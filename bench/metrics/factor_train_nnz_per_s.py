"""factor_train_nnz_per_s: real interactions × complete epochs in the
window ÷ the time from the window's start to the synchronised end of its
last epoch, for the factor models (MF and its relatives)."""


def read(m: dict):
    return m["nnz_per_s"]
