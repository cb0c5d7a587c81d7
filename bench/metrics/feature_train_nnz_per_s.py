"""feature_train_nnz_per_s: as ``factor_train_nnz_per_s``, for the
feature models (FM, MFSI)."""


def read(m: dict):
    return m["nnz_per_s"]
