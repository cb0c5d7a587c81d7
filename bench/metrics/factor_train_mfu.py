"""factor_train_mfu: an iCD-MF epoch's FLOPs (``costs.epochs``: the
sweeps, both Grams, the R' products, from nnz and the shapes, whatever
form the program runs them in) ÷ (the timed window's time an epoch × the
device's float32 peak), in %."""
from bench.costs import epochs, peaks


def read(m: dict):
    peak = peaks(m["device_kind"])
    if m["model"] != "mf" or peak is None:
        return None
    flops = epochs.mf_epoch_flops(m["nnz"], m["config"])
    return 100.0 * flops * m["epochs"] / (m["window_s"] * peak["fp32_flops"])
