"""feature_train_mfu: an iCD-FM epoch's FLOPs (``costs.epochs``: Grams,
the per-interaction sums and patches, R' products, field layers, from nnz
and the shapes, whatever form the program runs them in) ÷ (the timed
window's time an epoch × the device's float32 peak), in %."""
from bench.costs import epochs, peaks


def read(m: dict):
    peak = peaks(m["device_kind"])
    if m["model"] != "fm" or peak is None:
        return None
    flops = epochs.fm_epoch_flops(m["nnz"], m["config"],
                                  int(m["traffic"]["history_length"]))
    return 100.0 * flops * m["epochs"] / (m["window_s"] * peak["fp32_flops"])
