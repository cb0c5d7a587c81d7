"""mfsi_train_mfu: an iCD-MFSI epoch's FLOPs (``costs/mfsi.py``: Φ and Ψ,
the Grams, per column the R' product, the moments, the field layers'
sums, Newton steps and cache patches and the residual patches, from nnz
and the shapes, whatever form the program runs them in) ÷ (the timed
window's time an epoch × the device's float32 peak), in %."""
from bench.costs import mfsi, peaks


def read(m: dict):
    peak = peaks(m["device_kind"])
    if m["model"] != "mfsi" or peak is None:
        return None
    flops = mfsi.mfsi_epoch_flops(m["nnz"], m["config"],
                                  int(m["traffic"]["history_length"]))
    return 100.0 * flops * m["epochs"] / (m["window_s"] * peak["fp32_flops"])
