"""tensor_train_mfu: an iCD-Tucker epoch's FLOPs (``costs.tensor``: Φ, the
Grams, the mode sweeps, the core sweep and the item sweep, from nnz, the
context pairs and the ranks, whatever form the program runs them in) ÷
(the timed window's time an epoch × the device's float32 peak), in %."""
from bench.costs import peaks, tensor


def read(m: dict):
    peak = peaks(m["device_kind"])
    if m["model"] != "tucker" or peak is None:
        return None
    flops = tensor.tucker_epoch_flops(m["nnz"], m["counters"]["pairs"], m["config"])
    return 100.0 * flops * m["epochs"] / (m["window_s"] * peak["fp32_flops"])
