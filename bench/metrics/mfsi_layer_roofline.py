"""mfsi_layer_roofline: the field-layer kernels' (``kernels/mfsi_layer``)
share of their roofline: the least time their work takes on the device
(``costs/mfsi.field_layer_cost``: the FLOPs, and the bytes each array must
move once) ÷ their device time, the kernels launched inside the
``mfsi.field_layer`` spans from the span passes' pass (b), an epoch, in
%; None where the port has no such span or the device is not in the
table."""
from bench.costs import bound_s, mfsi, peaks


def read(m: dict):
    p, peak = m.get("spans"), peaks(m.get("device_kind"))
    row = None if p is None or peak is None or m["model"] != "mfsi" else \
        p["device"]["inclusive"].get("mfsi.field_layer")
    if not row or not row["launches"]:
        return None
    flops, nbytes = mfsi.field_layer_cost(m["config"], int(m["traffic"]["history_length"]))
    return 100.0 * bound_s(flops, nbytes, peak) / (row["device_s"] / p["epochs"])
