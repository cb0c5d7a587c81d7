"""resid_patch_ms.mfsi: device time of the kernels launched inside the
``mfsi.patch`` spans (e += Δφ·ψ over nnz after each field layer), in ms
an epoch, from the span passes' pass (b); None where the port has no such
span."""


def read(m: dict):
    p = m.get("spans")
    row = None if p is None or m["model"] != "mfsi" else \
        p["device"]["inclusive"].get("mfsi.patch")
    return 1e3 * row["device_s"] / p["epochs"] if row and row["launches"] else None
