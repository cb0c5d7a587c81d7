"""mode_sweep_ms.tucker: device time of the kernels launched inside the
``tucker.mode`` spans (the U and V mode sweeps), in ms an epoch, from the
span passes' pass (b); None where the port has no such span."""


def read(m: dict):
    p = m.get("spans")
    row = None if p is None or m["model"] != "tucker" else \
        p["device"]["inclusive"].get("tucker.mode")
    return 1e3 * row["device_s"] / p["epochs"] if row and row["launches"] else None
