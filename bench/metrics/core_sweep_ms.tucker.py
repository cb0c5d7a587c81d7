"""core_sweep_ms.tucker: device time of the kernels launched inside the
``tucker.core`` span (the core sweep's k1·k2·k3 scalar steps), in ms an
epoch, from the span passes' pass (b); None where the port has no such
span."""


def read(m: dict):
    p = m.get("spans")
    row = None if p is None or m["model"] != "tucker" else \
        p["device"]["inclusive"].get("tucker.core")
    return 1e3 * row["device_s"] / p["epochs"] if row and row["launches"] else None
