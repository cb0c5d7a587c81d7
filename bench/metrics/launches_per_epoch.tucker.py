"""launches_per_epoch.tucker: device kernels launched in the traced window ÷
its epochs (the profiler's kernel records)."""


def read(m: dict):
    tr = m.get("trace")
    if m["model"] != "tucker" or tr is None or tr["launches"] == 0:
        return None
    return tr["launches"] / tr["steps"]
