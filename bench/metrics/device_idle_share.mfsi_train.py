"""device_idle_share.mfsi_train: 1 − the device's busy time a traced
epoch ÷ the time an epoch took in the untraced window, in %."""
from bench.harness.profile import idle_share


def read(m: dict):
    return idle_share(m) if m["model"] == "mfsi" else None
