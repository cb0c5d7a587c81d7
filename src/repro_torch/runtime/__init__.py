from repro_torch.runtime.health import StragglerWatchdog  # noqa: F401
