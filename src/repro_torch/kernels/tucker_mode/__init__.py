from repro_torch.kernels.tucker_mode.ops import mode_sweep  # noqa: F401
