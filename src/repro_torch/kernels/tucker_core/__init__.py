from repro_torch.kernels.tucker_core.ops import core_sweep_slabs  # noqa: F401
