from repro_torch.kernels.gram.ops import gram  # noqa: F401
