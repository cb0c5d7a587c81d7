from repro_torch.kernels.cd_update.ops import cd_column_update  # noqa: F401
