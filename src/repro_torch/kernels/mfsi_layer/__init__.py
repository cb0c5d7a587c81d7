from repro_torch.kernels.mfsi_layer.ops import field_layer, prepare  # noqa: F401
