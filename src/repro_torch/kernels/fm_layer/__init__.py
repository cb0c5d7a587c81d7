from repro_torch.kernels.fm_layer.ops import Caches, field_layer, prepare  # noqa: F401
