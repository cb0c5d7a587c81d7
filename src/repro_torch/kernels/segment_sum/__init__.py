from repro_torch.kernels.segment_sum.ops import segment_sum_sorted  # noqa: F401
