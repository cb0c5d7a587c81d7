"""Plain PyTorch version of the sorted segment sum: each value vector
scattered onto its rows by ``index_add_``, the rows spelt out from the
CSR offsets."""
import torch


def segment_sum_sorted_ref(values, offsets: torch.Tensor) -> tuple:
    n = offsets.shape[0] - 1
    rows = torch.repeat_interleave(
        torch.arange(n, device=offsets.device), torch.diff(offsets),
        output_size=values[0].shape[0])
    return tuple(torch.zeros(n, dtype=v.dtype, device=v.device).index_add_(0, rows, v)
                 for v in values)
