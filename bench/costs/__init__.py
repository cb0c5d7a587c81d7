"""Operation and byte counts from shapes, and the devices' published peaks.

The counts are of the work the algorithm needs for the real interactions
(nnz), never of the padded slots a layout happens to hold: a layout that
pads less does the same work in less time, and its share of the bound
rises. Nothing here imports the port.
"""
from __future__ import annotations

# NVIDIA's data sheet, SXM part, dense rates: float32 outside the tensor
# cores and HBM bandwidth, at the full 700 W power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"fp32_flops": 67e12, "bytes_per_s": 3.35e12},
}


def peaks(device_kind: str):
    """The device's peaks, or None for a device the table lacks (a
    reader then reports nothing)."""
    return PEAKS.get(device_kind)


def bound_s(flops: float, nbytes: float, peak: dict) -> float:
    """The least time the device could take: the larger of the two."""
    return max(flops / peak["fp32_flops"], nbytes / peak["bytes_per_s"])


def block_k(config: dict) -> int:
    """Columns a fused block: ``block_k`` 0 means min(k, 8), as the port's
    epochs resolve it."""
    k, b = int(config["k"]), int(config["block_k"])
    return min(k, 8) if b == 0 else max(1, min(b, k))


def blocks(k: int, k_b: int) -> list:
    """Sizes of the blocks a sweep of k columns makes."""
    return [min(k_b, k - f0) for f0 in range(0, k, k_b)]
