"""Hand-written Hopper kernels for the compute hot spots.

Each kernel package ships three layers, as in ``repro.kernels``:

  csrc/*.cu + kernel.py — the CUDA C++ kernel for ``sm_90a``, compiled by
                          ``nvcc`` at its first launch into ``build/`` and
                          bound through ``ctypes`` (``build.py``)
  ops.py                — the public wrapper: dispatch by device, shape
                          and dtype checks, the launch counter
  ref.py                — the plain PyTorch version of the same function

Dispatch follows the tensors, not a switch: a CUDA tensor launches the
hand kernel (or raises on a form the kernel does not take), a CPU tensor
takes the plain version. No environment variable or option sends a CUDA
tensor to the plain version. Where no tensor says where to run (numpy
data, a device left unnamed), :func:`resolve_device` picks ``cuda``.

Kernels:
  topk_score — fused score + top-K over a ψ table or one row-range shard
               of it (replaces ``repro/kernels/topk_score/kernel.py``
               ``topk_score_pallas``).
  gram       — J = XᵀX or Xᵀ·diag(w)·X of a tall-skinny matrix (replaces
               ``repro/kernels/gram/kernel.py`` ``gram_pallas``).
  cd_sweep   — the fused k_b-column iCD Newton sweep over the padded
               layout, with one shared Gram block or a per-row patch, Ψ
               pre-gathered or gathered in the kernel, one warp a row or,
               for rows too long for shared memory, one block a row (the
               shared-J gather sweep with the row held in registers, a
               group of threads a row, where the row fits them)
               (replaces ``repro/kernels/cd_sweep/kernel.py``
               ``cd_block_sweep_pallas``, ``cd_block_sweep_gather_pallas``,
               ``cd_block_sweep_rowpatch_pallas`` and
               ``cd_block_sweep_rowpatch_gather_pallas``), and the feature
               models' slab reduce and rank-m residual patch, ψ
               pre-gathered or gathered in the kernel (replaces
               ``cd_slab_reduce_pallas``, ``cd_slab_reduce_gather_pallas``,
               ``cd_resid_patch_pallas`` and
               ``cd_resid_patch_gather_pallas``).
  cd_update  — the per-column update, one k_b = 1 launch of ``cd_sweep``.
  segment_sum — sums of 1 to 4 value vectors over rows given as CSR
               offsets, in a fixed order (no TPU kernel: the JAX package
               leaves ``jax.ops.segment_sum`` to XLA).
  tucker_core — Tucker's core sweep a slab (f1, f2) of the core at a
               time: one pass over the log and one solve of the slab's k3
               steps (no TPU kernel: the JAX package's core sweep is a
               ``lax.fori_loop`` of XLA ops).
  tucker_mode — Tucker's mode sweeps a column of u or v at a time: one
               pass over the pairs and the log and one solve of every
               row's step (no TPU kernel: the JAX package's mode sweep is
               a loop of XLA ops).
"""
from __future__ import annotations

import torch


def on_cuda(*tensors) -> bool:
    """Whether a kernel wrapper should launch its CUDA kernel for these
    tensors (``None`` entries are skipped). All tensors must share one
    device; a mix of devices raises rather than picking a path."""
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(
            f"kernel inputs must share one device, got {sorted(map(str, devices))}")
    return next(iter(devices)).type == "cuda"


def resolve_device(device=None) -> torch.device:
    """The device for data that carries none: ``cuda`` unless the caller
    names another. Raises when CUDA is named or defaulted to and no GPU is
    present, so nothing lands on the CPU's plain versions unasked."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} but no CUDA device is available; pass "
            "device='cpu' to run the plain PyTorch versions")
    return device
