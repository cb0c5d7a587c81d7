"""Public wrapper for Tucker's blocked core sweep (no JAX counterpart
kernel: the JAX package's core sweep is a ``lax.fori_loop`` of XLA ops,
one scalar Newton step a coordinate).

A CUDA tensor launches the hand-written kernels (``csrc/tucker_core.cu``);
a CPU tensor takes the plain version (``ref.core_sweep_slabs_ref``)."""
from __future__ import annotations

import torch

from repro_torch.kernels import on_cuda
from repro_torch.kernels.tucker_core import kernel
from repro_torch.kernels.tucker_core.ref import core_sweep_slabs_ref

MAX_K3 = kernel.WIDTHS[-1]


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"core_sweep_slabs: {msg}")


def core_sweep_slabs(w, gp, gram_g, r, b, j_i, ctx_ptr, item, alpha, e, *,
                     alpha0: float, l2_core: float, eta: float) -> tuple:
    """Every scalar Newton step of Tucker's core sweep, in the reference's
    order idx = (f1·k2 + f2)·k3 + f3, a slab (f1, f2) at a time: one pass
    over the log a slab, then one patch of the residuals.

    ``w`` (n_items, k3) item factors; ``gp`` (k1·k2, n_pairs) the rows
    g_ab = u[c1, f1]·v[c2, f2]; ``gram_g`` = gp·gpᵀ; ``r`` = gp·Φ with Φ
    the (n_pairs, k3) φ rows entering the sweep; ``b`` (k1·k2, k3) the
    core; ``j_i`` (k3, k3) = wᵀw; the log context-major: ``ctx_ptr``
    (n_pairs + 1,) int64 CSR offsets of the pairs, ``item``, ``alpha``
    (ᾱ) and ``e`` (nnz,). Returns ``(delta, e)``: the (k1·k2, k3) steps
    and the residuals after them (new tensors; the inputs are left as
    they were). Φ after the sweep is Φ + gpᵀ·delta.

    On CUDA every tensor is contiguous float32 (``item`` int64 or int32,
    ``ctx_ptr`` int64) and k3 ≤ 128; the sums are taken in an order fixed
    by the offsets and the grid, never by atomics, so two runs give the
    same bits."""
    if not on_cuda(w, gp, gram_g, r, b, j_i, ctx_ptr, item, alpha, e):
        return core_sweep_slabs_ref(w, gp, gram_g, r, b, j_i, ctx_ptr, item, alpha,
                                    e, alpha0=alpha0, l2_core=l2_core, eta=eta)
    n_slabs, k3 = b.shape
    n_pairs, nnz = gp.shape[1], item.shape[0]
    _check(1 <= k3 <= MAX_K3,
           f"the kernel takes k3 from 1 to {MAX_K3}, got {k3}")
    shapes = {"w": (w, (w.shape[0], k3)), "gp": (gp, (n_slabs, n_pairs)),
              "gram_g": (gram_g, (n_slabs, n_slabs)), "r": (r, (n_slabs, k3)),
              "b": (b, (n_slabs, k3)), "j_i": (j_i, (k3, k3)),
              "alpha": (alpha, (nnz,)), "e": (e, (nnz,))}
    for name, (t, shape) in shapes.items():
        _check(t.dtype == torch.float32 and tuple(t.shape) == shape
               and t.is_contiguous(),
               f"{name} must be a contiguous float32 {shape} tensor")
    _check(ctx_ptr.dtype == torch.int64 and tuple(ctx_ptr.shape) == (n_pairs + 1,)
           and ctx_ptr.is_contiguous(),
           f"ctx_ptr must be a contiguous int64 ({n_pairs + 1},) vector")
    _check(item.dtype in (torch.int64, torch.int32) and item.dim() == 1,
           "item must be an int64 or int32 vector")
    _check(n_slabs >= 1, "the core has no slab")
    resident, slots, tile = kernel.layout(w.device, kernel.width_of(k3))
    blocks = max(1, min(resident, -(-nnz // tile)))
    item32 = item.to(torch.int32).contiguous()
    delta = torch.empty((n_slabs, k3), dtype=torch.float32, device=w.device)
    part = torch.empty(blocks * slots, dtype=torch.float32, device=w.device)
    r, e = r.clone(), e.clone()
    kernel.launch(w, gp, gram_g, r, b, j_i, ctx_ptr, item32, alpha, e, delta, part,
                  blocks, float(alpha0), float(l2_core), float(eta))
    core_sweep_slabs.launches += 2 * n_slabs + 1
    core_sweep_slabs.slabs += n_slabs
    return delta, e


core_sweep_slabs.launches = 0  # CUDA kernel launches: 2·k1·k2 + 1 a call
core_sweep_slabs.slabs = 0     # core slabs (f1, f2) swept by the kernel
