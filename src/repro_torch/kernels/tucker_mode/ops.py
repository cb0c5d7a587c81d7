"""Public wrapper for Tucker's mode sweep by column (no JAX counterpart
kernel: the JAX package's mode sweep is a loop of XLA ops a column).

A CUDA tensor launches the hand-written kernels (``csrc/tucker_mode.cu``);
a CPU tensor takes the plain version (``ref.mode_sweep_ref``)."""
from __future__ import annotations

import torch

from repro_torch.kernels import on_cuda
from repro_torch.kernels.tucker_mode import kernel
from repro_torch.kernels.tucker_mode.ref import mode_sweep_ref

MAX_K3 = kernel.WIDTHS[-1]
MAX_K_OTHER = 64  # the partner's columns a pass's shared memory holds at every width


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"mode_sweep: {msg}")


def mode_sweep(side, b_slices, partner, partner_of_pair, group_of_pair, order, group_ptr,
               phi, j_i, w, ctx_ptr, item, alpha, e, *, columns, alpha0: float,
               l2: float, eta: float) -> tuple:
    """One mode sweep of Tucker's flat epoch: a scalar Newton step for
    every row of ``side`` in each of ``columns``, in that order (a column
    may come twice).

    ``side`` (n_side, k_side) the mode's factor, and ``phi`` (n_pairs, k3),
    the φ rows of the pairs, are updated in place; ``b_slices``
    (k_side, k_other, k3) the core with the mode first (``b`` for u,
    ``b.transpose(0, 1)`` for v; any strides but the last); ``partner``
    (n_partner, k_other) the other mode's factor and ``partner_of_pair``
    its row a pair; ``group_of_pair`` the pair's row of ``side``, and
    ``order`` / ``group_ptr`` the pairs listed group by group (``order``
    int32, None where the pairs already are) with the groups' (n_side + 1,)
    int64 offsets in that list (``parafac.pair_groups``); ``j_i`` = wᵀw;
    the log context-major: ``ctx_ptr`` (n_pairs + 1,) int64 CSR offsets of
    the pairs, ``item``, ``alpha`` (ᾱ) and ``e`` (nnz,). Returns
    ``(side, phi, e)``; ``e`` is a new tensor where a column is swept.

    On CUDA: per column one pass over the pairs and the log and one solve,
    then one closing pass (``mode_sweep.launches``). Every float tensor is
    float32 and contiguous but ``b_slices``; k3 ≤ 128, k_other ≤ 64. The
    sums are taken in an order fixed by the offsets, the group order and
    the grid, never by atomics, so two runs give the same bits."""
    columns = tuple(int(c) for c in columns)
    if not on_cuda(side, b_slices, partner, partner_of_pair, group_of_pair, order, group_ptr,
                   phi, j_i, w, ctx_ptr, item, alpha, e):
        return mode_sweep_ref(side, b_slices, partner, partner_of_pair, group_of_pair, order,
                              group_ptr, phi, j_i, w, ctx_ptr, item, alpha, e,
                              columns=columns, alpha0=alpha0, l2=l2, eta=eta)
    (n_side, k_side), (n_pairs, k3) = side.shape, phi.shape
    k_o, nnz = b_slices.shape[1], item.shape[0]
    _check(1 <= k3 <= MAX_K3, f"the kernel takes k3 from 1 to {MAX_K3}, got {k3}")
    _check(1 <= k_o <= MAX_K_OTHER,
           f"the kernel takes k_other from 1 to {MAX_K_OTHER}, got {k_o}")
    _check(all(0 <= c < k_side for c in columns), f"columns must lie in [0, {k_side})")
    _check(nnz < 2 ** 31, "the kernel takes fewer than 2**31 interactions")
    shapes = {"side": (side, (n_side, k_side)), "partner": (partner, (partner.shape[0], k_o)),
              "phi": (phi, (n_pairs, k3)), "j_i": (j_i, (k3, k3)),
              "w": (w, (w.shape[0], k3)), "alpha": (alpha, (nnz,)), "e": (e, (nnz,))}
    for name, (t, shape) in shapes.items():
        _check(t.dtype == torch.float32 and tuple(t.shape) == shape and t.is_contiguous(),
               f"{name} must be a contiguous float32 {shape} tensor")
    _check(b_slices.dtype == torch.float32 and tuple(b_slices.shape) == (k_side, k_o, k3)
           and b_slices.stride(2) == 1,
           f"b_slices must be a float32 {(k_side, k_o, k3)} tensor with unit last stride")
    for name, t, n in (("partner_of_pair", partner_of_pair, n_pairs),
                       ("group_of_pair", group_of_pair, n_pairs),
                       ("group_ptr", group_ptr, n_side + 1), ("ctx_ptr", ctx_ptr, n_pairs + 1)):
        _check(t.dtype == torch.int64 and tuple(t.shape) == (n,) and t.is_contiguous(),
               f"{name} must be a contiguous int64 ({n},) vector")
    _check(order is None or (order.dtype == torch.int32 and tuple(order.shape) == (n_pairs,)
                             and order.is_contiguous()),
           f"order must be None or a contiguous int32 ({n_pairs},) vector")
    _check(item.dtype in (torch.int64, torch.int32) and tuple(item.shape) == (nnz,),
           "item must be an int64 or int32 vector")
    if not columns:
        return side, phi, e
    dev = w.device
    warps = max(1, -(-n_pairs // kernel.chunk(kernel.width_of(k3))))
    item32 = item.to(torch.int32).contiguous()
    e_out = torch.empty_like(e)
    s = torch.empty(nnz, dtype=torch.float32, device=dev)
    delta = torch.empty(max(1, n_side), dtype=torch.float32, device=dev)
    head = torch.empty((warps, 4), dtype=torch.float32, device=dev)
    tail = torch.empty((warps, 4), dtype=torch.float32, device=dev)
    out = torch.empty((max(1, n_side), 4), dtype=torch.float32, device=dev)
    kernel.launch(side, b_slices, partner, partner_of_pair, group_of_pair, order, group_ptr,
                  phi, j_i, w, ctx_ptr, item32, alpha, e, e_out, s, columns, delta, head,
                  tail, out, float(alpha0), float(l2), float(eta))
    passes = len(columns) + 1 if n_pairs else 0
    mode_sweep.launches += passes + (len(columns) if n_side else 0)
    mode_sweep.columns += len(columns)
    return side, phi, e_out


mode_sweep.launches = 0  # CUDA kernel launches: 2·columns + 1 a call
mode_sweep.columns = 0   # mode columns swept by the kernels
