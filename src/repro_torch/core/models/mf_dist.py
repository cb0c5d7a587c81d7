"""Explicitly distributed iCD-MF on ``torch.distributed`` (port of
``repro.core.models.mf_dist``): the paper's complexity bound across
ranks.

Lemmas 2 and 3 say the ONLY state iCD shares across shards is

  * the k×k Gram of the opposite side          → one k² all-reduce a sweep
  * the opposite side's current column ψ_f / w_f → one column all-gather
  * residuals regrouped ctx-major ↔ item-major  → one nnz all-to-all

Everything else (segment reductions, Newton steps, residual patches) is
LOCAL once contexts, items and their observations are partitioned by
owner.

Layout (built on the host by :func:`shard_interactions`): contexts are
range-partitioned over the D shards and so are items; each shard stores
its ctx-major observation block, its item-major observation block, and
the routing indices that move the residual cache between the two
groupings with one all-to-all. All blocks are padded to one size (α = 0
padding). :class:`ShardedMFHost` is that whole (D, …) layout in numpy,
array for array the reference's ``ShardedMF``; :class:`ShardedMF` is one
rank's blocks as tensors (``host.local(rank, device)``).

Where the reference writes each shard's body inside ``shard_map`` over
the mesh axis ``"shards"``, :func:`build_epoch` returns the same body for
one rank, and its collectives run on the 1-D mesh's group
(``runtime.collectives``). Every rank of the mesh calls it, each on its
own blocks. The column sweeps go through ``core.sweeps.sweep_columns``
with the flat ``mf.epoch``'s Newton body (``sweeps.newton_delta``, with
the denominator clamp that keeps l2 = 0 empty contexts finite) and the
port's segment sums; only the delivery of the opposite column is
distributed.

Per-epoch traffic a rank (C contexts, I items, nnz observations):
  2·k² (Grams) + k·(C+I)·4 B (column all-gathers) + 2·(nnz/D)·4 B (routes).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import sweeps
from repro_torch.core.gram import full_fp32, sharded_gram
from repro_torch.core.models.mf import MFHyperParams, MFParams
from repro_torch.runtime import collectives
from repro_torch.sparse.interactions import Interactions
from repro_torch.sparse.segment import segment_sum

_FIELDS = ("ctx_l", "item_g", "y_c", "alpha_c", "item_l", "ctx_g", "y_i",
           "alpha_i", "send_idx", "recv_pos")


@dataclasses.dataclass(frozen=True)
class ShardedMF:
    """One rank's blocks: the reference's per-shard slice with the shard
    dimension dropped. Index tensors are int64 (torch's index type)."""

    # ctx-major observations (p_c,): local ctx row, global item, targets
    ctx_l: torch.Tensor
    item_g: torch.Tensor
    y_c: torch.Tensor
    alpha_c: torch.Tensor
    # item-major observations (p_i,)
    item_l: torch.Tensor
    ctx_g: torch.Tensor
    y_i: torch.Tensor
    alpha_i: torch.Tensor
    # routing: ctx-major → item-major residual exchange
    send_idx: torch.Tensor   # (D, blk) positions into the ctx-major block, -1 pad
    recv_pos: torch.Tensor   # (D, blk) positions into the item-major block, -1 pad
    c_per: int
    i_per: int
    n_shards: int


@dataclasses.dataclass(frozen=True)
class ShardedMFHost:
    """Every shard's blocks on the host: each array has leading dim D,
    dtypes and values as the reference's ``ShardedMF`` (int32 indices,
    float32 targets)."""

    ctx_l: np.ndarray
    item_g: np.ndarray
    y_c: np.ndarray
    alpha_c: np.ndarray
    item_l: np.ndarray
    ctx_g: np.ndarray
    y_i: np.ndarray
    alpha_i: np.ndarray
    send_idx: np.ndarray     # (D, D, blk)
    recv_pos: np.ndarray     # (D, D, blk)
    c_per: int
    i_per: int
    n_shards: int

    def local(self, rank: int, device) -> ShardedMF:
        """Shard ``rank``'s blocks as tensors on ``device``."""
        def put(name):
            a = getattr(self, name)[rank]
            dtype = torch.int64 if a.dtype.kind == "i" else torch.float32
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=device)

        return ShardedMF(**{f: put(f) for f in _FIELDS}, c_per=self.c_per,
                         i_per=self.i_per, n_shards=self.n_shards)


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _blocks(order, shard, n_shards):
    """For ``order`` sorted so that ``shard[order]`` ascends: each entry's
    shard, its position in that shard's block, and the largest block."""
    s = shard[order]
    counts = np.bincount(s, minlength=n_shards)
    starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
    return s, np.arange(len(order)) - starts[s], max(1, int(counts.max(initial=0)))


def shard_interactions(data: Interactions, n_shards: int,
                       weights=None) -> ShardedMFHost:
    """Host-side partitioner: range-partition contexts and items, pad the
    blocks, precompute the all-to-all routing. Array-equal to the
    reference's.

    ``weights`` (optional, (nnz,) ctx-major) folds per-interaction
    confidence into both blocked α layouts exactly (α is purely
    multiplicative in the explicit loss parts); padding stays α = 0.

    The reference fills the routing with Python loops over every
    interaction; here one stable sort of the interactions by
    (ctx shard, item shard) gives each (source, destination) pair its
    slots in ascending interaction order, the loops' order."""
    d = n_shards
    c_per = -(-data.n_ctx // d)
    i_per = -(-data.n_items // d)
    ctx, item = _host(data.ctx), _host(data.item)
    y, alpha = _host(data.y), _host(data.alpha)
    if weights is not None:
        alpha = alpha * np.asarray(_host(weights), alpha.dtype)
    nnz = len(ctx)
    ctx_shard = ctx // c_per
    item_shard = item // i_per

    def blocked(order, shard, rows, per, other):
        s, pos, p = _blocks(order, shard, d)
        loc = np.zeros((d, p), np.int32)
        glob = np.zeros((d, p), np.int32)
        yb = np.zeros((d, p), np.float32)
        ab = np.zeros((d, p), np.float32)
        loc[s, pos] = rows[order] - s * per
        glob[s, pos] = other[order]
        yb[s, pos] = y[order]
        ab[s, pos] = alpha[order]
        where = np.empty(nnz, np.int64)
        where[order] = pos
        return loc, glob, yb, ab, where

    # ctx-major and item-major blocks
    ctx_l, item_g, y_c, alpha_c, pos_c = blocked(
        np.lexsort((item, ctx)), ctx_shard, ctx, c_per, item)
    item_l, ctx_g, y_i, alpha_i, pos_i = blocked(
        np.lexsort((ctx, item)), item_shard, item, i_per, ctx)

    # routing ctx-shard → item-shard
    pair = ctx_shard * d + item_shard
    order = np.argsort(pair, kind="stable")
    _, slot, blk = _blocks(order, pair, d * d)
    cs, its = ctx_shard[order], item_shard[order]
    send_idx = -np.ones((d, d, blk), np.int32)
    recv_pos = -np.ones((d, d, blk), np.int32)
    send_idx[cs, its, slot] = pos_c[order]
    # receiver `its` sees this entry in its block from source `cs`
    recv_pos[its, cs, slot] = pos_i[order]

    return ShardedMFHost(
        ctx_l=ctx_l, item_g=item_g, y_c=y_c, alpha_c=alpha_c,
        item_l=item_l, ctx_g=ctx_g, y_i=y_i, alpha_i=alpha_i,
        send_idx=send_idx, recv_pos=recv_pos,
        c_per=c_per, i_per=i_per, n_shards=d,
    )


def shard_params(params: MFParams, sd) -> MFParams:
    """Pad + block the factor matrices to (D, rows_per_shard, k), on the
    params' device."""
    d, k = sd.n_shards, params.w.shape[1]
    w = params.w.new_zeros((d * sd.c_per, k))
    w[: params.w.shape[0]] = params.w
    h = params.h.new_zeros((d * sd.i_per, k))
    h[: params.h.shape[0]] = params.h
    return MFParams(w=w.reshape(d, sd.c_per, k), h=h.reshape(d, sd.i_per, k))


def unshard_params(params: MFParams, n_ctx: int, n_items: int) -> MFParams:
    k = params.w.shape[-1]
    return MFParams(w=params.w.reshape(-1, k)[:n_ctx],
                    h=params.h.reshape(-1, k)[:n_items])


def _route(e_src, src_idx, dst_pos, p_dest: int, group):
    """Move per-observation values between groupings with one all-to-all.
    ``src_idx`` (D, blk): positions in ``e_src`` to send to each rank;
    ``dst_pos`` (D, blk): where each value received from each rank lands
    (-1 = padding). Every real position receives exactly one value and
    padding adds +0.0 to position 0, so the result is exact in any order
    of the adds."""
    send = torch.where(src_idx >= 0, e_src[src_idx.clamp(min=0)], 0)
    recv = collectives.all_to_all(send.reshape(-1), group).float()
    flat_pos = dst_pos.reshape(-1)
    out = torch.zeros((p_dest,), dtype=torch.float32, device=e_src.device)
    return out.index_add_(0, flat_pos.clamp(min=0),
                          torch.where(flat_pos >= 0, recv, 0.0))


def make_shard_mesh(n_shards: int, *, device_type: str = "cuda"):
    """One flat ``("shards",)`` mesh over the whole initialised world:
    the optimized iCD layout. ``device_type`` is ``"cuda"`` (NCCL) unless
    the caller names ``"cpu"`` (gloo)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    if n_shards != world:
        raise ValueError(f"make_shard_mesh({n_shards}) needs a world of "
                         f"{n_shards} ranks; this one has {world}")
    return init_device_mesh(device_type, (n_shards,),
                            mesh_dim_names=("shards",))


def build_epoch(mesh, hp: MFHyperParams, sd_template,
                variant: str = "gather", wire_dtype=torch.float32):
    """One rank's epoch over the flat shard mesh:
    ``epoch(w_loc, h_loc, sd_loc, e_loc) -> (w_loc, h_loc, e_loc)``, with
    this rank's (c_per, k) and (i_per, k) factor blocks, its
    :class:`ShardedMF` and its (p_c,) ctx-major residuals. The inputs are
    left as they were.

    variant:
      'gather' — the opposite column is ALL-GATHERED a dimension
                 (on the wire a sweep: k·rows_other values).
      'route'  — the owner shard evaluates its column at the observations
                 and ROUTES per-nnz values (all-to-all): k·(nnz/D) values
                 instead of k·rows_other.
    wire_dtype — bf16 on the wire for gathered or routed column values
                 only; the Newton math and the residual routes stay fp32.
    ``hp.implementation`` picks the Grams' route: ``"xla"`` the plain
    product, ``"pallas"`` the Gram kernel.
    """
    if variant not in ("gather", "route"):
        raise ValueError(f"variant must be 'gather' or 'route', got {variant!r}")
    group = collectives.group_of(mesh)
    c_per, i_per = sd_template.c_per, sd_template.i_per

    def side_sweep(side_m, other_m, j_o, rows_l, alpha_l, e_l, n_per,
                   opp_global, opp_local, out_idx, in_idx):
        """One side's k-column sweep: the flat epoch's Newton body, with
        the opposite column delivered over the wire a dimension."""

        def body(f, carry):
            side_m, e = carry
            o_col = sweeps.take_col(other_m, f)
            if variant == "gather":
                col = collectives.all_gather(o_col.to(wire_dtype), group)
                o_vals = col.float()[opp_global]
            else:  # owners evaluate at their entries, route per-nnz
                o_vals = _route(o_col[opp_local].to(wire_dtype), out_idx,
                                in_idx, alpha_l.shape[0], group)
            s_col = sweeps.take_col(side_m, f)
            lp = segment_sum(alpha_l * e * o_vals, rows_l, n_per)
            lpp = segment_sum(alpha_l * o_vals * o_vals, rows_l, n_per)
            rp = side_m @ sweeps.take_col(j_o, f)
            rpp = j_o[f, f]
            delta = sweeps.newton_delta(
                sweeps.NewtonParts(lp + hp.alpha0 * rp, lpp + hp.alpha0 * rpp),
                s_col, hp.l2, hp.eta)
            e = e + delta[rows_l] * o_vals
            return sweeps.put_col(side_m, f, s_col + delta), e

        return sweeps.sweep_columns(side_m.shape[1], body, (side_m, e_l),
                                    unroll=hp.unroll)

    def epoch(w_loc, h_loc, sd: ShardedMF, e_loc):
        w, h = w_loc.clone(), h_loc.clone()
        with full_fp32():
            # context sweep
            j_i = sharded_gram(h, group, implementation=hp.implementation)
            w, e = side_sweep(w, h, j_i, sd.ctx_l, sd.alpha_c, e_loc, c_per,
                              sd.item_g, sd.item_l, sd.recv_pos, sd.send_idx)
            # residuals: ctx-major → item-major
            e_item = _route(e, sd.send_idx, sd.recv_pos, sd.alpha_i.shape[0],
                            group)
            # item sweep
            j_c = sharded_gram(w, group, implementation=hp.implementation)
            h, e_item = side_sweep(h, w, j_c, sd.item_l, sd.alpha_i, e_item,
                                   i_per, sd.ctx_g, sd.ctx_l, sd.send_idx,
                                   sd.recv_pos)
            # residuals back
            e = _route(e_item, sd.recv_pos, sd.send_idx, sd.alpha_c.shape[0],
                       group)
        return w, h, e

    return epoch


def residuals_blocked(params_blocked: MFParams, sd) -> torch.Tensor:
    """Initial ctx-major residual blocks (D, p_c): ŷ − ȳ (α = 0 padding),
    on the params' device, from the host layout. The k products are
    summed in ascending column order, as the reference's einsum sums
    them, so the result is array-equal to its."""
    w = params_blocked.w                     # (D, c_per, k)
    dev = w.device
    ctx_l = torch.as_tensor(sd.ctx_l, dtype=torch.int64, device=dev)
    item_g = torch.as_tensor(sd.item_g, dtype=torch.int64, device=dev)
    h_flat = params_blocked.h.reshape(-1, w.shape[2])
    scores = torch.zeros(ctx_l.shape, dtype=w.dtype, device=dev)
    for f in range(w.shape[2]):
        scores = scores + torch.gather(w[:, :, f], 1, ctx_l) * h_flat[item_g, f]
    return scores - torch.as_tensor(sd.y_c, device=dev)
