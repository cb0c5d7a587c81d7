"""Sharded retrieval: row-range ψ shards + cross-shard top-K merge (port of
``repro.serve.cluster``, host-loop path).

The ψ table is partitioned by row range: shard s owns global ids
``[s·rows_per, (s+1)·rows_per)``, every shard padded to the uniform
``rows_per = ⌈n_items/S⌉``. Each shard runs the fused ``topk_score`` kernel
over its slab, emitting GLOBAL candidate ids through the kernel's
``id_offset``/``n_valid`` meta, and ``topk_merge_shards`` ranks the S·K
candidates into the final (B, k). The merge's two-key order reproduces the
kernel's ascending-global-id tie policy, so within this package the result
is bit-identical at any shard count.

Exclusion: a dense (B, n_items) mask is sliced to the shard's row range;
the ``exclude_ids`` form is passed whole (global ids, so a shard simply
never matches ids outside its range).

``shard_map_topk`` and ``ShardedRetrievalCluster`` are not ported yet
(slice 5); the fault-tolerant mesh (``serve/mesh.py``) builds on the
functions here.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import resolve_device, vmem
from repro_torch.kernels.topk_score.ops import topk_merge_shards, topk_score


@dataclasses.dataclass(frozen=True)
class TopKResult:
    """Top-K results plus the degraded-service contract.

    Unpacks like the bare ``(scores, ids)`` tuple, and also carries:

      * ``coverage`` — fraction of the catalogue's items that were
        searched (1.0 when every shard answered);
      * ``dead_ranges`` — the global item-id ranges ``(lo, hi)`` that were
        unavailable, coalesced and clipped to ``n_items``.

    A degraded query completes and says so: it never returns a
    full-looking top-K that silently omits part of the catalogue.
    """

    scores: torch.Tensor                            # (B, k)
    ids: torch.Tensor                               # (B, k)
    coverage: float = 1.0
    dead_ranges: Tuple[Tuple[int, int], ...] = ()

    def __iter__(self):
        return iter((self.scores, self.ids))

    def __getitem__(self, i):
        return (self.scores, self.ids)[i]

    def __len__(self) -> int:
        return 2

    @property
    def degraded(self) -> bool:
        return self.coverage < 1.0


def dead_item_ranges(
    table: "PsiShardSet", dead_shards
) -> Tuple[Tuple[int, int], ...]:
    """Coalesced global item-id ranges owned by ``dead_shards``, clipped to
    the real catalogue (a dead LAST shard's padding rows don't count)."""
    ranges = []
    for s in sorted(set(dead_shards)):
        lo = s * table.rows_per
        hi = min(lo + table.rows_per, table.n_items)
        if hi <= lo:
            continue
        if ranges and ranges[-1][1] == lo:
            ranges[-1] = (ranges[-1][0], hi)
        else:
            ranges.append((lo, hi))
    return tuple(ranges)


def coverage_fraction(table: "PsiShardSet", dead_shards) -> float:
    """Fraction of real catalogue rows in surviving shards."""
    if table.n_items == 0:
        return 1.0
    dead = sum(hi - lo for lo, hi in dead_item_ranges(table, dead_shards))
    return 1.0 - dead / table.n_items


def empty_topk(b: int, k: int, device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """The no-admissible-candidates result: (−inf, −1) everywhere — what a
    query against zero surviving shards degrades to."""
    return (torch.full((b, k), float("-inf"), device=device),
            torch.full((b, k), -1, dtype=torch.int32, device=device))


def colocate_parts(parts: List[torch.Tensor]) -> List[torch.Tensor]:
    """Move per-shard results onto the first part's device before they are
    stacked for the merge. No-op when they already share one device."""
    dev = parts[0].device
    return [p if p.device == dev else p.to(dev) for p in parts]


def shard_topk(
    table: "PsiShardSet",
    s: int,
    phi_rows: torch.Tensor,
    k: int,
    *,
    slab: Optional[torch.Tensor] = None,
    exclude_mask: Optional[torch.Tensor] = None,
    exclude_ids: Optional[torch.Tensor] = None,
    block_items: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One shard's kernel dispatch: (B, k) candidates with GLOBAL ids.
    ``slab`` overrides the table's own copy of shard ``s``; the replica
    layer (``serve/mesh.py``) routes any replica slab through here, so
    every replica runs the same kernel call the unreplicated cluster
    does. φ and the exclusion move to the slab's device if needed."""
    lo = s * table.rows_per
    shard = table.shards[s] if slab is None else slab
    dev = shard.device
    mask_s = None
    if exclude_mask is not None:
        mask_s = _shard_exclude_mask(exclude_mask, lo, table.rows_per).to(dev)
    if exclude_ids is not None:
        exclude_ids = exclude_ids.to(dev)
    return topk_score(
        phi_rows.to(dev), shard, k, mask_s, exclude_ids=exclude_ids,
        id_offset=lo, n_valid=table.valid_rows(s), block_items=block_items,
    )


@dataclasses.dataclass(frozen=True)
class PsiShardSet:
    """One immutable, versioned row-range partition of a ψ table.

    ``shards[s]`` is the (rows_per, D) slab owning global item ids
    ``[s·rows_per, (s+1)·rows_per)``; only the LAST shard carries padding
    rows (global id ≥ n_items), which the kernel's ``n_valid`` meta keeps
    inadmissible. ``version`` is the publish counter the request cache
    keys on (``serve/batcher.py``).
    """

    shards: Tuple[torch.Tensor, ...]   # S × (rows_per, D)
    n_items: int
    rows_per: int
    version: int = 0

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    def valid_rows(self, s: int) -> int:
        """Admissible rows of shard ``s`` (< rows_per only on the last)."""
        return max(0, min(self.rows_per, self.n_items - s * self.rows_per))


def shard_psi(
    psi_table,
    n_shards: int,
    *,
    devices: Optional[Sequence] = None,
    version: int = 0,
) -> PsiShardSet:
    """Row-range-partition ``psi_table`` into ``n_shards`` uniform slabs.

    Each slab is its own contiguous copy. ``devices`` (optional) places
    shard s on ``devices[s % len(devices)]``; without it every shard stays
    on the table's device, and a table that is no tensor (numpy) goes to
    the GPU, raising when none is present."""
    if not isinstance(psi_table, torch.Tensor) and devices is None:
        psi_table = torch.as_tensor(psi_table, dtype=torch.float32,
                                    device=resolve_device())
    psi_table = torch.as_tensor(psi_table, dtype=torch.float32)
    n_items, _ = psi_table.shape
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    rows_per = -(-n_items // n_shards)
    shards = []
    for s in range(n_shards):
        lo = s * rows_per
        blk = psi_table[lo: lo + rows_per]
        if blk.shape[0] < rows_per:  # last shard: pad to the uniform size
            blk = torch.nn.functional.pad(blk, (0, 0, 0, rows_per - blk.shape[0]))
        dev = devices[s % len(devices)] if devices is not None else blk.device
        shards.append(blk.to(dev, copy=True).contiguous())
    return PsiShardSet(
        shards=tuple(shards), n_items=n_items, rows_per=rows_per,
        version=version,
    )


def resolve_cluster_block_items(table: PsiShardSet, k: int) -> int:
    """Per-shard ``block_items`` for the kernel: the ψ rows one pass-1
    block scores. Raises :class:`vmem.VmemBudgetError` when ``k`` needs
    more shared memory than a block has (never shrinks below it)."""
    return vmem.cluster_block_items(vmem.topk_k_pad(k),
                                    shard_items=table.rows_per)


def _shard_exclude_mask(exclude_mask, lo: int, rows_per: int):
    """Slice a dense (B, n_items) mask to one shard's row range, padded to
    the uniform shard size."""
    blk = torch.as_tensor(exclude_mask)[:, lo: lo + rows_per]
    short = rows_per - blk.shape[1]
    if short > 0:
        blk = torch.nn.functional.pad(blk.to(torch.int8), (0, short))
    return blk


def cluster_topk(
    table: PsiShardSet,
    phi_rows,
    k: int,
    *,
    exclude_mask=None,
    exclude_ids=None,
    block_items: Optional[int] = None,
    dead_shards: Sequence[int] = (),
) -> TopKResult:
    """Sharded top-K over one table snapshot: S kernel dispatches + the
    cross-shard merge. ``dead_shards`` are skipped: the query completes
    over the survivors and reports ``coverage < 1`` and the dead global-id
    ranges."""
    phi_rows = torch.as_tensor(phi_rows, dtype=torch.float32)
    b = phi_rows.shape[0]
    if block_items is None:
        block_items = resolve_cluster_block_items(table, k)
    dead = set(dead_shards)
    parts_s, parts_i = [], []
    for s in range(table.n_shards):
        if s in dead:
            continue
        ss, ii = shard_topk(
            table, s, phi_rows, k, exclude_mask=exclude_mask,
            exclude_ids=exclude_ids, block_items=block_items,
        )
        parts_s.append(ss)
        parts_i.append(ii)
    coverage = coverage_fraction(table, dead)
    ranges = dead_item_ranges(table, dead)
    if not parts_s:  # every shard dead: complete, loudly empty
        es, ei = empty_topk(b, k, device=table.shards[0].device)
        return TopKResult(es, ei, coverage, ranges)
    if len(parts_s) == 1:  # nothing to merge; skip the sort
        return TopKResult(parts_s[0], parts_i[0], coverage, ranges)
    ms, mi = topk_merge_shards(
        torch.stack(colocate_parts(parts_s)),
        torch.stack(colocate_parts(parts_i)), k,
    )
    return TopKResult(ms, mi, coverage, ranges)
