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

:class:`ShardedRetrievalCluster` is the service over these functions:
versioned, double-buffered publishes (``serve/publish.py``), delta
publishes, ``devices=`` placement, the IVF tier (``retrieval='ivf'``,
``serve/ann.py``) and kernel cost recording. The fault-tolerant mesh
(``serve/mesh.py``) builds on the same functions. :func:`shard_map_topk`
is the reference's one-program ``shard_map`` path on
``torch.distributed``: one rank a shard, one kernel launch each, one
all-gather of the candidates, the same merge.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

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

    @property
    def d(self) -> int:
        return int(self.shards[0].shape[1])

    @property
    def offsets(self) -> Tuple[int, ...]:
        return tuple(s * self.rows_per for s in range(self.n_shards))

    def valid_rows(self, s: int) -> int:
        """Admissible rows of shard ``s`` (< rows_per only on the last)."""
        return max(0, min(self.rows_per, self.n_items - s * self.rows_per))

    def stacked(self) -> torch.Tensor:
        """(S, rows_per, D) on the first shard's device, memoized on the
        snapshot (immutable: a publish makes a NEW shard set)."""
        cached = getattr(self, "_stacked_cache", None)
        if cached is None:
            dev = self.shards[0].device
            cached = torch.stack([sh.to(dev) for sh in self.shards])
            object.__setattr__(self, "_stacked_cache", cached)
        return cached


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
    block scores (:func:`vmem.topk_block_items`, the same for every shard
    size)."""
    return vmem.topk_block_items(vmem.topk_k_pad(k))


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


def shard_map_topk(mesh, table: PsiShardSet, phi_rows, k: int, *,
                   exclude_ids=None,
                   block_items: Optional[int] = None) -> TopKResult:
    """Every shard's kernel in one program over ``mesh``'s ranks (one ψ
    shard a rank; φ and the exclude-id lists the same on every rank), then
    the cross-shard merge of the gathered (S, B, K) candidates.

    Every rank of the 1-D ``mesh`` calls it with the same arguments and
    gets the same result. Rank r runs the top-K kernel once over
    ``table.shards[r]`` with ``id_offset = r·rows_per`` and ``n_valid =
    clip(n_items − id_offset, 0, rows_per)``; one all-gather brings the
    candidates, scores and ids packed into one int32 tensor, to every
    rank. Within the port the result equals :func:`cluster_topk`'s bit for
    bit. Exclusion takes the ``exclude_ids`` form only (a dense mask would
    have to be resharded; the id list is global)."""
    from repro_torch.runtime import collectives

    group = collectives.group_of(mesh)
    n_ranks = mesh.size()
    if n_ranks != table.n_shards:
        raise ValueError(f"mesh has {n_ranks} ranks but table has "
                         f"{table.n_shards} shards")
    rank = mesh.get_local_rank()
    if block_items is None:
        block_items = resolve_cluster_block_items(table, k)
    shard = table.shards[rank]
    dev = shard.device
    phi_rows = torch.as_tensor(phi_rows, dtype=torch.float32).to(dev)
    if exclude_ids is not None:
        exclude_ids = torch.as_tensor(exclude_ids, dtype=torch.int32).to(dev)
    ss, ii = topk_score(phi_rows, shard, k, exclude_ids=exclude_ids,
                        id_offset=rank * table.rows_per,
                        n_valid=table.valid_rows(rank),
                        block_items=block_items)
    both = torch.stack((ss.view(torch.int32), ii))[None]     # (1, 2, B, K)
    got = collectives.all_gather(both, group)                # (S, 2, B, K)
    ss, ii = got[:, 0].view(torch.float32), got[:, 1]
    return TopKResult(*topk_merge_shards(ss, ii, k))


class ShardedRetrievalCluster:
    """Sharded retrieval service: versioned ψ shards + merge + refresh::

        cluster = ShardedRetrievalCluster(
            lambda ctx: mf.build_phi(params, ctx), n_shards=4, k=100)
        cluster.publish(mf.export_psi(params))      # version 1 live
        scores, ids = cluster.topk(user_ids)        # == engine, bit-exact
        cluster.publish(mf.export_psi(new_params))  # version 2; in-flight
                                                    # queries finish on v1

    ``publish`` is double-buffered and versioned (``serve/publish.py``):
    each ``topk`` grabs the active :class:`PsiShardSet` once and serves
    the whole request from that snapshot. ``devices=`` places shard s on
    ``devices[s % len(devices)]``. ``mesh=`` takes the one-program path
    (:func:`shard_map_topk`): every rank of the mesh calls ``topk`` and
    runs the kernel on its own shard.
    """

    def __init__(self, phi_fn: Optional[Callable[..., torch.Tensor]] = None,
                 *, n_shards: int = 2, k: int = 100,
                 block_items: Optional[int] = None,
                 devices: Optional[Sequence] = None, psi_table=None,
                 retrieval: str = "exact", ann=None, registry=None):
        from repro_torch.obs.costs import KernelCostRecorder
        from repro_torch.obs.metrics import next_instance_id, resolve_registry
        from repro_torch.serve.publish import VersionedTable

        self.phi_fn = phi_fn
        self.n_shards = int(n_shards)
        self.k = int(k)
        self.block_items = block_items
        self.devices = devices
        if retrieval not in ("exact", "ivf"):
            raise ValueError(f"retrieval must be 'exact' or 'ivf', got {retrieval!r}")
        self.retrieval = retrieval
        self.ann = ann
        self._ivf: dict = {}      # table version → per-shard PsiIndex tuple
        self._table = VersionedTable()
        self.registry = resolve_registry(registry)
        self._costs = KernelCostRecorder(self.registry)
        self._m_queries = self.registry.counter(
            "serve_cluster_queries_total", "cluster topk_phi requests",
            labels=("instance",)).labels(instance=next_instance_id())
        if psi_table is not None:
            self.publish(psi_table)

    # ------------------------------------------------------------- publish
    def publish(self, psi_table) -> int:
        """Shard + version a fresh ψ snapshot and flip it live; returns the
        new version. Never disturbs in-flight readers (double buffer)."""
        return self._table.publish(
            lambda version: shard_psi(psi_table, self.n_shards,
                                      devices=self.devices, version=version))

    def publish_delta(self, rows, ids) -> int:
        """Incremental publish: patch/append ψ ``rows`` at global item
        ``ids`` onto the active table and flip the result live under a
        normal version bump. Appends (ids ≥ n_items) grow the catalogue.

        With ``retrieval='ivf'`` the delta also FOLDS into the live
        per-shard indexes (``serve.ann.fold_delta_indexes``) instead of
        re-running k-means; a delta that changes the shard geometry
        (rows_per) leaves the indexes to a lazy full rebuild. Returns the
        new version."""
        from repro_torch.serve.publish import apply_delta, dense_table

        old_table = self.table
        old_indexes = self._ivf.get(old_table.version)
        version = self.publish(apply_delta(dense_table(old_table), rows, ids))
        if self.retrieval == "ivf" and old_indexes is not None:
            from repro_torch.serve.ann import fold_delta_indexes

            new_table = self.table
            if (new_table.rows_per == old_table.rows_per
                    and new_table.n_shards == old_table.n_shards):
                self._ivf = {version: fold_delta_indexes(
                    old_indexes, new_table, rows, ids, self._ann_cfg(),
                    registry=self.registry)}
        return version

    def _ann_cfg(self):
        from repro_torch.serve.ann import AnnConfig

        return self.ann or AnnConfig()

    def _ivf_indexes(self, table: PsiShardSet):
        """Per-shard IVF indexes for one table snapshot, built lazily and
        memoized on the publish version; only the latest is kept."""
        cached = self._ivf.get(table.version)
        if cached is None:
            from repro_torch.serve.ann import build_shard_indexes

            cached = build_shard_indexes(table, self._ann_cfg())
            self._ivf = {table.version: cached}
        return cached

    @property
    def table(self) -> PsiShardSet:
        """The active (latest published) shard set."""
        return self._table.active

    @property
    def version(self) -> int:
        return self._table.version

    @property
    def n_items(self) -> int:
        return self.table.n_items

    # -------------------------------------------------------------- query
    def phi(self, *query) -> torch.Tensor:
        return torch.as_tensor(self.phi_fn(*query), dtype=torch.float32)

    def topk(self, *query, k: Optional[int] = None, exclude_mask=None,
             exclude_ids=None, mesh=None) -> TopKResult:
        """(scores, ids) :class:`TopKResult`, both (B, k), for a query
        batch (coverage always 1.0: the unreplicated cluster has no
        failure detector; see ``serve/mesh.py`` for the degraded path)."""
        return self.topk_phi(self.phi(*query), k=k, exclude_mask=exclude_mask,
                             exclude_ids=exclude_ids, mesh=mesh)

    def topk_phi(self, phi_rows, *, k: Optional[int] = None,
                 exclude_mask=None, exclude_ids=None, mesh=None) -> TopKResult:
        """Like :meth:`topk` from pre-built φ rows (batcher / eval path).

        ``retrieval='ivf'`` routes through the per-shard IVF indexes: each
        shard prunes to its ``n_probe`` cluster blocks and re-ranks them
        with the exact kernel; the cross-shard merge is unchanged. A dense
        ``exclude_mask`` is sliced per shard on the exact path and refused
        under IVF, as in the reference."""
        table = self.table  # ONE snapshot: version-consistent whole request
        k = k or self.k
        self._m_queries.inc()
        if mesh is not None:
            if exclude_mask is not None:
                raise ValueError(
                    "the shard_map path takes exclude_ids (global id lists),"
                    " not a dense exclude_mask")
            if self.retrieval == "ivf":
                raise ValueError(
                    "retrieval='ivf' serves through the host-loop path; "
                    "the shard_map path is exact-only")
            return shard_map_topk(mesh, table, phi_rows, k,
                                  exclude_ids=exclude_ids,
                                  block_items=self.block_items)
        dev = table.shards[0].device
        phi_rows = torch.as_tensor(phi_rows, dtype=torch.float32).to(dev)
        if exclude_ids is not None:
            exclude_ids = torch.as_tensor(exclude_ids, dtype=torch.int32).to(dev)
        if self.retrieval == "ivf":
            if exclude_mask is not None:
                raise ValueError(
                    "retrieval='ivf' takes exclude_ids (global id lists), "
                    "not a dense exclude_mask")
            from repro_torch.serve.ann import ivf_cluster_topk

            return ivf_cluster_topk(
                table, self._ivf_indexes(table), phi_rows, k,
                exclude_ids=exclude_ids, registry=self.registry)
        from repro_torch.obs.costs import topk_score_cost

        b = int(phi_rows.shape[0])
        excl_l = 0 if exclude_ids is None else int(exclude_ids.shape[1])
        cost = topk_score_cost(b, table.rows_per, table.d, k, excl_l=excl_l,
                               mask=exclude_mask is not None)
        # one kernel call per shard: S× the streams, the same block
        self._costs.record("topk_score", {
            "hbm_bytes": cost["hbm_bytes"] * table.n_shards,
            "flops": cost["flops"] * table.n_shards,
            "smem_bytes": cost["smem_bytes"],
        }, calls=table.n_shards)
        return cluster_topk(table, phi_rows, k, exclude_mask=exclude_mask,
                            exclude_ids=exclude_ids,
                            block_items=self.block_items)
