"""IVF-tiered approximate retrieval: centroid pruning + exact fused re-rank
(port of ``repro.serve.ann``).

The exact serving stack (engine → cluster → mesh) streams the whole ψ
catalogue through the top-K kernel per query. Every zoo model is
k-separable (score = ⟨φ, ψ_i⟩), so indexing the ψ side once speeds up
serving for the whole zoo: this module adds the approximate tier.

:class:`PsiIndex` — an inverted-file (IVF) index over one ψ table (or one
row-range shard of it):

  build     :func:`kmeans` clusters the rows; the table is PERMUTED into
            cluster-contiguous blocks, each padded to the uniform
            ``block_rows``. Within a block, rows keep ascending global id
            (a stable argsort of the assignment), which carries the
            kernel's ascending-id tie policy through the permutation.
  storage   fp32, bf16, or int8 with per-row scales
            (``core.quant.int8_quantize_rows``); the kernel dequantizes
            each row before its fp32 products
            (:func:`repro_torch.kernels.vmem.psi_row_bytes`).
  query     φ·centroidᵀ scores pick each row's top ``n_probe`` clusters
            (a device-side probe mask); only the selected blocks' valid
            rows are scored, exactly, by the top-K kernel's IVF form, which
            ranks them by (−score, ascending global id) through
            ``ids_global``.
  oracle    ``n_probe ≥ n_clusters`` probes everything with no pruning
            step and is then bit-identical (ids and scores) to the exact
            path on the card: the kernel's per-row fp32 dot does not
            depend on where the row sits, blocks partition the catalogue,
            and a global top-K element is its own block's top-K element
            under the same total order.
  delta     ``apply_delta`` folds published rows in place: patched ids
            re-quantize in their slot, appended ids join their nearest
            centroid's block. Every folded row bumps ``staleness``; past
            ``AnnConfig.reindex_after`` the owner rebuilds the index from
            the authoritative table (``needs_reindex``).

One launch chain per query and index: the reference dispatches the kernel
once per probed block and merges the blocks' candidates by global id (a
TPU program's design). Here the probe mask stays on the device and the
top-K kernel's IVF form (``topk_score_ivf``) scores every probed block's
valid rows in one pass 1 over a (cluster, chunk) list built on the device,
its keys carrying global ids, then merges them: the same result, since
within a block positions ascend with global id.

k-means is seeded through an explicit CPU ``torch.Generator`` (distinct
rows by ``torch.randperm``), which cannot reproduce the reference's
``jax.random.choice(PRNGKey(seed), ...)``: for the same seed the two
packages build different indexes, and pruned results differ with them.
:func:`index_from_numpy` builds the port's index from a k-means result of
the reference (centroids and assignment), which is how the two are held
against each other.

Exclusion: callers pass GLOBAL ``exclude_ids``; the kernel compares them
with the scored rows' global ids (``ids_global``). Sharding: each shard of a
``PsiShardSet`` gets its own index over its row range
(:func:`build_shard_indexes`), and :func:`ivf_cluster_topk` merges the
shards' candidates as ``cluster.cluster_topk`` does.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.gram import full_fp32
from repro_torch.core.quant import int8_quantize_rows
from repro_torch.kernels.topk_score.ops import (
    topk_merge_shards,
    topk_score_ivf,
)
from repro_torch.kernels.vmem import TOPK_MAX_CHUNK
from repro_torch.obs.costs import KernelCostRecorder, topk_score_ivf_cost
from repro_torch.serve.cluster import (
    PsiShardSet,
    TopKResult,
    colocate_parts,
    coverage_fraction,
    dead_item_ranges,
    empty_topk,
)

_QUANTS = ("none", "bf16", "int8")
_PSI_BYTES = {"none": 4, "bf16": 2, "int8": 1}


@dataclasses.dataclass(frozen=True)
class AnnConfig:
    """Knobs for the IVF tier (engine/cluster/mesh take one of these).

    ``n_clusters=0`` auto-sizes to ≈√n (centroid scan cost ≈ probed-block
    cost). ``n_probe=0`` auto-sizes to ``max(1, n_clusters // 4)``.
    ``quant`` picks the ψ storage form; ``reindex_after`` is the staleness
    budget: after that many folded-in delta rows the owner rebuilds the
    index (fresh k-means) instead of folding further."""

    n_clusters: int = 0
    n_probe: int = 0
    quant: str = "none"
    kmeans_iters: int = 8
    seed: int = 0
    reindex_after: int = 64

    def __post_init__(self):
        if self.quant not in _QUANTS:
            raise ValueError(f"quant must be one of {_QUANTS}, got {self.quant!r}")

    def resolve_clusters(self, n_rows: int) -> int:
        c = self.n_clusters or max(1, int(round(float(n_rows) ** 0.5)))
        return max(1, min(c, n_rows))

    def resolve_probe(self, n_clusters: int) -> int:
        p = self.n_probe or max(1, n_clusters // 4)
        return max(1, min(p, n_clusters))


def _assign(psi: torch.Tensor, x_sq: torch.Tensor,
            centroids: torch.Tensor) -> torch.Tensor:
    """Nearest centroid of each row by ``|x|² − 2x·c + |c|²``; ties take
    the lowest cluster (``argmin`` returns the first minimum)."""
    with full_fp32():
        d2 = (x_sq[:, None] - 2.0 * (psi @ centroids.T)
              + (centroids * centroids).sum(dim=1)[None])
    return torch.argmin(d2, dim=1)


def _lloyd(psi: torch.Tensor, centroids: torch.Tensor,
           n_iters: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``n_iters`` Lloyd steps from ``centroids``: ``(centroids, assign)``.

    A step assigns every row to its nearest centroid and moves each
    centroid to its members' mean; a cluster that loses all members keeps
    its centroid. The member sums are one one-hot product, a fixed-order
    reduction (no atomics), so the card gives the same bits every run."""
    n = psi.shape[0]
    c = centroids.shape[0]
    x_sq = (psi * psi).sum(dim=1)
    for _ in range(n_iters):
        a = _assign(psi, x_sq, centroids)
        onehot = torch.zeros((c, n), dtype=psi.dtype, device=psi.device)
        onehot[a, torch.arange(n, device=psi.device)] = 1.0
        with full_fp32():
            sums = onehot @ psi
        cnt = onehot.sum(dim=1)
        centroids = torch.where(cnt[:, None] > 0,
                                sums / torch.clamp(cnt, min=1.0)[:, None],
                                centroids)
    return centroids, _assign(psi, x_sq, centroids)


def kmeans(psi, n_clusters: int, *, n_iters: int = 8,
           seed: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lloyd's k-means: ``(centroids (C, D) f32, assign (n,) int64)``.

    The initial centroids are ``n_clusters`` distinct rows drawn by a CPU
    ``torch.Generator`` seeded with ``seed`` (the same rows on any
    device); empty clusters keep their centroid, and their blocks hold no
    valid rows."""
    psi = torch.as_tensor(psi).float()
    n = psi.shape[0]
    if not 1 <= n_clusters <= n:
        raise ValueError(f"need 1 <= n_clusters <= {n}, got {n_clusters}")
    gen = torch.Generator().manual_seed(int(seed))
    init = torch.randperm(n, generator=gen)[:n_clusters].to(psi.device)
    return _lloyd(psi, psi[init], n_iters)


def _quantize(perm: torch.Tensor, quant: str):
    """Stored form of the permuted table: ``(psi_q, scales or None)``."""
    if quant == "int8":
        return int8_quantize_rows(perm)
    if quant == "bf16":
        return perm.to(torch.bfloat16), None
    return perm, None


def _layout(psi: torch.Tensor, assign: torch.Tensor, n_clusters: int, cfg,
            id_offset: int, centroids: torch.Tensor) -> "PsiIndex":
    """Permute ``psi`` into cluster-contiguous blocks of ``block_rows``
    (a multiple of 8) and quantize it. A stable argsort of the assignment
    keeps each block's rows in ascending id; a row's slot in its block is
    its index in the sorted order minus its cluster's start."""
    n, d = psi.shape
    dev = psi.device
    assign = assign.to(dev, torch.int64)
    counts_t = torch.bincount(assign, minlength=n_clusters)
    counts = counts_t.cpu().numpy().astype(np.int64)
    block_rows = -(-max(int(counts.max()), 1) // 8) * 8
    order = torch.sort(assign, stable=True).indices
    sorted_cl = assign[order]
    starts = torch.cumsum(counts_t, 0) - counts_t
    slot = torch.arange(n, device=dev) - starts[sorted_cl]
    pos = torch.empty(n, dtype=torch.int64, device=dev)
    pos[order] = sorted_cl * block_rows + slot
    perm = torch.zeros((n_clusters * block_rows, d), dtype=torch.float32,
                       device=dev)
    perm[pos] = psi
    ids_global = torch.full((n_clusters * block_rows,), -1, dtype=torch.int32,
                            device=dev)
    ids_global[pos] = (id_offset + torch.arange(n, device=dev)).to(torch.int32)
    psi_q, scales = _quantize(perm, cfg.quant)
    return PsiIndex(
        cfg=cfg, centroids=centroids.float().to(dev), psi_q=psi_q,
        scales=scales, ids_global=ids_global, inv_pos=pos.to(torch.int32),
        counts=counts, block_rows=block_rows, id_offset=int(id_offset),
        n_rows=n, staleness=0,
    )


def index_from_numpy(psi, centroids, assign, cfg: AnnConfig, *,
                     id_offset: int = 0, device="cuda") -> "PsiIndex":
    """The port's index over ``psi`` from a given k-means result (numpy
    ``centroids`` (C, D) and ``assign`` (n,)), e.g. the reference's: the
    layout and storage are then the reference's for the same clustering."""
    psi = torch.as_tensor(np.array(psi, np.float32), device=device)
    cents = torch.as_tensor(np.array(centroids, np.float32), device=device)
    assign = torch.as_tensor(np.array(assign, np.int64), device=device)
    return _layout(psi, assign, int(cents.shape[0]), cfg, id_offset, cents)


class PsiIndex:
    """IVF index over one ψ table / shard: cluster-permuted quantized
    storage + centroid pruning + exact fused re-rank. Construct with
    :meth:`build` (or :func:`index_from_numpy`); treat instances as
    immutable (``apply_delta`` returns a new index). Everything but the
    per-cluster ``counts`` lives on the table's device."""

    def __init__(self, *, cfg, centroids, psi_q, scales, ids_global,
                 inv_pos, counts, block_rows, id_offset, n_rows, staleness):
        self.cfg = cfg
        self.centroids = centroids        # (C, D) f32
        self.psi_q = psi_q                # (C·block_rows, D) stored dtype
        self.scales = scales              # (C·block_rows,) f32 | None (int8)
        self.ids_global = ids_global      # (C·block_rows,) i32, −1 on pads
        self.inv_pos = inv_pos            # (n_rows,) i32: local id → position
        self.counts = counts              # np (C,) valid rows per cluster
        self.counts_dev = torch.as_tensor(  # the same, on the device
            counts, dtype=torch.int32, device=psi_q.device)
        self.block_rows = block_rows      # uniform padded block size
        self.id_offset = id_offset        # global id of local row 0
        self.n_rows = n_rows              # valid rows indexed
        self.staleness = staleness        # delta rows folded since build

    # -------------------------------------------------------------- build
    @classmethod
    def build(cls, psi, cfg: AnnConfig = AnnConfig(), *,
              id_offset: int = 0) -> "PsiIndex":
        psi = torch.as_tensor(psi).float().contiguous()
        n = psi.shape[0]
        if n < 1:
            raise ValueError("cannot index an empty ψ table")
        c = cfg.resolve_clusters(n)
        centroids, assign = kmeans(psi, c, n_iters=cfg.kmeans_iters,
                                   seed=cfg.seed)
        return _layout(psi, assign, c, cfg, id_offset, centroids)

    # --------------------------------------------------------- properties
    @property
    def n_clusters(self) -> int:
        return int(self.centroids.shape[0])

    @property
    def d(self) -> int:
        return int(self.centroids.shape[1])

    @property
    def quant(self) -> str:
        return self.cfg.quant

    @property
    def device(self) -> torch.device:
        return self.psi_q.device

    def needs_reindex(self) -> bool:
        """Staleness budget exhausted: folded-in deltas have drifted the
        catalogue past what frozen centroids index well — rebuild."""
        return self.staleness > self.cfg.reindex_after

    # -------------------------------------------------------------- query
    def topk(self, phi_rows, k: int, *, n_probe: Optional[int] = None,
             exclude_ids=None, block_items: Optional[int] = None,
             registry=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Approximate top-K: ``(scores (B, k), ids (B, k))``, ids GLOBAL.

        Each φ row probes its own top-``n_probe`` clusters (a stable sort
        of the centroid scores, ties to the lower cluster), as a (B, C)
        probe mask built on the index's device; ``n_probe ≥ n_clusters``
        probes every cluster (the bit-exact oracle). One call of the top-K
        kernel's IVF form (``topk_score_ivf``) then ranks the probed
        clusters' valid rows by (−score, global id), which is the
        reference's per-block top-K followed by its merge by global id:
        within a block, positions ascend with global id. Nothing is copied
        to the host before the launch.

        ``registry`` opts into the query and probed-block counters and the
        launch's kernel cost at the stored width (read from the probe mask
        after the launch); ``None`` records nothing."""
        dev = self.device
        phi_rows = torch.as_tensor(phi_rows, dtype=torch.float32).to(dev)
        phi_rows = phi_rows.contiguous()
        b = int(phi_rows.shape[0])
        c = self.n_clusters
        n_probe = self.cfg.resolve_probe(c) if n_probe is None else n_probe
        if n_probe >= c:                      # oracle: prune nothing
            probe = torch.ones((b, c), dtype=torch.bool, device=dev)
        else:
            with full_fp32():
                cscores = phi_rows @ self.centroids.T   # (B, C): C ≪ n_items
            sel = torch.sort(cscores, dim=1, descending=True,
                             stable=True).indices[:, :n_probe]
            probe = torch.zeros((b, c), dtype=torch.bool, device=dev)
            probe.scatter_(1, sel, True)
        ex = None
        if exclude_ids is not None:
            ex = torch.as_tensor(exclude_ids, dtype=torch.int32,
                                 device=dev).contiguous()
        chunk = block_items or TOPK_MAX_CHUNK
        scores, ids = topk_score_ivf(
            phi_rows, self.psi_q, k, probe_mask=probe,
            counts=self.counts_dev, ids_global=self.ids_global,
            block_rows=self.block_rows, exclude_ids=ex,
            psi_scale=self.scales, block_items=chunk,
            max_lists=max(1, int((-(-self.counts // chunk)).sum())))
        if registry is not None and registry:   # NULL_REGISTRY is falsy
            live = probe.any(dim=0) & (self.counts_dev > 0)
            probed = int(live.sum())
            rows = int(self.counts_dev[live].sum())
            registry.counter(
                "ann_queries_total", "PsiIndex.topk dispatches").inc()
            registry.counter(
                "ann_probed_blocks_total",
                "IVF blocks actually dispatched (post-pruning)").inc(probed)
            KernelCostRecorder(registry).record("topk_score_ivf",
                                                topk_score_ivf_cost(
                b, rows, self.d, k, c, psi_bytes=_PSI_BYTES[self.cfg.quant],
                per_row_scale=self.cfg.quant == "int8",
                excl_l=0 if ex is None else int(ex.shape[1])))
        return scores, ids

    # -------------------------------------------------------------- delta
    def apply_delta(self, rows, ids) -> "PsiIndex":
        """Fold published delta rows into the index without re-clustering.

        Patched ids (already indexed) re-quantize in their existing slot —
        position, hence tie order, is unchanged. Appended ids (must extend
        the local range contiguously, the ``publish.apply_delta`` hole
        rule) join their NEAREST centroid's block; a full block grows every
        block by 8 rows (untouched rows are moved, not re-quantized). Every
        folded row bumps ``staleness``. The fold runs on host copies, one
        row at a time in ascending id, as in the reference."""
        rows = torch.as_tensor(rows).float().cpu().numpy().reshape(
            -1, self.d)
        ids = np.asarray(ids, np.int64).reshape(-1)
        if rows.shape[0] != ids.shape[0]:
            raise ValueError(f"{rows.shape[0]} rows vs {ids.shape[0]} ids")
        order = np.argsort(ids, kind="stable")
        rows, ids = rows[order], ids[order]

        counts = self.counts.copy()
        block_rows = self.block_rows
        c = self.n_clusters
        stored_dtype = self.psi_q.dtype
        # bf16 has no numpy dtype: fold on its fp32 values (exact) and
        # round the stored rows back at the end
        psi_q = (self.psi_q.float() if stored_dtype == torch.bfloat16
                 else self.psi_q).cpu().numpy().copy()
        scales = None if self.scales is None else self.scales.cpu().numpy().copy()
        ids_global = self.ids_global.cpu().numpy().copy()
        inv_pos = self.inv_pos.cpu().numpy().copy()
        centroids = self.centroids.cpu().numpy()
        n_rows = self.n_rows

        def grow(new_block_rows):
            nonlocal psi_q, scales, ids_global, inv_pos, block_rows
            nq = np.zeros((c * new_block_rows,) + psi_q.shape[1:], psi_q.dtype)
            ng = np.full(c * new_block_rows, -1, np.int32)
            ns = None if scales is None else np.zeros(
                c * new_block_rows, np.float32)
            for cl in range(c):
                src, dst = cl * block_rows, cl * new_block_rows
                nq[dst: dst + block_rows] = psi_q[src: src + block_rows]
                ng[dst: dst + block_rows] = ids_global[src: src + block_rows]
                if ns is not None:
                    ns[dst: dst + block_rows] = scales[src: src + block_rows]
            psi_q, ids_global, scales = nq, ng, ns
            valid = inv_pos >= 0
            inv_pos = np.where(
                valid,
                (inv_pos // block_rows) * new_block_rows
                + (inv_pos % block_rows),
                -1,
            ).astype(np.int32)
            block_rows = new_block_rows

        for row, gid in zip(rows, ids):
            local = int(gid) - self.id_offset
            if 0 <= local < n_rows:                       # patch in place
                pos = int(inv_pos[local])
                self._store_row(psi_q, scales, pos, row)
            elif local == n_rows:                         # contiguous append
                d2 = np.sum((centroids - row[None]) ** 2, axis=1)
                cl = int(np.argmin(d2))
                if counts[cl] >= block_rows:
                    grow(block_rows + 8)
                pos = cl * block_rows + int(counts[cl])
                counts[cl] += 1
                self._store_row(psi_q, scales, pos, row)
                ids_global[pos] = int(gid)
                inv_pos = np.append(inv_pos, np.int32(pos))
                n_rows += 1
            else:
                raise ValueError(
                    f"delta id {int(gid)} is outside [{self.id_offset}, "
                    f"{self.id_offset + n_rows}] — appends must be "
                    "contiguous (publish.apply_delta's hole rule)"
                )
        dev = self.device
        return PsiIndex(
            cfg=self.cfg, centroids=self.centroids,
            psi_q=torch.as_tensor(psi_q, device=dev).to(stored_dtype),
            scales=None if scales is None else torch.as_tensor(scales, device=dev),
            ids_global=torch.as_tensor(ids_global, device=dev),
            inv_pos=torch.as_tensor(inv_pos, device=dev),
            counts=counts, block_rows=block_rows, id_offset=self.id_offset,
            n_rows=n_rows, staleness=self.staleness + len(ids),
        )

    def _store_row(self, psi_q, scales, pos, row):
        """Quantize ONE row into storage slot ``pos`` (delta fold-in)."""
        if self.cfg.quant == "int8":
            absmax = max(float(np.max(np.abs(row))), 1e-12)
            scale = absmax / 127.0
            psi_q[pos] = np.clip(
                np.round(row / scale), -127, 127
            ).astype(psi_q.dtype)
            scales[pos] = scale
        elif self.cfg.quant == "bf16":
            psi_q[pos] = torch.as_tensor(row).to(torch.bfloat16).float().numpy()
        else:
            psi_q[pos] = row.astype(psi_q.dtype)


# ---------------------------------------------------------------- sharding
def build_shard_indexes(table: PsiShardSet,
                        cfg: AnnConfig) -> Tuple[Optional[PsiIndex], ...]:
    """One :class:`PsiIndex` per shard of ``table``, each over its VALID
    rows with ``id_offset`` = the shard's row-range start — per-shard
    candidates come out with global ids, so the cross-shard merge applies
    unchanged. A shard with zero valid rows gets ``None``."""
    out = []
    for s in range(table.n_shards):
        valid = table.valid_rows(s)
        if valid <= 0:
            out.append(None)
            continue
        out.append(PsiIndex.build(
            table.shards[s][:valid], cfg, id_offset=s * table.rows_per))
    return tuple(out)


def fold_delta_indexes(indexes: Sequence[Optional[PsiIndex]],
                       new_table: PsiShardSet, rows, ids, cfg: AnnConfig, *,
                       registry=None) -> Tuple[Optional[PsiIndex], ...]:
    """Per-shard delta fold-in after a ``publish_delta``: route each
    changed/appended row to its owning shard's index, fold it in, and
    REBUILD any index whose staleness budget is spent (or whose shard just
    materialized) from the authoritative ``new_table`` slab. Callers must
    have checked that the shard geometry (``rows_per``/``n_shards``) is
    unchanged. ``registry`` opts into the reindex counter (``None``
    records nothing)."""
    rows = torch.as_tensor(rows).float().cpu()
    rows = rows.reshape(-1, rows.shape[-1])
    ids = np.asarray(ids, np.int64).reshape(-1)
    shard_of = ids // new_table.rows_per
    out = []
    rebuilt = 0
    for s in range(new_table.n_shards):
        idx = indexes[s] if s < len(indexes) else None
        hit = shard_of == s
        if hit.any() and idx is not None:
            idx = idx.apply_delta(rows[torch.as_tensor(hit)], ids[hit])
        # idx None with hits: the shard just gained its first rows — the
        # rebuild below indexes it from the authoritative table
        if (idx is None or idx.needs_reindex()) and new_table.valid_rows(s) > 0:
            idx = PsiIndex.build(
                new_table.shards[s][: new_table.valid_rows(s)], cfg,
                id_offset=s * new_table.rows_per)
            rebuilt += 1
        out.append(idx)
    if registry is not None and registry and rebuilt:
        registry.counter(
            "ann_reindexes_total",
            "per-shard IVF index rebuilds triggered by the staleness "
            "budget (needs_reindex) or a newly materialized shard",
        ).inc(rebuilt)
    return tuple(out)


def ivf_cluster_topk(table: PsiShardSet,
                     indexes: Sequence[Optional[PsiIndex]], phi_rows, k: int,
                     *, n_probe: Optional[int] = None, exclude_ids=None,
                     dead_shards: Sequence[int] = (),
                     registry=None) -> TopKResult:
    """Sharded IVF top-K: per-shard :meth:`PsiIndex.topk` candidates (each
    shard prunes to its own ``n_probe`` blocks) + the same cross-shard
    merge and coverage/degradation contract as ``cluster.cluster_topk``."""
    phi_rows = torch.as_tensor(phi_rows, dtype=torch.float32)
    b = int(phi_rows.shape[0])
    dead = set(dead_shards)
    parts_s, parts_i = [], []
    for s in range(table.n_shards):
        if s in dead or indexes[s] is None:
            continue
        ss, ii = indexes[s].topk(phi_rows, k, n_probe=n_probe,
                                 exclude_ids=exclude_ids, registry=registry)
        parts_s.append(ss)
        parts_i.append(ii)
    coverage = coverage_fraction(table, dead)
    ranges = dead_item_ranges(table, dead)
    if not parts_s:
        es, ei = empty_topk(b, k, device=table.shards[0].device)
        return TopKResult(es, ei, coverage, ranges)
    if len(parts_s) == 1:
        return TopKResult(parts_s[0], parts_i[0], coverage, ranges)
    ms, mi = topk_merge_shards(
        torch.stack(colocate_parts(parts_s)),
        torch.stack(colocate_parts(parts_i)), k)
    return TopKResult(ms, mi, coverage, ranges)
