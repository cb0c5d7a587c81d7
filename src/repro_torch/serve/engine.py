"""Model-agnostic retrieval engine over the fused score + top-K kernel
(port of ``repro.serve.engine``).

Every k-separable model scores an item as ``ŷ = ⟨φ(context), ψ(item)⟩``,
so one retrieval path serves the zoo. Each model exports
``export_psi(params) -> (n_items, D)`` (the catalogue ψ table) and
``build_phi(params, query) -> (B, D)`` (φ rows for a query batch); for MF,
ψ = ``params.h`` and φ = ``w[ctx]``. The engine is (ψ table, φ builder):
``topk`` runs the fused kernel (``kernels/topk_score``), which never
materializes the (B, n_items) score matrix.

Exclusion forms:

  * ``exclude_ids`` (B, L) int32, −1-padded per-row GLOBAL id lists
    (:func:`exclude_ids_from_lists`) — the form the kernel takes;
  * ``exclude_mask`` (B, n_items) bool (:func:`exclude_mask_from_lists`)
    — the dense form, for query-batch-sized test and oracle use.

``retrieval='ivf'`` indexes the ψ table once at construction
(``serve/ann.py``) and serves through centroid pruning and the exact
kernel over the probed blocks; it takes the ``exclude_ids`` form only.

:meth:`RetrievalEngine.from_model` builds the engine from a
:mod:`repro_torch.core.models.api` adapter, which also lets it fold in an
unseen user at request time (:meth:`RetrievalEngine.fold_in_phi`).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.gram import full_fp32
from repro_torch.kernels import resolve_device
from repro_torch.kernels.topk_score.ops import topk_score
from repro_torch.obs.costs import KernelCostRecorder
from repro_torch.obs.metrics import resolve_registry
from repro_torch.serve.cluster import TopKResult

def exclude_ids_from_lists(item_lists: Sequence, *, min_width: int = 1,
                           device=None) -> torch.Tensor:
    """(B, L) int32, −1-padded: ragged per-row GLOBAL excluded-id lists in
    the kernel's exclude form, on ``device`` (the GPU unless the caller
    names the CPU). L is the widest row (≥ ``min_width``); host cost is
    O(Σ|list|), never O(B·n_items)."""
    width = max(min_width, max((len(ids) for ids in item_lists), default=0))
    out = np.full((len(item_lists), width), -1, np.int32)
    for r, ids in enumerate(item_lists):
        ids = np.asarray(ids, np.int64).reshape(-1)
        out[r, : ids.size] = ids
    return torch.as_tensor(out, device=resolve_device(device))


def exclude_mask_from_lists(item_lists: Sequence, n_items: int, *,
                            device=None) -> torch.Tensor:
    """(B, n_items) bool mask from ragged per-row item-id lists — the DENSE
    form, for query-batch-sized test and oracle use only."""
    mask = np.zeros((len(item_lists), n_items), dtype=bool)
    for r, ids in enumerate(item_lists):
        ids = np.asarray(ids, dtype=np.int64)
        if ids.size:
            mask[r, ids] = True
    return torch.as_tensor(mask, device=resolve_device(device))


class RetrievalEngine:
    """Serve top-K retrieval for any k-separable model::

        engine = RetrievalEngine(mf.export_psi(params),
                                 lambda ctx: mf.build_phi(params, ctx))
        scores, ids = engine.topk(user_ids, k=100)

    ``topk`` follows the kernel: ties in ascending id, (−inf, −1) in slots
    with no admissible candidate. A single-device engine has no failure
    modes, so its results' ``coverage`` is always 1.0."""

    def __init__(self, psi_table: torch.Tensor,
                 phi_fn: Callable[..., torch.Tensor], *, k: int = 100,
                 block_items: Optional[int] = None, retrieval: str = "exact",
                 ann=None, registry=None):
        if retrieval not in ("exact", "ivf"):
            raise ValueError(
                f"retrieval must be 'exact' or 'ivf', got {retrieval!r}")
        self.psi = torch.as_tensor(psi_table).float().contiguous()
        self.phi_fn = phi_fn
        self.k = k
        self.block_items = block_items
        self.retrieval = retrieval
        self.registry = resolve_registry(registry)
        self._costs = KernelCostRecorder(self.registry)
        self.index = None
        self.ann = ann
        self.model = None
        self._params = None
        if retrieval == "ivf":
            # the engine's ψ is fixed at construction, so the IVF tier
            # indexes it once, eagerly
            from repro_torch.serve.ann import AnnConfig, PsiIndex

            self.ann = ann or AnnConfig()
            self.index = PsiIndex.build(self.psi, self.ann)

    @classmethod
    def from_model(cls, model, params, *, k: int = 100,
                   block_items: Optional[int] = None, retrieval: str = "exact",
                   ann=None, registry=None) -> "RetrievalEngine":
        """An engine from a :class:`repro_torch.core.models.api.Model`
        adapter, the unified construction path::

            engine = RetrievalEngine.from_model(model, params, k=100)
            res = engine.topk(query)                  # model's query space
            phi = engine.fold_in_phi(unseen_history)  # request-time fold-in

        The engine keeps (model, params), so the serving tier can fold in
        an UNSEEN user at request time: the user's history is solved to a
        φ row against the frozen ψ table (single-row CD,
        ``core/foldin.py``) without touching training state."""
        eng = cls(model.export_psi(params),
                  lambda *query: model.build_phi(
                      params, query[0] if len(query) == 1 else query),
                  k=k, block_items=block_items, retrieval=retrieval, ann=ann,
                  registry=registry)
        eng.model = model
        eng._params = params
        return eng

    def fold_in_phi(self, item_ids, y=None, alpha=None, **kw) -> torch.Tensor:
        """(1, D) φ row, on the ψ table's device, for an unseen user folded
        in from their item history against the frozen ψ snapshot. Only on
        engines built with :meth:`from_model`."""
        if self.model is None:
            raise RuntimeError(
                "fold_in_phi needs a Model adapter — build the engine with "
                "RetrievalEngine.from_model(model, params)")
        row = self.model.fold_in_user(self._params, item_ids, y, alpha, **kw)
        return row.float().to(self.psi.device)[None, :]

    @property
    def n_items(self) -> int:
        return int(self.psi.shape[0])

    def phi(self, *query) -> torch.Tensor:
        """φ rows for a query batch — (B, D), on the ψ table's device."""
        return torch.as_tensor(self.phi_fn(*query)).float().to(
            self.psi.device).contiguous()

    def topk(self, *query, k: Optional[int] = None, exclude_mask=None,
             exclude_ids=None) -> TopKResult:
        """(scores, ids) :class:`~repro_torch.serve.cluster.TopKResult`,
        both (B, k), for a query batch."""
        return self.topk_phi(self.phi(*query), k=k, exclude_mask=exclude_mask,
                             exclude_ids=exclude_ids)

    def topk_phi(self, phi_rows, *, k: Optional[int] = None,
                 exclude_mask=None, exclude_ids=None) -> TopKResult:
        """Like :meth:`topk` but from pre-built φ rows (the eval path).

        ``retrieval='ivf'`` routes through the engine's
        :class:`~repro_torch.serve.ann.PsiIndex`; with ``ann.n_probe >=
        n_clusters`` the result is the exact path's. The IVF tier takes
        ``exclude_ids`` only: a dense mask is indexed by catalogue position,
        which an approximate tier must not depend on."""
        if self.retrieval == "ivf":
            if exclude_mask is not None:
                raise ValueError(
                    "retrieval='ivf' takes exclude_ids (global id lists), "
                    "not a dense exclude_mask")
            s, i = self.index.topk(phi_rows, k or self.k,
                                   exclude_ids=exclude_ids,
                                   block_items=self.block_items,
                                   registry=self.registry)
            return TopKResult(s, i)
        b = int(phi_rows.shape[0])
        excl_l = 0 if exclude_ids is None else int(exclude_ids.shape[1])
        self._costs.record_topk(b, self.n_items, int(self.psi.shape[1]),
                                k or self.k, excl_l=excl_l,
                                mask=exclude_mask is not None)
        s, i = topk_score(phi_rows, self.psi, k or self.k, exclude_mask,
                          exclude_ids=exclude_ids,
                          block_items=self.block_items)
        return TopKResult(s, i)

    def scores(self, phi_rows) -> torch.Tensor:
        """Dense (B, n_items) scores — small batches and tests ONLY."""
        with full_fp32():
            return phi_rows @ self.psi.T


def bulk_score(forward: Callable, batch, chunk: int = 65536):
    """Offline scoring of a huge batch in fixed-size chunks. ``batch`` is
    a tensor or a tuple/list/dict of tensors with a shared first axis."""
    def piece(x, lo):
        if isinstance(x, dict):
            return {key: piece(v, lo) for key, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(piece(v, lo) for v in x)
        return x[lo: lo + chunk]

    first = batch
    while isinstance(first, (dict, tuple, list)):
        first = next(iter(first.values())) if isinstance(first, dict) else first[0]
    n = first.shape[0]
    return torch.cat([forward(piece(batch, lo)) for lo in range(0, n, chunk)],
                     dim=0)


def mf_retrieval_score_fn(user_vec, item_table):
    """The paper-native separable retrieval: one (k)·(k, N) mat-vec per id
    chunk, or a (B, k)·(k, N) product when ``user_vec`` is a (B, k)
    batch."""

    def score(ids):
        rows = item_table[torch.as_tensor(ids, device=item_table.device)]
        with full_fp32():
            if user_vec.dim() == 1:
                return rows @ user_vec                 # (c,)
            return (rows @ user_vec.T).T               # (B, c)

    return score
