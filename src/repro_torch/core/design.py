"""Fielded design matrices for the feature-based models (paper §5.2; port
of ``repro.core.design``).

The paper writes X ∈ R^{|C|×p} as a generic sparse matrix. Production
feature pipelines are *fielded*: the p columns partition into fields (user
id, age bucket, country, device, previous video, watch history, ...), and
each row activates a bounded number of features per field — exactly one
for categorical fields, a variable-length bag for history fields.

Within a ONE-HOT field no two features share a row, so their coordinate
updates touch disjoint residuals and run as one vectorized Newton step
(exact CD). Multi-hot fields share rows; the MFSI solver offers a
sequential scan over bag slots (``slot``) or a damped parallel update over
the whole bag (``jacobi``).

A :class:`Design` stacks all field vocabularies into one (p, k) parameter
matrix with per-field row offsets, matching the paper's flat W ∈ R^{p×k}.
Tensors live on one device (the GPU unless the caller names the CPU,
``kernels.resolve_device``); ids are int64, where the reference keeps
int32 with the same values.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import resolve_device


@dataclasses.dataclass(frozen=True)
class Field:
    """One feature field.

    ids:     (n_rows, bag) int64 — local feature ids (0..vocab-1); padded
             slots may hold any id but must be zero-weighted.
    weights: (n_rows, bag) f32 — x values; 0 for padding. One-hot fields
             have bag == 1 and weight 1 (or a real value for a dense
             scalar feature, a vocab-1 field).
    vocab:   number of features in this field.
    offset:  row offset of this field inside the stacked table.
    one_hot: bag == 1, so per-column updates within the field are exact.
    """

    ids: torch.Tensor
    weights: torch.Tensor
    vocab: int
    offset: int
    one_hot: bool
    name: str = ""

    @property
    def bag(self) -> int:
        return int(self.ids.shape[1])


@dataclasses.dataclass(frozen=True)
class Design:
    fields: Tuple[Field, ...]
    n_rows: int
    p: int  # total features

    def global_ids(self, field: Field) -> torch.Tensor:
        return field.ids + field.offset


def _duplicate_rows(ids: np.ndarray, weights: np.ndarray) -> np.ndarray:
    """Rows of a bag field in which two non-zero-weighted slots carry the
    same id, in ascending order. Each row's slots are sorted by (id,
    inactive), so the active slots of one id are neighbours."""
    active = weights != 0
    key = ids.astype(np.int64) * 2 + (~active)
    order = np.argsort(key, axis=1, kind="stable")
    s_ids = np.take_along_axis(ids, order, axis=1)
    s_act = np.take_along_axis(active, order, axis=1)
    dup = (s_ids[:, 1:] == s_ids[:, :-1]) & s_act[:, 1:] & s_act[:, :-1]
    return np.nonzero(dup.any(axis=1))[0]


def make_design(fields_spec: Sequence[dict], n_rows: int, *,
                device=None) -> Design:
    """Build a design on ``device`` from host arrays.

    Each spec: {name, ids (n_rows,) or (n_rows, bag), vocab, weights
    optional of the same shape}. Within a row, the non-zero-weighted slots
    of a bag must carry distinct ids (bag = set semantics; FM's pairwise
    identity relies on it): a duplicate raises ``ValueError`` naming the
    first such row, as the reference's per-row check does."""
    device = resolve_device(device)
    fields = []
    offset = 0
    for spec in fields_spec:
        ids = np.asarray(spec["ids"], dtype=np.int32)
        if ids.ndim == 1:
            ids = ids[:, None]
        weights = spec.get("weights")
        if weights is None:
            weights = np.ones_like(ids, dtype=np.float32)
        else:
            weights = np.asarray(weights, dtype=np.float32)
            if weights.ndim == 1:
                weights = weights[:, None]
        vocab = int(spec["vocab"])
        assert ids.shape == weights.shape and ids.shape[0] == n_rows
        if ids.shape[1] > 1:
            dup = _duplicate_rows(ids, weights)
            if len(dup):
                raise ValueError(
                    f"field {spec.get('name')}: duplicate ids in row "
                    f"{int(dup[0])}; merge duplicate bag entries before "
                    "make_design")
        fields.append(Field(
            ids=torch.as_tensor(ids.astype(np.int64), device=device),
            weights=torch.as_tensor(weights, device=device),
            vocab=vocab, offset=offset, one_hot=ids.shape[1] == 1,
            name=spec.get("name", f"field{len(fields)}"),
        ))
        offset += vocab
    return Design(fields=tuple(fields), n_rows=n_rows, p=offset)


def take_rows(design: Design, rows) -> Design:
    """Row-subset view of a design: the B query rows of every field, so a
    query batch costs O(B·k), not a full-design product over all
    contexts."""
    rows = torch.as_tensor(rows, dtype=torch.long,
                           device=design.fields[0].ids.device)
    fields = tuple(dataclasses.replace(f, ids=f.ids[rows],
                                       weights=f.weights[rows])
                   for f in design.fields)
    return Design(fields=fields, n_rows=int(rows.shape[0]), p=design.p)


def design_matmul(design: Design, table: torch.Tensor) -> torch.Tensor:
    """Φ = X·W for the stacked table W (p, k): a fielded embedding-bag
    sum, one weighted bag per field and row."""
    out = torch.zeros((design.n_rows, table.shape[1]), dtype=torch.float32,
                      device=table.device)
    for field in design.fields:
        out += F.embedding_bag(design.global_ids(field), table, mode="sum",
                               per_sample_weights=field.weights)
    return out


def design_col_sq_sums(design: Design) -> torch.Tensor:
    """Σ_c x_{c,l}² per feature l — the R'' weights of eq. (24). (p,)"""
    dev = design.fields[0].ids.device
    out = torch.zeros((design.p,), dtype=torch.float32, device=dev)
    for field in design.fields:
        w = field.weights.reshape(-1)
        out.index_add_(0, design.global_ids(field).reshape(-1), w * w)
    return out


def to_dense(design: Design) -> torch.Tensor:
    """Materialize X (n_rows, p) — tests only."""
    dev = design.fields[0].ids.device
    x = torch.zeros((design.n_rows, design.p), dtype=torch.float32, device=dev)
    rows = torch.arange(design.n_rows, device=dev)
    for field in design.fields:
        for j in range(field.bag):
            x.index_put_((rows, field.offset + field.ids[:, j]),
                         field.weights[:, j], accumulate=True)
    return x
