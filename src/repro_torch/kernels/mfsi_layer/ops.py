"""Public wrapper for iCD-MFSI's field layer on the flat layout (no JAX
counterpart kernel: the JAX package's field layer is XLA ops).

A CUDA tensor launches the hand-written kernels (``csrc/mfsi_layer.cu``);
a CPU tensor takes the plain version (``ref.field_layer_ref``)."""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import on_cuda
from repro_torch.kernels.mfsi_layer import kernel
from repro_torch.kernels.mfsi_layer.ref import field_layer_ref
from repro_torch.sparse.segment import segment_sum


class FieldLayer(NamedTuple):
    """One field layer, as :func:`prepare` leaves it for a side sweep."""
    ids: torch.Tensor   # (n,) int64 global feature ids
    xw: torch.Tensor    # (n,) float32 weights x
    rows: torch.Tensor  # (n,) int64 row of each entry
    cnt: torch.Tensor   # (vocab,) Σ x² a feature
    vocab: int
    offset: int
    eta: float
    identity: bool      # one entry a row: entry n is row n


class Scratch(NamedTuple):
    sums: torch.Tensor            # (3·vocab,) zeros between layers
    delta: torch.Tensor           # (vocab,)
    acc: Optional[torch.Tensor]   # (n_rows,) zeros between layers, where a bag is
    dphi: torch.Tensor            # (n_rows,) the last layer's dφ


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"mfsi field_layer: {msg}")


def prepare(layers, n_rows: int) -> tuple:
    """The layers of ``mfsi._field_layers`` — (global ids, weights, rows,
    vocab, offset, η) each, rows 0..n_rows − 1 wherever a layer has one
    entry a row — as :class:`FieldLayer` with their Σ x² by feature, and
    the scratch of a side sweep. Once a side sweep: the checks live here."""
    out = []
    for ids, xw, rows, vocab, offset, eta in layers:
        ids, xw, rows = ids.contiguous(), xw.contiguous(), rows.contiguous()
        n = ids.shape[0]
        _check(ids.dtype == torch.int64 and rows.dtype == torch.int64
               and xw.dtype == torch.float32 and xw.shape == rows.shape == (n,),
               "a layer takes (n,) int64 ids and rows and float32 weights")
        out.append(FieldLayer(ids, xw, rows, segment_sum(xw * xw, ids - offset, vocab),
                              int(vocab), int(offset), float(eta), n == n_rows))
    dev = out[0].ids.device
    vocab = max(layer.vocab for layer in out)
    bag = not all(layer.identity for layer in out)
    scratch = Scratch(torch.zeros(3 * vocab, dtype=torch.float32, device=dev),
                      torch.empty(vocab, dtype=torch.float32, device=dev),
                      torch.zeros(n_rows, dtype=torch.float32, device=dev) if bag else None,
                      torch.empty(n_rows, dtype=torch.float32, device=dev))
    return out, scratch


def field_layer(layer: FieldLayer, table_col, phi_col, q, r_vec, p2, jff, scratch: Scratch,
                *, alpha0: float, l2: float) -> torch.Tensor:
    """One field layer's Newton step in one dimension f*: every feature
    of the layer steps at once (one-hot fields exactly, a Jacobi bag as
    one damped step). ``table_col`` (p,) the embedding table's column f*
    and ``phi_col`` (n_rows,) Φ's, any stride, and the caches ``q``,
    ``r_vec`` (n_rows,) are updated in place; ``p2`` (n_rows,) and ``jff``
    (J(f*, f*), a 0-dim tensor) are read. Returns the rows' dφ (n_rows,)
    for the caller's residual patch: on CUDA ``scratch.dphi``, which the
    next layer overwrites.

    On CUDA three launches (four for a bag; ``field_layer.launches``); every
    float tensor float32, ``q``, ``r_vec`` and ``p2`` contiguous. The sums
    are atomics, so their last bits can change from run to run."""
    if not on_cuda(table_col, q):
        return field_layer_ref(layer, table_col, phi_col, q, r_vec, p2, jff, alpha0=alpha0,
                               l2=l2)
    n_rows = q.shape[0]
    _check(all(t.dtype == torch.float32 for t in (table_col, phi_col, q, r_vec, p2, jff))
           and q.is_contiguous() and r_vec.is_contiguous() and p2.is_contiguous()
           and r_vec.shape == p2.shape == phi_col.shape == (n_rows,) and jff.dim() == 0
           and scratch.dphi.shape == (n_rows,)
           and table_col.shape[0] >= layer.offset + layer.vocab,
           "float32 (n_rows,) caches, contiguous q, r and p2, a 0-dim jff, a table column "
           "that holds the layer")
    kernel.launch(layer, table_col, phi_col, q, r_vec, p2, jff, scratch, float(alpha0),
                  float(l2), float(layer.eta))
    field_layer.launches += 1 + 2 * (layer.ids.shape[0] > 0) + (not layer.identity and n_rows > 0)
    return scratch.dphi


field_layer.launches = 0  # CUDA kernel launches: 3 a layer, 4 a bag layer
