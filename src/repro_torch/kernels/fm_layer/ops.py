"""Public wrapper for iCD-FM's embedding field layer on the flat layout (no
JAX counterpart kernel: the JAX package's embedding layer is XLA ops).

A CUDA tensor launches the hand-written kernels (``csrc/fm_layer.cu``);
a CPU tensor takes the plain version (``ref.field_layer_ref``)."""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import on_cuda
from repro_torch.kernels.fm_layer import kernel
from repro_torch.kernels.fm_layer.ref import field_layer_ref


class FieldLayer(NamedTuple):
    """One field layer, as :func:`prepare` leaves it for a side sweep."""
    ids: torch.Tensor   # (n,) int64 global feature ids
    xw: torch.Tensor    # (n,) float32 weights x
    rows: torch.Tensor  # (n,) int64 row of each entry
    vocab: int
    offset: int
    eta: float
    identity: bool      # one entry a row: entry n is row n


class Caches(NamedTuple):
    """A dimension's per-row caches, (n_rows,) float32 each: the layers move
    q, u, r_a and r_b in place and read p2, p1 and p0."""
    q: torch.Tensor
    u: torch.Tensor
    r_a: torch.Tensor
    r_b: torch.Tensor
    p2: torch.Tensor
    p1: torch.Tensor
    p0: torch.Tensor


class Scratch(NamedTuple):
    sums: torch.Tensor            # (4·vocab,) zeros between layers
    step: torch.Tensor            # (2·vocab,) δ and θ before the step
    acc: Optional[torch.Tensor]   # (2·n_rows,) zeros between layers, where a bag is
    dphi: torch.Tensor            # (2, n_rows) the last layer's dφ_f, dφ_s


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"fm field_layer: {msg}")


def prepare(layers, n_rows: int) -> tuple:
    """The layers of ``mfsi._field_layers`` — (global ids, weights, rows,
    vocab, offset, η) each, rows 0..n_rows − 1 wherever a layer has one
    entry a row — as :class:`FieldLayer`, and the scratch of a side sweep.
    Once a side sweep: the checks live here."""
    out = []
    for ids, xw, rows, vocab, offset, eta in layers:
        ids, xw, rows = ids.contiguous(), xw.contiguous(), rows.contiguous()
        n = ids.shape[0]
        _check(ids.dtype == torch.int64 and rows.dtype == torch.int64
               and xw.dtype == torch.float32 and xw.shape == rows.shape == (n,),
               "a layer takes (n,) int64 ids and rows and float32 weights")
        out.append(FieldLayer(ids, xw, rows, int(vocab), int(offset), float(eta),
                              n == n_rows))
    dev = out[0].ids.device
    vocab = max(layer.vocab for layer in out)
    bag = not all(layer.identity for layer in out)
    scratch = Scratch(torch.zeros(4 * vocab, dtype=torch.float32, device=dev),
                      torch.empty(2 * vocab, dtype=torch.float32, device=dev),
                      torch.zeros(2 * n_rows, dtype=torch.float32, device=dev) if bag else None,
                      torch.empty((2, n_rows), dtype=torch.float32, device=dev))
    return out, scratch


def field_layer(layer: FieldLayer, table_col, phi_f, phi_s, caches: Caches, j,
                scratch: Scratch, *, alpha0: float, l2: float) -> tuple:
    """One embedding field layer's Newton step in one dimension f*: every
    feature of the layer steps at once (one-hot fields exactly, a Jacobi
    bag as one damped step). ``table_col`` (p,) the embedding table's
    column f*, ``phi_f`` and ``phi_s`` (n_rows,) Φe's columns f* and the
    special one (one stride), and ``caches`` q, u, r_a, r_b are updated in
    place; ``caches`` p2, p1, p0 and ``j`` (J(f*, f*), J(f*, s), J(s, s),
    0-dim tensors) are read. Returns the rows' (dφ_f, dφ_s) (n_rows,) each
    for the caller's residual patch: on CUDA the rows of ``scratch.dphi``,
    which the next layer overwrites.

    On CUDA three launches (four for a bag; ``field_layer.launches``); every
    float tensor float32, the caches contiguous. The sums are atomics, so
    their last bits can change from run to run."""
    if not on_cuda(table_col, phi_f, caches.q):
        return field_layer_ref(layer, table_col, phi_f, phi_s, caches, j, alpha0=alpha0,
                               l2=l2)
    n_rows = phi_f.shape[0]
    _check(all(t.dtype == torch.float32 for t in (table_col, phi_f, phi_s, *caches, *j))
           and all(t.shape == (n_rows,) and t.is_contiguous() for t in caches)
           and phi_s.shape == (n_rows,) and phi_s.stride() == phi_f.stride()
           and all(t.dim() == 0 for t in j) and scratch.dphi.shape == (2, n_rows)
           and table_col.shape[0] >= layer.offset + layer.vocab,
           "float32 contiguous (n_rows,) caches, Φe's two columns of one stride, 0-dim J "
           "entries, a table column that holds the layer")
    kernel.launch(layer, table_col, phi_f, phi_s, caches, j, scratch, float(alpha0),
                  float(l2), float(layer.eta))
    field_layer.launches += 1 + 2 * (layer.ids.shape[0] > 0) + (not layer.identity and n_rows > 0)
    return scratch.dphi[0], scratch.dphi[1]


field_layer.launches = 0  # CUDA kernel launches: 3 a layer, 4 a bag layer
