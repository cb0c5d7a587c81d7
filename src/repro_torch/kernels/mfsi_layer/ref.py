"""Plain PyTorch version of iCD-MFSI's field layer: the algebra of the
kernels, with the sums by feature and by row taken by ``index_add_``.

For the layer's entries (feature v = id − offset, weight x, row c) and
the per-row caches q, p2 and r of the dimension, L′ = Σ x·q, L″ = Σ x²·p2
and R′ = Σ x·r by feature, R″ = J(f*, f*)·Σ x²; ``sweeps.newton_delta``'s
step; θ += δ; dφ = Σ x·δ by row, and φ += dφ, q += dφ·p2, r += dφ·J(f*, f*)."""
import torch

from repro_torch.core import sweeps
from repro_torch.sparse.segment import segment_sum


def field_layer_ref(layer, table_col, phi_col, q, r_vec, p2, jff, *, alpha0: float,
                    l2: float) -> torch.Tensor:
    local, xw, rows = layer.ids - layer.offset, layer.xw, layer.rows
    lp = segment_sum(xw * q[rows], local, layer.vocab)
    lpp = segment_sum(xw * xw * p2[rows], local, layer.vocab)
    rp = segment_sum(xw * r_vec[rows], local, layer.vocab)
    theta = table_col[layer.offset:layer.offset + layer.vocab]
    delta = sweeps.newton_delta(
        sweeps.NewtonParts(lp + alpha0 * rp, lpp + alpha0 * (jff * layer.cnt)),
        theta, l2, layer.eta)
    theta += delta
    dphi = segment_sum(xw * delta[local], rows, q.shape[0])
    phi_col += dphi
    q += dphi * p2
    r_vec += dphi * jff
    return dphi
