"""Plain PyTorch version of iCD-FM's embedding field layer: the algebra of
the kernels (``fm._embed_layer_update``'s, in place), with the sums by
feature and by row taken by ``index_add_``.

For the layer's entries (feature v = id − offset, weight x, row c), the
rows' Φe columns φ_f and φ_s and the dimension's caches: g = φ_f − x·θ
(θ before the step); L′ = Σ x·(q + g·u), L″ = Σ x²·(p2 + 2g·p1 + g²·p0),
R′ = Σ x·(r_a + g·r_b), R″ = Σ x²·(jff + 2g·jfs + g²·jss) by feature;
``sweeps.newton_delta``'s step; θ += δ; dφ_f = Σ x·δ and dφ_s = Σ x·δ·g by
row; φ_f += dφ_f, φ_s += dφ_s, q += dφ_f·p2 + dφ_s·p1, u += dφ_f·p1 +
dφ_s·p0, r_a += dφ_f·jff + dφ_s·jfs, r_b += dφ_f·jfs + dφ_s·jss."""
import torch

from repro_torch.core import sweeps
from repro_torch.sparse.segment import segment_sum


def field_layer_ref(layer, table_col, phi_f, phi_s, c, j, *, alpha0: float,
                    l2: float) -> tuple:
    j_ff, j_fs, j_ss = j
    local, xw, rows, vocab = layer.ids - layer.offset, layer.xw, layer.rows, layer.vocab
    g = phi_f[rows] - xw * table_col[layer.ids]
    lp = segment_sum(xw * (c.q[rows] + g * c.u[rows]), local, vocab)
    lpp = segment_sum(
        xw * xw * (c.p2[rows] + 2 * g * c.p1[rows] + g * g * c.p0[rows]), local, vocab)
    rp = segment_sum(xw * (c.r_a[rows] + g * c.r_b[rows]), local, vocab)
    rpp = segment_sum(xw * xw * (j_ff + 2 * g * j_fs + g * g * j_ss), local, vocab)
    theta = table_col[layer.offset:layer.offset + vocab]
    delta = sweeps.newton_delta(
        sweeps.NewtonParts(lp + alpha0 * rp, lpp + alpha0 * rpp), theta, l2, layer.eta)
    theta += delta
    d_entry = xw * delta[local]
    n_rows = phi_f.shape[0]
    dphi_f = segment_sum(d_entry, rows, n_rows)
    dphi_s = segment_sum(d_entry * g, rows, n_rows)
    phi_f += dphi_f
    phi_s += dphi_s
    c.q.copy_(c.q + dphi_f * c.p2 + dphi_s * c.p1)
    c.u.copy_(c.u + dphi_f * c.p1 + dphi_s * c.p0)
    c.r_a.copy_(c.r_a + dphi_f * j_ff + dphi_s * j_fs)
    c.r_b.copy_(c.r_b + dphi_f * j_fs + dphi_s * j_ss)
    return dphi_f, dphi_s
