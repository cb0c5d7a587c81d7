"""iCD-FM (paper §5.2.2, eqs. 26–33), flat and column by column.

FM over x = (x_c, z_i): ŷ = b + Σ_l x_l w̃_l + Σ_{l<l'} ⟨w_l, w_l'⟩ x_l x_l'
is (k+2)-separable with aligned columns

    Φe = [Φ | φ_spec | 1]      Ψe = [Ψ | 1 | ψ_spec]

(Φ = XW, φ_spec the context's bias, linear and self-pairwise terms), so
ŷ = ⟨Φe(c), Ψe(i)⟩. A side's sweep takes J = OᵀO of the other side's Ψe
(or Φe), then for each dimension f runs the field layers in order: a
one-hot field's features touch disjoint rows, so one vectorized Newton
step over the field is exact CD; a multi-hot field takes one damped
(Jacobi, η = ``jacobi_eta``) step over the whole bag. A layer's step keeps the per-row caches
(q, u from e; p2, p1, p0 moments; r_a, r_b from J) and the side's own Φe
in closed form; the residuals take the dimension's Δφ_f and Δφ_spec once
the layers are done. Then the linear weights (layer by layer) and, on the
context side, the global bias.
"""
from __future__ import annotations

import torch

from bench.reference.common import Arith, Log, newton, scores, seg

LEAVES = ("b", "w_lin", "w", "h_lin", "h")


class Design:
    """A fielded design from the benchmark's raw field specs: each field's
    global ids (rows, bag), weights and vocabulary."""

    def __init__(self, specs: list, n_rows: int, dtype, device):
        self.n_rows = n_rows
        self.fields = []
        offset = 0
        for spec in specs:
            ids = torch.as_tensor(spec["ids"], dtype=torch.int64, device=device)
            ids = ids[:, None] if ids.dim() == 1 else ids
            w = spec.get("weights")
            w = (torch.ones(ids.shape, dtype=dtype, device=device) if w is None
                 else torch.as_tensor(w, device=device).to(dtype).reshape(ids.shape))
            self.fields.append((ids + offset, w, int(spec["vocab"]), offset))
            offset += int(spec["vocab"])
        self.p = offset

    def matmul(self, table: torch.Tensor) -> torch.Tensor:
        out = torch.zeros((self.n_rows, table.shape[1]), dtype=table.dtype,
                          device=table.device)
        for gids, w, _, _ in self.fields:
            for j in range(gids.shape[1]):
                out += w[:, j, None] * table[gids[:, j]]
        return out

    def self_pairwise(self, table, phi):
        """½ Σ_f (φ_f² − Σ_l x_l² w_{l,f}²)."""
        wsq = torch.sum(table * table, dim=1)
        sq = sum(torch.sum(wsq[g] * w * w, dim=1) for g, w, _, _ in self.fields)
        return 0.5 * (torch.sum(phi * phi, dim=1) - sq)

    def layers(self, mode: str, eta: float, jacobi_eta: float):
        """(global ids, x, rows, vocab, offset, η) per layer."""
        if mode != "jacobi":
            raise ValueError(f"multi_hot_mode {mode!r}: the reference has Jacobi only")
        dev = self.fields[0][0].device
        rows = torch.arange(self.n_rows, device=dev)
        out = []
        for gids, w, vocab, offset in self.fields:
            bag = gids.shape[1]
            if bag == 1:
                out.append((gids[:, 0], w[:, 0], rows, vocab, offset, eta))
            else:
                out.append((gids.reshape(-1), w.reshape(-1),
                            rows.repeat_interleave(bag), vocab, offset, jacobi_eta))
        return out


class Reference:
    def __init__(self, inputs, config: dict, theta0: dict, arith: Arith,
                 device, weights=None):
        self.cfg = config
        self.ar = arith
        dt = arith.dtype
        self.log = Log(inputs, float(config["alpha0"]), device)
        self.abar = self.log.abar.to(dt)
        if weights is not None:
            self.abar = self.abar * weights.to(device=device, dtype=dt)
        self.x = Design(inputs.ctx_fields, inputs.n_ctx, dt, device)
        self.z = Design(inputs.item_fields, inputs.n_items, dt, device)
        self.x64 = Design(inputs.ctx_fields, inputs.n_ctx, torch.float64, device)
        self.z64 = Design(inputs.item_fields, inputs.n_items, torch.float64, device)
        self.theta = {n: theta0[n].to(device=device, dtype=dt).clone() for n in LEAVES}
        pe, se = self._ext(self.theta, self.x, self.z)
        self.e = scores(pe, se, self.log.ctx, self.log.item) - self.log.ybar.to(dt)

    def _ext(self, th: dict, x: Design, z: Design):
        """(Φe, Ψe) of the parameters ``th``."""
        c = self.cfg
        phi = x.matmul(th["w"])
        spec = x.self_pairwise(th["w"], phi)
        if c["use_linear"]:
            spec = spec + x.matmul(th["w_lin"][:, None])[:, 0]
        if c["use_bias"]:
            spec = spec + th["b"]
        ones = torch.ones((x.n_rows, 1), dtype=phi.dtype, device=phi.device)
        pe = torch.cat([phi, spec[:, None], ones], dim=1)
        psi = z.matmul(th["h"])
        spec = z.self_pairwise(th["h"], psi)
        if c["use_linear"]:
            spec = spec + z.matmul(th["h_lin"][:, None])[:, 0]
        ones = torch.ones((z.n_rows, 1), dtype=psi.dtype, device=psi.device)
        return pe, torch.cat([psi, ones, spec[:, None]], dim=1)

    def _embed_layer(self, col, ext, cache, layer, f, spec, j_ff, j_fs, j_ss):
        c = self.cfg
        ids, xw, rows, vocab, offset, eta = layer
        q, u, r_a, r_b, p2, p1, p0 = cache
        local = ids - offset
        g = ext[:, f][rows] - xw * col[ids]
        lp = seg(xw * (q[rows] + g * u[rows]), local, vocab)
        lpp = seg(xw * xw * (p2[rows] + 2 * g * p1[rows] + g * g * p0[rows]), local, vocab)
        rp = seg(xw * (r_a[rows] + g * r_b[rows]), local, vocab)
        rpp = seg(xw * xw * (j_ff + 2 * g * j_fs + g * g * j_ss), local, vocab)
        layer_w = col[offset:offset + vocab]
        delta = newton(lp + c["alpha0"] * rp + c["l2"] * layer_w,
                       lpp + c["alpha0"] * rpp + c["l2"], eta)
        col[offset:offset + vocab] += delta
        d_entry = xw * delta[local]
        dphi_f = seg(d_entry, rows, ext.shape[0])
        dphi_s = seg(d_entry * g, rows, ext.shape[0])
        ext[:, f] += dphi_f
        ext[:, spec] += dphi_s
        cache[0] = q + dphi_f * p2 + dphi_s * p1
        cache[1] = u + dphi_f * p1 + dphi_s * p0
        cache[2] = r_a + dphi_f * j_ff + dphi_s * j_fs
        cache[3] = r_b + dphi_f * j_fs + dphi_s * j_ss
        return dphi_f, dphi_s

    def _side(self, table, lin, bias, ext, other, design, rows_nnz, other_ids, spec):
        """One side: dimensions, linear weights, bias. ``table``, ``lin``
        and ``ext`` in place; returns the new bias (or None)."""
        c = self.cfg
        n = design.n_rows
        j = self.ar.mm(other.T, other)
        layers = design.layers(c["multi_hot_mode"], c["eta"], c["jacobi_eta"])
        a = self.abar
        o_s = other[:, spec][other_ids]
        p0 = seg(a * o_s * o_s, rows_nnz, n)
        j_ss = j[spec, spec]
        for f in range(c["k"]):
            o_f = other[:, f][other_ids]
            cache = [seg(a * self.e * o_f, rows_nnz, n), seg(a * self.e * o_s, rows_nnz, n),
                     self.ar.mm(ext, j[:, f:f + 1])[:, 0],
                     self.ar.mm(ext, j[:, spec:spec + 1])[:, 0],
                     seg(a * o_f * o_f, rows_nnz, n), seg(a * o_f * o_s, rows_nnz, n), p0]
            col = table[:, f].clone()
            tot_f = torch.zeros_like(p0)
            tot_s = torch.zeros_like(p0)
            for layer in layers:
                dphi_f, dphi_s = self._embed_layer(col, ext, cache, layer, f, spec,
                                                   j[f, f], j[f, spec], j_ss)
                tot_f += dphi_f
                tot_s += dphi_s
            table[:, f] = col
            self.e += tot_f[rows_nnz] * o_f + tot_s[rows_nnz] * o_s
        if c["use_linear"]:
            u = seg(a * self.e * o_s, rows_nnz, n)
            r_b = self.ar.mm(ext, j[:, spec:spec + 1])[:, 0]
            for ids, xw, rows, vocab, offset, eta in layers:
                local = ids - offset
                lp = seg(xw * u[rows], local, vocab)
                lpp = seg(xw * xw * p0[rows], local, vocab)
                rp = seg(xw * r_b[rows], local, vocab)
                rpp = j_ss * seg(xw * xw, local, vocab)
                layer_w = lin[offset:offset + vocab]
                delta = newton(lp + c["alpha0"] * rp + c["l2_lin"] * layer_w,
                               lpp + c["alpha0"] * rpp + c["l2_lin"], eta)
                lin[offset:offset + vocab] += delta
                dspec = seg(xw * delta[local], rows, n)
                ext[:, spec] += dspec
                u = u + dspec * p0
                r_b = r_b + dspec * j_ss
                self.e += dspec[rows_nnz] * o_s
        if c["use_bias"] and bias is not None:
            r_b = self.ar.mm(ext, j[:, spec:spec + 1])[:, 0]
            u = seg(a * self.e * o_s, rows_nnz, n)
            delta = newton(torch.sum(u) + c["alpha0"] * torch.sum(r_b),
                           torch.sum(p0) + c["alpha0"] * j_ss * n, c["eta"])
            ext[:, spec] += delta
            self.e += delta * o_s
            return bias + delta
        return bias

    def epoch(self) -> None:
        th, lg, k = self.theta, self.log, self.cfg["k"]
        pe, se = self._ext(th, self.x, self.z)
        th["b"] = self._side(th["w"], th["w_lin"], th["b"], pe, se, self.x,
                             lg.ctx, lg.item, k)
        self._side(th["h"], th["h_lin"], None, se, pe, self.z, lg.item, lg.ctx, k + 1)

    def leaves(self) -> dict:
        return dict(self.theta)

    def residual(self) -> torch.Tensor:
        return self.e

    def objective(self, leaves: dict) -> float:
        """Lemma 1's objective in float64: Σ ᾱ(ŷ−ȳ)² + α₀ Σ J_C∘J_I +
        λ(‖w‖² + ‖h‖²) + λ_lin(‖w̃‖² + ‖h̃‖²) (φ_spec and ψ_spec are
        components, not parameters)."""
        dev = self.log.ctx.device
        th = {n: leaves[n].to(device=dev, dtype=torch.float64) for n in LEAVES}
        pe, se = self._ext(th, self.x64, self.z64)
        e = scores(pe, se, self.log.ctx, self.log.item) - self.log.ybar
        c = self.cfg
        return float(torch.sum(self.log.abar * e * e)
                     + c["alpha0"] * torch.sum((pe.T @ pe) * (se.T @ se))
                     + c["l2"] * (torch.sum(th["w"] ** 2) + torch.sum(th["h"] ** 2))
                     + c["l2_lin"] * (torch.sum(th["w_lin"] ** 2)
                                      + torch.sum(th["h_lin"] ** 2)))
