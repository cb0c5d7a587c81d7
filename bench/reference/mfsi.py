"""iCD-MFSI (paper §5.2.1, eqs. 20–25, Algorithm 3), flat and column by
column.

Matrix factorisation with side information: ŷ(c, i) = x_c W (z_i H)ᵀ
(eq. 20), k-separable with φ_f(c) = Σ_l x_{c,l} w_{l,f} and ψ_f(i) =
Σ_l z_{i,l} h_{l,f} (eq. 21). A side's sweep takes J = ΨᵀΨ of the other
side (the Gram of its Φ for the item side), then for each dimension f:

    q_c  = Σ_{i∈S_c} ᾱ e ψ_f(i),   p2_c = Σ_{i∈S_c} ᾱ ψ_f(i)²,
    r_c  = Σ_f' J(f', f) φ_f'(c)

and, layer by layer in the design's field order,

    L'  = Σ_c x_{c,l} q_c,          L'' = Σ_c x_{c,l}² p2_c      (eq. 22)
    R'  = Σ_c x_{c,l} r_c,          R'' = J(f, f) Σ_c x_{c,l}²   (eqs. 23, 24)
    Δw_{l,f} = −η (L' + α₀R' + λw) / (L'' + α₀R'' + λ)

then Δφ_f(c) = Σ_l x_{c,l} Δw_{l,f} patches φ_f, q (by Δφ·p2), r (by
Δφ·J(f, f)) (eq. 25) and the residuals e (by Δφ·ψ_f) before the next
layer. The context side runs before the item side, whose J is the Gram of
the updated Φ. Everything is plain ``torch`` in the ``Arith``'s dtype,
float64 by default.

Departures from the paper, each as the port runs it:

  * A one-hot field's features never share a row, so the field takes one
    vectorised Newton step a dimension: the same as Algorithm 3's
    coordinate loop over the field's features, in any order.
  * A multi-hot field (a bag) takes one damped parallel (Jacobi) step a
    dimension over all its features, from the same caches, with η =
    ``jacobi_eta``; the paper steps each coordinate in turn. The port's
    ``slot`` mode is not modelled (``Design.layers`` raises).
  * The Newton denominator is clamped at 1e-12 (an empty row with λ = 0).
  * The objective is Lemma 1's, without its constant term.
"""
from __future__ import annotations

import torch

from bench.reference.common import Arith, Log, newton, scores, seg
from bench.reference.fm import Design

LEAVES = ("w", "h")


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
        phi, psi = self.x.matmul(self.theta["w"]), self.z.matmul(self.theta["h"])
        self.e = scores(phi, psi, self.log.ctx, self.log.item) - self.log.ybar.to(dt)

    def _side(self, table, phi, other, design: Design, rows_nnz, other_ids) -> None:
        """One side's sweep; ``table``, ``phi`` and ``self.e`` in place."""
        c = self.cfg
        n = design.n_rows
        j = self.ar.mm(other.T, other)
        layers = design.layers(c["multi_hot_mode"], c["eta"], c["jacobi_eta"])
        a = self.abar
        for f in range(c["k"]):
            o_f = other[:, f][other_ids]
            q = seg(a * self.e * o_f, rows_nnz, n)
            p2 = seg(a * o_f * o_f, rows_nnz, n)
            r = self.ar.mm(phi, j[:, f:f + 1])[:, 0]
            j_ff = j[f, f]
            for ids, xw, rows, vocab, offset, eta in layers:
                local = ids - offset
                lp = seg(xw * q[rows], local, vocab)
                lpp = seg(xw * xw * p2[rows], local, vocab)
                rp = seg(xw * r[rows], local, vocab)
                rpp = j_ff * seg(xw * xw, local, vocab)
                layer_w = table[offset:offset + vocab, f]
                delta = newton(lp + c["alpha0"] * rp + c["l2"] * layer_w,
                               lpp + c["alpha0"] * rpp + c["l2"], eta)
                table[offset:offset + vocab, f] += delta
                dphi = seg(xw * delta[local], rows, n)
                phi[:, f] += dphi
                q = q + dphi * p2
                r = r + dphi * j_ff
                self.e += dphi[rows_nnz] * o_f

    def epoch(self) -> None:
        th, lg = self.theta, self.log
        phi, psi = self.x.matmul(th["w"]), self.z.matmul(th["h"])
        self._side(th["w"], phi, psi, self.x, lg.ctx, lg.item)
        self._side(th["h"], psi, phi, self.z, lg.item, lg.ctx)

    def leaves(self) -> dict:
        return dict(self.theta)

    def residual(self) -> torch.Tensor:
        return self.e

    def objective(self, leaves: dict) -> float:
        """Lemma 1's objective in float64: Σ ᾱ(ŷ−ȳ)² + α₀ Σ J_C∘J_I +
        λ(‖W‖² + ‖H‖²)."""
        dev = self.log.ctx.device
        th = {n: leaves[n].to(device=dev, dtype=torch.float64) for n in LEAVES}
        phi, psi = self.x64.matmul(th["w"]), self.z64.matmul(th["h"])
        e = scores(phi, psi, self.log.ctx, self.log.item) - self.log.ybar
        c = self.cfg
        return float(torch.sum(self.log.abar * e * e)
                     + c["alpha0"] * torch.sum((phi.T @ phi) * (psi.T @ psi))
                     + c["l2"] * (torch.sum(th["w"] ** 2) + torch.sum(th["h"] ** 2)))
