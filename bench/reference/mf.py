"""iCD-MF (paper §5.1, Algorithm 2), flat and column by column.

ŷ(c, i) = ⟨w_c, h_i⟩. A side's sweep takes J = OᵀO of the other side's
factors O, then for each column f updates every row's coordinate by one
Newton step on the halved derivatives

    L'/2  = Σ_i ᾱ e ψ_f          R'/2  = Σ_g s_g J(g, f)
    L''/2 = Σ_i ᾱ ψ_f²           R''/2 = J(f, f)
    Δ = −η (L'/2 + α₀R'/2 + λ s_f) / (L''/2 + α₀R''/2 + λ)

and patches the residuals e += Δ ψ_f. The context side runs first, then
the item side with J of the new context factors.
"""
from __future__ import annotations

import torch

from bench.reference.common import Arith, Log, newton, scores, seg

LEAVES = ("w", "h")


class Reference:
    def __init__(self, inputs, config: dict, theta0: dict, arith: Arith,
                 device, weights=None):
        self.cfg = config
        self.ar = arith
        self.log = Log(inputs, float(config["alpha0"]), device)
        dt = arith.dtype
        self.abar = self.log.abar.to(dt)
        if weights is not None:
            self.abar = self.abar * weights.to(device=device, dtype=dt)
        self.theta = {n: theta0[n].to(device=device, dtype=dt).clone()
                      for n in LEAVES}
        self.e = scores(self.theta["w"], self.theta["h"], self.log.ctx,
                        self.log.item) - self.log.ybar.to(dt)

    def _side(self, side, other, rows, cols, n_rows):
        c = self.cfg
        j = self.ar.mm(other.T, other)
        for f in range(side.shape[1]):
            o = other[:, f][cols]
            lp = seg(self.abar * self.e * o, rows, n_rows)
            lpp = seg(self.abar * o * o, rows, n_rows)
            rp = self.ar.mm(side, j[:, f:f + 1])[:, 0]
            d = newton(lp + c["alpha0"] * rp + c["l2"] * side[:, f],
                       lpp + c["alpha0"] * j[f, f] + c["l2"], c["eta"])
            side[:, f] += d
            self.e += d[rows] * o

    def epoch(self) -> None:
        w, h, lg = self.theta["w"], self.theta["h"], self.log
        self._side(w, h, lg.ctx, lg.item, lg.n_ctx)
        self._side(h, w, lg.item, lg.ctx, lg.n_items)

    def leaves(self) -> dict:
        return dict(self.theta)

    def residual(self) -> torch.Tensor:
        return self.e

    def objective(self, leaves: dict) -> float:
        """Lemma 1's objective in float64: Σ ᾱ(ŷ−ȳ)² + α₀ Σ J_C∘J_I +
        λ(‖W‖² + ‖H‖²), of any leaves (the program's too)."""
        dev = self.log.ctx.device
        w, h = (leaves[n].to(device=dev, dtype=torch.float64) for n in LEAVES)
        e = scores(w, h, self.log.ctx, self.log.item) - self.log.ybar
        c = self.cfg
        return float(torch.sum(self.log.abar * e * e)
                     + c["alpha0"] * torch.sum((w.T @ w) * (h.T @ h))
                     + c["l2"] * (torch.sum(w * w) + torch.sum(h * h)))
