"""iCD-Tucker (paper §5.3.2, eqs. 40–41), flat, coordinate by coordinate.

ŷ(c, i) = Σ_{f1,f2,f3} b_{f1 f2 f3} u_{c1 f1} v_{c2 f2} w_{i f3} over the
observed context pairs c = (c1, c2) = (user, hour). With
Φ(c) = Σ_{f1,f2} b_{f1 f2 ·} u_{c1 f1} v_{c2 f2} (k3 wide) and ψ(i) = w_i,
ŷ = ⟨Φ(c), ψ(i)⟩, and Lemma 1's implicit part runs over the pairs C.

An epoch, in the paper's order, each coordinate one Newton step on the
halved derivatives (J = WᵀW):

  U sweep, for each f1: D(c) = ∂Φ(c)/∂u_{c1 f1} = Σ_{f2} b_{f1 f2 ·} v_{c2 f2},
      s = ⟨D(c), w_i⟩ an interaction; by user
      L'/2 = Σ ᾱ e s, L''/2 = Σ ᾱ s², R'/2 = Σ_c ⟨D(c), J Φ(c)⟩,
      R''/2 = Σ_c ⟨D(c), J D(c)⟩; Φ += Δ D, e += Δ s
  V sweep: the same, by hour, with D(c) = Σ_{f1} b_{f1 f2 ·} u_{c1 f1}
  core sweep, (f1, f2, f3) in lexicographic order: g(c) = u_{c1 f1} v_{c2 f2},
      x = g w_{i f3}; L'/2 = Σ ᾱ e x, L''/2 = Σ ᾱ x², R'/2 = (Φᵀg)·J[:, f3],
      R''/2 = J(f3, f3) Σ_c g²; Φ[:, f3] += Δ g, e += Δ x
  item sweep: iCD-MF's item side with Φ as the context factors (J_C = ΦᵀΦ)

with Δ = −η (L'/2 + α₀R'/2 + λθ) / (L''/2 + α₀R''/2 + λ), λ_core on the core.
The pairs are built here from the log and the inputs' hours, sorted by
(user, hour); the log by (pair, item).
"""
from __future__ import annotations

import numpy as np
import torch

from bench.reference.common import CHUNK, Arith, newton, scores, seg

LEAVES = ("u", "v", "w", "b")


class Reference:
    def __init__(self, inputs, config: dict, theta0: dict, arith: Arith,
                 device, weights=None):
        self.cfg = config
        self.ar = arith
        dt = arith.dtype
        alpha0 = float(config["alpha0"])
        nb, ni = int(inputs.n_buckets), int(inputs.n_items)
        user = torch.as_tensor(np.asarray(inputs.ctx, np.int64), device=device)
        hour = torch.as_tensor(np.asarray(inputs.hour, np.int64), device=device)
        item = torch.as_tensor(np.asarray(inputs.item, np.int64), device=device)
        keys, pair = torch.unique(user * nb + hour, sorted=True, return_inverse=True)
        order = torch.argsort(pair * ni + item)
        self.c1, self.c2 = keys // nb, keys % nb           # the pairs
        self.pair, self.item = pair[order], item[order]    # the log, (pair, item) order
        self.user = self.c1[self.pair]
        y = torch.as_tensor(np.asarray(inputs.y, np.float64), device=device)[order]
        alpha = torch.as_tensor(np.asarray(inputs.alpha, np.float64), device=device)[order]
        if bool(torch.any(alpha <= alpha0)):
            raise ValueError("Lemma 1 needs α > α₀ on every observed pair")
        self.ybar = alpha / (alpha - alpha0) * y           # float64, for the objective
        self.abar64 = alpha - alpha0
        self.abar = self.abar64.to(dt)
        if weights is not None:
            self.abar = self.abar * weights.to(device=device, dtype=dt)[order]
        self.n = (int(inputs.n_ctx), nb, ni)
        self.theta = {n: theta0[n].to(device=device, dtype=dt).clone() for n in LEAVES}
        self.e = scores(self._phi(self.theta), self.theta["w"], self.pair,
                        self.item) - self.ybar.to(dt)

    def _phi(self, th: dict) -> torch.Tensor:
        """Φ (pairs, k3)."""
        k1, k2, k3 = th["b"].shape
        uv = (th["u"][self.c1][:, :, None] * th["v"][self.c2][:, None, :]).reshape(-1, k1 * k2)
        return self.ar.mm(uv, th["b"].reshape(k1 * k2, k3))

    def _dots(self, d: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """⟨D(pair), w_item⟩ an interaction, CHUNK at a time."""
        out = torch.empty(self.pair.shape, dtype=d.dtype, device=d.device)
        for lo in range(0, len(self.pair), CHUNK):
            hi = lo + CHUNK
            out[lo:hi] = torch.sum(d[self.pair[lo:hi]] * w[self.item[lo:hi]], dim=1)
        return out

    def _mode(self, side, d_of, group, group_nnz, n_side, phi, j):
        """One mode's sweep; ``side`` and ``phi`` in place."""
        c = self.cfg
        w = self.theta["w"]
        for f in range(side.shape[1]):
            d = d_of(f)                                    # (pairs, k3)
            s = self._dots(d, w)
            lp = seg(self.abar * self.e * s, group_nnz, n_side)
            lpp = seg(self.abar * s * s, group_nnz, n_side)
            rp = seg(torch.sum(d * self.ar.mm(phi, j), dim=1), group, n_side)
            rpp = seg(torch.sum(d * self.ar.mm(d, j), dim=1), group, n_side)
            delta = newton(lp + c["alpha0"] * rp + c["l2"] * side[:, f],
                           lpp + c["alpha0"] * rpp + c["l2"], c["eta"])
            side[:, f] += delta
            phi += delta[group][:, None] * d
            self.e += delta[group_nnz] * s

    def _core(self, phi, j):
        c, th = self.cfg, self.theta
        u, v, w, b = (th[n] for n in LEAVES)
        k1, k2, k3 = b.shape
        for f1 in range(k1):
            for f2 in range(k2):
                g = u[self.c1, f1] * v[self.c2, f2]        # (pairs,)
                g_nnz = g[self.pair]
                gg = torch.sum(g * g)
                for f3 in range(k3):
                    x = g_nnz * w[:, f3][self.item]
                    lp = torch.sum(self.abar * self.e * x)
                    lpp = torch.sum(self.abar * x * x)
                    rp = torch.sum(self.ar.mm(g[None, :], phi)[0] * j[:, f3])
                    delta = newton(lp + c["alpha0"] * rp + c["l2_core"] * b[f1, f2, f3],
                                   lpp + c["alpha0"] * j[f3, f3] * gg + c["l2_core"],
                                   c["eta"])
                    b[f1, f2, f3] += delta
                    phi[:, f3] += delta * g
                    self.e += delta * x

    def _items(self, phi):
        c, w = self.cfg, self.theta["w"]
        j = self.ar.mm(phi.T, phi)
        for f in range(w.shape[1]):
            o = phi[:, f][self.pair]
            lp = seg(self.abar * self.e * o, self.item, self.n[2])
            lpp = seg(self.abar * o * o, self.item, self.n[2])
            rp = self.ar.mm(w, j[:, f:f + 1])[:, 0]
            delta = newton(lp + c["alpha0"] * rp + c["l2"] * w[:, f],
                           lpp + c["alpha0"] * j[f, f] + c["l2"], c["eta"])
            w[:, f] += delta
            self.e += delta[self.item] * o

    def epoch(self) -> None:
        th = self.theta
        u, v, w, b = (th[n] for n in LEAVES)
        n_users, n_buckets, _ = self.n
        j = self.ar.mm(w.T, w)
        phi = self._phi(th)
        vp = v[self.c2]
        self._mode(u, lambda f1: self.ar.mm(vp, b[f1]), self.c1, self.user, n_users, phi, j)
        up = u[self.c1]
        self._mode(v, lambda f2: self.ar.mm(up, b[:, f2]), self.c2, self.c2[self.pair],
                   n_buckets, phi, j)
        self._core(phi, j)
        self._items(phi)

    def leaves(self) -> dict:
        return dict(self.theta)

    def residual(self) -> torch.Tensor:
        return self.e

    def objective(self, leaves: dict) -> float:
        """Lemma 1's objective in float64: Σ ᾱ(ŷ−ȳ)² + α₀ Σ (ΦᵀΦ)∘(WᵀW) +
        λ(‖U‖² + ‖V‖² + ‖W‖²) + λ_core‖B‖², of any leaves (the program's
        too)."""
        dev = self.pair.device
        th = {n: leaves[n].to(device=dev, dtype=torch.float64) for n in LEAVES}
        phi = (th["u"][self.c1][:, :, None] * th["v"][self.c2][:, None, :]).reshape(
            len(self.c1), -1) @ th["b"].reshape(-1, th["b"].shape[2])
        e = scores(phi, th["w"], self.pair, self.item) - self.ybar
        c = self.cfg
        return float(torch.sum(self.abar64 * e * e)
                     + c["alpha0"] * torch.sum((phi.T @ phi) * (th["w"].T @ th["w"]))
                     + c["l2"] * sum(torch.sum(th[n] ** 2) for n in ("u", "v", "w"))
                     + c["l2_core"] * torch.sum(th["b"] ** 2))
