"""The FLOPs of a whole iCD-Tucker epoch (paper §5.3.2), from nnz, the
observed context pairs and the ranks, whatever form the program runs it
in. A multiply and an add are two; an elementwise operation one.

N interactions, P context pairs (user, hour), ranks k1, k2, k3, and n1,
n2, n_items rows of the three modes:

  * Φ over the pairs: u ⊗ v (k1·k2 a pair), then by B (2·k1·k2·k3);
    the Grams J_I = WᵀW and J_C = ΦᵀΦ;
  * a mode column (k1 of them in the U sweep, k2 in the V sweep): D over
    the pairs (2·k_other·k3 a pair), s = ⟨D, w_i⟩ (2·k3 an interaction),
    L'/2 and L''/2 (3 + 3), the products Φ·J and D·J (2·k3² each a pair)
    and their row sums with D (2·k3 each), Φ += Δ·D (2·k3), e += Δ·s
    (2), the Newton step (10 a row of the mode);
  * a core coordinate (k1·k2·k3 of them): g = u_{f1}·v_{f2} (1 a pair),
    x = g·w_{f3} (1 an interaction), L'/2 and L''/2 (3 + 3), Φᵀg
    (2·k3 a pair) and its dot with J's column, Σ g² (2 a pair), Φ's
    column += Δ·g (2 a pair), e += Δ·x (2 an interaction);
  * an item column (k3 of them): iCD-MF's item side with Φ's column
    gathered: L'/2 and L''/2 (3 + 3), e += Δ·o (2) an interaction; the
    R' mat-vec (2·k3 an item) and the Newton step (10 an item).
"""
from __future__ import annotations

from bench.costs import kernels


def tucker_epoch_flops(nnz: int, pairs: int, config: dict) -> int:
    k1, k2, k3 = (int(config[k]) for k in ("k1", "k2", "k3"))
    n1, n2, n_items = (int(config[k]) for k in ("n_ctx", "n_buckets", "n_items"))
    n, p = nnz, pairs
    flops = p * k1 * k2 * (1 + 2 * k3)
    flops += kernels.gram(n_items, k3)[0] + kernels.gram(p, k3)[0]
    for k_side, k_other, rows in ((k1, k2, n1), (k2, k1, n2)):
        per_col = (p * (2 * k_other * k3 + 4 * k3 * k3 + 6 * k3)
                   + n * (2 * k3 + 8) + 10 * rows)
        flops += k_side * per_col
    flops += k1 * k2 * k3 * (n * 9 + p * (2 * k3 + 5) + 2 * k3 + 10)
    flops += k3 * (n * 8 + n_items * (2 * k3 + 10))
    return flops
