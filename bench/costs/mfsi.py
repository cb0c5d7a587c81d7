"""The FLOPs of a whole iCD-MFSI epoch (paper §5.2.1, eqs. 20–25,
Algorithm 3), from nnz and the configuration's shapes, whatever form the
program runs it in. A multiply and an add are two; an elementwise
operation one.

N interactions; k dimensions; a side of n rows whose design has field
layers of E entries and V features each (``epochs.fm_layers``: a one-hot
field one layer of n entries, the Jacobi bag one of n × bag entries),
and n_other rows on the other side:

  * Φ = XW and Ψ = ZH at the epoch's start: 2k a design entry;
  * per side, the Gram of the other side's (n_other, k) table;
  * per side and column:
      - the R' product Φ·J[:, f] (n × k by k × 1);
      - the moments over nnz: ᾱ·ψ·ψ and ᾱ·e·ψ (2 + 2) and their sums by
        row (1 + 1): 6 an interaction;
      - each layer: L' (x·q, the sum: 2), L'' (x·x·p2, the sum: 3), R'
        (x·r, the sum: 2), Σx² (2) and Δφ's sum (x·Δ, the sum: 2): 11 an
        entry; the Newton step, 12 a feature (J(f, f)·Σx², α₀·R' and
        L' + α₀R', α₀·R'' and L'' + α₀R'', λw and its sum, + λ, the
        clamp, −η·, ÷, w += Δ); the cache patches, 5 a row (φ += Δφ,
        q += Δφ·p2, r += Δφ·J(f, f)); the residual patch e += Δφ·ψ,
        2 an interaction.

``field_layer_cost`` counts the field layers alone (``kernels/mfsi_layer``'s
launches, the residual patches aside): their FLOPs above (11 an entry, 12
a feature, 5 a row), and the bytes they must move at least, each array
read or written once. A layer of E entries over n rows and V features:
the sums read the ids and weights (12 an entry) and the rows' q, p2 and r
(12 a row) and write S (12 a feature); the step reads S and zeroes it,
reads Σx², reads and writes θ and writes Δ (40 a feature); the apply pass
reads the ids and weights again (12 an entry) and Δ (4 a feature) and
moves φ, q and r (read and written) with p2 read and Δφ written (32 a
row). A Jacobi bag adds its rows, read twice (16 an entry), its row sums
scattered, read and zeroed (12 a row).
"""
from __future__ import annotations

from bench.costs import epochs, kernels


def mfsi_epoch_flops(nnz: int, config: dict, history_length: int) -> int:
    k = int(config["k"])
    n_ctx, n_items = int(config["n_ctx"]), int(config["n_items"])
    flops = 0
    for (n, n_other), layers in zip(((n_ctx, n_items), (n_items, n_ctx)),
                                    epochs.fm_layers(config, history_length)):
        flops += 2 * k * sum(e for e, _ in layers)
        flops += kernels.gram(n_other, k)[0]
        per_col = kernels.matmul(n, k, 1)[0] + 6 * nnz
        per_col += sum(11 * e + 12 * v + 5 * n + 2 * nnz for e, v in layers)
        flops += k * per_col
    return flops


def field_layer_cost(config: dict, history_length: int) -> tuple:
    """(FLOPs, bytes) of an epoch's field layers, both sides."""
    k = int(config["k"])
    flops = nbytes = 0
    for n, layers in zip((int(config["n_ctx"]), int(config["n_items"])),
                         epochs.fm_layers(config, history_length)):
        for e, v in layers:
            flops += k * (11 * e + 12 * v + 5 * n)
            nbytes += k * (24 * e + 44 * n + 56 * v + (16 * e + 12 * n if e != n else 0))
    return flops, nbytes
