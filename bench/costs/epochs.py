"""One count an epoch: the FLOPs of a whole training epoch, and the
FLOPs and bytes of the kernel families a per-layer roofline reads, summed
over the epoch's launches, from nnz and the configuration's shapes."""
from __future__ import annotations

from bench.costs import block_k, blocks, kernels


def _sides(config: dict) -> list:
    """(rows updated, rows of the other side) for the context side, then
    the item side."""
    n_ctx, n_items = int(config["n_ctx"]), int(config["n_items"])
    return [(n_ctx, n_items), (n_items, n_ctx)]


def mf_sweeps(nnz: int, config: dict) -> tuple:
    """(FLOPs, bytes) of the block sweeps of one iCD-MF epoch."""
    k = int(config["k"])
    flops = nbytes = 0
    for n, n_other in _sides(config):
        for kb in blocks(k, block_k(config)):
            f, b = kernels.sweep_block(nnz, n, n_other, kb)
            flops, nbytes = flops + f, nbytes + b
    return flops, nbytes


def mf_epoch_flops(nnz: int, config: dict) -> int:
    """iCD-MF: per side the Gram of the other side's factors, the R'
    products (n × k by k × k_b a block) and the block sweeps."""
    k = int(config["k"])
    flops = mf_sweeps(nnz, config)[0]
    for n, n_other in _sides(config):
        flops += kernels.gram(n_other, k)[0]
        flops += sum(kernels.matmul(n, k, kb)[0]
                     for kb in blocks(k, block_k(config)))
    return flops


def fm_slabs(nnz: int, config: dict) -> tuple:
    """(FLOPs, bytes) of the slab reduces and residual patches of one
    iCD-FM epoch (m = k_b + 1: the block's columns and ψ_spec)."""
    k = int(config["k"])
    flops = nbytes = 0
    for n, n_other in _sides(config):
        for kb in blocks(k, block_k(config)):
            for f, b in (kernels.slab_reduce(nnz, n, n_other, kb + 1),
                         kernels.resid_patch(nnz, n, n_other, kb + 1)):
                flops, nbytes = flops + f, nbytes + b
    return flops, nbytes


def fm_layers(config: dict, history_length: int) -> list:
    """Per side, (entries, vocab) of each field layer: a one-hot field is
    one layer of n entries; a multi-hot bag one (Jacobi) layer of n ×
    bag entries."""
    if config["multi_hot_mode"] != "jacobi":
        raise ValueError(f"multi_hot_mode {config['multi_hot_mode']!r}: counted for Jacobi only")
    out = []
    for key, n in (("context_fields", int(config["n_ctx"])),
                   ("item_fields", int(config["n_items"]))):
        bags = config.get("bag_fields", [])
        out.append([(n * (history_length if name in bags else 1), vocab)
                    for name, vocab in config[key]])
    return out


def fm_epoch_flops(nnz: int, config: dict, history_length: int) -> int:
    """iCD-FM, D = k + 2 columns a side:

      * Φe and Ψe at the epoch's start: 2k a design entry, and the
        self-pairwise term (2k a row and feature, 3 an entry);
      * per side: the Gram of the other side's (n_other, D) extension;
        the slab reduces and residual patches; per column the two R'
        products (n × D by D × 1) and each field layer: 36 an entry (g,
        the four moment sums, the entry's Δ, Δφ and Δφ_spec), 8 a
        feature (the Newton step), 16 a row (the four cache patches);
        the within-block q patch (4 a row and later column); per side the
        linear layers (12 an entry, 8 a feature, 4 a row) and, on the
        context side, the bias (6 a row)."""
    k = int(config["k"])
    d = k + 2
    layers = fm_layers(config, history_length)
    p = [int(config["p_ctx"]), int(config["p_item"])]
    flops = fm_slabs(nnz, config)[0]
    for side, ((n, n_other), side_layers) in enumerate(zip(_sides(config), layers)):
        entries = sum(e for e, _ in side_layers)
        flops += 2 * k * entries + 2 * k * p[side] + 3 * entries
        flops += kernels.gram(n_other, d)[0]
        flops += k * 2 * kernels.matmul(n, d, 1)[0]
        per_col = sum(36 * e + 8 * v + 16 * n for e, v in side_layers)
        flops += k * per_col
        flops += sum(4 * n * kb * (kb - 1) // 2 for kb in blocks(k, block_k(config)))
        flops += sum(12 * e + 8 * v + 4 * n for e, v in side_layers)
        if side == 0:
            flops += 6 * n
    return flops
