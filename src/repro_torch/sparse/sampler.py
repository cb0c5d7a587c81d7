"""Uniform neighbor sampling for GNN minibatch training (GraphSAGE; port of
``repro.sparse.sampler``).

Seeds → fanout-1 neighbors → fanout-2 neighbors, each drawn uniformly with
replacement from the node's CSR adjacency row (the GraphSAGE default);
isolated nodes self-loop. Fixed fanout shapes, no host round trips. Each
function takes a ``torch.Generator`` where the reference takes a key (the
two draw different numbers).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.sparse.csr import CSR, coo_to_csr


def build_adjacency(src, dst, n_nodes: int, symmetrize: bool = True, *,
                    device=None) -> CSR:
    """Host-side: edge list → CSR adjacency (optionally symmetrized)."""
    src, dst = np.asarray(src), np.asarray(dst)
    if symmetrize:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    return coo_to_csr(src, dst, None, n_nodes, n_nodes, device=device)


def sample_neighbors(generator: torch.Generator, adj: CSR,
                     seeds: torch.Tensor, fanout: int) -> torch.Tensor:
    """Sample ``fanout`` neighbors per seed, uniform with replacement.

    Args:
      generator: a ``torch.Generator`` on the adjacency's device.
      adj: CSR adjacency.
      seeds: (n_seeds,) node ids.
      fanout: neighbors per seed.

    Returns:
      (n_seeds, fanout) int64 neighbor ids. Isolated nodes sample themselves.
    """
    seeds = torch.as_tensor(seeds, dtype=torch.int64, device=adj.indptr.device)
    starts = adj.indptr[seeds]
    degrees = adj.indptr[seeds + 1] - starts
    offs = torch.randint(0, torch.iinfo(torch.int32).max,
                         (seeds.shape[0], fanout), generator=generator,
                         device=seeds.device)
    # modulo degree; guard deg==0 with self loops
    safe_deg = torch.clamp(degrees, min=1)
    offs = offs % safe_deg[:, None]
    # an isolated last node points one past the indices: clip the gather
    # in bounds; the self loop replaces what it read
    pos = torch.clamp(starts[:, None] + offs, max=max(adj.nnz - 1, 0))
    neigh = (adj.indices[pos] if adj.nnz
             else torch.zeros_like(pos))
    return torch.where(degrees[:, None] > 0, neigh, seeds[:, None])


def neighbor_sampler(generator: torch.Generator, adj: CSR, seeds,
                     fanouts: Sequence[int]) -> Tuple[torch.Tensor, ...]:
    """Multi-hop GraphSAGE frontier sampling.

    Returns a tuple ``(layer_0, layer_1, ..., layer_L)`` where ``layer_0`` is
    the seeds and ``layer_h`` has shape ``(n_seeds * prod(fanouts[:h]),)`` —
    the flattened h-hop frontier. ``layer_h[i*fanout_h + j]`` is the j-th
    sampled neighbor of ``layer_{h-1}[i]``, so mean-aggregation is a reshape
    + mean along the fanout axis.
    """
    seeds = torch.as_tensor(seeds, dtype=torch.int64, device=adj.indptr.device)
    frontiers = [seeds]
    frontier = seeds
    for fanout in fanouts:
        neigh = sample_neighbors(generator, adj, frontier, fanout)
        frontier = neigh.reshape(-1)
        frontiers.append(frontier)
    return tuple(frontiers)
