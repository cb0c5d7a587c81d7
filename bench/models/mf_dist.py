"""The program under test for the distributed iCD-MF cell: one rank of
``repro_torch``'s ``mf_dist`` gather epoch (``core/models/mf_dist``: the log
range-partitioned by ``shard_interactions``, per column the other side's
column all-gathered, the Grams all-reduced, the residuals routed between
the two orders by all-to-all). Every rank of the initialised world builds
its own from the same inputs; ``leaves`` and ``residual`` are collectives
that give every rank the whole, unsharded state."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.models import mf, mf_dist
from repro_torch.runtime import collectives
from repro_torch.sparse.interactions import build_interactions


class Program:
    def __init__(self, config: dict, inputs, device, rank: int, world: int):
        self.hp = mf.MFHyperParams(
            k=config["k"], alpha0=config["alpha0"], l2=config["l2"], eta=config["eta"],
            implementation=config["implementation"])
        data = build_interactions(inputs.ctx, inputs.item, inputs.y, inputs.alpha,
                                  inputs.n_ctx, inputs.n_items, alpha0=config["alpha0"],
                                  device="cpu")
        self.host = mf_dist.shard_interactions(data, world)
        # real entries of each ctx-major block: the blocks hold (ctx, item)
        # order, a range of contexts each, padded at their ends
        self.real = np.bincount(np.asarray(inputs.ctx) // self.host.c_per, minlength=world)
        self.n_ctx, self.n_items, self.nnz = inputs.n_ctx, inputs.n_items, data.nnz
        self.rank, self.world = rank, world
        self.mesh = mf_dist.make_shard_mesh(world, device_type=device.type)
        self.group = collectives.group_of(self.mesh)
        self.sd = self.host.local(rank, device)
        blocked = mf_dist.shard_params(mf.MFParams(inputs.factors["w"], inputs.factors["h"]),
                                       self.host)
        self.w, self.h = blocked.w[rank].clone(), blocked.h[rank].clone()
        self.e = mf_dist.residuals_blocked(blocked, self.host)[rank].clone()
        self.epoch = mf_dist.build_epoch(self.mesh, self.hp, self.host, variant="gather")

    def step(self) -> None:
        """One epoch on this rank: the window's call, on every rank."""
        self.w, self.h, self.e = self.epoch(self.w, self.h, self.sd, self.e)

    def leaves(self) -> dict:
        k = self.w.shape[1]
        params = mf.MFParams(
            collectives.all_gather(self.w, self.group).reshape(self.world, -1, k),
            collectives.all_gather(self.h, self.group).reshape(self.world, -1, k))
        full = mf_dist.unshard_params(params, self.n_ctx, self.n_items)
        return {"w": full.w, "h": full.h}

    def residual(self) -> torch.Tensor:
        """The carried residuals on the observed pairs, (ctx, item) order."""
        blocks = collectives.all_gather(self.e, self.group).reshape(self.world, -1)
        return torch.cat([blocks[d, :n] for d, n in enumerate(self.real)])

    def counters(self) -> dict:
        return {"nnz": self.nnz, "world": self.world,
                "ctx_block": int(self.sd.ctx_l.shape[0]),
                "item_block": int(self.sd.item_l.shape[0])}
