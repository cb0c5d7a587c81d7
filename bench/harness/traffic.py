"""The one generator: a cell's inputs from its configuration, its traffic
mix and ``--seed``.

The log law (``traffic["log"]``) is drawn once from the mix's own
``base_seed``, on the device: each user's draws are ``min_degree`` plus a
geometric excess of mean ``mean_excess``, each draw an item with
popularity ∝ rank^-``popularity_exponent`` over a seeded permutation
(inverse CDF), duplicate pairs dropped. ``--seed`` then relabels users and
items by two seeded permutations and draws the initial factors, so every
seed runs the same sizes and degrees, in another order, from another
start.

Context features (``traffic["context_fields"]``, for a configuration with
fields) are built on the base log before the relabelling, by law:
``row`` (the row's own id), ``uniform`` (one-hot, seeded by
``field_seed``), ``last_item`` (the row's largest logged item) and
``last_items`` (a bag of the row's ``history_length`` largest logged
items, each weighing 1/len; a copy of ``chip_smoke.history_bags``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Inputs:
    """What the benchmark hands to both the program and the reference.

    ``ctx``/``item`` are the observed pairs sorted by (ctx, item); ``y`` and
    ``alpha`` their raw targets and confidences (before Lemma 1's
    rescaling); fields are ``make_design`` specs on the host; ``factors``
    the initial parameters on the device, float32, in the configuration's
    order."""

    n_ctx: int
    n_items: int
    ctx: np.ndarray
    item: np.ndarray
    y: np.ndarray
    alpha: np.ndarray
    ctx_fields: list
    item_fields: list
    factors: dict

    @property
    def nnz(self) -> int:
        return len(self.ctx)


def draw_log(n_ctx: int, n_items: int, law: dict, device) -> tuple:
    """The base log on ``device``: sorted unique (ctx, item) pairs."""
    gen = torch.Generator(device=device).manual_seed(int(law["base_seed"]))
    # torch's geometric counts trials (≥ 1): the excess is one less
    deg = torch.empty((n_ctx,), dtype=torch.float64, device=device).geometric_(
        1.0 / (1.0 + float(law["mean_excess"])), generator=gen)
    deg = deg.long() + (int(law["min_degree"]) - 1)
    pop = torch.arange(1, n_items + 1, dtype=torch.float64,
                       device=device) ** -float(law["popularity_exponent"])
    pop = pop[torch.randperm(n_items, generator=gen, device=device)]
    cdf = torch.cumsum(pop / pop.sum(), 0)
    u = torch.rand(int(deg.sum()), generator=gen, device=device,
                   dtype=torch.float64)
    items = torch.searchsorted(cdf, u, right=True).clamp_(max=n_items - 1)
    users = torch.repeat_interleave(torch.arange(n_ctx, device=device), deg)
    pairs = torch.unique(users * n_items + items)
    return pairs // n_items, pairs % n_items


def max_degrees(inputs: Inputs) -> dict:
    """Each side's largest degree: the row width that a layout padding
    every row to the longest would need."""
    return {"max_ctx_degree": int(np.bincount(inputs.ctx).max()),
            "max_item_degree": int(np.bincount(inputs.item).max())}


def last_items(ctx: np.ndarray, item: np.ndarray, n_ctx: int, length: int):
    """Each row's last ``length`` items of the sorted pairs, each weighing
    1/len; padding id 0 with weight 0. ((n_ctx, length) ids, weights)."""
    ends = np.searchsorted(ctx, np.arange(n_ctx), side="right")
    n = np.minimum(ends - np.searchsorted(ctx, np.arange(n_ctx)), length)
    held = np.arange(length)[None, :] < n[:, None]
    idx = np.where(held, ends[:, None] - n[:, None] + np.arange(length), 0)
    ids = np.where(held, item[idx], 0)
    return ids, np.where(held, 1.0 / np.maximum(n, 1)[:, None], 0.0)


def _base_fields(fields, laws: dict, ctx, item, n_rows: int, traffic: dict):
    """Field specs on the base labels: (name, ids, weights, vocab, law)."""
    rng = np.random.default_rng(int(traffic.get("field_seed", 0)))
    ends = np.searchsorted(ctx, np.arange(n_rows), side="right")
    out = []
    for name, vocab in fields:
        law = laws[name]
        weights = None
        if law == "row":
            ids = np.arange(n_rows)
        elif law == "uniform":
            ids = rng.integers(0, vocab, n_rows)
        elif law == "last_item":
            if np.any(ends == np.searchsorted(ctx, np.arange(n_rows))):
                raise ValueError(f"field {name}: a row with no logged item")
            ids = item[ends - 1]
        elif law == "last_items":
            ids, weights = last_items(ctx, item, n_rows,
                                      int(traffic["history_length"]))
        else:
            raise ValueError(f"field {name}: unknown law {law!r}")
        out.append((name, ids, weights, int(vocab), law))
    return out


def _relabel_fields(base, row_perm: np.ndarray, item_perm: np.ndarray):
    """Move each row to its new label; item-valued ids take the items' new
    labels, ``row`` fields stay the identity."""
    specs = []
    for name, ids, weights, vocab, law in base:
        if law == "row":
            specs.append(dict(name=name, ids=np.arange(len(row_perm)), vocab=vocab))
            continue
        if law in ("last_item", "last_items"):
            ids = item_perm[ids]
        moved = np.empty_like(ids)
        moved[row_perm] = ids
        spec = dict(name=name, ids=moved, vocab=vocab)
        if weights is not None:
            w = np.empty_like(weights)
            w[row_perm] = weights
            spec["weights"] = w
        specs.append(spec)
    return specs


def _factors(config: dict, gen: torch.Generator, device) -> dict:
    """Initial factors from ``config["factors"]``: each a [law, *dims]
    with dims named by config keys; ``normal`` is σ·N(0, 1) with σ =
    ``init_sigma``, ``zeros`` is zeros. One draw a factor, on the device."""
    out = {}
    for name, (law, *dims) in config["factors"].items():
        shape = tuple(int(config[d]) for d in dims)
        if law == "normal":
            out[name] = float(config["init_sigma"]) * torch.randn(
                shape, generator=gen, device=device)
        elif law == "zeros":
            out[name] = torch.zeros(shape, device=device)
        else:
            raise ValueError(f"factor {name}: unknown law {law!r}")
    return out


def make_inputs(config: dict, traffic: dict, seed: int, device) -> Inputs:
    n_ctx, n_items = int(config["n_ctx"]), int(config["n_items"])
    law = traffic["log"]
    b_ctx, b_item = draw_log(n_ctx, n_items, law, device)
    h_ctx, h_item = b_ctx.cpu().numpy(), b_item.cpu().numpy()
    ctx_base = (_base_fields(config["context_fields"], traffic["context_fields"],
                             h_ctx, h_item, n_ctx, traffic)
                if "context_fields" in config else [])
    gen = torch.Generator(device=device).manual_seed(int(seed))
    row_perm = torch.randperm(n_ctx, generator=gen, device=device)
    item_perm = torch.randperm(n_items, generator=gen, device=device)
    key = row_perm[b_ctx] * n_items + item_perm[b_item]
    key = torch.sort(key).values.cpu().numpy()
    del b_ctx, b_item
    rp, ip = row_perm.cpu().numpy(), item_perm.cpu().numpy()
    item_base = [(name, np.arange(vocab), None, int(vocab), "row")
                 for name, vocab in config.get("item_fields", [])]
    nnz = len(key)
    return Inputs(
        n_ctx=n_ctx, n_items=n_items, ctx=key // n_items, item=key % n_items,
        y=np.full(nnz, float(law["y"])),
        alpha=np.full(nnz, float(config["alpha0"]) + float(law["alpha_minus_alpha0"])),
        ctx_fields=_relabel_fields(ctx_base, rp, ip),
        item_fields=_relabel_fields(item_base, ip, ip),
        factors=_factors(config, gen, device))
