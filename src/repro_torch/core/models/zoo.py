"""Tiny reference instances of every k-separable model (port of
``repro.core.models.zoo``).

Builds a small instance of each zoo model through the unified
:mod:`repro_torch.core.models.api` ``Model`` protocol, so every consumer
exercises the same models through ONE surface. The designs and pair lists
come from the caller's numpy ``rng`` in the reference's order of draws, so
both packages build the same data from the same seed; the params come from
a ``torch.Generator`` (the reference draws them from ``jax.random``, which
the port cannot reproduce: to compare, carry the reference's params over
with each module's ``params_from_numpy``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.design import make_design
from repro_torch.core.models import fm, mf, mfsi, parafac, tucker
from repro_torch.core.models.api import Dataset, build_model
from repro_torch.core.models.parafac import TensorContext
from repro_torch.kernels import resolve_device

ZOO = ("mf", "mfsi", "fm", "parafac", "tucker")


def rand_f32(shape, seed=0, *, device=None) -> torch.Tensor:
    """Seeded standard normals on ``device`` (CUDA unless the CPU is
    named)."""
    return torch.as_tensor(np.random.default_rng(seed).normal(size=shape),
                           dtype=torch.float32, device=resolve_device(device))


def zoo_model(name, rng, *, n_ctx=20, n_items=37, b=9, k=6, device=None):
    """A small instance of zoo model ``name`` on ``device`` (the GPU unless
    the caller names the CPU): ``(model, params, query)``, where ``params``
    is a seeded init and ``query`` a B-row ``build_phi`` address in the
    model's own query space (ctx ids / design rows / a ``(c1, c2)``
    pair)."""
    dev = resolve_device(device)

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    if name == "mf":
        model = build_model("mf", hp=mf.MFHyperParams(k=k), dataset=Dataset())
        return (model, mf.init(n_ctx, n_items, k, generator=gen(0)),
                torch.arange(b, device=dev))
    if name in ("parafac", "tucker"):
        c1 = torch.as_tensor(rng.integers(0, 8, b), device=dev)
        c2 = torch.as_tensor(rng.integers(0, 7, b), device=dev)
        tc = TensorContext(c1=c1, c2=c2, n_c1=8, n_c2=7)
        if name == "parafac":
            params = parafac.init(8, 7, n_items, k, generator=gen(1))
            hp = parafac.PARAFACHyperParams(k=k)
        else:
            params = tucker.init(8, 7, n_items, 4, 3, k, generator=gen(2))
            hp = tucker.TuckerHyperParams(k1=4, k2=3, k3=k)
        return build_model(name, hp=hp, dataset=Dataset(tc=tc)), params, (c1, c2)
    x = make_design(
        [dict(name="id", ids=np.arange(n_ctx) % 11, vocab=11),
         dict(name="grp", ids=rng.integers(0, 5, n_ctx), vocab=5)], n_ctx,
        device=dev)
    z = make_design(
        [dict(name="item_id", ids=np.arange(n_items), vocab=n_items),
         dict(name="genre", ids=rng.integers(0, 7, n_items), vocab=7)],
        n_items, device=dev)
    if name == "mfsi":
        model = build_model("mfsi", hp=mfsi.MFSIHyperParams(k=k),
                            dataset=Dataset(x=x, z=z))
        return (model, mfsi.init(x.p, z.p, k, generator=gen(3)),
                torch.arange(b, device=dev))
    if name != "fm":
        raise ValueError(f"unknown zoo model {name!r}")
    params = fm.init(x.p, z.p, k, generator=gen(4))
    # break the all-zero linear/bias init so ψ_spec is a real column
    params = params._replace(
        b=torch.tensor(0.3, device=dev), w_lin=rand_f32((x.p,), 10, device=dev),
        h_lin=rand_f32((z.p,), 11, device=dev))
    model = build_model("fm", hp=fm.FMHyperParams(k=k), dataset=Dataset(x=x, z=z))
    return model, params, torch.arange(b, device=dev)


def model_phi_psi(name, rng, *, n_ctx=20, n_items=37, b=9, k=6, device=None):
    """A small instance of zoo model ``name``; returns (phi (B, D),
    psi (n_items, D)) through the model's export contract."""
    model, params, query = zoo_model(name, rng, n_ctx=n_ctx, n_items=n_items,
                                     b=b, k=k, device=device)
    return model.build_phi(params, query), model.export_psi(params)
