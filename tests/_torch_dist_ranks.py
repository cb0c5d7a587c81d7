"""Rank programs for ``tests/test_torch_dist.py``: the distribution layer
of the port on gloo ranks on the CPU.

``python -c "from _torch_dist_ranks import main; main()" WORLD DIR`` (with
``src`` and ``tests`` on ``PYTHONPATH``) reads the inputs the test wrote to
``DIR/inputs.npz``, spawns WORLD ranks with ``torch.multiprocessing``
(initialised through a ``FileStore`` in DIR, so no port is fixed), runs
every case of that world size on each rank and writes each rank's results
to ``DIR/rank{r}.npz``. It imports no JAX: the test compares the results
with the JAX package in its own process."""
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core.gram import sharded_gram
from repro_torch.core.models import mf, mf_dist
from repro_torch.runtime import collectives
from repro_torch.sparse.interactions import build_interactions

# (variant, wire dtype, Gram implementation) of the 2-epoch MF cases
MF_CASES = (("gather", "float32", "xla"), ("route", "float32", "xla"),
            ("route", "bfloat16", "xla"), ("gather", "float32", "pallas"))
TOPK_K = 7
BARRIER_DELAY_S = 0.5


def mf_problem(inp, prefix):
    """The port's data and params of an MF problem the test wrote."""
    g = lambda name: inp[f"{prefix}_{name}"]  # noqa: E731
    n_ctx, n_items, k = (int(x) for x in g("dims"))
    data = build_interactions(g("ctx"), g("item"), g("y"), g("a"), n_ctx,
                              n_items, alpha0=float(g("alpha0")), device="cpu")
    params = mf.params_from_numpy(g("w0"), g("h0"), device="cpu")
    hp = mf.MFHyperParams(k=k, alpha0=float(g("alpha0")), l2=float(g("l2")))
    return data, params, hp


def run_mf(out, inp, mesh, rank, prefix, cases):
    data, params, hp = mf_problem(inp, prefix)
    host = mf_dist.shard_interactions(data, mesh.size())
    pb = mf_dist.shard_params(params, host)
    e0 = mf_dist.residuals_blocked(pb, host)
    loc = host.local(rank, "cpu")
    for variant, wire, impl in cases:
        hpv = mf.MFHyperParams(k=hp.k, alpha0=hp.alpha0, l2=hp.l2,
                               implementation=impl)
        epoch = mf_dist.build_epoch(mesh, hpv, host, variant=variant,
                                    wire_dtype=getattr(torch, wire))
        w, h, e = pb.w[rank], pb.h[rank], e0[rank]
        collectives.reset_counts()
        for _ in range(2):
            w, h, e = epoch(w, h, loc, e)
        tag = f"{prefix}_{variant}_{wire}_{impl}"
        out[f"{tag}_w"], out[f"{tag}_h"], out[f"{tag}_e"] = w, h, e
        out[f"{tag}_calls"] = [collectives.all_reduce.calls,
                               collectives.all_gather.calls,
                               collectives.all_to_all.calls]


def run_topk(out, inp, mesh, rank, n_shards):
    from repro_torch.serve.cluster import (ShardedRetrievalCluster,
                                           shard_map_topk, shard_psi)

    psi, phi = torch.as_tensor(inp["psi"]), torch.as_tensor(inp["phi"])
    eids = torch.as_tensor(inp["eids"])
    table = shard_psi(psi, n_shards)
    for tag, ex in (("plain", None), ("excl", eids)):
        s, i = shard_map_topk(mesh, table, phi, TOPK_K, exclude_ids=ex)
        out[f"topk{n_shards}_{tag}_s"], out[f"topk{n_shards}_{tag}_i"] = s, i
    cluster = ShardedRetrievalCluster(n_shards=n_shards, k=TOPK_K,
                                      psi_table=psi)
    s, i = cluster.topk_phi(phi, exclude_ids=eids, mesh=mesh)
    out[f"topk{n_shards}_cluster_s"], out[f"topk{n_shards}_cluster_i"] = s, i
    try:
        shard_map_topk(mesh, shard_psi(psi, n_shards + 1), phi, TOPK_K)
    except ValueError as exc:
        out[f"topk{n_shards}_refusal"] = np.array(str(exc))


def cases4(rank, out, inp, d):
    """sharded_gram, the MF epochs, the clamp case, compressed_psum,
    shard_map_topk, and a checkpoint resharded onto two ranks."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.launch.sharding import P, named
    from repro_torch.optim.compression import compressed_psum
    from repro_torch.runtime.elastic import ElasticMeshManager

    mesh = mf_dist.make_shard_mesh(4, device_type="cpu")
    try:
        mf_dist.make_shard_mesh(3, device_type="cpu")
    except ValueError as exc:
        out["mesh_refusal"] = np.array(str(exc))

    m = torch.as_tensor(inp["gram_m"])
    rows = m.shape[0] // 4
    part = m[rank * rows:(rank + 1) * rows]
    out["gram_xla"] = sharded_gram(part, mesh)
    out["gram_pallas"] = sharded_gram(part, (mesh, "shards"),
                                      implementation="pallas")

    run_mf(out, inp, mesh, rank, "main", MF_CASES)
    run_mf(out, inp, mesh, rank, "clamp",
           (("gather", "float32", "xla"), ("route", "float32", "xla")))

    g = torch.as_tensor(inp["grad"])[rank]
    out["psum_mean"], out["psum_err"] = compressed_psum(
        g, torch.zeros_like(g), mesh)

    run_topk(out, inp, mesh, rank, 4)

    # a (2, 2) mesh's checkpoint restored onto the survivors of ranks 2, 3
    mgr = ElasticMeshManager(model_axis=2, device_type="cpu")
    big = mgr.build()
    specs = {"w": P("data", None), "h": P("model", None)}
    full = {"w": torch.as_tensor(inp["ck_w"]),
            "h": torch.as_tensor(inp["ck_h"]).bfloat16()}
    state = {n: distribute_tensor(full[n], s.mesh, s.placements)
             for n, s in named(big, specs).items()}
    ck = Checkpointer(os.path.join(d, "ck"))
    ck.save(1, state)
    out["ck_seen_on_return"] = [os.path.exists(
        os.path.join(d, "ck", "step_0000000001", "manifest.json"))]
    small = mgr.on_failure([2, 3])
    restored = ck.restore(1, full, shardings=mgr.shardings(specs, full))
    if small.get_coordinate() is not None:
        for n, x in restored.items():
            out[f"ck_{n}_mesh"] = [x.device_mesh.size(), *x.device_mesh.shape]
            out[f"ck_{n}_local"] = x.to_local().float()
            whole = x.full_tensor()
            out[f"ck_{n}_equal"] = [bool(torch.equal(whole, full[n]))]
    out["ck_small_shape"] = list(small.shape)


def cases2(rank, out, inp, d):
    """Sharding hints on DTensors, named shardings of icd-mf's specs, the
    launch meshes, and shard_map_topk over two shards."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch.sharding import icd_mf_specs, named
    from repro_torch.models.hints import constrain, sharding_hints

    model = init_device_mesh("cpu", (2,), mesh_dim_names=("model",))
    x = distribute_tensor(torch.arange(16.0).reshape(4, 4), model,
                          [Replicate()])
    out["hints_outside_is_x"] = [constrain(x, ("expert", None)) is x]
    with sharding_hints(expert="model"):
        y = constrain(x, ("expert", None))
        z = constrain(torch.arange(8.0).reshape(2, 4), (None, "expert"),
                      mesh=model)
    out["hints_y_placements"] = np.array(repr(y.placements))
    out["hints_y_local"], out["hints_y_full"] = y.to_local(), y.full_tensor()
    out["hints_z_local"] = z.to_local()

    grid = init_device_mesh("cpu", (1, 2), mesh_dim_names=("data", "model"))
    pods = init_device_mesh("cpu", (1, 1, 2),
                            mesh_dim_names=("pod", "data", "model"))
    out["dp_axes"] = np.array([repr(lmesh.dp_axes(grid)),
                               repr(lmesh.dp_axes(pods))])
    out["n_chips"] = [lmesh.n_chips(grid), lmesh.n_chips(pods)]
    try:
        lmesh.make_production_mesh(device_type="cpu")
    except (RuntimeError, ValueError) as exc:
        out["production_refusal"] = np.array(type(exc).__name__)
    pspecs, _ = icd_mf_specs(grid)
    params = mf.params_from_numpy(inp["ck_w"], inp["ck_w"][:6], device="cpu")
    sh = named(grid, pspecs)
    for n in ("w", "h"):
        t = distribute_tensor(getattr(params, n), getattr(sh, n).mesh,
                              getattr(sh, n).placements)
        out[f"named_{n}_local"] = t.to_local()

    # the barrier holds every rank until the last (here rank 0) arrives
    if rank == 0:
        time.sleep(BARRIER_DELAY_S)
    out["barrier_enter"] = [time.time()]
    collectives.mesh_barrier(grid)
    out["barrier_leave"] = [time.time()]

    run_topk(out, inp, grid["model"], rank, 2)
    m = torch.as_tensor(inp["gram_m"])
    out["gram2"] = sharded_gram(m[rank * 32:(rank + 1) * 32], (grid, "model"))


def run(rank, world, d):
    store = dist.FileStore(os.path.join(d, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    torch.set_num_threads(1)
    inp = dict(np.load(os.path.join(d, "inputs.npz")))
    out = {}
    try:
        (cases4 if world == 4 else cases2)(rank, out, inp, d)
        collectives.all_reduce(torch.zeros(1), dist.group.WORLD)
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(d, f"rank{rank}.npz"),
             **{k: v.detach().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v) for k, v in out.items()})


def main():
    world, d = int(sys.argv[1]), sys.argv[2]
    mp.spawn(run, args=(world, d), nprocs=world, join=True)


if __name__ == "__main__":
    main()
