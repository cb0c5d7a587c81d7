"""The port's distribution layer (``sharded_gram``, ``mf_dist``,
``optim.compression``, ``shard_map_topk`` and the cluster's ``mesh=``,
``launch.{mesh,sharding}``, ``models.hints``, ``runtime.elastic`` and the
checkpointer's sharded save and ``shardings=`` restore) held against the
JAX package on gloo ranks on the CPU.

The reference's own mesh paths fail under jax 0.9 (ROADMAP §3), so the
port is held against the single-device functions those tests compare
with (``mf.epoch``, ``gram``, ``cluster_topk``) and against the
reference's host-side functions directly. Two subprocesses run the ranks
(``tests/_torch_dist_ranks.py``: 4 ranks, then 2), each with a timeout;
the JAX references run here. Tolerances are the reference's: MF epochs
rtol 5e-4 / atol 5e-5 (bf16 wire: the objective within 1%), the Gram
rtol 1e-5, the compressed mean atol 0.05; top-K ids exact across the
packages with scores to rtol 1e-5 / atol 1e-6, and bit for bit within the
port."""
import os
import subprocess
import sys
import threading
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.gram import gram as jgram
from repro.core.models import mf as jmf
from repro.core.models import mf_dist as jdist
from repro.launch import sharding as jsharding
from repro.optim import compression as jcompression
from repro.runtime.elastic import largest_mesh_shape as jlargest
from repro.serve.cluster import cluster_topk as jcluster_topk
from repro.serve.cluster import shard_psi as jshard_psi
from repro.sparse.interactions import build_interactions as jbuild
from repro_torch.core.models import mf, mf_dist
from repro_torch.launch import sharding
from repro_torch.models import hints
from repro_torch.optim import base, compression
from repro_torch.runtime.elastic import largest_mesh_shape
from repro_torch.serve.cluster import cluster_topk, shard_psi
from repro_torch.sparse.interactions import build_interactions

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
RANKS_TIMEOUT_S = 240
TOPK_K = 7  # the rank program's
MF_RTOL, MF_ATOL = 5e-4, 5e-5


def _problem(n_ctx, n_items, nnz, k, l2, seed, empty_last=False):
    """An MF problem as the rank program reads it (inputs.npz keys);
    ``empty_last`` leaves the last context without interactions."""
    rng = np.random.default_rng(seed)
    cells = rng.choice((n_ctx - empty_last) * n_items, nnz, replace=False)
    return {
        "ctx": cells // n_items, "item": cells % n_items,
        "y": rng.integers(1, 4, nnz).astype(np.float64),
        "a": 1.5 + rng.random(nnz),
        "w0": (0.1 * rng.normal(size=(n_ctx, k))).astype(np.float32),
        "h0": (0.1 * rng.normal(size=(n_items, k))).astype(np.float32),
        "dims": np.array([n_ctx, n_items, k]), "alpha0": np.array(0.5),
        "l2": np.array(l2),
    }


PROBLEMS = {
    # the reference's tests/test_mf_dist.py sizes, deliberately non-divisible
    "main": _problem(53, 37, 300, 6, 0.05, 0),
    # its l2 = 0 clamp case: context 20 has no interaction
    "clamp": _problem(21, 17, 90, 4, 0.0, 7, empty_last=True),
}


def _inputs() -> dict:
    rng = np.random.default_rng(11)
    inp = {f"{p}_{k}": v for p, prob in PROBLEMS.items() for k, v in prob.items()}
    eids = rng.integers(0, 50, (5, 4)).astype(np.int32)
    eids[:, 3] = -1
    inp.update(
        gram_m=rng.normal(size=(64, 6)).astype(np.float32),
        grad=rng.normal(size=(4, 128)).astype(np.float32),
        psi=rng.normal(size=(50, 8)).astype(np.float32),
        phi=rng.normal(size=(5, 8)).astype(np.float32),
        eids=eids,
        ck_w=np.arange(32.0, dtype=np.float32).reshape(8, 4),
        ck_h=rng.normal(size=(6, 4)).astype(np.float32),
    )
    return inp


INPUTS = _inputs()


def _run_ranks(world: int, d: Path) -> list:
    d.mkdir(parents=True, exist_ok=True)
    np.savez(d / "inputs.npz", **INPUTS)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=f"{ROOT / 'src'}:{ROOT / 'tests'}")
    proc = subprocess.run(
        [sys.executable, "-c", "from _torch_dist_ranks import main; main()",
         str(world), str(d)],
        cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=RANKS_TIMEOUT_S)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return _run_ranks(4, tmp_path_factory.mktemp("ranks4"))


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return _run_ranks(2, tmp_path_factory.mktemp("ranks2"))


def _jax_data(prob):
    n_ctx, n_items, _ = (int(x) for x in prob["dims"])
    return jbuild(prob["ctx"], prob["item"], prob["y"], prob["a"], n_ctx,
                  n_items, alpha0=float(prob["alpha0"]))


def _port_data(prob):
    n_ctx, n_items, _ = (int(x) for x in prob["dims"])
    return build_interactions(prob["ctx"], prob["item"], prob["y"], prob["a"],
                              n_ctx, n_items, alpha0=float(prob["alpha0"]),
                              device="cpu")


def _jax_hp(prob):
    return jmf.MFHyperParams(k=int(prob["dims"][2]),
                             alpha0=float(prob["alpha0"]), l2=float(prob["l2"]))


def _reference_epochs(prob, n=2):
    data, hp = _jax_data(prob), _jax_hp(prob)
    p = jmf.MFParams(jnp.asarray(prob["w0"]), jnp.asarray(prob["h0"]))
    e = jmf.residuals(p, data)
    for _ in range(n):
        p, e = jmf.epoch(p, data, e, hp)
    return p


def _gathered(ranks, tag, prob):
    """The ranks' blocks of one case, unsharded, and their residual blocks."""
    n_ctx, n_items, _ = (int(x) for x in prob["dims"])
    blocked = mf.MFParams(
        torch.stack([torch.as_tensor(r[f"{tag}_w"]) for r in ranks]),
        torch.stack([torch.as_tensor(r[f"{tag}_h"]) for r in ranks]))
    e = torch.stack([torch.as_tensor(r[f"{tag}_e"]) for r in ranks])
    return blocked, mf_dist.unshard_params(blocked, n_ctx, n_items), e


# ------------------------------------------------------------ host side ---
@pytest.mark.parametrize("n_shards", [4, 8])
@pytest.mark.parametrize("weighted", [False, True])
def test_shard_interactions_array_equal_to_reference(n_shards, weighted):
    prob = PROBLEMS["main"]
    w = (np.random.default_rng(3).random(len(prob["ctx"])).astype(np.float32)
         if weighted else None)
    want = jdist.shard_interactions(_jax_data(prob), n_shards,
                                    weights=None if w is None else jnp.asarray(w))
    got = mf_dist.shard_interactions(_port_data(prob), n_shards, weights=w)
    for f in mf_dist._FIELDS:
        a, b = np.asarray(getattr(want, f)), getattr(got, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    assert (got.c_per, got.i_per, got.n_shards) == (
        want.c_per, want.i_per, want.n_shards)


@pytest.mark.parametrize("n_shards", [4, 8])
def test_shard_params_and_residuals_blocked_array_equal(n_shards):
    prob = PROBLEMS["main"]
    n_ctx, n_items, _ = (int(x) for x in prob["dims"])
    jsd = jdist.shard_interactions(_jax_data(prob), n_shards)
    sd = mf_dist.shard_interactions(_port_data(prob), n_shards)
    jpb = jdist.shard_params(
        jmf.MFParams(jnp.asarray(prob["w0"]), jnp.asarray(prob["h0"])), jsd)
    pb = mf_dist.shard_params(
        mf.params_from_numpy(prob["w0"], prob["h0"], device="cpu"), sd)
    np.testing.assert_array_equal(pb.w.numpy(), np.asarray(jpb.w))
    np.testing.assert_array_equal(pb.h.numpy(), np.asarray(jpb.h))
    np.testing.assert_array_equal(
        mf_dist.residuals_blocked(pb, sd).numpy(),
        np.asarray(jdist.residuals_blocked(jpb, jsd)))
    back = mf_dist.unshard_params(pb, n_ctx, n_items)
    np.testing.assert_array_equal(back.w.numpy(), prob["w0"])
    np.testing.assert_array_equal(back.h.numpy(), prob["h0"])
    loc = sd.local(n_shards - 1, "cpu")
    assert loc.ctx_l.dtype == torch.int64 and loc.send_idx.shape == (
        n_shards, sd.send_idx.shape[2])
    np.testing.assert_array_equal(loc.recv_pos.numpy(), sd.recv_pos[-1])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ef_compress_update_array_equal_to_reference(seed):
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(8, 128)).astype(np.float32) * 10 ** seed
    err = rng.normal(size=(8, 128)).astype(np.float32) * 0.01
    if seed == 2:
        g[0, :4] = [0.0, 127.0, -127.0, 63.5]  # zero, the ends, a tie
    want = jcompression.ef_compress_update(jnp.asarray(g), jnp.asarray(err))
    got = compression.ef_compress_update(torch.as_tensor(g), torch.as_tensor(err))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert compression.int8_compress is not None and compression.int8_decompress(
        got[0], got[1]).dtype == torch.float32


def _runtime_cases():
    """Every case of tests/test_runtime.py's largest_mesh_shape tests."""
    return [(256, 16), (240, 16), (250, 16), (7, 4), (512, 16), (8, 6),
            (12, 6), (18, 12), (15, 6), (100, 48), (1, 16), (5, 1), (13, 13),
            (13, 12), (6, 0)]


@pytest.mark.parametrize("n,model", _runtime_cases())
def test_largest_mesh_shape_matches_reference(n, model):
    assert largest_mesh_shape(n, model) == jlargest(n, model)


def test_largest_mesh_shape_refuses_no_devices():
    with pytest.raises(ValueError):
        largest_mesh_shape(0, 4)
    with pytest.raises(ValueError):
        jlargest(0, 4)


def _normalized(entries):
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


def _jax_spec_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return [("/".join(jax.tree_util.keystr((k,)) for k in path),
             _normalized(tuple(spec))) for path, spec in flat]


def _port_spec_leaves(tree):
    paths, leaves, _ = base.tree_flatten_with_path(tree)
    return [(p, _normalized(tuple(s))) for p, s in zip(paths, leaves)]


@pytest.mark.parametrize("multi_pod", [False, True])
def test_spec_trees_match_reference_leaf_for_leaf(multi_pod):
    JP, PP = jax.sharding.PartitionSpec, sharding.P
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    jmesh = jax.make_mesh((1,) * len(names), names)
    pmesh = types.SimpleNamespace(mesh_dim_names=names)
    for jt, pt in zip(jsharding.icd_mf_specs(jmesh),
                      sharding.icd_mf_specs(pmesh)):
        assert _port_spec_leaves(pt) == _jax_spec_leaves(jt)

    def params(P):
        return {"emb": P("model", ("data",)), "w": P(("data",), "model"),
                "b": P(None), "mf": jmf.MFParams(w=P(("data",), None),
                                                 h=P("model", None))}

    jp = params(JP)
    pp = {**params(PP), "mf": mf.MFParams(w=PP(("data",), None),
                                          h=PP("model", None))}
    assert _port_spec_leaves(sharding.opt_state_specs(pp)) == \
        _jax_spec_leaves(jsharding.opt_state_specs(jp))
    assert _port_spec_leaves(sharding.train_state_specs(pp)) == \
        _jax_spec_leaves(jsharding.train_state_specs(jp))
    got_state, got_live = sharding.zero1_state_specs(pp)
    want_state, want_live = jsharding.zero1_state_specs(jp)
    assert _port_spec_leaves(got_state) == _jax_spec_leaves(want_state)
    assert _port_spec_leaves(got_live) == _jax_spec_leaves(want_live)
    assert sharding._drop_data(PP("data", "model")) == PP(None, "model")


def test_sharding_hints_without_mapping_and_restore():
    x = torch.ones((4, 4))
    assert hints.constrain(x, ("a", None)) is x
    with hints.sharding_hints(a="model"):
        with hints.sharding_hints(b="data"):
            assert hints._current() == {"b": "data"}
            seen = []
            t = threading.Thread(target=lambda: seen.append(hints._current()))
            t.start()
            t.join()
            assert seen == [None]  # the mapping is thread-local
        assert hints._current() == {"a": "model"}  # outer mapping restored
        with pytest.raises(ValueError, match="mesh="):
            hints.constrain(x, ("a", None))  # a plain tensor names no mesh
    assert hints._current() is None


def test_group_of_resolves_once_and_refuses():
    """A mesh resolves to a ``Group`` that later calls take as it is; a
    2-D mesh names no single group, and a non-group is refused."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.runtime import collectives

    with collectives.world_of_one("gloo"):
        flat = init_device_mesh("cpu", (1,), mesh_dim_names=("shards",))
        group = collectives.group_of(flat)
        assert collectives.group_of(group) is group
        assert (group.size, group.gloo, group.nccl) == (1, True, False)
        x = torch.arange(6.0)
        assert torch.equal(collectives.all_gather(x, group), x)
        grid = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
        with pytest.raises(ValueError, match="names no single group"):
            collectives.group_of(grid)
        assert collectives.group_of((grid, "model")).size == 1
        with pytest.raises(TypeError, match="expected a Group"):
            collectives.group_of(object())


def test_cluster_mesh_path_refusals():
    from repro_torch.serve.ann import AnnConfig
    from repro_torch.serve.cluster import ShardedRetrievalCluster

    psi = torch.as_tensor(INPUTS["psi"])
    phi = torch.as_tensor(INPUTS["phi"])
    exact = ShardedRetrievalCluster(n_shards=2, k=3, psi_table=psi)
    with pytest.raises(ValueError, match="exclude_ids"):
        exact.topk_phi(phi, exclude_mask=torch.zeros((5, 50), dtype=torch.bool),
                       mesh=object())
    ivf = ShardedRetrievalCluster(n_shards=2, k=3, psi_table=psi,
                                  retrieval="ivf", ann=AnnConfig(n_clusters=2))
    with pytest.raises(ValueError, match="exact-only"):
        ivf.topk_phi(phi, mesh=object())


# ------------------------------------------------------------- 4 ranks ---
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_sharded_gram_matches_reference(four, impl):
    want = np.asarray(jgram(jnp.asarray(INPUTS["gram_m"])))
    for r in four:
        np.testing.assert_allclose(r[f"gram_{impl}"], want, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(r[f"gram_{impl}"], four[0][f"gram_{impl}"])


@pytest.mark.parametrize("variant,impl", [("gather", "xla"), ("route", "xla"),
                                          ("gather", "pallas")])
def test_mf_dist_fp32_wire_matches_reference_epochs(four, variant, impl):
    prob = PROBLEMS["main"]
    ref = _reference_epochs(prob)
    blocked, got, e = _gathered(four, f"main_{variant}_float32_{impl}", prob)
    np.testing.assert_allclose(got.w.numpy(), np.asarray(ref.w),
                               rtol=MF_RTOL, atol=MF_ATOL)
    np.testing.assert_allclose(got.h.numpy(), np.asarray(ref.h),
                               rtol=MF_RTOL, atol=MF_ATOL)
    # the residuals the epochs carried are those of their factors (on real
    # slots: routing leaves α = 0 padding at 0, as the reference's does)
    sd = mf_dist.shard_interactions(_port_data(prob), 4)
    real = torch.as_tensor(sd.alpha_c) > 0
    torch.testing.assert_close(e[real], mf_dist.residuals_blocked(blocked, sd)[real],
                               rtol=1e-4, atol=1e-5)


def test_mf_dist_bf16_wire_objective_within_one_percent(four):
    prob = PROBLEMS["main"]
    data, hp = _jax_data(prob), _jax_hp(prob)
    ref_obj = float(jmf.objective(_reference_epochs(prob), data, hp))
    _, got, _ = _gathered(four, "main_route_bfloat16_xla", prob)
    obj = float(jmf.objective(
        jmf.MFParams(jnp.asarray(got.w.numpy()), jnp.asarray(got.h.numpy())),
        data, hp))
    assert abs(obj - ref_obj) / ref_obj < 0.01, (obj, ref_obj)
    _, fp32, _ = _gathered(four, "main_route_float32_xla", prob)
    assert not torch.equal(got.w, fp32.w)  # the wire did carry bf16


@pytest.mark.parametrize("variant", ["gather", "route"])
def test_mf_dist_empty_context_l2_zero_clamp(four, variant):
    prob = PROBLEMS["clamp"]
    ref = _reference_epochs(prob)
    assert bool(jnp.isfinite(ref.w).all())
    _, got, _ = _gathered(four, f"clamp_{variant}_float32_xla", prob)
    assert torch.isfinite(got.w).all() and torch.isfinite(got.h).all()
    np.testing.assert_allclose(got.w.numpy(), np.asarray(ref.w),
                               rtol=MF_RTOL, atol=MF_ATOL)
    np.testing.assert_allclose(got.h.numpy(), np.asarray(ref.h),
                               rtol=MF_RTOL, atol=MF_ATOL)


@pytest.mark.parametrize("variant", ["gather", "route"])
def test_mf_dist_collectives_per_epoch(four, variant):
    """A rank's collectives in 2 epochs at k = 6: 2 Gram all-reduces an
    epoch, and the gathered or routed column a dimension and side, and 2
    residual routes."""
    k = 6
    want = [4, 4 * k, 4] if variant == "gather" else [4, 0, 4 * k + 4]
    for r in four:
        assert list(r[f"main_{variant}_float32_xla_calls"]) == want


def test_make_shard_mesh_refuses_another_world(four):
    assert "needs a world of 3 ranks; this one has 4" in str(four[0]["mesh_refusal"])


def test_compressed_psum_matches_mean(four):
    g = INPUTS["grad"]
    for rank, r in enumerate(four):
        np.testing.assert_allclose(r["psum_mean"], g.mean(axis=0), atol=0.05)
        np.testing.assert_array_equal(r["psum_mean"], four[0]["psum_mean"])
        _, _, err = jcompression.ef_compress_update(
            jnp.asarray(g[rank]), jnp.zeros(128, jnp.float32))
        np.testing.assert_array_equal(r["psum_err"], np.asarray(err))


def _port_cluster(n_shards, exclude):
    psi = torch.as_tensor(INPUTS["psi"])
    eids = torch.as_tensor(INPUTS["eids"]) if exclude else None
    return cluster_topk(shard_psi(psi, n_shards),
                        torch.as_tensor(INPUTS["phi"]), TOPK_K, exclude_ids=eids)


def _check_topk(ranks, n_shards):
    for exclude, tag in ((False, "plain"), (True, "excl"), (True, "cluster")):
        want_s, want_i = _port_cluster(n_shards, exclude)
        jt = jshard_psi(jnp.asarray(INPUTS["psi"]), n_shards)
        ref_s, ref_i = jcluster_topk(
            jt, jnp.asarray(INPUTS["phi"]), TOPK_K,
            exclude_ids=jnp.asarray(INPUTS["eids"]) if exclude else None)
        for r in ranks:
            got_s = torch.as_tensor(r[f"topk{n_shards}_{tag}_s"])
            got_i = torch.as_tensor(r[f"topk{n_shards}_{tag}_i"])
            assert torch.equal(got_i, want_i) and torch.equal(got_s, want_s)
            np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
            np.testing.assert_allclose(got_s.numpy(), np.asarray(ref_s),
                                       rtol=1e-5, atol=1e-6)
    assert f"mesh has {n_shards} ranks but table has {n_shards + 1} shards" in \
        str(ranks[0][f"topk{n_shards}_refusal"])


def test_shard_map_topk_on_four_ranks(four):
    _check_topk(four, 4)


def test_checkpoint_resharded_onto_survivors(four):
    """A (2, 2) mesh's DTensor checkpoint, restored after ranks 2 and 3
    fail onto the (1, 2) mesh of ranks 0 and 1, bit for bit."""
    w, h = INPUTS["ck_w"], torch.as_tensor(INPUTS["ck_h"]).bfloat16().float()
    for rank, r in enumerate(four):
        assert list(r["ck_small_shape"]) == [1, 2]
        if rank >= 2:
            assert "ck_w_local" not in r
            continue
        assert list(r["ck_w_mesh"]) == [2, 1, 2] == list(r["ck_h_mesh"])
        assert r["ck_w_equal"][0] and r["ck_h_equal"][0]
        np.testing.assert_array_equal(r["ck_w_local"], w)  # data has 1 rank
        np.testing.assert_array_equal(r["ck_h_local"],
                                      h[3 * rank:3 * rank + 3].numpy())


def test_sharded_save_returns_after_the_files_exist(four):
    """Every rank's DTensor ``save`` returns only once process 0 has
    written the checkpoint: each rank finds its manifest on return."""
    assert all(r["ck_seen_on_return"][0] for r in four)


# ------------------------------------------------------------- 2 ranks ---
def test_mesh_barrier_holds_every_rank_until_the_last(two):
    """Rank 0 reaches the (1, 2) mesh's barrier late; no rank leaves it
    before rank 0 has entered."""
    enter0 = two[0]["barrier_enter"][0]
    assert enter0 - min(r["barrier_enter"][0] for r in two) > 0.25
    assert min(r["barrier_leave"][0] for r in two) >= enter0


def test_sharding_hints_place_a_dtensor(two):
    full = np.arange(16.0).reshape(4, 4)
    for rank, r in enumerate(two):
        assert r["hints_outside_is_x"][0]
        assert str(r["hints_y_placements"]) == "(Shard(dim=0),)"
        np.testing.assert_array_equal(r["hints_y_local"], full[2 * rank:2 * rank + 2])
        np.testing.assert_array_equal(r["hints_y_full"], full)
        np.testing.assert_array_equal(
            r["hints_z_local"], np.arange(8.0).reshape(2, 4)[:, 2 * rank:2 * rank + 2])


def test_launch_meshes_and_named_icd_specs(two):
    w = INPUTS["ck_w"]
    for rank, r in enumerate(two):
        assert list(r["dp_axes"]) == ["('data',)", "('pod', 'data')"]
        assert list(r["n_chips"]) == [2, 2]
        assert str(r["production_refusal"]) == "RuntimeError"
        np.testing.assert_array_equal(r["named_w_local"], w)  # W over data (1)
        np.testing.assert_array_equal(r["named_h_local"], w[:6][3 * rank:3 * rank + 3])
        np.testing.assert_allclose(r["gram2"], np.asarray(
            jgram(jnp.asarray(INPUTS["gram_m"]))), rtol=1e-5, atol=1e-5)


def test_shard_map_topk_on_two_ranks(two):
    _check_topk(two, 2)
