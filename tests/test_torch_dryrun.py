"""The port's launch tooling (``launch.{hlo_analysis,cells,dryrun}`` and
the collectives' byte counts and fake backend) held against the JAX
package on the CPU.

The text helpers must give the reference's results on the same HLO
lines, and the roofline the reference's terms for the same numbers. The
cells must list the reference's ids, kinds and global shapes, and on a
world of one (gloo) their steps must answer as the reference cells' steps
(``mf.epoch`` on a 1 × 1 jax mesh, no jit shardings; ``top_k`` of
``w_users @ h_items.T``): the MF epoch at the reference's mf_dist
tolerance (rtol 5e-4 / atol 5e-5), top-K ids exact and scores to rtol
1e-5 / atol 1e-6. One rank of the 256-rank production mesh, traced on meta
tensors in a fake world, must make the collectives a hand count gives.
The reference's own dry run cannot be the oracle: its mesh paths fail
under jax 0.9 (ROADMAP §3)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.configs.base import ShapeSpec as JShapeSpec
from repro.core.models import mf as jmf
from repro.launch import cells as jcells
from repro.launch import hlo_analysis as jhlo
from repro.sparse.interactions import build_interactions as jbuild
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.core.models import mf, mf_dist
from repro_torch.launch import cells, hlo_analysis
from repro_torch.launch.mesh import make_mesh_of_one, make_production_mesh
from repro_torch.runtime import collectives
from repro_torch.sparse.interactions import build_interactions

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
MF_RTOL, MF_ATOL = 5e-4, 5e-5
TOPK_RTOL, TOPK_ATOL = 1e-5, 1e-6

# synthetic HLO lines: the reference's own test's, the -start forms,
# metadata that names a collective, and every kind
HLO = """
  %x = f32[256,1024]{1,0} all-reduce(%a), replica_groups=[16,16]<=[256]
  %y = bf16[512]{0} all-gather(%b), replica_groups={{0,1}}
  %z = f32[8,16]{1,0} all-to-all(%c), replica_groups={{0,1,2,3}}
  %not_a_collective = f32[9999999]{0} add(%p, %q)
  %fusion.1 = f32[4]{0} fusion(%x), calls=%all_reduce_like_name
  %s = (f32[64]{0}, f32[64]{0}) all-reduce-start(%d), replica_groups=[2,128]<=[256]
  %r = f32[32,8]{1,0} reduce-scatter(f32[256,8]{1,0} %e), replica_groups={{0,1,2,3,4,5,6,7}}
  %cp = s32[100]{0} collective-permute(%f), source_target_pairs={{0,1},{1,0}}
  %m = f32[7]{0} negate(%g), metadata={op_name="all-gather(" source_file="x.py"}
  %t = u8[3,5]{1,0} all-to-all(%h), replica_groups=[32,8]<=[256]
"""

TEXT_CASES = [
    ("shape_bytes", ("f32", "16,16")), ("shape_bytes", ("bf16", "8")),
    ("shape_bytes", ("pred", "100")), ("shape_bytes", ("s32", "")),
    ("shape_bytes", ("weird", "4")), ("shape_bytes", ("c128", "3,2")),
    ("shape_bytes", ("f8e4m3fn", "9")), ("shape_bytes", ("u64", "2,2,2")),
    ("group_size", ("replica_groups=[32,8]<=[256]",)),
    ("group_size", ("replica_groups={{0,1,2,3},{4,5,6,7}}",)),
    ("group_size", ("no groups here",)),
    ("group_size", ("x, replica_groups={{5}}, y",)),
    ("collective_bytes", (HLO,)),
    ("collective_bytes", ("",)),
] + [("collective_bytes", (line,)) for line in HLO.strip().splitlines()]


@pytest.mark.parametrize("fn,args", TEXT_CASES)
def test_hlo_text_helpers_equal_the_reference(fn, args):
    name = {"shape_bytes": "_shape_bytes", "group_size": "_group_size",
            "collective_bytes": "collective_bytes"}[fn]
    assert getattr(hlo_analysis, name)(*args) == getattr(jhlo, name)(*args)


def test_roofline_terms_and_dominant_equal_the_reference():
    for terms in ((1.0, 2.0, 0.5), (3.0, 2.0, 0.5), (0.1, 0.2, 0.9),
                  (0.0, 0.0, 0.0)):
        kw = dict(flops=197e12, bytes_accessed=1.6e12, coll_bytes=2.5e10,
                  coll_breakdown={"all-reduce": 1.0}, compute_s=terms[0],
                  memory_s=terms[1], collective_s=terms[2])
        got, want = hlo_analysis.Roofline(**kw), jhlo.Roofline(**kw)
        assert got.to_dict() == want.to_dict()
        assert (got.dominant, got.bound_s) == (want.dominant, want.bound_s)
        assert got.fraction_of_roofline() == want.fraction_of_roofline()
    for ca in ([{"flops": 3.0}], ({"flops": 1.0}, {}), {"flops": 2.0}, [], None):
        assert hlo_analysis.normalize_cost_analysis(ca) == \
            jhlo.normalize_cost_analysis(ca)
    # the port's terms from counts, on the H100's rates and the wire model
    r = hlo_analysis.roofline(
        134e12, 6.7e12, {"all_reduce": 100, "all_gather": 10, "all_to_all": 1},
        {"all_reduce": 1, "all_gather": 2, "all_to_all": 3})
    assert (r.compute_s, r.memory_s) == (2.0, 2.0)
    assert r.coll_breakdown == {"all-reduce": 200.0, "all-gather": 10.0,
                                "all-to-all": 1.0, "counts": {
                                    "all-reduce": 1, "all-gather": 2,
                                    "all-to-all": 3}}
    assert r.collective_s == 211.0 / 450e9


def test_roofline_from_trace_counts_products_and_unfused_bytes():
    """A product, a view and an elementwise op on meta tensors: the FLOP
    counter sees the product alone, the byte counter every op's inputs and
    outputs but the view's, and no collective ran."""
    a = torch.empty((4, 8), device="meta")
    b = torch.empty((2, 8), device="meta")
    r = hlo_analysis.roofline_from_trace(lambda x, y: (x @ y.t()).relu(), (a, b))
    assert r.flops == 2 * 4 * 8 * 2
    # mm reads 32 + 16 floats and writes 8; relu reads and writes 8
    assert r.bytes_accessed == 4 * (32 + 16 + 8 + 8 + 8)
    assert r.coll_bytes == 0 and r.coll_breakdown["counts"] == {
        "all-reduce": 0, "all-gather": 0, "all-to-all": 0}
    assert r.compute_s == r.flops / 67e12 and r.memory_s == r.bytes_accessed / 3.35e12


def _jax_mesh_of_one():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


def _entries(spec):
    """A spec's entries, a one-name tuple written as the name (jax's
    ``PartitionSpec`` stores it so)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def test_cells_ids_kinds_shapes_and_specs_equal_the_reference():
    assert cells.all_cell_ids() == jcells.all_cell_ids()
    assert cells.ICD_ARCHS == jcells.ICD_ARCHS
    jmesh = _jax_mesh_of_one()
    with collectives.world_of_one("gloo"):
        mesh = make_mesh_of_one("cpu")
        for arch, shape in cells.all_cell_ids():
            got = cells.build_cell(arch, shape, mesh)
            want = jcells.build_cell(arch, shape, jmesh)
            assert (got.arch, got.shape, got.kind) == (want.arch, want.shape,
                                                       want.kind)
            assert got.notes.startswith(want.notes)
            assert all(t.device.type == "meta"
                       for t in hlo_analysis.tensors_of(got.abstract_args))
            # on one rank the rank's shapes are the global ones
            if got.kind == "retrieval":
                got_shapes = [tuple(a.shape) for a in got.abstract_args]
                want_shapes = [a.shape for a in want.abstract_args]
                assert got_shapes == want_shapes
                assert [_entries(s) for s in got.in_specs] == \
                    [_entries(s) for s in want.in_specs]
                assert [_entries(s) for s in got.out_specs] == \
                    [_entries(s) for s in want.out_specs]
            else:
                w, h, sd, e = got.abstract_args
                jp, jd, je = want.abstract_args
                assert (tuple(w.shape), tuple(h.shape), tuple(e.shape)) == (
                    jp.w.shape, jp.h.shape, je.shape)
                assert tuple(sd.ctx_l.shape) == jd.ctx.shape
                gw, gh, gd, ge = got.in_specs
                jps, jds, jes = want.in_specs
                assert (_entries(gw), _entries(gh), _entries(ge)) == (
                    _entries(jps.w), _entries(jps.h), _entries(jes))
                assert {k: _entries(v) for k, v in gd.items()} == {
                    k: _entries(getattr(jds, k)) for k in gd}


TOY = dict(n_ctx=64, n_items=48, nnz=600, k=8)


def _toy_problem():
    rng = np.random.default_rng(26)
    cells_ = rng.choice(TOY["n_ctx"] * TOY["n_items"], TOY["nnz"], replace=False)
    return dict(ctx=cells_ // TOY["n_items"], item=cells_ % TOY["n_items"],
                y=rng.integers(1, 4, TOY["nnz"]).astype(np.float64),
                a=1.5 + rng.random(TOY["nnz"]),
                w0=(0.1 * rng.normal(size=(TOY["n_ctx"], TOY["k"]))).astype(np.float32),
                h0=(0.1 * rng.normal(size=(TOY["n_items"], TOY["k"]))).astype(np.float32))


def _toy_shape(cls, name):
    if name == "retrieval":
        return cls("retrieval", "retrieval", global_batch=16,
                   extras=(("n_candidates", 300),))
    return cls("epoch_youtube", "train",
               extras=(("n_ctx", TOY["n_ctx"]), ("n_items", TOY["n_items"]),
                       ("nnz", TOY["nnz"])))


def test_train_cell_step_matches_the_reference_cell_on_a_world_of_one():
    import dataclasses

    prob = _toy_problem()
    cfg = dataclasses.replace(get_config("icd-mf"), k=TOY["k"])
    n_ctx, n_items = TOY["n_ctx"], TOY["n_items"]

    # the reference cell's step: mf.epoch, called directly
    want_cell = jcells.build_cell("icd-mf", "epoch_youtube", _jax_mesh_of_one(),
                                  shape_override=_toy_shape(JShapeSpec, "train"))
    jdata = jbuild(prob["ctx"], prob["item"], prob["y"], prob["a"], n_ctx,
                   n_items, alpha0=cfg.alpha0)
    jp = jmf.MFParams(jax.numpy.asarray(prob["w0"]), jax.numpy.asarray(prob["h0"]))
    (jw, jh), je = want_cell.step_fn(jp, jdata, jmf.residuals(jp, jdata))

    data = build_interactions(prob["ctx"], prob["item"], prob["y"], prob["a"],
                              n_ctx, n_items, alpha0=cfg.alpha0, device="cpu")
    params = mf.MFParams(torch.from_numpy(prob["w0"]), torch.from_numpy(prob["h0"]))
    with collectives.world_of_one("gloo"):
        cell = cells.build_cell("icd-mf", "epoch_youtube", make_mesh_of_one("cpu"),
                                cfg_override=cfg,
                                shape_override=_toy_shape(ShapeSpec, "train"))
        host = mf_dist.shard_interactions(data, 1)
        pb = mf_dist.shard_params(params, host)
        e0 = mf_dist.residuals_blocked(pb, host)[0]
        w, h, e = cell.step_fn(pb.w[0], pb.h[0], host.local(0, "cpu"), e0)
    got = mf_dist.unshard_params(mf.MFParams(w[None], h[None]), n_ctx, n_items)
    np.testing.assert_allclose(got.w.numpy(), np.asarray(jw), rtol=MF_RTOL,
                               atol=MF_ATOL)
    np.testing.assert_allclose(got.h.numpy(), np.asarray(jh), rtol=MF_RTOL,
                               atol=MF_ATOL)
    # on one rank the ctx-major block is the whole log in ctx-major order
    np.testing.assert_allclose(e.numpy(), np.asarray(je), rtol=MF_RTOL,
                               atol=MF_ATOL)


def test_retrieval_cell_step_matches_the_reference_cell_on_a_world_of_one():
    import dataclasses

    rng = np.random.default_rng(27)
    k = TOY["k"]
    phi = rng.normal(size=(16, k)).astype(np.float32)
    psi = rng.normal(size=(300, k)).astype(np.float32)
    want_cell = jcells.build_cell("icd-mf", "retrieval", _jax_mesh_of_one(),
                                  shape_override=_toy_shape(JShapeSpec, "retrieval"))
    want_s, want_i = want_cell.step_fn(jax.numpy.asarray(phi), jax.numpy.asarray(psi))
    cfg = dataclasses.replace(get_config("icd-mf"), k=k)
    with collectives.world_of_one("gloo"):
        cell = cells.build_cell("icd-mf", "retrieval", make_mesh_of_one("cpu"),
                                cfg_override=cfg,
                                shape_override=_toy_shape(ShapeSpec, "retrieval"))
        assert [tuple(a.shape) for a in cell.abstract_args] == [(16, k), (300, k)]
        got_s, got_i = cell.step_fn(torch.from_numpy(phi), torch.from_numpy(psi))
    assert got_i.shape == (16, cells.RETRIEVAL_K)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               rtol=TOPK_RTOL, atol=TOPK_ATOL)


def test_gather_train_cell_collectives_in_a_fake_world_of_256():
    """One rank of the 16 × 16 mesh at epoch_youtube, on meta tensors: 2 Gram
    all-reduces, 2k column all-gathers, 2 residual routes, and the bytes a
    hand count gives."""
    d, k = 256, get_config("icd-mf").k
    c_per, i_per = -(-200_000 // d), -(-68_000 // d)   # 782, 266
    p = -(-20_000_000 // d)                            # 78,125
    blk = -(-p // d)                                   # 306
    with collectives.fake_world(d):
        cell = cells.build_cell("icd-mf", "epoch_youtube",
                                make_production_mesh(device_type="cpu"))
        trace = hlo_analysis.trace_step(cell.step_fn, cell.abstract_args)
    assert trace.counts == {"all_reduce": 2, "all_gather": 2 * k, "all_to_all": 2}
    assert trace.payload == {
        "all_reduce": 2 * k * k * 4,
        "all_gather": k * d * (c_per + i_per) * 4,
        "all_to_all": 2 * d * blk * 4,
    }
    w, h, e = trace.outputs
    assert (w.shape, h.shape, e.shape) == ((c_per, k), (i_per, k), (p,))
    assert all(t.device.type == "meta" for t in trace.outputs)
    roof = trace.roofline
    assert roof.coll_breakdown["all-reduce"] == 2 * trace.payload["all_reduce"]
    assert roof.coll_bytes == (2 * trace.payload["all_reduce"]
                               + trace.payload["all_gather"]
                               + trace.payload["all_to_all"])
    # the two Grams are the only matrix products the counter sees
    assert trace.flops == 2 * (c_per + i_per) * k * k
    assert trace.bytes_accessed > 0 and roof.dominant == "memory"


def test_a_meta_tensor_needs_a_fake_group():
    with collectives.world_of_one("gloo"):
        group = collectives.group_of(torch.distributed.group.WORLD)
        assert not group.fake
        with pytest.raises(RuntimeError, match="meta tensor needs a fake"):
            collectives.all_reduce(torch.zeros(3, device="meta"), group)
        collectives.all_reduce(torch.zeros(3), group)   # gloo still serves CPU


def test_a_fake_group_serves_only_meta_tensors():
    collectives.reset_counts()
    with collectives.fake_world(4):
        group = collectives.group_of(torch.distributed.group.WORLD)
        assert group.fake and group.size == 4
        for t in (torch.zeros(3), torch.zeros(3, dtype=torch.int64)):
            for fn in (collectives.all_reduce, collectives.all_gather,
                       collectives.all_to_all):
                with pytest.raises(RuntimeError, match="fake group serves only"):
                    fn(t, group)
        meta = torch.empty((4, 2), device="meta")
        assert collectives.all_gather(meta, group).shape == (16, 2)
        collectives.all_reduce(meta, group)
        collectives.all_to_all(meta, group)
    assert collectives.read_counts() == {"all_reduce": 1, "all_gather": 1,
                                         "all_to_all": 1}
    assert collectives.read_bytes() == {"all_reduce": 32, "all_gather": 128,
                                        "all_to_all": 32}


def _no_zero_stands_in(rec) -> None:
    """Nothing the dry run cannot see is written as a number."""
    assert "lower_s" not in rec and "compile_s" not in rec
    assert rec["trace_s"] > 0 and rec["compile"].startswith("none")
    mem = rec["memory"]
    assert mem["argument_bytes"] > 0 and mem["output_bytes"] > 0
    assert mem["temp_bytes"] is None and mem["peak_hbm_estimate"] is None
    assert mem["not_estimated"]
    r = rec["roofline"]
    assert r["flops_per_device"] > 0 and r["bytes_per_device"] > 0
    assert r["collective_bytes_per_device"] > 0


def test_dryrun_cli_writes_six_ok_cells(tmp_path):
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}", OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--mesh", "both",
           "--out", str(tmp_path)]
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    recs = {p.stem: json.loads(p.read_text()) for p in tmp_path.glob("*.json")}
    assert len(recs) == 6 and all(r["status"] == "ok" for r in recs.values())
    for tag, rec in recs.items():
        _no_zero_stands_in(rec)
        assert rec["chips"] == (512 if tag.endswith("mp") else 256)
        want = ({"all_reduce": 0, "all_gather": 1, "all_to_all": 0}
                if rec["kind"] == "retrieval" else
                {"all_reduce": 2, "all_gather": 256, "all_to_all": 2})
        assert rec["counts"] == want, tag
        assert rec["roofline"]["collective_breakdown"]["counts"] == {
            name.replace("_", "-"): n for name, n in want.items()}
    assert recs["icd-mf__retrieval__sp"]["memory"]["argument_bytes"] == \
        4 * 128 * (256 + 62_500)
    # a second run finds every cell cached
    again = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                           text=True, timeout=120)
    assert again.returncode == 0 and again.stdout.count("[skip-cached]") == 6
