"""The port's serve driver end to end, its package boundary, its entry
points' device policy, and its CUDA kernels against their plain versions.

``python -m repro_torch.launch.serve --device cpu`` runs as a subprocess
beside the JAX package's driver and must print the same report lines (the
numbers differ: the factors come from different generators, and the
timings from different machines). No file of the port imports JAX or the
JAX package. This module imports no JAX itself, so its ``gpu`` tests run
on a machine with a card and no JAX: ``pytest -m gpu
tests/test_torch_launch.py``."""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels.topk_score import ops, ref
from repro_torch.launch import serve

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ARGS = ["--arch", "icd-mf", "--smoke", "--requests", "32", "--kill", "0:0"]


def _driver(module, extra=()):
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}:{os.environ.get('PYTHONPATH', '')}",
               OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, "-m", module, *ARGS, *extra], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)


def _template(line: str) -> str:
    """A report line with its numbers masked."""
    return re.sub(r"-?\d+(\.\d+)?", "#", line)


def test_serve_driver_cpu_matches_reference_report():
    port = _driver("repro_torch.launch.serve", ["--device", "cpu"])
    assert port.returncode == 0, port.stdout[-1500:] + port.stderr[-1500:]
    ref = _driver("repro.launch.serve")
    assert ref.returncode == 0, ref.stdout[-1500:] + ref.stderr[-1500:]
    got, want = port.stdout.splitlines(), ref.stdout.splitlines()
    assert [_template(x) for x in got] == [_template(x) for x in want]
    # the chaos line, coverage and the fault counters are not timing-bound
    assert got[1] == want[1] and got[4] == want[4]
    assert "1 faults, 1 failovers" in got[3]


def test_serve_main_in_process_report(tmp_path):
    metrics, trace = tmp_path / "m.prom", tmp_path / "t.json"
    report = serve.main([*ARGS, "--device", "cpu", "--stats-every", "16",
                         "--metrics-out", str(metrics),
                         "--trace-out", str(trace)])
    assert report["coverage"] == 1.0 and len(report["results"]) == 32
    assert report["mesh_stats"]["faults"] == 1
    assert "serve_mesh_dispatches_total" in metrics.read_text()
    assert '"traceEvents"' in trace.read_text()


def test_entry_points_refuse_what_is_not_there():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.main(ARGS)  # --device defaults to cuda: no fallback
    with pytest.raises(NotImplementedError, match="slice 2"):
        serve.main([*ARGS, "--device", "cpu", "--continual"])

    with pytest.raises(NotImplementedError, match="not yet ported"):
        get_config("icd-fm")
    with pytest.raises(KeyError):
        get_smoke_config("gpt-2")
    cfg = get_config("icd-mf")
    assert (cfg.n_ctx, cfg.n_items, cfg.k) == (200_000, 68_000, 128)


def test_numpy_data_goes_to_cuda_unless_cpu_is_named():
    from repro_torch.core.models import mf
    from repro_torch.serve.cluster import shard_psi
    from repro_torch.serve.mesh import FaultTolerantRetrievalMesh

    w, h = np.ones((3, 4), np.float32), np.ones((6, 4), np.float32)
    assert mf.params_from_numpy(w, h, device="cpu").h.device.type == "cpu"
    assert shard_psi(torch.as_tensor(h), 2).shards[0].device.type == "cpu"
    if torch.cuda.is_available():
        assert mf.params_from_numpy(w, h).h.device.type == "cuda"
        assert shard_psi(h, 2).shards[0].device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mf.params_from_numpy(w, h)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        shard_psi(h, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FaultTolerantRetrievalMesh(n_shards=2, n_replicas=1, k=2).publish(h)


def test_training_data_goes_to_cuda_unless_cpu_is_named():
    from repro_torch.examples import quickstart
    from repro_torch.serve.engine import exclude_ids_from_lists
    from repro_torch.sparse.interactions import build_interactions

    def build(**kw):
        return build_interactions([0, 1], [1, 0], [1.0, 1.0], [2.0, 2.0], 2, 2,
                                  **kw)

    assert build(device="cpu").ctx.device.type == "cpu"
    assert exclude_ids_from_lists([[1]], device="cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert build().alpha.device.type == "cuda"
        return
    for fn in (build, lambda: exclude_ids_from_lists([[1]]), quickstart.run):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()


_IMPORT = re.compile(
    r"^\s*(import\s+(jax|repro)(\.|\s|,|$)|from\s+(jax|repro)(\.|\s))",
    re.MULTILINE)


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    offenders = {str(f.relative_to(ROOT)): m.group(0).strip()
                 for f in files for m in [_IMPORT.search(f.read_text())] if m}
    assert offenders == {}
    # the pattern does catch what it is for, and not the port itself
    assert _IMPORT.search("import jax.numpy as jnp")
    assert _IMPORT.search("from repro.serve import mesh")
    assert _IMPORT.search("from repro import obs")
    assert not _IMPORT.search("from repro_torch.serve import mesh")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _ints(shape, seed, dev):
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.integers(-3, 4, shape), dtype=torch.float32,
                        device=dev)


@pytest.mark.gpu
@pytest.mark.parametrize("exclude", [False, True])
def test_kernel_matches_plain_on_cuda(cuda, exclude):
    """Small-integer scores are exact in any summation order, so the
    kernel must equal the plain version bit for bit, ties included."""
    phi, psi = _ints((19, 16), 40, cuda), _ints((1001, 16), 41, cuda)
    eids = None
    if exclude:
        rng = np.random.default_rng(42)
        e = rng.integers(4990, 6001, (19, 8)).astype(np.int32)
        e[:, 6:] = -1
        eids = torch.tensor(e, device=cuda)
    before = ops.topk_score.launches
    args = dict(exclude_ids=eids, id_offset=5000, n_valid=990)
    s, i = ops.topk_score(phi, psi, 37, **args)
    rs, ri = ref.topk_score_ref(phi, psi, 37, **args)
    torch.cuda.synchronize()
    assert ops.topk_score.launches == before + 1
    assert torch.equal(i, ri) and torch.equal(s, rs)


@pytest.mark.gpu
def test_unported_forms_raise_on_cuda(cuda):
    phi, psi = torch.zeros(2, 8, device=cuda), torch.zeros(16, 8, device=cuda)
    with pytest.raises(NotImplementedError, match="exclude_mask"):
        ops.topk_score(phi, psi, 4, torch.zeros(2, 16, device=cuda))
    with pytest.raises(NotImplementedError, match="bfloat16"):
        ops.topk_score(phi, psi.bfloat16(), 4)
    with pytest.raises(ValueError, match="int32"):
        ops.topk_score(phi, psi, 4, exclude_ids=torch.zeros(
            2, 3, dtype=torch.int64, device=cuda))


def _sweep_operands(dev, c, d, kb, n_src, k, seed):
    """Sweep operands: W, the ψ slab and the Gram block are column slices
    of wider matrices, as the epochs pass them; a third of the slots is
    padding (id 0, α = 0)."""
    rng = np.random.default_rng(seed)
    alpha = (rng.random((c, d)) * 4 + 0.5).astype(np.float32)
    pad = rng.random((c, d)) < 0.3
    alpha[pad] = 0
    ids = rng.integers(0, n_src, (c, d)).astype(np.int32)
    ids[pad] = 0
    tab = (0.3 * rng.normal(size=(n_src, k))).astype(np.float32)
    jfull = tab.T @ tab + np.eye(k, dtype=np.float32)

    def t(a):
        return torch.tensor(a, device=dev)

    return dict(tab=t(tab)[:, :kb], ids=t(ids), alpha=t(alpha),
                e=t(rng.normal(size=(c, d)).astype(np.float32)),
                w=t((0.3 * rng.normal(size=(c, k))).astype(np.float32))[:, :kb],
                r1=t(rng.normal(size=(c, kb)).astype(np.float32)),
                j=t(jfull)[:kb, :kb])


@pytest.mark.gpu
@pytest.mark.parametrize("rows,k,weighted", [(1000, 12, False), (1000, 12, True),
                                             (4097, 130, True), (0, 8, False)])
def test_gram_kernel_matches_plain_on_cuda(cuda, rows, k, weighted):
    """Small-integer inputs: every partial sum is an exact integer in fp32,
    so the kernel must equal the plain version bit for bit."""
    from repro_torch.kernels.gram import ops as gram_ops
    from repro_torch.kernels.gram.ref import gram_ref

    x = _ints((rows, k), 50, cuda)
    w = _ints((rows,), 51, cuda).abs() if weighted else None
    before = gram_ops.gram.launches
    got = gram_ops.gram(x, weights=w)
    want = gram_ref(x, w)
    torch.cuda.synchronize()
    assert gram_ops.gram.launches == before + 1
    assert torch.equal(got, want)
    # a column slice of a wider matrix is read in place
    wide = _ints((rows, k + 5), 52, cuda)
    assert torch.equal(gram_ops.gram(wide[:, 2:2 + k]), gram_ref(wide[:, 2:2 + k]))


@pytest.mark.gpu
@pytest.mark.parametrize("c,d,kb,k,eta", [(1001, 40, 8, 12, 1.0), (13, 200, 1, 5, 0.5),
                                          (9, 33, 3, 3, 1.3), (300, 128, 4, 12, 0.8)])
def test_sweep_kernels_match_plain_on_cuda(cuda, c, d, kb, k, eta):
    """Both routings against the plain version, with the reference's
    kernel-vs-oracle tolerance (rtol 2e-5, atol 2e-6): the kernel sums
    the D_pad slots in another order. e is updated in place."""
    from repro_torch.kernels.cd_sweep import ops as cs, ref as cr

    x = _sweep_operands(cuda, c, d, kb, 50, k, c + d)
    kw = dict(alpha0=0.7, l2=0.05, eta=eta)
    rw, re = cr.cd_block_sweep_gather_ref(x["tab"], x["ids"], x["alpha"], x["e"],
                                          x["w"], x["r1"], x["j"], **kw)
    psi = cr.gather_psi_blk(x["tab"], x["ids"]).contiguous()
    for name in ("cd_block_sweep_gather", "cd_block_sweep"):
        fn = getattr(cs, name)
        before = fn.launches
        e = x["e"].clone()
        first = (x["tab"], x["ids"]) if name.endswith("gather") else (psi,)
        w, e2 = fn(*first, x["alpha"], e, x["w"], x["r1"], x["j"], **kw)
        torch.cuda.synchronize()
        assert e2 is e and fn.launches == before + 1
        torch.testing.assert_close(w, rw, rtol=2e-5, atol=2e-6)
        torch.testing.assert_close(e, re, rtol=2e-5, atol=2e-6)


@pytest.mark.gpu
def test_sweep_kernel_clamps_empty_rows_and_clips_ids(cuda):
    from repro_torch.kernels.cd_sweep import ops as cs, ref as cr

    x = _sweep_operands(cuda, 40, 128, 8, 30, 8, 7)
    x["alpha"][:10] = 0
    x["ids"][10:, :4] = torch.tensor([-7, 30, 1000, 29], dtype=torch.int32,
                                     device=cuda)
    kw = dict(alpha0=0.0, l2=0.0)
    e = x["e"].clone()
    w, _ = cs.cd_block_sweep_gather(x["tab"], x["ids"], x["alpha"], e, x["w"],
                                    x["r1"], x["j"], **kw)
    rw, re = cr.cd_block_sweep_gather_ref(x["tab"], x["ids"], x["alpha"], x["e"],
                                          x["w"], x["r1"], x["j"], **kw)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(w).all()) and torch.equal(w[:10], x["w"][:10])
    torch.testing.assert_close(w, rw, rtol=2e-5, atol=2e-6)
    torch.testing.assert_close(e, re, rtol=2e-5, atol=2e-6)


@pytest.mark.gpu
def test_column_update_is_one_kb1_sweep_launch(cuda):
    from repro_torch.kernels.cd_sweep import ops as cs
    from repro_torch.kernels.cd_update import ops as cu
    from repro_torch.kernels.cd_update.ref import cd_column_update_ref

    x = _sweep_operands(cuda, 300, 128, 1, 40, 1, 8)
    psi = x["tab"][:, 0][x["ids"].long()].contiguous()
    args = (psi, x["alpha"], x["e"], x["w"][:, 0], x["r1"][:, 0], x["j"][0, 0])
    rw, re = cd_column_update_ref(*args, alpha0=1.0, l2=0.1)
    before = cs.cd_block_sweep.launches
    w, e = cu.cd_column_update(psi, x["alpha"], x["e"].clone(), *args[3:],
                               alpha0=1.0, l2=0.1)
    torch.cuda.synchronize()
    assert cs.cd_block_sweep.launches == before + 1
    torch.testing.assert_close(w, rw, rtol=2e-5, atol=2e-6)
    torch.testing.assert_close(e, re, rtol=2e-5, atol=2e-6)


def _slab_operands(dev, c, d, m, n_src, seed, *, strided=False, past=False):
    """Slab-reduce and residual-patch operands: a quarter of the slots is
    padding (id 0, α = 0); ``strided`` makes the ψ and Δφ slabs column
    slices of wider tables, ``past`` puts ids past both ends of the slab."""
    rng = np.random.default_rng(seed)
    alpha = (rng.random((c, d)) * 4 + 0.5).astype(np.float32)
    ids = rng.integers(0, n_src, (c, d)).astype(np.int32)
    pad = rng.random((c, d)) < 0.25
    alpha[pad], ids[pad] = 0, 0
    if past:
        ids[:, :4] = [-7, n_src, 1000 * n_src, -1]
    extra = 3 if strided else 0
    tab = (0.3 * rng.normal(size=(n_src, m + extra))).astype(np.float32)
    dphi = rng.normal(size=(c, m + extra)).astype(np.float32)

    def t(a):
        return torch.tensor(a, device=dev)

    return dict(tab=t(tab)[:, extra:], ids=t(ids), alpha=t(alpha),
                e=t(rng.normal(size=(c, d)).astype(np.float32)),
                dphi=t(dphi)[:, extra:])


def _row_tol(terms, long_rows):
    """Per-row absolute tolerance of a sum over D_pad slots (terms (C, ...,
    D)): the kernel-vs-oracle atol 2e-6, plus, for rows of a thousand slots
    and more, whose sums the kernel and the plain version take in other
    orders (fp32 error grows as u·Σ|terms|), 1e-5 of the row's Σ|terms|."""
    tol = torch.full(terms.shape[:-1], 2e-6, device=terms.device)
    return tol + 1e-5 * terms.abs().sum(-1) if long_rows else tol


@pytest.mark.gpu
@pytest.mark.parametrize("c,d,m,n_src,strided,past", [
    (2_000, 128, 8, 680, False, False),    # the context side, scaled down
    (680, 1_024, 8, 2_000, True, False),   # the item side, a strided slab
    (301, 128, 9, 500, False, True),       # FM's m = k_b + 1, ids past the slab
    (37, 200, 17, 90, True, True),         # m = 17: P in three column tiles
    (5, 20_000, 8, 3_000, False, False),   # a long row
    (3, 20_000, 17, 3_000, True, True),
])
def test_slab_and_patch_kernels_match_plain_on_cuda(cuda, c, d, m, n_src,
                                                    strided, past):
    """Kernels 6–9 against their plain versions: Q and P to rtol 2e-5 /
    atol 2e-6 (a row-scaled atol for rows of 1,024 slots and more), P
    symmetric bit for bit, e patched in place, each launch counted."""
    from repro_torch.kernels.cd_sweep import ops as cs, ref as cr

    x = _slab_operands(cuda, c, d, m, n_src, c + d + m, strided=strided,
                       past=past)
    psi = cr.gather_psi_blk(x["tab"], x["ids"]).contiguous()
    long_rows = d >= 1_024
    a = x["alpha"][:, None, :]
    q_tol = _row_tol(a * x["e"][:, None, :] * psi, long_rows)
    p_tol = _row_tol(a[:, :, None, :] * psi[:, :, None, :] * psi[:, None, :, :],
                     long_rows)
    rq, rp = cr.cd_slab_reduce_ref(psi, x["alpha"], x["e"])
    for name, first in (("cd_slab_reduce_gather", (x["tab"], x["ids"])),
                        ("cd_slab_reduce", (psi,))):
        fn = getattr(cs, name)
        before = fn.launches
        q, p = fn(*first, x["alpha"], x["e"])
        torch.cuda.synchronize()
        assert fn.launches == before + 1, name
        assert torch.equal(p, p.transpose(1, 2))
        assert bool(((q - rq).abs() <= 2e-5 * rq.abs() + q_tol).all()), name
        assert bool(((p - rp).abs() <= 2e-5 * rp.abs() + p_tol).all()), name
    re = cr.cd_resid_patch_ref(psi, x["e"], x["dphi"])
    for name, first in (("cd_resid_patch_gather", (x["tab"], x["ids"])),
                        ("cd_resid_patch", (psi,))):
        fn = getattr(cs, name)
        before = fn.launches
        e = x["e"].clone()
        assert fn(*first, e, x["dphi"]) is e
        torch.cuda.synchronize()
        assert fn.launches == before + 1, name
        torch.testing.assert_close(e, re, rtol=2e-5, atol=2e-6)


@pytest.mark.gpu
def test_slab_and_patch_kernels_refuse_what_they_do_not_take(cuda):
    from repro_torch.kernels.cd_sweep import ops as cs

    x = _slab_operands(cuda, 8, 64, 3, 20, 1)
    one_row = torch.zeros((3, 8), device=cuda).T[:1]   # (1, 3), strides (1, 8)
    with pytest.raises(ValueError, match="columns must be contiguous"):
        cs.cd_slab_reduce_gather(one_row, x["ids"][:, :], x["alpha"], x["e"])
    with pytest.raises(ValueError, match="contiguous"):
        cs.cd_slab_reduce_gather(x["tab"], x["ids"], x["alpha"].T.contiguous().T,
                                 x["e"])
    with pytest.raises(ValueError, match="int32"):
        cs.cd_resid_patch_gather(x["tab"], x["ids"].long(), x["e"], x["dphi"])
    with pytest.raises(ValueError, match="dphi_blk"):
        cs.cd_resid_patch_gather(x["tab"], x["ids"], x["e"], x["dphi"][:4])
    with pytest.raises(ValueError, match="psi_blk"):
        cs.cd_slab_reduce(torch.zeros((8, 3, 63), device=cuda), x["alpha"],
                          x["e"])
    # an empty grid launches nothing
    before = cs.cd_slab_reduce_gather.launches
    q, p = cs.cd_slab_reduce_gather(x["tab"], x["ids"][:0], x["alpha"][:0],
                                    x["e"][:0])
    assert q.shape == (0, 3) and p.shape == (0, 3, 3)
    assert cs.cd_slab_reduce_gather.launches == before


def _mfsi_problem(dev, seed=7, n_ctx=60, n_items=40, nnz=500):
    from repro_torch.core import design
    from repro_torch.sparse.interactions import build_interactions

    rng = np.random.default_rng(seed)
    w = np.full((n_ctx, 3), 1 / 3, np.float32)
    w[::4, 2] = 0
    x = design.make_design([
        dict(name="user", ids=np.arange(n_ctx), vocab=n_ctx),
        dict(name="country", ids=rng.integers(0, 5, n_ctx), vocab=5),
        dict(name="hist", vocab=n_items, weights=w, ids=np.stack(
            [rng.choice(n_items, 3, replace=False) for _ in range(n_ctx)]))],
        n_ctx, device=dev)
    z = design.make_design([
        dict(name="item", ids=np.arange(n_items), vocab=n_items),
        dict(name="genre", ids=rng.integers(0, 4, n_items), vocab=4)],
        n_items, device=dev)
    cells = rng.choice(n_ctx * n_items, size=nnz, replace=False)
    y = rng.integers(1, 4, nnz).astype(np.float64)
    alpha = 1.3 + rng.random(nnz)
    data = build_interactions(cells // n_items, cells % n_items, y, alpha,
                              n_ctx, n_items, alpha0=0.3, device=dev)
    return x, z, data


@pytest.mark.gpu
@pytest.mark.parametrize("hpkw", [dict(block_k=0), dict(block_k=8, psi_dispatch="pregather"),
                                  dict(block_k=5, multi_hot_mode="slot"),
                                  dict(block_k=1)])
def test_mfsi_epoch_padded_on_cuda_matches_cpu(cuda, hpkw):
    """k = 12 (block_k 8 leaves a 4-column tail): two fused MFSI epochs on
    the card against the same epochs through the plain versions on the
    CPU, to the reference's fused-vs-flat tolerance (rtol 5e-4, atol
    1e-5; e atol 5e-5)."""
    from repro_torch.core.models import mfsi
    from repro_torch.kernels.cd_sweep import ops as cs

    rng = np.random.default_rng(8)
    hp = mfsi.MFSIHyperParams(k=12, alpha0=0.3, l2=0.05, **hpkw)
    counters = (cs.cd_slab_reduce, cs.cd_slab_reduce_gather, cs.cd_resid_patch,
                cs.cd_resid_patch_gather)
    out = {}
    for where in ("cpu", cuda):
        x, z, data = _mfsi_problem(where)
        if not out:
            w0 = (0.1 * rng.normal(size=(x.p, 12))).astype(np.float32)
            h0 = (0.1 * rng.normal(size=(z.p, 12))).astype(np.float32)
        pdata = mfsi.pad_interactions(data)
        p = mfsi.params_from_numpy(w0, h0, device=where)
        e = mfsi.residuals_padded(p, x, z, data, pdata)
        before = [c.launches for c in counters]
        for _ in range(2):
            p, e = mfsi.epoch_padded(p, x, z, pdata, e, hp)
        launched = [c.launches - b for c, b in zip(counters, before)]
        if where == "cpu":
            assert launched == [0, 0, 0, 0]
        else:
            n = 2 * 2 * -(-12 // (8 if hp.block_k == 0 else hp.block_k))
            gather = hp.psi_dispatch == "gather"
            assert launched == ([0, n, 0, n] if gather else [n, 0, n, 0])
        out[str(where)] = [t.cpu() for t in (*p, e)]
    for i, (a, b) in enumerate(zip(out[str(cuda)], out["cpu"])):
        torch.testing.assert_close(a, b, rtol=5e-4, atol=5e-5 if i == 2 else 1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("k,rows,excl", [(257, 3_000, 0), (1_000, 34_000, 40),
                                         (2_048, 9_000, 0), (2_048, 1_500, 8)])
def test_large_k_matches_plain_on_cuda(cuda, k, rows, excl):
    """K above 256 takes the kernel's large-K merge. Small-integer scores
    are exact in any summation order and tie often: the kernel must equal
    the plain version bit for bit, ties in ascending id, and K > n_valid
    fills (−inf, −1)."""
    phi, psi = _ints((19, 16), k, cuda), _ints((rows, 16), k + 1, cuda)
    eids = None
    if excl:
        rng = np.random.default_rng(k)
        eids = torch.tensor(rng.integers(95, 100 + rows, (19, excl)).astype(np.int32),
                            device=cuda)
    args = dict(exclude_ids=eids, id_offset=100, n_valid=rows - 7)
    before = ops.topk_score.launches
    s, i = ops.topk_score(phi, psi, k, **args)
    rs, ri = ref.topk_score_ref(phi, psi, k, **args)
    torch.cuda.synchronize()
    assert ops.topk_score.launches == before + 1
    assert torch.equal(i, ri) and torch.equal(s, rs)
    if k > rows - 7:
        assert bool((i[:, rows - 7:] == -1).all())
        assert bool(torch.isneginf(s[:, rows - 7:]).all())


def test_sweep_launch_form_follows_the_row_length():
    """Warp-row while one row fits a block's shared memory (the user side
    of the tensor models at D_pad 128, MF's item side at 1,024), block-row
    beyond (CtxMF's hour-of-day buckets at 142,464); only a k_b whose
    block alone overflows a block fits neither. The cost model carries
    the form and its own traffic."""
    from repro_torch.kernels import vmem
    from repro_torch.obs.costs import cd_sweep_cost

    for d, want in ((128, vmem.WARP_ROW), (1_024, vmem.WARP_ROW),
                    (142_464, vmem.BLOCK_ROW)):
        for gather in (True, False):
            for rowpatch in (True, False):
                assert vmem.cd_sweep_form(d, 8, gather=gather,
                                          rowpatch=rowpatch) == want
    # the row patch costs k_b² floats a row in place of the shared block
    assert vmem.cd_sweep_smem_bytes(128, 8, 4, gather=True, rowpatch=True) \
        == vmem.cd_sweep_smem_bytes(128, 8, 4, gather=True) - 4 * 64 + 4 * 4 * 64
    assert vmem.cd_sweep_gather_block_ctx(128, 8, n_rows=200_000,
                                          rowpatch=True) >= 1
    # MF's sweeps keep refusing rows that cannot stay resident
    with pytest.raises(vmem.VmemBudgetError):
        vmem.resolve_cd_sweep_dispatch(142_464, 8)
    with pytest.raises(vmem.VmemBudgetError):
        vmem.cd_sweep_form(142_464, 240, gather=True)
    with pytest.raises(vmem.VmemBudgetError):
        vmem.cd_sweep_gather_block_ctx(142_464, 8, rowpatch=True)
    nnz = 3_399_385
    user = cd_sweep_cost(200_000, 128, 8, 8, n_src=nnz + 1, rowpatch=True)
    assert user["form"] == vmem.WARP_ROW
    assert user["hbm_bytes"] == user["form_bytes"] == (
        200_000 * 128 * 16 + 200_000 * 8 * 12 + 200_000 * 64 * 4
        + (nnz + 1) * 8 * 4)
    bucket = cd_sweep_cost(24, 142_464, 8, 8, n_src=nnz + 1, rowpatch=True)
    assert bucket["form"] == vmem.BLOCK_ROW
    assert bucket["hbm_bytes"] == (24 * 142_464 * 16 + 24 * 8 * 12
                                   + 24 * 64 * 4 + (nnz + 1) * 8 * 4)
    assert bucket["form_bytes"] == 32 * 24 * 142_464 * 8 + 24 * 8 * 12 + 24 * 64 * 4
    assert bucket["smem_bytes"] == vmem.cd_sweep_block_row_smem_bytes(8)


def _rowpatch_operands(dev, c, d, kb, n_src, seed, pad_frac=0.3):
    """Row-patch operands: a flat slab whose last row is the zero
    sentinel (padding points at it, α = 0), and per-row patches P = K Kᵀ +
    I, as J ⊙ K is positive semi-definite."""
    rng = np.random.default_rng(seed)
    alpha = (rng.random((c, d)) * 4 + 0.5).astype(np.float32)
    ids = rng.integers(0, n_src - 1, (c, d)).astype(np.int32)
    pad = rng.random((c, d)) < pad_frac
    alpha[pad], ids[pad] = 0, n_src - 1
    tab = (0.3 * rng.normal(size=(n_src, kb))).astype(np.float32)
    tab[-1] = 0
    k = (0.3 * rng.normal(size=(c, kb, kb))).astype(np.float32)
    p = k @ k.transpose(0, 2, 1) + np.eye(kb, dtype=np.float32)

    def t(a):
        return torch.tensor(a, device=dev)

    return dict(tab=t(tab), ids=t(ids), alpha=t(alpha), p=t(p),
                e=t(rng.normal(size=(c, d)).astype(np.float32)),
                w=t((0.3 * rng.normal(size=(c, kb))).astype(np.float32)),
                r1=t(rng.normal(size=(c, kb)).astype(np.float32)))


def _hold_sweep(fn, plain, x, first, cpl, long_rows=False, **kw):
    """One launch against the plain version on the same inputs: the
    reference's kernel-vs-oracle rtol 2e-5 / atol 2e-6; for rows of many
    thousands of slots, whose sums the two take in other orders, an
    absolute tolerance per row of 1e-5 of the row's Σ|α·e·ψ_j|/den_j summed
    over j (in W; times max|ψ| in e)."""
    from repro_torch.kernels.cd_sweep import ref as cr

    before = (fn.launches, fn.launches_block_row)
    e = x["e"].clone()
    w, e2 = fn(*first, x["alpha"], e, x["w"], x["r1"], cpl, **kw)
    rw, re = plain(*first, x["alpha"], x["e"], x["w"], x["r1"], cpl, **kw)
    torch.cuda.synchronize()
    assert e2 is e and fn.launches == before[0] + 1
    assert fn.launches_block_row == before[1] + int(long_rows)
    assert bool(torch.isfinite(w).all()) and bool(torch.isfinite(e).all())
    atol_w = torch.full((w.shape[0], 1), 2e-6, device=w.device)
    atol_e = atol_w
    if long_rows:
        psi = (cr.gather_psi_blk(*first) if len(first) == 2 else first[0])
        a = x["alpha"][:, None, :]
        diag = torch.diagonal(cpl if cpl.dim() == 3 else cpl.expand(
            w.shape[0], *cpl.shape), dim1=1, dim2=2)
        den = (a * psi * psi).sum(-1) + kw["alpha0"] * diag + kw["l2"]
        scale = ((a * x["e"][:, None, :].abs() * psi.abs()).sum(-1)
                 / den.clamp(min=1e-12)).sum(1, keepdim=True)
        atol_w = 2e-6 + 1e-5 * scale
        atol_e = atol_w * psi.abs().amax(1)
    assert bool(((w - rw).abs() <= 2e-5 * rw.abs() + atol_w).all())
    assert bool(((e - re).abs() <= 2e-5 * re.abs() + atol_e).all())
    return w, rw


@pytest.mark.gpu
@pytest.mark.parametrize("c,d,kb,eta", [(1001, 40, 8, 1.0), (300, 128, 4, 0.8),
                                        (13, 200, 1, 0.5), (9, 33, 3, 1.3)])
def test_rowpatch_kernels_match_plain_on_cuda(cuda, c, d, kb, eta):
    """Both row-patch routings in the warp-row form, C off the row tile."""
    from repro_torch.kernels.cd_sweep import ops as cs, ref as cr

    x = _rowpatch_operands(cuda, c, d, kb, 60, c + d)
    kw = dict(alpha0=0.7, l2=0.05, eta=eta)
    psi = cr.gather_psi_blk(x["tab"], x["ids"]).contiguous()
    _hold_sweep(cs.cd_block_sweep_rowpatch_gather,
                cr.cd_block_sweep_rowpatch_gather_ref, x,
                (x["tab"], x["ids"]), x["p"], **kw)
    _hold_sweep(cs.cd_block_sweep_rowpatch, cr.cd_block_sweep_rowpatch_ref,
                x, (psi,), x["p"], **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("rowpatch", [True, False])
@pytest.mark.parametrize("gather", [True, False])
def test_block_row_form_matches_plain_on_cuda(cuda, rowpatch, gather):
    """Rows of 20,000 slots do not fit a block's shared memory: the sweep
    runs one block a row, with the per-row patch and with one shared J."""
    from repro_torch.kernels.cd_sweep import ops as cs, ref as cr

    x = _rowpatch_operands(cuda, 5, 20_000, 8, 3_000, 9)
    cpl = x["p"] if rowpatch else x["p"][0]
    name = ("cd_block_sweep_rowpatch" if rowpatch else "cd_block_sweep") + (
        "_gather" if gather else "")
    first = ((x["tab"], x["ids"]) if gather else
             (cr.gather_psi_blk(x["tab"], x["ids"]).contiguous(),))
    _hold_sweep(getattr(cs, name), getattr(cr, name + "_ref"), x, first, cpl,
                long_rows=True, alpha0=0.7, l2=0.05, eta=0.9)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [128, 20_000])
def test_rowpatch_kernel_clamps_empty_rows_and_clips_ids(cuda, d):
    from repro_torch.kernels.cd_sweep import ops as cs, ref as cr

    x = _rowpatch_operands(cuda, 12, d, 8, 40, 3)
    x["alpha"][:4] = 0
    x["p"][:4] = 0
    x["ids"][4:, :4] = torch.tensor([-7, 40, 1000, 39], dtype=torch.int32,
                                    device=cuda)
    w, _ = _hold_sweep(cs.cd_block_sweep_rowpatch_gather,
                       cr.cd_block_sweep_rowpatch_gather_ref, x,
                       (x["tab"], x["ids"]), x["p"], long_rows=d > 128,
                       alpha0=0.0, l2=0.0)
    assert torch.equal(w[:4], x["w"][:4])


def _tensor_problem(dev, seed=7, n_c1=40, n_c2=6, n_items=30, nnz=600):
    from repro_torch.core.models import parafac
    from repro_torch.sparse.interactions import build_interactions

    rng = np.random.default_rng(seed)
    pairs = rng.choice(n_c1 * n_c2, size=150, replace=False)
    cells = rng.choice(150 * n_items, size=nnz, replace=False)
    y = rng.integers(1, 4, nnz).astype(np.float64)
    alpha = 1.3 + rng.random(nnz)
    tc = parafac.TensorContext(
        c1=torch.as_tensor(pairs // n_c2, device=dev),
        c2=torch.as_tensor(pairs % n_c2, device=dev), n_c1=n_c1, n_c2=n_c2)
    data = build_interactions(cells // n_items, cells % n_items, y, alpha, 150,
                              n_items, alpha0=0.3, device=dev)
    return tc, data


@pytest.mark.gpu
@pytest.mark.parametrize("hpkw", [dict(block_k=0), dict(block_k=8, psi_dispatch="pregather"),
                                  dict(block_k=1, dense_context=True)])
def test_parafac_epoch_padded_on_cuda_matches_cpu(cuda, hpkw):
    """k = 12 (block_k 8 leaves a 4-column tail): two fused epochs on the
    card against the same epochs through the plain versions on the CPU,
    to the reference's fused-vs-flat tolerance (rtol 5e-4, atol 1e-5; e
    atol 5e-5)."""
    from repro_torch.core.models import parafac
    from repro_torch.kernels.cd_sweep import ops as cs

    rng = np.random.default_rng(8)
    f = [(0.3 * rng.normal(size=(n, 12))).astype(np.float32) for n in (40, 6, 30)]
    hp = parafac.PARAFACHyperParams(k=12, alpha0=0.3, l2=0.05, **hpkw)
    counters = (cs.cd_block_sweep_rowpatch, cs.cd_block_sweep_rowpatch_gather)
    out = {}
    for where in ("cpu", cuda):
        tc, data = _tensor_problem(where)
        pad = parafac.pad_tensor_groups(tc, data)
        p = parafac.params_from_numpy(*f, device=where)
        e = parafac.residuals(p, tc, data)
        before = sum(c.launches for c in counters)
        for _ in range(2):
            p, e = parafac.epoch_padded(p, tc, data, pad, e, hp)
        assert (sum(c.launches for c in counters) > before) == (where != "cpu")
        out[str(where)] = [t.cpu() for t in (*p, e)]
    for i, (a, b) in enumerate(zip(out[str(cuda)], out["cpu"])):
        torch.testing.assert_close(a, b, rtol=5e-4, atol=5e-5 if i == 3 else 1e-5)


@pytest.mark.gpu
def test_tucker_epoch_padded_on_cuda_matches_cpu(cuda):
    """Mode ranks (3, 2, 4) at block_k 2: two fused epochs on the card
    against the CPU, to the reference's Tucker tolerance (rtol 1e-3, atol
    1e-4)."""
    from repro_torch.core.models import tucker

    rng = np.random.default_rng(9)
    f = [(0.3 * rng.normal(size=s)).astype(np.float32)
         for s in ((40, 3), (6, 2), (30, 4), (3, 2, 4))]
    hp = tucker.TuckerHyperParams(k1=3, k2=2, k3=4, alpha0=0.3, l2=0.05,
                                  l2_core=0.02, block_k=2)
    out = {}
    for where in ("cpu", cuda):
        tc, data = _tensor_problem(where)
        pad = tucker.pad_tensor_groups(tc, data)
        p = tucker.params_from_numpy(*f, device=where)
        e = tucker.residuals(p, tc, data)
        for _ in range(2):
            p, e = tucker.epoch_padded(p, tc, data, pad, e, hp)
        out[str(where)] = [t.cpu() for t in (*p, e)]
    for a, b in zip(out[str(cuda)], out["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("hpkw", [dict(block_k=8), dict(block_k=8, psi_dispatch="pregather"),
                                  dict(block_k=1), dict(block_k=0, eta=0.8)])
def test_mf_padded_epoch_on_cuda_matches_cpu(cuda, hpkw):
    """k = 12: block_k 8 leaves a 4-column tail. Two fused epochs on the
    card against the same epochs through the plain versions on the CPU,
    to the reference's fused-vs-flat tolerance (rtol 3e-4, atol 3e-5)."""
    from repro_torch.core.models import mf, mf_padded
    from repro_torch.kernels.cd_sweep import ops as cs
    from repro_torch.sparse.interactions import build_interactions

    rng = np.random.default_rng(7)
    n_ctx, n_items, nnz, k = 300, 150, 3000, 12
    cells = rng.choice((n_ctx - 5) * n_items, size=nnz, replace=False)
    y = rng.integers(1, 5, nnz).astype(np.float64)
    alpha = 1.4 + rng.random(nnz)
    w0 = (0.1 * rng.normal(size=(n_ctx, k))).astype(np.float32)
    h0 = (0.1 * rng.normal(size=(n_items, k))).astype(np.float32)
    hp = mf.MFHyperParams(k=k, alpha0=0.4, l2=0.05, **hpkw)
    out = {}
    for where in ("cpu", cuda):
        data = build_interactions(cells // n_items, cells % n_items, y, alpha,
                                  n_ctx, n_items, alpha0=0.4, device=where)
        pdata = mf_padded.pad_interactions(data)
        p = mf.params_from_numpy(w0, h0, device=where)
        e = mf_padded.residuals(p, pdata)
        before = cs.cd_block_sweep.launches + cs.cd_block_sweep_gather.launches
        for _ in range(2):
            p, e = mf_padded.epoch(p, pdata, e, hp)
        launched = cs.cd_block_sweep.launches + cs.cd_block_sweep_gather.launches
        assert (launched > before) == (where != "cpu")
        out[str(where)] = [t.cpu() for t in (p.w, p.h, e)]
    for a, b in zip(out[str(cuda)], out["cpu"]):
        torch.testing.assert_close(a, b, rtol=3e-4, atol=3e-5)


@pytest.mark.gpu
def test_quickstart_twin_on_cuda(cuda):
    from repro_torch.examples import quickstart

    out = quickstart.main([])
    assert out["recall"] > out["recall_pop"]
    assert out["params"].w.device.type == "cuda"
