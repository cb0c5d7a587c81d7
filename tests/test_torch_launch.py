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
    with pytest.raises(SystemExit, match="unknown serving arch"):
        serve.main(["--arch", "gpt-2", "--device", "cpu"])
    with pytest.raises(KeyError):
        get_smoke_config("gpt-2")
    cfg = get_config("icd-mf")
    assert (cfg.n_ctx, cfg.n_items, cfg.k) == (200_000, 68_000, 128)
    cfg = get_config("icd-fm")
    assert (cfg.n_ctx, cfg.n_items, cfg.k, cfg.p_ctx) == (200_000, 68_000, 128,
                                                          336_091)


def test_numpy_data_goes_to_cuda_unless_cpu_is_named():
    from repro_torch.core import foldin, naive_cd
    from repro_torch.core.models import mf, zoo
    from repro_torch.serve.cluster import shard_psi
    from repro_torch.serve.mesh import FaultTolerantRetrievalMesh

    w, h = np.ones((3, 4), np.float32), np.ones((6, 4), np.float32)
    fold_kw = dict(alpha0=0.5, l2=0.1)
    dense = ([0, 1], [1, 0], np.ones(2, np.float32), np.ones(2, np.float32),
             2, 2, 0.5)
    host_data = {
        "fold_in_row": lambda **kw: foldin.fold_in_row(h, [1, 2], **fold_kw,
                                                       **kw).row,
        "fold_in_exact": lambda **kw: foldin.fold_in_exact(h, [1, 2], **fold_kw,
                                                           **kw),
        "dense_from_observed": lambda **kw: naive_cd.dense_from_observed(
            *dense, **kw)[0],
        "rand_f32": lambda **kw: zoo.rand_f32((3,), **kw),
    }
    assert mf.params_from_numpy(w, h, device="cpu").h.device.type == "cpu"
    assert shard_psi(torch.as_tensor(h), 2).shards[0].device.type == "cpu"
    for name, fn in host_data.items():
        assert fn(device="cpu").device.type == "cpu", name
    # a tensor keeps its own device
    th = torch.as_tensor(h)
    assert foldin.fold_in_row(th, [1], **fold_kw).row.device.type == "cpu"
    assert foldin.fold_in_exact(th, [1], **fold_kw).device.type == "cpu"
    assert naive_cd.dense_from_observed(
        [0], [1], torch.ones(1), [1.0], 2, 2, 0.5)[0].device.type == "cpu"
    if torch.cuda.is_available():
        assert mf.params_from_numpy(w, h).h.device.type == "cuda"
        assert shard_psi(h, 2).shards[0].device.type == "cuda"
        for name, fn in host_data.items():
            assert fn().device.type == "cuda", name
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mf.params_from_numpy(w, h)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        shard_psi(h, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FaultTolerantRetrievalMesh(n_shards=2, n_replicas=1, k=2).publish(h)
    for name, fn in host_data.items():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()


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
    # the launch tooling among them
    assert {ROOT / "src" / "repro_torch" / "launch" / f
            for f in ("cells.py", "dryrun.py", "hlo_analysis.py")} <= set(files)
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
    """Every form the reference takes now launches; what the kernel
    refuses is malformed input, with a ValueError naming it."""
    phi, psi = torch.zeros(2, 8, device=cuda), torch.zeros(16, 8, device=cuda)
    mask = torch.zeros(2, 16, dtype=torch.bool, device=cuda)
    s, i = ops.topk_score(phi, psi.bfloat16(), 4, mask)
    torch.cuda.synchronize()
    assert (i == torch.arange(4, device=cuda)).all() and (s == 0).all()
    with pytest.raises(ValueError, match="int32"):
        ops.topk_score(phi, psi, 4, exclude_ids=torch.zeros(
            2, 3, dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError, match="psi_scale"):
        ops.topk_score(phi, psi.to(torch.int8), 4)
    with pytest.raises(ValueError, match="psi_scale has 3 rows"):
        ops.topk_score(phi, psi.to(torch.int8), 4,
                       psi_scale=torch.ones(3, device=cuda))
    with pytest.raises(ValueError, match="not both"):
        ops.topk_score(phi, psi, 4, mask, exclude_ids=torch.zeros(
            2, 3, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="columns must be contiguous"):
        ops.topk_score(phi, psi, 4, torch.zeros(16, 2, dtype=torch.bool,
                                                device=cuda).T)
    with pytest.raises(ValueError, match="float32, bfloat16 or int8"):
        ops.topk_score(phi, psi.double(), 4)


def _small_int_forms(dev, b, rows, d, seed):
    """φ and ψ in small integers and ψ's three stored forms: fp32, bf16
    (integers up to 256 are exact in bf16) and int8 with scale 1, and
    int8 with power-of-two scales (exact products). Every score is an
    exact integer, so the kernel must equal the plain version bit for bit
    whatever the summation order."""
    rng = np.random.default_rng(seed)
    phi = torch.tensor(rng.integers(-3, 4, (b, d)), dtype=torch.float32, device=dev)
    q = rng.integers(-3, 4, (rows, d))
    big = torch.tensor(rng.integers(-256, 257, (rows, d)), dtype=torch.float32,
                       device=dev)
    q8 = torch.tensor(q, dtype=torch.int8, device=dev)
    pow2 = torch.tensor(2.0 ** rng.integers(-2, 3, rows), dtype=torch.float32,
                        device=dev)
    return phi, {
        "fp32": (q8.float(), None), "bf16": (big.bfloat16(), None),
        "int8": (q8, torch.ones(rows, device=dev)), "int8_pow2": (q8, pow2)}


@pytest.mark.gpu
@pytest.mark.parametrize("b,rows,d,k", [(16, 2_000, 128, 100), (19, 1_001, 16, 37),
                                        (5, 300, 6, 257), (3, 700, 5, 1)])
def test_quantized_psi_forms_exact_on_cuda(cuda, b, rows, d, k):
    """bf16 and int8 ψ (D·itemsize multiples of 16 take the 16-byte loads,
    D = 6 and 5 the scalar ones), with ties across chunks and exclusions,
    equal the plain version bit for bit, and each form counts its
    launches."""
    phi, forms = _small_int_forms(cuda, b, rows, d, b + rows)
    eids = torch.tensor(np.random.default_rng(rows).integers(
        4_990, 5_000 + rows, (b, 6)), dtype=torch.int32, device=cuda)
    for name, (psi, scale) in forms.items():
        before = {f: getattr(ops.topk_score, f) for f in
                  ("launches", "launches_bf16", "launches_int8", "launches_mask")}
        args = dict(exclude_ids=eids, psi_scale=scale, id_offset=5_000,
                    n_valid=rows - 7)
        s, i = ops.topk_score(phi, psi, k, **args)
        rs, ri = ref.topk_score_ref(phi, psi, k, **args)
        torch.cuda.synchronize()
        assert torch.equal(i, ri) and torch.equal(s, rs), name
        after = {f: getattr(ops.topk_score, f) - v for f, v in before.items()}
        assert after == {"launches": 1, "launches_mask": 0,
                         "launches_bf16": int(name == "bf16"),
                         "launches_int8": int(name.startswith("int8"))}, name


@pytest.mark.gpu
def test_dense_mask_forms_on_cuda(cuda):
    """The dense mask in bool, int8 and uint8, whole and as a middle
    shard's column slice of a wider mask (rows read at their own stride),
    with fully masked rows: equal to the plain version bit for bit."""
    from repro_torch.serve.cluster import _shard_exclude_mask

    b, n_items, d, rows_per = 9, 3_000, 16, 1_000
    phi, forms = _small_int_forms(cuda, b, n_items, d, 60)
    psi = forms["fp32"][0]
    rng = np.random.default_rng(61)
    wide = torch.tensor(rng.random((b, n_items)) < 0.2, device=cuda)
    wide[3] = True                                  # a fully masked row
    for dtype in (torch.bool, torch.int8, torch.uint8):
        m = wide.to(dtype)
        before = ops.topk_score.launches_mask
        s, i = ops.topk_score(phi, psi, 50, m)
        rs, ri = ref.topk_score_ref(phi, psi, 50, m)
        torch.cuda.synchronize()
        assert torch.equal(i, ri) and torch.equal(s, rs)
        assert ops.topk_score.launches_mask == before + 1
        assert (i[3] == -1).all() and torch.isneginf(s[3]).all()
    lo = rows_per                                   # the middle shard
    view = _shard_exclude_mask(wide, lo, rows_per)
    assert not view.is_contiguous() and view.stride() == (n_items, 1)
    shard = psi[lo:lo + rows_per].contiguous()
    args = dict(id_offset=lo, n_valid=rows_per - 3)
    s, i = ops.topk_score(phi, shard, 40, view, **args)
    rs, ri = ref.topk_score_ref(phi, shard, 40, view.contiguous(), **args)
    torch.cuda.synchronize()
    assert torch.equal(i, ri) and torch.equal(s, rs)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [8_193, 20_000])
def test_topk_above_8192_exact_on_cuda(cuda, k):
    """K past 8,192 (k_pad 16,384 and 32,768) through the device-memory
    merge: exact in small integers over 40,000 rows, ties in ascending id,
    K past n_valid padded with (−inf, −1)."""
    rng = np.random.default_rng(k)
    phi = torch.tensor(rng.integers(-3, 4, (5, 8)), dtype=torch.float32, device=cuda)
    psi = torch.tensor(rng.integers(-3, 4, (40_000, 8)), dtype=torch.float32,
                       device=cuda)
    for n_valid in (40_000, min(k - 100, 40_000)):
        s, i = ops.topk_score(phi, psi, k, n_valid=n_valid, id_offset=7)
        rs, ri = ref.topk_score_ref(phi, psi, k, n_valid=n_valid, id_offset=7)
        torch.cuda.synchronize()
        assert torch.equal(i, ri) and torch.equal(s, rs)
        if k > n_valid:
            assert (i[:, n_valid:] == -1).all()


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


# the Gram in random fp32 against the plain version (a cuBLAS product,
# another summation order): rtol 1e-4 and 1e-6 of the largest |J|, as
# chip_smoke.py holds it
GRAM_RTOL, GRAM_ATOL_REL = 1e-4, 1e-6


@pytest.mark.gpu
@pytest.mark.parametrize("rows,k,weighted", [
    (7, 16, False), (130, 130, True), (0, 8, False), (33, 1, True),
    (68_000, 128, False), (200_000, 128, True), (5_000, 257, False)])
def test_gram_kernel_random_repeatable_and_strided_on_cuda(cuda, rows, k,
                                                           weighted):
    """Random fp32 to GRAM_RTOL, two calls bit-equal, small integers exact,
    and a column slice of a wider matrix read in place, both where its
    rows are 16-byte aligned (ldx % 4 == 0: the 16-byte copies) and where
    they are not (the 4-byte copies)."""
    from repro_torch.kernels.gram import ops as gram_ops
    from repro_torch.kernels.gram.ref import gram_ref

    gen = torch.Generator(device=cuda).manual_seed(rows + k)
    x = 0.1 * torch.randn((rows, k), generator=gen, device=cuda)
    w = (torch.rand((rows,), generator=gen, device=cuda) * 4
         if weighted else None)
    got, again = gram_ops.gram(x, weights=w), gram_ops.gram(x, weights=w)
    want = gram_ref(x, w)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    torch.testing.assert_close(got, want, rtol=GRAM_RTOL,
                               atol=GRAM_ATOL_REL * float(want.abs().max())
                               if rows else 0.0)
    assert torch.equal(got, got.T)
    xi = _ints((rows, k + 8), rows, cuda)
    wi = _ints((rows,), rows + 1, cuda).abs() if weighted else None
    for lo in (4, 3):          # aligned rows, then unaligned ones
        view = xi[:, lo:lo + k]
        assert torch.equal(gram_ops.gram(view, weights=wi), gram_ref(view, wi))
    torch.cuda.synchronize()


def _ivf_case(dev, *, b, c, block_rows, d, seed, empty=(1,)):
    """An IVF index's arrays in small integers: C blocks of block_rows
    rows with random counts (the clusters in ``empty`` hold none), global
    ids a random permutation laid out ascending within each block, and ψ
    in its three stored forms with scores that are exact integers (int8
    with scale 1). Equal rows repeat across and inside blocks."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, block_rows + 1, size=c)
    counts[list(empty)] = 0
    counts[0] = block_rows
    n = int(counts.sum())
    gids = rng.permutation(n) + 1_000
    ids_global = np.full(c * block_rows, -1, np.int32)
    base = rng.integers(-3, 4, size=(max(8, n // 4), d))
    table = np.zeros((c * block_rows, d), np.float32)
    at = 0
    for cl in range(c):
        pos = cl * block_rows + np.arange(counts[cl])
        ids_global[pos] = np.sort(gids[at:at + counts[cl]])
        table[pos] = base[rng.integers(0, len(base), size=counts[cl])]
        at += counts[cl]
    psi = torch.tensor(table, device=dev)
    phi = torch.tensor(rng.integers(-3, 4, (b, d)), dtype=torch.float32,
                       device=dev)
    forms = {"fp32": (psi, None), "bf16": (psi.bfloat16(), None),
             "int8": (psi.to(torch.int8), torch.ones(len(psi), device=dev))}
    arrays = dict(counts=torch.tensor(counts, dtype=torch.int32, device=dev),
                  ids_global=torch.tensor(ids_global, device=dev),
                  block_rows=block_rows)
    excl = rng.choice(gids, size=(b, 9)).astype(np.int32)
    excl[:, -2:] = -1
    return phi, forms, arrays, torch.tensor(excl, device=dev), gids


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 100, 257, 1_000])
def test_ivf_form_exact_on_cuda(cuda, k):
    """The IVF form against its plain version bit for bit: the three
    storage forms, ties inside and across blocks, an empty cluster, blocks
    of several chunks, random, all-false and all-true probe masks, with and
    without exclusions; one launch a call."""
    b, c = 19, 7
    phi, forms, arrays, excl, _ = _ivf_case(cuda, b=b, c=c, block_rows=600,
                                            d=16, seed=k)
    rng = np.random.default_rng(k + 1)
    masks = {"random": torch.tensor(rng.random((b, c)) < 0.4, device=cuda),
             "none": torch.zeros((b, c), dtype=torch.bool, device=cuda),
             "all": torch.ones((b, c), dtype=torch.uint8, device=cuda)}
    for name, (psi, scale) in forms.items():
        for mname, mask in masks.items():
            for ex in (None, excl):
                before = {f: getattr(ops.topk_score, f) for f in
                          ("launches", "launches_ivf", "launches_mask")}
                args = dict(probe_mask=mask, psi_scale=scale, exclude_ids=ex,
                            **arrays)
                s, i = ops.topk_score_ivf(phi, psi, k, **args)
                rs, ri = ref.topk_score_ivf_ref(phi, psi, k, **args)
                torch.cuda.synchronize()
                assert torch.equal(i, ri) and torch.equal(s, rs), (name, mname)
                after = {f: getattr(ops.topk_score, f) - v
                         for f, v in before.items()}
                assert after == {"launches": 1, "launches_ivf": 1,
                                 "launches_mask": 0}
                if mname == "none":
                    assert (i == -1).all()


@pytest.mark.gpu
def test_ivf_index_one_launch_per_shard_and_call_on_cuda(cuda):
    """``PsiIndex.topk`` on the card equals the same index on the CPU (the
    plain version), and the sharded IVF top-K launches the IVF form once a
    shard and call, with no other launch of the top-K kernel."""
    from repro_torch.serve import ann
    from repro_torch.serve.cluster import shard_psi

    rng = np.random.default_rng(70)
    psi = rng.integers(-3, 4, size=(900, 16)).astype(np.float32)
    phi = rng.integers(-3, 4, size=(16, 16)).astype(np.float32)
    excl = torch.tensor(rng.integers(0, 900, size=(16, 12)), dtype=torch.int32)
    for q in ("none", "bf16", "int8"):
        cfg = ann.AnnConfig(n_clusters=9, n_probe=3, quant=q, seed=71)
        idx_cpu = ann.PsiIndex.build(torch.from_numpy(psi), cfg)
        assign = idx_cpu.inv_pos.numpy() // idx_cpu.block_rows
        gpu = ann.index_from_numpy(psi, idx_cpu.centroids.numpy(), assign,
                                   cfg, device=cuda)
        for n_probe in (3, 9):
            s, i = gpu.topk(torch.from_numpy(phi).to(cuda), 100,
                            n_probe=n_probe, exclude_ids=excl.to(cuda))
            rs, ri = idx_cpu.topk(torch.from_numpy(phi), 100, n_probe=n_probe,
                                  exclude_ids=excl)
            torch.cuda.synchronize()
            assert torch.equal(i.cpu(), ri), (q, n_probe)
            torch.testing.assert_close(s.cpu(), rs, rtol=1e-5, atol=1e-5)
    table = shard_psi(torch.from_numpy(psi).to(cuda), 2)
    cfg = ann.AnnConfig(n_clusters=6, n_probe=2, seed=72)
    indexes = ann.build_shard_indexes(table, cfg)
    before = (ops.topk_score.launches, ops.topk_score.launches_ivf)
    for _ in range(3):
        ann.ivf_cluster_topk(table, indexes, torch.from_numpy(phi).to(cuda),
                             50, exclude_ids=excl.to(cuda))
    torch.cuda.synchronize()
    assert (ops.topk_score.launches - before[0],
            ops.topk_score.launches_ivf - before[1]) == (6, 6)


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
    """The pre-gathered shared-J sweep: warp-row while one row fits a
    block's shared memory (the user side of the tensor models at D_pad
    128, MF's item side at 1,024), block-row beyond (CtxMF's hour-of-day
    buckets at 142,464); only a k_b whose block alone overflows a block
    fits neither. The gather sweep, with either coupling, and the
    pre-gathered row-patch sweep take the register-row form where their
    rows fit registers (D_pad 128 and 1,024 here) and the split-row form
    where the pre-gathered shared-J sweep takes the block-row form. The
    cost model carries the form and its own traffic."""
    from repro_torch.kernels import vmem
    from repro_torch.obs.costs import cd_sweep_cost

    for d, want, want_new in ((128, vmem.WARP_ROW, vmem.REG_ROW),
                              (1_024, vmem.WARP_ROW, vmem.REG_ROW),
                              (142_464, vmem.BLOCK_ROW, vmem.SPLIT_ROW)):
        for gather in (True, False):
            for rowpatch in (True, False):
                assert vmem.cd_sweep_form(d, 8, gather=gather,
                                          rowpatch=rowpatch) == (
                    want_new if gather or rowpatch else want)
    # the row patch costs k_b² floats a row in place of the shared block
    assert vmem.cd_sweep_smem_bytes(128, 8, 4, gather=True, rowpatch=True) \
        == vmem.cd_sweep_smem_bytes(128, 8, 4, gather=True) - 4 * 64 + 4 * 4 * 64
    assert vmem.cd_sweep_gather_block_ctx(128, 8, n_rows=200_000,
                                          rowpatch=True) >= 1
    # MF's sweeps take the long rows in the same forms, and refuse only a
    # k_b that no form can launch
    assert vmem.resolve_cd_sweep_dispatch(142_464, 8) is True
    assert vmem.resolve_cd_sweep_dispatch(142_464, 8, prefer_gather=False) is False
    with pytest.raises(vmem.VmemBudgetError):
        vmem.resolve_cd_sweep_dispatch(142_464, 240)
    with pytest.raises(vmem.VmemBudgetError):
        vmem.cd_sweep_form(142_464, 240, gather=True)
    with pytest.raises(vmem.VmemBudgetError):
        vmem.cd_sweep_gather_block_ctx(142_464, 8, rowpatch=True)
    nnz = 3_399_385
    user = cd_sweep_cost(200_000, 128, 8, 8, n_src=nnz + 1, rowpatch=True)
    assert user["form"] == vmem.REG_ROW
    assert user["hbm_bytes"] == user["form_bytes"] == (
        200_000 * 128 * 16 + 200_000 * 8 * 12 + 200_000 * 64 * 4
        + (nnz + 1) * 8 * 4)
    assert user["smem_bytes"] == vmem.cd_sweep_reg_smem_bytes(32, rowpatch=True)
    bucket = cd_sweep_cost(24, 142_464, 8, 8, n_src=nnz + 1, rowpatch=True)
    assert bucket["form"] == vmem.SPLIT_ROW
    assert bucket["hbm_bytes"] == (24 * 142_464 * 16 + 24 * 8 * 12
                                   + 24 * 64 * 4 + (nnz + 1) * 8 * 4)
    # two passes of 44 B a slot, 35 chunks of 4,096 slots a row, each with
    # 44 partial sums written and read back, and Δ written and read back
    assert vmem.cd_sweep_split_chunk(142_464, 24) == 4_096
    assert bucket["form_bytes"] == (2 * 44 * 24 * 142_464
                                    + 4 * 24 * (2 * 44 * 35 + 2 * 8)
                                    + 24 * 8 * 12 + 24 * 64 * 4)
    assert bucket["smem_bytes"] == vmem.cd_sweep_split_smem_bytes()
    # the pre-gathered bucket side takes the split-row form: two passes of
    # (8 + 4·k_b) = 40 B a slot (no ids), the same scratch; the tile is
    # read twice where the function reads it once
    pre = cd_sweep_cost(24, 142_464, 8, 8, gather=False, rowpatch=True)
    assert pre["form"] == vmem.SPLIT_ROW
    assert pre["hbm_bytes"] == (24 * 142_464 * 12 + 24 * 142_464 * 8 * 4
                                + 24 * 8 * 12 + 24 * 64 * 4)
    assert pre["form_bytes"] == (2 * 40 * 24 * 142_464
                                 + 4 * 24 * (2 * 44 * 35 + 2 * 8)
                                 + 24 * 8 * 12 + 24 * 64 * 4)
    assert pre["smem_bytes"] == vmem.cd_sweep_split_smem_bytes()
    # the pre-gathered user side takes the register-row form, which moves
    # what the function must
    pre = cd_sweep_cost(200_000, 128, 8, 8, gather=False, rowpatch=True)
    assert pre["form"] == vmem.REG_ROW
    assert pre["form_bytes"] == pre["hbm_bytes"] == (
        200_000 * 128 * (12 + 8 * 4) + 200_000 * 8 * 12 + 200_000 * 64 * 4)
    assert pre["smem_bytes"] == vmem.cd_sweep_reg_smem_bytes(32, rowpatch=True)
    # the pre-gathered shared-J sweep keeps the block-row form on long rows
    pre = cd_sweep_cost(24, 142_464, 8, 8, gather=False)
    assert pre["form"] == vmem.BLOCK_ROW
    assert pre["form_bytes"] == 24 * 24 * 142_464 * 8 + 24 * 8 * 12
    assert pre["smem_bytes"] == vmem.cd_sweep_block_row_smem_bytes(8)


def test_register_row_sizing_holds_each_row_in_registers():
    """``vmem.cd_sweep_reg_group``: a compiled (lanes, slots) pair whose
    lanes hold the row, a whole number of groups a block, the fewest lanes
    at its slot count (one warp at 4 slots a thread, more warps at 8); the
    full-width rows (D_pad 128 and 1,024) with no idle slot; the gather
    sweep and the pre-gathered row-patch sweep take it, the pre-gathered
    shared-J sweep does not. k_b > 8 and rows past CDG_THREADS ×
    CDG_SWEEP_MAX_SLOTS keep the shared-memory forms, and MF's dispatch
    takes long rows in their form, refusing only a k_b no form launches;
    the slab reduce takes the one-tile form at m ≤ 9 in either routing."""
    from repro_torch.kernels import vmem
    from repro_torch.kernels.cd_sweep import ops as cs

    longest = vmem.CDG_THREADS * vmem.CDG_SWEEP_MAX_SLOTS
    for d in [*range(1, 300), 1_000, 1_024, 1_025, 2_000, longest]:
        for kb in (1, 3, 8):
            lanes, slots = vmem.cd_sweep_reg_group(d, kb)
            assert lanes in vmem.CDG_SWEEP_LANES and slots in vmem.CDG_SWEEP_SLOTS
            assert lanes * slots >= d and vmem.CDG_THREADS % lanes == 0
            assert slots <= vmem.CDG_SWEEP_MAX_SLOTS
            assert lanes == vmem.CDG_SWEEP_MIN_LANES or (lanes // 2) * slots < d
            assert vmem.cd_sweep_form(d, kb, gather=True) == vmem.REG_ROW
            assert vmem.cd_sweep_form(d, kb, gather=False,
                                      rowpatch=True) == vmem.REG_ROW
    for d in (128, 1_024):
        lanes, slots = vmem.cd_sweep_reg_group(d, 8)
        assert lanes * slots == d
    assert vmem.cd_sweep_reg_group(128, 9) is None
    assert vmem.cd_sweep_form(128, 9, gather=True) == vmem.WARP_ROW
    assert vmem.cd_sweep_reg_group(longest + 1, 8) is None
    assert vmem.cd_sweep_form(longest + 1, 8, gather=True) == vmem.WARP_ROW
    assert vmem.cd_sweep_form(20_000, 8, gather=True) == vmem.SPLIT_ROW
    assert vmem.cd_sweep_form(128, 8, gather=False) == vmem.WARP_ROW
    assert vmem.cd_sweep_form(128, 8, gather=True, rowpatch=True) == vmem.REG_ROW
    assert vmem.cd_sweep_form(128, 9, gather=False, rowpatch=True) == vmem.WARP_ROW
    assert vmem.cd_sweep_form(20_000, 8, gather=False,
                              rowpatch=True) == vmem.SPLIT_ROW
    assert vmem.cd_sweep_form(20_000, 8, gather=False) == vmem.BLOCK_ROW
    assert vmem.resolve_cd_sweep_dispatch(20_000, 8) is True
    with pytest.raises(vmem.VmemBudgetError):
        vmem.resolve_cd_sweep_dispatch(20_000, 240, prefer_gather=False)
    assert vmem.resolve_cd_sweep_dispatch(1_024, 8) is True
    assert vmem.cd_sweep_reg_smem_bytes() == 4 * (64 + 4 * vmem.CDG_THREADS // 32)
    assert vmem.cd_sweep_reg_smem_bytes() <= vmem.SMEM_STATIC_BYTES
    # the slab reduce: one tile for either routing at m ≤ 9 (the m ≤ 8
    # instance, then FM's m = 9), the tiled form from the first m past it
    for m in range(1, 10):
        assert vmem.cd_slab_reduce_form(m) == vmem.SLAB_ONE_TILE
    for m in (10, 17):
        assert vmem.cd_slab_reduce_form(m) == vmem.SLAB_TILED
    for d in (1, 128, 1_024, 20_480):
        assert vmem.cd_slab_reduce_lanes(d) in vmem.CDG_SLAB_LANES
    # every wrapper counts its forms; the CPU's plain versions launch nothing
    for fn in (cs.cd_block_sweep, cs.cd_block_sweep_gather,
               cs.cd_block_sweep_rowpatch, cs.cd_block_sweep_rowpatch_gather):
        assert fn.launches_reg_row >= 0 and fn.launches_block_row >= 0
    for fn in (cs.cd_slab_reduce, cs.cd_slab_reduce_gather):
        assert fn.launches_one_tile >= 0
    x = _reg_operands("cpu", 5, 16, 8, 9, 0, 3)
    before = (cs.cd_block_sweep_gather.launches,
              cs.cd_block_sweep_gather.launches_reg_row,
              cs.cd_slab_reduce_gather.launches_one_tile)
    cs.cd_block_sweep_gather(x["tab"], x["ids"], x["alpha"], x["e"].clone(),
                             x["w"], x["r1"], x["j"], alpha0=0.5, l2=0.1)
    cs.cd_slab_reduce_gather(x["tab"], x["ids"], x["alpha"], x["e"])
    assert (cs.cd_block_sweep_gather.launches,
            cs.cd_block_sweep_gather.launches_reg_row,
            cs.cd_slab_reduce_gather.launches_one_tile) == before


def test_cost_model_carries_the_register_forms_and_their_traffic():
    """The register-row sweep and the one-tile slab reduce (m = 8 and
    FM's m = 9) move what the function must (``form_bytes ==
    hbm_bytes``); the tiled slab reduce, from m = 10, makes one pass over
    the row per pair of 8-column tiles."""
    from repro_torch.kernels import vmem
    from repro_torch.obs.costs import cd_slab_reduce_cost, cd_sweep_cost

    for c, d, n_src in ((200_000, 128, 68_000), (68_000, 1_024, 200_000)):
        cost = cd_sweep_cost(c, d, 8, 8, n_src=n_src)
        assert cost["form"] == vmem.REG_ROW
        assert cost["hbm_bytes"] == cost["form_bytes"] == (
            16 * c * d + 12 * c * 8 + 4 * n_src * 8)
        assert cost["smem_bytes"] == vmem.cd_sweep_reg_smem_bytes()
        slab = cd_slab_reduce_cost(c, d, 8, n_src=n_src)
        assert slab["form"] == vmem.SLAB_ONE_TILE
        assert slab["hbm_bytes"] == slab["form_bytes"] == (
            12 * c * d + 4 * n_src * 8 + 4 * c * (8 + 64))
    assert cd_sweep_cost(100, 128, 8, 8, n_src=50, gather=False)["form"] ==         vmem.WARP_ROW
    c, d, n_src = 1_000, 128, 300
    out = lambda m: 4 * c * (m + m * m)  # noqa: E731
    wide = cd_slab_reduce_cost(c, d, 9, n_src=n_src)
    assert wide["form"] == vmem.SLAB_ONE_TILE
    assert wide["form_bytes"] == wide["hbm_bytes"] == 12 * c * d + 4 * n_src * 9 + out(9)
    tiled = cd_slab_reduce_cost(c, d, 10, n_src=n_src)
    assert tiled["form"] == vmem.SLAB_TILED
    assert tiled["hbm_bytes"] == 12 * c * d + 4 * n_src * 10 + out(10)
    # passes (0, 0), (0, 1), (1, 1): ids and α each, e on the diagonal
    assert tiled["form_bytes"] == (12 + 8 + 12) * c * d + 4 * n_src * 10 + out(10)
    pre = cd_slab_reduce_cost(c, d, 8, gather=False)
    assert pre["form"] == vmem.SLAB_ONE_TILE
    assert pre["form_bytes"] == pre["hbm_bytes"] == 4 * 10 * c * d + out(8)
    pre17 = cd_slab_reduce_cost(c, d, 17, gather=False)
    # tiles of 8, 8 and 1 columns: α (+ e on the diagonal) and the tiles' Ψ
    per_slot = (8 + 32) + (4 + 64) + (4 + 36) + (8 + 32) + (4 + 36) + (8 + 4)
    assert pre17["form_bytes"] == per_slot * c * d + out(17)


def _reg_operands(dev, c, d, kb, ld, f0, seed, *, past=False, zero_rows=0,
                  pad_frac=0.3, scale=0.3):
    """Gather-sweep and slab-reduce operands whose ψ slab is columns
    ``f0 … f0+kb`` of an (n_src, ``ld``) table of ``scale``·N(0, 1): at ld
    a multiple of 4 and f0 a multiple of 4 the slab allows 16-byte loads,
    an odd ld or f0 does not. A ``pad_frac`` share of slots is padding (id
    0, α = 0); ``past`` puts ids past both ends of the slab; the first
    ``zero_rows`` rows have α = 0."""
    rng = np.random.default_rng(seed)
    n_src = 3 * d + 7
    alpha = (rng.random((c, d)) * 4 + 0.5).astype(np.float32)
    ids = rng.integers(0, n_src, (c, d)).astype(np.int32)
    pad = rng.random((c, d)) < pad_frac
    alpha[pad], ids[pad] = 0, 0
    alpha[:zero_rows] = 0
    if past:
        ids[:, :4] = [-7, n_src, 1000 * n_src, -1]
    tab = (scale * rng.normal(size=(n_src, ld))).astype(np.float32)
    jfull = tab.T @ tab + np.eye(ld, dtype=np.float32)
    cols = slice(f0, f0 + kb)

    def t(a):
        return torch.tensor(a, device=dev)

    return dict(tab=t(tab)[:, cols], ids=t(ids), alpha=t(alpha),
                e=t(rng.normal(size=(c, d)).astype(np.float32)),
                w=t((0.3 * rng.normal(size=(c, ld))).astype(np.float32))[:, cols],
                r1=t(rng.normal(size=(c, kb)).astype(np.float32)),
                j=t(jfull)[cols, cols])


def _sweep_tol(x, long_rows, alpha0, l2):
    """Per-row atol of W and per-slot atol of e for the gather sweep: the
    kernel-vs-oracle atol 2e-6, plus, for rows of 1,024 slots, ``_row_tol``'s
    1e-5 of the row's Σ_j Σ_d |α·e·ψ_j| / den_j (in e, times the slot's
    largest |ψ_j|)."""
    from repro_torch.kernels.cd_sweep import ref as cr

    psi = cr.gather_psi_blk(x["tab"], x["ids"])
    a = x["alpha"][:, None, :]
    den = ((a * psi * psi).sum(-1) + alpha0 * torch.diagonal(x["j"])
           + l2).clamp(min=1e-12)
    terms = (a * x["e"][:, None, :].abs() * psi.abs() / den[:, :, None]).sum(1)
    atol_w = _row_tol(terms, long_rows)[:, None]
    return atol_w, atol_w * psi.abs().amax(1)


def _hold_gather_sweep(x, *, long_rows, lanes_slots=None, **kw):
    """One gather sweep against the plain version, and a second call on the
    same inputs, which must give the same bits; through the wrapper, or
    through the binding at ``lanes_slots``."""
    from repro_torch.kernels.cd_sweep import kernel, ops as cs, ref as cr

    rw, re = cr.cd_block_sweep_gather_ref(x["tab"], x["ids"], x["alpha"],
                                          x["e"], x["w"], x["r1"], x["j"], **kw)
    got = []
    for _ in range(2):
        e = x["e"].clone()
        if lanes_slots is None:
            w, e2 = cs.cd_block_sweep_gather(x["tab"], x["ids"], x["alpha"], e,
                                             x["w"], x["r1"], x["j"], **kw)
            assert e2 is e
        else:
            w = torch.empty_like(rw)
            kernel.launch_reg(x["tab"], x["ids"], x["alpha"], e, x["w"],
                              x["r1"], x["j"], w, lanes=lanes_slots[0],
                              slots=lanes_slots[1], **kw)
        got.append((w, e))
    torch.cuda.synchronize()
    (w, e), (w2, e_again) = got
    assert torch.equal(w, w2) and torch.equal(e, e_again), "two calls differ"
    assert bool(torch.isfinite(w).all()) and bool(torch.isfinite(e).all())
    atol_w, atol_e = _sweep_tol(x, long_rows, kw["alpha0"], kw["l2"])
    assert bool(((w - rw).abs() <= 2e-5 * rw.abs() + atol_w).all())
    assert bool(((e - re).abs() <= 2e-5 * re.abs() + atol_e).all())
    return w


@pytest.mark.gpu
@pytest.mark.parametrize("c,d,kb,ld,f0,past,zero_rows", [
    (2_000, 128, 8, 128, 8, False, 0),     # the context side: 16-byte loads
    (680, 1_024, 8, 128, 40, False, 0),    # the item side, a strided slab
    (301, 128, 3, 3, 0, True, 5),          # k_b = 3: scalar loads
    (97, 200, 4, 7, 2, True, 3),           # an odd ld, 8 slots a thread
    (50, 40, 8, 9, 1, True, 0),            # k_b = 8 at an odd ld
    (33, 2_048, 8, 8, 0, False, 2),        # the form's longest row
])
def test_register_row_sweep_matches_plain_on_cuda(cuda, c, d, kb, ld, f0,
                                                  past, zero_rows):
    """The shared-J gather sweep in the register-row form against the plain
    version, to the reference's kernel-vs-oracle tolerance (rtol 2e-5,
    atol 2e-6; for rows of 1,024 slots and more ``_row_tol``'s row-scaled
    atol, ``_sweep_tol``): the 16-byte and the scalar gathers, ids past
    both ends of the slab, rows with α = 0 (W unchanged at l2 = α₀ = 0),
    each launch counted in its form, two calls giving the same bits."""
    from repro_torch.kernels import vmem
    from repro_torch.kernels.cd_sweep import ops as cs

    assert vmem.cd_sweep_form(d, kb, gather=True) == vmem.REG_ROW
    fn = cs.cd_block_sweep_gather
    for kw in (dict(alpha0=0.7, l2=0.05, eta=0.9), dict(alpha0=0.0, l2=0.0)):
        x = _reg_operands(cuda, c, d, kb, ld, f0, c + d, past=past,
                          zero_rows=zero_rows)
        before = (fn.launches, fn.launches_reg_row, fn.launches_block_row)
        w = _hold_gather_sweep(x, long_rows=d >= 1_024, **kw)
        assert (fn.launches - before[0], fn.launches_reg_row - before[1],
                fn.launches_block_row - before[2]) == (2, 2, 0)
        if kw["l2"] == 0:
            assert torch.equal(w[:zero_rows], x["w"][:zero_rows])


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [8, 16, 32, 64, 128, 256])
def test_register_row_sweep_every_group_size_on_cuda(cuda, lanes):
    """Every compiled (lanes, slots) instance, through the binding, at a
    ragged row that fills its group but for three slots and at a row of
    half its slots, C off the block's row count: against the plain
    version to rtol 2e-5 / atol 2e-6 (``_row_tol``'s row-scaled atol from
    1,024 slots), two calls giving the same bits."""
    from repro_torch.kernels import vmem

    for slots in vmem.CDG_SWEEP_SLOTS:
        for d in (lanes * slots - 3, max(1, lanes * slots // 2)):
            x = _reg_operands(cuda, 37, d, 8, 16, 8, lanes + slots + d,
                              past=True, zero_rows=2)
            _hold_gather_sweep(x, long_rows=d >= 1_024, lanes_slots=(lanes, slots),
                               alpha0=0.6, l2=0.1, eta=1.1)


def _hold_one_tile(x, long_rows, *, lanes=None):
    """The gather slab reduce against the plain version: Q and P to rtol
    2e-5 / atol 2e-6 (``_row_tol``'s row-scaled atol for rows of 1,024
    slots and more), P symmetric bit for bit, a second call equal bit for
    bit; through the wrapper, or through the binding at ``lanes``."""
    from repro_torch.kernels.cd_sweep import kernel, ops as cs, ref as cr

    psi = cr.gather_psi_blk(x["tab"], x["ids"])
    rq, rp = cr.cd_slab_reduce_ref(psi, x["alpha"], x["e"])
    got = []
    for _ in range(2):
        if lanes is None:
            got.append(cs.cd_slab_reduce_gather(x["tab"], x["ids"], x["alpha"],
                                                x["e"]))
        else:
            q, p = torch.empty_like(rq), torch.empty_like(rp)
            kernel.slab_reduce_reg(x["tab"], x["ids"], x["alpha"], x["e"], q,
                                   p, lanes=lanes)
            got.append((q, p))
    torch.cuda.synchronize()
    (q, p), (q2, p2) = got
    assert torch.equal(q, q2) and torch.equal(p, p2), "two calls differ"
    assert torch.equal(p, p.transpose(1, 2))
    a = x["alpha"][:, None, :]
    q_tol = _row_tol(a * x["e"][:, None, :] * psi, long_rows)
    p_tol = _row_tol(a[:, :, None, :] * psi[:, :, None, :] * psi[:, None, :, :],
                     long_rows)
    assert bool(((q - rq).abs() <= 2e-5 * rq.abs() + q_tol).all())
    assert bool(((p - rp).abs() <= 2e-5 * rp.abs() + p_tol).all())
    return q, p


@pytest.mark.gpu
@pytest.mark.parametrize("c,d,m,ld,f0,past,zero_rows", [
    (2_000, 128, 8, 128, 8, False, 0),     # the context side: 16-byte loads
    (680, 1_024, 8, 128, 40, False, 0),    # the item side, a strided slab
    (301, 128, 3, 3, 0, True, 5),          # m = 3: scalar loads
    (97, 200, 4, 7, 2, True, 3),           # an odd ld
    (41, 300, 4, 16, 4, False, 1),         # m = 4: one 16-byte load
    (5, 20_480, 8, 8, 0, True, 1),         # long rows
])
def test_one_tile_slab_reduce_matches_plain_on_cuda(cuda, c, d, m, ld, f0,
                                                    past, zero_rows):
    """The gather slab reduce's one-tile form (m ≤ 8 here; m = 9 below)
    through the wrapper, as ``_hold_one_tile`` holds it; each launch
    counted in its form, rows
    with α = 0 giving zero Q and P. ψ is 0.1·N(0, 1), as phase 13 of
    ``chip_smoke.py`` holds it: at 0.3 a 128-slot row's Σ|α·e·ψ| reaches
    ≈ 45, where any two fp32 summation orders (the tiled form's too) can
    differ by more than the atol."""
    from repro_torch.kernels.cd_sweep import ops as cs

    fn = cs.cd_slab_reduce_gather
    x = _reg_operands(cuda, c, d, m, ld, f0, c + d + m, past=past,
                      zero_rows=zero_rows, scale=0.1)
    before = (fn.launches, fn.launches_one_tile)
    q, p = _hold_one_tile(x, d >= 1_024)
    assert (fn.launches - before[0], fn.launches_one_tile - before[1]) == (2, 2)
    assert not bool(q[:zero_rows].any()) and not bool(p[:zero_rows].any())
    # m = 9 takes the one-tile form's wide instance, m = 10 the tiled form
    for m, one_tile in ((9, 1), (10, 0)):
        x = _reg_operands(cuda, 40, 128, m, 16, 0, 9, scale=0.1)
        before = (fn.launches, fn.launches_one_tile)
        cs.cd_slab_reduce_gather(x["tab"], x["ids"], x["alpha"], x["e"])
        assert (fn.launches - before[0], fn.launches_one_tile - before[1]) == (1, one_tile)


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [8, 16, 32])
def test_one_tile_slab_reduce_every_group_size_on_cuda(cuda, lanes):
    """Each compiled group size through the binding, at D_pad 128 and
    1,024 (16-byte loads) and 37 (scalar), C off the block's row count; ψ
    at phase 13's 0.1·N(0, 1)."""
    for c, d, m, ld, f0 in ((203, 128, 8, 128, 0), (61, 1_024, 8, 128, 16),
                            (77, 37, 5, 5, 0)):
        x = _reg_operands(cuda, c, d, m, ld, f0, lanes + d, past=True,
                          zero_rows=1, scale=0.1)
        _hold_one_tile(x, d >= 1_024, lanes=lanes)


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


def _hold_sweep(fn, plain, x, first, cpl, long_rows=False, long_form=None,
                **kw):
    """One launch against the plain version on the same inputs: the
    reference's kernel-vs-oracle rtol 2e-5 / atol 2e-6; for rows of many
    thousands of slots, whose sums the two take in other orders, an
    absolute tolerance per row of 1e-5 of the row's Σ|α·e·ψ_j|/den_j summed
    over j (in W; times max|ψ| in e). The launch counts as a long-row one
    (``launches_block_row``) when ``long_form`` (default ``long_rows``)."""
    before = (fn.launches, fn.launches_block_row)
    e = x["e"].clone()
    w, e2 = fn(*first, x["alpha"], e, x["w"], x["r1"], cpl, **kw)
    rw, re = plain(*first, x["alpha"], x["e"], x["w"], x["r1"], cpl, **kw)
    torch.cuda.synchronize()
    assert e2 is e and fn.launches == before[0] + 1
    long_form = long_rows if long_form is None else long_form
    assert fn.launches_block_row == before[1] + int(long_form)
    _assert_sweep_close(x, first, cpl, w, e, rw, re, long_rows, **kw)
    return w, rw


def _assert_sweep_close(x, first, cpl, w, e, rw, re, long_rows, **kw):
    """W and e of a sweep against the plain version's ``rw``, ``re`` at
    :func:`_hold_sweep`'s tolerance; ``first`` is the ψ source."""
    from repro_torch.kernels.cd_sweep import ref as cr

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


@pytest.mark.gpu
@pytest.mark.parametrize("c,d,kb,eta", [(1001, 40, 8, 1.0), (300, 128, 4, 0.8),
                                        (13, 200, 1, 0.5), (9, 33, 3, 1.3)])
def test_rowpatch_kernels_match_plain_on_cuda(cuda, c, d, kb, eta):
    """Both row-patch routings through their wrappers (the register-row
    form), C off the row tile."""
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
    runs one block a row, with the per-row patch and with one shared J
    (through the wrappers a long-row launch: the gather sweep's is
    split-row). The pre-gathered row-patch sweep, which its wrapper now
    sends to the split-row form, holds the block-row form through its
    binding (``rows_per_block=0``)."""
    from repro_torch.kernels import vmem
    from repro_torch.kernels.cd_sweep import kernel, ops as cs, ref as cr

    x = _rowpatch_operands(cuda, 5, 20_000, 8, 3_000, 9)
    cpl = x["p"] if rowpatch else x["p"][0]
    name = ("cd_block_sweep_rowpatch" if rowpatch else "cd_block_sweep") + (
        "_gather" if gather else "")
    first = ((x["tab"], x["ids"]) if gather else
             (cr.gather_psi_blk(x["tab"], x["ids"]).contiguous(),))
    kw = dict(alpha0=0.7, l2=0.05, eta=0.9)
    plain = getattr(cr, name + "_ref")
    if gather or not rowpatch:
        _hold_sweep(getattr(cs, name), plain, x, first, cpl, long_rows=True,
                    **kw)
        return
    assert vmem.cd_sweep_form(20_000, 8, gather=False, rowpatch=True) == vmem.SPLIT_ROW
    e, w = x["e"].clone(), torch.empty_like(x["w"])
    kernel.launch(first[0], None, None, x["alpha"], e, x["w"], x["r1"], cpl, w,
                  rows_per_block=0, **kw)
    rw, re = plain(*first, x["alpha"], x["e"], x["w"], x["r1"], cpl, **kw)
    torch.cuda.synchronize()
    _assert_sweep_close(x, first, cpl, w, e, rw, re, True, **kw)


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


def test_split_row_and_patch_sizing():
    """The split-row form's chunks (a multiple of the block, at most
    CDG_SPLIT_CHUNK, enough blocks for the card on few rows) and scratch,
    and the residual patch's register-slot form at m ≤ 8 and D_pad a
    multiple of 4; the cost model names the patch's form."""
    from repro_torch.kernels import vmem
    from repro_torch.obs.costs import cd_resid_patch_cost

    for d, rows in ((142_464, 24), (20_000, 5), (15_001, 4), (1, 1),
                    (10_000_000, 3)):
        chunk = vmem.cd_sweep_split_chunk(d, rows)
        assert chunk % vmem.CDG_THREADS == 0
        assert vmem.CDG_THREADS <= chunk <= vmem.CDG_SPLIT_CHUNK
        n_chunks = -(-d // chunk)
        assert rows * n_chunks >= min(vmem.CDG_SPLIT_TARGET_BLOCKS,
                                      rows * -(-d // vmem.CDG_THREADS))
    assert vmem.CDG_NSUM == 44
    assert vmem.cd_sweep_split_smem_bytes() <= vmem.SMEM_STATIC_BYTES
    assert vmem.cd_sweep_reg_smem_bytes(8, rowpatch=True) <= vmem.SMEM_STATIC_BYTES
    assert vmem.cd_sweep_reg_smem_bytes(32, rowpatch=True) == \
        4 * (8 * 64 + 4 * vmem.CDG_THREADS // 32)
    for m in range(1, 9):
        assert vmem.cd_resid_patch_form(128, m, gather=True) == vmem.PATCH_REG_SLOTS
        assert vmem.cd_resid_patch_form(130, m, gather=True) == vmem.PATCH_ONE_SLOT
        assert vmem.cd_resid_patch_form(128, m, gather=False) == vmem.PATCH_ONE_SLOT
    assert vmem.cd_resid_patch_form(128, 9, gather=True) == vmem.PATCH_ONE_SLOT
    assert cd_resid_patch_cost(200_000, 128, 8, n_src=68_000)["form"] == \
        vmem.PATCH_REG_SLOTS
    # the sweep's k_b > 8 on long gather rows keeps the block-row form
    assert vmem.cd_sweep_form(142_464, 9, gather=True, rowpatch=True) == vmem.BLOCK_ROW


def _split_row_call(source, x, psi, cpl, e, kw):
    """One split-row sweep on ``e`` in place through the binding,
    ``kernel.launch_split``, with the scratch ``ops`` allocates: ψ gathered
    (``source`` "gather") or from the tile ``psi``; ``kw`` as the wrappers
    take it (η 1 unless given); returns W."""
    from repro_torch.kernels import vmem
    from repro_torch.kernels.cd_sweep import kernel

    (c, d), kb = x["alpha"].shape, x["w"].shape[1]
    chunk = vmem.cd_sweep_split_chunk(d, c)
    w = torch.empty_like(x["w"])
    part = torch.empty((c, -(-d // chunk), vmem.CDG_NSUM), device=e.device)
    delta = torch.empty((c, kb), device=e.device)
    gathered = (x["tab"], x["ids"]) if source == "gather" else (None, None)
    kernel.launch_split(*gathered, x["alpha"], e, x["w"], x["r1"], cpl, w,
                        part, delta, chunk=chunk,
                        psi_blk=psi if source == "tile" else None,
                        **{"eta": 1.0, **kw})
    return w


@pytest.mark.gpu
@pytest.mark.parametrize("source", ["gather", "tile"])
@pytest.mark.parametrize("c,d,kb,shared", [
    (5, 20_000, 8, False),      # no chunk divides the row
    (4, 15_001, 3, False),      # off a multiple of 4: scalar loads in pass 2
    (6, 18_000, 1, False),      # k_b = 1
    (3, 16_000, 8, True),       # one J for every row (cs0 = 0)
    (24, 142_464, 8, False),    # the bucket shape
])
def test_split_row_form_matches_plain_on_cuda(cuda, source, c, d, kb, shared):
    """The sweep on long rows in the split-row form against the plain
    version at ``_hold_sweep``'s long-row tolerance, ψ gathered (``source``
    "gather", through the gather wrappers) or read from the pre-gathered
    tile ("tile": through the pre-gathered row-patch wrapper where it takes
    the split-row form, else — rows it sends to the warp-row form, and one
    J for every row, whose pre-gathered sweep keeps the block-row form —
    through the binding): ids past both ends of the slab, then (at l2 = α₀
    = 0, as ``test_rowpatch_kernel_clamps_empty_rows_and_clips_ids``) a row
    with α = 0 and P = 0 keeping W; each wrapper call one launch chain
    counted as a long-row and a split-row launch, two calls giving the same
    bits."""
    from repro_torch.kernels import vmem
    from repro_torch.kernels.cd_sweep import ops as cs, ref as cr

    x = _rowpatch_operands(cuda, c, d, kb, 3_000, c + d + kb)
    x["ids"][:, :4] = torch.tensor([-7, 3_000, 10**6, -1], dtype=torch.int32,
                                   device=cuda)
    psi = cr.gather_psi_blk(x["tab"], x["ids"]).contiguous()
    name = "cd_block_sweep" + ("" if shared else "_rowpatch")
    if source == "gather":
        name, first = name + "_gather", (x["tab"], x["ids"])
    else:
        first = (psi,)
    fn, plain = getattr(cs, name), getattr(cr, name + "_ref")
    wrapper = vmem.cd_sweep_form(d, kb, gather=source == "gather",
                                 rowpatch=not shared) == vmem.SPLIT_ROW
    assert wrapper == (source == "gather" or (not shared and d > 19_000))

    def call(e, cpl, kw):
        if wrapper:
            w, e2 = fn(*first, x["alpha"], e, x["w"], x["r1"], cpl, **kw)
            assert e2 is e
            return w
        return _split_row_call(source, x, psi, cpl, e, kw)

    for kw in (dict(alpha0=0.7, l2=0.05, eta=0.9), dict(alpha0=0.0, l2=0.0)):
        if kw["l2"] == 0:
            x["alpha"][:1] = 0
            x["p"][:1] = 0
        cpl = x["p"][1] if shared else x["p"]
        before = (fn.launches, fn.launches_block_row, fn.launches_split_row,
                  fn.launches_reg_row)
        e = x["e"].clone()
        w = call(e, cpl, kw)
        rw, re = plain(*first, x["alpha"], x["e"], x["w"], x["r1"], cpl, **kw)
        torch.cuda.synchronize()
        _assert_sweep_close(x, first, cpl, w, e, rw, re, True, **kw)
        e2 = x["e"].clone()
        w2 = call(e2, cpl, kw)
        e1 = x["e"].clone()
        w1 = call(e1, cpl, kw)
        torch.cuda.synchronize()
        assert torch.equal(w, w2) and torch.equal(w1, w2) and torch.equal(e1, e2)
        assert torch.equal(e, e1)
        n = 3 * int(wrapper)
        assert (fn.launches - before[0], fn.launches_block_row - before[1],
                fn.launches_split_row - before[2],
                fn.launches_reg_row - before[3]) == (n, n, n, 0)
        if kw["l2"] == 0 and not shared:
            assert torch.equal(w[:1], x["w"][:1])


@pytest.mark.gpu
@pytest.mark.parametrize("source", ["gather", "tile"])
def test_split_row_form_takes_more_rows_than_a_grid_column_on_cuda(cuda, source):
    """More than 65,535 rows in the split-row form (pass 1 numbers its
    blocks row-major in one grid dimension): 70,000 rows of 512 slots at
    k_b 8, both ψ sources, through the binding, against the plain version
    at the long-row tolerance; two calls give the same bits."""
    from repro_torch.kernels.cd_sweep import ref as cr

    x = _rowpatch_operands(cuda, 70_000, 512, 8, 5_000, 22)
    psi = cr.gather_psi_blk(x["tab"], x["ids"]).contiguous()
    kw = dict(alpha0=0.7, l2=0.05, eta=0.9)
    e, e2 = x["e"].clone(), x["e"].clone()
    w = _split_row_call(source, x, psi, x["p"], e, kw)
    w2 = _split_row_call(source, x, psi, x["p"], e2, kw)
    first = (x["tab"], x["ids"]) if source == "gather" else (psi,)
    plain = (cr.cd_block_sweep_rowpatch_gather_ref if source == "gather" else
             cr.cd_block_sweep_rowpatch_ref)
    rw, re = plain(*first, x["alpha"], x["e"], x["w"], x["r1"], x["p"], **kw)
    torch.cuda.synchronize()
    assert torch.equal(w, w2) and torch.equal(e, e2)
    _assert_sweep_close(x, first, x["p"], w, e, rw, re, True, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("c,d,kb,eta,zero_rows", [
    (2_000, 128, 8, 1.0, 0),    # the user side's row length
    (301, 128, 8, 0.7, 3),      # C off the row tile, α = 0 rows
    (97, 128, 3, 1.3, 2),       # k_b = 3
    (50, 100, 1, 0.5, 0),       # k_b = 1, slots past the row
    (203, 1_024, 8, 0.9, 2),    # 128 lanes × 8 slots: ψ read a step ahead
])
def test_pregathered_register_row_rowpatch_equals_warp_row_on_cuda(
        cuda, c, d, kb, eta, zero_rows):
    """The pre-gathered row-patch sweep in the register-row form through
    its wrapper, against the plain version (``_hold_sweep``; row-scaled
    atol from 1,024 slots), each launch counted in its form; at 32 lanes a
    row equal bit for bit to the warp-row form it replaced, through that
    form's binding; at any group size bit for bit the gather register-row
    form on the same ψ (the same sums in the same order). Rows with α = 0
    and P = 0 at l2 = α₀ = 0 keep W. The binding refuses the tile with one
    J for every row (that sweep keeps ``csrc/cd_sweep.cu``'s forms)."""
    from repro_torch.kernels import vmem
    from repro_torch.kernels.cd_sweep import kernel, ops as cs, ref as cr

    assert vmem.cd_sweep_form(d, kb, gather=False, rowpatch=True) == vmem.REG_ROW
    x = _rowpatch_operands(cuda, c, d, kb, 500, c + d + kb)
    kw = dict(alpha0=0.7, l2=0.05, eta=eta)
    if zero_rows:
        x["alpha"][:zero_rows] = 0
        x["p"][:zero_rows] = 0
        kw.update(alpha0=0.0, l2=0.0)
    psi = cr.gather_psi_blk(x["tab"], x["ids"]).contiguous()
    fn = cs.cd_block_sweep_rowpatch
    before = fn.launches_reg_row
    w, _ = _hold_sweep(fn, cr.cd_block_sweep_rowpatch_ref, x, (psi,), x["p"],
                       long_rows=d >= 1_024, long_form=False, **kw)
    assert fn.launches_reg_row == before + 1
    assert torch.equal(w[:zero_rows], x["w"][:zero_rows])
    e_new, e_gat = x["e"].clone(), x["e"].clone()
    w_new, _ = fn(psi, x["alpha"], e_new, x["w"], x["r1"], x["p"], **kw)
    w_gat, _ = cs.cd_block_sweep_rowpatch_gather(
        x["tab"], x["ids"], x["alpha"], e_gat, x["w"], x["r1"], x["p"], **kw)
    torch.cuda.synchronize()
    assert torch.equal(w_new, w) and torch.equal(w_new, w_gat)
    assert torch.equal(e_new, e_gat)
    if vmem.cd_sweep_reg_group(d, kb)[0] == 32:
        e_old, w_old = x["e"].clone(), torch.empty_like(w_new)
        kernel.launch(psi, None, None, x["alpha"], e_old, x["w"], x["r1"],
                      x["p"], w_old, rows_per_block=vmem.cd_sweep_block_ctx(
                          d, kb, n_rows=c, rowpatch=True), **kw)
        torch.cuda.synchronize()
        assert torch.equal(w_new, w_old) and torch.equal(e_new, e_old)
    lanes, slots = vmem.cd_sweep_reg_group(d, kb)
    with pytest.raises(RuntimeError, match="cd_sweep_reg"):
        kernel.launch_reg(None, None, x["alpha"], x["e"].clone(), x["w"],
                          x["r1"], x["p"][0], torch.empty_like(w_new),
                          lanes=lanes, slots=slots, psi_blk=psi, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("c,d,kb", [(2_000, 128, 8), (301, 100, 8), (97, 40, 3),
                                    (50, 1_000, 8), (33, 2_048, 4)])
def test_register_row_rowpatch_matches_plain_on_cuda(cuda, c, d, kb):
    """The gather row-patch sweep in the register-row form against the
    plain version (rtol 2e-5 / atol 2e-6; ``_hold_sweep``'s row-scaled atol
    from 1,024 slots), each launch counted in its form; at 32 lanes a row
    (64 < D_pad ≤ 128) equal bit for bit to the warp-row form it replaced,
    through that form's binding."""
    from repro_torch.kernels import vmem
    from repro_torch.kernels.cd_sweep import kernel, ops as cs, ref as cr

    assert vmem.cd_sweep_form(d, kb, gather=True, rowpatch=True) == vmem.REG_ROW
    x = _rowpatch_operands(cuda, c, d, kb, 500, c + d)
    x["ids"][:, :2] = torch.tensor([-3, 10**5], dtype=torch.int32, device=cuda)
    fn = cs.cd_block_sweep_rowpatch_gather
    kw = dict(alpha0=0.7, l2=0.05, eta=0.9)
    before = fn.launches_reg_row
    w, _ = _hold_sweep(fn, cr.cd_block_sweep_rowpatch_gather_ref, x,
                       (x["tab"], x["ids"]), x["p"], long_rows=d >= 1_024,
                       long_form=False, **kw)
    assert fn.launches_reg_row == before + 1
    if vmem.cd_sweep_reg_group(d, kb)[0] == 32:
        e_new, e_old = x["e"].clone(), x["e"].clone()
        w_new, _ = fn(x["tab"], x["ids"], x["alpha"], e_new, x["w"], x["r1"],
                      x["p"], **kw)
        w_old = torch.empty_like(w_new)
        kernel.launch(None, x["tab"], x["ids"], x["alpha"], e_old, x["w"],
                      x["r1"], x["p"], w_old, rows_per_block=vmem.cd_sweep_gather_block_ctx(
                          d, kb, n_rows=c, rowpatch=True), **kw)
        torch.cuda.synchronize()
        assert torch.equal(w_new, w_old) and torch.equal(e_new, e_old)


@pytest.mark.gpu
@pytest.mark.parametrize("m", range(1, 10))
def test_resid_patch_register_slots_equal_one_slot_on_cuda(cuda, m):
    """The gather residual patch at m ≤ 8 in the register-slot form equal
    bit for bit to the one-slot kernel it replaced (m = 9 keeps that
    kernel): a slab of 16-byte rows (ld 8 or 12), a slab of odd ld, ids
    past the slab; a D_pad off a multiple of 4 keeps the one-slot kernel.
    The register-slot form's tile source (the split-row form's pass 2
    pre-gathered), through its binding, equals the pre-gathered one-slot
    kernel bit for bit, 16-byte loads and, at D_pad 37, scalar loads."""
    from repro_torch.kernels.cd_sweep import kernel, ops as cs, ref as cr

    fn = cs.cd_resid_patch_gather
    for d, ld, want_reg in ((128, 8 if m <= 8 else 12, m <= 8),
                            (1_024, m + 3, m <= 8), (37, m, False)):
        x = _slab_operands(cuda, 203, d, ld, 300, m + d + ld, past=True)
        tab, dphi = x["tab"][:, ld - m:], x["dphi"][:, :m]
        before = (fn.launches, fn.launches_reg_slots)
        e = x["e"].clone()
        assert fn(tab, x["ids"], e, dphi) is e
        e_old = x["e"].clone()
        kernel.resid_patch(None, tab, x["ids"], e_old, dphi)
        torch.cuda.synchronize()
        assert (fn.launches - before[0], fn.launches_reg_slots - before[1]) == \
            (1, int(want_reg))
        assert torch.equal(e, e_old)
        torch.testing.assert_close(
            e, cr.cd_resid_patch_gather_ref(tab, x["ids"], x["e"], dphi),
            rtol=2e-5, atol=2e-6)
        if m <= 8:
            psi = cr.gather_psi_blk(tab, x["ids"]).contiguous()
            e_tile, e_one = x["e"].clone(), x["e"].clone()
            kernel.resid_patch_reg(None, None, e_tile, dphi, psi_blk=psi)
            kernel.resid_patch(psi, None, None, e_one, dphi)
            torch.cuda.synchronize()
            assert torch.equal(e_tile, e_one)


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


@pytest.mark.gpu
def test_serve_retrieval_twin_on_cuda(cuda):
    """The serve_retrieval twin's default path: on the card, where the
    cluster, the engine and the IVF oracle must agree bit for bit."""
    from repro_torch.examples import serve_retrieval

    before = ops.topk_score.launches_int8
    out = serve_retrieval.main([])
    assert out["versions"] == [1, 2] and out["mesh_version"] == 2
    assert out["recall_curve"][-1]["recall@100"] == 1.0
    assert out["int8_recall"] > 0.9 and out["degraded_coverage"] == 0.75
    assert ops.topk_score.launches_int8 > before


def _fused_case(dev, b, rows, d, seed, *, ints=True):
    """φ and ψ for the fused top-K form: small integers (many ties, within
    and across chunks; every score exact) or 0.3·N(0, 1)."""
    rng = np.random.default_rng(seed)
    if ints:
        phi = rng.integers(-3, 4, (b, d)).astype(np.float32)
        psi = rng.integers(-3, 4, (rows, d)).astype(np.float32)
    else:
        phi = (0.3 * rng.normal(size=(b, d))).astype(np.float32)
        psi = (0.3 * rng.normal(size=(rows, d))).astype(np.float32)
    return torch.tensor(phi, device=dev), torch.tensor(psi, device=dev)


def _same_bits(a, b):
    return torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def _fused_vs_chain(phi, psi, k, **kw):
    """One fused call (one launch) and one chain call on the same inputs:
    both counted once, the chain also in ``launches_chain``; returns both
    results."""
    before = (ops.topk_score.launches, ops.topk_score.launches_chain)
    got = ops.topk_score(phi, psi, k, **kw)
    mid = (ops.topk_score.launches, ops.topk_score.launches_chain)
    want = ops.topk_score(phi, psi, k, form="chain", **kw)
    after = (ops.topk_score.launches, ops.topk_score.launches_chain)
    torch.cuda.synchronize()
    assert (mid[0] - before[0], mid[1] - before[1]) == (1, 0)
    assert (after[0] - mid[0], after[1] - mid[1]) == (1, 1)
    return got, want


@pytest.mark.gpu
@pytest.mark.parametrize("storage", ["fp32", "bf16", "int8", "mask"])
def test_fused_topk_equals_chain_on_cuda(cuda, storage):
    """The exact form in one launch against the three-launch chain it
    replaced, bit for bit, and against the plain version (small integers:
    every score exact): K 1, 7, 100, 128 and 256; B 1, 5, 16 and 33; row
    counts off the chunk with an id offset and n_valid short of the
    table; exclusion (ids, or the mask as a middle column slice of a wider
    mask), a fully excluded row, ties across blocks (rows repeated)."""
    from repro_torch.serve.cluster import _shard_exclude_mask

    for b, rows, d in ((1, 300, 16), (5, 1_001, 8), (16, 34_000, 128), (33, 9_000, 6)):
        phi, psi = _fused_case(cuda, b, rows, d, b + rows)
        psi = torch.cat([psi[: rows // 2]] * 2 + [psi[: rows % 2]])  # ties across chunks
        rng = np.random.default_rng(rows)
        scale, mask = None, None
        if storage == "bf16":
            psi = psi.bfloat16()
        elif storage == "int8":
            psi, scale = psi.to(torch.int8), torch.full((rows,), 0.5, device=cuda)
        off, n_valid = 700, rows - 37
        kw = dict(psi_scale=scale, id_offset=off, n_valid=n_valid)
        if storage == "mask":
            wide = torch.tensor(rng.random((b, 3 * rows)) < 0.1, device=cuda)
            wide[0, rows:2 * rows] = True                   # a fully masked row
            mask = _shard_exclude_mask(wide, rows, rows)
            assert b == 1 or not mask.is_contiguous()
        else:
            e = rng.integers(off - 5, off + rows, (b, 20)).astype(np.int32)
            e[0] = np.arange(off, off + 20)
            e[-1, 10:] = -1
            kw["exclude_ids"] = torch.tensor(e, device=cuda)
        for k in (1, 7, 100, 128, 256):
            (s, i), (cs_, ci) = _fused_vs_chain(phi, psi, k, exclude_mask=mask, **kw)
            assert torch.equal(i, ci) and _same_bits(s, cs_), (storage, b, rows, k)
            rs, ri = ref.topk_score_ref(phi, psi, k, None if mask is None
                                        else mask.contiguous(), **kw)
            assert torch.equal(i, ri) and torch.equal(s, rs), (storage, b, rows, k)
            if storage == "mask":
                assert bool((i[0] == -1).all()) and bool(torch.isneginf(s[0]).all())


@pytest.mark.gpu
@pytest.mark.parametrize("b,rows,k,n_excl", [(16, 200_000, 100, 0),   # blocks walk chunks
                                             (3, 68_000, 256, 300),   # ids read in place
                                             (40, 2_000, 64, 0),      # three row blocks
                                             (2, 5, 3, 0),            # fewer rows than K
                                             (4, 0, 10, 0)])          # no row at all
def test_fused_topk_running_lists_and_edges_on_cuda(cuda, b, rows, k, n_excl):
    """Tables past two blocks an SM (each block walks several chunks,
    keeping a running list a φ row), exclusion lists longer than the
    staged ones, several row blocks, tables shorter than K and empty
    ones: the fused form equals the chain bit for bit, in random fp32 and
    in small integers (then also the plain version)."""
    for ints in (True, False):
        phi, psi = _fused_case(cuda, b, rows, 32, rows + k, ints=ints)
        kw = dict(id_offset=11, n_valid=max(0, rows - 3))
        if n_excl:
            e = np.random.default_rng(k).integers(0, rows + 20, (b, n_excl))
            kw["exclude_ids"] = torch.tensor(e.astype(np.int32), device=cuda)
        (s, i), (cs_, ci) = _fused_vs_chain(phi, psi, k, **kw)
        assert torch.equal(i, ci) and _same_bits(s, cs_), (b, rows, k, ints)
        if ints:
            rs, ri = ref.topk_score_ref(phi, psi, k, **kw)
            assert torch.equal(i, ri) and torch.equal(s, rs)
        if rows < k:
            assert bool((i[:, max(0, rows - 3):] == -1).all())


@pytest.mark.gpu
def test_fused_topk_nan_and_signed_zero_on_cuda(cuda):
    """A table with NaN rows and −0.0 scores: NaN keys come back as NaN
    with their ids, −0.0 ties with +0.0 in ascending id, as the chain does,
    bit for bit."""
    phi, psi = _fused_case(cuda, 9, 3_000, 16, 5)
    psi[::97] = float("nan")
    psi[5::31] = 0.0
    phi[1] = -0.0
    (s, i), (cs_, ci) = _fused_vs_chain(phi, psi, 100, id_offset=4)
    assert torch.equal(i, ci) and _same_bits(s, cs_)
    assert bool(torch.isnan(s).any())


@pytest.mark.gpu
def test_fused_topk_two_streams_give_the_same_bits(cuda):
    """Calls on two streams at once (each stream has its own completion
    counters), repeated, against the same calls one at a time; tables of
    one cluster and of several."""
    cases = [_fused_case(cuda, 16, rows, 64, rows, ints=False)
             for rows in (34_000, 50_000, 1_000)]
    want = [ops.topk_score(phi, psi, 100) for phi, psi in cases]
    streams = [torch.cuda.Stream(cuda) for _ in range(2)]
    torch.cuda.synchronize()
    got = [[], []]
    for _ in range(10):
        for j, st in enumerate(streams):
            with torch.cuda.stream(st):
                got[j].append([ops.topk_score(phi, psi, 100) for phi, psi in cases])
    torch.cuda.synchronize()
    for runs in got:
        for run in runs:
            for (s, i), (ws, wi) in zip(run, want):
                assert torch.equal(i, wi) and _same_bits(s, ws)


def test_fused_topk_sizing():
    """The fused form's grid (one block a chunk up to the blocks an SM the
    card holds, whole clusters), its shared memory (two blocks an SM with
    the longest staged exclusion lists), and which K takes which form."""
    from repro_torch.kernels import vmem

    cl = vmem.TOPK_FUSED_CLUSTER
    assert vmem.topk_fused_blocks(34_000, 132) == 136        # 133 chunks
    assert vmem.topk_fused_blocks(0, 132) == cl
    assert vmem.topk_fused_blocks(9, 132) == cl
    cap = vmem.TOPK_FUSED_MIN_BLOCKS * 132 // cl * cl
    assert vmem.topk_fused_blocks(200_000, 132) == cap == 264
    for rows in (1, 255, 256, 257, 34_000, 68_000, 10**7):
        n = vmem.topk_fused_blocks(rows, 132)
        assert n % cl == 0 and cl <= n <= max(cl, cap)
    assert vmem.topk_fused_smem_bytes(0) == vmem.topk_fused_smem_bytes(10_000)
    assert vmem.topk_fused_smem_bytes(vmem.TOPK_FUSED_EXCL_STAGE) == \
        vmem.topk_fused_smem_bytes(0) + 4 * 16 * vmem.TOPK_FUSED_EXCL_STAGE
    assert [vmem.topk_fused_list(kp) for kp in (1, 64, 128, 256)] == [128, 128, 128, 256]
    assert vmem.topk_fused_smem_bytes(0, 128) == vmem.topk_fused_smem_bytes(0, 256) - 8 * 16 * 128
    assert vmem.TOPK_FUSED_MIN_BLOCKS * (vmem.topk_fused_smem_bytes(
        vmem.TOPK_FUSED_EXCL_STAGE) + vmem.SMEM_PER_BLOCK_RESERVED) <= vmem.SM_SMEM_BYTES
    for k in (1, 100, 256):
        assert vmem.topk_form(k) == vmem.TOPK_FUSED
        assert vmem.topk_form(k, vmem.TOPK_CHAIN) == vmem.TOPK_CHAIN
    assert vmem.topk_form(257) == vmem.TOPK_CHAIN
    with pytest.raises(ValueError):
        vmem.topk_form(257, vmem.TOPK_FUSED)
    with pytest.raises(ValueError):
        vmem.topk_form(10, "tree")


@pytest.mark.gpu
@pytest.mark.parametrize("c,d,m", [(2_000, 128, 8), (680, 1_024, 8), (301, 100, 1),
                                   (97, 37, 2), (41, 300, 3), (50, 64, 4),
                                   (33, 20, 5), (20, 200, 6), (17, 129, 7)])
def test_pregathered_one_tile_slab_reduce_equals_tiled_on_cuda(cuda, c, d, m):
    """The pre-gathered slab reduce's one-tile form (m ≤ 8) equals the
    tiled form it replaced bit for bit (a lane sums its slots d ≡ lane mod
    32 in order, the transpose-reduce's trees are the butterfly's), each
    wrapper call counted in its form, two calls giving the same bits, and
    holds the plain version as ``_hold_one_tile`` does."""
    from repro_torch.kernels.cd_sweep import kernel, ops as cs, ref as cr

    x = _reg_operands(cuda, c, d, m, m, 0, c + d + m, zero_rows=1, scale=0.1)
    psi = cr.gather_psi_blk(x["tab"], x["ids"]).contiguous()
    fn = cs.cd_slab_reduce
    before = (fn.launches, fn.launches_one_tile)
    q, p = fn(psi, x["alpha"], x["e"])
    q2, p2 = fn(psi, x["alpha"], x["e"])
    tq, tp = torch.empty_like(q), torch.empty_like(p)
    kernel.slab_reduce(psi, None, None, x["alpha"], x["e"], tq, tp)  # the tiled form
    torch.cuda.synchronize()
    assert (fn.launches - before[0], fn.launches_one_tile - before[1]) == (2, 2)
    assert torch.equal(q, q2) and torch.equal(p, p2)
    assert _same_bits(q, tq) and _same_bits(p, tp)
    rq, rp = cr.cd_slab_reduce_ref(psi, x["alpha"], x["e"])
    a = x["alpha"][:, None, :]
    q_tol = _row_tol(a * x["e"][:, None, :] * psi, d >= 1_024)
    p_tol = _row_tol(a[:, :, None, :] * psi[:, :, None, :] * psi[:, None, :, :], d >= 1_024)
    assert bool(((q - rq).abs() <= 2e-5 * rq.abs() + q_tol).all())
    assert bool(((p - rp).abs() <= 2e-5 * rp.abs() + p_tol).all())
    assert not bool(q[:1].any()) and not bool(p[:1].any())


@pytest.mark.gpu
@pytest.mark.parametrize("c,d,ld,f0,past,zero_rows", [
    (203, 128, 9, 0, True, 1),       # FM's concatenated slab (ld 9)
    (37, 1, 12, 0, False, 0),        # D_pad 1; ld 12: a strided column slice
    (61, 63, 12, 0, True, 2),        # D_pad 63
    (2_000, 128, 12, 0, False, 0),   # the context side's D_pad
    (680, 1_024, 130, 4, True, 0),   # the item side's D_pad, a slice of a 130-column table
    (77, 200, 12, 3, True, 1),       # ld 12, the slice off 16-byte alignment
    (5, 20_480, 9, 0, True, 1),      # long rows
])
def test_wide_one_tile_slab_reduce_equals_tiled_on_cuda(cuda, c, d, ld, f0, past,
                                                       zero_rows):
    """FM's m = 9 in the one-tile form's wide instance (54 sums a thread),
    in both ψ routings: equal bit for bit to the tiled form it replaced (a
    lane sums its slots d ≡ lane mod 32 in order with the same products,
    the transpose-reduce's trees are the butterfly's), each wrapper call
    counted as a one-tile launch, two calls giving the same bits, and
    against the plain version as ``_hold_one_tile`` holds it; C off the
    block's 8 rows, ids past both ends of the slab, rows with α = 0 giving
    zero Q and P."""
    from repro_torch.kernels import vmem
    from repro_torch.kernels.cd_sweep import kernel, ops as cs, ref as cr

    m = 9
    assert vmem.cd_slab_reduce_form(m) == vmem.SLAB_ONE_TILE
    x = _reg_operands(cuda, c, d, m, ld, f0, c + d + ld, past=past,
                      zero_rows=zero_rows, scale=0.1)
    assert x["tab"].stride(0) == ld
    fn = cs.cd_slab_reduce_gather
    before = (fn.launches, fn.launches_one_tile)
    q, p = _hold_one_tile(x, d >= 1_024)
    assert (fn.launches - before[0], fn.launches_one_tile - before[1]) == (2, 2)
    tq, tp = torch.empty_like(q), torch.empty_like(p)
    kernel.slab_reduce(None, x["tab"], x["ids"], x["alpha"], x["e"], tq, tp)  # tiled
    torch.cuda.synchronize()
    assert _same_bits(q, tq) and _same_bits(p, tp)
    assert not bool(q[:zero_rows].any()) and not bool(p[:zero_rows].any())
    # the pre-gathered routing on the same ψ
    psi = cr.gather_psi_blk(x["tab"], x["ids"]).contiguous()
    fn = cs.cd_slab_reduce
    before = (fn.launches, fn.launches_one_tile)
    q_pre, p_pre = fn(psi, x["alpha"], x["e"])
    q_pre2, p_pre2 = fn(psi, x["alpha"], x["e"])
    kernel.slab_reduce(psi, None, None, x["alpha"], x["e"], tq, tp)  # tiled
    torch.cuda.synchronize()
    assert (fn.launches - before[0], fn.launches_one_tile - before[1]) == (2, 2)
    assert torch.equal(q_pre, q_pre2) and torch.equal(p_pre, p_pre2)
    assert _same_bits(q_pre, tq) and _same_bits(p_pre, tp)
    assert _same_bits(q_pre, q) and _same_bits(p_pre, p)


@pytest.mark.gpu
def test_wide_one_tile_slab_reduce_refuses_other_group_sizes(cuda):
    """The m = 9 instance is compiled at 32 lanes only: the binding refuses
    8 and 16 lanes at m = 9 (and m = 10, past every instance), where the
    m ≤ 8 instance takes them."""
    from repro_torch.kernels.cd_sweep import kernel

    x = _reg_operands(cuda, 16, 64, 9, 9, 0, 3, scale=0.1)
    q, p = torch.empty((16, 9), device=cuda), torch.empty((16, 9, 9), device=cuda)
    for lanes in (8, 16):
        with pytest.raises(RuntimeError, match="cd_slab_reduce_reg"):
            kernel.slab_reduce_reg(x["tab"], x["ids"], x["alpha"], x["e"], q, p,
                                   lanes=lanes)
    kernel.slab_reduce_reg(x["tab"], x["ids"], x["alpha"], x["e"], q, p, lanes=32)
    x = _reg_operands(cuda, 16, 64, 10, 10, 0, 3, scale=0.1)
    q, p = torch.empty((16, 10), device=cuda), torch.empty((16, 10, 10), device=cuda)
    with pytest.raises(RuntimeError, match="cd_slab_reduce_reg"):
        kernel.slab_reduce_reg(x["tab"], x["ids"], x["alpha"], x["e"], q, p, lanes=32)
    torch.cuda.synchronize()


def _digest(*tensors):
    """SHA-256 (first 16 hex digits) of the tensors' bytes, in order."""
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def _register_form_digests(dev):
    """The k_b = m = 8 (and m ≤ 8) instances of ``csrc/cd_gather.cu`` on
    fixed inputs made from numpy seeds: the register-row sweep (gathered
    with 16-byte and scalar loads, the per-row patch gathered and from the
    tile), the split-row sweep (gathered and from the tile), the one-tile
    slab reduce (16-byte and scalar gathers, the tile, 8 and 16 lanes) and
    the register-slot residual patch; {case: digest of its outputs}."""
    from repro_torch.kernels.cd_sweep import kernel, ops as cs, ref as cr

    out = {}
    kw = dict(alpha0=0.7, l2=0.05, eta=0.9)
    for name, (c, d, ld, f0) in (("sweep_vec", (203, 128, 128, 8)),
                                 ("sweep_scalar", (50, 40, 9, 1)),
                                 ("sweep_long", (33, 2_048, 8, 0)),
                                 ("split", (3, 20_000, 16, 8))):
        x = _reg_operands(dev, c, d, 8, ld, f0, c + d, past=True, zero_rows=1)
        w, e = cs.cd_block_sweep_gather(x["tab"], x["ids"], x["alpha"], x["e"].clone(),
                                        x["w"], x["r1"], x["j"], **kw)
        out[name] = _digest(w, e)
    for name, (c, d) in (("rowpatch", (97, 128)), ("rowpatch_split", (2, 20_480))):
        x = _rowpatch_operands(dev, c, d, 8, 3 * d + 7, c + d)
        w, e = cs.cd_block_sweep_rowpatch_gather(x["tab"], x["ids"], x["alpha"],
                                                 x["e"].clone(), x["w"], x["r1"],
                                                 x["p"], **kw)
        psi = cr.gather_psi_blk(x["tab"], x["ids"]).contiguous()
        wt, et = cs.cd_block_sweep_rowpatch(psi, x["alpha"], x["e"].clone(), x["w"],
                                            x["r1"], x["p"], **kw)
        out[name] = _digest(w, e)
        out[name + "_tile"] = _digest(wt, et)
    for name, (c, d, m, ld, f0) in (("slab_vec", (2_000, 128, 8, 128, 8)),
                                    ("slab_scalar", (97, 200, 4, 7, 2)),
                                    ("slab_long", (5, 20_480, 8, 8, 0))):
        x = _reg_operands(dev, c, d, m, ld, f0, c + d + m, past=True, zero_rows=1,
                          scale=0.1)
        out[name] = _digest(*cs.cd_slab_reduce_gather(x["tab"], x["ids"], x["alpha"],
                                                      x["e"]))
        psi = cr.gather_psi_blk(x["tab"], x["ids"]).contiguous()
        out[name + "_tile"] = _digest(*cs.cd_slab_reduce(psi, x["alpha"], x["e"]))
        for lanes in (8, 16):
            q = torch.empty((c, m), device=dev)
            p = torch.empty((c, m, m), device=dev)
            kernel.slab_reduce_reg(x["tab"], x["ids"], x["alpha"], x["e"], q, p,
                                   lanes=lanes)
            out[f"{name}_{lanes}"] = _digest(q, p)
    x = _slab_operands(dev, 301, 128, 8, 500, 11, past=True)
    e = x["e"].clone()
    cs.cd_resid_patch_gather(x["tab"], x["ids"], e, x["dphi"])
    out["patch"] = _digest(e)
    torch.cuda.synchronize()
    return out


# ``_register_form_digests`` on the tree before the m = 9 instance was
# added (NVIDIA H100 80GB HBM3): the KB = 8 instances must keep their bits.
# The pre-gathered cases equal the gathered ones: the same sums in the same
# order.
KB8_DIGESTS = {
    "sweep_vec": "df9770f532c6cfa5", "sweep_scalar": "a07cf2ecca0e82b2",
    "sweep_long": "13ea65a69fa2008b", "split": "71320357646578b6",
    "rowpatch": "cd509f5e2e4841c0", "rowpatch_tile": "cd509f5e2e4841c0",
    "rowpatch_split": "eb9208d9e078c9ec", "rowpatch_split_tile": "eb9208d9e078c9ec",
    "slab_vec": "953d8f891c059e9b", "slab_vec_tile": "953d8f891c059e9b",
    "slab_vec_8": "b476069ea5bb875f", "slab_vec_16": "ba0a1c29d89dc919",
    "slab_scalar": "5cb2b7a28a44e900", "slab_scalar_tile": "5cb2b7a28a44e900",
    "slab_scalar_8": "0d230426197a909d", "slab_scalar_16": "ea6ca3cbac8b3b19",
    "slab_long": "11479d8e9c08c135", "slab_long_tile": "11479d8e9c08c135",
    "slab_long_8": "9f65844ec2eabf7e", "slab_long_16": "d3c3169f896d1cef",
    "patch": "81ed1eaf73ee8735",
}


@pytest.mark.gpu
def test_kb8_register_forms_keep_their_bits_on_cuda(cuda):
    """Generalising the register machinery over the column count left the
    m ≤ 8 instances' arithmetic as it was: every case of
    ``_register_form_digests`` gives the bits it gave before."""
    assert _register_form_digests(cuda) == KB8_DIGESTS


@pytest.mark.gpu
@pytest.mark.parametrize("psi_dispatch", ["gather", "pregather"])
def test_mf_long_item_row_on_cuda_matches_cpu(cuda, psi_dispatch):
    """MF with one item row of 20,001 slots (every user on item 0, D_pad
    20,096): on the gather route the item side takes the split-row form
    with the shared J (k_b 8), on the pre-gathered route the block-row
    form; two epochs on
    the card against the same epochs on the CPU to the fused-vs-flat
    tolerance (rtol 3e-4, atol 3e-5)."""
    from repro_torch.core.models import mf, mf_padded
    from repro_torch.kernels import vmem
    from repro_torch.kernels.cd_sweep import ops as cs
    from repro_torch.sparse.interactions import build_interactions

    rng = np.random.default_rng(3)
    n_ctx, n_items, k = 20_001, 5, 8
    ctx = np.concatenate([np.arange(n_ctx), rng.integers(0, n_ctx, 3_000)])
    item = np.concatenate([np.zeros(n_ctx, np.int64), rng.integers(1, n_items, 3_000)])
    cells = np.unique(ctx * n_items + item)
    ctx, item = cells // n_items, cells % n_items
    nnz = len(ctx)
    y = rng.integers(1, 5, nnz).astype(np.float64)
    alpha = 1.0 + rng.random(nnz)
    w0 = (0.1 * rng.normal(size=(n_ctx, k))).astype(np.float32)
    h0 = (0.1 * rng.normal(size=(n_items, k))).astype(np.float32)
    hp = mf.MFHyperParams(k=k, alpha0=0.5, l2=0.1, block_k=8,
                          psi_dispatch=psi_dispatch)
    gather = psi_dispatch == "gather"
    fn = cs.cd_block_sweep_gather if gather else cs.cd_block_sweep
    out = {}
    for where in ("cpu", cuda):
        data = build_interactions(ctx, item, y, alpha, n_ctx, n_items,
                                  alpha0=0.5, device=where)
        pdata = mf_padded.pad_interactions(data)
        d_item = pdata.ctx_ids.shape[1]
        p = mf.params_from_numpy(w0, h0, device=where)
        e = mf_padded.residuals(p, pdata)
        before = (fn.launches_split_row, fn.launches_block_row)
        for _ in range(2):
            p, e = mf_padded.epoch(p, pdata, e, hp)
        if where != "cpu":
            long = (fn.launches_split_row - before[0], fn.launches_block_row - before[1])
            assert long == ((2, 2) if gather else (0, 2)), long
        out[str(where)] = [t.cpu() for t in (p.w, p.h, e)]
    assert d_item == 20_096 and vmem.cd_sweep_form(d_item, 8, gather=gather) == (
        vmem.SPLIT_ROW if gather else vmem.BLOCK_ROW)
    for a, b in zip(out[str(cuda)], out["cpu"]):
        torch.testing.assert_close(a, b, rtol=3e-4, atol=3e-5)


# ---------------------------------------------------------------------------
# FM (slice 4b) and fold-in: the kernels at FM's shapes (export width
# D = k + 2, fused blocks of m = k_b + 1 columns) and the epochs and
# fold-in on the card against the CPU.
# ---------------------------------------------------------------------------
def test_fm_shapes_take_the_forms_fm_drives():
    """At icd-fm's k = 128, block_k 0 gives k_b 8 and m = 9: the slab
    reduce takes the one-tile form's m = 9 instance and the gather
    residual patch the one-slot kernel (its register-slot form stops at m
    = CDG_KB = 8); the first m past the slab reduce's widest instance (10)
    takes the tiled form; block_k 7 (m = 8) keeps the one-tile and
    register-slot forms. A 130-column fp32 row is 520 bytes, not a
    multiple of 16, and a bf16 one 260."""
    from repro_torch.core import sweeps
    from repro_torch.kernels import vmem

    k_b = sweeps.resolve_block_k(0, 128)
    assert k_b == 8 and vmem.cd_slab_reduce_form(k_b + 1) == vmem.SLAB_ONE_TILE
    assert vmem.cd_slab_reduce_form(k_b + 2) == vmem.SLAB_TILED
    for d in (128, 1_024):
        assert vmem.cd_resid_patch_form(d, k_b + 1, gather=True) == vmem.PATCH_ONE_SLOT
        assert vmem.cd_resid_patch_form(d, 8, gather=True) == vmem.PATCH_REG_SLOTS
    assert vmem.cd_slab_reduce_form(8) == vmem.SLAB_ONE_TILE
    assert (4 * 130) % 16 and (2 * 130) % 16
    assert 128 // k_b == 16 and sweeps.resolve_block_k(7, 128) == 7


@pytest.mark.gpu
@pytest.mark.parametrize("storage", ["fp32", "bf16"])
def test_fused_topk_at_fm_width_equals_chain_and_plain_on_cuda(cuda, storage):
    """D = 130 (FM's Φe·Ψe): scalar loads (the rows are not 16-byte
    multiples) and a partial last D-slab, in the one-launch form, bit for
    bit the chain and the plain version in small integers (every score
    exact), K 1, 100 and 256, with exclusion lists, at the engine's
    68,000-row table and at short tables."""
    for b, rows in ((16, 68_000), (5, 1_001), (33, 300)):
        phi, psi = _fused_case(cuda, b, rows, 130, rows + 130)
        if storage == "bf16":
            psi = psi.bfloat16()
        e = np.random.default_rng(rows).integers(0, rows, (b, 12)).astype(np.int32)
        e[-1, 6:] = -1
        kw = dict(exclude_ids=torch.tensor(e, device=cuda))
        for k in (1, 100, 256):
            (s, i), (cs_, ci) = _fused_vs_chain(phi, psi, k, **kw)
            assert torch.equal(i, ci) and _same_bits(s, cs_), (storage, b, rows, k)
            rs, ri = ref.topk_score_ref(phi, psi, k, **kw)
            assert torch.equal(i, ri) and torch.equal(s, rs), (storage, b, rows, k)


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [200_000, 68_000])
@pytest.mark.parametrize("weighted", [False, True])
def test_gram_kernel_at_fm_width_exact_on_cuda(cuda, rows, weighted):
    """The Gram of Φe (200,000 × 130) and Ψe (68,000 × 130), weighted and
    not: 520-byte rows take the 4-byte copies. Small integers, so every sum
    is exact (|Σ| ≤ 27 · 200,000 < 2²⁴) and the kernel equals the plain
    version bit for bit, twice."""
    from repro_torch.kernels.gram import ops as gram_ops
    from repro_torch.kernels.gram.ref import gram_ref

    x = _ints((rows, 130), rows, cuda)
    w = _ints((rows,), rows + 1, cuda).abs() if weighted else None
    before = gram_ops.gram.launches
    got, again = gram_ops.gram(x, weights=w), gram_ops.gram(x, weights=w)
    want = gram_ref(x, w)
    torch.cuda.synchronize()
    assert gram_ops.gram.launches == before + 2
    assert torch.equal(got, want) and torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("hpkw", [dict(block_k=0), dict(block_k=0, psi_dispatch="pregather"),
                                  dict(block_k=7), dict(block_k=5, multi_hot_mode="slot")])
def test_fm_epoch_padded_on_cuda_matches_cpu(cuda, hpkw):
    """k = 12 (block_k 0 → k_b 8: one block of m = 9, tiled and one-slot,
    and a tail of m = 5): two fused FM epochs with the Gram kernel on the
    card against the same epochs through the plain versions on the CPU, to
    the reference's fused-vs-flat tolerance (rtol 5e-4, atol 1e-5; e atol
    5e-5); the launches by form."""
    from repro_torch.core import sweeps
    from repro_torch.core.models import fm
    from repro_torch.kernels import vmem
    from repro_torch.kernels.cd_sweep import ops as cs
    from repro_torch.kernels.gram import ops as gram_ops

    k = 12
    rng = np.random.default_rng(9)
    hp = fm.FMHyperParams(k=k, alpha0=0.3, l2=0.05, implementation="pallas", **hpkw)
    gather = hp.psi_dispatch == "gather"
    slab = cs.cd_slab_reduce_gather if gather else cs.cd_slab_reduce
    patch = cs.cd_resid_patch_gather if gather else cs.cd_resid_patch
    out = {}
    for where in ("cpu", cuda):
        x, z, data = _mfsi_problem(where)  # a bag, one-hot fields
        if not out:
            arrays = (np.float32(0.2), (0.01 * rng.normal(size=x.p)).astype(np.float32),
                      (0.1 * rng.normal(size=(x.p, k))).astype(np.float32),
                      (0.01 * rng.normal(size=z.p)).astype(np.float32),
                      (0.1 * rng.normal(size=(z.p, k))).astype(np.float32))
        pdata = fm.pad_interactions(data)
        p = fm.params_from_numpy(*arrays, device=where)
        e = fm.residuals_padded(p, x, z, data, pdata, hp)
        before = (gram_ops.gram.launches, slab.launches, slab.launches_one_tile,
                  patch.launches, getattr(patch, "launches_reg_slots", 0))
        for _ in range(2):
            p, e = fm.epoch_padded(p, x, z, pdata, e, hp)
        after = (gram_ops.gram.launches, slab.launches, slab.launches_one_tile,
                 patch.launches, getattr(patch, "launches_reg_slots", 0))
        launched = [a - b for a, b in zip(after, before)]
        if where == "cpu":
            assert launched == [0] * 5
        else:
            kb = sweeps.resolve_block_k(hp.block_k, k)
            ms = [min(kb, k - f0) + 1 for f0 in range(0, k, kb)]
            one_tile = sum(vmem.cd_slab_reduce_form(m) == vmem.SLAB_ONE_TILE for m in ms)
            reg = sum(gather and vmem.cd_resid_patch_form(d, m, gather=True)
                      == vmem.PATCH_REG_SLOTS
                      for m in ms for d in (pdata.alpha_c.shape[1], pdata.alpha_i.shape[1]))
            n = 2 * 2 * len(ms)
            assert launched == [4, n, 2 * 2 * one_tile, n, 2 * reg], launched
        out[str(where)] = [t.cpu() for t in (*p, e)]
    for i, (a, b) in enumerate(zip(out[str(cuda)], out["cpu"])):
        torch.testing.assert_close(a, b, rtol=5e-4, atol=5e-5 if i == 5 else 1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["mf", "fm", "parafac"])
def test_fold_in_on_cuda_matches_cpu(cuda, name):
    """A user and an item folded in on the card (G from the Gram kernel,
    one triangular solve a sweep) against the same fold-in on the CPU and
    against the float64 oracle, to rtol 2e-4 / atol 2e-5; FM's fixed
    columns exactly 1."""
    from repro_torch.core import foldin
    from repro_torch.core.models import zoo
    from repro_torch.kernels.gram import ops as gram_ops

    rows = {}
    for where in ("cpu", cuda):
        model, params, _ = zoo.zoo_model(name, np.random.default_rng(3),
                                         device=where)
        if where == "cpu":
            host = params
        else:
            params = type(host)(*(t.to(cuda) for t in host))
        before = gram_ops.gram.launches
        u = model.fold_in_user(params, [0, 3, 5, 9], n_sweeps=256, tol=1e-8)
        i = model.fold_in_item(params, [1, 2, 7], n_sweeps=256, tol=1e-8)
        torch.cuda.synchronize()
        assert u.device.type == i.device.type == torch.device(where).type
        assert gram_ops.gram.launches - before == (0 if where == "cpu" else 2)
        rows[str(where)] = (u.cpu(), i.cpu())
        if where == "cpu":
            hp = model._foldin_hp()
            free_u, init_u = model._user_free_init()
            free_i, init_i = model._item_free_init()
            exact = (foldin.fold_in_exact(model.export_psi(params), [0, 3, 5, 9],
                                          alpha0=hp["alpha0"], l2=hp["l2"],
                                          free=free_u, init=init_u),
                     foldin.fold_in_exact(model.phi_table(params), [1, 2, 7],
                                          alpha0=hp["alpha0"], l2=hp["l2"],
                                          free=free_i, init=init_i))
    for got, cpu, want in zip(rows[str(cuda)], rows["cpu"], exact):
        torch.testing.assert_close(got, cpu, rtol=2e-4, atol=2e-5)
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)
    if name == "fm":
        k = 6
        assert float(rows[str(cuda)][0][k + 1]) == 1.0
        assert float(rows[str(cuda)][1][k]) == 1.0


# ---------------------------------------------------------------------------
# Slice 6 and the training stack: the baselines, the optimizers and train
# step, the checkpointer, the loader and the twins
# ---------------------------------------------------------------------------
SLICE6_MODULES = ("data/loader.py", "runtime/hosts.py", "sparse/csr.py",
                  "sparse/sampler.py", "core/ials.py", "core/bpr.py",
                  "optim/__init__.py", "optim/base.py", "optim/sgd.py",
                  "optim/adam.py", "optim/adafactor.py", "optim/clip.py",
                  "optim/schedules.py", "optim/mixed.py",
                  "train/train_step.py", "train/trainer.py",
                  "checkpoint/checkpointer.py", "launch/train.py",
                  "examples/continual_learning.py", "examples/observability.py")


def test_slice6_modules_sit_at_the_reference_paths():
    """Each new module mirrors the reference's path (``runtime/hosts.py``,
    the port's host index and count, has none) and is among the files the
    import check reads."""
    port = ROOT / "src" / "repro_torch"
    for rel in SLICE6_MODULES:
        assert (port / rel).is_file(), rel
        if rel.startswith("examples/"):
            assert (ROOT / rel).is_file(), rel
        elif rel != "runtime/hosts.py":
            assert (ROOT / "src" / "repro" / rel).is_file(), rel
        assert not _IMPORT.search((port / rel).read_text()), rel


def _mf_problem(seed, n_ctx, n_items, nnz, k, dev):
    from repro_torch.core.models import mf
    from repro_torch.sparse.interactions import build_interactions

    rng = np.random.default_rng(seed)
    cells = rng.choice(n_ctx * n_items, size=nnz, replace=False)
    data = build_interactions(cells // n_items, cells % n_items, np.ones(nnz),
                              np.full(nnz, 2.5), n_ctx, n_items, alpha0=0.5,
                              device=dev)
    w = 0.1 * rng.normal(size=(n_ctx, k)).astype(np.float32)
    h = 0.1 * rng.normal(size=(n_items, k)).astype(np.float32)
    return data, mf.params_from_numpy(w, h, device=dev), cells


@pytest.mark.gpu
def test_ials_epoch_on_cuda_matches_cpu(cuda, monkeypatch):
    """One iALS epoch at 3,000 × 2,000, k 32, on the card and on the CPU,
    with blocks of rows and slices of observations small enough that rows
    split across slices."""
    from repro_torch.core import ials

    monkeypatch.setattr(ials, "_ROW_CHUNK", 1_000)
    monkeypatch.setattr(ials, "_OBS_CHUNK", 777)
    hp = ials.IALSHyperParams(k=32, alpha0=0.5, l2=0.1)
    out = {}
    for where in ("cpu", cuda):
        data, params, _ = _mf_problem(0, 3_000, 2_000, 40_000, 32, where)
        out[str(where)] = ials.epoch(params, data, hp)
    torch.cuda.synchronize()
    for a, b in zip(out[str(cuda)], out["cpu"]):
        assert a.device.type == "cuda"
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
def test_bpr_steps_on_cuda_match_cpu(cuda):
    """20 BPR steps of batch 4,096 (repeated ids in every batch) on the
    card and on the CPU, from one start and the same draws."""
    from repro_torch.core import bpr

    hp = bpr.BPRHyperParams(k=16, lr=0.05, batch=4_096)
    out = {}
    for where in ("cpu", cuda):
        data, params, cells = _mf_problem(1, 500, 300, 5_000, 16, where)
        pairs = np.stack([cells // 300, cells % 300], 1)
        out[str(where)] = bpr.fit(params, pairs, 300, hp, n_steps=20, seed=3)
    torch.cuda.synchronize()
    for a, b in zip(out[str(cuda)], out["cpu"]):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
def test_checkpoint_saved_on_cuda_restores_onto_cuda_and_cpu(cuda, tmp_path):
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import init_state

    gen = torch.Generator(device=cuda).manual_seed(0)
    params = {"w": torch.randn(300, 64, generator=gen, device=cuda),
              "b": torch.randn(64, generator=gen, device=cuda).bfloat16()}
    state = init_state(params, adamw(0.1))
    ck = Checkpointer(str(tmp_path))
    ck.save(1, state, blocking=True)
    for where in (cuda, "cpu"):
        target = init_state({"w": torch.zeros(300, 64, device=where),
                             "b": torch.zeros(64, device=where).bfloat16()},
                            adamw(0.1))
        got = ck.restore(1, target)
        assert got.params["w"].device.type == torch.device(where).type
        assert got.params["b"].dtype == torch.bfloat16
        assert torch.equal(got.params["w"].cpu(), params["w"].cpu())
        assert torch.equal(got.params["b"].cpu(), params["b"].cpu())
        assert torch.equal(got.opt["m"]["w"].cpu(), state.opt["m"]["w"].cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("n_mb", [1, 4])
def test_train_step_on_cuda_matches_cpu(cuda, n_mb):
    from repro_torch.optim import adafactor
    from repro_torch.train.train_step import build_train_step, init_state

    rng = np.random.default_rng(5)
    w0 = rng.normal(size=(32, 8)).astype(np.float32)
    x = rng.normal(size=(64, 32)).astype(np.float32)
    y = rng.normal(size=(64, 8)).astype(np.float32)

    def loss(p, b):
        return torch.mean((b["x"] @ p["w"] - b["y"]) ** 2)

    out = {}
    for where in ("cpu", cuda):
        opt = adafactor()
        step = build_train_step(loss, opt, num_microbatches=n_mb)
        s = init_state({"w": torch.tensor(w0, device=where)}, opt)
        batch = {"x": torch.tensor(x, device=where), "y": torch.tensor(y, device=where)}
        for _ in range(3):
            s, m = step(s, batch)
        out[str(where)] = (s.params["w"], float(m["loss"]))
    torch.cuda.synchronize()
    assert out[str(cuda)][0].device.type == "cuda"
    torch.testing.assert_close(out[str(cuda)][0].cpu(), out["cpu"][0],
                               rtol=1e-5, atol=1e-6)
    assert out[str(cuda)][1] == pytest.approx(out["cpu"][1], rel=1e-5)


SLICE7_MODULES = ("launch/mesh.py", "launch/sharding.py", "models/__init__.py",
                  "models/hints.py", "runtime/elastic.py",
                  "runtime/collectives.py", "optim/compression.py",
                  "core/models/mf_dist.py")


def test_slice7_modules_sit_at_the_reference_paths():
    """The distribution layer's modules mirror the reference's paths
    (``runtime/collectives.py``, the port's collectives over
    ``torch.distributed``, has none), are among the files the import
    check reads, and import without touching a process group."""
    import importlib

    import torch.distributed as dist

    port = ROOT / "src" / "repro_torch"
    for rel in SLICE7_MODULES:
        assert (port / rel).is_file(), rel
        if rel != "runtime/collectives.py":
            assert (ROOT / "src" / "repro" / rel).is_file(), rel
        assert not _IMPORT.search((port / rel).read_text()), rel
        name = "repro_torch." + rel[:-3].replace("/", ".").removesuffix(".__init__")
        importlib.import_module(name)
    assert not dist.is_initialized()


def _dist_mf_epoch(dev, backend):
    """One route/fp32 ``mf_dist`` epoch at toy size in a world of one."""
    from repro_torch.core.models import mf, mf_dist
    from repro_torch.runtime import collectives

    data, params, _ = _mf_problem(9, 60, 45, 400, 8, dev)
    hp = mf.MFHyperParams(k=8, alpha0=0.5, l2=0.1)
    with collectives.world_of_one(backend):
        mesh = mf_dist.make_shard_mesh(1, device_type=dev.type)
        host = mf_dist.shard_interactions(data, 1)
        pb = mf_dist.shard_params(params, host)
        e = mf_dist.residuals_blocked(pb, host)[0]
        collectives.reset_counts()
        epoch = mf_dist.build_epoch(mesh, hp, host, variant="route")
        w, h, e = epoch(pb.w[0], pb.h[0], host.local(0, dev), e)
        counts = collectives.read_counts()
    return w, h, e, counts


@pytest.mark.gpu
def test_mf_dist_nccl_world_of_one_matches_cpu(cuda):
    """The route/fp32 epoch over NCCL on the card against the same epoch
    over gloo on the CPU: real NCCL collectives, one rank."""
    got = _dist_mf_epoch(cuda, "nccl")
    want = _dist_mf_epoch(torch.device("cpu"), "gloo")
    torch.cuda.synchronize()
    assert got[0].device.type == "cuda"
    for a, b in zip(got[:3], want[:3]):
        torch.testing.assert_close(a.cpu(), b, rtol=5e-4, atol=5e-5)
    assert got[3] == want[3] == {"all_reduce": 2, "all_gather": 0,
                                 "all_to_all": 2 * 8 + 2}


@pytest.mark.gpu
def test_mesh_barrier_waits_on_the_host_over_nccl(cuda):
    """An NCCL all-reduce only queues work on the card; the barrier also
    waits for it on the host, so a long kernel queued before it has ended
    when it returns."""
    from repro_torch.core.models.mf_dist import make_shard_mesh
    from repro_torch.runtime.collectives import mesh_barrier, world_of_one

    with world_of_one("nccl"):
        mesh = make_shard_mesh(1, device_type="cuda")
        mesh_barrier(mesh)  # NCCL's one-time set-up
        torch.cuda.synchronize()
        torch.cuda._sleep(400_000_000)  # ≈ 0.2 s of the card's clock
        mesh_barrier(mesh)
        assert torch.cuda.current_stream().query()


@pytest.mark.gpu
@pytest.mark.parametrize("exclude", [False, True])
def test_shard_map_topk_nccl_world_of_one_equals_cluster_topk(cuda, exclude):
    from repro_torch.core.models.mf_dist import make_shard_mesh
    from repro_torch.runtime.collectives import world_of_one
    from repro_torch.serve.cluster import cluster_topk, shard_map_topk, shard_psi

    gen = torch.Generator(device=cuda).manual_seed(4)
    table = shard_psi(torch.randn(3_001, 64, generator=gen, device=cuda), 1)
    phi = torch.randn(16, 64, generator=gen, device=cuda)
    eids = (torch.randint(0, 3_001, (16, 20), generator=gen, device=cuda,
                          dtype=torch.int32) if exclude else None)
    with world_of_one("nccl"):
        mesh = make_shard_mesh(1, device_type="cuda")
        before = ops.topk_score.launches
        got = shard_map_topk(mesh, table, phi, 100, exclude_ids=eids)
        assert ops.topk_score.launches == before + 1
    want = cluster_topk(table, phi, 100, exclude_ids=eids)
    torch.cuda.synchronize()
    assert torch.equal(got.ids, want.ids) and torch.equal(got.scores, want.scores)


# ---------------------------------------------------------------------------
# The top-K kernel at any number of query rows. Above 65,535 φ rows the
# wrappers run the kernel once a slice of 65,520 rows (4,095 row blocks).
# ---------------------------------------------------------------------------
MANY_ROWS = 70_000


def _launch_counts():
    return {f: getattr(ops.topk_score, f) for f in
            ("launches", "launches_chain", "launches_mask", "launches_ivf")}


def _launched(before):
    return {f: n - before[f] for f, n in _launch_counts().items()}


@pytest.mark.gpu
@pytest.mark.parametrize("k,excl", [(10, "ids"), (100, "mask"), (300, None),
                                    (300, "mask")])
def test_topk_past_65535_rows_exact_on_cuda(cuda, k, excl):
    """70,000 φ rows in small integers (exact scores, ties everywhere):
    the one-launch form (K ≤ 256) and the chain (K = 300) against the
    plain version, ids exact, two launches a call; the dense mask a
    strided column slice, the id lists sliced by rows with φ."""
    rows, d = 2_000, 8
    phi, psi = _ints((MANY_ROWS, d), 35, cuda), _ints((rows, d), 36, cuda)
    rng = np.random.default_rng(37)
    kw = {}
    if excl == "ids":
        e = rng.integers(0, rows, (MANY_ROWS, 6)).astype(np.int32)
        e[:, -1] = -1
        kw["exclude_ids"] = torch.tensor(e, device=cuda)
    elif excl == "mask":
        wide = torch.tensor(rng.random((MANY_ROWS, rows + 64)) < 0.3, device=cuda)
        kw["exclude_mask"] = wide[:, 32:32 + rows]
    before = _launch_counts()
    s, i = ops.topk_score(phi, psi, k, n_valid=rows - 7, id_offset=5, **kw)
    torch.cuda.synchronize()
    assert _launched(before) == {"launches": 2,
                                 "launches_chain": 2 if k > 256 else 0,
                                 "launches_mask": 2 if excl == "mask" else 0,
                                 "launches_ivf": 0}
    rs, ri = ref.topk_score_ref(phi, psi, k, n_valid=rows - 7, id_offset=5, **kw)
    assert torch.equal(i, ri) and torch.equal(s, rs)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [100, 300])
def test_topk_ivf_past_65535_rows_exact_on_cuda(cuda, k):
    """The IVF form at 70,000 φ rows against its plain version, ids exact,
    with a random probe mask and exclusions, two launch chains a call."""
    c = 7
    phi, forms, arrays, excl, _ = _ivf_case(cuda, b=MANY_ROWS, c=c,
                                            block_rows=300, d=8, seed=k)
    rng = np.random.default_rng(k + 2)
    probe = torch.tensor(rng.random((MANY_ROWS, c)) < 0.5, device=cuda)
    psi, scale = forms["fp32"]
    args = dict(probe_mask=probe, psi_scale=scale, exclude_ids=excl, **arrays)
    before = _launch_counts()
    s, i = ops.topk_score_ivf(phi, psi, k, **args)
    torch.cuda.synchronize()
    assert _launched(before) == {"launches": 2, "launches_chain": 0,
                                 "launches_mask": 0, "launches_ivf": 2}
    rs, ri = ref.topk_score_ivf_ref(phi, psi, k, **args)
    assert torch.equal(i, ri) and torch.equal(s, rs)


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["fused", "chain", "ivf"])
def test_topk_past_65535_rows_equals_separate_calls_on_cuda(cuda, form):
    """Random fp32: every row of one 70,000-row call equals, bit for bit,
    the same row answered by calls of at most 65,535 rows, sliced where the
    wrapper does not slice (35,000 and 35,000; then 65,535 and 4,465)."""
    gen = torch.Generator(device=cuda).manual_seed(38)
    d, rows = 32, 5_000
    phi = torch.randn((MANY_ROWS, d), generator=gen, device=cuda)
    psi = torch.randn((rows, d), generator=gen, device=cuda)
    eids = torch.randint(0, rows, (MANY_ROWS, 5), generator=gen, device=cuda,
                         dtype=torch.int32)
    if form == "ivf":
        probe = torch.rand((MANY_ROWS, 10), generator=gen, device=cuda) < 0.6
        arrays = dict(counts=torch.full((10,), 500, dtype=torch.int32, device=cuda),
                      ids_global=torch.arange(rows, dtype=torch.int32, device=cuda),
                      block_rows=500)

        def call(r):
            return ops.topk_score_ivf(phi[r], psi, 50, probe_mask=probe[r],
                                      exclude_ids=eids[r], **arrays)
    else:
        k = 100 if form == "fused" else 400

        def call(r):
            return ops.topk_score(phi[r], psi, k, exclude_ids=eids[r])
    whole = call(slice(0, MANY_ROWS))
    for cut in (35_000, 65_535):
        parts = [call(slice(0, cut)), call(slice(cut, MANY_ROWS))]
        torch.cuda.synchronize()
        for j in (0, 1):
            assert torch.equal(whole[j], torch.cat([p[j] for p in parts])), (
                form, cut, j)


@pytest.mark.parametrize("b,want", [
    (0, []), (1, [(0, 1)]), (65_535, [(0, 65_535)]),
    (65_536, [(0, 65_520), (65_520, 65_536)]),
    (MANY_ROWS, [(0, 65_520), (65_520, MANY_ROWS)]),
    (131_040, [(0, 65_520), (65_520, 131_040)]),
    (131_041, [(0, 65_520), (65_520, 131_040), (131_040, 131_041)])])
def test_row_slices_cover_any_batch_in_launchable_pieces(b, want):
    from repro_torch.kernels import vmem

    got = ops._row_slices(b)
    assert [(s.start, s.stop) for s in got] == want
    # a slice fits one launch: the merges' grid.y and the fused form's
    # counters (one a block of TOPK_ROW_BLOCK rows, up to 65,535 rows)
    assert all(s.stop - s.start <= 65_535 for s in got)
    assert all(s.start % vmem.TOPK_ROW_BLOCK == 0 for s in got)


def _fake_launches(monkeypatch, seen):
    """Stand-ins for the three C entry points that answer with the plain
    version on the slice they are handed, writing into the output views
    the wrapper passes: the wrapper's slicing, run on the CPU."""
    from repro_torch.kernels.topk_score import kernel

    def exact(phi, psi, psi_scale, excl, mask, k, id_offset, n_valid,
              scores, ids):
        seen.append(phi.shape[0])
        s, i = ref.topk_score_ref(phi, psi, k, None if mask is None else mask != 0,
                                  exclude_ids=excl, psi_scale=psi_scale,
                                  id_offset=id_offset, n_valid=n_valid)
        scores.copy_(s)
        ids.copy_(i)

    def fused(phi, psi, psi_scale, excl, mask, mask_stride, k, k_pad, n_blocks,
              id_offset, n_valid, scores, ids, cand, counters):
        exact(phi, psi, psi_scale, excl, mask, k, id_offset, n_valid, scores, ids)

    def chain(phi, psi, psi_scale, excl, mask, mask_stride, k, k_pad, chunk,
              id_offset, n_valid, scores, ids, cand, cand2):
        exact(phi, psi, psi_scale, excl, mask, k, id_offset, n_valid, scores, ids)

    def ivf(phi, psi, psi_scale, excl, ids_global, counts, probe, block_rows,
            k, k_pad, chunk, max_lists, scores, ids, plan, cand, cand2):
        seen.append(phi.shape[0])
        s, i = ref.topk_score_ivf_ref(phi, psi, k, probe_mask=probe,
                                      counts=counts, ids_global=ids_global,
                                      block_rows=block_rows, exclude_ids=excl,
                                      psi_scale=psi_scale)
        scores.copy_(s)
        ids.copy_(i)

    monkeypatch.setattr(kernel, "launch_fused", fused)
    monkeypatch.setattr(kernel, "launch", chain)
    monkeypatch.setattr(kernel, "launch_ivf", ivf)
    monkeypatch.setattr(ops, "on_cuda", lambda *ts: True)
    monkeypatch.setattr(ops, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(ops, "fused_counters", lambda dev: None)
    monkeypatch.setattr(ops, "_key_buffers", lambda *a: (None, None))


@pytest.mark.parametrize("form,excl", [("fused", "ids"), ("fused", "mask"),
                                       ("chain", "mask"), ("chain", None),
                                       ("ivf", "ids")])
def test_wrapper_slices_rows_past_65535_on_the_cpu(monkeypatch, form, excl):
    """The wrapper's slicing past 65,535 rows, with the launches standing in
    as the plain version on each slice (the card runs the kernels in
    ``test_topk_past_65535_rows_*``): two launches of 65,520 and 4,480 rows,
    each given its rows of φ, of the id lists, the mask and the probe
    mask, and writing its rows of the result, equal to one plain call."""
    seen = []
    _fake_launches(monkeypatch, seen)
    rng = np.random.default_rng(39)
    rows, d = 40, 4
    phi = torch.tensor(rng.integers(-3, 4, (MANY_ROWS, d)), dtype=torch.float32)
    psi = torch.tensor(rng.integers(-3, 4, (rows, d)), dtype=torch.float32)
    kw = {}
    if excl == "ids":
        kw["exclude_ids"] = torch.tensor(
            rng.integers(-1, rows, (MANY_ROWS, 3)), dtype=torch.int32)
    elif excl == "mask":
        kw["exclude_mask"] = torch.tensor(rng.random((MANY_ROWS, rows + 8)) < 0.3)[:, 4:4 + rows]
    before = _launch_counts()
    if form == "ivf":
        kw.update(probe_mask=torch.tensor(rng.random((MANY_ROWS, 4)) < 0.5),
                  counts=torch.tensor([10, 7, 0, 10], dtype=torch.int32),
                  ids_global=torch.arange(rows, dtype=torch.int32),
                  block_rows=10)
        s, i = ops.topk_score_ivf(phi, psi, 6, **kw)
        rs, ri = ref.topk_score_ivf_ref(phi, psi, 6, **kw)
    else:
        k = 6 if form == "fused" else 300
        s, i = ops.topk_score(phi, psi, k, id_offset=3, n_valid=rows - 2, **kw)
        rs, ri = ref.topk_score_ref(phi, psi, k, id_offset=3,
                                    n_valid=rows - 2, **kw)
    assert seen == [65_520, MANY_ROWS - 65_520]
    assert torch.equal(i, ri) and torch.equal(s, rs)
    assert _launched(before) == {
        "launches": 2, "launches_chain": 2 if form == "chain" else 0,
        "launches_mask": 2 if excl == "mask" else 0,
        "launches_ivf": 2 if form == "ivf" else 0}


# --------------------------------------------------------------------------
# The sorted segment sum (kernels/segment_sum): the merge-path kernel over
# CSR offsets against its plain version.
# --------------------------------------------------------------------------
def _sorted_layout(case):
    """Row lengths of one layout (all with many slices of the kernel's
    path): a row of 150,000 entries, runs of length-1 rows, a tail of empty
    rows, an nnz that is not a multiple of 4, and a skewed log's rows."""
    rng = np.random.default_rng(60)
    if case == "long_row":
        return np.concatenate([rng.integers(0, 9, 3000), [150_000],
                               rng.integers(0, 9, 3000)])
    if case == "runs_of_one":
        return np.concatenate([np.ones(50_000, np.int64), [0, 0, 7],
                               np.ones(20_000, np.int64)])
    if case == "empty_tail":
        return np.concatenate([rng.integers(1, 40, 5000),
                               np.zeros(30_000, np.int64)])
    if case == "odd_nnz":
        lengths = rng.integers(0, 5, 4001)
        lengths[-1] += (3 - lengths.sum()) % 4  # nnz ≡ 3 (mod 4)
        return lengths
    # "skewed": item degrees of a power-law log, the top row 97,000
    return np.maximum(0, (97_000 / np.arange(1, 20_001)).astype(np.int64)
                      - rng.integers(0, 3, 20_000))


SORTED_CASES = ("long_row", "runs_of_one", "empty_tail", "odd_nnz", "skewed")


def _sorted_inputs(dev, case, n_values, *, lead=0, integers=True):
    """Values (views ``lead`` floats into their storage), offsets, and the
    plain version's sums on the CPU."""
    from repro_torch.kernels.segment_sum.ref import segment_sum_sorted_ref

    lengths = _sorted_layout(case)
    offsets = torch.tensor(np.concatenate([[0], np.cumsum(lengths)]),
                           dtype=torch.int64, device=dev)
    nnz = int(lengths.sum())
    gen = torch.Generator(device=dev).manual_seed(nnz + n_values + lead)
    values = []
    for _ in range(n_values):
        if integers:  # every partial sum exact in fp32
            big = torch.randint(-3, 4, (nnz + lead,), generator=gen,
                                device=dev).float()
        else:
            big = torch.randn((nnz + lead,), generator=gen, device=dev)
        values.append(big[lead:])  # a view ``lead`` floats into its storage
    want = segment_sum_sorted_ref([v.cpu() for v in values], offsets.cpu())
    return values, offsets, want


@pytest.mark.gpu
@pytest.mark.parametrize("n_values", [1, 2, 3, 4])
@pytest.mark.parametrize("case", SORTED_CASES)
def test_segment_sum_sorted_kernel_exact_on_cuda(cuda, case, n_values):
    """Small integers, so every order of summation gives the same bits: the
    kernel equals the plain version exactly, empty rows read 0 in memory
    the allocator last filled with NaN, two launches a call."""
    from repro_torch.kernels.segment_sum import ops as seg_ops

    values, offsets, want = _sorted_inputs(cuda, case, n_values)
    n = offsets.shape[0] - 1
    junk = torch.full((n_values, n), float("nan"), device=cuda)
    del junk  # the result's block, next, held NaN
    before = seg_ops.segment_sum_sorted.launches
    got = seg_ops.segment_sum_sorted(values, offsets)
    torch.cuda.synchronize()
    assert seg_ops.segment_sum_sorted.launches == before + 2
    assert len(got) == n_values
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.gpu
@pytest.mark.parametrize("lead", [0, 1, 2, 3])
@pytest.mark.parametrize("case", ["long_row", "odd_nnz", "skewed"])
def test_segment_sum_sorted_kernel_unaligned_random_repeatable_on_cuda(cuda, case, lead):
    """Random fp32 values that start ``lead`` floats past a 16-byte
    boundary: within 1e-6 of each row's Σ|x| (plus 1e-6) of the sums taken
    in float64 (the kernel's sums are at most ≈ 80 additions deep; a lost or
    doubled entry of the 150,000-entry row moves it by ≈ 7e-6 of Σ|x|),
    and two calls give the same bits."""
    from repro_torch.kernels.segment_sum import ops as seg_ops
    from repro_torch.kernels.segment_sum.ref import segment_sum_sorted_ref

    values, offsets, _ = _sorted_inputs(cuda, case, 4, lead=lead, integers=False)
    assert values[0].data_ptr() % 16 == 4 * lead
    got = seg_ops.segment_sum_sorted(values, offsets)
    again = seg_ops.segment_sum_sorted(values, offsets)
    torch.cuda.synchronize()
    exact = segment_sum_sorted_ref([v.double().cpu() for v in values], offsets.cpu())
    mass = segment_sum_sorted_ref([v.double().abs().cpu() for v in values],
                                  offsets.cpu())
    for g, a, x, m in zip(got, again, exact, mass):
        assert torch.equal(g, a)
        assert bool(((g.cpu().double() - x).abs() <= 1e-6 * m + 1e-6).all())


@pytest.mark.gpu
@pytest.mark.parametrize("n_values", [2, 4])
@pytest.mark.parametrize("lead", [1, 3])
@pytest.mark.parametrize("case", ["long_row", "odd_nnz", "skewed"])
def test_segment_sum_sorted_kernel_same_bits_in_100_launches_on_cuda(cuda, case, lead,
                                                                     n_values):
    """100 launches over one unaligned layout give the same bits, each into
    memory the allocator last filled with NaN: a row that a launch failed
    to write, or summed in another order, shows."""
    from repro_torch.kernels.segment_sum import ops as seg_ops

    values, offsets, _ = _sorted_inputs(cuda, case, n_values, lead=lead, integers=False)
    n = offsets.shape[0] - 1
    first = torch.stack(seg_ops.segment_sum_sorted(values, offsets))
    assert bool(torch.isfinite(first).all())
    differ = 0
    for _ in range(100):
        junk = torch.full((n_values, n), float("nan"), device=cuda)
        del junk  # the result's block, next, held NaN
        got = torch.stack(seg_ops.segment_sum_sorted(values, offsets))
        differ += int(not torch.equal(got, first))
    assert differ == 0, f"{differ} of 100 launches differ from the first"


@pytest.mark.gpu
def test_segment_sum_sorted_kernel_edges_on_cuda(cuda):
    """No entries at all (every row 0), one row, no rows (no launch), and
    what the kernel does not take: a strided or float64 vector, int32
    offsets."""
    from repro_torch.kernels.segment_sum import ops as seg_ops

    before = seg_ops.segment_sum_sorted.launches
    empty = torch.zeros(0, device=cuda)
    got, = seg_ops.segment_sum_sorted([empty], torch.zeros(7, dtype=torch.int64,
                                                            device=cuda))
    assert torch.equal(got, torch.zeros(6, device=cuda))
    v = torch.arange(10, dtype=torch.float32, device=cuda)
    got = seg_ops.segment_sum_sorted([v, 2 * v], torch.tensor([0, 10], device=cuda))
    assert [float(g) for g in torch.cat(got)] == [45.0, 90.0]
    mid = seg_ops.segment_sum_sorted.launches
    assert mid == before + 4
    none, = seg_ops.segment_sum_sorted([empty], torch.zeros(1, dtype=torch.int64,
                                                             device=cuda))
    assert none.shape == (0,) and seg_ops.segment_sum_sorted.launches == mid
    offsets = torch.tensor([0, 5, 10], device=cuda)
    with pytest.raises(ValueError, match="contiguous float32"):
        seg_ops.segment_sum_sorted([torch.zeros(20, device=cuda)[::2]], offsets)
    with pytest.raises(ValueError, match="contiguous float32"):
        seg_ops.segment_sum_sorted([v.double()], offsets)
    with pytest.raises(ValueError, match="int64"):
        seg_ops.segment_sum_sorted([v], offsets.int())


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["mf", "tucker"])
def test_mf_epoch_sums_by_the_kernel_not_index_add_on_cuda(cuda, model):
    """A tiny flat epoch on the card sums the one-hot column sweep by the
    kernel: each column's two sums on a side are one call (two launches).
    ``mf.epoch`` runs it on both sides, ``tucker.epoch`` on the item side,
    2·k3 launches (its mode sweeps sum in ``kernels/tucker_mode``); neither
    launches an ``aten::index_add_``. The epoch matches the same epoch on
    the CPU."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.models import mf, tucker
    from repro_torch.kernels.segment_sum import ops as seg_ops
    from repro_torch.sparse.interactions import build_interactions

    rng = np.random.default_rng(61)
    n_ctx, n_items, k, nnz = 300, 120, 8, 4000
    cells = rng.choice(n_ctx * n_items, nnz, replace=False)
    w0 = (0.1 * rng.normal(size=(n_ctx, k))).astype(np.float32)
    h0 = (0.1 * rng.normal(size=(n_items, k))).astype(np.float32)
    hp = mf.MFHyperParams(k=k)
    t_hp = tucker.TuckerHyperParams(k1=3, k2=2, k3=4, alpha0=0.3, l2=0.05,
                                    l2_core=0.02)
    t0 = [(0.3 * rng.normal(size=s)).astype(np.float32)
          for s in ((40, 3), (6, 2), (30, 4), (3, 2, 4))]
    out = {}
    for dev in ("cpu", cuda):
        if model == "mf":
            data = build_interactions(cells // n_items, cells % n_items, np.ones(nnz),
                                      np.full(nnz, 3.0), n_ctx, n_items, device=dev)
            params = mf.params_from_numpy(w0, h0, device=dev)
            e = mf.residuals(params, data)

            def step():
                return mf.epoch(params, data, e, hp)
        else:
            tc, data = _tensor_problem(dev)
            params = tucker.params_from_numpy(*t0, device=dev)
            e = tucker.residuals(params, tc, data)

            def step():
                return tucker.epoch(params, tc, data, e, t_hp)
        before = seg_ops.segment_sum_sorted.launches
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            out[str(dev)] = step()
        if dev == cuda:
            torch.cuda.synchronize()
            launches = seg_ops.segment_sum_sorted.launches - before
            assert launches == (2 * 2 * k if model == "mf" else 2 * t_hp.k3)
            names = {ev.key for ev in prof.key_averages()}
            assert "aten::index_add_" not in names, sorted(names)
    (pc, ec), (pg, eg) = out["cpu"], out[str(cuda)]
    for a, b in (*zip(pc, pg), (ec, eg)):
        torch.testing.assert_close(b.cpu(), a, rtol=1e-4, atol=1e-5)
