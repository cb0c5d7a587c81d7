"""The port's serve driver end to end, its package boundary, its entry
points' device policy, and its CUDA kernel against the plain version.

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
