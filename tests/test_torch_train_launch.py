"""The port's training CLI (``python -m repro_torch.launch.train``) beside
the JAX package's: the same report lines (numbers masked: the factors come
from different generators), and its loop's objective trajectory held
against the reference's loop from the same numpy factors at ``mf``'s
tolerances (rtol 5e-4, atol 5e-5); the same epochs as ``Trainer`` steps
with a ``Checkpointer``, resumed, equal to an uninterrupted run."""
import os
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke_config
from repro.core.models import mf as jmf
from repro.data.synthetic import make_implicit_dataset as jmake
from repro.sparse.interactions import build_interactions as jbuild
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_smoke_config
from repro_torch.core.models import mf
from repro_torch.data.synthetic import make_implicit_dataset
from repro_torch.launch import train
from repro_torch.sparse.interactions import build_interactions
from repro_torch.train.train_step import TrainState
from repro_torch.train.trainer import Trainer

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
EPOCH_RTOL, EPOCH_ATOL = 5e-4, 5e-5


def _cli(module, *args):
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}:{os.environ.get('PYTHONPATH', '')}",
               OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-m", module, *args], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=300)


def _template(line: str) -> str:
    return re.sub(r"-?\d+(\.\d+)?", "#", line)


@pytest.mark.parametrize("arch", ["icd-mf", "icd-fm"])
def test_cli_prints_the_reference_lines(arch):
    args = ("--arch", arch, "--smoke", "--steps", "10", "--seed", "1")
    port = _cli("repro_torch.launch.train", *args, "--device", "cpu")
    assert port.returncode == 0, port.stdout[-1500:] + port.stderr[-1500:]
    ref = _cli("repro.launch.train", *args)
    assert ref.returncode == 0, ref.stdout[-1500:] + ref.stderr[-1500:]
    got, want = port.stdout.splitlines(), ref.stdout.splitlines()
    assert got[0] == want[0] == f"[train] arch={arch} smoke=True"
    assert [_template(x) for x in got] == [_template(x) for x in want]
    assert len(got) == 3


def test_cli_refuses_what_is_not_there():
    with pytest.raises(KeyError):
        train.main(["--arch", "gpt-2", "--smoke", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.main(["--arch", "icd-mf", "--smoke", "--steps", "1"])


def _smoke_data(arch, seed):
    cfg = get_smoke_config(arch)
    jcfg = jget_smoke_config(arch)
    assert cfg == type(cfg)(**jcfg.__dict__)
    ds = make_implicit_dataset(n_users=cfg.n_ctx, n_items=cfg.n_items, seed=seed)
    ev = ds.events
    np.testing.assert_array_equal(ev, jmake(n_users=cfg.n_ctx, n_items=cfg.n_items,
                                            seed=seed).events)
    args = (ev[:, 0], ev[:, 1], np.ones(len(ev)), np.full(len(ev), cfg.alpha0 + 2.0),
            cfg.n_ctx, cfg.n_items)
    rng = np.random.default_rng(seed)
    w = 0.1 * rng.normal(size=(cfg.n_ctx, cfg.k)).astype(np.float32)
    h = 0.1 * rng.normal(size=(cfg.n_items, cfg.k)).astype(np.float32)
    return (cfg, build_interactions(*args, alpha0=cfg.alpha0, device="cpu"),
            jbuild(*args, alpha0=cfg.alpha0), w, h)


@pytest.mark.parametrize("arch", ["icd-mf", "icd-fm"])
def test_loop_trajectory_equals_reference(arch):
    """train_loop against the reference's ``_icd_main`` loop (one-epoch
    ``mf.fit`` calls, the objective every 5 epochs), from the same numpy
    factors on the same data."""
    cfg, data, jdata, w, h = _smoke_data(arch, 3)
    hp = mf.MFHyperParams(k=cfg.k, alpha0=cfg.alpha0, l2=cfg.l2)
    jhp = jmf.MFHyperParams(k=cfg.k, alpha0=cfg.alpha0, l2=cfg.l2)
    lines = []
    params, objs = train.train_loop(mf.params_from_numpy(w, h, device="cpu"),
                                    data, hp, 15, log=lines.append)
    jparams, jobjs = jmf.MFParams(jnp.asarray(w), jnp.asarray(h)), []
    for ep in range(15):
        jparams = jmf.fit(jparams, jdata, jhp, 1)
        if (ep + 1) % 5 == 0:
            jobjs.append((ep + 1, float(jmf.objective(jparams, jdata, jhp))))
    assert [e for e, _ in objs] == [e for e, _ in jobjs] == [5, 10, 15]
    np.testing.assert_allclose([o for _, o in objs], [o for _, o in jobjs],
                               rtol=EPOCH_RTOL)
    assert all(b < a for (_, a), (_, b) in zip(objs, objs[1:]))
    assert lines == [f"[icd] epoch {e} objective {o:.4f}" for e, o in objs]
    for a, b in zip(params, jparams):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=EPOCH_RTOL,
                                   atol=EPOCH_ATOL)


def test_trainer_resume_equals_uninterrupted_loop(tmp_path):
    """The loop's epochs as ``Trainer`` steps with a ``Checkpointer``:
    stop after epoch 2, resume a new trainer from the checkpoint, finish at
    5 — bit for bit the uninterrupted run and ``train_loop``."""
    cfg, data, _, w, h = _smoke_data("icd-mf", 4)
    hp = mf.MFHyperParams(k=cfg.k, alpha0=cfg.alpha0, l2=cfg.l2)
    step = train.epoch_step(data, hp)

    def trainer(ck):
        state = TrainState(mf.params_from_numpy(w, h, device="cpu"), None,
                           torch.zeros((), dtype=torch.int32))
        return Trainer(step, state, iter(lambda: {}, None), checkpointer=ck,
                       ckpt_every=1, log_every=1000, log_fn=lambda s: None)

    ck = Checkpointer(str(tmp_path / "a"), keep=2)
    trainer(ck).run(2)
    tr = trainer(ck)
    resumed = tr.run(5)
    assert len(tr.metrics_history) == 3 and int(resumed.step) == 5
    straight = trainer(Checkpointer(str(tmp_path / "b"))).run(5)
    looped, _ = train.train_loop(mf.params_from_numpy(w, h, device="cpu"), data,
                                 hp, 5, log=lambda s: None)
    for a, b, c in zip(resumed.params, straight.params, looped):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert ck.all_steps() == [4, 5]
