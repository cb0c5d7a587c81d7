"""The port's checkpointer and trainer (``repro_torch.checkpoint``,
``repro_torch.train.trainer``): the reference's six cases on the port
(roundtrip, retention, corruption, tmp dirs, structure mismatch, trainer
resume), the reference's on-disk layout, and a checkpoint written by
either package restored in the other, for ``MFParams`` and for a
``TrainState`` with ``sgd``, bit for bit."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JCheckpointer
from repro.core.models import mf as jmf
from repro.optim import sgd as jsgd
from repro.train import train_step as jtrain_step
from repro_torch.checkpoint import Checkpointer
from repro_torch.core.models import mf
from repro_torch.optim import base, sgd
from repro_torch.train.train_step import build_train_step, init_state
from repro_torch.train.trainer import Trainer

torch.set_num_threads(1)


def _state():
    return {
        "params": {"w": torch.arange(6.0).reshape(2, 3), "b": torch.ones((3,))},
        "step": torch.tensor(7, dtype=torch.int32),
    }


def _leaves_equal(got, want):
    g, w = base.tree_leaves(got), base.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.dtype == b.dtype
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    state = _state()
    ck.save(7, state, blocking=True)
    _leaves_equal(ck.restore(7, state), state)


def test_retention_and_latest(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    state = _state()
    for s in (1, 2, 3, 4):
        ck.save(s, state, blocking=True)
    assert ck.all_steps() == [3, 4]
    assert ck.latest_step() == 4


def test_async_save_snapshots_state(tmp_path):
    """save() copies the state before returning: changing it afterwards
    does not reach the files."""
    ck = Checkpointer(str(tmp_path))
    state = _state()
    ck.save(1, state)
    state["params"]["w"].add_(100.0)
    ck.wait()
    torch.testing.assert_close(ck.restore(1, _state())["params"]["w"],
                               torch.arange(6.0).reshape(2, 3))


def test_corruption_detected(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=3)
    state = _state()
    ck.save(1, state, blocking=True)
    d = os.path.join(str(tmp_path), "step_0000000001")
    fname = json.load(open(os.path.join(d, "manifest.json")))["leaves"][0]["file"]
    with open(os.path.join(d, fname), "r+b") as f:
        f.seek(60)
        f.write(b"\xde\xad")
    with pytest.raises(IOError):
        ck.restore(1, state)


def test_tmp_dirs_ignored(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=3)
    os.makedirs(os.path.join(str(tmp_path), "step_0000000009.tmp"))
    assert ck.all_steps() == []
    # a step dir without manifest (crash before fsync) is also invalid
    os.makedirs(os.path.join(str(tmp_path), "step_0000000010"))
    assert ck.all_steps() == []
    assert ck.restore_latest(_state()) == (None, None)


def test_structure_mismatch_rejected(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _state(), blocking=True)
    with pytest.raises(ValueError):
        ck.restore(1, {"params": {"w": torch.zeros((2, 3))}})
    with pytest.raises(ValueError, match="shape"):
        bad = _state()
        bad["params"]["w"] = torch.zeros((3, 2))
        ck.restore(1, bad)
    # shardings=: a world of one on the CPU, each leaf placed on its
    # sharding bit for bit; a sharding that is not one is refused by name
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.core.models.mf_dist import make_shard_mesh
    from repro_torch.launch.sharding import P, named
    from repro_torch.runtime.collectives import world_of_one

    with world_of_one("gloo"):
        mesh = make_shard_mesh(1, device_type="cpu")
        specs = {"params": {"w": P("shards", None), "b": P(None)}, "step": None}
        got = ck.restore(1, _state(), shardings=named(mesh, specs))
        assert isinstance(got["params"]["w"], DTensor)
        assert got["params"]["w"].placements == (Shard(0),)
        assert got["params"]["b"].placements == (Replicate(),)
        assert not isinstance(got["step"], DTensor)
        _leaves_equal({"params": {k: v.full_tensor()
                                  for k, v in got["params"].items()},
                       "step": got["step"]}, _state())
        with pytest.raises(ValueError, match="shardings= must be a tree"):
            ck.restore(1, _state(), shardings=object())
        with pytest.raises(TypeError, match="NamedSharding"):
            ck.restore(1, _state(), shardings={
                "params": {"w": object(), "b": None}, "step": None})


def test_bfloat16_leaves_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path))
    state = {"p": torch.randn(4, 3).bfloat16(), "s": torch.tensor(2)}
    ck.save(3, state, blocking=True)
    manifest = json.load(open(tmp_path / "step_0000000003" / "manifest.json"))
    assert [e["dtype"] for e in manifest["leaves"]] == ["bfloat16", "int64"]
    _leaves_equal(ck.restore(3, state), state)


def _trainer_run(n_steps, ck):
    def loss(p, b):
        return torch.sum((p - b["t"]) ** 2)

    opt = sgd(0.1)
    step_fn = build_train_step(loss, opt)

    def data():
        while True:
            yield {"t": torch.tensor([1.0, 2.0])}

    state = init_state(torch.zeros(2), opt)
    logs = []
    tr = Trainer(step_fn, state, data(), checkpointer=ck, ckpt_every=2,
                 log_every=1000, log_fn=logs.append)
    return tr.run(n_steps), logs


def test_trainer_resume(tmp_path):
    """Kill the trainer after 6 steps, restart, verify it resumes and the
    final state equals an uninterrupted 10-step run."""
    ck = Checkpointer(str(tmp_path / "a"), keep=5)
    _trainer_run(6, ck)                       # "crash" at step 6
    resumed, logs = _trainer_run(10, ck)      # restart, resumes from 6
    assert logs == ["[trainer] resumed from step 6"]
    straight, _ = _trainer_run(10, Checkpointer(str(tmp_path / "b"), keep=5))
    torch.testing.assert_close(resumed.params, straight.params, rtol=0, atol=0)
    assert int(resumed.step) == 10


def _mf(seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(5, 3)).astype(np.float32),
            rng.normal(size=(4, 3)).astype(np.float32))


def _manifests(d1, d2, step):
    m1 = json.load(open(os.path.join(d1, f"step_{step:010d}", "manifest.json")))
    m2 = json.load(open(os.path.join(d2, f"step_{step:010d}", "manifest.json")))
    return m1, m2


def test_mf_params_restore_across_packages(tmp_path):
    w, h = _mf(0)
    port, ref = str(tmp_path / "port"), str(tmp_path / "ref")
    Checkpointer(port).save(4, mf.params_from_numpy(w, h, device="cpu"), blocking=True)
    JCheckpointer(ref).save(4, jmf.MFParams(jnp.asarray(w), jnp.asarray(h)),
                            blocking=True)
    m_port, m_ref = _manifests(port, ref, 4)
    assert m_port == m_ref           # same paths, files, dtypes, shapes, bytes
    # the port reads the reference's checkpoint ...
    target = mf.params_from_numpy(np.zeros_like(w), np.zeros_like(h), device="cpu")
    got = Checkpointer(ref).restore(4, target)
    assert isinstance(got, mf.MFParams)
    np.testing.assert_array_equal(got.w.numpy(), w)
    np.testing.assert_array_equal(got.h.numpy(), h)
    # ... and the reference reads the port's
    jtarget = jmf.MFParams(jnp.zeros_like(w), jnp.zeros_like(h))
    step, want = JCheckpointer(port).restore_latest(jtarget)
    assert step == 4
    np.testing.assert_array_equal(np.asarray(want.w), w)
    np.testing.assert_array_equal(np.asarray(want.h), h)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_train_state_restore_across_packages(tmp_path, momentum):
    """A ``TrainState`` over ``MFParams`` with ``sgd`` (with momentum: the
    optimizer state is a tree too), trained 3 steps in each package from
    the same numpy start, saved by one and restored by the other; the
    restored run's next step equals the writer's."""
    w, h = _mf(1)
    x = np.random.default_rng(2).normal(size=(5, 4)).astype(np.float32)

    def loss(p, b):
        return torch.mean((p.w @ p.h.T - b["x"]) ** 2)

    def jloss(p, b):
        return jnp.mean((p.w @ p.h.T - b["x"]) ** 2)

    opt, jopt = sgd(0.5, momentum=momentum), jsgd(0.5, momentum=momentum)
    step = build_train_step(loss, opt)
    jstep = jtrain_step.build_train_step(jloss, jopt)
    s = init_state(mf.params_from_numpy(w, h, device="cpu"), opt)
    js = jtrain_step.init_state(jmf.MFParams(jnp.asarray(w), jnp.asarray(h)), jopt)
    batch, jbatch = {"x": torch.tensor(x)}, {"x": jnp.asarray(x)}
    for _ in range(3):
        s, _ = step(s, batch)
        js, _ = jstep(js, jbatch)
    port, ref = str(tmp_path / "port"), str(tmp_path / "ref")
    Checkpointer(port).save(3, s, blocking=True)
    JCheckpointer(ref).save(3, js, blocking=True)
    m_port, m_ref = _manifests(port, ref, 3)
    assert [(e["path"], e["file"], e["dtype"], e["shape"]) for e in m_port["leaves"]] == \
        [(e["path"], e["file"], e["dtype"], e["shape"]) for e in m_ref["leaves"]]

    fresh = init_state(mf.params_from_numpy(np.zeros_like(w), np.zeros_like(h),
                                            device="cpu"), opt)
    got = Checkpointer(ref).restore(3, fresh)           # reference → port
    for a, b in zip(base.tree_leaves(got), jax.tree_util.tree_leaves(js)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    jfresh = jtrain_step.init_state(
        jmf.MFParams(jnp.zeros_like(w), jnp.zeros_like(h)), jopt)
    jgot = JCheckpointer(port).restore(3, jfresh)       # port → reference
    for a, b in zip(jax.tree_util.tree_leaves(jgot), base.tree_leaves(s)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    # the run goes on from either side's restore as from the writer's state
    s_next, _ = step(got, batch)
    s_ref, _ = step(s, batch)
    _leaves_equal(s_next, s_ref)
