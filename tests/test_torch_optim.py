"""The port's optimizers, schedules, clipping, mixed precision and train
step held against the JAX package: every optimizer 10 steps on the same
gradients to rtol 1e-5, the schedules at the same steps, and
``build_train_step`` with and without microbatches against the
reference's step from the same numpy inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.optim.mixed import mixed_precision as jmixed
from repro.train import train_step as jtrain_step
from repro_torch import optim
from repro_torch.optim import base
from repro_torch.optim.mixed import mixed_precision
from repro_torch.train import train_step

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-7


def _params(rng):
    return {"a": rng.normal(size=(3,)).astype(np.float32),
            "b": rng.normal(size=(4, 5)).astype(np.float32),
            "c": [rng.normal(size=(2, 3, 4)).astype(np.float32)]}


def _torch(tree):
    return base.tree_map(lambda x: torch.tensor(np.asarray(x)), tree)


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _assert_tree_close(got, want, rtol=RTOL, atol=ATOL):
    g_leaves = base.tree_leaves(got)
    w_leaves = jax.tree_util.tree_leaves(want)
    assert len(g_leaves) == len(w_leaves)
    for g, w in zip(g_leaves, w_leaves):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32),
                                   rtol=rtol, atol=atol)


OPTIMIZERS = {
    "sgd": (lambda m: m.sgd(0.1)),
    "sgd_momentum": (lambda m: m.sgd(0.05, momentum=0.9)),
    "sgd_nesterov": (lambda m: m.sgd(0.05, momentum=0.9, nesterov=True)),
    "adamw": (lambda m: m.adamw(0.01, weight_decay=0.1)),
    "adamw_schedule": (lambda m: m.adamw(m.linear_warmup_cosine(0.1, 3, 10))),
    "adafactor": (lambda m: m.adafactor()),
    "adafactor_lr": (lambda m: m.adafactor(0.05)),
    "sgd_cosine": (lambda m: m.sgd(m.cosine_decay(0.2, 8))),
    "sgd_constant": (lambda m: m.sgd(m.constant(0.1))),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_ten_steps_equal_reference(name):
    rng = np.random.default_rng(0)
    params = _params(rng)
    grads = [_params(rng) for _ in range(10)]
    opt, jopt = OPTIMIZERS[name](optim), OPTIMIZERS[name](joptim)
    p, jp = _torch(params), _jax(params)
    s, js = opt.init(p), jopt.init(jp)
    for g in grads:
        u, s = opt.update(_torch(g), s, p)
        ju, js = jopt.update(_jax(g), js, jp)
        _assert_tree_close(u, ju)
        p, jp = optim.apply_updates(p, u), joptim.apply_updates(jp, ju)
        _assert_tree_close(p, jp)
    assert int(s["step"]) == int(js["step"]) == 10


@pytest.mark.parametrize("inner", ["sgd_momentum", "adamw"])
def test_mixed_precision_equals_reference(inner):
    rng = np.random.default_rng(1)
    params = _params(rng)
    p = base.tree_map(lambda x: x.bfloat16(), _torch(params))
    jp = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), _jax(params))
    opt = mixed_precision(OPTIMIZERS[inner](optim))
    jopt = jmixed(OPTIMIZERS[inner](joptim))
    s, js = opt.init(p), jopt.init(jp)
    for _ in range(10):
        g = _params(rng)
        u, s = opt.update(base.tree_map(lambda x: x.bfloat16(), _torch(g)), s, p)
        ju, js = jopt.update(jax.tree_util.tree_map(
            lambda x: x.astype(jnp.bfloat16), _jax(g)), js, jp)
        _assert_tree_close(s["master"], js["master"])
        p, jp = optim.apply_updates(p, u), joptim.apply_updates(jp, ju)
        assert all(x.dtype == torch.bfloat16 for x in base.tree_leaves(p))
        # bf16 live params: the same rounding of the same fp32 master
        _assert_tree_close(p, jp, rtol=0, atol=0)


@pytest.mark.parametrize("max_norm", [1.0, 100.0])
def test_clip_by_global_norm_equals_reference(max_norm):
    g = _params(np.random.default_rng(2))
    got, norm = optim.clip_by_global_norm(_torch(g), max_norm)
    want, jnorm = joptim.clip_by_global_norm(_jax(g), max_norm)
    _assert_tree_close(got, want)
    assert float(norm) == pytest.approx(float(jnorm), rel=RTOL)
    assert float(optim.global_norm(_torch(g))) == pytest.approx(
        float(joptim.global_norm(_jax(g))), rel=RTOL)


def test_schedules_equal_reference():
    cases = [(optim.linear_warmup_cosine(1.0, 10, 100), joptim.linear_warmup_cosine(1.0, 10, 100)),
             (optim.cosine_decay(2.0, 50, 0.2), joptim.cosine_decay(2.0, 50, 0.2)),
             (optim.constant(0.3), joptim.constant(0.3))]
    for f, jf in cases:
        for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
            got = float(f(torch.tensor(step, dtype=torch.int32)))
            want = float(jf(jnp.int32(step)))
            assert got == pytest.approx(want, rel=RTOL, abs=1e-7), step


def test_tree_paths_and_none_subtrees():
    state = train_step.TrainState({"w": torch.zeros(2), "b": torch.ones(1)},
                                  {"step": torch.tensor(0), "mom": None},
                                  torch.tensor(3))
    paths, leaves, unflatten = base.tree_flatten_with_path(state)
    assert paths == [".params/['b']", ".params/['w']", ".opt/['step']", ".step"]
    back = unflatten(leaves)
    assert isinstance(back, train_step.TrainState) and back.opt["mom"] is None
    with pytest.raises(ValueError):
        base.tree_map(lambda a, b: a, {"x": 1}, {"y": 1})


def _regression(seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(4, 3)).astype(np.float32),
            {"x": rng.normal(size=(8, 4)).astype(np.float32),
             "y": rng.normal(size=(8, 3)).astype(np.float32)})


@pytest.mark.parametrize("n_mb,unroll", [(1, False), (4, False), (4, True), (2, True)])
@pytest.mark.parametrize("opt_name", ["sgd", "adamw"])
def test_train_step_equals_reference(n_mb, unroll, opt_name):
    """A step with ``n_mb`` microbatches equals the reference's step, and
    the loss and gradient do not depend on ``n_mb`` (mean loss)."""
    w, batch = _regression(0)

    def loss(p, b):
        return torch.mean((b["x"] @ p["w"] - b["y"]) ** 2)

    def jloss(p, b):
        return jnp.mean((b["x"] @ p["w"] - b["y"]) ** 2)

    make = {"sgd": lambda m: m.sgd(0.1), "adamw": lambda m: m.adamw(0.05)}[opt_name]
    opt, jopt = make(optim), make(joptim)
    step = train_step.build_train_step(loss, opt, num_microbatches=n_mb,
                                       clip_norm=0.5, unroll_microbatches=unroll)
    jstep = jtrain_step.build_train_step(jloss, jopt, num_microbatches=n_mb,
                                         clip_norm=0.5, unroll_microbatches=unroll)
    s = train_step.init_state(_torch({"w": w}), opt)
    js = jtrain_step.init_state(_jax({"w": w}), jopt)
    one = train_step.build_train_step(loss, opt, clip_norm=0.5)(s, _torch(batch))
    for _ in range(3):
        s, m = step(s, _torch(batch))
        js, jm = jstep(js, _jax(batch))
        _assert_tree_close(s.params, js.params)
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=RTOL)
        assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=RTOL)
    assert int(s.step) == int(js.step) == 3
    s1 = train_step.build_train_step(loss, opt, num_microbatches=n_mb,
                                     clip_norm=0.5)(
        train_step.init_state(_torch({"w": w}), opt), _torch(batch))[0]
    torch.testing.assert_close(s1.params["w"], one[0].params["w"], rtol=1e-5, atol=1e-6)


def test_optimizers_minimize_quadratic():
    """The reference test's claim on the port, through build_train_step."""
    target = torch.tensor([1.0, -2.0, 3.0])

    def loss(p, b):
        return torch.sum((p["x"] - target) ** 2)

    for opt in (optim.sgd(0.1), optim.sgd(0.05, momentum=0.9), optim.adamw(0.1)):
        step = train_step.build_train_step(loss, opt, clip_norm=1e9)
        s = train_step.init_state({"x": torch.zeros(3)}, opt)
        for _ in range(200):
            s, m = step(s, {})
        assert float(m["loss"]) < 1e-2
