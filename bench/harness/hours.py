"""An hour of the day for each interaction, by a traffic mix's ``hours``
law, for configurations whose context is a pair (user, hour bucket).

The law (``traffic["hours"]``): each user gets a home hour, uniform over
the configuration's ``n_buckets``; each interaction's hour is home +
round(N(0, ``sigma``²)) mod ``n_buckets``. One generator seeded by the
law's ``seed`` draws the home hours by user label, then the offsets in
the log's (ctx, item) order, so the same inputs give the same hours.

:func:`make_inputs` is the generator's ``make_inputs`` plus those hours;
both the program and the reference read them from ``Inputs.hour`` and
build the (user, hour) pair list each in its own way.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from bench.harness import traffic

# the generator's own, taken at import: ``tools/control_hours`` puts
# :func:`make_inputs` in its place for the time of a reading
_log_inputs = traffic.make_inputs


@dataclasses.dataclass
class HourlyInputs(traffic.Inputs):
    """``Inputs`` with ``hour`` (nnz,) int64, in the (ctx, item) order of
    ``ctx`` and ``item``, and the buckets' count."""

    hour: np.ndarray = None
    n_buckets: int = 0


def draw(inputs, n_buckets: int, law: dict) -> np.ndarray:
    """The hours of ``inputs``' interactions under ``law``."""
    rng = np.random.default_rng(int(law["seed"]))
    home = rng.integers(0, n_buckets, inputs.n_ctx)
    offset = np.rint(rng.normal(0.0, float(law["sigma"]), inputs.nnz)).astype(np.int64)
    return (home[np.asarray(inputs.ctx, np.int64)] + offset) % n_buckets


def make_inputs(config: dict, mix: dict, seed: int, device):
    """The cell's inputs; with the hours where the mix has an ``hours``
    law, else the generator's inputs as they are."""
    inputs = _log_inputs(config, mix, seed, device)
    if "hours" not in mix:
        return inputs
    n_buckets = int(config["n_buckets"])
    fields = {f.name: getattr(inputs, f.name) for f in dataclasses.fields(traffic.Inputs)}
    return HourlyInputs(**fields, hour=draw(inputs, n_buckets, mix["hours"]),
                        n_buckets=n_buckets)
