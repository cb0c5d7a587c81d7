"""The numbers that decide ``correct``, each from the program's outputs and
the reference's, both after the same epochs from the same start θ_0.

  loss_gap.<t>    |L(θ_P) − L(θ_R)| / L(θ_R) after epoch t, L the
                  reference's objective (Lemma 1) evaluated in float64
  norm_gap.<t>    after epoch t, the worst leaf's |‖θ_P − θ_0‖ −
                  ‖θ_R − θ_0‖|, the gap of the two changes' norms, over
                  the larger of that leaf's reference change and the
                  median leaf's
  change_gap.<t>  the same worst leaf's ‖θ_P − θ_R‖ over the same
                  denominator
  resid_gap.<t>   ‖e_P − e_R‖ / ‖e_R‖ of the carried residuals on the
                  observed pairs after epoch t

A workload's ``checks`` names the numbers it compares, each with its
limit; the others are reported beside them.

Leaves whose reference change, as a root mean square over the leaf's
entries, is under a thousandth of the median leaf's are left out: they
move by rounding alone. (By the mean square, a scalar that moves, such as
FM's global bias, is not taken for one.)
"""
from __future__ import annotations

import statistics

import torch

KEEP_BELOW_MEDIAN = 1e-3


def _f64(t, device):
    return t.to(device=device, dtype=torch.float64)


def leaf_gaps(prog: dict, ref: dict, theta0: dict, device) -> tuple:
    """(norm gap, change gap, {leaf: change gap}) over one epoch's leaves."""
    d_ref, d_diff, d_prog, rms = {}, {}, {}, {}
    for name in ref:
        r, p, z = (_f64(x[name], device) for x in (ref, prog, theta0))
        d_ref[name] = float(torch.linalg.vector_norm(r - z))
        d_prog[name] = float(torch.linalg.vector_norm(p - z))
        d_diff[name] = float(torch.linalg.vector_norm(p - r))
        rms[name] = d_ref[name] / max(1, r.numel()) ** 0.5
    med = statistics.median(d_ref.values())
    kept = [n for n in d_ref if rms[n] >= KEEP_BELOW_MEDIAN * statistics.median(rms.values())]
    per_leaf = {n: d_diff[n] / max(d_ref[n], med) for n in kept}
    norm = max(abs(d_prog[n] - d_ref[n]) / max(d_ref[n], med) for n in kept)
    return norm, max(per_leaf.values()), per_leaf


def rel_diff(a, b, device) -> float:
    a, b = _f64(a, device), _f64(b, device)
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def compare(snaps: list, resids: list, theta0: dict, reference, device) -> tuple:
    """``snaps[t-1]`` and ``resids[t-1]`` are the program's leaves and
    residuals after epoch t; ``reference`` is stepped here alongside.
    Returns ({number: value}, {reported only: value})."""
    out, info = {}, {}
    for t, (prog, resid) in enumerate(zip(snaps, resids), start=1):
        reference.epoch()
        ref = reference.leaves()
        l_ref = reference.objective(ref)
        out[f"loss_gap.{t}"] = abs(reference.objective(prog) - l_ref) / abs(l_ref)
        out[f"norm_gap.{t}"], out[f"change_gap.{t}"], per_leaf = leaf_gaps(
            prog, ref, theta0, device)
        out[f"resid_gap.{t}"] = rel_diff(resid, reference.residual(), device)
        info[f"loss.{t}"] = l_ref
        info.update({f"leaf.{t}.{n}": v for n, v in per_leaf.items()})
    return out, info
