"""GPU smoke test of the PyTorch port: build, hold, serve, train, time.

  python3 chip_smoke.py

Needs one CUDA card (an H100 for the numbers to mean what PERF.md says).
Phases, one line each or more:

  1. build every hand-written kernel from ``csrc/`` with nvcc, one nvcc
     per source, all at once, and print each one's ptxas report;
  2. hold the top-K kernel against its plain PyTorch version on the card:
     random fp32 data at the serving driver's shapes (B=16, one 34,000-row
     shard, D=128, K=100, id_offset=34,000, n_valid short of the shard),
     with and without exclude-id lists, plus small-integer cases whose
     scores are exact (ties across blocks, K > n_valid, fully excluded
     rows, ragged chunks and row blocks), where ids must match exactly;
  3. serve 256 requests through ``repro_torch.launch.serve.main`` at full
     icd-mf width (200,000 × 68,000 × k=128, top-100, 2 shards × 2
     replicas, replica (0, 0) killed) and check coverage, the kernel's
     launch count, and 16 users' results against a plain recompute over
     the whole ψ table;
  4. time the top-K kernel, its plain version and
     ``torch.topk(phi @ psi.T)`` (a yardstick the port never calls) with
     CUDA events, beside the card's bound for the same work;
  5. hold the Gram and block-sweep kernels against their plain versions:
     at the full-width dispatch shapes (Gram of 200,000 × 128 and
     68,000 × 128, weighted and not, in small integers, where the sums are
     exact, and in random fp32; the gather sweep on both sides and the
     pre-gathered sweep on the context side), and at small edge cases (k
     not divisible by k_b, row counts off the row tile, all-zero-α rows
     with l2 = 0 and α₀ = 0, padding ids, η ≠ 1, k_b = 1, and a whole
     ``mf_padded`` epoch on the card against the same epoch on the CPU);
  6. train icd-mf at full width on a seeded log (200,000 users × 68,000
     items, k = 128): ``mf_padded.fit`` for 3 epochs with the defaults,
     the objective falling every epoch, the kernels' launches counted;
     then from one start one epoch each with ``psi_dispatch='pregather'``
     and with the segment-sum ``mf.epoch``, held against the gather epoch;
     and a streaming ranking evaluation of the trained model through the
     top-K kernel, held against the plain version;
  7. time the Gram and sweep kernels at the full-width shapes beside their
     plain versions, the library call where one exists, and their bounds;
  8. run the quickstart twin on the card (iCD-MF must beat popularity);
  9. hold the row-patch block sweeps (kernels 4 and 5) against their plain
     versions: both routings at the full-width user-side shape (C =
     200,000, D_pad = 128, k_b = 8, a slab of nnz + 1 rows) in the warp-row
     form, both at the bucket-side shape (C = 24, D_pad = 142,464) in the
     block-row form, and edge cases (C off the row tile, a 4-column tail,
     k_b = 1, η ≠ 1, ids past both ends, all-α = 0 rows with l2 = α₀ = 0,
     the shared-J sweep in the block-row form);
 10. train CtxMF at full width (200,000 users × 24 hour-of-day buckets ×
     68,000 items, k = 128) on phase 6's log with seeded timestamps over
     28 days: 3 ``epoch_padded`` epochs (objective falling, launches
     counted by form), one pregather and one flat epoch from one start
     held against the default one, one profiled epoch, one
     ``dense_context`` epoch, and 16 (user, bucket) queries through the
     top-K kernel against a plain recompute;
 11. Tucker: one ``epoch_padded`` on the same log at k1 = k2 = k3 = 8
     (objective falling), and small PARAFAC and Tucker epochs on the card
     against the same epochs on the CPU;
 12. time the row-patch kernels at both full-width shapes beside their
     plain versions and their bounds;
 13. hold the slab-reduce and residual-patch kernels (kernels 6–9, both ψ
     routings) against their plain versions: at both sides' full-width
     shapes (context C = 200,000, D_pad = 128, n_src = 68,000; item C =
     68,000, D_pad = 1,024, n_src = 200,000; m = 8, the ψ slab a column
     slice of a k = 128 table), at m = 9 and 17 with strided slabs, on rows
     of 20,480 slots and with ids past the slab;
 14. train MFSI at icd-fm width (200,000 contexts over 7 fields, p_ctx =
     336,091, 68,000 items, k = 128) on phase 6's log with a seeded
     context design: 3 ``epoch_padded`` epochs (objective falling, 96
     launches each of the gather slab reduce and residual patch), one
     pregather and one flat epoch from one start held against the default
     one, one profiled epoch, and 16 users' queries through the top-K
     kernel against a plain recompute;
 15. time kernels 6–9 at both sides' full-width shapes beside their plain
     versions, their bounds and, for the pre-gathered forms, one
     ``torch.bmm``/``baddbmm`` over the same tile.

Phase 2 also holds the top-K kernel's large-K path (K = 257, 1,000 and
2,048, K past n_valid) in small integers, exactly.

It then prints the ``kernels`` JSON line, the card's name and power limit,
and, last, ``{"ok": true, "device": {...}}``. Any failed check raises and
the script exits non-zero without that line.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in full fp32

# fp32 scores of the kernel (sequential FMAs over D) against the plain
# version (a cuBLAS product, another summation order): at D=128 and scores
# of magnitude ≲ 40, the two differ by a few ulps of the largest partial sum
RTOL, ATOL = 1e-5, 1e-5
H100_BYTES_PER_S = 3.35e12      # HBM3, SXM data sheet
H100_FP32_FLOPS = 67e12         # fp32 outside the tensor cores
SERVE_SHAPE = dict(b=16, rows=34_000, d=128, k=100)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def ids_agree(s_ref, i_ref, i_got, s_next) -> None:
    """Ids must be equal at every slot whose score is separated from its
    neighbours (and, for the last slot, from the next candidate) by more
    than the score tolerance; inside a near-tie the order may differ."""
    s = s_ref.double().cpu().numpy()
    tol = ATOL + RTOL * np.abs(s)
    ext = np.concatenate([s, s_next.double().cpu().numpy()[:, None]], axis=1)
    gap_prev = np.full(s.shape, np.inf)
    gap_prev[:, 1:] = np.abs(np.diff(s, axis=1))
    gap_next = np.abs(ext[:, 1:] - ext[:, :-1])
    firm = (gap_prev > tol) & (gap_next > tol)
    got, ref = i_got.cpu().numpy(), i_ref.cpu().numpy()
    bad = firm & (got != ref)
    if bad.any():
        r, c = np.argwhere(bad)[0]
        raise AssertionError(f"id mismatch at row {r} slot {c}: kernel "
                             f"{got[r, c]} vs plain {ref[r, c]}")


def check_random(ops, ref, gen, dev, exclude: bool) -> float:
    b, rows, d, k = (SERVE_SHAPE[x] for x in ("b", "rows", "d", "k"))
    phi = torch.randn((b, d), generator=gen, device=dev)
    psi = torch.randn((rows, d), generator=gen, device=dev)
    off, n_valid = rows, rows - 1_000
    eids = None
    if exclude:
        eids = torch.randint(off, off + rows, (b, 32), generator=gen,
                             device=dev, dtype=torch.int32)
        eids[:, 24:] = -1
    s, i = ops.topk_score(phi, psi, k, exclude_ids=eids, id_offset=off,
                          n_valid=n_valid)
    rs, ri = ref.topk_score_ref(phi, psi, k + 1, exclude_ids=eids,
                                id_offset=off, n_valid=n_valid)
    torch.cuda.synchronize()
    torch.testing.assert_close(s, rs[:, :k], rtol=RTOL, atol=ATOL)
    ids_agree(rs[:, :k], ri[:, :k], i, rs[:, k])
    if exclude:
        hit = (i[:, :, None] == eids[:, None, :]).any(-1) & (i >= 0)
        assert not bool(hit.any()), "an excluded id came back"
    return float((s - rs[:, :k]).abs().max())


def check_exact(ops, ref, rng, dev) -> None:
    cases = [  # b, rows, d, k, id_offset, n_valid, excl_l, full_row_excl
        (16, 34_000, 128, 100, 34_000, 33_000, 0, False),   # many cross-block ties
        (16, 34_000, 128, 100, 34_000, 33_000, 40, False),
        (19, 1_001, 16, 37, 5_000, 990, 6, False),           # ragged rows, 2 row blocks
        (5, 60, 8, 100, 0, 50, 0, False),                    # K > n_valid
        (4, 40, 8, 20, 80, 40, 40, True),                    # a fully excluded row
        (3, 700, 4, 256, 0, 700, 0, False),                  # the largest small K
        (16, 34_000, 128, 257, 34_000, 33_000, 0, False),    # large K: the wide merge
        (16, 34_000, 128, 1_000, 34_000, 33_000, 40, False),
        (5, 1_500, 8, 2_048, 0, 1_490, 0, False),            # large K > n_valid
        (7, 2_000, 5, 1, 10, 1_990, 3, False),               # K=1, D % 4 != 0
    ]
    for b, rows, d, k, off, n_valid, excl_l, full in cases:
        phi = torch.tensor(rng.integers(-3, 4, (b, d)), dtype=torch.float32, device=dev)
        psi = torch.tensor(rng.integers(-3, 4, (rows, d)), dtype=torch.float32, device=dev)
        eids = None
        if excl_l:
            e = rng.integers(off - 5, off + rows, (b, excl_l)).astype(np.int32)
            if full:
                e[0] = np.arange(off, off + rows)[:excl_l]
            eids = torch.tensor(e, device=dev)
        s, i = ops.topk_score(phi, psi, k, exclude_ids=eids, id_offset=off,
                              n_valid=n_valid)
        rs, ri = ref.topk_score_ref(phi, psi, k, exclude_ids=eids,
                                    id_offset=off, n_valid=n_valid)
        torch.cuda.synchronize()
        assert torch.equal(i, ri), f"ids differ on integer case {b, rows, d, k}"
        assert torch.equal(s, rs), f"scores differ on integer case {b, rows, d, k}"
        if full:
            assert bool((i[0] == -1).all()) and bool(torch.isneginf(s[0]).all())
        if k > n_valid:
            assert bool((i[:, n_valid:] == -1).all())


def check_serve(ref, serve, argv, dev) -> dict:
    """Drive the serve driver in-process; check coverage and 16 users'
    results against a plain recompute over the whole ψ table."""
    report = serve.main(argv)
    assert report["coverage"] == 1.0, report["coverage"]
    params, k, users = report["params"], report["k"], report["users"]
    pick = np.arange(0, len(users), max(1, len(users) // 16))[:16]
    rs, ri = ref.topk_score_ref(
        params.w[torch.as_tensor(users[pick], device=dev)], params.h, k + 1)
    got_s = torch.stack([torch.as_tensor(report["results"][j].scores)
                         for j in pick]).to(dev)
    got_i = torch.stack([torch.as_tensor(report["results"][j].ids)
                         for j in pick]).to(dev)
    torch.testing.assert_close(got_s, rs[:, :k], rtol=RTOL, atol=ATOL)
    ids_agree(rs[:, :k], ri[:, :k], got_i, rs[:, k])
    return report


def device_ms(fn, n: int = 50) -> float:
    """Median device time of one call: the stream is held by a sleep while
    the host enqueues every call, so host overhead does not show; the
    calls rotate over inputs larger than the 50 MB L2 in total."""
    for _ in range(3):
        fn(0)
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    torch.cuda._sleep(200_000_000)
    for j, (a, b) in enumerate(ev):
        a.record()
        fn(j)
        b.record()
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in ev]))


def kernel_breakdown(fn, n: int = 20) -> str:
    """Device time per call of each CUDA kernel ``fn`` launches, by name,
    from torch.profiler; "not measured" when the profiler sees none."""
    from torch.profiler import ProfilerActivity, profile

    fn(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for j in range(n):
            fn(j)
        torch.cuda.synchronize()
    parts = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0) or 0
        if us > 0 and "topk" in ev.key and ev.device_type.name == "CUDA":
            parts.append(f"{ev.key.split('(')[0]} {us / n / 1e3:.4f} ms")
    return ", ".join(parts) or "not measured"


# ---------------------------------------------------------------------------
# Training slice: Gram and block-sweep kernels, icd-mf at full width.
# ---------------------------------------------------------------------------
# Kernel against plain version on the card: the reference's own kernel-vs-
# oracle tolerance for the sweeps (tests/test_kernels.py) — the two sum
# the D_pad slots in different orders; the Gram in random fp32 to rtol 1e-4
# and an absolute 1e-6 of the largest |J| (200,000-term sums in another
# order), and exactly in small integers, whose sums are exact in any order.
SWEEP_RTOL, SWEEP_ATOL = 2e-5, 2e-6
GRAM_RTOL, GRAM_ATOL_REL = 1e-4, 1e-6
# mf_padded against mf (tests/test_mf_padded.py) and gather against
# pregather (the same kernel program: they must agree to roundoff)
EPOCH_RTOL, EPOCH_ATOL = 3e-4, 3e-5
DISPATCH_RTOL, DISPATCH_ATOL = 1e-6, 1e-7
FULL = dict(n_ctx=200_000, n_items=68_000, k=128, alpha0=1.0, l2=0.1)


def make_full_log(seed: int = 0):
    """The full-width training log: degree per user uniform in [5, 30),
    items drawn with popularity ∝ rank^-0.3 over a seeded permutation
    (the top item near 1,000 events), duplicate pairs dropped, y = 1,
    α = α₀ + 4. Returns (ctx, item) sorted pairs."""
    rng = np.random.default_rng(seed)
    n_ctx, n_items = FULL["n_ctx"], FULL["n_items"]
    deg = rng.integers(5, 30, n_ctx)
    pop = 1.0 / np.arange(1, n_items + 1) ** 0.3
    pop = pop[rng.permutation(n_items)]
    items = rng.choice(n_items, size=int(deg.sum()), p=pop / pop.sum())
    users = np.repeat(np.arange(n_ctx), deg)
    pairs = np.unique(users.astype(np.int64) * n_items + items)
    return pairs // n_items, pairs % n_items


def sweep_inputs(gen, dev, c, d, kb, n_src, k=None, pad_frac=0.5):
    """Random sweep operands at (C, D_pad) with a ``pad_frac`` share of
    padding slots (id 0, α = 0); W and R' are column slices of (C, k)."""
    k = k or kb
    alpha = torch.rand((c, d), generator=gen, device=dev) * 4 + 0.5
    pad = torch.rand((c, d), generator=gen, device=dev) < pad_frac
    alpha[pad] = 0
    ids = torch.randint(0, n_src, (c, d), generator=gen, device=dev,
                        dtype=torch.int32)
    ids[pad] = 0
    e = torch.randn((c, d), generator=gen, device=dev)
    tab = 0.1 * torch.randn((n_src, k), generator=gen, device=dev)
    w = 0.1 * torch.randn((c, k), generator=gen, device=dev)
    r1 = torch.randn((c, kb), generator=gen, device=dev)
    jfull = tab.T @ tab + torch.eye(k, device=dev)
    return dict(alpha=alpha, ids=ids, e=e, tab=tab[:, :kb], w=w[:, :kb],
                r1=r1, j=jfull[:kb, :kb])


def hold_sweep(cs, cr, gen, dev, c, d, kb, n_src, *, gather=True, k=None,
               alpha0=1.0, l2=0.1, eta=1.0, pad_frac=0.5, x=None) -> float:
    """One sweep launch against the plain version on the same inputs;
    returns the largest |error| over W and e."""
    x = x or sweep_inputs(gen, dev, c, d, kb, n_src, k=k, pad_frac=pad_frac)
    kw = dict(alpha0=alpha0, l2=l2, eta=eta)
    if gather:
        rw, re = cr.cd_block_sweep_gather_ref(
            x["tab"], x["ids"], x["alpha"], x["e"], x["w"], x["r1"], x["j"], **kw)
        e = x["e"].clone()
        w, e2 = cs.cd_block_sweep_gather(
            x["tab"], x["ids"], x["alpha"], e, x["w"], x["r1"], x["j"], **kw)
    else:
        psi = cr.gather_psi_blk(x["tab"], x["ids"]).contiguous()
        rw, re = cr.cd_block_sweep_ref(psi, x["alpha"], x["e"], x["w"],
                                       x["r1"], x["j"], **kw)
        e = x["e"].clone()
        w, e2 = cs.cd_block_sweep(psi, x["alpha"], e, x["w"], x["r1"],
                                  x["j"], **kw)
    torch.cuda.synchronize()
    assert e2 is e, "the residual grid must be updated in place"
    assert bool(torch.isfinite(w).all()) and bool(torch.isfinite(e).all())
    torch.testing.assert_close(w, rw, rtol=SWEEP_RTOL, atol=SWEEP_ATOL)
    torch.testing.assert_close(e, re, rtol=SWEEP_RTOL, atol=SWEEP_ATOL)
    return max(float((w - rw).abs().max()), float((e - re).abs().max()))


def hold_gram(gops, gref, gen, dev, rows, k, weighted) -> float:
    """Gram kernel against the plain version: exact on small integers,
    to a tolerance on random fp32; returns the random case's |error|."""
    xi = torch.randint(-3, 4, (rows, k), generator=gen, device=dev).float()
    wi = (torch.randint(0, 3, (rows,), generator=gen, device=dev).float()
          if weighted else None)
    got, ref = gops.gram(xi, weights=wi), gref.gram_ref(xi, wi)
    torch.cuda.synchronize()
    assert torch.equal(got, ref), f"integer Gram differs at {rows}x{k}"
    x = 0.1 * torch.randn((rows, k), generator=gen, device=dev)
    w = (torch.rand((rows,), generator=gen, device=dev) * 4
         if weighted else None)
    got, ref = gops.gram(x, weights=w), gref.gram_ref(x, w)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, rtol=GRAM_RTOL,
                               atol=GRAM_ATOL_REL * float(ref.abs().max()))
    return float((got - ref).abs().max())


def hold_training_kernels(dev) -> dict:
    """Phase 5: every new kernel against its plain version."""
    from repro_torch.kernels.cd_sweep import ops as cs, ref as cr
    from repro_torch.kernels.cd_update import ops as cu, ref as cur
    from repro_torch.kernels.gram import ops as gops, ref as gref

    gen = torch.Generator(device=dev).manual_seed(5)
    n_ctx, n_items = FULL["n_ctx"], FULL["n_items"]
    err = {"gram": 0.0, "cd_block_sweep": 0.0, "cd_block_sweep_gather": 0.0}
    for rows in (n_ctx, n_items):
        for weighted in (False, True):
            err["gram"] = max(err["gram"], hold_gram(gops, gref, gen, dev,
                                                     rows, 128, weighted))
    for rows, k in ((7, 16), (1000, 12), (130, 130), (0, 8), (33, 1)):
        hold_gram(gops, gref, gen, dev, rows, k, rows % 2 == 1)
    # full-width dispatch shapes: context side (D_pad 128) and item side
    # (D_pad 1,024, the 1,000-event head of the log)
    err["cd_block_sweep_gather"] = max(
        hold_sweep(cs, cr, gen, dev, n_ctx, 128, 8, n_items, k=128,
                   pad_frac=0.85),
        hold_sweep(cs, cr, gen, dev, n_items, 1024, 8, n_ctx, k=128,
                   pad_frac=0.95))
    err["cd_block_sweep"] = hold_sweep(cs, cr, gen, dev, n_ctx, 128, 8,
                                       n_items, gather=False, k=128,
                                       pad_frac=0.85)
    # edge cases: C off the row tile, D_pad off the warp width, a 4-column
    # tail block, η ≠ 1, k_b = 1 of a wider table, out-of-range ids clipped
    for c, d, kb, k, eta in ((1001, 40, 8, 12, 1.0), (1001, 40, 4, 12, 0.7),
                             (13, 200, 1, 5, 0.5), (9, 33, 3, 3, 1.3)):
        for gather in (True, False):
            hold_sweep(cs, cr, gen, dev, c, d, kb, 50, gather=gather, k=k,
                       eta=eta)
    x = sweep_inputs(gen, dev, 64, 128, 8, 30)
    x["ids"][:, :5] = torch.tensor([-7, 29, 30, 1000, -1], dtype=torch.int32,
                                   device=dev)
    hold_sweep(cs, cr, gen, dev, 64, 128, 8, 30, x=x)
    # all-zero-α rows with l2 = 0 and α₀ = 0: the 1e-12 clamp, Δ = 0
    x = sweep_inputs(gen, dev, 40, 128, 8, 30)
    x["alpha"][:10] = 0
    w_before = x["w"].clone()
    hold_sweep(cs, cr, gen, dev, 40, 128, 8, 30, x=x, alpha0=0.0, l2=0.0)
    e = x["e"].clone()
    w, _ = cs.cd_block_sweep_gather(x["tab"], x["ids"], x["alpha"], e,
                                    x["w"], x["r1"], x["j"], alpha0=0.0, l2=0.0)
    assert torch.equal(w[:10], w_before[:10]), "an empty row moved"
    # cd_column_update is the k_b = 1 launch of the block-sweep kernel
    x = sweep_inputs(gen, dev, 300, 128, 1, 40)
    psi = cr.gather_psi_blk(x["tab"], x["ids"])[:, 0, :].contiguous()
    before = cs.cd_block_sweep.launches
    rw, re = cur.cd_column_update_ref(psi, x["alpha"], x["e"], x["w"][:, 0],
                                      x["r1"][:, 0], x["j"][0, 0], alpha0=1.0,
                                      l2=0.1)
    w, e = cu.cd_column_update(psi, x["alpha"], x["e"].clone(), x["w"][:, 0],
                               x["r1"][:, 0], x["j"][0, 0], alpha0=1.0, l2=0.1)
    torch.cuda.synchronize()
    assert cs.cd_block_sweep.launches == before + 1
    torch.testing.assert_close(w, rw, rtol=SWEEP_RTOL, atol=SWEEP_ATOL)
    torch.testing.assert_close(e, re, rtol=SWEEP_RTOL, atol=SWEEP_ATOL)
    # a whole fused epoch on the card against the same epoch on the CPU
    # (plain versions), k = 12 with block_k 8 (a tail of 4), 1 and 0
    for hpkw in (dict(block_k=8), dict(block_k=8, psi_dispatch="pregather"),
                 dict(block_k=1), dict(block_k=0, eta=0.8)):
        small_epoch_on_card_vs_cpu(dev, hpkw)
    return err


def small_epoch_on_card_vs_cpu(dev, hpkw) -> None:
    from repro_torch.core.models import mf, mf_padded
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
    for where in ("cpu", dev):
        data = build_interactions(cells // n_items, cells % n_items, y, alpha,
                                  n_ctx, n_items, alpha0=0.4, device=where)
        pdata = mf_padded.pad_interactions(data)
        p = mf.params_from_numpy(w0, h0, device=where)
        e = mf_padded.residuals(p, pdata)
        for _ in range(2):
            p, e = mf_padded.epoch(p, pdata, e, hp)
        out[str(where)] = (p.w.cpu(), p.h.cpu(), e.cpu())
    (cw, ch, ce), (gw, gh, ge) = out["cpu"], out[str(dev)]
    for a, b in ((gw, cw), (gh, ch), (ge, ce)):
        torch.testing.assert_close(a, b, rtol=EPOCH_RTOL, atol=EPOCH_ATOL)


def train_full_width(dev) -> dict:
    """Phase 6: icd-mf at full width on the card."""
    from repro_torch.core.models import mf, mf_padded
    from repro_torch.eval.ranking import ranking_eval
    from repro_torch.kernels.cd_sweep import ops as cs
    from repro_torch.kernels.gram import ops as gops
    from repro_torch.kernels.topk_score import ops as tops, ref as tref
    from repro_torch.sparse.interactions import build_interactions

    t0 = time.perf_counter()
    ctx, item = make_full_log()
    a0 = FULL["alpha0"]
    data = build_interactions(ctx, item, np.ones(len(ctx)),
                              np.full(len(ctx), a0 + 4.0), FULL["n_ctx"],
                              FULL["n_items"], alpha0=a0, device=dev)
    pdata = mf_padded.pad_interactions(data)
    torch.cuda.synchronize()
    d_c, d_i = pdata.alpha_c.shape[1], pdata.alpha_i.shape[1]
    grid_bytes = 16 * (FULL["n_ctx"] * d_c + FULL["n_items"] * d_i)
    log(f"phase 6 data: nnz {data.nnz}, D_pad ctx {d_c} item {d_i}, fill "
        f"{data.nnz / (FULL['n_ctx'] * d_c):.3f} ctx {data.nnz / (FULL['n_items'] * d_i):.3f} "
        f"item, grids (ids, α, y, e) {grid_bytes / 1e9:.3f} GB; built in "
        f"{time.perf_counter() - t0:.1f}s")

    hp = mf.MFHyperParams(k=FULL["k"], alpha0=a0, l2=FULL["l2"])
    gen = torch.Generator(device=dev).manual_seed(3)
    params0 = mf.init(FULL["n_ctx"], FULL["n_items"], FULL["k"], generator=gen)
    objs = [float(mf.objective(params0, data, hp))]
    epoch_s = []
    stamp = [time.perf_counter()]

    def on_epoch(ep, p):
        torch.cuda.synchronize()
        epoch_s.append(time.perf_counter() - stamp[0])
        objs.append(float(mf.objective(p, data, hp)))
        stamp[0] = time.perf_counter()

    counters = (gops.gram, cs.cd_block_sweep, cs.cd_block_sweep_gather,
                tops.topk_score)
    for c in counters:
        c.launches = 0
    stamp[0] = time.perf_counter()
    trained = mf_padded.fit(params0, pdata, hp, 3, callback=on_epoch)
    launches = {c.__name__: c.launches for c in counters}
    log(f"phase 6 train: mf_padded.fit 3 epochs (block_k 8, gather): "
        f"objective {' -> '.join(f'{o:.6g}' for o in objs)}; epoch s "
        f"{', '.join(f'{s:.3f}' for s in epoch_s)} (objective excluded); "
        f"launches {launches}: {launches['gram'] // 3} Gram and "
        f"{launches['cd_block_sweep_gather'] // 3} sweep launches an epoch")
    assert all(b < a for a, b in zip(objs, objs[1:])), "objective must fall"
    assert launches["gram"] == 6 and launches["cd_block_sweep_gather"] == 96 \
        and launches["cd_block_sweep"] == 0, launches

    # one epoch from one start through each dispatch and the segment sum
    finals = {}
    for name in ("gather", "pregather"):
        for c in counters:
            c.launches = 0
        hpd = mf.MFHyperParams(k=FULL["k"], alpha0=a0, l2=FULL["l2"],
                               psi_dispatch=name)
        torch.cuda.synchronize()
        t = time.perf_counter()
        p, e = mf_padded.epoch(params0, pdata, mf_padded.residuals(params0, pdata), hpd)
        torch.cuda.synchronize()
        finals[name] = (p, e, time.perf_counter() - t,
                        {c.__name__: c.launches for c in counters})
    t = time.perf_counter()
    p_seg, _ = mf.epoch(params0, data, mf.residuals(params0, data), hp)
    torch.cuda.synchronize()
    seg_s = time.perf_counter() - t
    (pg, eg, sg, lg), (pp, ep_, sp, lp) = finals["gather"], finals["pregather"]
    assert lp["cd_block_sweep"] == 32 and lp["cd_block_sweep_gather"] == 0, lp
    for a, b in ((pp.w, pg.w), (pp.h, pg.h), (ep_, eg)):
        torch.testing.assert_close(a, b, rtol=DISPATCH_RTOL, atol=DISPATCH_ATOL)
    e_start = mf_padded.residuals(params0, pdata)
    log(f"phase 6 epoch breakdown (torch.profiler, one gather epoch and a "
        f"copy of its start grid): {epoch_breakdown(lambda: mf_padded.epoch(params0, pdata, e_start.clone(), hp))}")
    del e_start
    dw = float((pp.w - pg.w).abs().max())
    for a, b in ((pg.w, p_seg.w), (pg.h, p_seg.h)):
        torch.testing.assert_close(a, b, rtol=EPOCH_RTOL, atol=EPOCH_ATOL)
    seg_err = max(float((pg.w - p_seg.w).abs().max()),
                  float((pg.h - p_seg.h).abs().max()))
    log(f"phase 6 one epoch from one start: gather {sg:.3f}s, pregather "
        f"{sp:.3f}s (max |dW| {dw:.3g}, rtol {DISPATCH_RTOL}), segment-sum "
        f"mf.epoch {seg_s:.3f}s (max |d| {seg_err:.3g}, rtol {EPOCH_RTOL} "
        f"atol {EPOCH_ATOL})")

    # streaming ranking eval of the trained model through the top-K kernel
    n_eval = 4096
    users = np.arange(0, FULL["n_ctx"], FULL["n_ctx"] // n_eval)[:n_eval]
    starts = np.searchsorted(ctx, users)
    ends = np.searchsorted(ctx, users, side="right")
    truth = item[ends - 1]
    exclude = [item[s:e - 1] for s, e in zip(starts, ends)]
    phi = mf.build_phi(trained, torch.as_tensor(users, device=dev))
    tops.topk_score.launches = 0
    res = ranking_eval(phi, trained.h, truth, k=100, exclude=exclude,
                       batch_rows=256)
    eval_launches = tops.topk_score.launches
    from repro_torch.core.metrics import ndcg_from_topk, recall_from_topk
    from repro_torch.serve.engine import exclude_ids_from_lists

    eids = exclude_ids_from_lists(exclude, device=dev)
    _, ref_ids = tref.topk_score_ref(phi, trained.h, 100, exclude_ids=eids)
    tt = torch.as_tensor(truth, device=dev)
    ref_r = float(recall_from_topk(ref_ids, tt))
    ref_n = float(ndcg_from_topk(ref_ids, tt))
    # the kernel and the plain product sum D in other orders, so a near-tie
    # at the truth's rank may fall either way: allow two users' worth
    assert abs(res["recall@100"] - ref_r) <= 2 / n_eval and \
        abs(res["ndcg@100"] - ref_n) <= 2 / n_eval, (res, ref_r, ref_n)
    assert eval_launches == n_eval // 256, eval_launches
    log(f"phase 6 eval: ranking_eval of {n_eval} users (last train item "
        f"held as truth, the rest excluded): recall@100 "
        f"{res['recall@100']:.4f} ndcg@100 {res['ndcg@100']:.4f}, plain "
        f"recompute {ref_r:.4f} / {ref_n:.4f}; {eval_launches} top-K launches")
    return {"launches": launches, "pdata": pdata, "params": trained,
            "eval_launches": eval_launches,
            "pregather_launches": lp["cd_block_sweep"]}


def epoch_breakdown(fn, top: int = 8) -> str:
    """Device time of one call of ``fn`` by CUDA kernel name (the ``top``
    largest), the device's busy time against the host's wall time, from
    torch.profiler; "not measured" when the profiler sees no device
    time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    by = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0) or 0
        if us > 0 and ev.device_type.name == "CUDA":
            name = ev.key.split("(")[0][:60]
            by[name] = by.get(name, 0.0) + us / 1e3
    if not by:
        return "not measured"
    busy = sum(by.values())
    parts = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    return (f"wall {wall_ms:.3f} ms, device busy {busy:.3f} ms "
            f"({100 * busy / wall_ms:.1f}%, idle {100 - 100 * busy / wall_ms:.1f}%); "
            + ", ".join(f"{n} {ms:.3f} ms" for n, ms in parts))


def time_training_kernels(dev, pdata, params) -> dict:
    """Phase 7: CUDA-event times at the full-width dispatch shapes, one
    launch per side as an epoch makes them (k_b = 8, columns 0..7)."""
    from repro_torch.kernels.cd_sweep import ops as cs, ref as cr
    from repro_torch.kernels.gram import ops as gops, ref as gref
    from repro_torch.obs.costs import cd_sweep_cost

    torch.backends.cuda.matmul.allow_tf32 = False
    w, h = params
    kb = 8
    sides = {  # name: (side, other, ids, alpha)
        "ctx": (w, h, pdata.item_ids, pdata.alpha_c),
        "item": (h, w, pdata.ctx_ids, pdata.alpha_i),
    }
    out = {}
    # Gram: one launch per side and epoch, of the fixed side's factors
    g = {"ms": [], "plain": [], "lib": [], "bound": []}
    for name, (_side, other, _ids, _alpha) in sides.items():
        xs = [other.clone() for _ in range(2)]
        g["ms"].append(device_ms(lambda j: gops.gram(xs[j % 2])))
        g["plain"].append(device_ms(lambda j: gref.gram_ref(xs[j % 2])))
        g["lib"].append(device_ms(lambda j: torch.mm(xs[j % 2].T, xs[j % 2])))
        rows, k = other.shape
        g["bound"].append(bound(4 * rows * k + 4 * k * k, rows * k * (k + 1)))
        log(f"phase 7 gram {rows}x{k}: kernel {g['ms'][-1]:.4f} ms, plain "
            f"{g['plain'][-1]:.4f} ms, torch.mm(x.T, x) {g['lib'][-1]:.4f} ms, "
            f"bound {g['bound'][-1][0]:.4f} ms ({g['bound'][-1][1]})")
    out["gram"] = g
    for disp in ("gather", "pregather"):
        r = {"ms": [], "plain": [], "bound": []}
        for name, (side, other, ids, alpha) in sides.items():
            c, d = alpha.shape
            jfull = gref.gram_ref(other)
            j = jfull[:kb, :kb].contiguous()
            r1 = side @ jfull[:, :kb]
            tab, wb = other[:, :kb], side[:, :kb]
            es = [torch.zeros_like(alpha) for _ in range(2)]
            if disp == "gather":
                fn = lambda i: cs.cd_block_sweep_gather(  # noqa: E731
                    tab, ids, alpha, es[i % 2], wb, r1, j, alpha0=1.0, l2=0.1)
                plain = lambda i: cr.cd_block_sweep_gather_ref(  # noqa: E731
                    tab, ids, alpha, es[i % 2], wb, r1, j, alpha0=1.0, l2=0.1)
            else:
                psi = cr.gather_psi_blk(tab, ids).contiguous()
                fn = lambda i: cs.cd_block_sweep(  # noqa: E731
                    psi, alpha, es[i % 2], wb, r1, j, alpha0=1.0, l2=0.1)
                plain = lambda i: cr.cd_block_sweep_ref(  # noqa: E731
                    psi, alpha, es[i % 2], wb, r1, j, alpha0=1.0, l2=0.1)
            r["ms"].append(device_ms(fn, n=20))
            r["plain"].append(device_ms(plain, n=5))
            cost = cd_sweep_cost(c, d, kb, kb, n_src=other.shape[0],
                                 gather=disp == "gather")
            r["bound"].append(bound(cost["hbm_bytes"], cost["flops"]))
            log(f"phase 7 {disp} sweep {name} side (C {c}, D_pad {d}, k_b "
                f"{kb}): kernel {r['ms'][-1]:.4f} ms, plain "
                f"{r['plain'][-1]:.4f} ms, library —, bound "
                f"{r['bound'][-1][0]:.4f} ms "
                f"({r['bound'][-1][1]}: {cost['hbm_bytes']:.0f} B, "
                f"{cost['flops']:.0f} FLOP)")
            del es
        out[disp] = r
    return out


def bound(nbytes: float, flops: float):
    """(least ms, what bounds it) on an H100 for this work."""
    tb, tf = nbytes / H100_BYTES_PER_S, flops / H100_FP32_FLOPS
    return max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations"


def run_quickstart(dev) -> dict:
    """Phase 8: the quickstart twin on the card."""
    from repro_torch.examples import quickstart

    t = time.perf_counter()
    out = quickstart.run(device=dev, log=lambda m: None)
    assert out["recall"] > out["recall_pop"], out
    objs = out["objectives"]
    assert all(b < a for a, b in zip(objs, objs[1:])), objs
    log(f"phase 8 quickstart twin: Recall@10 iCD-MF {out['recall']:.3f} vs "
        f"popularity {out['recall_pop']:.3f}; objective every 5 epochs "
        f"{', '.join(f'{o:.2f}' for o in objs)}; {time.perf_counter() - t:.1f}s")
    return out


# ---------------------------------------------------------------------------
# Slice 3: the tensor models and the row-patch block sweeps.
# ---------------------------------------------------------------------------
# Long rows (block-row form): the kernel and the plain version sum each
# row's many thousands of slots in other orders, and fp32 summation error is
# a small multiple of u·Σ|terms|. So a row's absolute tolerance is
# LONG_ROW_REL of its Σ_j (Σ_d |α·e·ψ_j|) / den_j in W, times max_j |ψ_j| per
# slot in e, beside the sweep's rtol.
LONG_ROW_REL = 1e-5
# the reference's fused-vs-flat tolerances (tests/test_icd_tensor.py,
# tests/test_ctxmf.py): parameters, residuals
TENSOR_RTOL, TENSOR_ATOL, TENSOR_E_ATOL = 5e-4, 1e-5, 5e-5
TUCKER_RTOL, TUCKER_ATOL = 1e-3, 1e-4
# the CtxMF log (phase 10): its shape at full width, which phase 10 checks
CTX = dict(n_buckets=24, days=28, ts_seed=1, k_tucker=8, nnz=3_399_385,
           d_user=128, d_bucket=142_464, d_item=1_024)


def rowpatch_inputs(gen, dev, c, d, kb, n_src, pad_frac=0.3, ids=None,
                    alpha=None):
    """Random row-patch operands at (C, D_pad): a flat slab of ``n_src``
    rows whose last is the zero sentinel (padding points at it, α = 0) and
    per-row patches P = K·Kᵀ + I; ``ids``/``alpha`` may be a real layout's."""
    if alpha is None:
        alpha = torch.rand((c, d), generator=gen, device=dev) * 4 + 0.5
        pad = torch.rand((c, d), generator=gen, device=dev) < pad_frac
        alpha[pad] = 0
        ids = torch.randint(0, n_src - 1, (c, d), generator=gen, device=dev,
                            dtype=torch.int32)
        ids[pad] = n_src - 1
    tab = 0.1 * torch.randn((n_src, kb), generator=gen, device=dev)
    tab[-1] = 0
    kk = 0.3 * torch.randn((c, kb, kb), generator=gen, device=dev)
    return dict(alpha=alpha, ids=ids, tab=tab,
                e=torch.randn((c, d), generator=gen, device=dev),
                w=0.1 * torch.randn((c, kb), generator=gen, device=dev),
                r1=torch.randn((c, kb), generator=gen, device=dev),
                p=kk @ kk.transpose(1, 2) + torch.eye(kb, device=dev))


def hold_rowpatch(cs, cr, x, *, gather=True, cpl=None, alpha0=1.0, l2=0.1,
                  eta=1.0):
    """One launch of a row-patch sweep (or, with a 2-D ``cpl``, the
    shared-J sweep) against its plain version; returns (max |error| over W
    and e, whether it ran in the block-row form, W)."""
    from repro_torch.kernels import vmem

    cpl = x["p"] if cpl is None else cpl
    name = ("cd_block_sweep_rowpatch" if cpl.dim() == 3 else
            "cd_block_sweep") + ("_gather" if gather else "")
    fn, plain = getattr(cs, name), getattr(cr, name + "_ref")
    psi = cr.gather_psi_blk(x["tab"], x["ids"]).contiguous()
    first = (x["tab"], x["ids"]) if gather else (psi,)
    kw = dict(alpha0=alpha0, l2=l2, eta=eta)
    d, kb = x["alpha"].shape[1], x["w"].shape[1]
    long_rows = vmem.cd_sweep_form(d, kb, gather=gather,
                                   rowpatch=cpl.dim() == 3) == vmem.BLOCK_ROW
    before = (fn.launches, fn.launches_block_row)
    rw, re = plain(*first, x["alpha"], x["e"], x["w"], x["r1"], cpl, **kw)
    e = x["e"].clone()
    w, e2 = fn(*first, x["alpha"], e, x["w"], x["r1"], cpl, **kw)
    torch.cuda.synchronize()
    assert e2 is e, "the residual grid must be updated in place"
    assert (fn.launches - before[0], fn.launches_block_row - before[1]) == \
        (1, int(long_rows)), (name, long_rows)
    assert bool(torch.isfinite(w).all()) and bool(torch.isfinite(e).all())
    atol_w = atol_e = SWEEP_ATOL
    if long_rows:
        a = x["alpha"][:, None, :]
        den = ((a * psi * psi).sum(-1) + alpha0 * torch.diagonal(
            cpl, dim1=-2, dim2=-1) + l2).clamp(min=1e-12)
        scale = ((a * x["e"].abs()[:, None, :] * psi.abs()).sum(-1)
                 / den).sum(1, keepdim=True)
        atol_w = SWEEP_ATOL + LONG_ROW_REL * scale
        atol_e = atol_w * psi.abs().amax(1)
    bad_w = (w - rw).abs() > SWEEP_RTOL * rw.abs() + atol_w
    bad_e = (e - re).abs() > SWEEP_RTOL * re.abs() + atol_e
    err = max(float((w - rw).abs().max()), float((e - re).abs().max()))
    assert not bool(bad_w.any()) and not bool(bad_e.any()), (name, d, err)
    return err, long_rows, w


def hold_rowpatch_kernels(dev, n_src) -> dict:
    """Phase 9: both row-patch kernels against their plain versions at the
    full-width shapes and at edge cases; ``n_src`` = nnz + 1."""
    from repro_torch.kernels.cd_sweep import ops as cs, ref as cr

    gen = torch.Generator(device=dev).manual_seed(9)
    err = {"cd_block_sweep_rowpatch": 0.0, "cd_block_sweep_rowpatch_gather": 0.0}
    # user side (warp-row; 13% of the slots filled at full width), bucket
    # side (block-row; full rows)
    for c, d, pad, long_rows in ((FULL["n_ctx"], 128, 0.87, False),
                                 (CTX["n_buckets"], CTX["d_bucket"], 0.01, True)):
        x = rowpatch_inputs(gen, dev, c, d, 8, n_src, pad)
        for gather in (True, False):
            name = "cd_block_sweep_rowpatch" + ("_gather" if gather else "")
            got, lr, _ = hold_rowpatch(cs, cr, x, gather=gather)
            assert lr == long_rows
            err[name] = max(err[name], got)
            log(f"phase 9 hold {name} C {c} D_pad {d}: "
                f"{'block-row' if lr else 'warp-row'} form, max |err| {got:.3g}")
        del x
    # edge cases: C off the row tile, a 4-column tail, k_b = 1, η ≠ 1,
    # long rows in both couplings
    for c, d, kb, eta in ((1001, 40, 8, 1.0), (1001, 40, 4, 0.7),
                          (13, 200, 1, 0.5), (9, 33, 3, 1.3),
                          (5, 20_000, 8, 0.9), (3, 16_000, 4, 1.0)):
        x = rowpatch_inputs(gen, dev, c, d, kb, 60)
        for gather in (True, False):
            hold_rowpatch(cs, cr, x, gather=gather, eta=eta)
    for d in (128, 20_000):
        # ids past both ends, clipped to the slab
        x = rowpatch_inputs(gen, dev, 64, d, 8, 30)
        x["ids"][:, :5] = torch.tensor([-7, 29, 30, 1000, -1],
                                       dtype=torch.int32, device=dev)
        hold_rowpatch(cs, cr, x)
        # all-α = 0 rows with l2 = α₀ = 0: the 1e-12 clamp, W unchanged
        x = rowpatch_inputs(gen, dev, 12, d, 8, 40)
        x["alpha"][:4] = 0
        x["p"][:4] = 0
        for gather in (True, False):
            _, _, w = hold_rowpatch(cs, cr, x, gather=gather, alpha0=0.0, l2=0.0)
            assert torch.equal(w[:4], x["w"][:4]), "an empty row moved"
    # the shared-J sweep (MF's kernel 2) in the block-row form
    x = rowpatch_inputs(gen, dev, 5, 20_000, 8, 3_000)
    for gather in (True, False):
        _, lr, _ = hold_rowpatch(cs, cr, x, gather=gather, cpl=x["p"][0])
        assert lr
    return err


def make_ctx_log(dev):
    """Phase 6's log with a seeded uniform timestamp per event over 28
    days, bucketed by hour of day, on the card: (tc, data, padded)."""
    from repro_torch.core.models import ctxmf
    from repro_torch.sparse.interactions import build_interactions

    user, item = make_full_log()
    t = np.random.default_rng(CTX["ts_seed"]).uniform(
        0.0, CTX["days"] * 86400.0, len(user))
    bucket = ctxmf.seasonal_buckets(t, CTX["n_buckets"], period=86400.0)
    tc, pair = ctxmf.build_context(user, bucket, FULL["n_ctx"],
                                   CTX["n_buckets"], device=dev)
    a0 = FULL["alpha0"]
    data = build_interactions(pair, item, np.ones(len(user)),
                              np.full(len(user), a0 + 4.0), tc.n_ctx,
                              FULL["n_items"], alpha0=a0, device=dev)
    return tc, data, ctxmf.pad_tensor_groups(tc, data)


def _counters():
    from repro_torch.kernels.cd_sweep import ops as cs
    from repro_torch.kernels.gram import ops as gops

    return (gops.gram, cs.cd_block_sweep, cs.cd_block_sweep_gather,
            cs.cd_block_sweep_rowpatch, cs.cd_block_sweep_rowpatch_gather)


def reset_counts() -> None:
    for c in _counters():
        c.launches = 0
        if hasattr(c, "launches_block_row"):
            c.launches_block_row = 0


def read_counts() -> dict:
    out = {}
    for c in _counters():
        out[c.__name__] = c.launches
        if hasattr(c, "launches_block_row"):
            out[c.__name__ + ":block_row"] = c.launches_block_row
    return out


def _hold_params(got, want, e_got=None, e_want=None) -> float:
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=TENSOR_RTOL, atol=TENSOR_ATOL)
    if e_got is not None:
        torch.testing.assert_close(e_got, e_want, rtol=TENSOR_RTOL,
                                   atol=TENSOR_E_ATOL)
    return max(float((a - b).abs().max()) for a, b in zip(got, want))


def train_ctxmf_full_width(dev) -> dict:
    """Phase 10: CtxMF at full width on the card."""
    import dataclasses

    from repro_torch.core.models import ctxmf
    from repro_torch.kernels import vmem
    from repro_torch.kernels.topk_score import ops as tops, ref as tref
    from repro_torch.serve.engine import RetrievalEngine

    t0 = time.perf_counter()
    tc, data, padded = make_ctx_log(dev)
    per_bucket = torch.bincount(tc.c2[data.ctx], minlength=CTX["n_buckets"])
    torch.cuda.synchronize()
    d1, d2, di = padded.g1.d_pad, padded.g2.d_pad, padded.gi.d_pad
    forms = [vmem.cd_sweep_form(d, 8, gather=True, rowpatch=True)
             for d in (d1, d2)]
    log(f"phase 10 data: nnz {data.nnz}, {tc.n_ctx} (user, bucket) pairs, "
        f"D_pad user {d1} bucket {d2} item {di}; bucket rows "
        f"{int(per_bucket.min())}-{int(per_bucket.max())} events; sweep forms "
        f"user {forms[0]}, bucket {forms[1]}; built in "
        f"{time.perf_counter() - t0:.1f}s")
    assert (data.nnz, d1, d2, di) == (CTX["nnz"], CTX["d_user"], CTX["d_bucket"],
                                      CTX["d_item"]), (data.nnz, d1, d2, di)
    assert forms == [vmem.WARP_ROW, vmem.BLOCK_ROW], forms

    hp = ctxmf.CtxMFHyperParams(k=FULL["k"], alpha0=FULL["alpha0"],
                                l2=FULL["l2"], implementation="pallas")
    gen = torch.Generator(device=dev).manual_seed(10)
    params0 = ctxmf.init(FULL["n_ctx"], CTX["n_buckets"], FULL["n_items"],
                         FULL["k"], generator=gen)
    objs = [float(ctxmf.objective(params0, tc, data, hp))]
    epoch_s, first = [], None
    p, e = params0, ctxmf.residuals(params0, tc, data)
    torch.cuda.synchronize()
    reset_counts()
    for _ in range(3):
        t = time.perf_counter()
        p, e = ctxmf.epoch_padded(p, tc, data, padded, e, hp)
        torch.cuda.synchronize()
        epoch_s.append(time.perf_counter() - t)
        first = first or (p, e)
        objs.append(float(ctxmf.objective(p, tc, data, hp)))
    launches = read_counts()
    rp = launches["cd_block_sweep_rowpatch_gather"]
    rp_block = launches["cd_block_sweep_rowpatch_gather:block_row"]
    log(f"phase 10 train: ctxmf.epoch_padded x3 (k {FULL['k']}, block_k 0 -> k_b 8, "
        f"gather, Gram kernel for J_I): objective "
        f"{' -> '.join(f'{o:.6g}' for o in objs)}; epoch s "
        f"{', '.join(f'{s:.3f}' for s in epoch_s)} (objective excluded); "
        f"launches {launches}: an epoch {(rp - rp_block) // 3} warp-row + "
        f"{rp_block // 3} block-row row-patch, "
        f"{launches['cd_block_sweep_gather'] // 3} item-sweep and "
        f"{launches['gram'] // 3} Gram launches")
    assert all(b < a for a, b in zip(objs, objs[1:])), "objective must fall"
    nb = -(-FULL["k"] // 8)  # k_b = 8 blocks a mode: 16 at k = 128
    want = {"gram": 3, "cd_block_sweep": 0, "cd_block_sweep:block_row": 0,
            "cd_block_sweep_gather": 3 * nb,
            "cd_block_sweep_gather:block_row": 0,
            "cd_block_sweep_rowpatch": 0,
            "cd_block_sweep_rowpatch:block_row": 0,
            "cd_block_sweep_rowpatch_gather": 6 * nb,
            "cd_block_sweep_rowpatch_gather:block_row": 3 * nb}
    assert launches == want, launches

    # one epoch from one start through the pregather route and the flat path
    pg, eg = first
    reset_counts()
    t = time.perf_counter()
    pp, ep_ = ctxmf.epoch_padded(params0, tc, data, padded,
                                 ctxmf.residuals(params0, tc, data),
                                 dataclasses.replace(hp, psi_dispatch="pregather"))
    torch.cuda.synchronize()
    pre_s, pre_launches = time.perf_counter() - t, read_counts()
    assert pre_launches["cd_block_sweep_rowpatch"] == 2 * nb and \
        pre_launches["cd_block_sweep_rowpatch:block_row"] == nb and \
        pre_launches["cd_block_sweep"] == nb and \
        pre_launches["cd_block_sweep_rowpatch_gather"] == 0, pre_launches
    d_pre = _hold_params(pp, pg, ep_, eg)
    del pp, ep_
    t = time.perf_counter()
    pf, ef = ctxmf.epoch(params0, tc, data, ctxmf.residuals(params0, tc, data), hp)
    torch.cuda.synchronize()
    flat_s = time.perf_counter() - t
    d_flat = _hold_params(pf, pg, ef, eg)
    del pf, ef
    log(f"phase 10 one epoch from one start: gather {epoch_s[0]:.3f}s, "
        f"pregather {pre_s:.3f}s (max |d param| {d_pre:.3g}), flat "
        f"ctxmf.epoch {flat_s:.3f}s (max |d param| {d_flat:.3g}); rtol "
        f"{TENSOR_RTOL} atol {TENSOR_ATOL} (e atol {TENSOR_E_ATOL})")
    e0 = ctxmf.residuals(params0, tc, data)
    log(f"phase 10 epoch breakdown (torch.profiler, one gather epoch): "
        f"{epoch_breakdown(lambda: ctxmf.epoch_padded(params0, tc, data, padded, e0, hp), top=12)}")
    del e0

    # dense context: regularizer universe users × buckets
    hpd = dataclasses.replace(hp, dense_context=True)
    od0 = float(ctxmf.objective(params0, tc, data, hpd))
    reset_counts()
    t = time.perf_counter()
    pd, _ = ctxmf.epoch_padded(params0, tc, data, padded,
                               ctxmf.residuals(params0, tc, data), hpd)
    torch.cuda.synchronize()
    dense_s, dense_launches = time.perf_counter() - t, read_counts()
    od1 = float(ctxmf.objective(pd, tc, data, hpd))
    assert od1 < od0 and all(bool(torch.isfinite(x).all()) for x in pd)
    assert dense_launches["cd_block_sweep_rowpatch_gather"] == 2 * nb and \
        dense_launches["cd_block_sweep_rowpatch_gather:block_row"] == nb
    del pd
    log(f"phase 10 dense_context epoch: objective {od0:.6g} -> {od1:.6g}, "
        f"{dense_s:.3f}s, launches {dense_launches}")

    # 16 (user, bucket) queries through the top-K kernel
    qu = torch.arange(16, device=dev) * (FULL["n_ctx"] // 16) + 7
    qb = (torch.arange(16, device=dev) * 5) % CTX["n_buckets"]
    engine = RetrievalEngine(ctxmf.export_psi(p),
                             lambda u, b: ctxmf.build_phi(p, u, b), k=100)
    phi = ctxmf.build_phi(p, qu, qb)
    tops.topk_score.launches = 0
    res = engine.topk_phi(phi)
    q_launches = tops.topk_score.launches
    rs, ri = tref.topk_score_ref(phi, ctxmf.export_psi(p), 101)
    torch.cuda.synchronize()
    torch.testing.assert_close(res.scores, rs[:, :100], rtol=RTOL, atol=ATOL)
    ids_agree(rs[:, :100], ri[:, :100], res.ids, rs[:, 100])
    exact = int((res.ids == ri[:, :100]).all(1).sum())
    assert q_launches == 1, q_launches
    log(f"phase 10 queries: 16 (user, bucket) queries, top-100 through "
        f"{q_launches} top-K launch; ids equal to the plain recompute in "
        f"{exact}/16 rows outright, and at every slot outside a near-tie")
    return {"tc": tc, "data": data, "padded": padded, "launches": launches,
            "pre_launches": pre_launches}


def small_tensor_epochs_on_card_vs_cpu(dev) -> None:
    """Two fused epochs of PARAFAC (k = 12, block_k 8: a 4-column tail) and
    of Tucker (mode ranks 3, 2, 4 at block_k 2) on a small problem, on the
    card against the same epochs on the CPU."""
    from repro_torch.core.models import parafac, tucker
    from repro_torch.sparse.interactions import build_interactions

    rng = np.random.default_rng(12)
    n_c1, n_c2, n_items, n_pairs, nnz = 40, 6, 30, 150, 600
    pairs = rng.choice(n_c1 * n_c2, size=n_pairs, replace=False)
    cells = rng.choice(n_pairs * n_items, size=nnz, replace=False)
    y = rng.integers(1, 4, nnz).astype(np.float64)
    alpha = 1.3 + rng.random(nnz)
    fp = [(0.3 * rng.normal(size=(n, 12))).astype(np.float32)
          for n in (n_c1, n_c2, n_items)]
    ft = [(0.3 * rng.normal(size=s)).astype(np.float32)
          for s in ((n_c1, 3), (n_c2, 2), (n_items, 4), (3, 2, 4))]
    cases = (  # (model, hp, factors, rtol, atol of the params, atol of e)
        (parafac, parafac.PARAFACHyperParams(k=12, alpha0=0.3, l2=0.05,
                                             block_k=8), fp,
         TENSOR_RTOL, TENSOR_ATOL, TENSOR_E_ATOL),
        (tucker, tucker.TuckerHyperParams(k1=3, k2=2, k3=4, alpha0=0.3,
                                          l2=0.05, l2_core=0.02, block_k=2),
         ft, TUCKER_RTOL, TUCKER_ATOL, TUCKER_ATOL))
    for mod, hp, f, rtol, atol, e_atol in cases:
        out = []
        for where in ("cpu", dev):
            tc = mod.TensorContext(
                c1=torch.as_tensor(pairs // n_c2, device=where),
                c2=torch.as_tensor(pairs % n_c2, device=where),
                n_c1=n_c1, n_c2=n_c2)
            data = build_interactions(cells // n_items, cells % n_items, y,
                                      alpha, n_pairs, n_items, alpha0=0.3,
                                      device=where)
            pad = mod.pad_tensor_groups(tc, data)
            p = mod.params_from_numpy(*f, device=where)
            e = mod.residuals(p, tc, data)
            for _ in range(2):
                p, e = mod.epoch_padded(p, tc, data, pad, e, hp)
            out.append([t.cpu() for t in (*p, e)])
        *params, e = zip(out[1], out[0])
        for a, b in params:
            torch.testing.assert_close(a, b, rtol=rtol, atol=atol)
        torch.testing.assert_close(*e, rtol=rtol, atol=e_atol)


def train_tucker_full_width(dev, tc, data, padded) -> None:
    """Phase 11: one Tucker epoch at k1 = k2 = k3 = 8 on the CtxMF log."""
    from repro_torch.core.models import tucker

    k = CTX["k_tucker"]
    hp = tucker.TuckerHyperParams(k1=k, k2=k, k3=k, alpha0=FULL["alpha0"],
                                  l2=FULL["l2"])
    gen = torch.Generator(device=dev).manual_seed(11)
    p0 = tucker.init(FULL["n_ctx"], CTX["n_buckets"], FULL["n_items"], k, k, k,
                     generator=gen)
    o0 = float(tucker.objective(p0, tc, data, hp))
    e0 = tucker.residuals(p0, tc, data)
    torch.cuda.synchronize()
    reset_counts()
    t = time.perf_counter()
    p1, _ = tucker.epoch_padded(p0, tc, data, padded, e0, hp)
    torch.cuda.synchronize()
    s, launches = time.perf_counter() - t, read_counts()
    o1 = float(tucker.objective(p1, tc, data, hp))
    assert o1 < o0 and all(bool(torch.isfinite(x).all()) for x in p1), (o0, o1)
    assert launches["cd_block_sweep_rowpatch_gather"] == 2 and \
        launches["cd_block_sweep_rowpatch_gather:block_row"] == 1 and \
        launches["cd_block_sweep_gather"] == 1, launches
    small_tensor_epochs_on_card_vs_cpu(dev)
    log(f"phase 11 tucker: epoch_padded at k1 = k2 = k3 = {k} (core sweep "
        f"{k ** 3} scalar steps): objective {o0:.6g} -> {o1:.6g} in {s:.3f}s, "
        f"launches {launches}; small PARAFAC and Tucker epochs on the card "
        f"match the CPU")


def time_rowpatch_kernels(dev, padded, n_src) -> dict:
    """Phase 12: CUDA-event times of both row-patch forms at the
    full-width user (warp-row) and bucket (block-row) shapes, on the real
    layouts' ids and α with random values, one launch of k_b = 8."""
    from repro_torch.kernels.cd_sweep import ops as cs, ref as cr
    from repro_torch.obs.costs import cd_sweep_cost

    gen = torch.Generator(device=dev).manual_seed(12)
    out = {d: {"ms": [], "plain": [], "bound": []}
           for d in ("gather", "pregather")}
    kw = dict(alpha0=1.0, l2=0.1)
    for side, g in (("user", padded.g1), ("bucket", padded.g2)):
        c, d = g.alpha_pad.shape
        x = rowpatch_inputs(gen, dev, c, d, 8, n_src, ids=g.flat_ids,
                            alpha=g.alpha_pad)
        es = [x["e"].clone() for _ in range(2)]
        psi = cr.gather_psi_blk(x["tab"], x["ids"]).contiguous()
        rest = (x["alpha"], None, x["w"], x["r1"], x["p"])

        def args(first, i):
            return (*first, rest[0], es[i % 2], *rest[2:])

        for disp in ("gather", "pregather"):
            first = (x["tab"], x["ids"]) if disp == "gather" else (psi,)
            name = "cd_block_sweep_rowpatch" + ("_gather" if disp == "gather" else "")
            fn, plain = getattr(cs, name), getattr(cr, name + "_ref")
            r = out[disp]
            r["ms"].append(device_ms(lambda i: fn(*args(first, i), **kw),
                                     n=20 if side == "user" else 10))
            r["plain"].append(device_ms(lambda i: plain(*args(first, i), **kw),
                                        n=5))
            cost = cd_sweep_cost(c, d, 8, 8, n_src=n_src,
                                 gather=disp == "gather", rowpatch=True)
            r["bound"].append(bound(cost["hbm_bytes"], cost["flops"]))
            own = bound(cost["form_bytes"], cost["flops"])
            log(f"phase 12 {name} {side} side (C {c}, D_pad {d}, k_b 8, "
                f"{cost['form']}): kernel {r['ms'][-1]:.4f} ms, plain "
                f"{r['plain'][-1]:.4f} ms, library —, bound "
                f"{r['bound'][-1][0]:.4f} ms ({r['bound'][-1][1]}: "
                f"{cost['hbm_bytes']:.0f} B, {cost['flops']:.0f} FLOP); the "
                f"form's own traffic {cost['form_bytes']:.0f} B, "
                f"{own[0]:.4f} ms")
        del x, es, psi
    return out


# ---------------------------------------------------------------------------
# Slice 4a: the fielded design, MFSI, the slab-reduce and residual-patch
# kernels.
# ---------------------------------------------------------------------------
# icd-fm's full width (src/repro/configs/icd_fm.py, the paper's §6 A+P+H
# features): context fields with their vocabularies, p_ctx = 336,091; the
# item design is the video id. Depth is not cut: k = 128. The history bag
# is the repo's own feature (benchmarks/experiments.py: HIST_LEN = 10, the
# last items merged, each occurrence weighing 1/len).
ICD_FM = dict(fields=(("user", 200_000), ("age", 8), ("country", 64), ("gender", 3),
                  ("device", 16), ("prev_video", 68_000), ("history", 68_000)),
          hist_len=10, p_ctx=336_091, seed=16)
# rows longer than this sum in another order than the plain version over
# enough slots that the row-scaled bound applies (phase 9's LONG_ROW_REL)
SLAB_LONG_D = 1_024


def history_bags(ctx, item, n_ctx, length):
    """Each user's watch history as ``benchmarks/experiments.py`` builds it
    (``_merge_bag``): the user's last ``length`` logged items, each
    weighing 1/len; padding id 0 with weight 0. Returns ((n_ctx, length)
    ids, weights). ``make_full_log``'s pairs are unique, so there are no
    repeats to merge (``make_design`` raises on a repeated id in a bag)."""
    ends = np.searchsorted(ctx, np.arange(n_ctx), side="right")
    n = np.minimum(ends - np.searchsorted(ctx, np.arange(n_ctx)), length)
    held = np.arange(length)[None, :] < n[:, None]
    idx = np.where(held, ends[:, None] - n[:, None] + np.arange(length), 0)
    ids = np.where(held, item[idx], 0)
    return ids, np.where(held, 1.0 / np.maximum(n, 1)[:, None], 0.0)


def make_fm_design(dev, ctx, item):
    """The context and item designs on phase 6's log: user id; one-hot age,
    country, gender and device, seeded; previous video = the user's last
    logged item; history = ``history_bags`` of the user's last 10 items.
    Every user has logged at least one item, so no id is reserved for an
    empty history and the vocabularies stay icd-fm's."""
    from repro_torch.core import design

    n_ctx, n_items = FULL["n_ctx"], FULL["n_items"]
    rng = np.random.default_rng(ICD_FM["seed"])
    ends = np.searchsorted(ctx, np.arange(n_ctx), side="right")
    hist, hist_w = history_bags(ctx, item, n_ctx, ICD_FM["hist_len"])
    ids = {"user": np.arange(n_ctx), "prev_video": item[ends - 1]}
    spec = []
    for name, vocab in ICD_FM["fields"]:
        if name == "history":
            spec.append(dict(name=name, ids=hist, weights=hist_w, vocab=vocab))
        else:
            spec.append(dict(name=name, vocab=vocab, ids=ids.get(
                name, rng.integers(0, vocab, n_ctx))))
    x = design.make_design(spec, n_ctx, device=dev)
    z = design.make_design([dict(name="video", ids=np.arange(n_items),
                                 vocab=n_items)], n_items, device=dev)
    return x, z


def slab_inputs(gen, dev, c, d, m, n_src, *, pad_frac, k=None, ids=None,
                alpha=None):
    """Random slab-reduce / residual-patch operands at (C, D_pad): the ψ
    slab a column slice of an (n_src, k) table (row stride k, as the epochs
    pass ``other_psi[:, blk]``), a ``pad_frac`` share of padding slots (id
    0, α = 0), or a real layout's ``ids``/``alpha``."""
    if alpha is None:
        alpha = torch.rand((c, d), generator=gen, device=dev) * 4 + 0.5
        pad = torch.rand((c, d), generator=gen, device=dev) < pad_frac
        alpha[pad] = 0
        ids = torch.randint(0, n_src, (c, d), generator=gen, device=dev,
                            dtype=torch.int32)
        ids[pad] = 0
    k = k or m
    return dict(alpha=alpha, ids=ids,
                tab=(0.1 * torch.randn((n_src, k), generator=gen, device=dev))[:, :m],
                e=torch.randn((c, d), generator=gen, device=dev),
                dphi=0.1 * torch.randn((c, m), generator=gen, device=dev))


def hold_slab(cs, cr, x) -> dict:
    """All four slab kernels once against their plain versions on the same
    inputs; returns the largest |error| of each. Q and P to SWEEP_RTOL /
    SWEEP_ATOL, plus, for rows of SLAB_LONG_D slots and more,
    LONG_ROW_REL of the row's Σ|terms|; P symmetric bit for bit; e patched
    in place to SWEEP_RTOL / SWEEP_ATOL (m terms a slot, no long sum)."""
    tab, ids, alpha, e, dphi = (x[n] for n in ("tab", "ids", "alpha", "e", "dphi"))
    psi = cr.gather_psi_blk(tab, ids).contiguous()
    c, d = alpha.shape
    rq, rp = cr.cd_slab_reduce_ref(psi, alpha, e)
    # per-row Σ|terms| of Q and of P, in place of the (C, m, m, D) products
    aps = alpha[:, None, :] * psi.abs()
    q_abs = (aps * e.abs()[:, None, :]).sum(-1)
    p_abs = torch.einsum("cid,cjd->cij", aps, psi.abs())
    rel = LONG_ROW_REL if d >= SLAB_LONG_D else 0.0
    err = {}
    for name, first in (("cd_slab_reduce_gather", (tab, ids)),
                        ("cd_slab_reduce", (psi,))):
        fn = getattr(cs, name)
        before = fn.launches
        q, p = fn(*first, alpha, e)
        torch.cuda.synchronize()
        assert fn.launches == before + 1, name
        assert torch.equal(p, p.transpose(1, 2)), f"{name}: P not symmetric"
        assert bool(torch.isfinite(q).all()) and bool(torch.isfinite(p).all())
        bad_q = (q - rq).abs() > SWEEP_RTOL * rq.abs() + SWEEP_ATOL + rel * q_abs
        bad_p = (p - rp).abs() > SWEEP_RTOL * rp.abs() + SWEEP_ATOL + rel * p_abs
        err[name] = max(float((q - rq).abs().max()), float((p - rp).abs().max()))
        assert not bool(bad_q.any()) and not bool(bad_p.any()), (name, c, d, err[name])
    re = cr.cd_resid_patch_ref(psi, e, dphi)
    for name, first in (("cd_resid_patch_gather", (tab, ids)),
                        ("cd_resid_patch", (psi,))):
        fn = getattr(cs, name)
        before = fn.launches
        e2 = e.clone()
        assert fn(*first, e2, dphi) is e2, "the residual grid must be patched in place"
        torch.cuda.synchronize()
        assert fn.launches == before + 1, name
        torch.testing.assert_close(e2, re, rtol=SWEEP_RTOL, atol=SWEEP_ATOL)
        err[name] = float((e2 - re).abs().max())
    return err


def hold_slab_kernels(dev) -> dict:
    """Phase 13: kernels 6–9 against their plain versions at both sides'
    full-width shapes (m = 8), and at m = 9 and 17, a long row, ids past
    the slab."""
    from repro_torch.kernels.cd_sweep import ops as cs, ref as cr

    gen = torch.Generator(device=dev).manual_seed(13)
    n_ctx, n_items = FULL["n_ctx"], FULL["n_items"]
    worst = {}

    def hold(x, what):
        got = hold_slab(cs, cr, x)
        for n, v in got.items():
            worst[n] = max(worst.get(n, 0.0), v)
        log(f"phase 13 hold {what}: max |err| " + ", ".join(
            f"{n} {v:.3g}" for n, v in got.items()))

    # the full-width shapes, at the log's fill (13% of the context grid,
    # 5% of the item grid), the ψ slab a column slice of a k = 128 table
    hold(slab_inputs(gen, dev, n_ctx, 128, 8, n_items, pad_frac=0.87, k=128),
         f"context side C {n_ctx} D_pad 128 n_src {n_items} m 8")
    hold(slab_inputs(gen, dev, n_items, 1_024, 8, n_ctx, pad_frac=0.95, k=128),
         f"item side C {n_items} D_pad 1024 n_src {n_ctx} m 8")
    # FM's m = k_b + 1 and a P of three column tiles, with ψ slabs strided
    for m in (9, 17):
        hold(slab_inputs(gen, dev, 5_000, 128, m, 3_000, pad_frac=0.5, k=m + 7),
             f"m {m}, strided slab")
    # a long row (no shared memory per slot: any D_pad runs)
    hold(slab_inputs(gen, dev, 6, 20_480, 8, 3_000, pad_frac=0.1, k=16),
         "long rows D_pad 20480")
    # ids past both ends of the slab, clipped as jnp.take(mode="clip")
    x = slab_inputs(gen, dev, 64, 128, 8, 30, pad_frac=0.3)
    x["ids"][:, :5] = torch.tensor([-7, 29, 30, 1000, -1], dtype=torch.int32,
                                   device=dev)
    hold(x, "ids past the slab")
    return worst


def train_mfsi_full_width(dev) -> dict:
    """Phase 14: MFSI at icd-fm width on the card."""
    import dataclasses

    from repro_torch.core.models import mfsi
    from repro_torch.kernels.cd_sweep import ops as cs
    from repro_torch.kernels.gram import ops as gops
    from repro_torch.kernels.topk_score import ops as tops, ref as tref
    from repro_torch.sparse.interactions import build_interactions

    t0 = time.perf_counter()
    ctx, item = make_full_log()
    x, z = make_fm_design(dev, ctx, item)
    a0 = FULL["alpha0"]
    data = build_interactions(ctx, item, np.ones(len(ctx)),
                              np.full(len(ctx), a0 + 4.0), FULL["n_ctx"],
                              FULL["n_items"], alpha0=a0, device=dev)
    pdata = mfsi.pad_interactions(data)
    torch.cuda.synchronize()
    bags = x.fields[-1].weights.gt(0).sum(1).float()
    log(f"phase 14 data: nnz {data.nnz}, p_ctx {x.p} over {len(x.fields)} "
        f"fields, p_item {z.p}; history bags of {bags.mean():.2f} items "
        f"(most {int(bags.max())}); D_pad ctx {pdata.alpha_c.shape[1]} item "
        f"{pdata.alpha_i.shape[1]}; built in {time.perf_counter() - t0:.1f}s")
    assert x.p == ICD_FM["p_ctx"] and z.p == FULL["n_items"], (x.p, z.p)

    k = FULL["k"]
    hp = mfsi.MFSIHyperParams(k=k, alpha0=a0, l2=FULL["l2"],
                              implementation="pallas")
    gen = torch.Generator(device=dev).manual_seed(14)
    params0 = mfsi.init(x.p, z.p, k, generator=gen)
    counters = (gops.gram, cs.cd_slab_reduce, cs.cd_slab_reduce_gather,
                cs.cd_resid_patch, cs.cd_resid_patch_gather)

    def reset():
        for c in counters:
            c.launches = 0

    def counts():
        return {c.__name__: c.launches for c in counters}

    objs = [float(mfsi.objective(params0, x, z, data, hp))]
    p, e = params0, mfsi.residuals_padded(params0, x, z, data, pdata)
    epoch_s, first = [], None
    torch.cuda.synchronize()
    reset()
    for _ in range(3):
        t = time.perf_counter()
        p, e = mfsi.epoch_padded(p, x, z, pdata, e, hp)
        torch.cuda.synchronize()
        epoch_s.append(time.perf_counter() - t)
        first = first or (p, e.clone())
        objs.append(float(mfsi.objective(p, x, z, data, hp)))
    launches = counts()
    nb = -(-k // 8)  # k_b = 8: 16 blocks a side
    log(f"phase 14 train: mfsi.epoch_padded x3 (k {k}, block_k 0 -> k_b 8, "
        f"gather, jacobi, Gram kernel): objective "
        f"{' -> '.join(f'{o:.6g}' for o in objs)}; epoch s "
        f"{', '.join(f'{s:.3f}' for s in epoch_s)} (objective excluded); "
        f"launches {launches}")
    assert all(b < a for a, b in zip(objs, objs[1:])), "objective must fall"
    assert launches == {"gram": 6, "cd_slab_reduce": 0,
                        "cd_slab_reduce_gather": 3 * 2 * nb,
                        "cd_resid_patch": 0,
                        "cd_resid_patch_gather": 3 * 2 * nb}, launches

    # one epoch from one start through the pregather route and the flat path
    pg, eg = first
    reset()
    t = time.perf_counter()
    pp, ep_ = mfsi.epoch_padded(params0, x, z, pdata,
                                mfsi.residuals_padded(params0, x, z, data, pdata),
                                dataclasses.replace(hp, psi_dispatch="pregather"))
    torch.cuda.synchronize()
    pre_s, pre_launches = time.perf_counter() - t, counts()
    assert pre_launches["cd_slab_reduce"] == 2 * nb and \
        pre_launches["cd_resid_patch"] == 2 * nb and \
        pre_launches["cd_slab_reduce_gather"] == 0, pre_launches
    d_pre = _hold_params(pp, pg, ep_, eg)
    del pp, ep_
    t = time.perf_counter()
    pf, ef = mfsi.epoch(params0, x, z, data,
                        mfsi.residuals(params0, x, z, data), hp)
    torch.cuda.synchronize()
    flat_s = time.perf_counter() - t
    d_flat = _hold_params(pf, pg, ef, eg[pdata.c_rows, pdata.c_cols])
    del pf, ef
    log(f"phase 14 one epoch from one start: gather {epoch_s[0]:.3f}s, "
        f"pregather {pre_s:.3f}s (max |d param| {d_pre:.3g}), flat mfsi.epoch "
        f"{flat_s:.3f}s (max |d param| {d_flat:.3g}); rtol {TENSOR_RTOL} atol "
        f"{TENSOR_ATOL} (e atol {TENSOR_E_ATOL})")
    e0 = mfsi.residuals_padded(params0, x, z, data, pdata)
    log(f"phase 14 epoch breakdown (torch.profiler, one gather epoch and a "
        f"copy of its start grid): {epoch_breakdown(lambda: mfsi.epoch_padded(params0, x, z, pdata, e0.clone(), hp), top=12)}")
    del e0
    # one segment sum of each context field's layer (an epoch makes five a
    # layer and column): where the index_add_ time goes, field by field
    from repro_torch.sparse.segment import segment_sum

    seg = []
    for f, (ids_g, xw, _, vocab, offset, _) in zip(x.fields,
                                                   mfsi._field_layers(x, hp)):
        local = ids_g - offset
        seg.append(f"{f.name} ({vocab}, {xw.numel()} entries) "
                   f"{device_ms(lambda j: segment_sum(xw, local, vocab), n=10):.4f}")
    log(f"phase 14 segment sums, ms a call by context field: {', '.join(seg)}")

    # 16 users' queries through the top-K kernel
    users = torch.arange(16, device=dev) * (FULL["n_ctx"] // 16) + 5
    phi = mfsi.build_phi(p, x, users)
    psi = mfsi.export_psi(p, z)
    want_phi = mfsi.phi(p, x)[users]
    torch.testing.assert_close(phi, want_phi, rtol=1e-5, atol=1e-6)
    tops.topk_score.launches = 0
    s, i = tops.topk_score(phi, psi, 100)
    rs, ri = tref.topk_score_ref(phi, psi, 101)
    torch.cuda.synchronize()
    assert tops.topk_score.launches == 1
    torch.testing.assert_close(s, rs[:, :100], rtol=RTOL, atol=ATOL)
    ids_agree(rs[:, :100], ri[:, :100], i, rs[:, 100])
    exact = int((i == ri[:, :100]).all(1).sum())
    log(f"phase 14 queries: 16 users' build_phi(rows) against export_psi, "
        f"top-100 through 1 top-K launch; ids equal to the plain recompute "
        f"in {exact}/16 rows outright, and at every slot outside a near-tie")
    return {"launches": launches, "pre_launches": pre_launches, "pdata": pdata}


def time_slab_kernels(dev, pdata) -> dict:
    """Phase 15: CUDA-event times of kernels 6–9 at both sides' full-width
    shapes, on the MFSI log's ids and α with random values (m = 8, the ψ
    slab a column slice of a k = 128 table), beside their plain versions,
    their bounds and, for the pre-gathered forms, the one ``torch.bmm``
    (``baddbmm``) that computes the same function on the same tile."""
    from repro_torch.kernels.cd_sweep import ops as cs, ref as cr
    from repro_torch.obs.costs import cd_resid_patch_cost, cd_slab_reduce_cost

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(15)
    m = 8
    names = ("cd_slab_reduce", "cd_slab_reduce_gather", "cd_resid_patch",
             "cd_resid_patch_gather")
    out = {n: {"ms": [], "plain": [], "bound": [], "lib": []} for n in names}
    sides = (("context", pdata.item_ids, pdata.alpha_c, FULL["n_items"]),
             ("item", pdata.ctx_ids, pdata.alpha_i, FULL["n_ctx"]))
    for side, ids, alpha, n_src in sides:
        c, d = alpha.shape
        x = slab_inputs(gen, dev, c, d, m, n_src, pad_frac=0, k=FULL["k"],
                        ids=ids, alpha=alpha)
        tab, e, dphi = x["tab"], x["e"], x["dphi"]
        psi = cr.gather_psi_blk(tab, ids).contiguous()
        es = [e.clone() for _ in range(2)]
        calls = {
            "cd_slab_reduce": (lambda i: cs.cd_slab_reduce(psi, alpha, es[i % 2]),
                               lambda i: cr.cd_slab_reduce_ref(psi, alpha, es[i % 2]),
                               lambda i: torch.bmm(
                                   psi * alpha[:, None, :],
                                   torch.cat([psi, es[i % 2][:, None, :]], 1)
                                   .transpose(1, 2))),
            "cd_slab_reduce_gather": (
                lambda i: cs.cd_slab_reduce_gather(tab, ids, alpha, es[i % 2]),
                lambda i: cr.cd_slab_reduce_gather_ref(tab, ids, alpha, es[i % 2]),
                None),
            "cd_resid_patch": (lambda i: cs.cd_resid_patch(psi, es[i % 2], dphi),
                               lambda i: cr.cd_resid_patch_ref(psi, es[i % 2], dphi),
                               lambda i: torch.baddbmm(es[i % 2][:, None, :],
                                                       dphi[:, None, :], psi)),
            "cd_resid_patch_gather": (
                lambda i: cs.cd_resid_patch_gather(tab, ids, es[i % 2], dphi),
                lambda i: cr.cd_resid_patch_gather_ref(tab, ids, es[i % 2], dphi),
                None),
        }
        for name in names:
            fn, plain, lib = calls[name]
            gather = name.endswith("gather")
            cost = (cd_slab_reduce_cost if "slab" in name else cd_resid_patch_cost)(
                c, d, m, n_src=n_src, gather=gather)
            r = out[name]
            r["ms"].append(device_ms(fn, n=20))
            r["plain"].append(device_ms(plain, n=5))
            r["lib"].append(device_ms(lib, n=10) if lib else None)
            r["bound"].append(bound(cost["hbm_bytes"], cost["flops"]))
            lib_txt = f"{r['lib'][-1]:.4f} ms" if lib else "—"
            log(f"phase 15 {name} {side} side (C {c}, D_pad {d}, m {m}, n_src "
                f"{n_src}): kernel {r['ms'][-1]:.4f} ms, plain "
                f"{r['plain'][-1]:.4f} ms, library {lib_txt}, bound "
                f"{r['bound'][-1][0]:.4f} ms ({r['bound'][-1][1]}: "
                f"{cost['hbm_bytes']:.0f} B, {cost['flops']:.0f} FLOP)")
        del x, psi, es
    return out


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        sys.exit(1)
    from repro_torch.kernels import build
    from repro_torch.kernels.cd_sweep import kernel as cd_kernel
    from repro_torch.kernels.gram import kernel as gram_kernel
    from repro_torch.kernels.topk_score import kernel, ops, ref
    from repro_torch.launch import serve

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)

    # 1. build every kernel, one nvcc per source, all at once
    libs = [kernel.LIB, gram_kernel.LIB, cd_kernel.LIB, cd_kernel.SLAB_LIB]
    t0 = time.perf_counter()
    paths = build.build_all(libs)
    log(f"phase 1 build: {', '.join(p.name for p in paths)} in "
        f"{time.perf_counter() - t0:.1f}s (in parallel)")
    for lib in libs:
        ptxas = [ln.split("'")[1][:40] if "Compiling entry" in ln else ln.strip()
                 for ln in lib.build_log.splitlines()
                 if "registers" in ln or "spill" in ln or "smem" in ln
                 or "Compiling entry" in ln]
        log(f"phase 1 ptxas {lib.name}: {' | '.join(ptxas)}")

    # 2. kernel vs plain version on the card
    gen = torch.Generator(device=dev).manual_seed(1)
    err = max(check_random(ops, ref, gen, dev, exclude=False),
              check_random(ops, ref, gen, dev, exclude=True))
    check_exact(ops, ref, np.random.default_rng(2), dev)
    log(f"phase 2 hold: random fp32 at B=16 x 34000 x 128, K=100 (both "
        f"forms) max |score err| = {err:.3g} (rtol {RTOL}, atol {ATOL}); "
        f"integer cases exact")

    # 3. the serving path at full icd-mf width
    ops.topk_score.launches = 0
    report = check_serve(ref, serve, ["--arch", "icd-mf", "--device", "cuda",
                                      "--requests", "256", "--shards", "2",
                                      "--replicas", "2", "--kill", "0:0"], dev)
    launches = ops.topk_score.launches
    ms = report["mesh_stats"]
    assert launches >= 1 and launches == ms["dispatches"] - ms["faults"], (
        "every successful mesh dispatch must launch the kernel once",
        launches, dict(ms))
    flushes = report["batcher_stats"]["flushes"]
    log(f"phase 3 serve: 256 requests, {flushes} flushes, "
        f"{launches} kernel launches ({launches / flushes:.2f} per flush), "
        f"{ms['dispatches']} dispatches, {ms['faults']} faults, "
        f"coverage 1.0, 16 users match the plain recompute; "
        f"{256 / report['seconds']:.1f} req/s, completion "
        f"p50 {np.percentile(report['completion_s'], 50) * 1e3:.3f} ms "
        f"p99 {np.percentile(report['completion_s'], 99) * 1e3:.3f} ms")

    # 4. time at the serving shapes
    b, rows, d, k = (SERVE_SHAPE[x] for x in ("b", "rows", "d", "k"))
    phi = torch.randn((b, d), generator=gen, device=dev)
    slabs = [torch.randn((rows, d), generator=gen, device=dev) for _ in range(4)]

    def serve_call(j):
        return ops.topk_score(phi, slabs[j % 4], k, id_offset=rows, n_valid=rows)

    kernel_ms = device_ms(serve_call)
    plain_ms = device_ms(lambda j: ref.topk_score_ref(
        phi, slabs[j % 4], k, id_offset=rows, n_valid=rows))
    library_ms = device_ms(lambda j: torch.topk(phi @ slabs[j % 4].T, k))
    log(f"phase 4 breakdown (torch.profiler, per call): "
        f"{kernel_breakdown(serve_call)}")
    # the large-K path at the same shard (K = 1,000: four merge levels'
    # worth of keys per φ row in one 128 KB block)
    wide_ms = device_ms(lambda j: ops.topk_score(phi, slabs[j % 4], 1_000,
                                                 id_offset=rows, n_valid=rows), n=20)
    wide_plain = device_ms(lambda j: ref.topk_score_ref(
        phi, slabs[j % 4], 1_000, id_offset=rows, n_valid=rows), n=10)
    log(f"phase 4 large K: topk_score K=1000 {wide_ms:.4f} ms, plain "
        f"{wide_plain:.4f} ms, torch.topk(phi @ psi.T, 1000) "
        f"{device_ms(lambda j: torch.topk(phi @ slabs[j % 4].T, 1_000), n=10):.4f} ms; "
        f"breakdown {kernel_breakdown(lambda j: ops.topk_score(phi, slabs[j % 4], 1_000))}")
    nbytes = 4 * (b * d + rows * d) + 8 * b * k
    flops = 2 * b * rows * d
    bound_ms = max(nbytes / H100_BYTES_PER_S, flops / H100_FP32_FLOPS) * 1e3
    bound_by = "bytes" if nbytes / H100_BYTES_PER_S >= flops / H100_FP32_FLOPS else "operations"
    log(f"phase 4 time: topk_score {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"torch.topk(phi @ psi.T) {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}: {nbytes} B, {flops} FLOP); phase 3's {launches} launches "
        f"at this time are {launches * kernel_ms:.3f} ms of its "
        f"{report['seconds'] * 1e3:.3f} ms trace "
        f"({100 * launches * kernel_ms / (report['seconds'] * 1e3):.1f}%)")

    del phi, slabs, report

    # 5.-8. the training slice
    t0 = time.perf_counter()
    errs = hold_training_kernels(dev)
    log(f"phase 5 hold: gram max |err| {errs['gram']:.3g} (random fp32; "
        f"rtol {GRAM_RTOL}, atol {GRAM_ATOL_REL} x max|J|; integer cases "
        f"exact), gather sweep {errs['cd_block_sweep_gather']:.3g}, "
        f"pre-gathered sweep {errs['cd_block_sweep']:.3g} (rtol {SWEEP_RTOL}, "
        f"atol {SWEEP_ATOL}); edge cases and small epochs pass; "
        f"{time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    tr = train_full_width(dev)
    log(f"phase 6 done in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    times = time_training_kernels(dev, tr["pdata"], tr["params"])
    log(f"phase 7 done in {time.perf_counter() - t0:.1f}s")
    run_quickstart(dev)

    # 9.-12. the tensor models
    n_src = CTX["nnz"] + 1
    t0 = time.perf_counter()
    rp_errs = hold_rowpatch_kernels(dev, n_src)
    log(f"phase 9 hold: row-patch sweeps max |err| pre-gathered "
        f"{rp_errs['cd_block_sweep_rowpatch']:.3g}, gather "
        f"{rp_errs['cd_block_sweep_rowpatch_gather']:.3g} (rtol {SWEEP_RTOL}, "
        f"atol {SWEEP_ATOL}; long rows + {LONG_ROW_REL} x the row's sum of "
        f"|a e psi| / den); edge cases pass; {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    ctx = train_ctxmf_full_width(dev)
    log(f"phase 10 done in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    train_tucker_full_width(dev, ctx["tc"], ctx["data"], ctx["padded"])
    log(f"phase 11 done in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    rp_times = time_rowpatch_kernels(dev, ctx["padded"], n_src)
    log(f"phase 12 done in {time.perf_counter() - t0:.1f}s")
    del ctx["data"], ctx["padded"]

    # 13.-15. the fielded design, MFSI, the slab-reduce and residual-patch kernels
    t0 = time.perf_counter()
    slab_errs = hold_slab_kernels(dev)
    log(f"phase 13 done in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    fm = train_mfsi_full_width(dev)
    log(f"phase 14 done in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    slab_times = time_slab_kernels(dev, fm["pdata"])
    log(f"phase 15 done in {time.perf_counter() - t0:.1f}s")
    del fm["pdata"]

    def row(name, source, replaces, launches, err, t, library):
        """A kernel's JSON row; times are per launch, averaged over the
        two sides' launches an epoch makes."""
        mean = lambda xs: float(np.mean(xs))  # noqa: E731
        by = {b for _, b in t["bound"]}
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": mean(t["ms"]),
                "plain_ms": mean(t["plain"]),
                "bound_ms": mean([b for b, _ in t["bound"]]),
                "bound_by": by.pop() if len(by) == 1 else "bytes",
                "library_ms": None if library is None else mean(library)}

    cd_src = "src/repro_torch/kernels/cd_sweep/csrc/cd_sweep.cu"
    print(json.dumps({"kernels": [{
        "name": "topk_score", "route": "cuda",
        "source": "src/repro_torch/kernels/topk_score/csrc/topk_score.cu",
        "replaces": "src/repro/kernels/topk_score/kernel.py:159",
        "launches": launches, "max_abs_err": err, "ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms,
    }, row("gram", "src/repro_torch/kernels/gram/csrc/gram.cu",
           "src/repro/kernels/gram/kernel.py:49", tr["launches"]["gram"],
           errs["gram"], times["gram"], times["gram"]["lib"]),
       row("cd_block_sweep", cd_src,
           "src/repro/kernels/cd_sweep/kernel.py:119",
           tr["pregather_launches"], errs["cd_block_sweep"],
           times["pregather"], None),
       row("cd_block_sweep_gather", cd_src,
           "src/repro/kernels/cd_sweep/kernel.py:429",
           tr["launches"]["cd_block_sweep_gather"],
           errs["cd_block_sweep_gather"], times["gather"], None),
       row("cd_block_sweep_rowpatch", cd_src,
           "src/repro/kernels/cd_sweep/kernel.py:207",
           ctx["pre_launches"]["cd_block_sweep_rowpatch"],
           rp_errs["cd_block_sweep_rowpatch"], rp_times["pregather"], None),
       row("cd_block_sweep_rowpatch_gather", cd_src,
           "src/repro/kernels/cd_sweep/kernel.py:519",
           ctx["launches"]["cd_block_sweep_rowpatch_gather"],
           rp_errs["cd_block_sweep_rowpatch_gather"], rp_times["gather"],
           None)] + [
        row(name, "src/repro_torch/kernels/cd_sweep/csrc/cd_slab.cu",
            f"src/repro/kernels/cd_sweep/kernel.py:{line}",
            (fm["launches"] if name.endswith("gather") else fm["pre_launches"])[name],
            slab_errs[name], slab_times[name],
            None if name.endswith("gather") else slab_times[name]["lib"])
        for name, line in (("cd_slab_reduce", 275), ("cd_slab_reduce_gather", 585),
                           ("cd_resid_patch", 331), ("cd_resid_patch_gather", 646))]}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
