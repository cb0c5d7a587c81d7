"""GPU smoke test of the PyTorch port: build, hold, serve, time.

  python3 chip_smoke.py

Needs one CUDA card (an H100 for the numbers to mean what PERF.md says).
Phases, one line each:

  1. build the hand-written top-K kernel from ``csrc/`` with nvcc;
  2. hold the kernel against its plain PyTorch version on the card: random
     fp32 data at the serving driver's shapes (B=16, one 34,000-row shard,
     D=128, K=100, id_offset=34,000, n_valid short of the shard), with and
     without exclude-id lists, plus small-integer cases whose scores are
     exact (ties across blocks, K > n_valid, fully excluded rows, ragged
     chunks and row blocks), where ids must match exactly;
  3. serve 256 requests through ``repro_torch.launch.serve.main`` at full
     icd-mf width (200,000 × 68,000 × k=128, top-100, 2 shards × 2
     replicas, replica (0, 0) killed) and check coverage, the kernel's
     launch count, and 16 users' results against a plain recompute over
     the whole ψ table;
  4. time the kernel, its plain version and ``torch.topk(phi @ psi.T)``
     (a yardstick the port never calls) with CUDA events, beside the
     card's bound for the same work.

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
        (3, 700, 4, 256, 0, 700, 0, False),                  # the largest K
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


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        sys.exit(1)
    from repro_torch.kernels.topk_score import kernel, ops, ref
    from repro_torch.launch import serve

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)

    # 1. build
    t0 = time.perf_counter()
    lib = kernel.build()
    ptxas = [ln.strip() for ln in kernel.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    log(f"phase 1 build: {lib.name} in {time.perf_counter() - t0:.1f}s; "
        f"ptxas: {' | '.join(ptxas)}")

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

    print(json.dumps({"kernels": [{
        "name": "topk_score", "route": "cuda",
        "source": "src/repro_torch/kernels/topk_score/csrc/topk_score.cu",
        "replaces": "src/repro/kernels/topk_score/kernel.py:159",
        "launches": launches, "max_abs_err": err, "ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms,
    }]}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
