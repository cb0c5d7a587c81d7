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
     every call at K ≤ 256 (the one-launch form) also against the
     three-launch chain it replaced, bit for bit;
  3. serve 256 requests through ``repro_torch.launch.serve.main`` at full
     icd-mf width (200,000 × 68,000 × k=128, top-100, 2 shards × 2
     replicas, replica (0, 0) killed), after a 32-request warm-up run of
     the same driver, and check coverage, the kernel's launch count, and
     16 users' results against a plain recompute over
     the whole ψ table;
  4. time the top-K kernel (one launch, ``topk_fused_kernel``), the
     three-launch chain it replaced, its plain version and
     ``torch.topk(phi @ psi.T)`` (a yardstick the port never calls) with
     CUDA events, beside the card's bound for the same work; the
     profiler's breakdown (one kernel a call); a call with 20 excluded ids
     a row, the serving trace's form;
  5. hold the Gram and block-sweep kernels against their plain versions:
     at the full-width dispatch shapes (Gram of 200,000 × 128 and
     68,000 × 128, weighted and not, in small integers, where the sums are
     exact, and in random fp32, two calls giving the same bits; the odd
     shapes (7, 16), (1,000, 12), (130, 130), (0, 8), (33, 1); the gather sweep on both sides and the
     pre-gathered sweep on the context side), and at small edge cases (k
     not divisible by k_b, row counts off the row tile, all-zero-α rows
     with l2 = 0 and α₀ = 0, padding ids, η ≠ 1, k_b = 1, and a whole
     ``mf_padded`` epoch on the card against the same epoch on the CPU),
     each sweep called twice for the same bits, the gather sweep's rows of
     up to 2,048 slots in the register-row form (``csrc/cd_gather.cu``);
     and long rows (ROADMAP fault 3.3): ``mf_padded`` with one item row
     at D_pad 20,096, k_b 8, two epochs on the card — the item side in the
     split-row form with the shared J, or pre-gathered in the block-row
     form — against the same epochs on the CPU;
  6. train icd-mf at full width on a seeded log (200,000 users × 68,000
     items, k = 128): ``mf_padded.fit`` for 3 epochs with the defaults,
     the objective falling every epoch, the kernels' launches counted;
     then from one start one epoch each with ``psi_dispatch='pregather'``
     and with the segment-sum ``mf.epoch``, held against the gather epoch;
     and a streaming ranking evaluation of the trained model through the
     top-K kernel, held against the plain version;
  7. time the Gram and sweep kernels at the full-width shapes beside their
     plain versions, the library call where one exists (``torch.mm(x.T,
     x)`` for the Gram), and their bounds, and the Gram at 1, 2, 4 and 8
     diagonal blocks an SM; the gather sweep's register-row form beside
     the warp-row form it replaced (and how far each lands from the plain
     version from one random start);
  8. run the quickstart twin on the card (iCD-MF must beat popularity);
  9. hold the row-patch block sweeps (kernels 4 and 5) against their plain
     versions, each called twice for the same bits: both routings at the
     full-width user-side shape (C = 200,000, D_pad = 128, k_b = 8, a slab
     of nnz + 1 rows) — the gather one in the register-row form
     (``csrc/cd_gather.cu``), also equal bit for bit to the warp-row form
     it replaced —, both at the bucket-side shape (C = 24, D_pad =
     142,464) — the gather one in the split-row form, the pre-gathered one
     in the block-row form —, and edge cases (C off the row tile, a
     4-column tail, k_b = 1, 3, 4 and 8 on long rows no chunk divides, one
     off a multiple of 4, η ≠ 1, ids past both ends, all-α = 0 rows with
     l2 = α₀ = 0, the shared-J sweep on long rows);
 10. train CtxMF at full width (200,000 users × 24 hour-of-day buckets ×
     68,000 items, k = 128) on phase 6's log with seeded timestamps over
     28 days: 3 ``epoch_padded`` epochs (objective falling and within
     rtol 1e-4 of the earlier forms' CTX_OBJECTIVES, launches counted by
     form: 48 register-row and 48 split-row row-patch launch chains), one
     pregather and one flat epoch from one start
     held against the default one, one profiled epoch, one
     ``dense_context`` epoch, and 16 (user, bucket) queries through the
     top-K kernel against a plain recompute;
 11. Tucker: one ``epoch_padded`` on the same log at k1 = k2 = k3 = 8
     (objective falling), and small PARAFAC and Tucker epochs on the card
     against the same epochs on the CPU;
 12. time the row-patch kernels at both full-width shapes beside their
     plain versions and their bounds, the gather routing's register-row
     and split-row forms beside the warp-row and block-row forms they
     replaced;
 13. hold the slab-reduce and residual-patch kernels (kernels 6–9, both ψ
     routings) against their plain versions: at both sides' full-width
     shapes (context C = 200,000, D_pad = 128, n_src = 68,000; item C =
     68,000, D_pad = 1,024, n_src = 200,000; m = 8, the ψ slab a column
     slice of a k = 128 table), at m = 9 and 17 with strided slabs, on rows
     of 20,480 slots and with ids past the slab, each slab reduce called
     twice for the same bits, both at m ≤ 9 in the one-tile form
     (``csrc/cd_gather.cu``; its m = 9 instance also on FM's 9-column slab
     at both sides' full width) equal bit for bit to the tiled form
     (``csrc/cd_slab.cu``, which m = 17 takes), and the gather residual patch at m ≤ 8
     in its register-slot form equal bit for bit to the one-slot kernel,
     at m = 1–9, slabs with and without 16-byte loads, D_pad off a
     multiple of 4;
 14. train MFSI at icd-fm width (200,000 contexts over 7 fields, p_ctx =
     336,091, 68,000 items, k = 128) on phase 6's log with a seeded
     context design: 3 ``epoch_padded`` epochs (objective falling, 96
     launches each of the gather slab reduce and residual patch, all in
     the one-tile and register-slot forms), one
     pregather epoch (its slab reduce in the one-tile form, its objective
     beside the gather epoch's) and one flat epoch from one start held
     against the default one, one profiled epoch, and 16 users' queries
     through the top-K kernel against a plain recompute;
 15. time kernels 6–9 at both sides' full-width shapes beside their plain
     versions, their bounds and, for the pre-gathered forms, one
     ``torch.bmm``/``baddbmm`` over the same tile; the slab reduce's
     one-tile form (both routings, equal bit for bit) and the gather
     residual patch's register-slot form beside the tiled and one-slot
     kernels they replaced.

 16. serve the quantized IVF tier at full icd-mf width on phase 6's trained
     factors: ``FaultTolerantRetrievalMesh(retrieval="ivf",
     ann=AnnConfig(quant=q))`` for q in none, bf16 and int8 (2 shards × 2
     replicas, AnnConfig's defaults: 184 clusters a shard, n_probe 46,
     replica (0, 0) killed), 256 single-row requests with exclude lists
     through the ``MicroBatcher``: coverage, the top-K kernel's IVF launch
     chains (one a live shard and flush, and no other launch), probed
     blocks per flush, req/s,
     completion p50/p99, the oracle probe (bit-identical to the exact mesh
     for fp32, equal to a plain recompute over the dequantized table for
     bf16 and int8), the recall curve over n_probe and one profiled query;
     then ``publish_delta`` of 8 patched and 8 appended rows (each
     retrievable) and a 72-row patch that spends the index's staleness
     budget (``ann_reindexes_total``); a ``StagedRollout`` that promotes a
     good table and rolls back a NaN one; and a 4-shard
     ``ShardedRetrievalCluster`` fed by a ``PsiPublisher`` over 2
     ``mf_padded.fit`` epochs, whose top-K with a dense exclusion mask
     (sliced per shard, read in place) equals the engine's bit for bit;
 17. time the top-K kernel's fp32, bf16, int8 and dense-mask forms at the
     serving shard and K = 10,000, each beside its plain version, its bound
     and the yardstick ``torch.topk(phi @ deq(psi).T, k)``; its IVF form
     over phase 16's shard-0 index of each storage form (16 rows, n_probe
     46), held against its plain version and timed beside the yardstick
     ``torch.topk`` over the masked dense scores; the three-launch chain
     beside each exact form's one launch; tables of 9, 40 and 100 rows in
     one launch and in the chain at their narrowest chunk and at the full
     one; and the large-K merge
     at K = 257, 512, 1,000 and 8,192 likewise;
 18. run the serve_retrieval twin on the card (train → publish, cluster,
     batcher, sharded eval, failover, canary rollout, IVF with int8 ψ);
 19. train FM at icd-fm width (``configs/icd_fm``: p_ctx 336,091, 68,000
     items, k = 128, D = k + 2 = 130) on phase 14's log and designs: 3
     ``epoch_padded`` epochs with the defaults (block_k 0 → k_b 8, m = 9:
     96 launches each of the gather slab reduce, all in the one-tile
     form's m = 9 instance, and the one-slot gather residual patch, 6 Gram
     launches; the objective falling), then from one start a pregather
     (32 one-tile slab reduces), a flat and a block_k 7 (m = 8:
     the one-tile and register-slot forms) epoch held against the gather
     one, their wall times in turns, and one profiled epoch at m = 9 and
     at m = 8;
 20. time the Gram of Φe (200,000 × 130) and Ψe (68,000 × 130) beside
     ``torch.mm`` and kernels 6–9 at m = 9 at both sides' shapes beside
     their plain versions, bounds and ``torch.bmm``/``baddbmm``, the slab
     reduces' one-tile form beside the tiled form it replaced (bit for
     bit);
 21. serve FM from the Model API (``RetrievalEngine.from_model`` over Ψe):
     16 users' top-100 in one top-K launch at D = 130, bit for bit the
     chain, against a plain recompute, and its time; fold in a user and an
     item for MF and for FM on the card (one Gram launch each), each row
     against the same fold-in on the CPU, with its wall time, and against
     the float64 oracle on the CPU: the Gram kernel's G against TᵀT,
     ``fold_in_exact``'s row a fixed point of one card sweep, and a row
     that converged (MF's) equal to it (FM's distance printed); a
     cold-start ranking eval of 64 MF users through fold-in;
 22. run the serve driver with ``--continual`` at full icd-mf width: the
     fold-in user's and item's rows against the CPU's, their answers
     against a plain recompute, the delta publish's version;
 23. run the continual-learning twin's loop at full icd-mf width on phase
     6's log in time order (one swap of item ids puts a cold item among
     the replayed events): 6 warm ``mf.fit`` epochs through the Model API
     on the head (80%, the last 4 item ids cold), a 2-shard
     ``ShardedRetrievalCluster`` (K 10) fed by a ``PsiPublisher``, 4 tail
     batches of 64 events through ``interaction_stream`` (a fold-in and a
     top-K a user, the cold items folded in and delta-published, a
     rotating-block refresh a batch), a cold-start eval of 256 users; the
     counts, versions and launches against the host's count of the log, 8
     queries against the plain top-K and the CPU's fold-in, the wall and
     device time a query, the peak memory;
 24. the training stack on phase 6's interactions: ``launch.train``'s loop
     for 3 epochs (the objective falling), the same epochs as ``Trainer``
     steps with a ``Checkpointer``, stopped after epoch 1 and resumed,
     bit for bit the uninterrupted run (deterministic algorithms on), the
     checkpoint's size and save and restore seconds; 2 iALS epochs (peak
     memory, seconds an epoch, the objective falling); 100 BPR steps of
     batch 4,096 against the same steps on the CPU;
 25. ``python -m repro_torch.launch.train --arch icd-mf --smoke --steps 10``
     as a subprocess, the continual-learning twin at its own sizes (the
     reference example's counts) and the observability twin into a
     temporary directory, whose three files must parse;
 26. the distribution layer in an NCCL world of one (an in-memory store,
     no port) at full icd-mf width on phase 6's log: ``shard_interactions``
     (its host seconds), ``sharded_gram`` through the Gram kernel bit for
     bit the single-device kernel, two ``mf_dist`` epochs each for
     gather/fp32, route/fp32 and route/bf16 from the start of two flat
     ``mf.epoch``s (fp32 within the reference's rtol 5e-4 / atol 5e-5,
     bf16's objective within 1%, objectives falling; wall times,
     collectives and Gram launches an epoch; one profiled epoch; one
     collective's wall time), ``shard_map_topk`` bit for bit
     ``cluster_topk`` and both timed, ``compressed_psum``, and a DTensor
     checkpoint restored with ``shardings=`` bit for bit; then the world
     is torn down;
 27. the dry run's cells (``launch/cells.py``) for real, in an NCCL world
     of one on a 1 × 1 mesh at their global shapes: the retrieval cell
     (``shard_map_topk``, B 4,096 × 1,000,000 × 128, K 100, one top-K
     launch; ids of 64 rows equal the plain version's) and the
     ``epoch_youtube`` train cell (one ``mf_dist`` gather epoch at 200,000
     × 68,000 × 128 on a seeded log of ≈ 20 M interactions, two Gram
     launches; the objective falling; within phase 26's tolerance of the
     flat ``mf.epoch`` from the same start), each beside the dry run's
     roofline terms for the same step (a fake world of one, meta tensors)
     and the retrieval kernel beside ``torch.topk(phi @ psi.T)``; the
     log's seconds (drawn on the card), ``shard_interactions``' host
     seconds, the phase's wall and peak memory. ``epoch_web`` (500 M
     interactions) is dry-run only;
 28. the sorted segment sum (``kernels/segment_sum``) at the cells' log
     shape (``bench.harness.traffic.draw_log``, the ``youtube`` mix:
     19,992,436 entries, 200,000 context rows, 68,000 item rows, the top
     item ≈ 97,294): two and four values on each side, against the float64
     sums (1e-6 of a row's Σ|x| + 1) and twice for the same bits, timed
     beside its byte bound, its plain version, the ``zeros`` +
     ``index_add_`` it replaced and ``torch.segment_reduce``;
 29. Tucker's core sweep by core slab (``kernels/tucker_core``) at the
     ``tucker-train-youtube-hourly`` cell's shape (the benchmark's inputs:
     ranks 16, 4, 32, ≈ 2.8 M (user, hour) pairs, 19,992,436
     interactions): the kernels' steps and residuals against the blocked
     plain form in float64 and twice for the same bits; one slab pass and
     one solve, the kernels' sweep and ``tucker.core_sweep`` whole, beside
     the pass's bounds, the plain form and the per-coordinate loop it
     replaced; one ``tucker.epoch`` (seconds, launches, 64 slabs);
 30. Tucker's mode sweeps by column (``kernels/tucker_mode``) at the same
     cell's inputs: the u and v sweeps by the kernels against the per-column
     body they replaced in float64 (norm gaps of u, v, Φ and e) and twice
     for the same bits; a column's pass and solve (the profiler's ms a
     launch) and each sweep whole (CUDA events) beside a column's bound, the
     plain form and the per-column body in float32; one ``tucker.epoch``
     (seconds, launches, the kernels' columns).

Phase 2 also holds the top-K kernel's large-K path (K = 257, 1,000 and
2,048, K past n_valid) in small integers, exactly, and its bf16, int8
(per-row scale) and dense-mask forms: on random data at the serving shard
(the mask also as a middle shard's strided column slice), and exactly in
small integers (int8 with scale 1, bf16 integers up to 256, ties across
chunks, fully masked rows), with K = 8,193, 10,000 and 20,000 over 40,000
rows (the device-memory merge).

``python3 chip_smoke.py --serve-order BEFORE`` runs only phase 3's order
check (:func:`serve_first_runs`); ``--gram-tune`` only the Gram's variants
(:func:`gram_tune`); ``--sweep-tune`` only the variants of
``csrc/cd_gather.cu`` (:func:`sweep_tune`: blocks an SM, slots a thread,
the split-row form's chunk length, the residual patch's slots a thread);
``--slab-tune`` only the variants of the slab reduce's m = 9 instance
(:func:`slab_tune`: blocks an SM, slots in flight); ``--topk-tune`` only the variants of the top-K kernel's one-launch form
(:func:`topk_tune`: threads a block, blocks an SM, blocks a cluster);
``--dist`` only phase 26, and ``--cells`` only phase 27, after building
the Gram and top-K kernels; ``--segment-sum`` only phase 28, after
building the segment-sum kernel; ``--segment-sum-tune`` only the variants
of ``csrc/segment_sum.cu`` (:func:`segment_sum_tune`: threads a block, path
items a lane); ``--tucker-core`` only phase 29, after building the
core-sweep kernel; ``--tucker-mode`` only phase 30, after building the
mode-sweep kernel.

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

# each user's watch history as ``benchmarks/experiments.py`` builds it
# (``_merge_bag``): the user's last logged items, each weighing 1/len
from bench.harness.traffic import last_items as history_bags  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in full fp32

# fp32 scores of the kernel (sequential FMAs over D) against the plain
# version (a cuBLAS product, another summation order): at D=128 and scores
# of magnitude ≲ 40, the two differ by a few ulps of the largest partial sum
RTOL, ATOL = 1e-5, 1e-5
H100_BYTES_PER_S = 3.35e12      # HBM3, SXM data sheet
H100_FP32_FLOPS = 67e12         # fp32 outside the tensor cores
SERVE_SHAPE = dict(b=16, rows=34_000, d=128, k=100)
# phase 3's serve driver: icd-mf, 2 shards × 2 replicas, replica (0, 0) dead
SERVE_ARGV = ["--arch", "icd-mf", "--device", "cuda", "--shards", "2",
              "--replicas", "2", "--kill", "0:0"]


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


CHAIN_HELD = {"calls": 0}


def hold_chain(ops, got, phi, psi, k, *args, **kw) -> None:
    """The one-launch form's result ``got`` against the three-launch chain
    it replaced on the same inputs, bit for bit (NaN and −0.0 included),
    for K ≤ 256 (larger K takes the chain in both); counted in
    CHAIN_HELD."""
    from repro_torch.kernels import vmem

    if vmem.topk_form(k) != vmem.TOPK_FUSED:
        return
    s, i = ops.topk_score(phi, psi, k, *args, form=vmem.TOPK_CHAIN, **kw)
    torch.cuda.synchronize()
    assert torch.equal(i, got[1]) and torch.equal(
        s.view(torch.int32), got[0].view(torch.int32)), (
        "the fused and chain forms differ", tuple(phi.shape), tuple(psi.shape), k)
    CHAIN_HELD["calls"] += 1


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
    hold_chain(ops, (s, i), phi, psi, k, exclude_ids=eids, id_offset=off,
               n_valid=n_valid)
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
        (16, 34_000, 128, 257, 34_000, 33_000, 0, False),    # large K: device-memory merge
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
        hold_chain(ops, (s, i), phi, psi, k, exclude_ids=eids, id_offset=off,
                   n_valid=n_valid)
        assert torch.equal(i, ri), f"ids differ on integer case {b, rows, d, k}"
        assert torch.equal(s, rs), f"scores differ on integer case {b, rows, d, k}"
        if full:
            assert bool((i[0] == -1).all()) and bool(torch.isneginf(s[0]).all())
        if k > n_valid:
            assert bool((i[:, n_valid:] == -1).all())


def _forms(psi):
    """ψ's three stored forms at the serving shard: (name, stored ψ,
    per-row scale or None)."""
    from repro_torch.core.quant import int8_quantize_rows

    q, scale = int8_quantize_rows(psi)
    return [("bf16", psi.bfloat16(), None), ("int8", q, scale)]


def check_forms_random(ops, ref, gen, dev) -> dict:
    """Phase 2, the bf16, int8 and dense-mask forms on random data at the
    serving shard (B=16, 34,000 × 128, K=100, id_offset 34,000, n_valid
    short of the shard), against the plain version over the same stored
    table, at RTOL/ATOL; the mask whole (bool) and as the middle shard's
    column slice of a (16, 3 × 34,000) mask, read at its own stride."""
    from repro_torch.serve.cluster import _shard_exclude_mask

    b, rows, d, k = (SERVE_SHAPE[x] for x in ("b", "rows", "d", "k"))
    phi = torch.randn((b, d), generator=gen, device=dev)
    psi = torch.randn((rows, d), generator=gen, device=dev)
    off, n_valid = rows, rows - 1_000
    errs = {}
    for name, stored, scale in _forms(psi):
        s, i = ops.topk_score(phi, stored, k, psi_scale=scale, id_offset=off,
                              n_valid=n_valid)
        rs, ri = ref.topk_score_ref(phi, stored, k + 1, psi_scale=scale,
                                    id_offset=off, n_valid=n_valid)
        torch.cuda.synchronize()
        hold_chain(ops, (s, i), phi, stored, k, psi_scale=scale, id_offset=off,
                   n_valid=n_valid)
        torch.testing.assert_close(s, rs[:, :k], rtol=RTOL, atol=ATOL)
        ids_agree(rs[:, :k], ri[:, :k], i, rs[:, k])
        errs[name] = float((s - rs[:, :k]).abs().max())
    wide = torch.rand((b, 3 * rows), generator=gen, device=dev) < 0.1
    mid = _shard_exclude_mask(wide, rows, rows)
    assert not mid.is_contiguous() and mid.stride() == (3 * rows, 1)
    err = 0.0
    for mask in (wide[:, :rows].contiguous(), mid):
        s, i = ops.topk_score(phi, psi, k, mask, id_offset=off, n_valid=n_valid)
        rs, ri = ref.topk_score_ref(phi, psi, k + 1, mask.contiguous(),
                                    id_offset=off, n_valid=n_valid)
        torch.cuda.synchronize()
        hold_chain(ops, (s, i), phi, psi, k, mask, id_offset=off, n_valid=n_valid)
        torch.testing.assert_close(s, rs[:, :k], rtol=RTOL, atol=ATOL)
        ids_agree(rs[:, :k], ri[:, :k], i, rs[:, k])
        hit = torch.gather(mask, 1, torch.clamp(i - off, min=0).long()) & (i >= 0)
        assert not bool(hit.any()), "a masked id came back"
        err = max(err, float((s - rs[:, :k]).abs().max()))
    errs["mask"] = err
    return errs


def check_forms_exact(ops, ref, rng, dev) -> None:
    """Phase 2, small integers, where every score is exact in any order, so
    ids and scores must equal the plain version's: int8 with scale 1, bf16
    integers up to 256, ties across chunks (rows repeated), fully masked
    rows; and K = 8,193, 10,000 and 20,000 over 40,000 rows (the
    device-memory merge), ties in ascending id."""
    cases = [  # b, rows, d, k, id_offset, n_valid
        (16, 34_000, 128, 100, 34_000, 33_000),
        (19, 1_001, 16, 37, 5_000, 990),
        (5, 700, 6, 257, 0, 700),         # D·itemsize off 16 B: scalar loads
        (4, 1_500, 8, 1_000, 80, 1_490),
    ]
    for b, rows, d, k, off, n_valid in cases:
        phi = torch.tensor(rng.integers(-3, 4, (b, d)), dtype=torch.float32, device=dev)
        third = max(1, rows // 3)               # rows repeat: ties across chunks
        q = np.concatenate([rng.integers(-3, 4, (third, d))] * 4)[:rows]
        q8 = torch.tensor(q, dtype=torch.int8, device=dev)
        big = np.concatenate([rng.integers(-256, 257, (third, d))] * 4)[:rows]
        big = torch.tensor(big, dtype=torch.float32, device=dev)
        mask = torch.tensor(rng.random((b, rows)) < 0.2, device=dev)
        mask[0] = True                               # a fully masked row
        forms = [("int8", q8, torch.ones(rows, device=dev), None),
                 ("bf16", big.bfloat16(), None, None),
                 ("mask", q8.float(), None, mask)]
        for name, psi, scale, m in forms:
            s, i = ops.topk_score(phi, psi, k, m, psi_scale=scale,
                                  id_offset=off, n_valid=n_valid)
            rs, ri = ref.topk_score_ref(phi, psi, k, m, psi_scale=scale,
                                        id_offset=off, n_valid=n_valid)
            torch.cuda.synchronize()
            hold_chain(ops, (s, i), phi, psi, k, m, psi_scale=scale,
                       id_offset=off, n_valid=n_valid)
            assert torch.equal(i, ri), f"ids differ: {name} {b, rows, d, k}"
            assert torch.equal(s, rs), f"scores differ: {name} {b, rows, d, k}"
            if m is not None:
                assert bool((i[0] == -1).all()) and bool(torch.isneginf(s[0]).all())
    phi = torch.tensor(rng.integers(-3, 4, (5, 8)), dtype=torch.float32, device=dev)
    psi = torch.tensor(rng.integers(-3, 4, (40_000, 8)), dtype=torch.float32, device=dev)
    for k in (8_193, 10_000, 20_000):
        for n_valid in (40_000, 15_000):
            s, i = ops.topk_score(phi, psi, k, id_offset=3, n_valid=n_valid)
            rs, ri = ref.topk_score_ref(phi, psi, k, id_offset=3, n_valid=n_valid)
            torch.cuda.synchronize()
            assert torch.equal(i, ri) and torch.equal(s, rs), ("large K", k, n_valid)
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


def serve_first_runs(before: str) -> None:
    """Phase 3's order check, in a fresh process: the phase-2 checks named
    by ``before`` (``none``; ``fp32``: the fp32 random and integer checks;
    ``forms_random``; ``forms_exact``; ``phase2``: all of them), then the
    256-request serve driver twice, printing each run's trace time. Run
    as ``python3 chip_smoke.py --serve-order BEFORE``; the first run pays
    the process's one-time costs that ``before`` has not already paid."""
    from repro_torch.kernels import build
    from repro_torch.kernels.topk_score import kernel, ops, ref
    from repro_torch.launch import serve

    build.build_all([kernel.LIB])
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(1)
    if before in ("fp32", "phase2"):
        check_random(ops, ref, gen, dev, exclude=False)
        check_random(ops, ref, gen, dev, exclude=True)
        check_exact(ops, ref, np.random.default_rng(2), dev)
    if before in ("forms_random", "phase2"):
        check_forms_random(ops, ref, gen, dev)
    if before in ("forms_exact", "phase2"):
        check_forms_exact(ops, ref, np.random.default_rng(3), dev)
    for run in range(2):
        r = check_serve(ref, serve, SERVE_ARGV + ["--requests", "256"], dev)
        lat = np.asarray(r["completion_s"]) * 1e3
        log(f"serve order: after {before}, run {run}: trace "
            f"{r['seconds'] * 1e3:.3f} ms, completion p50 "
            f"{np.percentile(lat, 50):.3f} ms p99 {np.percentile(lat, 99):.3f} ms "
            f"(CUDA_MODULE_LOADING={os.environ.get('CUDA_MODULE_LOADING', 'unset')})")


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


def kernel_breakdown(fn, n: int = 20, as_list: bool = False):
    """Device time per call of each CUDA kernel ``fn`` launches, by name,
    from torch.profiler; "not measured" when the profiler sees none (with
    ``as_list``, the list of "name ms" parts)."""
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
    if as_list:
        return parts
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
    from repro_torch.kernels import vmem

    x = x or sweep_inputs(gen, dev, c, d, kb, n_src, k=k, pad_frac=pad_frac)
    kw = dict(alpha0=alpha0, l2=l2, eta=eta)
    if gather:
        rw, re = cr.cd_block_sweep_gather_ref(
            x["tab"], x["ids"], x["alpha"], x["e"], x["w"], x["r1"], x["j"], **kw)
        fn, first = cs.cd_block_sweep_gather, (x["tab"], x["ids"])
    else:
        psi = cr.gather_psi_blk(x["tab"], x["ids"]).contiguous()
        rw, re = cr.cd_block_sweep_ref(psi, x["alpha"], x["e"], x["w"],
                                       x["r1"], x["j"], **kw)
        fn, first = cs.cd_block_sweep, (psi,)
    reg = vmem.cd_sweep_form(d, kb, gather=gather) == vmem.REG_ROW
    before = (fn.launches, fn.launches_reg_row)
    e, e_again = x["e"].clone(), x["e"].clone()
    w, e2 = fn(*first, x["alpha"], e, x["w"], x["r1"], x["j"], **kw)
    w_again, _ = fn(*first, x["alpha"], e_again, x["w"], x["r1"], x["j"], **kw)
    torch.cuda.synchronize()
    assert (fn.launches - before[0], fn.launches_reg_row - before[1]) == \
        (2, 2 * reg), (c, d, kb, gather)
    assert torch.equal(w, w_again) and torch.equal(e, e_again), \
        f"two sweep calls differ at C {c} D_pad {d} k_b {kb}"
    assert e2 is e, "the residual grid must be updated in place"
    assert bool(torch.isfinite(w).all()) and bool(torch.isfinite(e).all())
    torch.testing.assert_close(w, rw, rtol=SWEEP_RTOL, atol=SWEEP_ATOL)
    torch.testing.assert_close(e, re, rtol=SWEEP_RTOL, atol=SWEEP_ATOL)
    return max(float((w - rw).abs().max()), float((e - re).abs().max()))


def hold_gram(gops, gref, gen, dev, rows, k, weighted) -> float:
    """Gram kernel against the plain version: exact on small integers,
    to a tolerance on random fp32, the same bits from two calls; returns
    the random case's |error|."""
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
    again = gops.gram(x, weights=w)
    torch.cuda.synchronize()
    assert torch.equal(got, again), f"two Gram calls differ at {rows}x{k}"
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
    err["long_rows"] = long_item_row_on_card_vs_cpu(dev)
    return err


def long_item_row_on_card_vs_cpu(dev) -> dict:
    """Phase 5, long rows (ROADMAP fault 3.3): MF with one item row of
    20,001 slots (D_pad 20,096, k = 8, block_k 8), two ``mf_padded`` epochs
    on the card — the item side in the gather sweep's split-row form with
    the shared J, or, pre-gathered, the block-row form — against the same
    epochs through the plain versions on the CPU, to the fused-vs-flat
    tolerance (rtol 3e-4, atol 3e-5). Returns the max |error| by route."""
    from repro_torch.core.models import mf, mf_padded
    from repro_torch.kernels import vmem
    from repro_torch.kernels.cd_sweep import ops as cs
    from repro_torch.sparse.interactions import build_interactions

    rng = np.random.default_rng(21)
    n_ctx, n_items, k = 20_001, 5, 8
    ctx = np.concatenate([np.arange(n_ctx), rng.integers(0, n_ctx, 3_000)])
    item = np.concatenate([np.zeros(n_ctx, np.int64), rng.integers(1, n_items, 3_000)])
    cells = np.unique(ctx * n_items + item)
    ctx, item = cells // n_items, cells % n_items
    y = rng.integers(1, 5, len(cells)).astype(np.float64)
    alpha = 1.0 + rng.random(len(cells))
    w0 = (0.1 * rng.normal(size=(n_ctx, k))).astype(np.float32)
    h0 = (0.1 * rng.normal(size=(n_items, k))).astype(np.float32)
    errs = {}
    for route in ("gather", "pregather"):
        gather = route == "gather"
        hp = mf.MFHyperParams(k=k, alpha0=0.5, l2=0.1, block_k=8, psi_dispatch=route)
        fn = cs.cd_block_sweep_gather if gather else cs.cd_block_sweep
        out = {}
        for where in ("cpu", dev):
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
                torch.cuda.synchronize()
                got = (fn.launches_split_row - before[0],
                       fn.launches_block_row - before[1])
                assert got == ((2, 2) if gather else (0, 2)), (route, got)
            out[str(where)] = [t.cpu() for t in (p.w, p.h, e)]
        form = vmem.cd_sweep_form(d_item, 8, gather=gather)
        assert d_item == 20_096 and form == (vmem.SPLIT_ROW if gather else vmem.BLOCK_ROW)
        for a, b_ in zip(out[str(dev)], out["cpu"]):
            torch.testing.assert_close(a, b_, rtol=3e-4, atol=3e-5)
        errs[route] = max(float((a - b_).abs().max())
                          for a, b_ in zip(out[str(dev)], out["cpu"]))
        log(f"phase 5 long rows: mf_padded, one item row at D_pad {d_item}, "
            f"k_b 8, {route}: item side in the {form} form"
            f"{' with the shared J' if gather else ''}, 2 epochs on the card "
            f"against the CPU's plain versions, max |err| {errs[route]:.3g} "
            f"(rtol 3e-4, atol 3e-5)")
    return errs


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
    from repro_torch.kernels.segment_sum import ops as seg_ops
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
    cs.cd_block_sweep_gather.launches_reg_row = 0
    stamp[0] = time.perf_counter()
    trained = mf_padded.fit(params0, pdata, hp, 3, callback=on_epoch)
    launches = {c.__name__: c.launches for c in counters}
    launches["cd_block_sweep_gather:reg_row"] = cs.cd_block_sweep_gather.launches_reg_row
    log(f"phase 6 train: mf_padded.fit 3 epochs (block_k 8, gather): "
        f"objective {' -> '.join(f'{o:.6g}' for o in objs)}; epoch s "
        f"{', '.join(f'{s:.3f}' for s in epoch_s)} (objective excluded); "
        f"launches {launches}: {launches['gram'] // 3} Gram and "
        f"{launches['cd_block_sweep_gather'] // 3} sweep launches an epoch, "
        f"all in the register-row form")
    assert all(b < a for a, b in zip(objs, objs[1:])), "objective must fall"
    assert launches["gram"] == 6 and launches["cd_block_sweep_gather"] == 96 \
        and launches["cd_block_sweep_gather:reg_row"] == 96 \
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
    e_seg = mf.residuals(params0, data)
    seg_ops.segment_sum_sorted.launches = 0
    t = time.perf_counter()
    p_seg, _ = mf.epoch(params0, data, e_seg, hp)
    torch.cuda.synchronize()
    seg_s = time.perf_counter() - t
    seg_launches = seg_ops.segment_sum_sorted.launches
    del e_seg
    # per side and column one sorted-sum call of two values, two launches
    assert seg_launches == 2 * 2 * FULL["k"], seg_launches
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
        f"atol {EPOCH_ATOL}; {seg_launches} sorted-sum launches)")

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
            "pregather_launches": lp["cd_block_sweep"],
            "segment_sum_launches": seg_launches}


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
    from repro_torch.kernels import vmem
    from repro_torch.kernels.cd_sweep import kernel as ck, ops as cs, ref as cr
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
            f"bound {g['bound'][-1][0]:.4f} ms ({g['bound'][-1][1]}); "
            f"by row splits (diagonal blocks a launch): "
            + ", ".join(f"{n} {device_ms(gram_at_splits(xs, n)):.4f} ms"
                        for n in GRAM_SPLIT_SWEEP))
    out["gram"] = g
    for disp in ("gather", "pregather"):
        r = {"ms": [], "plain": [], "bound": [], "warp_row": []}
        for name, (side, other, ids, alpha) in sides.items():
            c, d = alpha.shape
            jfull = gref.gram_ref(other)
            j = jfull[:kb, :kb].contiguous()
            r1 = side @ jfull[:, :kb]
            tab, wb = other[:, :kb], side[:, :kb]
            es = [torch.zeros_like(alpha) for _ in range(2)]
            form = vmem.cd_sweep_form(d, kb, gather=disp == "gather")
            if disp == "gather":
                fn = lambda i: cs.cd_block_sweep_gather(  # noqa: E731
                    tab, ids, alpha, es[i % 2], wb, r1, j, alpha0=1.0, l2=0.1)
                plain = lambda i: cr.cd_block_sweep_gather_ref(  # noqa: E731
                    tab, ids, alpha, es[i % 2], wb, r1, j, alpha0=1.0, l2=0.1)
                # the warp-row form this one replaced, through its binding
                rows = vmem.cd_sweep_gather_block_ctx(d, kb, n_rows=c)
                w_out = torch.empty((c, kb), device=alpha.device)

                def old(i, rows=rows, w_out=w_out, tab=tab, ids=ids, alpha=alpha,
                        wb=wb, r1=r1, j=j, es=es):
                    ck.launch(None, tab, ids, alpha, es[i % 2], wb, r1, j, w_out,
                              alpha0=1.0, l2=0.1, eta=1.0, rows_per_block=rows)
                    return w_out
                # the two forms and the plain version from one random start
                # (phase 5 holds them; this says how far apart they land)
                e0 = torch.randn(alpha.shape, device=alpha.device,
                                 generator=torch.Generator(device=alpha.device).manual_seed(7))
                rw, re = cr.cd_block_sweep_gather_ref(tab, ids, alpha, e0, wb, r1,
                                                      j, alpha0=1.0, l2=0.1)
                e_new, e_old = e0.clone(), e0.clone()
                w_new, _ = cs.cd_block_sweep_gather(tab, ids, alpha, e_new, wb,
                                                    r1, j, alpha0=1.0, l2=0.1)
                w_old = torch.empty((c, kb), device=alpha.device)
                ck.launch(None, tab, ids, alpha, e_old, wb, r1, j, w_old,
                          alpha0=1.0, l2=0.1, eta=1.0, rows_per_block=rows)
                torch.cuda.synchronize()
                same = torch.equal(w_new, w_old) and torch.equal(e_new, e_old)
                dev_txt = ", ".join(
                    f"{n} {max(float((a - rw).abs().max()), float((b - re).abs().max())):.3g}"
                    for n, a, b in (("register-row", w_new, e_new),
                                    ("warp-row", w_old, e_old)))
                del e0, e_new, e_old, re
                r["warp_row"].append(device_ms(old, n=20))
                lanes, slots = vmem.cd_sweep_reg_group(d, kb)
                form += (f" ({lanes} lanes x {slots} slots; from one random start "
                         f"max |d| against the plain version {dev_txt}, the two "
                         f"forms equal bit for bit: {same})")
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
            old_txt = (f", the warp-row form it replaced {r['warp_row'][-1]:.4f} ms"
                       if r["warp_row"] else "")
            log(f"phase 7 {disp} sweep {name} side (C {c}, D_pad {d}, k_b "
                f"{kb}), form {form}: kernel {r['ms'][-1]:.4f} ms{old_txt}, plain "
                f"{r['plain'][-1]:.4f} ms, library — (none"
                f"{': a gather comes first' if disp == 'gather' else ''}), bound "
                f"{r['bound'][-1][0]:.4f} ms "
                f"({r['bound'][-1][1]}: {cost['hbm_bytes']:.0f} B, "
                f"{cost['flops']:.0f} FLOP)")
            del es
        out[disp] = r
    return out


# phase 7's sweep of the Gram's row splits: 1, 2, 4 (vmem's choice) and 8
# diagonal blocks an SM
GRAM_SPLIT_SWEEP = (132, 264, 528, 1056)


def gram_at_splits(xs, target: int):
    """One Gram launch over ``xs[j % 2]`` cut into about ``target`` row
    splits (a whole number of staged chunks each), through the kernel's
    binding: the wrapper's choice is ``vmem.gram_row_splits``."""
    from repro_torch.kernels import vmem
    from repro_torch.kernels.gram import kernel as gk

    rows, k = xs[0].shape
    chunks = -(-rows // vmem.GRAM_CHUNK)
    per = -(-chunks // min(target, chunks)) * vmem.GRAM_CHUNK
    splits = -(-rows // per)
    partial = torch.empty((splits, k, k), device=xs[0].device)
    out = torch.empty((k, k), device=xs[0].device)
    return lambda j: gk.launch(xs[j % 2], None, splits, per, partial, out)


# --gram-tune: (blocks an SM, ring stages, chunk rows) of the Gram variants
GRAM_TUNE = ((4, 3, 32), (3, 3, 32), (3, 4, 32), (2, 4, 32), (2, 6, 32),
             (3, 6, 16))


def gram_tune() -> None:
    """``python3 chip_smoke.py --gram-tune``: build ``gram.cu`` once for each
    of GRAM_TUNE's (blocks an SM, stages, chunk) and time each at phase 7's
    two shapes (random fp32, k = 128) and several row-split counts, beside
    ``torch.mm(x.T, x)``; each variant is held against it first."""
    import ctypes

    from repro_torch.kernels import build
    from repro_torch.kernels.gram import kernel as gk

    dev = torch.device("cuda", 0)
    libs = [build.CudaLibrary("gram", gk.LIB.source, bind=gk._bind, defines={
        **gk.LIB.defines, "GRAM_MIN_BLOCKS": b, "GRAM_STAGES": st,
        "GRAM_CHUNK": ch}) for b, st, ch in GRAM_TUNE]
    build.build_all(libs)
    for lib, v in zip(libs, GRAM_TUNE):
        entry, seen = "", []
        for ln in lib.build_log.splitlines():
            if "Compiling entry" in ln:
                entry = ln
            elif "gram_diag_kernelILb1ELb0E" in entry and (
                    "registers" in ln or "spill" in ln):
                seen.append(ln.split(":")[-1].strip())
        log(f"gram-tune build {v}: gram_diag_kernel<true, false>: "
            + " | ".join(seen))
    gen = torch.Generator(device=dev).manual_seed(7)
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream  # noqa: E731
    for rows in (68_000, 200_000):
        xs = [0.1 * torch.randn((rows, 128), generator=gen, device=dev)
              for _ in range(2)]
        mm = device_ms(lambda j: torch.mm(xs[j % 2].T, xs[j % 2]))
        want = torch.mm(xs[0].T, xs[0])
        for lib, (b, st, ch) in zip(libs, GRAM_TUNE):
            fn = lib.load().gram_f32
            parts = []
            for target in (132, 264, 396, 528, 792):
                chunks = -(-rows // ch)
                per = -(-chunks // min(target, chunks)) * ch
                splits = -(-rows // per)
                partial = torch.empty((splits, 128, 128), device=dev)
                out = torch.empty((128, 128), device=dev)

                def call(j, splits=splits, per=per, partial=partial, out=out):
                    lib.check(fn(xs[j % 2].data_ptr(), 128, None, rows, 128,
                                 splits, per, partial.data_ptr(),
                                 out.data_ptr(), ctypes.c_void_p(stream())),
                              "gram")
                call(0)
                torch.cuda.synchronize()
                torch.testing.assert_close(out, want, rtol=GRAM_RTOL,
                                           atol=GRAM_ATOL_REL * float(want.abs().max()))
                parts.append(f"{splits} splits {device_ms(call):.4f}")
            log(f"gram-tune {rows}x128 blocks/SM {b} stages {st} chunk {ch}: "
                + ", ".join(parts) + f" ms; torch.mm {mm:.4f} ms")


# --sweep-tune: builds of csrc/cd_gather.cu, each (sweep blocks an SM, most
# slots a thread whose ψ stays in registers — 0 re-reads it from L1 a step
# ahead at any slot count, 16 never —, slab-reduce and split-row pass-1
# blocks an SM, their slots in flight, residual-patch slots a thread), the
# (lanes, slots) each side's rows try, and the split-row chunk lengths
SWEEP_TUNE_BUILDS = ((3, 4, 3, 2, 4), (3, 0, 2, 4, 8), (3, 16, 3, 3, 4),
                     (4, 4, 4, 1, 8), (2, 4, 3, 4, 4))
SWEEP_TUNE_GROUPS = {128: ((8, 16), (16, 8), (32, 4)),
                     1_024: ((64, 16), (128, 8), (256, 4))}
SWEEP_TUNE_CHUNKS = (1_024, 2_048, 3_072, 4_096, 8_192)


def _ptxas_by_kernel(log_text: str) -> dict:
    """{kernel instance: "N registers, S B spill stores"} from nvcc's
    ``-Xptxas -v`` report: sweep<lanes,slots>, with the row patch
    sweep<lanes,slots,P> and from the tile sweep<lanes,slots,P,T> (the
    k_b = 8 instances), slab<lanes> (T: from the tile; slab<32,9> the m =
    9 instance), the split-row pass 1 and the register-slot patch (16-byte
    loads), each gathered or from the tile."""
    import re

    out, name = {}, None
    for ln in log_text.splitlines():
        if "Compiling entry" in ln:
            m = re.search(r"(sweep_gather|slab_reduce)_reg_kernelI((?:L[ib]\d+E)+)E", ln)
            args = re.findall(r"L[ib](\d+)E", m.group(2)) if m else []
            name = None
            if m and m.group(1) == "sweep_gather" and args[2] == "8":
                lanes, slots, _, patch, tile = args
                name = f"sweep<{lanes},{slots}{',P' * (patch == '1')}{',T' * (tile == '1')}>"
            elif m and m.group(1) == "slab_reduce":
                lanes, kb, tile = args
                name = f"slab<{lanes}{',' + kb if kb != '8' else ''}{',T' * (tile == '1')}>"
            if "split_reduce" in ln:
                name = "split pass 1" + " tile" * ("kernelILb1" in ln)
            elif "resid_patch_reg_kernelILb1" in ln:
                name = "patch" + " tile" * ("ILb1ELb1" in ln)
        elif name and "spill" in ln:
            out[name] = ln.split(",")[1].strip()
        elif name and "registers" in ln:
            out[name] = ln.split("Used")[1].split(",")[0].strip() + ", " + out.get(name, "")
    return out


# --slab-tune: builds of csrc/cd_gather.cu, each (the slab reduce's m = 9
# instance's blocks an SM, its slots in flight)
SLAB_TUNE_BUILDS = ((2, 2), (3, 1), (3, 2), (2, 3), (2, 4))


def slab_tune() -> None:
    """``python3 chip_smoke.py --slab-tune``: build ``cd_gather.cu`` once
    for each of SLAB_TUNE_BUILDS and time the slab reduce's m = 9 instance
    at both sides' full-width shapes (context C 200,000 × D_pad 128, n_src
    68,000; item 68,000 × 1,024, n_src 200,000; the log's padding share),
    gathered from FM's concatenated slab (row stride 9) and from the
    pre-gathered tile, each first held bit for bit against the tiled form,
    beside the tiled form's time; with each build's registers and
    spills."""
    from repro_torch.kernels import build
    from repro_torch.kernels.cd_sweep import kernel as ck, ref as cr

    dev = torch.device("cuda", 0)
    libs = [build.CudaLibrary("cd_gather", ck.GATHER_LIB.source, bind=ck._bind_gather,
                              defines={**ck.GATHER_DEFINES,
                                       "CDG_SLAB_WIDE_MIN_BLOCKS": blocks,
                                       "CDG_SLAB_WIDE_INFLIGHT": inflight})
            for blocks, inflight in SLAB_TUNE_BUILDS]
    t0 = time.perf_counter()
    build.build_all([*libs, ck.SLAB_LIB])
    log(f"slab-tune build: {len(libs)} variants in {time.perf_counter() - t0:.1f}s")
    for lib, v in zip(libs, SLAB_TUNE_BUILDS):
        regs = _ptxas_by_kernel(lib.build_log)
        log(f"slab-tune build {v}: " + "; ".join(
            f"{k} {r}" for k, r in sorted(regs.items()) if k.startswith("slab<")))
    gen = torch.Generator(device=dev).manual_seed(20)
    m = FM_M
    for c, d, n_src, pad in ((FULL["n_ctx"], 128, FULL["n_items"], 0.87),
                             (FULL["n_items"], 1_024, FULL["n_ctx"], 0.95)):
        x = slab_inputs(gen, dev, c, d, m, n_src, pad_frac=pad, k=m)
        ids, alpha, e = x["ids"], x["alpha"], x["e"]
        psi = cr.gather_psi_blk(x["tab"], ids).contiguous()
        q_t, p_t = torch.empty((c, m), device=dev), torch.empty((c, m, m), device=dev)
        q, p = torch.empty_like(q_t), torch.empty_like(p_t)
        for what, tab, pb in (("gather", x["tab"], None), ("tile", None, psi)):
            gid = None if tab is None else ids

            def tiled(j, tab=tab, pb=pb, gid=gid):
                ck.slab_reduce(pb, tab, gid, alpha, e, q_t, p_t)
            tiled(0)
            old = device_ms(tiled, n=20)
            parts = []
            for lib, v in zip(libs, SLAB_TUNE_BUILDS):
                def call(j, lib=lib, tab=tab, pb=pb, gid=gid):
                    ck.slab_reduce_reg(tab, gid, alpha, e, q, p, lanes=32, psi_blk=pb,
                                       lib=lib)
                call(0)
                torch.cuda.synchronize()
                assert torch.equal(q, q_t) and torch.equal(p, p_t), (what, v)
                parts.append(f"{v} {device_ms(call, n=20):.4f}")
            log(f"slab-tune m 9 C {c} D_pad {d} {what}: tiled form {old:.4f} ms; "
                "one-tile (blocks an SM, slots in flight) " + ", ".join(parts) + " ms")
        del x, ids, alpha, e, psi, q_t, p_t, q, p


def sweep_tune() -> None:
    """``python3 chip_smoke.py --sweep-tune``: build ``cd_gather.cu`` once
    for each of SWEEP_TUNE_BUILDS and time, at both sides' full-width
    shapes (context C 200,000 × D_pad 128, item 68,000 × 1,024, k_b = m =
    8, the ψ slab a column slice of a k = 128 table, the log's padding
    share), the register-row sweep at each (lanes, slots) of
    SWEEP_TUNE_GROUPS, the one-tile slab reduce at 8, 16 and 32 lanes and
    the register-slot residual patch; at CtxMF's full-width row-patch
    shapes (user C 200,000 × D_pad 128, bucket 24 × 142,464) the
    register-row row-patch sweep at each (lanes, slots) and the split-row
    form at each of SWEEP_TUNE_CHUNKS; each first held against its plain
    version, beside the forms they replace; with each build's registers
    and spills."""
    from repro_torch.kernels import build, vmem
    from repro_torch.kernels.cd_sweep import kernel as ck, ref as cr

    dev = torch.device("cuda", 0)
    libs = [build.CudaLibrary("cd_gather", ck.GATHER_LIB.source, bind=ck._bind_gather,
                              defines={**ck.GATHER_DEFINES,
                                       "CDG_SWEEP_MIN_BLOCKS": sb,
                                       "CDG_SWEEP_REG_SLOTS": reg,
                                       "CDG_SLAB_MIN_BLOCKS": lb,
                                       "CDG_SLAB_INFLIGHT": inflight,
                                       "CDG_PATCH_SLOTS": patch})
            for sb, reg, lb, inflight, patch in SWEEP_TUNE_BUILDS]
    t0 = time.perf_counter()
    build.build_all([*libs, ck.LIB, ck.SLAB_LIB])
    log(f"sweep-tune build: {len(libs)} variants in {time.perf_counter() - t0:.1f}s")
    for lib, v in zip(libs, SWEEP_TUNE_BUILDS):
        regs = _ptxas_by_kernel(lib.build_log)
        log(f"sweep-tune build {v}: " + "; ".join(f"{k} {r}" for k, r in sorted(regs.items())))
    gen = torch.Generator(device=dev).manual_seed(19)
    for c, d, n_src, pad in ((FULL["n_ctx"], 128, FULL["n_items"], 0.87),
                             (FULL["n_items"], 1_024, FULL["n_ctx"], 0.95)):
        x = sweep_inputs(gen, dev, c, d, 8, n_src, k=128, pad_frac=pad)
        kw = dict(alpha0=1.0, l2=0.1)
        args = (x["tab"], x["ids"], x["alpha"])
        rw, re = cr.cd_block_sweep_gather_ref(*args, x["e"], x["w"], x["r1"], x["j"], **kw)
        es = [x["e"].clone() for _ in range(2)]
        w_out = torch.empty((c, 8), device=dev)
        rows = vmem.cd_sweep_gather_block_ctx(d, 8, n_rows=c)
        old = device_ms(lambda j: ck.launch(None, *args, es[j % 2], x["w"], x["r1"], x["j"],
                                            w_out, eta=1.0, rows_per_block=rows, **kw), n=20)
        log(f"sweep-tune sweep C {c} D_pad {d}: warp-row form {old:.4f} ms")
        for lib, v in zip(libs, SWEEP_TUNE_BUILDS):
            parts = []
            for lanes, slots in SWEEP_TUNE_GROUPS[d]:
                e = x["e"].clone()

                def call(j, lanes=lanes, slots=slots, lib=lib, e=None):
                    ck.launch_reg(*args, es[j % 2] if e is None else e, x["w"], x["r1"],
                                  x["j"], w_out, eta=1.0, lanes=lanes, slots=slots,
                                  lib=lib, **kw)
                call(0, e=e)
                torch.cuda.synchronize()
                torch.testing.assert_close(w_out, rw, rtol=SWEEP_RTOL, atol=SWEEP_ATOL)
                torch.testing.assert_close(e, re, rtol=SWEEP_RTOL, atol=SWEEP_ATOL)
                parts.append(f"{lanes}x{slots} {device_ms(call, n=20):.4f}")
            log(f"sweep-tune sweep C {c} D_pad {d} build {v}: " + ", ".join(parts) + " ms")
        del x, es, rw, re
        x = slab_inputs(gen, dev, c, d, 8, n_src, pad_frac=pad, k=128)
        args = (x["tab"], x["ids"], x["alpha"], x["e"])
        rq, rp = cr.cd_slab_reduce_gather_ref(*args)
        q, p = torch.empty_like(rq), torch.empty_like(rp)
        old = device_ms(lambda j: ck.slab_reduce(None, *args, q, p), n=20)
        log(f"sweep-tune slab C {c} D_pad {d}: tiled form {old:.4f} ms")
        for lib, v in zip(libs, SWEEP_TUNE_BUILDS):
            parts = []
            for lanes in vmem.CDG_SLAB_LANES:
                def call(j, lanes=lanes, lib=lib):
                    ck.slab_reduce_reg(*args, q, p, lanes=lanes, lib=lib)
                call(0)
                torch.cuda.synchronize()
                torch.testing.assert_close(q, rq, rtol=SWEEP_RTOL, atol=SWEEP_ATOL)
                torch.testing.assert_close(p, rp, rtol=SWEEP_RTOL, atol=SWEEP_ATOL)
                parts.append(f"{lanes} lanes {device_ms(call, n=20):.4f}")
            log(f"sweep-tune slab C {c} D_pad {d} build {v}: " + ", ".join(parts) + " ms")
        # the residual patch, one slot a thread against the register-slot form
        dphi = 0.1 * torch.randn((c, 8), generator=gen, device=dev)
        re = cr.cd_resid_patch_gather_ref(x["tab"], x["ids"], x["e"], dphi)
        es = [x["e"].clone() for _ in range(2)]
        old = device_ms(lambda j: ck.resid_patch(None, x["tab"], x["ids"], es[j % 2],
                                                 dphi), n=20)
        parts = []
        for lib, v in zip(libs, SWEEP_TUNE_BUILDS):
            e = x["e"].clone()
            ck.resid_patch_reg(x["tab"], x["ids"], e, dphi, lib=lib)
            torch.cuda.synchronize()
            torch.testing.assert_close(e, re, rtol=SWEEP_RTOL, atol=SWEEP_ATOL)
            parts.append(f"{v[4]} slots (build {v}) {device_ms(lambda j, lib=lib: ck.resid_patch_reg(x['tab'], x['ids'], es[j % 2], dphi, lib=lib), n=20):.4f}")
        log(f"sweep-tune patch C {c} D_pad {d}: one slot a thread {old:.4f} ms; "
            + ", ".join(parts) + " ms")
        del x, rq, rp, q, p, es, re
    sweep_tune_rowpatch(libs)


def sweep_tune_rowpatch(libs) -> None:
    """--sweep-tune's row-patch part, in both ψ routings: the register-row
    form at CtxMF's user side at each (lanes, slots) of SWEEP_TUNE_GROUPS
    and the split-row form at its bucket side at each of
    SWEEP_TUNE_CHUNKS, in each build of ``libs`` (SWEEP_TUNE_BUILDS),
    beside the warp-row and block-row forms they replaced; each first held
    against its plain version (at 32 lanes × 4 slots bit for bit the
    warp-row form). At the bucket side, pre-gathered, the split-row form's
    pass 2 (the register-slot patch from the tile) beside row 8's one-slot
    kernel on the same tile, which must give the same bits."""
    from repro_torch.kernels import vmem
    from repro_torch.kernels.cd_sweep import kernel as ck, ref as cr

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(20)
    kw = dict(alpha0=1.0, l2=0.1, eta=1.0)
    n_src = CTX["nnz"] + 1
    for c, d, pad in ((FULL["n_ctx"], CTX["d_user"], 0.87),
                      (CTX["n_buckets"], CTX["d_bucket"], 0.01)):
        x = rowpatch_inputs(gen, dev, c, d, 8, n_src, pad)
        psi = cr.gather_psi_blk(x["tab"], x["ids"]).contiguous()
        rest = (x["w"], x["r1"], x["p"])
        es = [x["e"].clone() for _ in range(2)]
        w_out = torch.empty((c, 8), device=dev)
        long_rows = d > 2_048
        for disp in ("gather", "pregather"):
            gather = disp == "gather"
            src = (x["tab"], x["ids"]) if gather else (None, None)
            tile = None if gather else psi
            plain = (cr.cd_block_sweep_rowpatch_gather_ref if gather else
                     cr.cd_block_sweep_rowpatch_ref)
            rw, re = plain(*(src if gather else (psi,)), x["alpha"], x["e"],
                           *rest, **kw)
            rows = 0 if long_rows else (
                vmem.cd_sweep_gather_block_ctx if gather else
                vmem.cd_sweep_block_ctx)(d, 8, n_rows=c, rowpatch=True)
            e_old, w_old = x["e"].clone(), torch.empty_like(w_out)
            ck.launch(tile, *src, x["alpha"], e_old, *rest, w_old,
                      rows_per_block=rows, **kw)
            old = device_ms(lambda j: ck.launch(tile, *src, x["alpha"], es[j % 2],
                                                *rest, w_out, rows_per_block=rows,
                                                **kw), n=10)
            log(f"sweep-tune rowpatch {disp} C {c} D_pad {d}: "
                f"{'block-row' if long_rows else 'warp-row'} form {old:.4f} ms")
            for lib, v in zip(libs, SWEEP_TUNE_BUILDS):
                parts = []
                if long_rows:
                    for chunk in SWEEP_TUNE_CHUNKS:
                        part = torch.empty((c, -(-d // chunk), vmem.CDG_NSUM), device=dev)
                        delta = torch.empty((c, 8), device=dev)

                        def call(j, chunk=chunk, lib=lib, part=part, delta=delta, e=None):
                            ck.launch_split(*src, x["alpha"], es[j % 2] if e is None else e,
                                            *rest, w_out, part, delta, chunk=chunk,
                                            psi_blk=tile, lib=lib, **kw)
                        e = x["e"].clone()
                        call(0, e=e)
                        torch.cuda.synchronize()
                        atol_w, atol_e = long_row_atol(x, psi, x["p"], 1.0, 0.1)
                        assert bool(((w_out - rw).abs() <= SWEEP_RTOL * rw.abs() + atol_w).all())
                        assert bool(((e - re).abs() <= SWEEP_RTOL * re.abs() + atol_e).all())
                        parts.append(f"chunk {chunk} {device_ms(call, n=10):.4f}")
                else:
                    for lanes, slots in SWEEP_TUNE_GROUPS[d]:
                        def call(j, lanes=lanes, slots=slots, lib=lib, e=None):
                            ck.launch_reg(*src, x["alpha"], es[j % 2] if e is None else e,
                                          *rest, w_out, lanes=lanes, slots=slots,
                                          psi_blk=tile, lib=lib, **kw)
                        e = x["e"].clone()
                        call(0, e=e)
                        torch.cuda.synchronize()
                        torch.testing.assert_close(w_out, rw, rtol=SWEEP_RTOL, atol=SWEEP_ATOL)
                        torch.testing.assert_close(e, re, rtol=SWEEP_RTOL, atol=SWEEP_ATOL)
                        if lanes == 32:
                            assert torch.equal(w_out, w_old) and torch.equal(e, e_old)
                        parts.append(f"{lanes}x{slots} {device_ms(call, n=20):.4f}")
                log(f"sweep-tune rowpatch {disp} C {c} D_pad {d} build {v}: "
                    + ", ".join(parts) + " ms")
            del rw, re, e_old
        if long_rows:
            # pass 2 pre-gathered: the register-slot patch from the tile
            # against row 8's one-slot kernel on the same tile and Δ
            delta = 0.1 * torch.randn((c, 8), generator=gen, device=dev)
            e_reg, e_one = x["e"].clone(), x["e"].clone()
            ck.resid_patch_reg(None, None, e_reg, delta, psi_blk=psi)
            ck.resid_patch(psi, None, None, e_one, delta)
            torch.cuda.synchronize()
            assert torch.equal(e_reg, e_one), "the two pass-2 kernels differ"
            one = device_ms(lambda j: ck.resid_patch(psi, None, None, es[j % 2], delta),
                            n=20)
            parts = [f"{v[4]} slots (build {v}) "
                     f"{device_ms(lambda j, lib=lib: ck.resid_patch_reg(None, None, es[j % 2], delta, psi_blk=psi, lib=lib), n=20):.4f}"
                     for lib, v in zip(libs, SWEEP_TUNE_BUILDS)]
            log(f"sweep-tune rowpatch pregather pass 2 C {c} D_pad {d}: row 8's "
                f"one-slot kernel {one:.4f} ms; register-slot from the tile "
                + ", ".join(parts) + " ms (the same bits)")
        del x, es, psi


# --topk-tune: builds of csrc/topk_score.cu, each (threads a block, blocks
# an SM in __launch_bounds__ and in the grid, blocks a cluster) of the
# one-launch exact form; the first is vmem's
TOPK_TUNE = ((512, 2, 8), (512, 1, 8), (512, 2, 4), (512, 2, 16), (256, 2, 8),
             (256, 3, 8))


# --topk-tune's stage split: builds of csrc/topk_score.cu that stop the
# one-launch form after a stage (each a (name, anchor, text inserted before
# the anchor)), timed at the serving shard: the difference between two
# consecutive builds is the time of the stage between them
TOPK_STAGES = (
    ("launch", "    cg::cluster_group cluster = cg::this_cluster();\n",
     "    if (B == -1) out_s[0] = 1.f;\n    return;\n"),
    ("scoring", "    for (int rr = warp; rr < TOPK_ROWS; rr += TF_WARPS) {\n"
                "        const key_t64* kr = keys + rr * KEY_PITCH;\n",
     "    if (keys[t] == 1ull) out_s[0] = 1.f;\n    return;\n"),
    ("bound", "    __syncthreads();\n    // later chunks (tables past the grid)",
     "    cluster.sync();\n    if (thr_s[t % TOPK_ROWS] == 1ull) out_s[0] = 1.f;\n    return;\n"),
    ("survivors", "    // the cluster's lists are complete: block q merges rows",
     "    cluster.sync();\n    if (lists[t] == 1ull) out_s[0] = 1.f;\n    return;\n"),
    ("cluster merge", "    if (n_clusters == 1) {\n        if (live && s == 0) decode_row",
     "    if (live && s == 0 && merged[lane] == 1ull) out_s[0] = 1.f;\n    return;\n"),
)


def _topk_stage_sources(build_dir) -> list:
    """(stage, path) of TOPK_STAGES' stop-after builds of the source; the
    bound's build also skips the survivors' selection."""
    from repro_torch.kernels.topk_score import kernel

    src = kernel.LIB.source.read_text()
    out = []
    for name, anchor, text in TOPK_STAGES:
        assert src.count(anchor) == 1, name
        body = src.replace(anchor, text + anchor)
        if name == "bound":  # stop before the survivors are kept
            sel = "        select_row(rr, bound, true);\n"
            assert body.count(sel) == 1
            body = body.replace(sel, "")
        path = build_dir / f"topk_score_until_{name.replace(' ', '_')}.cu"
        path.write_text(body)
        out.append((name, path))
    return out


def topk_tune() -> None:
    """Build each of TOPK_TUNE's variants of ``csrc/topk_score.cu`` (all
    nvcc at once) and time its one-launch form at the serving shard (B =
    16, 34,000 × 128 fp32, K = 100; with and without 20 excluded ids a
    row), at B = 64, and over 200,000 rows (blocks walk several chunks),
    each held bit for bit against the three-launch chain, beside the
    chain's time, with the fused kernel's registers and spills."""
    from repro_torch.kernels import build, vmem
    from repro_torch.kernels.build import CudaLibrary
    from repro_torch.kernels.topk_score import kernel, ops

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    log(f"topk-tune on {smi.stdout.strip()}")
    libs = []
    for threads, mb, cl in TOPK_TUNE:
        defines = dict(kernel.DEFINES, TOPK_FUSED_THREADS=threads,
                       TOPK_FUSED_MIN_BLOCKS=mb, TOPK_FUSED_CLUSTER=cl)
        libs.append(CudaLibrary("topk_score", kernel.LIB.source,
                                defines=defines, bind=kernel._bind))
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stages = [(name, CudaLibrary("topk_score", path, defines=kernel.DEFINES,
                                 bind=kernel._bind))
              for name, path in _topk_stage_sources(build.BUILD_DIR)]
    t0 = time.perf_counter()
    build.build_all([kernel.LIB, *libs, *(lib for _, lib in stages)])
    log(f"topk-tune build: {len(libs) + len(stages) + 1} libraries in "
        f"{time.perf_counter() - t0:.1f}s")
    gen = torch.Generator(device=dev).manual_seed(22)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    d, k = 128, 100
    shapes = []
    for b, rows, n_excl in ((16, 34_000, 0), (16, 34_000, 20), (64, 34_000, 0),
                            (16, 200_000, 0)):
        phi = torch.randn((b, d), generator=gen, device=dev)
        tabs = [torch.randn((rows, d), generator=gen, device=dev)
                for _ in range(max(2, 4 * 34_000 // rows))]
        eids = (torch.randint(0, rows, (b, n_excl), generator=gen, device=dev,
                              dtype=torch.int32) if n_excl else None)
        chain_ms = device_ms(lambda j: ops.topk_score(
            phi, tabs[j % len(tabs)], k, exclude_ids=eids, form="chain"))
        want = ops.topk_score(phi, tabs[0], k, exclude_ids=eids, form="chain")
        shapes.append((f"B {b} x {rows} rows, {n_excl} excluded ids", phi, tabs,
                       eids, want, chain_ms))
    for (threads, mb, cl), lib in zip(TOPK_TUNE, libs):
        regs = ""
        lines = lib.build_log.splitlines()
        for n, ln in enumerate(lines):
            if "Compiling entry" in ln and "topk_fused_kernelIfLb1E" in ln:
                regs = " ".join(x.split(":")[-1].strip() for x in lines[n + 1:n + 4]
                                if "registers" in x or "spill" in x)
        parts = []
        for label, phi, tabs, eids, want, chain_ms in shapes:
            b = phi.shape[0]
            n_blocks = vmem.topk_fused_blocks(tabs[0].shape[0], sms,
                                              min_blocks=mb, cluster=cl)
            cand = torch.empty((n_blocks // cl, b, vmem.topk_k_pad(k)),
                               dtype=torch.int64, device=dev)
            counters = torch.zeros(-(-b // vmem.TOPK_ROW_BLOCK), dtype=torch.int32,
                                   device=dev)
            out = (torch.empty((b, k), device=dev),
                   torch.empty((b, k), dtype=torch.int32, device=dev))

            def call(j, tabs=tabs, phi=phi, eids=eids, n_blocks=n_blocks,
                     cand=cand, counters=counters, out=out):
                kernel.launch_fused(phi, tabs[j % len(tabs)], None, eids, None, 0,
                                    k, vmem.topk_k_pad(k), n_blocks, 0,
                                    tabs[j % len(tabs)].shape[0], out[0], out[1],
                                    cand, counters, lib=lib)
            call(0)
            torch.cuda.synchronize()
            same = torch.equal(out[1], want[1]) and torch.equal(out[0], want[0])
            ms = device_ms(call)
            parts.append(f"{label}: {ms:.4f} ms ({n_blocks} blocks; chain "
                         f"{chain_ms:.4f}; equal {same})")
            assert same, (threads, mb, cl, label)
        log(f"topk-tune threads {threads}, {mb} blocks an SM, clusters of {cl} "
            f"[{regs}]: " + "; ".join(parts))
    # where one launch's time goes at the serving shard (vmem's build)
    label, phi, tabs, eids, want, chain_ms = shapes[0]
    b, rows = phi.shape[0], tabs[0].shape[0]
    n_blocks = vmem.topk_fused_blocks(rows, sms)
    cand = torch.empty((n_blocks // vmem.TOPK_FUSED_CLUSTER, b, vmem.topk_k_pad(k)),
                       dtype=torch.int64, device=dev)
    counters = torch.zeros(1, dtype=torch.int32, device=dev)
    out = (torch.empty((b, k), device=dev),
           torch.empty((b, k), dtype=torch.int32, device=dev))
    until = []
    for name, lib in [*stages, ("the last cluster's merge", kernel.LIB)]:
        def call(j, lib=lib):
            kernel.launch_fused(phi, tabs[j % len(tabs)], None, None, None, 0, k,
                                vmem.topk_k_pad(k), n_blocks, 0, rows, out[0],
                                out[1], cand, counters, lib=lib)
        call(0)
        torch.cuda.synchronize()
        until.append((name, device_ms(call)))
    split = [f"{name} {t - (until[i - 1][1] if i else 0.0):.4f}"
             for i, (name, t) in enumerate(until)]
    log(f"topk-tune stage split of one launch at {label} (ms a stage, from "
        f"builds that stop after it; the bound's build keeps no survivor): "
        f"{', '.join(split)}; whole call {until[-1][1]:.4f} ms")


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
# phase 10's objective before and after each of its 3 epochs with the
# warp-row and block-row row-patch forms (chip_smoke.py of the commit before
# the split-row form, on an H100), which the new forms must keep to rtol 1e-4
CTX_OBJECTIVES = (4.09181e+07, 2.12352e+07, 2.12054e+07, 2.11854e+07)


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
    """Two launches of a row-patch sweep (or, with a 2-D ``cpl``, the
    shared-J sweep) on the same inputs, which must give the same bits, held
    against the plain version; returns (max |error| over W and e, whether
    it ran on long rows — the block-row or split-row form —, W)."""
    from repro_torch.kernels import vmem

    cpl = x["p"] if cpl is None else cpl
    name = ("cd_block_sweep_rowpatch" if cpl.dim() == 3 else
            "cd_block_sweep") + ("_gather" if gather else "")
    fn, plain = getattr(cs, name), getattr(cr, name + "_ref")
    psi = cr.gather_psi_blk(x["tab"], x["ids"]).contiguous()
    first = (x["tab"], x["ids"]) if gather else (psi,)
    kw = dict(alpha0=alpha0, l2=l2, eta=eta)
    d, kb = x["alpha"].shape[1], x["w"].shape[1]
    form = vmem.cd_sweep_form(d, kb, gather=gather, rowpatch=cpl.dim() == 3)
    long_rows = form in (vmem.BLOCK_ROW, vmem.SPLIT_ROW)
    before = (fn.launches, fn.launches_block_row, fn.launches_split_row,
              fn.launches_reg_row)
    rw, re = plain(*first, x["alpha"], x["e"], x["w"], x["r1"], cpl, **kw)
    e, e_again = x["e"].clone(), x["e"].clone()
    w, e2 = fn(*first, x["alpha"], e, x["w"], x["r1"], cpl, **kw)
    w_again, _ = fn(*first, x["alpha"], e_again, x["w"], x["r1"], cpl, **kw)
    torch.cuda.synchronize()
    assert e2 is e, "the residual grid must be updated in place"
    assert torch.equal(w, w_again) and torch.equal(e, e_again), \
        f"{name}: two calls differ"
    assert (fn.launches - before[0], fn.launches_block_row - before[1],
            fn.launches_split_row - before[2], fn.launches_reg_row - before[3]) \
        == (2, 2 * long_rows, 2 * (form == vmem.SPLIT_ROW),
            2 * (form == vmem.REG_ROW)), (name, form)
    assert bool(torch.isfinite(w).all()) and bool(torch.isfinite(e).all())
    atol_w = atol_e = SWEEP_ATOL
    if long_rows:
        atol_w, atol_e = long_row_atol(x, psi, cpl, alpha0, l2)
    bad_w = (w - rw).abs() > SWEEP_RTOL * rw.abs() + atol_w
    bad_e = (e - re).abs() > SWEEP_RTOL * re.abs() + atol_e
    err = max(float((w - rw).abs().max()), float((e - re).abs().max()))
    assert not bool(bad_w.any()) and not bool(bad_e.any()), (name, d, err)
    return err, long_rows, w


def long_row_atol(x, psi, cpl, alpha0, l2):
    """(per-row atol of W, per-slot atol of e) of a sweep on long rows:
    SWEEP_ATOL plus LONG_ROW_REL of the row's Σ_j (Σ_d |α·e·ψ_j|) / den_j,
    in e times the slot's largest |ψ_j|."""
    a = x["alpha"][:, None, :]
    den = ((a * psi * psi).sum(-1) + alpha0 * torch.diagonal(
        cpl, dim1=-2, dim2=-1) + l2).clamp(min=1e-12)
    scale = ((a * x["e"].abs()[:, None, :] * psi.abs()).sum(-1)
             / den).sum(1, keepdim=True)
    atol_w = SWEEP_ATOL + LONG_ROW_REL * scale
    return atol_w, atol_w * psi.abs().amax(1)


def hold_rowpatch_kernels(dev, n_src) -> dict:
    """Phase 9: both row-patch kernels against their plain versions at the
    full-width shapes and at edge cases; ``n_src`` = nnz + 1. Both
    routings run in the register-row form (user side) and the split-row
    form (bucket side); at the user side each equals the warp-row form it
    replaced bit for bit. Fault 3.4: the split-row form on more than
    65,535 rows."""
    from repro_torch.kernels import vmem
    from repro_torch.kernels.cd_sweep import kernel as ck, ops as cs, ref as cr

    gen = torch.Generator(device=dev).manual_seed(9)
    err = {"cd_block_sweep_rowpatch": 0.0, "cd_block_sweep_rowpatch_gather": 0.0}
    # user side (13% of the slots filled at full width), bucket side (full
    # rows)
    for c, d, pad, long_rows in ((FULL["n_ctx"], 128, 0.87, False),
                                 (CTX["n_buckets"], CTX["d_bucket"], 0.01, True)):
        x = rowpatch_inputs(gen, dev, c, d, 8, n_src, pad)
        for gather in (True, False):
            name = "cd_block_sweep_rowpatch" + ("_gather" if gather else "")
            got, lr, _ = hold_rowpatch(cs, cr, x, gather=gather)
            assert lr == long_rows
            err[name] = max(err[name], got)
            log(f"phase 9 hold {name} C {c} D_pad {d}: "
                f"{vmem.cd_sweep_form(d, 8, gather=gather, rowpatch=True)} "
                f"form, max |err| {got:.3g}, two calls the same bits")
        if not long_rows:
            # the register-row row-patch form at 32 lanes against the
            # warp-row form it replaced, bit for bit, in both routings
            for gather in (True, False):
                same = rowpatch_reg_vs_warp_row(ck, cs, cr, x, gather=gather)
                assert same, ("register-row and warp-row row-patch forms "
                              "differ", gather)
            log(f"phase 9 hold: the register-row row-patch form equals the "
                f"warp-row form bit for bit at C {c} D_pad {d} "
                f"({vmem.cd_sweep_reg_group(d, 8)[0]} lanes), gathered and "
                f"pre-gathered")
        del x
    # edge cases: C off the row tile, a 4-column tail, k_b = 1, η ≠ 1,
    # long rows in both couplings at k_b 8, 4, 3 and 1, row lengths that no
    # chunk divides (20,000, 16,000 and 18,000 at chunks of 256) and one
    # off a multiple of 4 (15,001: scalar loads in pass 2)
    for c, d, kb, eta in ((1001, 40, 8, 1.0), (1001, 40, 4, 0.7),
                          (13, 200, 1, 0.5), (9, 33, 3, 1.3),
                          (5, 20_000, 8, 0.9), (3, 16_000, 4, 1.0),
                          (4, 15_001, 3, 1.1), (6, 18_000, 1, 0.7)):
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
    # the shared-J sweep (MF's kernel 2) on long rows: the split-row form
    # with one J (cs0 = 0) in the gather routing, the block-row form
    # pre-gathered
    x = rowpatch_inputs(gen, dev, 5, 20_000, 8, 3_000)
    for gather in (True, False):
        _, lr, _ = hold_rowpatch(cs, cr, x, gather=gather, cpl=x["p"][0])
        assert lr
    del x
    err["many_rows"] = hold_split_row_many_rows(dev, gen)
    return err


def hold_split_row_many_rows(dev, gen, c=70_000, d=512) -> float:
    """Phase 9, fault 3.4: the split-row form on ``c`` rows of ``d`` slots
    (70,000: more than a grid's 65,535 y-blocks), k_b 8, ψ gathered and
    from the tile, through the binding, against the plain version at the
    long-row tolerance, two calls the same bits; returns the max |error|."""
    from repro_torch.kernels import vmem
    from repro_torch.kernels.cd_sweep import kernel as ck, ref as cr

    x = rowpatch_inputs(gen, dev, c, d, 8, 5_000, 0.3)
    psi = cr.gather_psi_blk(x["tab"], x["ids"]).contiguous()
    kw = dict(alpha0=1.0, l2=0.1, eta=0.9)
    chunk = vmem.cd_sweep_split_chunk(d, c)
    part = torch.empty((c, -(-d // chunk), vmem.CDG_NSUM), device=dev)
    delta = torch.empty((c, 8), device=dev)
    worst = 0.0
    for tile in (False, True):
        src = (None, None) if tile else (x["tab"], x["ids"])
        got = []
        for _ in range(2):
            e, w = x["e"].clone(), torch.empty_like(x["w"])
            ck.launch_split(*src, x["alpha"], e, x["w"], x["r1"], x["p"], w,
                            part, delta, chunk=chunk,
                            psi_blk=psi if tile else None, **kw)
            got.append((w, e))
        plain = cr.cd_block_sweep_rowpatch_ref if tile else \
            cr.cd_block_sweep_rowpatch_gather_ref
        rw, re = plain(*((psi,) if tile else src), x["alpha"], x["e"], x["w"],
                       x["r1"], x["p"], **kw)
        torch.cuda.synchronize()
        (w, e), (w2, e2) = got
        assert torch.equal(w, w2) and torch.equal(e, e2), "two calls differ"
        atol_w, atol_e = long_row_atol(x, psi, x["p"], kw["alpha0"], kw["l2"])
        assert bool(((w - rw).abs() <= SWEEP_RTOL * rw.abs() + atol_w).all())
        assert bool(((e - re).abs() <= SWEEP_RTOL * re.abs() + atol_e).all())
        err = max(float((w - rw).abs().max()), float((e - re).abs().max()))
        worst = max(worst, err)
        log(f"phase 9 hold fault 3.4: split-row form on C {c} rows x D_pad "
            f"{d} ({'tile' if tile else 'gathered'} psi, chunk {chunk}), max "
            f"|err| {err:.3g} against the plain version, two calls the same "
            f"bits")
    return worst


def rowpatch_reg_vs_warp_row(ck, cs, cr, x, *, gather=True) -> bool:
    """The row-patch sweep, gathered or pre-gathered, through its wrapper
    (the register-row form) and through the warp-row form's binding, on
    the same inputs: whether W and e agree bit for bit."""
    from repro_torch.kernels import vmem

    c, d = x["alpha"].shape
    kw = dict(alpha0=1.0, l2=0.1, eta=1.0)
    if gather:
        first, old = (x["tab"], x["ids"]), (None, x["tab"], x["ids"])
        fn, rows = cs.cd_block_sweep_rowpatch_gather, vmem.cd_sweep_gather_block_ctx
    else:
        psi = cr.gather_psi_blk(x["tab"], x["ids"]).contiguous()
        first, old = (psi,), (psi, None, None)
        fn, rows = cs.cd_block_sweep_rowpatch, vmem.cd_sweep_block_ctx
    e_new, e_old = x["e"].clone(), x["e"].clone()
    w_new, _ = fn(*first, x["alpha"], e_new, x["w"], x["r1"], x["p"], **kw)
    w_old = torch.empty_like(w_new)
    ck.launch(*old, x["alpha"], e_old, x["w"], x["r1"], x["p"], w_old,
              rows_per_block=rows(d, 8, n_rows=c, rowpatch=True), **kw)
    torch.cuda.synchronize()
    return torch.equal(w_new, w_old) and torch.equal(e_new, e_old)


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


SWEEP_FORM_COUNTERS = ("block_row", "split_row", "reg_row")


def reset_counts() -> None:
    for c in _counters():
        c.launches = 0
        if hasattr(c, "launches_block_row"):
            for f in SWEEP_FORM_COUNTERS:
                setattr(c, f"launches_{f}", 0)


def read_counts() -> dict:
    out = {}
    for c in _counters():
        out[c.__name__] = c.launches
        if hasattr(c, "launches_block_row"):
            for f in SWEEP_FORM_COUNTERS:
                out[f"{c.__name__}:{f}"] = getattr(c, f"launches_{f}")
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
    assert forms == [vmem.REG_ROW, vmem.SPLIT_ROW], forms

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
    rp_split = launches["cd_block_sweep_rowpatch_gather:split_row"]
    rp_reg = launches["cd_block_sweep_rowpatch_gather:reg_row"]
    log(f"phase 10 train: ctxmf.epoch_padded x3 (k {FULL['k']}, block_k 0 -> k_b 8, "
        f"gather, Gram kernel for J_I): objective "
        f"{' -> '.join(f'{o:.6g}' for o in objs)}; epoch s "
        f"{', '.join(f'{s:.3f}' for s in epoch_s)} (objective excluded); "
        f"launches {launches}: in 3 epochs {rp_reg} register-row + {rp_split} "
        f"split-row row-patch launch chains, "
        f"{launches['cd_block_sweep_gather']} item-sweep (register-row) and "
        f"{launches['gram']} Gram launches")
    assert all(b < a for a, b in zip(objs, objs[1:])), "objective must fall"
    # the split-row form sums the bucket rows in another order than the
    # block-row form did: the objectives agree with the earlier form's to
    # rtol 1e-4
    for got, want_obj in zip(objs, CTX_OBJECTIVES):
        assert abs(got - want_obj) <= 1e-4 * abs(want_obj), (objs, CTX_OBJECTIVES)
    nb = -(-FULL["k"] // 8)  # k_b = 8 blocks a mode: 16 at k = 128
    want = {f"{n}:{f}": 0 for n in (
        "cd_block_sweep", "cd_block_sweep_gather", "cd_block_sweep_rowpatch",
        "cd_block_sweep_rowpatch_gather") for f in SWEEP_FORM_COUNTERS}
    want.update({"gram": 3, "cd_block_sweep": 0,
                 "cd_block_sweep_gather": 3 * nb,
                 "cd_block_sweep_gather:reg_row": 3 * nb,
                 "cd_block_sweep_rowpatch": 0,
                 "cd_block_sweep_rowpatch_gather": 6 * nb,
                 "cd_block_sweep_rowpatch_gather:block_row": 3 * nb,
                 "cd_block_sweep_rowpatch_gather:split_row": 3 * nb,
                 "cd_block_sweep_rowpatch_gather:reg_row": 3 * nb})
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
    # the row-patch sweep: nb register-row chains (user side) and nb
    # split-row chains (bucket side; launches_block_row counts long-row
    # chains, so none of them is in the block-row form)
    assert pre_launches["cd_block_sweep_rowpatch"] == 2 * nb and \
        pre_launches["cd_block_sweep_rowpatch:reg_row"] == nb and \
        pre_launches["cd_block_sweep_rowpatch:split_row"] == nb and \
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
        f"pregather {pre_s:.3f}s (max |d param| {d_pre:.3g}; row-patch "
        f"sweep {pre_launches['cd_block_sweep_rowpatch:reg_row']} register-row "
        f"+ {pre_launches['cd_block_sweep_rowpatch:split_row']} split-row "
        f"launch chains, no block-row one), flat "
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
    # one P for every row: the bucket side in the split-row form with cs0 = 0
    assert dense_launches["cd_block_sweep_rowpatch_gather"] == 2 * nb and \
        dense_launches["cd_block_sweep_rowpatch_gather:split_row"] == nb and \
        dense_launches["cd_block_sweep_rowpatch_gather:reg_row"] == nb
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
    """Phase 12: CUDA-event times of both row-patch routings at the
    full-width user and bucket shapes, on the real layouts' ids and α with
    random values, one launch of k_b = 8; each routing's forms (register-row
    at the user side, split-row at the bucket side) beside the warp-row and
    block-row forms they replaced, through their binding, in the same
    call."""
    from repro_torch.kernels import vmem
    from repro_torch.kernels.cd_sweep import kernel as ck, ops as cs, ref as cr
    from repro_torch.obs.costs import cd_sweep_cost

    gen = torch.Generator(device=dev).manual_seed(12)
    out = {d: {"ms": [], "plain": [], "bound": [], "old": []}
           for d in ("gather", "pregather")}
    kw = dict(alpha0=1.0, l2=0.1)
    for side, g in (("user", padded.g1), ("bucket", padded.g2)):
        c, d = g.alpha_pad.shape
        x = rowpatch_inputs(gen, dev, c, d, 8, n_src, ids=g.flat_ids,
                            alpha=g.alpha_pad)
        es = [x["e"].clone() for _ in range(2)]
        psi = cr.gather_psi_blk(x["tab"], x["ids"]).contiguous()
        rest = (x["alpha"], None, x["w"], x["r1"], x["p"])
        w_old = torch.empty((c, 8), device=dev)
        long_rows = side == "bucket"

        def args(first, i):
            return (*first, rest[0], es[i % 2], *rest[2:])

        for disp in ("gather", "pregather"):
            gather = disp == "gather"
            first = (x["tab"], x["ids"]) if gather else (psi,)
            old_first = (None, *first) if gather else (psi, None, None)
            rows = 0 if long_rows else (
                vmem.cd_sweep_gather_block_ctx if gather else
                vmem.cd_sweep_block_ctx)(d, 8, n_rows=c, rowpatch=True)

            def old(i, old_first=old_first, rows=rows):
                # the form this routing took before, through its binding
                ck.launch(*old_first, x["alpha"], es[i % 2], x["w"], x["r1"],
                          x["p"], w_old, eta=1.0, rows_per_block=rows, **kw)

            name = "cd_block_sweep_rowpatch" + ("_gather" if gather else "")
            fn, plain = getattr(cs, name), getattr(cr, name + "_ref")
            r = out[disp]
            n = 20 if side == "user" else 10
            r["ms"].append(device_ms(lambda i: fn(*args(first, i), **kw), n=n))
            r["old"].append(device_ms(old, n=n))
            r["plain"].append(device_ms(lambda i: plain(*args(first, i), **kw),
                                        n=5))
            cost = cd_sweep_cost(c, d, 8, 8, n_src=n_src, gather=gather,
                                 rowpatch=True)
            r["bound"].append(bound(cost["hbm_bytes"], cost["flops"]))
            own = bound(cost["form_bytes"], cost["flops"])
            log(f"phase 12 {name} {side} side (C {c}, D_pad {d}, k_b 8, "
                f"{cost['form']}): kernel {r['ms'][-1]:.4f} ms, the "
                f"{'block-row' if long_rows else 'warp-row'} form it replaced "
                f"{r['old'][-1]:.4f} ms, plain {r['plain'][-1]:.4f} ms, "
                f"library —, bound {r['bound'][-1][0]:.4f} ms "
                f"({r['bound'][-1][1]}: {cost['hbm_bytes']:.0f} B, "
                f"{cost['flops']:.0f} FLOP); the form's own traffic "
                f"{cost['form_bytes']:.0f} B, {own[0]:.4f} ms")
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
    """All four slab kernels against their plain versions on the same
    inputs; returns the largest |error| of each. Q and P to SWEEP_RTOL /
    SWEEP_ATOL, plus, for rows of SLAB_LONG_D slots and more,
    LONG_ROW_REL of the row's Σ|terms|; P symmetric bit for bit, and the
    same bits from a second call; where m takes the one-tile form (m ≤ 9,
    either routing), Q and P equal bit for bit to the tiled form it
    replaced; e patched in place to SWEEP_RTOL / SWEEP_ATOL (m terms a
    slot, no long sum), the gather patch in its register-slot form (m ≤ 8)
    equal bit for bit to the one-slot kernel it replaced."""
    from repro_torch.kernels import vmem
    from repro_torch.kernels.cd_sweep import kernel as ck

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
        one_tile = vmem.cd_slab_reduce_form(tab.shape[1]) == vmem.SLAB_ONE_TILE
        before = (fn.launches, fn.launches_one_tile)
        q, p = fn(*first, alpha, e)
        q2, p2 = fn(*first, alpha, e)
        torch.cuda.synchronize()
        assert (fn.launches - before[0], fn.launches_one_tile - before[1]) == \
            (2, 2 * one_tile), name
        assert torch.equal(q, q2) and torch.equal(p, p2), f"{name}: two calls differ"
        assert torch.equal(p, p.transpose(1, 2)), f"{name}: P not symmetric"
        assert bool(torch.isfinite(q).all()) and bool(torch.isfinite(p).all())
        bad_q = (q - rq).abs() > SWEEP_RTOL * rq.abs() + SWEEP_ATOL + rel * q_abs
        bad_p = (p - rp).abs() > SWEEP_RTOL * rp.abs() + SWEEP_ATOL + rel * p_abs
        err[name] = max(float((q - rq).abs().max()), float((p - rp).abs().max()))
        assert not bool(bad_q.any()) and not bool(bad_p.any()), (name, c, d, err[name])
        if one_tile:
            q_t, p_t = torch.empty_like(q), torch.empty_like(p)
            gather = len(first) == 2
            ck.slab_reduce(None if gather else psi, tab if gather else None,
                           ids if gather else None, alpha, e, q_t, p_t)  # the tiled form
            torch.cuda.synchronize()
            assert torch.equal(q, q_t) and torch.equal(p, p_t), f"{name}: forms differ"
    re = cr.cd_resid_patch_ref(psi, e, dphi)
    reg = vmem.cd_resid_patch_form(d, tab.shape[1], gather=True) == vmem.PATCH_REG_SLOTS
    for name, first in (("cd_resid_patch_gather", (tab, ids)),
                        ("cd_resid_patch", (psi,))):
        fn = getattr(cs, name)
        before = (fn.launches, getattr(fn, "launches_reg_slots", 0))
        e2 = e.clone()
        assert fn(*first, e2, dphi) is e2, "the residual grid must be patched in place"
        torch.cuda.synchronize()
        assert fn.launches == before[0] + 1, name
        torch.testing.assert_close(e2, re, rtol=SWEEP_RTOL, atol=SWEEP_ATOL)
        err[name] = float((e2 - re).abs().max())
        if len(first) == 2:
            assert fn.launches_reg_slots == before[1] + reg, name
            e_old = e.clone()
            ck.resid_patch(None, tab, ids, e_old, dphi)  # the one-slot kernel
            torch.cuda.synchronize()
            assert torch.equal(e2, e_old), f"{name}: forms differ"
    return err


def hold_slab_kernels(dev) -> dict:
    """Phase 13: kernels 6–9 against their plain versions at both sides'
    full-width shapes (m = 8, and m = 9 on FM's 9-column slab, the shapes
    FM's main path gives the m = 9 instance), and at m =
    9 (the one-tile form's wide instance) and 17 (the tiled form), a long
    row, ids past the slab. Returns the largest |error| of each kernel,
    and of the slab reduces at m = 9 under ``<name>:m9``."""
    from repro_torch.kernels.cd_sweep import ops as cs, ref as cr

    gen = torch.Generator(device=dev).manual_seed(13)
    n_ctx, n_items = FULL["n_ctx"], FULL["n_items"]
    worst = {}

    def hold(x, what):
        got = hold_slab(cs, cr, x)
        m = x["tab"].shape[1]
        for n, v in got.items():
            worst[n] = max(worst.get(n, 0.0), v)
            if m == FM_M and "slab" in n:
                worst[f"{n}:m9"] = max(worst.get(f"{n}:m9", 0.0), v)
        log(f"phase 13 hold {what}: max |err| " + ", ".join(
            f"{n} {v:.3g}" for n, v in got.items()))

    # the full-width shapes, at the log's fill (13% of the context grid,
    # 5% of the item grid), the ψ slab a column slice of a k = 128 table
    hold(slab_inputs(gen, dev, n_ctx, 128, 8, n_items, pad_frac=0.87, k=128),
         f"context side C {n_ctx} D_pad 128 n_src {n_items} m 8")
    hold(slab_inputs(gen, dev, n_items, 1_024, 8, n_ctx, pad_frac=0.95, k=128),
         f"item side C {n_items} D_pad 1024 n_src {n_ctx} m 8")
    # FM's m = k_b + 1 on its concatenated slab (ld 9) at both sides
    hold(slab_inputs(gen, dev, n_ctx, 128, FM_M, n_items, pad_frac=0.87, k=FM_M),
         f"context side C {n_ctx} D_pad 128 n_src {n_items} m 9 ld 9")
    hold(slab_inputs(gen, dev, n_items, 1_024, FM_M, n_ctx, pad_frac=0.95, k=FM_M),
         f"item side C {n_items} D_pad 1024 n_src {n_ctx} m 9 ld 9")
    # m = 9 (one tile) and a P of three column tiles (m = 17, the tiled
    # form), with ψ slabs strided
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
    # the residual patch's register-slot form at every m ≤ 8 (m = 9 keeps
    # the one-slot kernel), on slabs of ld 8 (16-byte loads at m = 4 and 8)
    # and of ld m + 3 (scalar gathers), and at a D_pad off a multiple of 4
    # (the one-slot kernel)
    for m in range(1, 10):
        for k, d in ((max(m, 8), 128), (m + 3, 128), (m, 37)):
            hold(slab_inputs(gen, dev, 301, d, m, 500, pad_frac=0.3, k=k),
                 f"m {m}, ld {k}, D_pad {d}")
    return worst


def _slab_counters():
    from repro_torch.kernels.cd_sweep import ops as cs
    from repro_torch.kernels.gram import ops as gops

    return (gops.gram, cs.cd_slab_reduce, cs.cd_slab_reduce_gather,
            cs.cd_resid_patch, cs.cd_resid_patch_gather)


def reset_slab_counts() -> None:
    """The feature models' launch counts (the Gram, kernels 6–9 and their
    register forms) to 0."""
    for c in _slab_counters():
        c.launches = 0
    _, slab, slab_g, _, patch_g = _slab_counters()
    slab.launches_one_tile = slab_g.launches_one_tile = 0
    patch_g.launches_reg_slots = 0


def read_slab_counts() -> dict:
    """The feature models' launch counts, and the one-tile slab reduces and
    register-slot patches among them (the pregather route's one-tile count
    where that route launched)."""
    _, slab, slab_g, _, patch_g = _slab_counters()
    out = {c.__name__: c.launches for c in _slab_counters()}
    out["cd_slab_reduce_gather:one_tile"] = slab_g.launches_one_tile
    out["cd_resid_patch_gather:reg_slots"] = patch_g.launches_reg_slots
    if slab.launches:
        out["cd_slab_reduce:one_tile"] = slab.launches_one_tile
    return out


def train_mfsi_full_width(dev) -> dict:
    """Phase 14: MFSI at icd-fm width on the card."""
    import dataclasses

    from repro_torch.core.models import mfsi
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
    objs = [float(mfsi.objective(params0, x, z, data, hp))]
    p, e = params0, mfsi.residuals_padded(params0, x, z, data, pdata)
    epoch_s, first = [], None
    torch.cuda.synchronize()
    reset_slab_counts()
    for _ in range(3):
        t = time.perf_counter()
        p, e = mfsi.epoch_padded(p, x, z, pdata, e, hp)
        torch.cuda.synchronize()
        epoch_s.append(time.perf_counter() - t)
        first = first or (p, e.clone())
        objs.append(float(mfsi.objective(p, x, z, data, hp)))
    launches = read_slab_counts()
    nb = -(-k // 8)  # k_b = 8: 16 blocks a side
    log(f"phase 14 train: mfsi.epoch_padded x3 (k {k}, block_k 0 -> k_b 8, "
        f"gather, jacobi, Gram kernel): objective "
        f"{' -> '.join(f'{o:.6g}' for o in objs)}; epoch s "
        f"{', '.join(f'{s:.3f}' for s in epoch_s)} (objective excluded); "
        f"launches {launches}")
    assert all(b < a for a, b in zip(objs, objs[1:])), "objective must fall"
    assert launches == {"gram": 6, "cd_slab_reduce": 0,
                        "cd_slab_reduce_gather": 3 * 2 * nb,
                        "cd_slab_reduce_gather:one_tile": 3 * 2 * nb,
                        "cd_resid_patch": 0,
                        "cd_resid_patch_gather": 3 * 2 * nb,
                        "cd_resid_patch_gather:reg_slots": 3 * 2 * nb}, launches

    # one epoch from one start through the pregather route and the flat path
    pg, eg = first
    reset_slab_counts()
    t = time.perf_counter()
    pp, ep_ = mfsi.epoch_padded(params0, x, z, pdata,
                                mfsi.residuals_padded(params0, x, z, data, pdata),
                                dataclasses.replace(hp, psi_dispatch="pregather"))
    torch.cuda.synchronize()
    pre_s, pre_launches = time.perf_counter() - t, read_slab_counts()
    assert pre_launches["cd_slab_reduce"] == 2 * nb and \
        pre_launches["cd_slab_reduce:one_tile"] == 2 * nb and \
        pre_launches["cd_resid_patch"] == 2 * nb and \
        pre_launches["cd_slab_reduce_gather"] == 0, pre_launches
    d_pre = _hold_params(pp, pg, ep_, eg)
    obj_pre = float(mfsi.objective(pp, x, z, data, hp))
    del pp, ep_
    t = time.perf_counter()
    pf, ef = mfsi.epoch(params0, x, z, data,
                        mfsi.residuals(params0, x, z, data), hp)
    torch.cuda.synchronize()
    flat_s = time.perf_counter() - t
    d_flat = _hold_params(pf, pg, ef, eg[pdata.c_rows, pdata.c_cols])
    del pf, ef
    log(f"phase 14 one epoch from one start: gather {epoch_s[0]:.3f}s, "
        f"pregather {pre_s:.3f}s (slab reduce one-tile in all "
        f"{pre_launches['cd_slab_reduce:one_tile']} launches; objective "
        f"{obj_pre:.6g}, the gather epoch's {objs[1]:.6g}; max |d param| "
        f"{d_pre:.3g}), flat mfsi.epoch "
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
    return {"launches": launches, "pre_launches": pre_launches, "pdata": pdata,
            "x": x, "z": z, "data": data}


def time_slab_kernels(dev, pdata, m: int = 8, phase: int = 15,
                      ld: int = FULL["k"]) -> dict:
    """Phase 15 (m = 8, MFSI's blocks) and phase 20 (m = 9, FM's
    [Ψ[:, blk] | ψ_spec]): CUDA-event times of kernels 6–9 at both sides'
    full-width shapes, on the log's ids and α with random values (the ψ
    slab a column slice of a table of ``ld`` columns: k = 128 for MFSI's
    slice, m for FM's concatenated slab), beside their plain versions,
    their bounds and, for the pre-gathered forms, the one ``torch.bmm``
    (``baddbmm``) that computes the same function on the same tile. Where
    m takes the register forms (the one-tile slab reduce at m ≤ 9, the
    register-slot patch at m ≤ 8), also the tiled and one-slot kernels
    they replaced, in the same call."""
    from repro_torch.kernels import vmem
    from repro_torch.kernels.cd_sweep import kernel as ck, ops as cs, ref as cr
    from repro_torch.obs.costs import cd_resid_patch_cost, cd_slab_reduce_cost

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(phase)
    names = ("cd_slab_reduce", "cd_slab_reduce_gather", "cd_resid_patch",
             "cd_resid_patch_gather")
    out = {n: {"ms": [], "plain": [], "bound": [], "lib": [], "tiled": [],
               "one_slot": []} for n in names}
    sides = (("context", pdata.item_ids, pdata.alpha_c, FULL["n_items"]),
             ("item", pdata.ctx_ids, pdata.alpha_i, FULL["n_ctx"]))
    for side, ids, alpha, n_src in sides:
        c, d = alpha.shape
        x = slab_inputs(gen, dev, c, d, m, n_src, pad_frac=0, k=ld, ids=ids,
                        alpha=alpha)
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
        q_t, p_t = torch.empty((c, m), device=dev), torch.empty((c, m, m), device=dev)

        def tiled(i, gather=True):  # the tiled form the one-tile form replaced
            ck.slab_reduce(None if gather else psi, tab if gather else None,
                           ids if gather else None, alpha, es[i % 2], q_t, p_t)
            return q_t, p_t

        def one_slot(i):  # the gather patch the register-slot form replaced
            ck.resid_patch(None, tab, ids, es[i % 2], dphi)
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
            lib_txt = f"{r['lib'][-1]:.4f} ms" if lib else "— (none: a gather comes first)"
            form = f", form {cost['form']}"
            if name in ("cd_slab_reduce", "cd_slab_reduce_gather") and \
                    cost["form"] == vmem.SLAB_ONE_TILE:
                q_n, p_n = fn(0)
                q_o, p_o = tiled(0, gather)
                torch.cuda.synchronize()
                same = torch.equal(q_n, q_o) and torch.equal(p_n, p_o)
                assert same, f"{name}: one-tile and tiled forms differ"
                gap = max(float((q_n - q_o).abs().max()), float((p_n - p_o).abs().max()))
                r["tiled"].append(device_ms(lambda i: tiled(i, gather), n=20))
                form = (f", form {cost['form']} ({vmem.cd_slab_reduce_lanes(d)} "
                        f"lanes a row; against the tiled form max |d| {gap:.3g}, "
                        f"equal bit for bit: {same}); the tiled form it replaced "
                        f"{r['tiled'][-1]:.4f} ms")
                del q_n, p_n
            if name == "cd_resid_patch_gather" and cost["form"] == vmem.PATCH_REG_SLOTS:
                e_new, e_old = e.clone(), e.clone()
                cs.cd_resid_patch_gather(tab, ids, e_new, dphi)
                ck.resid_patch(None, tab, ids, e_old, dphi)
                torch.cuda.synchronize()
                same = torch.equal(e_new, e_old)
                assert same, "register-slot and one-slot patches differ"
                r["one_slot"].append(device_ms(one_slot, n=20))
                form = (f", form {cost['form']} ({vmem.CDG_PATCH_SLOTS} slots a "
                        f"thread; equal bit for bit to the one-slot kernel: "
                        f"{same}); the one-slot kernel it replaced "
                        f"{r['one_slot'][-1]:.4f} ms")
                del e_new, e_old
            log(f"phase {phase} {name} {side} side (C {c}, D_pad {d}, m {m}, n_src "
                f"{n_src}){form}: kernel {r['ms'][-1]:.4f} ms, plain "
                f"{r['plain'][-1]:.4f} ms, library {lib_txt}, bound "
                f"{r['bound'][-1][0]:.4f} ms ({r['bound'][-1][1]}: "
                f"{cost['hbm_bytes']:.0f} B, {cost['flops']:.0f} FLOP)")
        del x, psi, es
    return out


# ---------------------------------------------------------------------------
# Serving tier: the quantized IVF mesh, delta publish, staged rollout, the
# sharded cluster fed by a publisher (phase 16) and the top-K forms' times
# (phase 17).
# ---------------------------------------------------------------------------
IVF_PROBES = (1, 4, 16, 46)      # AnnConfig's default at a 34,000-row shard: 46


def _dequantized(indexes, n_items, d, dev):
    """The (n_items, D) fp32 table the IVF indexes store (their rows
    dequantized as the kernel does), in global id order."""
    from repro_torch.kernels.topk_score.ref import dequantize_psi

    out = torch.zeros((n_items, d), device=dev)
    for idx in indexes:
        live = idx.ids_global >= 0
        deq = dequantize_psi(idx.psi_q, idx.scales)
        out[idx.ids_global[live].long()] = deq[live]
    return out


def ivf_block_loop(idx, phi, k, n_probe, eids):
    """The IVF query as the reference runs it: one ``topk_score`` launch a
    probed block over its valid rows (exclusions mapped to positions), the
    rows that did not probe the block masked, positions mapped to global
    ids, then the merge by (−score, global id)."""
    from repro_torch.kernels.topk_score import ops

    b, c = phi.shape[0], idx.n_clusters
    cs = phi @ idx.centroids.T
    sel = torch.sort(cs, dim=1, descending=True, stable=True).indices[:, :n_probe]
    probe = torch.zeros((b, c), dtype=torch.bool, device=phi.device)
    probe.scatter_(1, sel, True)
    e = eids.long() - idx.id_offset
    ok = (eids >= 0) & (e >= 0) & (e < idx.n_rows)
    epos = torch.where(ok, idx.inv_pos[e.clamp(0, idx.n_rows - 1)], -1)
    epos = epos.to(torch.int32).contiguous()
    parts_s, parts_i = [], []
    for cl in probe.any(dim=0).nonzero()[:, 0].tolist():
        lo, n = cl * idx.block_rows, int(idx.counts[cl])
        if n == 0:
            continue
        ss, ii = ops.topk_score(
            phi, idx.psi_q[lo:lo + n], k, exclude_ids=epos, id_offset=lo,
            psi_scale=None if idx.scales is None else idx.scales[lo:lo + n])
        m = probe[:, cl][:, None]
        parts_s.append(torch.where(m, ss, float("-inf")))
        parts_i.append(torch.where(m & (ii >= 0),
                                   idx.ids_global[ii.clamp(min=0).long()], -1))
    return ops.topk_merge_shards(torch.stack(parts_s), torch.stack(parts_i), k)


def serve_ivf_full_width(dev, params, pdata) -> dict:
    """Phase 16: the quantized IVF serving tier at full icd-mf width on
    phase 6's trained factors."""
    from repro_torch.core.models import mf, mf_padded
    from repro_torch.eval.ranking import ann_recall_curve
    from repro_torch.kernels.topk_score import ops as tops, ref as tref
    from repro_torch.obs import MetricsRegistry
    from repro_torch.serve.ann import AnnConfig, ivf_cluster_topk
    from repro_torch.serve.batcher import MicroBatcher
    from repro_torch.serve.cluster import ShardedRetrievalCluster
    from repro_torch.serve.engine import RetrievalEngine, exclude_ids_from_lists
    from repro_torch.serve.mesh import (
        FaultInjector,
        FaultTolerantRetrievalMesh,
        RetryPolicy,
    )
    from repro_torch.serve.publish import PsiPublisher, StagedRollout, dense_table

    k, n_items, d = 100, FULL["n_items"], FULL["k"]
    psi = mf.export_psi(params)
    phi_all = mf.build_phi(params, torch.arange(FULL["n_ctx"], device=dev)).cpu().numpy()
    rng = np.random.default_rng(16)
    users = rng.integers(0, FULL["n_ctx"], size=256)
    excl = [rng.choice(n_items, size=int(rng.integers(0, 20)), replace=False)
            for _ in users]
    probe_users = users[:16]
    phi16 = torch.as_tensor(phi_all[probe_users], device=dev)
    eids16 = exclude_ids_from_lists([excl[j] for j in range(16)], device=dev)
    exact = FaultTolerantRetrievalMesh(None, n_shards=2, n_replicas=2, k=k)
    exact.publish(psi)
    ex_res = exact.topk_phi(phi16, exclude_ids=eids16)

    def counts():
        return {f: getattr(tops.topk_score, f) for f in
                ("launches", "launches_bf16", "launches_int8", "launches_mask",
                 "launches_ivf")}

    out = {"launches": {}, "meshes": {}}
    for q in ("none", "bf16", "int8"):
        reg = MetricsRegistry(clock=time.perf_counter)
        inj = FaultInjector()
        mesh = FaultTolerantRetrievalMesh(
            None, n_shards=2, n_replicas=2, k=k, retrieval="ivf",
            ann=AnnConfig(quant=q), injector=inj,
            retry=RetryPolicy(max_attempts=3, deadline=2e-3), registry=reg)
        mesh.publish(psi)
        torch.cuda.synchronize()
        t = time.perf_counter()
        indexes = mesh._ivf_indexes(mesh.table)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t
        n_c = [ix.n_clusters for ix in indexes]
        probe = [ix.cfg.resolve_probe(c) for ix, c in zip(indexes, n_c)]
        inj.fail(0, 0, "error")
        batcher = MicroBatcher(
            lambda phi, eids, m=mesh: m.topk_phi(phi, exclude_ids=eids),
            max_batch=16, max_delay=2e-3, clock=time.perf_counter,
            version_fn=lambda m=mesh: m.version, registry=reg)
        for f in counts():
            setattr(tops.topk_score, f, 0)
        t0 = time.perf_counter()
        tickets = []
        for u, e in zip(users, excl):
            tickets.append(batcher.submit(phi_all[u], exclude=e,
                                          key=("user", int(u))))
            batcher.step()
        batcher.flush()
        dt = time.perf_counter() - t0
        launched = counts()
        out["launches"][q] = launched
        flushes = batcher.stats["flushes"]
        lat = [batcher.completed_at(tk) - t0 for tk in tickets]
        cov = min(batcher.result(tk).coverage for tk in tickets)
        assert cov == 1.0, (q, cov)
        ms = mesh.stats
        assert ms["faults"] >= 1 and ms["failovers"] >= 1, dict(ms)
        # one IVF launch chain a live shard and call (both shards answer
        # every flush; the killed replica's dispatch fails before its
        # launch), and no other launch of the top-K kernel
        probes = reg.get("ann_probed_blocks_total")
        assert launched["launches_ivf"] == 2 * flushes == launched["launches"] \
            == ms["dispatches"] - ms["faults"], (launched, flushes, dict(ms))
        # the oracle probe: every block, no pruning
        full = ivf_cluster_topk(mesh.table, indexes, phi16, k,
                                n_probe=max(n_c), exclude_ids=eids16)
        if q == "none":
            assert torch.equal(full.ids, ex_res.ids) and torch.equal(
                full.scores, ex_res.scores), "oracle probe != exact mesh"
            oracle = "bit-identical to the exact mesh"
        else:
            deq = _dequantized(indexes, n_items, d, dev)
            rs, ri = tref.topk_score_ref(phi16, deq, k + 1, exclude_ids=eids16)
            torch.cuda.synchronize()
            torch.testing.assert_close(full.scores, rs[:, :k], rtol=RTOL, atol=ATOL)
            ids_agree(rs[:, :k], ri[:, :k], full.ids, rs[:, k])
            oracle = (f"equals a plain recompute over the dequantized table "
                      f"(max |err| {float((full.scores - rs[:, :k]).abs().max()):.3g})")
        curve = ann_recall_curve(
            indexes[0], torch.as_tensor(phi_all[users], device=dev),
            psi[: mesh.table.rows_per], k=k, n_probes=IVF_PROBES + (n_c[0],))
        # the one-chain IVF form equals the reference's per-block loop bit
        # for bit (the same FMAs a row; ties by global id either way) for
        # the 256 users in batches of 16, at n_probe 46 and 184
        eids_all = exclude_ids_from_lists(excl, device=dev)
        for lo in range(0, len(users), 16):
            phi_b = torch.as_tensor(phi_all[users[lo:lo + 16]], device=dev)
            for p in (probe[0], n_c[0]):
                got = indexes[0].topk(phi_b, k, n_probe=p,
                                      exclude_ids=eids_all[lo:lo + 16])
                want = ivf_block_loop(indexes[0], phi_b, k, p,
                                      eids_all[lo:lo + 16])
                assert torch.equal(got[1], want[1]) and torch.equal(
                    got[0], want[0]), (q, lo, p)
        flush_profile = epoch_breakdown(
            lambda m=mesh: m.topk_phi(phi16, exclude_ids=eids16))
        log(f"phase 16 ivf {q}: 2 shards x 2 replicas, replica (0, 0) killed; "
            f"{n_c} clusters, n_probe {probe}, block_rows "
            f"{[ix.block_rows for ix in indexes]}, index build {build_s:.3f}s; "
            f"256 requests in {flushes} flushes: {256 / dt:.1f} req/s, "
            f"completion p50 {np.percentile(lat, 50) * 1e3:.3f} ms p99 "
            f"{np.percentile(lat, 99) * 1e3:.3f} ms, coverage {cov}; "
            f"{launched['launches_ivf']} IVF launch chains "
            f"({launched['launches_ivf'] / flushes:.1f} per flush, one a shard; "
            f"bf16 {launched['launches_bf16']}, int8 "
            f"{launched['launches_int8']}) over {probes:.0f} probed blocks "
            f"({probes / flushes:.1f} per flush), {ms['dispatches']} dispatches, "
            f"{ms['faults']} faults, {ms['failovers']} failovers, no host copy "
            f"before a launch; the 256 users' results at n_probe "
            f"{probe[0]} and {n_c[0]} equal one launch a probed block, bit for "
            f"bit; oracle probe "
            f"{oracle}; recall@{k} of shard 0 over the 256 users by n_probe "
            + ", ".join(f"{pt['n_probe']}: {pt[f'recall@{k}']:.4f}" for pt in curve))
        log(f"phase 16 ivf {q} one 16-row query (torch.profiler): {flush_profile}")
        out["meshes"][q] = mesh
        out.setdefault("index", {})[q] = indexes[0]     # phase 17 times it
        out.setdefault("serve", {})[q] = dict(req_s=256 / dt, flushes=flushes,
                                               launches=launched["launches"])

    # delta publish into the fp32 IVF mesh: 8 patched rows (both shards)
    # and 8 appended ids, each retrievable by its own direction
    mesh, reg = out["meshes"]["none"], out["meshes"]["none"].registry
    g = torch.Generator(device=dev).manual_seed(17)
    half = n_items // 2                    # shard 1 starts here
    patch_ids = np.asarray([5, n_items // 7, n_items // 3, half - 1, half,
                            3 * n_items // 5, 8 * n_items // 9, n_items - 1])
    ids = np.concatenate([patch_ids, np.arange(n_items, n_items + 8)])
    rows = 50.0 * torch.randn((16, d), generator=g, device=dev)
    v = mesh.publish_delta(rows, ids)
    assert mesh.n_items == n_items + 8
    idx2 = mesh._ivf_indexes(mesh.table)
    top_oracle = ivf_cluster_topk(mesh.table, idx2, rows, 1,
                                  n_probe=max(ix.n_clusters for ix in idx2))
    assert torch.equal(top_oracle.ids[:, 0].cpu(), torch.as_tensor(ids, dtype=torch.int32)), \
        "a delta row is not retrievable"
    top_served = mesh.topk_phi(rows, k=1).ids[:, 0].cpu().numpy()
    # a patch-only delta of 72 rows into shard 0 keeps the geometry: the
    # indexes fold it, and the staleness budget (64) forces a rebuild
    patch72 = 100 + np.arange(72) * ((half - 200) // 72)
    mesh.publish_delta(
        dense_table(mesh.table)[torch.as_tensor(patch72, device=dev)] * 1.5,
        patch72)
    reindexes = reg.get("ann_reindexes_total")
    assert reindexes == 1, reindexes
    log(f"phase 16 delta: 8 patched + 8 appended rows -> v{v}, n_items "
        f"{mesh.n_items} (the geometry changed, so the indexes were rebuilt "
        f"lazily); all 16 top-1 for their own direction at the oracle probe, "
        f"{int((top_served == ids).sum())}/16 at the served n_probe; a "
        f"72-row patch into shard 0 folded and spent the staleness budget: "
        f"ann_reindexes_total {reindexes:.0f}")

    # staged rollout on the same mesh: a good table, then a NaN table
    rollout = StagedRollout(mesh, mirror_phi=phi16)
    live_v = mesh.version
    ok, _ = rollout.publish(dense_table(mesh.table) * 0.5)
    bad = torch.full((mesh.n_items, d), float("nan"), device=dev)
    ok_bad, report = rollout.publish(bad)
    assert ok and not ok_bad and mesh.version == live_v + 1, (ok, ok_bad, report)
    assert not report["checks"]["scores_finite"]
    assert not any(r.canary for row in mesh.replica_set.replicas for r in row)
    log(f"phase 16 rollout: good table promoted (v{live_v} -> v{mesh.version}), "
        f"NaN table rolled back (checks {report['checks']})")

    # the sharded cluster fed by a publisher over 2 mf_padded epochs; its
    # top-K, with a dense exclusion mask sliced per shard, is the engine's
    out.pop("meshes")
    del exact, mesh, idx2, rollout
    hp = mf.MFHyperParams(k=d, alpha0=FULL["alpha0"], l2=FULL["l2"])
    cluster = ShardedRetrievalCluster(None, n_shards=4, k=k)
    pub = PsiPublisher(cluster, mf.export_psi)
    mask16 = torch.zeros((16, n_items), dtype=torch.bool, device=dev)
    for r in range(16):
        mask16[r, torch.as_tensor(excl[r], device=dev).long()] = True
    tops.topk_score.launches_mask = 0
    p2 = mf_padded.fit(params, pdata, hp, 2, callback=pub)
    engine = RetrievalEngine(mf.export_psi(p2), None, k=k)
    a = cluster.topk_phi(phi16, exclude_mask=mask16)
    b = engine.topk_phi(phi16, exclude_mask=mask16)
    torch.cuda.synchronize()
    out["launches"]["mask"] = tops.topk_score.launches_mask
    out["query"] = (phi16, eids16)
    assert [v for _, v in pub.versions] == [1, 2], pub.versions
    assert torch.equal(a.ids, b.ids) and torch.equal(a.scores, b.scores)
    c = cluster.topk_phi(phi16, exclude_ids=eids16)
    assert torch.equal(c.ids, a.ids) and torch.equal(c.scores, a.scores)
    log(f"phase 16 cluster: 4 shards fed by a PsiPublisher over 2 "
        f"mf_padded.fit epochs, versions {pub.versions}; top-{k} with a dense "
        f"(16, {n_items}) mask (4 shard slices, {out['launches']['mask']} "
        f"mask-form launches with the engine's) bit-identical to the engine "
        f"and to the exclude-id form")
    return out


def _time_form(ops, tref, phi, tables, k, *, scale_of=None, mask=None,
               n_valid=None, block_items=None, n=50, chain=None):
    """(kernel ms, plain ms, yardstick ms) of one top-K form, rotating over
    ``tables`` (their total past the L2 cache where they are large); with
    ``chain`` (a dict), also the three-launch chain's time, in
    ``chain["ms"]``."""
    sc = scale_of or (lambda j: None)
    kw = dict(n_valid=n_valid)
    kern = device_ms(lambda j: ops.topk_score(
        phi, tables[j % len(tables)], k, mask, psi_scale=sc(j),
        block_items=block_items, **kw), n=n)
    if chain is not None:
        chain["ms"] = device_ms(lambda j: ops.topk_score(
            phi, tables[j % len(tables)], k, mask, psi_scale=sc(j),
            form="chain", **kw), n=n)
    plain = device_ms(lambda j: tref.topk_score_ref(
        phi, tables[j % len(tables)], k, mask, psi_scale=sc(j), **kw), n=n)

    def yard(j):
        s = phi @ tref.dequantize_psi(tables[j % len(tables)], sc(j)).T
        if mask is not None:
            s = s.masked_fill(mask, float("-inf"))
        return torch.topk(s, min(k, s.shape[1]))

    return kern, plain, device_ms(yard, n=n)


def time_topk_forms(dev, ivf) -> dict:
    """Phase 17: CUDA-event times of the top-K forms at the serving shard
    (B=16, 34,000 × 128, K=100), each beside its plain version, its bound
    (ψ at the stored width) and the yardstick ``torch.topk(phi @
    deq(psi).T, k)`` (dequantization included), which the port never
    calls; the IVF form at the serving shard's index (:func:`time_ivf_form`);
    the chunk of small tables (:func:`time_small_tables`); K = 10,000; and
    the large-K merge at K = 257, 512, 1,000 and 8,192."""
    from repro_torch.core.quant import int8_quantize_rows
    from repro_torch.kernels import vmem
    from repro_torch.kernels.topk_score import ops, ref as tref
    from repro_torch.obs.costs import topk_score_cost

    b, rows, d, k = (SERVE_SHAPE[x] for x in ("b", "rows", "d", "k"))
    gen = torch.Generator(device=dev).manual_seed(18)
    phi = torch.randn((b, d), generator=gen, device=dev)
    fp32 = [torch.randn((rows, d), generator=gen, device=dev) for _ in range(4)]
    quant = [int8_quantize_rows(t) for t in fp32]
    out = {}

    chain = {}

    def put(name, t, nbytes, flops, label):
        bms = max(nbytes / H100_BYTES_PER_S, flops / H100_FP32_FLOPS) * 1e3
        by = "bytes" if nbytes / H100_BYTES_PER_S >= flops / H100_FP32_FLOPS else "operations"
        out[name] = dict(ms=t[0], plain=t[1], lib=t[2], bound=bms, bound_by=by)
        if "ms" in chain:
            out[name]["chain"] = chain.pop("ms")
            label += f" (one launch; the three-launch chain {out[name]['chain']:.4f} ms)"
        log(f"phase 17 time {label}: kernel {t[0]:.4f} ms, plain {t[1]:.4f} ms, "
            f"yardstick torch.topk(phi @ deq(psi).T) {t[2]:.4f} ms, bound "
            f"{bms:.4f} ms ({by}: {nbytes:.0f} B, {flops:.0f} FLOP)")

    def cost(n_rows, k_, **kw):
        # B = 16 is one φ block, so the model reads ψ once at its stored
        # width (psi_row_bytes), φ, the (B, k) outputs and the mask
        c = topk_score_cost(b, n_rows, d, k_, **kw)
        return c["hbm_bytes"], c["flops"]

    put("fp32", _time_form(ops, tref, phi, fp32, k, chain=chain), *cost(rows, k),
        "fp32 psi (34,000 x 128)")
    # distinct copies, so that the rotation's total passes the 50 MB L2
    bf = [fp32[j % 4].bfloat16() for j in range(12)]
    put("bf16", _time_form(ops, tref, phi, bf, k, chain=chain),
        *cost(rows, k, psi_bytes=2), "bf16 psi")
    q8 = [quant[j % 4][0].clone() for j in range(24)]
    put("int8", _time_form(ops, tref, phi, q8, k, chain=chain,
                           scale_of=lambda j: quant[j % 4][1]),
        *cost(rows, k, psi_bytes=1, per_row_scale=True),
        "int8 psi + per-row scale")
    del bf, q8
    mask = torch.rand((b, rows), generator=gen, device=dev) < 0.01
    put("mask", _time_form(ops, tref, phi, fp32, k, mask=mask, chain=chain),
        *cost(rows, k, mask=True), "fp32 psi, dense (16, 34,000) bool mask")
    for name, e in time_ivf_form(dev, ivf, put).items():
        out[name]["err"] = e
    put("k256", _time_form(ops, tref, phi, fp32, 256, chain=chain),
        *cost(rows, 256), "fp32 psi, K = 256 (the one-launch form's largest K)")
    out["small"] = time_small_tables(dev, phi)
    put("k10000", _time_form(ops, tref, phi, fp32, 10_000, n=10),
        *cost(rows, 10_000), "fp32 psi, K = 10,000 (device-memory merge)")
    out.update(time_large_k(dev))
    return out


def time_ivf_form(dev, ivf, put) -> dict:
    """Phase 17, the IVF form at the serving shard: phase 16's shard-0
    index of each storage form (34,000 rows in 184 clusters), phase 16's 16
    φ rows with their exclude lists, K = 100, probes at n_probe 46 (built
    outside the timed calls, as ``PsiIndex.topk`` builds them before its
    launch). Kernel: one ``topk_score_ivf`` call (plan, pass 1, merges);
    plain: its plain version; yardstick: ``torch.topk`` over the dense
    scores with the inadmissible pairs masked (the mask built outside the
    timed call), which the port never calls. The bound counts the rows
    the batch probed. Each form is also held against its plain version;
    returns the max |score error| by form."""
    from repro_torch.kernels.topk_score import ops, ref as tref
    from repro_torch.obs.costs import topk_score_ivf_cost

    phi, eids = ivf["query"]
    k = SERVE_SHAPE["k"]
    errs = {}
    for q, idx in ivf["index"].items():
        c, br = idx.n_clusters, idx.block_rows
        cs = phi @ idx.centroids.T
        sel = torch.sort(cs, dim=1, descending=True,
                         stable=True).indices[:, :idx.cfg.resolve_probe(c)]
        probe = torch.zeros((phi.shape[0], c), dtype=torch.bool, device=dev)
        probe.scatter_(1, sel, True)
        args = dict(probe_mask=probe, counts=idx.counts_dev,
                    ids_global=idx.ids_global, block_rows=br,
                    exclude_ids=eids, psi_scale=idx.scales)
        got = ops.topk_score_ivf(phi, idx.psi_q, k, **args)
        want = tref.topk_score_ivf_ref(phi, idx.psi_q, k + 1, **args)
        torch.cuda.synchronize()
        torch.testing.assert_close(got[0], want[0][:, :k], rtol=RTOL, atol=ATOL)
        ids_agree(want[0][:, :k], want[1][:, :k], got[1], want[0][:, k])
        err = float((got[0] - want[0][:, :k]).nan_to_num(0, 0, 0).abs().max())
        slot = torch.arange(c * br, device=dev)
        live = (slot % br < idx.counts_dev.long()[slot // br])[None] \
            & probe[:, slot // br]
        ex = tref.exclude_ids_to_mask(eids, idx.n_rows, id_offset=idx.id_offset)
        gid = (idx.ids_global.long() - idx.id_offset).clamp(min=0)
        inadmissible = ~live | ex[:, gid]

        def yard(j):
            s = (phi @ tref.dequantize_psi(idx.psi_q, idx.scales).T
                 ).masked_fill(inadmissible, float("-inf"))
            return torch.topk(s, k)

        t = (device_ms(lambda j: ops.topk_score_ivf(phi, idx.psi_q, k, **args)),
             device_ms(lambda j: tref.topk_score_ivf_ref(phi, idx.psi_q, k,
                                                         **args), n=10),
             device_ms(yard))
        live_c = probe.any(dim=0) & (idx.counts_dev > 0)
        rows = int(idx.counts_dev[live_c].sum())
        cost = topk_score_ivf_cost(
            phi.shape[0], rows, idx.d, k, c,
            psi_bytes={"none": 4, "bf16": 2, "int8": 1}[q],
            per_row_scale=q == "int8", excl_l=int(eids.shape[1]))
        put(f"ivf_{q}", t, cost["hbm_bytes"], cost["flops"],
            f"IVF form, {q} psi, shard 0's index ({c} clusters of {br} rows, "
            f"{int(live_c.sum())} probed holding {rows} rows; max |score err| "
            f"{err:.3g})")
        errs[f"ivf_{q}"] = err
    return errs


def time_small_tables(dev, phi) -> dict:
    """Phase 17, small tables: ``topk_score`` over n rows at B = 1 and 16,
    K = 10, in the one-launch form, and in the chain it replaced at the
    narrowest chunk that holds the table (at least 32 rows and k_pad) and
    at the full chunk (256, ``vmem.topk_block_items``)."""
    from repro_torch.kernels import vmem
    from repro_torch.kernels.topk_score import ops

    gen = torch.Generator(device=dev).manual_seed(20)
    out = {}
    parts = []
    for n in (9, 40, 100):
        tables = [torch.randn((n, phi.shape[1]), generator=gen, device=dev)
                  for _ in range(4)]
        chunk = max(32, vmem.topk_k_pad(10), 1 << (n - 1).bit_length())
        for b in (1, 16):
            t = [device_ms(lambda j: ops.topk_score(phi[:b], tables[j % 4], 10,
                                                    block_items=ch, form="chain"))
                 for ch in (chunk, vmem.TOPK_MAX_CHUNK)]
            fused = device_ms(lambda j: ops.topk_score(phi[:b], tables[j % 4], 10))
            out[(n, b)] = (chunk, *t, fused)
            parts.append(f"n {n} B {b}: one launch {fused:.4f} ms; chain at "
                         f"chunk {chunk} {t[0]:.4f} ms, chunk "
                         f"{vmem.TOPK_MAX_CHUNK} {t[1]:.4f} ms")
    log("phase 17 small tables (K = 10): " + "; ".join(parts))
    return out


def run_serve_retrieval(dev) -> dict:
    """Phase 18: the serve_retrieval twin on the card, with the same
    assertions as the CPU test of it."""
    from repro_torch.examples import serve_retrieval

    t = time.perf_counter()
    lines = []
    out = serve_retrieval.run(device=dev, log=lines.append)
    assert out["versions"] == [1, 2] and out["mesh_version"] == 2, out
    assert out["recall_curve"][-1]["recall@100"] == 1.0, out["recall_curve"]
    assert out["int8_recall"] > 0.9 and out["degraded_coverage"] == 0.75, out
    for ln in lines:
        log(f"phase 18 serve_retrieval: {ln}")
    log(f"phase 18 serve_retrieval twin on the card passed in "
        f"{time.perf_counter() - t:.1f}s")
    return out


def time_large_k(dev, ks=(257, 512, 1_000, 8_192)) -> dict:
    """Phase 17, the large-K merge at the serving shard (B=16, 34,000 ×
    128, fp32): CUDA-event times of ``ops.topk_score`` at each K beside
    its plain version, the yardstick ``torch.topk(phi @ psi.T, k)`` and
    its bound."""
    from repro_torch.kernels.topk_score import ops, ref as tref
    from repro_torch.obs.costs import topk_score_cost

    b, rows, d = (SERVE_SHAPE[x] for x in ("b", "rows", "d"))
    gen = torch.Generator(device=dev).manual_seed(19)
    phi = torch.randn((b, d), generator=gen, device=dev)
    tables = [torch.randn((rows, d), generator=gen, device=dev) for _ in range(4)]
    out = {}
    for kk in ks:
        kern = device_ms(lambda j: ops.topk_score(phi, tables[j % 4], kk), n=20)
        plain = device_ms(lambda j: tref.topk_score_ref(phi, tables[j % 4], kk), n=10)
        yard = device_ms(lambda j: torch.topk(phi @ tables[j % 4].T, kk), n=10)
        c = topk_score_cost(b, rows, d, kk)
        bms = max(c["hbm_bytes"] / H100_BYTES_PER_S, c["flops"] / H100_FP32_FLOPS) * 1e3
        out[f"k{kk}"] = dict(ms=kern, plain=plain, lib=yard, bound=bms)
        log(f"phase 17 time large K = {kk}: kernel {kern:.4f} ms, plain "
            f"{plain:.4f} ms, yardstick torch.topk(phi @ psi.T) {yard:.4f} ms, "
            f"bound {bms:.4f} ms ({c['hbm_bytes']:.0f} B, {c['flops']:.0f} FLOP)")
    return out


# ---------------------------------------------------------------------------
# Slice 4b and fold-in: FM at icd-fm width on the slab kernels at m = 9
# (phase 19), rows 1 and 6–9 at FM's shapes (phase 20), FM served from the
# Model API and fold-in against the float64 oracle (phase 21), the serve
# driver's --continual at full icd-mf width (phase 22).
# ---------------------------------------------------------------------------
# fold-in rows against the float64 oracle (tests/test_foldin.py)
FOLD_RTOL, FOLD_ATOL = 2e-4, 2e-5
# FM's fused block at block_k 0: k_b 8 columns and ψ_spec
FM_M = 8 + 1


def fm_epochs(fm, p, x, z, pdata, e, hp, n):
    """``n`` fused FM epochs from (p, e): the params after each, the
    first epoch's (params, residual grid copy), and the wall s of each."""
    secs, first = [], None
    for _ in range(n):
        t = time.perf_counter()
        p, e = fm.epoch_padded(p, x, z, pdata, e, hp)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
        first = first or (p, e.clone())
    return p, e, first, secs


def fold_in_oracle(table, ids, free, init, hp) -> dict:
    """One fold-in's float64 oracle on the CPU: ``fold_in_exact``'s row,
    the table's TᵀT, and, as a note, the condition number of the row's
    normal matrix M = A + α₀G + λI over the free coordinates (the larger,
    the more sweeps a row takes to converge)."""
    from repro_torch.core import foldin

    t64 = table.cpu().double()
    want = foldin.fold_in_exact(table.cpu(), ids, free=free, init=init,
                                alpha0=hp.alpha0, l2=hp.l2).double()
    g64 = t64.T @ t64
    sel = t64[torch.as_tensor(np.asarray(ids, np.int64))]
    m = sel.T @ sel + hp.alpha0 * g64 + hp.l2 * torch.eye(
        t64.shape[1], dtype=torch.float64)
    fr = torch.as_tensor(np.flatnonzero(np.ones(t64.shape[1], bool) if free is None
                                        else free))
    ev = torch.linalg.eigvalsh(m[fr][:, fr])
    return {"want": want, "g": g64, "t": t64, "cond": float(ev[-1] / ev[0]),
            "score_max": float((t64 @ want).abs().max())}


def train_fm_full_width(dev, x, z, data, pdata) -> dict:
    """Phase 19: FM at icd-fm width (``configs/icd_fm``) on phase 14's log
    and designs: 3 ``epoch_padded`` epochs with the defaults (block_k 0 →
    k_b 8, m = 9: the slab reduce's one-tile m = 9 instance and the
    one-slot residual patch, gather routing, jacobi), the objective
    falling every epoch; from one start a pregather (one-tile too), a flat
    and a block_k 7 (m = 8: the one-tile and register-slot forms) epoch
    held against the gather one; profiles of one epoch at m = 9 and at m =
    8."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.models import fm
    from repro_torch.kernels.segment_sum import ops as seg_ops

    cfg = get_config("icd-fm")
    assert (x.p, z.p, x.n_rows, z.n_rows, cfg.k) == (
        cfg.p_ctx, cfg.p_item, cfg.n_ctx, cfg.n_items, FULL["k"]), (x.p, z.p)
    k = cfg.k
    hp = fm.FMHyperParams(k=k, alpha0=cfg.alpha0, l2=cfg.l2,
                          implementation="pallas")
    params0 = fm.init(x.p, z.p, k, generator=torch.Generator(device=dev).manual_seed(19))
    objs = [float(fm.objective(params0, x, z, data, hp))]
    e0 = fm.residuals_padded(params0, x, z, data, pdata, hp)
    torch.cuda.synchronize()
    reset_slab_counts()
    p, e, first = params0, e0.clone(), None
    epoch_s = []
    for _ in range(3):
        p, e, f1, secs = fm_epochs(fm, p, x, z, pdata, e, hp, 1)
        first = first or f1
        epoch_s += secs
        objs.append(float(fm.objective(p, x, z, data, hp)))
    launches = read_slab_counts()
    nb = -(-k // 8)
    log(f"phase 19 train: fm.epoch_padded x3 (icd-fm: p_ctx {x.p}, p_item "
        f"{z.p}, k {k}, D = k + 2 = {k + 2}; block_k 0 -> k_b 8, m 9, gather, "
        f"jacobi, Gram kernel; slab reduce one-tile, m = 9 instance): objective "
        f"{' -> '.join(f'{o:.6g}' for o in objs)}; "
        f"epoch s {', '.join(f'{s:.3f}' for s in epoch_s)} (objective "
        f"excluded); launches {launches}")
    assert all(b < a for a, b in zip(objs, objs[1:])), "objective must fall"
    assert launches == {"gram": 6, "cd_slab_reduce": 0,
                        "cd_slab_reduce_gather": 3 * 2 * nb,
                        "cd_slab_reduce_gather:one_tile": 3 * 2 * nb,
                        "cd_resid_patch": 0,
                        "cd_resid_patch_gather": 3 * 2 * nb,
                        "cd_resid_patch_gather:reg_slots": 0}, launches

    # one epoch from one start: pregather, flat and block_k 7 (m = 8)
    pg, eg = first
    reset_slab_counts()
    pp, ep_, _, pre_s = fm_epochs(fm, params0, x, z, pdata, e0.clone(),
                                  dataclasses.replace(hp, psi_dispatch="pregather"), 1)
    pre_launches = read_slab_counts()
    assert pre_launches["cd_slab_reduce"] == pre_launches["cd_resid_patch"] == 2 * nb \
        and pre_launches["cd_slab_reduce:one_tile"] == 2 * nb \
        and pre_launches["cd_slab_reduce_gather"] == 0, pre_launches
    d_pre = _hold_params(pp, pg, ep_, eg)
    del pp, ep_
    e_flat = fm.residuals(params0, x, z, data, hp)
    seg_ops.segment_sum_sorted.launches = 0
    t = time.perf_counter()
    pf, ef = fm.epoch(params0, x, z, data, e_flat, hp)
    torch.cuda.synchronize()
    flat_s = time.perf_counter() - t
    seg_launches = seg_ops.segment_sum_sorted.launches
    del e_flat
    # per side p0, k moments calls and u for the linear layers, and u for
    # the bias once: one sorted-sum call each, two launches
    assert seg_launches == 2 * (2 * (k + 1) + 3), seg_launches
    d_flat = _hold_params(pf, pg, ef, eg[pdata.c_rows, pdata.c_cols])
    del pf, ef
    # m = 9 against m = 8 from one start, in turns (m 8, m 9, m 9, m 8)
    hp7 = dataclasses.replace(hp, block_k=7)
    nb7 = -(-k // 7)
    reset_slab_counts()
    p7, _, f7, m8_s = fm_epochs(fm, params0, x, z, pdata, e0.clone(), hp7, 1)
    m8_launches = read_slab_counts()
    assert m8_launches["cd_slab_reduce_gather"] == \
        m8_launches["cd_slab_reduce_gather:one_tile"] == 2 * nb7 and \
        m8_launches["cd_resid_patch_gather"] == \
        m8_launches["cd_resid_patch_gather:reg_slots"] == 2 * nb7, m8_launches
    m9_s = [fm_epochs(fm, params0, x, z, pdata, e0.clone(), hp, 1)[3][0]
            for _ in range(2)]
    m8_s += fm_epochs(fm, params0, x, z, pdata, e0.clone(), hp7, 1)[3]
    d_m8 = _hold_params(f7[0], pg, f7[1], eg)
    del p7, f7
    log(f"phase 19 one epoch from one start: gather {epoch_s[0]:.3f}s; "
        f"pregather {pre_s[0]:.3f}s (slab reduce one-tile in all "
        f"{pre_launches['cd_slab_reduce:one_tile']} of its "
        f"{pre_launches['cd_slab_reduce']} launches, max |d param| {d_pre:.3g}); "
        f"flat fm.epoch {flat_s:.3f}s (max |d param| {d_flat:.3g}, {seg_launches} "
        f"sorted-sum launches); rtol "
        f"{TENSOR_RTOL} atol {TENSOR_ATOL} (e atol {TENSOR_E_ATOL})")
    log(f"phase 19 m = 9 against m = 8, one epoch from one start each, in "
        f"turns (m 8, m 9, m 9, m 8): block_k 7 (m 8: {nb7} blocks a side, "
        f"one-tile and register-slot in all "
        f"{m8_launches['cd_slab_reduce_gather']} launches) epoch s "
        f"{', '.join(f'{s:.3f}' for s in m8_s)}; block_k 8 (m 9: {nb} blocks "
        f"a side, one-tile and one-slot) epoch s {', '.join(f'{s:.3f}' for s in m9_s)}; "
        f"block_k 7 params against block_k 8's max |d| {d_m8:.3g}")
    prof = {}
    for name, h in (("m9", hp), ("m8", hp7)):
        prof[name] = epoch_breakdown(
            lambda: fm.epoch_padded(params0, x, z, pdata, e0.clone(), h), top=12)
        log(f"phase 19 epoch breakdown at {name[0]} = {name[1]} (torch.profiler, "
            f"one gather epoch and a copy of its start grid): {prof[name]}")
    return {"params": p, "hp": hp, "launches": launches,
            "pre_launches": pre_launches, "m9_s": m9_s, "m8_s": m8_s,
            "segment_sum_launches": seg_launches}


def time_gram_fm(dev, p, x, z, hp) -> dict:
    """Phase 20, row 1 at FM's shapes: the Gram of Φe (200,000 × 130) and
    Ψe (68,000 × 130) of the trained FM, 520-byte rows (the kernel's
    4-byte copies), beside the plain version, ``torch.mm(x.T, x)`` (TF32
    off) and the bound."""
    from repro_torch.core.models import fm
    from repro_torch.kernels.gram import ops as gops, ref as gref

    torch.backends.cuda.matmul.allow_tf32 = False
    g = {"ms": [], "plain": [], "lib": [], "bound": []}
    for what, t in (("phi_ext", fm.phi_ext(p, x, hp)), ("psi_ext", fm.psi_ext(p, z, hp))):
        xs = [t.clone() for _ in range(2)]
        rows, k = t.shape
        got, want = gops.gram(xs[0]), gref.gram_ref(xs[0])
        torch.testing.assert_close(got, want, rtol=GRAM_RTOL,
                                   atol=GRAM_ATOL_REL * float(want.abs().max()))
        g["ms"].append(device_ms(lambda j: gops.gram(xs[j % 2])))
        g["plain"].append(device_ms(lambda j: gref.gram_ref(xs[j % 2])))
        g["lib"].append(device_ms(lambda j: torch.mm(xs[j % 2].T, xs[j % 2])))
        g["bound"].append(bound(4 * rows * k + 4 * k * k, rows * k * (k + 1)))
        log(f"phase 20 gram {what} {rows}x{k}: kernel {g['ms'][-1]:.4f} ms, "
            f"plain {g['plain'][-1]:.4f} ms, torch.mm(x.T, x) "
            f"{g['lib'][-1]:.4f} ms, bound {g['bound'][-1][0]:.4f} ms "
            f"({g['bound'][-1][1]}); max |err| {float((got - want).abs().max()):.3g}")
        del xs
    return g


def serve_and_fold_in(dev, fm_out, x, z, data, mf_params) -> dict:
    """Phase 21: FM served from the Model API (``RetrievalEngine.from_model``
    over Ψe, 68,000 × 130): 16 users' top-100 in one top-K launch, equal
    bit for bit to the chain and held against a plain recompute; the
    kernel's time at D = 130. Then users and items folded in for MF and FM
    on the card against ``fold_in_exact`` in float64 on the CPU, and a
    cold-start ranking eval of 64 MF users through fold-in."""
    from repro_torch.core import foldin
    from repro_torch.core.models import fm, mf
    from repro_torch.core.models.api import Dataset, build_model
    from repro_torch.eval.ranking import foldin_ranking_eval
    from repro_torch.kernels.gram import ops as gops
    from repro_torch.kernels.topk_score import ops as tops, ref as tref
    from repro_torch.obs.costs import topk_score_cost
    from repro_torch.serve.engine import RetrievalEngine

    p, hp = fm_out["params"], fm_out["hp"]
    model = build_model("fm", hp=hp, dataset=Dataset(data=data, x=x, z=z))
    eng = RetrievalEngine.from_model(model, p, k=100)
    assert tuple(eng.psi.shape) == (FULL["n_items"], FULL["k"] + 2)
    users = torch.arange(16, device=dev) * (FULL["n_ctx"] // 16) + 5
    torch.cuda.synchronize()
    tops.topk_score.launches = tops.topk_score.launches_chain = 0
    res = eng.topk(users)
    torch.cuda.synchronize()
    launches = tops.topk_score.launches
    assert launches == 1 and tops.topk_score.launches_chain == 0, launches
    phi = model.build_phi(p, users)
    torch.testing.assert_close(phi, fm.phi_ext(p, x, hp)[users], rtol=1e-5, atol=1e-6)
    hold_chain(tops, (res.scores, res.ids), phi, eng.psi, 100)
    rs, ri = tref.topk_score_ref(phi, eng.psi, 101)
    torch.testing.assert_close(res.scores, rs[:, :100], rtol=RTOL, atol=ATOL)
    ids_agree(rs[:, :100], ri[:, :100], res.ids, rs[:, 100])
    s64 = phi.double() @ eng.psi.double().T
    i64 = torch.sort(-s64, dim=1, stable=True).indices[:, :100]
    exact = int((res.ids.long() == i64).all(1).sum())
    log(f"phase 21 FM engine: RetrievalEngine.from_model over Psi_e "
        f"{tuple(eng.psi.shape)}, 16 users' top-100 in {launches} one-launch "
        f"top-K call; equal bit for bit to the chain; scores within rtol "
        f"{RTOL} atol {ATOL} of the plain version; ids equal to a float64 "
        f"recompute in {exact}/16 rows outright, and to the plain version at "
        f"every slot outside a near-tie")
    t = {}
    t["ms"] = device_ms(lambda j: tops.topk_score(phi, eng.psi, 100))
    t["chain"] = device_ms(lambda j: tops.topk_score(phi, eng.psi, 100, form="chain"))
    t["plain"] = device_ms(lambda j: tref.topk_score_ref(phi, eng.psi, 100), n=10)
    t["lib"] = device_ms(lambda j: torch.topk(phi @ eng.psi.T, 100), n=20)
    cost = topk_score_cost(16, FULL["n_items"], FULL["k"] + 2, 100)
    t["bound"], t["bound_by"] = bound(cost["hbm_bytes"], cost["flops"])
    t["launches"] = launches
    log(f"phase 21 top-K at D = {FULL['k'] + 2} (B 16, {FULL['n_items']:,} rows, K 100): "
        f"one launch {t['ms']:.4f} ms, the chain {t['chain']:.4f} ms, plain "
        f"{t['plain']:.4f} ms, torch.topk(phi @ psi.T) {t['lib']:.4f} ms, "
        f"bound {t['bound']:.4f} ms ({t['bound_by']})")

    # fold-in on the card against the float64 oracle on the CPU
    log_ctx, log_item = data.ctx.cpu().numpy(), data.item.cpu().numpy()
    users_items = log_item[log_ctx == 7]
    items_users = log_ctx[log_item == 11][:40]
    mf_model = build_model("mf", hp=mf.MFHyperParams(
        k=FULL["k"], alpha0=FULL["alpha0"], l2=FULL["l2"]), dataset=Dataset())
    folds = {}
    for name, m, params in (("mf", mf_model, mf_params), ("fm", model, p)):
        for side, ids in (("user", users_items), ("item", items_users)):
            fold = m.fold_in_user if side == "user" else m.fold_in_item
            table = m.export_psi(params) if side == "user" else m.phi_table(params)
            free, init = (m._user_free_init() if side == "user"
                          else m._item_free_init())
            torch.cuda.synchronize()
            gops.gram.launches = 0
            walls = []
            for _ in range(3):
                t0 = time.perf_counter()
                row = fold(params, ids)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            assert gops.gram.launches == 3 and row.device.type == "cuda"
            res_d = foldin.fold_in_row(table, ids, free=free, init=init,
                                       **m._foldin_hp())
            torch.testing.assert_close(row, res_d.row, rtol=1e-6, atol=1e-7)
            # the same fold-in through the plain versions on the CPU
            host = foldin.fold_in_row(table.cpu(), ids, free=free, init=init,
                                      **m._foldin_hp())
            torch.testing.assert_close(row.cpu(), host.row, rtol=FOLD_RTOL,
                                       atol=FOLD_ATOL)
            # against the float64 oracle on the CPU: the Gram kernel's G,
            # which the row's normal matrix is built from, against TᵀT
            orc = fold_in_oracle(table, ids, free, init, m.hp)
            want = orc["want"]
            g = gops.gram(table.contiguous()).cpu().double()
            torch.testing.assert_close(g, orc["g"], rtol=GRAM_RTOL,
                                       atol=GRAM_ATOL_REL * float(orc["g"].abs().max()))
            # the oracle's row is a fixed point of the card's sweep: one
            # sweep started there stays within the reference's tolerance
            still = foldin.fold_in_row(table, ids, free=free,
                                       init=want.float().numpy(), n_sweeps=1,
                                       **m._foldin_hp()).row.cpu().double()
            torch.testing.assert_close(still, want, rtol=FOLD_RTOL, atol=FOLD_ATOL)
            # a row that converged to tol 1e-6 is the oracle's row within
            # the reference's tolerance; MF's M is well conditioned and
            # converges, FM's (a spec coordinate against a constant-1
            # column) is not and stops at the sweep cap, its distance shown
            d = row.cpu().double() - want
            gap = (float(d.abs().max()), float((orc["t"] @ d).abs().max()))
            converged = res_d.delta_max < 1e-6 * (1.0 + float(row.abs().max()))
            assert converged or name == "fm", (name, side, res_d)
            if converged:
                torch.testing.assert_close(row.cpu().double(), want,
                                           rtol=FOLD_RTOL, atol=FOLD_ATOL)
            folds[f"{name}_{side}"] = {
                "ms": walls[-1], "sweeps": res_d.n_sweeps, "cond": orc["cond"],
                "default": gap, "fixed_point": float((still - want).abs().max()),
                "gram": float((g - orc["g"]).abs().max())}
            log(f"phase 21 fold-in {name} {side} ({len(ids)} interactions, "
                f"table {tuple(table.shape)}): wall {walls[-1]:.3f} ms a call "
                f"(first {walls[0]:.3f} ms; 1 Gram launch a call), "
                f"{res_d.n_sweeps} sweeps to tol 1e-6 (delta {res_d.delta_max:.3g}; "
                f"the CPU's row within rtol {FOLD_RTOL} atol {FOLD_ATOL}); against "
                f"the float64 oracle on the CPU: the Gram kernel's G max |d| "
                f"{folds[f'{name}_{side}']['gram']:.3g} of max |TᵀT| "
                f"{float(orc['g'].abs().max()):.6g}; one card sweep from "
                f"fold_in_exact's row moves it max |d| "
                f"{folds[f'{name}_{side}']['fixed_point']:.3g} (held to rtol "
                f"{FOLD_RTOL} atol {FOLD_ATOL}); this row max |d row| {gap[0]:.3g}"
                f"{' (held, converged)' if converged else ' (not converged)'}, "
                f"max |d score| {gap[1]:.3g} of max |score| {orc['score_max']:.3g}; "
                f"cond(M) {orc['cond']:.3g}")
            if name == "fm":
                fixed = FULL["k"] + (1 if side == "user" else 0)
                assert float(row[fixed]) == 1.0
    # cold start: 64 MF users ranked from their folded-in φ rows
    pick = np.arange(64) * (FULL["n_ctx"] // 64) + 3
    starts = np.searchsorted(log_ctx, pick)
    ends = np.searchsorted(log_ctx, pick, side="right")
    hist = [log_item[a:b - 1] for a, b in zip(starts, ends)]
    held = log_item[ends - 1]
    tops.topk_score.launches = 0
    t0 = time.perf_counter()
    ev = foldin_ranking_eval(mf_model, mf_params, hist, held, k=100)
    torch.cuda.synchronize()
    assert tops.topk_score.launches >= 1
    log(f"phase 21 foldin_ranking_eval: 64 MF users folded in from their "
        f"history, held-out last item: recall@100 {ev['recall@100']:.4f}, "
        f"ndcg@100 {ev['ndcg@100']:.4f}, {tops.topk_score.launches} top-K "
        f"launch(es), {time.perf_counter() - t0:.3f}s")
    return {"topk": t, "folds": folds}


def serve_continual(ref, serve, dev) -> dict:
    """Phase 22: the serve driver with ``--continual`` at full icd-mf width
    (after phase 3's runs): a 64-request trace, then an unseen user folded
    in and queried through the mesh, a new item folded in, delta-published
    and self-queried; the rows against the same fold-in through the plain
    versions on the CPU, the answers against a plain recompute."""
    from repro_torch.core import foldin
    from repro_torch.kernels.gram import ops as gops
    from repro_torch.kernels.topk_score import ops as tops

    torch.cuda.synchronize()
    tops.topk_score.launches = gops.gram.launches = 0
    t0 = time.perf_counter()
    report = check_serve(ref, serve, SERVE_ARGV + ["--requests", "64", "--continual"], dev)
    wall = time.perf_counter() - t0
    launches = {"topk_score": tops.topk_score.launches, "gram": gops.gram.launches}
    assert launches["gram"] == 2 and launches["topk_score"] >= 3, launches
    c, w, h = report["continual"], report["params"].w, report["params"].h
    kw = dict(alpha0=FULL["alpha0"], l2=FULL["l2"])
    want_u = foldin.fold_in_row(h.cpu(), c["history"], **kw).row
    want_i = foldin.fold_in_row(w.cpu(), c["item_ctx"], **kw).row
    torch.testing.assert_close(c["phi"][0].cpu(), want_u, rtol=FOLD_RTOL, atol=FOLD_ATOL)
    torch.testing.assert_close(c["psi_row"].cpu(), want_i, rtol=FOLD_RTOL, atol=FOLD_ATOL)
    k = report["k"]
    rs, ri = ref.topk_score_ref(c["phi"], h, k + 1)
    ids_agree(rs[:, :k], ri[:, :k], c["user_result"].ids, rs[:, k])
    table = torch.cat([h, c["psi_row"][None, :]])
    rs, ri = ref.topk_score_ref(c["psi_row"][None, :], table, k + 1)
    ids_agree(rs[:, :k], ri[:, :k], c["item_result"].ids, rs[:, k])
    assert c["new_id"] == FULL["n_items"] and c["version"] == 2
    log(f"phase 22 serve --continual (icd-mf full width, 64 requests, replica "
        f"(0, 0) killed): fold-in user top id {int(c['user_result'].ids[0, 0])}, "
        f"item {c['new_id']} delta-published as v{c['version']}, self-query "
        f"top id {int(c['item_result'].ids[0, 0])}; both rows within rtol "
        f"{FOLD_RTOL} of the CPU's fold-in, both answers equal to a plain "
        f"recompute outside near-ties; launches {launches}; {wall * 1e3:.3f} ms")
    return {"launches": launches}


# ---------------------------------------------------------------------------
# Slice 6 and the training stack: the continual-learning loop at full icd-mf
# width (phase 23), the training stack at full width (phase 24), the CLIs
# and twins on the card (phase 25).
# ---------------------------------------------------------------------------
# the continual loop's replay: 4 batches (of the example's 64 events) and a
# cold-start eval of 256 users; the cluster's K
CL = dict(batches=4, n_eval=256, k=10)
# the replayed event whose item becomes the last cold id (see make_timed_log)
CL_COLD_AT = 100


def make_timed_log():
    """Phase 6's log in time order: each event a seeded uniform timestamp
    over 28 days (phase 10's), sorted by it. One swap of item ids makes
    the item of tail event ``CL_COLD_AT`` the last id, a cold one, so a
    cold item arrives within the replayed batches (the log's ≈ 40 tail
    events on 4 random items would need ≈ 17,000 replayed events);
    popularity stays a random permutation over the ids. Returns (n, 3)
    int64 events: user, item, t in seconds."""
    user, item = make_full_log()
    t = np.random.default_rng(CTX["ts_seed"]).uniform(
        0.0, CTX["days"] * 86400.0, len(user))
    order = np.argsort(t, kind="stable")
    events = np.stack([user[order], item[order], t[order].astype(np.int64)], 1)
    last = FULL["n_items"] - 1
    arriving = events[int(0.8 * len(events)) + CL_COLD_AT, 1]
    events[:, 1] = np.where(events[:, 1] == arriving, last,
                            np.where(events[:, 1] == last, arriving, events[:, 1]))
    return events


def continual_expected(events, n_items, n_cold, batches, batch_events, n_eval):
    """What the replay must do, from the log alone on the host: the user
    queries answered, the versions of the cold items' delta publishes, the
    final version, and the eval's users."""
    split = int(0.8 * len(events))
    n_warm = n_items - n_cold
    head = events[:split]
    hist = {int(i): 1 for i in head[head[:, 1] >= n_warm][:, 1]}
    live, version, deltas, users = n_warm, 1, [], 0
    for b in range(batches):
        lo = split + b * batch_events
        for i in events[lo:lo + batch_events, 1]:
            if i >= n_warm:
                hist[int(i)] = 1
                while hist.get(live):
                    live, version = live + 1, version + 1
                    deltas.append(version)
            else:
                users += 1
        version += 1            # the refresh's full republish
    order = np.argsort(events[:, 0], kind="stable")
    bounds = np.searchsorted(events[order, 0], np.arange(n_eval + 1))
    by_user = events[order, 1]
    n_eval_users = 0
    for u in range(n_eval):
        h = by_user[bounds[u]:bounds[u + 1]]
        if len(h) and h[-1] < n_warm and (h[:-1] < n_warm).any():
            n_eval_users += 1
    return {"users": users, "deltas": deltas, "version": version,
            "n_live": live, "n_eval": n_eval_users}


def busy_ms(fn):
    """(wall ms, device busy ms) of one call of ``fn`` from torch.profiler
    (busy 0 when the profiler sees no device time)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    busy = sum((getattr(ev, "self_device_time_total", 0) or 0) / 1e3
               for ev in prof.key_averages() if ev.device_type.name == "CUDA")
    return wall, busy


def continual_full_width(dev) -> dict:
    """Phase 23: the continual-learning twin's ``run`` at full icd-mf width
    (with the example's α₀ 0.3 and λ 0.05) on the timed log: warm MF
    through the Model API on the head (80% of
    the events, the last 4 item ids cold), live on a 2-shard cluster (K
    10) through a PsiPublisher, 4 tail batches of 64 events replayed
    through ``interaction_stream`` (a fold-in and a top-K a user, cold
    items delta-published), a rotating-block refresh a batch, a cold-start
    eval of 256 users; counts against the host's count of the log, 8
    queries held against the plain top-K and the CPU's fold-in."""
    from repro_torch.core import foldin
    from repro_torch.examples import continual_learning as cl
    from repro_torch.kernels.gram import ops as gops
    from repro_torch.kernels.topk_score import ops as tops, ref as tref
    from repro_torch.serve.publish import dense_table

    t0 = time.perf_counter()
    events = make_timed_log()
    want = continual_expected(events, FULL["n_items"], cl.N_COLD, CL["batches"],
                              cl.BATCH_EVENTS, CL["n_eval"])
    log(f"phase 23 log: {len(events)} events in time order, head "
        f"{int(0.8 * len(events))}, built in {time.perf_counter() - t0:.1f}s")
    lines = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    gops.gram.launches = tops.topk_score.launches = 0
    t0 = time.perf_counter()
    out = cl.run(events, FULL["n_ctx"], FULL["n_items"], FULL["k"],
                 tail_batches=CL["batches"], n_eval=CL["n_eval"], device=dev,
                 log=lines.append)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"gram": gops.gram.launches, "topk_score": tops.topk_score.launches}
    peak = torch.cuda.max_memory_allocated(dev)
    for ln in lines:
        log(f"phase 23 continual: {ln}")
    assert out["folded_users"] == want["users"] and out["versions"] == want["deltas"] \
        and out["version"] == want["version"] and out["n_items_live"] == want["n_live"] \
        and out["n_eval"] == want["n_eval"], (out, want)
    assert out["folded_items"] == cl.N_COLD, out["folded_items"]
    want_launches = {
        "gram": out["folded_users"] + out["folded_items"] + out["n_eval"],
        "topk_score": 2 * out["folded_users"] + -(-out["n_eval"] // 256)}
    assert launches == want_launches, (launches, want_launches)

    # 8 queries: ids against the plain top-K over the table they ran on,
    # rows against the same fold-in on the CPU
    model = out["model"]
    k = CL["k"]
    row_err = 0.0
    for q in out["held"]:
        table = dense_table(q["table"])
        rs, ri = tref.topk_score_ref(q["phi"].float()[None], table, k + 1)
        ids_agree(rs[:, :k], ri[:, :k], q["result"].ids, rs[:, k])
        cpu = foldin.fold_in_row(model.export_psi(q["params"]).cpu(), q["history"],
                                 **model._foldin_hp()).row
        torch.testing.assert_close(q["phi"].cpu(), cpu, rtol=FOLD_RTOL, atol=FOLD_ATOL)
        row_err = max(row_err, float((q["phi"].cpu() - cpu).abs().max()))

    # device time a query: 16 more of the same queries, profiled
    params, cluster = out["params"], out["cluster"]
    hists = [q["history"] for q in out["held"]] * 2

    def queries():
        for h in hists:
            cluster.topk_phi(model.fold_in_user(params, h).float()[None])

    queries()
    q_wall, q_busy = busy_ms(queries)
    qs = np.asarray(out["query_s"]) * 1e3
    log(f"phase 23 continual at icd-mf width ({FULL['n_ctx']:,} x "
        f"{FULL['n_items']:,}, k {FULL['k']}): warm {cl.WARM_EPOCHS} mf.fit "
        f"epochs in {out['warm_s']:.3f}s on {out['warm_events']} events; "
        f"{out['folded_users']} fold-in queries answered, {out['folded_items']} "
        f"cold items delta-published (versions {out['versions']}), final "
        f"v{out['version']} with {out['n_items_live']} items (all as the log "
        f"implies); launches {launches} (Gram: a fold-in each; top-K: 2 shards "
        f"a query, 1 a 256-user eval batch); query wall ms median "
        f"{np.median(qs):.3f} mean {qs.mean():.3f} p99 "
        f"{np.percentile(qs, 99):.3f}; 16 profiled queries wall "
        f"{q_wall / 16:.3f} ms, device {q_busy / 16:.4f} ms a query; fold-in "
        f"eval recall@10 {out['recall']:.4f} (popularity {out['recall_pop']:.4f}) "
        f"over {out['n_eval']} users; 8 queries' ids equal the plain top-K "
        f"outside near-ties, rows within rtol {FOLD_RTOL} of the CPU's fold-in "
        f"(max |d| {row_err:.3g}); peak memory {peak / 2**30:.2f} GiB; "
        f"{wall:.1f}s")
    return {"launches": launches, "query_ms": float(np.median(qs)),
            "device_ms": q_busy / 16, "peak": peak}


def training_stack_full_width(dev) -> dict:
    """Phase 24 on phase 6's Interactions: ``launch.train``'s loop for 3
    epochs; the same epochs as Trainer steps with a Checkpointer, stopped
    after epoch 1 and resumed by a new trainer, bit for bit an
    uninterrupted run (deterministic algorithms on: the flat epoch's
    segment sums otherwise add in a varying order); two iALS epochs; 100
    BPR steps against the same steps on the CPU."""
    import tempfile

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.core import bpr, ials
    from repro_torch.core.models import mf
    from repro_torch.launch import train
    from repro_torch.sparse.interactions import build_interactions
    from repro_torch.train.train_step import TrainState
    from repro_torch.train.trainer import Trainer

    ctx, item = make_full_log()
    a0 = FULL["alpha0"]
    data = build_interactions(ctx, item, np.ones(len(ctx)),
                              np.full(len(ctx), a0 + 4.0), FULL["n_ctx"],
                              FULL["n_items"], alpha0=a0, device=dev)
    hp = mf.MFHyperParams(k=FULL["k"], alpha0=a0, l2=FULL["l2"])
    gen = torch.Generator(device=dev).manual_seed(5)
    params0 = mf.init(FULL["n_ctx"], FULL["n_items"], FULL["k"], generator=gen)
    obj0 = float(mf.objective(params0, data, hp))

    # launch.train's loop
    torch.cuda.synchronize()
    t = time.perf_counter()
    _, objs = train.train_loop(params0, data, hp, 3, log_every=1, log=lambda s: None)
    loop_s = time.perf_counter() - t
    seq = [obj0] + [o for _, o in objs]
    assert all(b < a for a, b in zip(seq, seq[1:])), seq
    log(f"phase 24 launch.train loop: 3 epochs (mf.fit, the objective each "
        f"epoch) on {data.nnz} interactions: objective "
        f"{' -> '.join(f'{o:.6g}' for o in seq)}; {loop_s / 3:.3f}s an epoch "
        f"with its objective")

    # Trainer + Checkpointer: stop after epoch 1, resume, finish
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    step = train.epoch_step(data, hp)

    def trainer(ck):
        state = TrainState(params0, None, torch.zeros((), dtype=torch.int32))
        return Trainer(step, state, iter(lambda: {}, None), checkpointer=ck,
                       ckpt_every=1, log_every=1000, log_fn=lambda s: None)

    t_tr = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            straight = trainer(None).run(3)
            ck = Checkpointer(os.path.join(tmp, "ck"), keep=2)
            trainer(ck).run(1)
            ckpt_bytes = sum(os.path.getsize(os.path.join(dp, f))
                             for dp, _, fs in os.walk(os.path.join(tmp, "ck")) for f in fs)
            t = time.perf_counter()
            ck.restore_latest(trainer(None).state)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t
            tr = trainer(ck)
            resumed = tr.run(3)
            t = time.perf_counter()
            Checkpointer(os.path.join(tmp, "save")).save(3, resumed, blocking=True)
            save_s = time.perf_counter() - t
    finally:
        torch.use_deterministic_algorithms(False)
    assert int(resumed.step) == 3 and len(tr.metrics_history) == 2
    for a, b in zip(resumed.params, straight.params):
        assert torch.equal(a, b), "the resumed run differs from the uninterrupted one"
    log(f"phase 24 Trainer + Checkpointer: stopped after epoch 1, resumed by a "
        f"new trainer, 3 epochs bit for bit the uninterrupted run's params; "
        f"checkpoint {ckpt_bytes / 1e6:.3f} MB, save {save_s:.3f}s, restore "
        f"{restore_s:.3f}s; 7 deterministic epochs and the checkpoints in "
        f"{time.perf_counter() - t_tr:.1f}s")

    # two iALS epochs
    ihp = ials.IALSHyperParams(k=FULL["k"], alpha0=a0, l2=FULL["l2"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base_mem = torch.cuda.memory_allocated(dev)
    p, ials_s, iobjs = params0, [], [obj0]
    for _ in range(2):
        t = time.perf_counter()
        p = ials.epoch(p, data, ihp)
        torch.cuda.synchronize()
        ials_s.append(time.perf_counter() - t)
        iobjs.append(float(mf.objective(p, data, hp)))
    peak = torch.cuda.max_memory_allocated(dev)
    total = torch.cuda.get_device_properties(dev).total_memory
    outer = data.nnz * FULL["k"] ** 2 * 4
    assert all(b < a for a, b in zip(iobjs, iobjs[1:])), iobjs
    assert peak < total and peak - base_mem < outer, (peak, total, outer)
    log(f"phase 24 iALS: 2 epochs, objective "
        f"{' -> '.join(f'{o:.6g}' for o in iobjs)}; {', '.join(f'{s:.3f}' for s in ials_s)}s "
        f"an epoch; peak memory {peak / 2**30:.2f} GiB ({(peak - base_mem) / 2**30:.2f} "
        f"GiB above the phase's start) of the card's {total / 2**30:.1f} GiB, "
        f"against {outer / 1e9:.1f} GB for the (nnz, k, k) outer products")

    # 100 BPR steps on the card and on the CPU
    pairs = np.stack([ctx, item], 1)
    bhp = bpr.BPRHyperParams(k=FULL["k"])
    pb = bpr.init(FULL["n_ctx"], FULL["n_items"], FULL["k"],
                  generator=torch.Generator(device=dev).manual_seed(6))
    torch.cuda.synchronize()
    t = time.perf_counter()
    got = bpr.fit(pb, pairs, FULL["n_items"], bhp, n_steps=100, seed=0)
    torch.cuda.synchronize()
    bpr_s = time.perf_counter() - t
    t = time.perf_counter()
    cpu = bpr.fit(mf.MFParams(pb.w.cpu(), pb.h.cpu()), pairs, FULL["n_items"], bhp,
                  n_steps=100, seed=0)
    bpr_cpu_s = time.perf_counter() - t
    errs = []
    for a, b in zip(got, cpu):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-6)
        errs.append(float((a.cpu() - b).abs().max()))
    log(f"phase 24 BPR: 100 steps of batch {bhp.batch} at full width in "
        f"{bpr_s:.3f}s on the card ({bpr_cpu_s:.1f}s on the CPU), equal to "
        f"the same steps on the CPU within "
        f"rtol 1e-5 / atol 1e-6 (max |d| {max(errs):.3g})")
    return {"ials_s": ials_s, "ials_peak": peak, "save_s": save_s,
            "restore_s": restore_s, "ckpt_bytes": ckpt_bytes}


def run_clis_and_twins(dev) -> None:
    """Phase 25: ``python -m repro_torch.launch.train --arch icd-mf --smoke
    --steps 10`` as a subprocess on the card, the continual-learning twin
    at its own sizes and the observability twin into a temporary
    directory, whose three files must parse."""
    import tempfile

    from repro_torch.examples import continual_learning as cl
    from repro_torch.examples import observability as obs

    t = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    p = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                        "--arch", "icd-mf", "--smoke", "--steps", "10"],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 0, p.stdout[-1500:] + p.stderr[-1500:]
    lines = p.stdout.splitlines()
    assert lines[0] == "[train] arch=icd-mf smoke=True" and len(lines) == 3 \
        and lines[1].startswith("[icd] epoch 5 objective"), lines
    objs = [float(x.split()[-1]) for x in lines[1:]]
    assert objs[1] < objs[0], objs
    log(f"phase 25 launch.train CLI on the card: {' | '.join(lines)}; "
        f"{time.perf_counter() - t:.1f}s")

    t = time.perf_counter()
    lines = []
    out = cl.run(*_example_log(cl), device=dev, log=lines.append)
    assert (out["folded_users"], out["folded_items"], out["versions"],
            out["version"]) == (1005, 4, [4, 5, 6, 9], 21), out
    for ln in lines:
        log(f"phase 25 continual_learning twin: {ln}")
    log(f"phase 25 continual_learning twin on the card: the reference "
        f"example's counts; recall@10 {out['recall']:.4f} vs popularity "
        f"{out['recall_pop']:.4f} (3 of its 300 users apart on the CPU; "
        f"the warm epochs' segment sums add in a varying order on the "
        f"card); {time.perf_counter() - t:.1f}s")

    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        lines = []
        out = obs.run(out_dir=tmp, device=dev, log=lines.append)
        rows = [json.loads(x) for x in open(os.path.join(tmp, "metrics.jsonl"))]
        prom = open(os.path.join(tmp, "metrics.prom")).read()
        trace = json.load(open(os.path.join(tmp, "trace.json")))
    assert len(rows) == out["n_series"] and "serve_mesh_failovers_total" in prom
    assert len(trace["traceEvents"]) == out["n_trace_events"] > 0
    assert out["versions"] == [1, 2, 3, 4] and out["losses"][-1] < out["losses"][0]
    for ln in lines:
        log(f"phase 25 observability twin: {ln.replace(tmp, '<tmp>')}")
    log(f"phase 25 observability twin on the card: {len(rows)} JSONL series, "
        f"{prom.count(chr(10))} Prometheus lines and {len(trace['traceEvents'])} "
        f"trace events parsed; {time.perf_counter() - t:.1f}s")


def _example_log(cl):
    from repro_torch.data.synthetic import make_implicit_dataset

    ds = make_implicit_dataset(n_users=cl.N_USERS, n_items=cl.N_ITEMS,
                               attr_strength=0.8, seed=0)
    return ds.events, cl.N_USERS, cl.N_ITEMS, cl.K


# ---------------------------------------------------------------------------
# Slice 7: the distribution layer on torch.distributed, in an NCCL world of
# one at full icd-mf width (phase 26).
# ---------------------------------------------------------------------------
# the reference's mf_dist tolerance (tests/test_mf_dist.py): fp32 wires
# against the flat epoch; the bf16 wire's objective within 1%
DIST_RTOL, DIST_ATOL, DIST_BF16_REL = 5e-4, 5e-5, 0.01
# collectives a rank makes in one epoch at k = 128: the two Grams'
# all-reduces, a column a dimension and side, and the two residual routes
DIST_CALLS = {"gather": {"all_reduce": 2, "all_gather": 256, "all_to_all": 2},
              "route": {"all_reduce": 2, "all_gather": 0, "all_to_all": 258}}


def distribution_full_width(dev) -> dict:
    """Phase 26: the distribution layer in an NCCL world of one (an
    in-memory store, no port) at full icd-mf width on phase 6's log:
    ``shard_interactions`` (its host seconds), ``sharded_gram`` through
    the Gram kernel bit for bit the single-device kernel, two ``mf_dist``
    epochs for each of gather/fp32, route/fp32 and route/bf16 from the
    start of two flat ``mf.epoch``s (fp32 within rtol 5e-4 / atol 5e-5,
    bf16's objective within 1%, every objective falling), their wall
    times, collectives and Gram launches an epoch; ``shard_map_topk`` over
    a 1-shard table of the trained ψ (B 16, K 100, 20 excluded ids a row)
    bit for bit ``cluster_topk``, both timed; ``compressed_psum`` on a
    128 × 128 gradient; and a ``Checkpointer`` round trip of the factors
    as DTensors, restored with ``shardings=`` bit for bit. The world is
    torn down at the end."""
    import tempfile

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, distribute_tensor

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.core.gram import gram, sharded_gram
    from repro_torch.core.models import mf, mf_dist
    from repro_torch.kernels.gram import ops as gops
    from repro_torch.kernels.topk_score import ops as tops
    from repro_torch.launch.sharding import P, named
    from repro_torch.optim.compression import compressed_psum
    from repro_torch.runtime import collectives
    from repro_torch.serve.cluster import cluster_topk, shard_map_topk, shard_psi
    from repro_torch.serve.engine import exclude_ids_from_lists
    from repro_torch.sparse.interactions import build_interactions

    n_ctx, n_items, k = FULL["n_ctx"], FULL["n_items"], FULL["k"]
    ctx, item = make_full_log()
    a0 = FULL["alpha0"]
    data = build_interactions(ctx, item, np.ones(len(ctx)),
                              np.full(len(ctx), a0 + 4.0), n_ctx, n_items,
                              alpha0=a0, device=dev)
    hp = mf.MFHyperParams(k=k, alpha0=a0, l2=FULL["l2"], implementation="pallas")
    gen = torch.Generator(device=dev).manual_seed(7)
    params0 = mf.init(n_ctx, n_items, k, generator=gen)
    obj0 = float(mf.objective(params0, data, hp))

    def sync_s(t):
        torch.cuda.synchronize()
        return time.perf_counter() - t

    def wall_ms(fn, n=50):
        """Median wall ms of one call of ``fn`` with its sync."""
        fn()
        times = []
        for _ in range(n):
            t = time.perf_counter()
            fn()
            times.append(sync_s(t) * 1e3)
        return float(np.median(times))

    # two flat epochs from the start the distributed ones take
    flat, e_flat, flat_s = params0, mf.residuals(params0, data), []
    for _ in range(2):
        t = time.perf_counter()
        flat, e_flat = mf.epoch(flat, data, e_flat, hp)
        flat_s.append(sync_s(t))
    obj_flat = float(mf.objective(flat, data, hp))

    out = {}
    with collectives.world_of_one("nccl"):
        mesh = mf_dist.make_shard_mesh(1)
        t = time.perf_counter()
        host = mf_dist.shard_interactions(data, 1)
        shard_s = time.perf_counter() - t
        log(f"phase 26 world of one over NCCL (HashStore), mesh {mesh}; "
            f"shard_interactions of {data.nnz} interactions on the host in "
            f"{shard_s:.3f}s: blocks p_c {host.ctx_l.shape[1]}, p_i "
            f"{host.item_l.shape[1]}, routing blk {host.send_idx.shape[2]}")

        j_dist = sharded_gram(params0.h, mesh, implementation="pallas")
        j_one = gram(params0.h, implementation="pallas")
        assert torch.equal(j_dist, j_one), "sharded_gram must equal the kernel"

        pb = mf_dist.shard_params(params0, host)
        e0 = mf_dist.residuals_blocked(pb, host)[0]
        loc = host.local(0, dev)
        gops.gram.launches = 0
        epochs, out["gram_launches"] = {}, 0
        for variant, wire in (("gather", torch.float32), ("route", torch.float32),
                              ("route", torch.bfloat16)):
            epoch = mf_dist.build_epoch(mesh, hp, host, variant=variant,
                                        wire_dtype=wire)
            w, h, e = pb.w[0], pb.h[0], e0
            objs, secs, calls, grams = [obj0], [], [], []
            for _ in range(2):
                collectives.reset_counts()
                before = gops.gram.launches
                t = time.perf_counter()
                w, h, e = epoch(w, h, loc, e)
                secs.append(sync_s(t))
                calls.append(collectives.read_counts())
                grams.append(gops.gram.launches - before)
                got = mf_dist.unshard_params(mf.MFParams(w[None], h[None]),
                                             n_ctx, n_items)
                objs.append(float(mf.objective(got, data, hp)))
            name = f"{variant}/{str(wire).removeprefix('torch.')}"
            assert all(b < a for a, b in zip(objs, objs[1:])), (name, objs)
            assert calls == [DIST_CALLS[variant]] * 2 and grams == [2, 2], (
                name, calls, grams)
            if wire == torch.float32:
                for a, b in ((got.w, flat.w), (got.h, flat.h)):
                    torch.testing.assert_close(a, b, rtol=DIST_RTOL, atol=DIST_ATOL)
                err = max(float((got.w - flat.w).abs().max()),
                          float((got.h - flat.h).abs().max()))
                held = f"max |d| {err:.3g} from the flat epochs"
            else:
                rel = abs(objs[-1] - obj_flat) / obj_flat
                assert rel < DIST_BF16_REL, (name, objs[-1], obj_flat)
                err = max(float((got.w - flat.w).abs().max()),
                          float((got.h - flat.h).abs().max()))
                held = (f"objective {rel:.3g} from the flat epochs' (relative), "
                        f"max |d| {err:.3g}")
            epochs[name] = {"s": secs, "calls": calls[0]}
            out["gram_launches"] += sum(grams)
            log(f"phase 26 mf_dist {name}: objective "
                f"{' -> '.join(f'{o:.6g}' for o in objs)}; epoch s "
                f"{', '.join(f'{x:.3f}' for x in secs)}; collectives an epoch "
                f"{calls[0]}; Gram launches an epoch {grams}; {held}")
            if wire == torch.float32 and variant == "gather":
                log(f"phase 26 mf_dist {name} epoch breakdown (torch.profiler): "
                    f"{epoch_breakdown(lambda: epoch(pb.w[0], pb.h[0], loc, e0))}")
        # one collective's cost: with its sync, and back to back (the host
        # time a call takes when calls queue, as in an epoch), through the
        # wrapper on the group an epoch resolves once, and as the bare
        # torch.distributed call into a kept and into a new output
        col = flat.h[:, 0].contiguous()
        group, col_out = collectives.group_of(mesh), torch.empty_like(col)
        column, residuals = f"a {n_items}-row column", f"{e0.numel()} residuals"
        calls = (
            ("all_gather", column, lambda: collectives.all_gather(col, group)),
            ("bare all_gather_into_tensor", column,
             lambda: dist.all_gather_into_tensor(col_out, col, group=group.pg)),
            ("bare all_gather_into_tensor into a new tensor", column,
             lambda: dist.all_gather_into_tensor(torch.empty_like(col), col,
                                                 group=group.pg)),
            ("all_to_all", residuals, lambda: collectives.all_to_all(e0, group)))
        for name, what, fn in calls:
            t = time.perf_counter()
            for _ in range(200):
                fn()
            queued = sync_s(t) / 200 * 1e3
            log(f"phase 26 one collective in the world of one: {name} of "
                f"{what} {wall_ms(fn):.4f} ms a call with its sync (median "
                f"of 50), {queued:.4f} ms a call back to back (200 calls)")
        log(f"phase 26 flat mf.epoch (Gram kernel) from the same start: epoch "
            f"s {', '.join(f'{x:.3f}' for x in flat_s)}, objective "
            f"{obj0:.6g} -> {obj_flat:.6g}; sharded_gram (pallas) equal bit for "
            f"bit to the single-device kernel")

        # one-program sharded top-K over the trained ψ
        table = shard_psi(flat.h, 1)
        rng = np.random.default_rng(26)
        users = rng.choice(n_ctx, 16, replace=False)
        phi = mf.build_phi(flat, torch.as_tensor(users, device=dev))
        eids = exclude_ids_from_lists([rng.choice(n_items, 20, replace=False)
                                       for _ in users], device=dev)
        tops.topk_score.launches = 0
        got_t = shard_map_topk(mesh, table, phi, 100, exclude_ids=eids)
        out["topk_launches"] = tops.topk_score.launches
        want_t = cluster_topk(table, phi, 100, exclude_ids=eids)
        assert out["topk_launches"] == 1, out
        assert torch.equal(got_t.ids, want_t.ids) and torch.equal(
            got_t.scores, want_t.scores), "shard_map_topk must equal cluster_topk"

        smt_ms = wall_ms(lambda: shard_map_topk(mesh, table, phi, 100,
                                                exclude_ids=eids))
        ct_ms = wall_ms(lambda: cluster_topk(table, phi, 100, exclude_ids=eids))
        log(f"phase 26 shard_map_topk (1 shard of {n_items} x {k}, B 16, K 100, "
            f"20 excluded ids a row): bit for bit cluster_topk, "
            f"{out['topk_launches']} top-K launch; wall {smt_ms:.4f} ms a call "
            f"(median of 50) against cluster_topk {ct_ms:.4f} ms")

        g = torch.randn((128, 128), generator=gen, device=dev)
        mean, err = compressed_psum(g, torch.zeros_like(g), mesh)
        torch.testing.assert_close(mean, g, rtol=0, atol=0.05)
        log(f"phase 26 compressed_psum (128 x 128, int8 error feedback): max "
            f"|mean - g| {float((mean - g).abs().max()):.4g} (atol 0.05), "
            f"carried error max {float(err.abs().max()):.4g}")

        # the barrier a sharded save ends with waits on the host, and so
        # for a kernel queued before it
        collectives.mesh_barrier(mesh)
        torch.cuda.synchronize()
        torch.cuda._sleep(400_000_000)
        t = time.perf_counter()
        collectives.mesh_barrier(mesh)
        barrier_s = time.perf_counter() - t
        assert torch.cuda.current_stream().query(), (
            "mesh_barrier returned before the card's queued work ended")
        log(f"phase 26 mesh_barrier behind a queued _sleep of 4e8 cycles: "
            f"returned after {barrier_s:.4f}s with the stream empty")

        specs = mf.MFParams(w=P("shards", None), h=P("shards", None))
        shardings = named(mesh, specs)
        state = mf.MFParams(*(distribute_tensor(x, s.mesh, s.placements)
                              for x, s in zip(flat, shardings)))
        with tempfile.TemporaryDirectory() as tmp:
            ck = Checkpointer(tmp)
            t = time.perf_counter()
            ck.save(1, state)
            save_s = sync_s(t)
            t = time.perf_counter()
            back = ck.restore(1, flat, shardings=shardings)
            restore_s = sync_s(t)
        assert all(isinstance(x, DTensor) and x.device.type == dev.type for x in back)
        assert torch.equal(back.w.full_tensor(), flat.w) and torch.equal(
            back.h.full_tensor(), flat.h), "the resharded restore must be exact"
        log(f"phase 26 Checkpointer of the factors as DTensors on the mesh: "
            f"saved in {save_s:.3f}s, restored with shardings= in "
            f"{restore_s:.3f}s, bit for bit")
    assert not dist.is_initialized()
    out["epochs"] = epochs
    return out


def dist_only() -> None:
    """Phase 26 alone, after building the Gram and top-K kernels."""
    from repro_torch.kernels import build
    from repro_torch.kernels.gram import kernel as gram_kernel
    from repro_torch.kernels.topk_score import kernel

    build.build_all([kernel.LIB, gram_kernel.LIB])
    distribution_full_width(torch.device("cuda", 0))


# ---------------------------------------------------------------------------
# Slice 8: the launch tooling's cells on the card (phase 27).
# ---------------------------------------------------------------------------
# the train cell's log (make_cell_log): make_full_log's shape at degrees
# scaled ≈ 5.9×, so that nnz ≈ epoch_youtube's 20,000,000 (mean 99.5)
CELL_DEGREES = (30, 170)
# ids of the retrieval cell held exactly against the plain version
CELL_HOLD_ROWS = 64


def make_cell_log(dev, seed: int = 27):
    """The train cell's log, in ``make_full_log``'s shape at degrees
    uniform in CELL_DEGREES (≈ 19.9 M pairs): items ∝ rank^-0.3 over a
    seeded permutation, drawn by inverse CDF, duplicate pairs dropped. It
    is drawn on the card from a seeded torch generator (the host takes ≈
    40 s for numpy's draw at this size) and returned as sorted host
    (ctx, item) pairs."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    n_ctx, n_items = FULL["n_ctx"], FULL["n_items"]
    deg = torch.randint(*CELL_DEGREES, (n_ctx,), generator=gen, device=dev)
    pop = torch.arange(1, n_items + 1, dtype=torch.float64, device=dev) ** -0.3
    pop = pop[torch.randperm(n_items, generator=gen, device=dev)]
    cdf = torch.cumsum(pop / pop.sum(), 0)
    u = torch.rand(int(deg.sum()), generator=gen, device=dev, dtype=torch.float64)
    items = torch.searchsorted(cdf, u, right=True).clamp_(max=n_items - 1)
    users = torch.repeat_interleave(torch.arange(n_ctx, device=dev), deg)
    pairs = torch.unique(users * n_items + items).cpu().numpy()
    return pairs // n_items, pairs % n_items


def _roofline_line(roof) -> str:
    return (f"compute {roof.compute_s * 1e3:.4f} ms, memory {roof.memory_s * 1e3:.4f} ms, "
            f"collective {roof.collective_s * 1e3:.4f} ms (bound {roof.bound_s * 1e3:.4f} "
            f"ms, {roof.dominant}; {roof.flops:.4g} FLOP, {roof.bytes_accessed:.4g} B "
            f"unfused, {roof.coll_bytes:.4g} B on the wire)")


def cells_full_width(dev) -> dict:
    """Phase 27: the dry run's cells (``launch/cells.py``) run for real on
    the card, in an NCCL world of one on a 1 × 1 ("data", "model") mesh,
    at their global shapes. The retrieval cell (``shard_map_topk`` of B
    4,096 × 1,000,000 × 128, K 100) on row 10's one-launch form, its ids
    held exactly against the plain version on a 64-row slice (small-integer
    factors: exact scores, ties ranked by id); the ``epoch_youtube`` train
    cell (one ``mf_dist`` gather epoch at 200,000 × 68,000 × 128 on a
    seeded log of ≈ 20 M interactions, the Gram through row 1) from the
    start of a flat ``mf.epoch``, within phase 26's tolerance, the
    objective falling. Beside each cell's times, its roofline terms from
    the dry run's trace of the same step at the same shapes in a fake
    world of one (meta tensors). ``epoch_web`` (500 M interactions) is
    dry-run only. Returns the kernels' launches on the cells' steps.
    The train cell's log is drawn on the card (``make_cell_log``)."""
    import torch.distributed as dist

    from repro_torch.configs import get_shapes
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.core.models import mf, mf_dist
    from repro_torch.kernels.gram import ops as gops
    from repro_torch.kernels.topk_score import ops as tops
    from repro_torch.kernels.topk_score import ref as tref
    from repro_torch.launch import cells as lc
    from repro_torch.launch import hlo_analysis
    from repro_torch.launch.mesh import make_mesh_of_one
    from repro_torch.runtime import collectives
    from repro_torch.sparse.interactions import build_interactions

    torch.cuda.synchronize()
    held_gib = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    peaks = {}

    def peak_since(name):
        """The peak allocated since the last call, under ``name``."""
        torch.cuda.synchronize()
        peaks[name] = round(torch.cuda.max_memory_allocated() / 2**30, 2)
        torch.cuda.reset_peak_memory_stats()

    n_ctx, n_items, k = FULL["n_ctx"], FULL["n_items"], FULL["k"]
    log("phase 27 epoch_web (10,000,000 x 1,000,000, 500 M interactions) is "
        "dry-run only: not run on the card")

    t = time.perf_counter()
    ctx, item = make_cell_log(dev)
    log_s = time.perf_counter() - t
    nnz = len(ctx)
    spec = get_shapes("icd-mf")["epoch_youtube"]
    assert abs(nnz - spec.extra("nnz")) < 0.01 * spec.extra("nnz"), nnz
    train_shape = ShapeSpec("epoch_youtube", "train", extras=(
        ("n_ctx", n_ctx), ("n_items", n_items), ("nnz", nnz)))

    # the dry run's terms for the steps run below, at their shapes, one rank
    roofs = {}
    with collectives.fake_world(1):
        mesh = make_mesh_of_one("cpu")
        for name, override in (("retrieval", None), ("epoch_youtube", train_shape)):
            cell = lc.build_cell("icd-mf", name, mesh, shape_override=override)
            tr = hlo_analysis.trace_step(cell.step_fn, cell.abstract_args)
            roofs[name] = (tr.roofline, tr.trace_s)
    assert not dist.is_initialized()
    peak_since("log")

    def sync_s(t0):
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    out = {}
    with collectives.world_of_one("nccl"):
        mesh = make_mesh_of_one("cuda")

        # the retrieval cell at its global shape
        cell = lc.build_cell("icd-mf", "retrieval", mesh)
        shapes = [tuple(a.shape) for a in cell.abstract_args]
        assert shapes == [(4_096, k), (1_000_000, k)], shapes
        gen = torch.Generator(device=dev).manual_seed(27)
        phi, psi = (torch.randint(-8, 9, shp, generator=gen, device=dev).float()
                    for shp in shapes)
        tops.topk_score.launches = 0
        scores, ids = cell.step_fn(phi, psi)
        torch.cuda.synchronize()
        out["topk_launches"] = tops.topk_score.launches
        assert out["topk_launches"] == 1, out
        assert ids.shape == (4_096, lc.RETRIEVAL_K) and bool(torch.isfinite(scores).all())
        rs, ri = tref.topk_score_ref(phi[:CELL_HOLD_ROWS], psi, lc.RETRIEVAL_K)
        assert torch.equal(ids[:CELL_HOLD_ROWS], ri) and torch.equal(
            scores[:CELL_HOLD_ROWS], rs), "the retrieval cell's ids must equal ref.py's"
        step_ms = []
        for _ in range(3):
            t = time.perf_counter()
            cell.step_fn(phi, psi)
            step_ms.append(sync_s(t) * 1e3)
        kernel_ms = device_ms(lambda j: tops.topk_score(phi, psi, lc.RETRIEVAL_K), n=5)
        # a yardstick the port never calls: the (4,096, 1 M) scores, 16 GB
        library_ms = device_ms(lambda j: torch.topk(phi @ psi.T, lc.RETRIEVAL_K), n=3)
        roof, trace_s = roofs["retrieval"]
        log(f"phase 27 retrieval cell (shard_map_topk, B 4096 x 1,000,000 x {k}, "
            f"K {lc.RETRIEVAL_K}, one shard): {out['topk_launches']} top-K launch, "
            f"ids of {CELL_HOLD_ROWS} rows equal ref.py's; step wall "
            f"{', '.join(f'{x:.3f}' for x in step_ms)} ms; the kernel alone "
            f"{kernel_ms:.3f} ms (CUDA events, median of 5), torch.topk(phi @ "
            f"psi.T) {library_ms:.3f} ms (median of 3); dry-run roofline "
            f"(fake world of one, traced in {trace_s:.2f}s): {_roofline_line(roof)}")
        del phi, psi, scores, ids, rs, ri
        peak_since("retrieval")

        # the epoch_youtube train cell at its global shape
        a0 = FULL["alpha0"]
        data = build_interactions(ctx, item, np.ones(nnz), np.full(nnz, a0 + 4.0),
                                  n_ctx, n_items, alpha0=a0, device=dev)
        hp = mf.MFHyperParams(k=k, alpha0=a0, l2=FULL["l2"], implementation="pallas")
        params0 = mf.init(n_ctx, n_items, k, generator=gen)
        obj0 = float(mf.objective(params0, data, hp))
        t = time.perf_counter()
        host = mf_dist.shard_interactions(data, 1)
        shard_s = time.perf_counter() - t
        cell = lc.build_cell("icd-mf", "epoch_youtube", mesh, shape_override=train_shape)
        pb = mf_dist.shard_params(params0, host)
        e0 = mf_dist.residuals_blocked(pb, host)[0]
        loc = host.local(0, dev)
        peak_since("train set-up")
        epoch_s = []
        for rep in range(2):   # the same epoch twice from one start
            gops.gram.launches = 0
            collectives.reset_counts()
            t = time.perf_counter()
            w, h, e = cell.step_fn(pb.w[0], pb.h[0], loc, e0)
            epoch_s.append(sync_s(t))
            calls = collectives.read_counts()
            assert calls == DIST_CALLS["gather"] and gops.gram.launches == 2, (
                calls, gops.gram.launches)
        out["gram_launches"] = gops.gram.launches
        peak_since("mf_dist epoch")
        breakdown = epoch_breakdown(lambda: cell.step_fn(pb.w[0], pb.h[0], loc, e0))
        got = mf_dist.unshard_params(mf.MFParams(w[None], h[None]), n_ctx, n_items)
        obj1 = float(mf.objective(got, data, hp))
        assert obj1 < obj0 and bool(torch.isfinite(e).all()), (obj0, obj1)
        e_flat = mf.residuals(params0, data)
        peak_since("objective, flat residuals")
        t = time.perf_counter()
        flat, _ = mf.epoch(params0, data, e_flat, hp)
        flat_s = sync_s(t)
        peak_since("flat epoch")
        for a, b in ((got.w, flat.w), (got.h, flat.h)):
            torch.testing.assert_close(a, b, rtol=DIST_RTOL, atol=DIST_ATOL)
        err = max(float((got.w - flat.w).abs().max()),
                  float((got.h - flat.h).abs().max()))
        roof, trace_s = roofs["epoch_youtube"]
        log(f"phase 27 train cell epoch_youtube ({n_ctx} x {n_items} x {k}, {nnz} "
            f"interactions, the log drawn on the card in {log_s:.2f}s): "
            f"shard_interactions on the host {shard_s:.3f}s (blocks p_c "
            f"{host.ctx_l.shape[1]}, p_i {host.item_l.shape[1]}); one mf_dist "
            f"gather epoch {', '.join(f'{x:.3f}' for x in epoch_s)} s, collectives "
            f"{calls}, {out['gram_launches']} Gram launches; objective {obj0:.6g} -> "
            f"{obj1:.6g}; the flat mf.epoch from the same start {flat_s:.3f} s, max "
            f"|d| {err:.3g} (rtol {DIST_RTOL}, atol {DIST_ATOL}); dry-run roofline "
            f"(fake world of one, traced in {trace_s:.2f}s): {_roofline_line(roof)}")
        log(f"phase 27 train cell epoch breakdown (torch.profiler): {breakdown}")
        del data, host, loc, pb, e0, e_flat, w, h, e, got, flat
    assert not dist.is_initialized()
    peak_since("the rest")
    log(f"phase 27 wall {time.perf_counter() - t_phase:.1f}s; peak allocated "
        f"{max(peaks.values()):.2f} GiB, by part {peaks} GiB "
        f"({held_gib:.2f} GiB held by earlier phases at its start)")
    return out


def cells_only() -> None:
    """Phase 27 alone, after building the Gram and top-K kernels."""
    from repro_torch.kernels import build
    from repro_torch.kernels.gram import kernel as gram_kernel
    from repro_torch.kernels.topk_score import kernel

    build.build_all([kernel.LIB, gram_kernel.LIB])
    cells_full_width(torch.device("cuda", 0))


def _kernel_ms_by_name(fn, keys, n: int = 3) -> dict:
    """Device ms a launch, and launches a call, of each CUDA kernel whose
    name holds one of ``keys``, over ``n`` profiled calls of ``fn`` (empty
    when the profiler sees none)."""
    from torch.profiler import ProfilerActivity, profile

    fn(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for j in range(n):
            fn(j)
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0) or 0
        name = ev.key.split("<")[0].split("(")[0]
        if us > 0 and ev.device_type.name == "CUDA" and any(k in name for k in keys):
            out[name] = (us / ev.count / 1e3, ev.count / n)
    return out


def segment_sums_at_cell_shape(dev) -> dict:
    """Phase 28: the sorted segment sum (``kernels/segment_sum``) at the
    cells' log shape: ``bench.harness.traffic.draw_log`` with the
    ``youtube`` mix and icd-mf's sizes (19,992,436 entries; 200,000 rows
    context-major, 68,000 item-major, the top item ≈ 97,294), random fp32
    values. For each side, two values (MF's call) and four (FM's moments):
    the kernel beside its byte bound, its plain version, the ``zeros`` +
    ``index_add_`` a value that it replaced (on the sorted int64 row ids,
    as the epochs held them) and ``torch.segment_reduce(..., offsets=)``
    a value (the library yardstick, never called by the port); each pass's
    time from the profiler; the result within 1e-6 of each row's Σ|x| + 1
    of the float64 sums (beside the fp32 plain version's distance) and the
    same bits in two launches."""
    from bench.harness import traffic
    from repro_torch.kernels.segment_sum import ops as so, ref as sr

    with open(os.path.join(ROOT, "bench", "configs", "icd-mf.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(ROOT, "bench", "traffic", "youtube.json")) as f:
        mix = json.load(f)
    n_ctx, n_items = int(cfg["n_ctx"]), int(cfg["n_items"])
    t0 = time.perf_counter()
    ctx, item = traffic.draw_log(n_ctx, n_items, mix["log"], dev)
    t_item = torch.sort(item, stable=True).values
    ctx_ptr = torch.searchsorted(ctx, torch.arange(n_ctx + 1, device=dev))
    item_ptr = torch.searchsorted(t_item, torch.arange(n_items + 1, device=dev))
    torch.cuda.synchronize()
    nnz = int(ctx.shape[0])
    top_item = int(torch.diff(item_ptr).max())
    log(f"phase 28 log: {nnz} entries, {n_ctx} context rows (busiest "
        f"{int(torch.diff(ctx_ptr).max())}), {n_items} item rows (top {top_item}), "
        f"drawn on the card with its offsets in {time.perf_counter() - t0:.2f}s")
    gen = torch.Generator(device=dev).manual_seed(28)
    values = [torch.randn((nnz,), generator=gen, device=dev) for _ in range(4)]
    out = {"nnz": nnz, "top_item": top_item}
    for side, ptr, ids in (("context", ctx_ptr, ctx), ("item", item_ptr, t_item)):
        n = ptr.shape[0] - 1
        for nv in (2, 4):
            vals = values[:nv]
            got = so.segment_sum_sorted(vals, ptr)
            again = so.segment_sum_sorted(vals, ptr)
            exact = sr.segment_sum_sorted_ref([v.double() for v in vals], ptr)
            mass = sr.segment_sum_sorted_ref([v.double().abs() for v in vals], ptr)
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(got, again)), \
                "two launches of the segment-sum kernel differ"
            err = max(float(((g.double() - x).abs() / (m + 1.0)).max())
                      for g, x, m in zip(got, exact, mass))
            plain_err = max(float(((g.double() - x).abs() / (m + 1.0)).max())
                            for g, x, m in zip(sr.segment_sum_sorted_ref(vals, ptr),
                                               exact, mass))
            assert err <= 1e-6, (side, nv, err)
            del got, again, exact, mass
            kernel_ms = device_ms(lambda j: so.segment_sum_sorted(vals, ptr))
            passes = {k: ms for k, (ms, _) in _kernel_ms_by_name(
                lambda j: so.segment_sum_sorted(vals, ptr), ("segment_sum",), n=10).items()}
            plain_ms = device_ms(lambda j: sr.segment_sum_sorted_ref(vals, ptr), n=10)
            scatter_ms = device_ms(lambda j: [
                torch.zeros(n, device=dev).index_add_(0, ids, v) for v in vals], n=20)
            library_ms = device_ms(lambda j: [
                torch.segment_reduce(v, "sum", offsets=ptr) for v in vals], n=20)
            nbytes = nv * nnz * 4 + (n + 1) * 8 + nv * n * 4
            bound_ms = nbytes / H100_BYTES_PER_S * 1e3
            out[f"{side}_v{nv}"] = dict(ms=kernel_ms, bound=bound_ms, plain=plain_ms,
                                        scatter=scatter_ms, lib=library_ms,
                                        passes=passes, err=err, plain_err=plain_err)
            log(f"phase 28 {side} side, {nv} values: kernel {kernel_ms:.4f} ms "
                f"({kernel_ms / bound_ms:.2f}x its bound {bound_ms:.4f} ms, bytes: "
                f"{nbytes} B; by pass: "
                f"{', '.join(f'{k} {v:.4f} ms' for k, v in passes.items()) or 'not measured'}"
                f"), plain {plain_ms:.4f} ms, zeros + index_add_ x{nv} "
                f"{scatter_ms:.4f} ms, torch.segment_reduce x{nv} {library_ms:.4f} ms; "
                f"max |err| / (row's sum of |x| + 1) against float64 {err:.3g} (the "
                f"plain version in fp32 {plain_err:.3g}), two launches bit for bit")
    return out


SEGSUM_TUNE_BUILDS = [(128, 23), (128, 15), (64, 23), (256, 23)]


def segment_sum_tune() -> None:
    """Build ``csrc/segment_sum.cu`` in ``SEGSUM_TUNE_BUILDS``' variants
    (threads a block, path items a lane) and time each at phase 28's shapes,
    two and four values on both sides, each result within 1e-6 of each
    row's Σ|x| + 1 of the float64 sums, with registers and spills by
    kernel."""
    import ctypes

    from bench.harness import traffic
    from repro_torch.kernels import build
    from repro_torch.kernels.segment_sum import kernel as sk, ref as sr

    dev = torch.device("cuda", 0)
    libs = {cfg: build.CudaLibrary(
        "segment_sum", sk.LIB.source,
        defines={"SEGSUM_THREADS": cfg[0], "SEGSUM_ITEMS": cfg[1]},
        bind=sk._bind) for cfg in SEGSUM_TUNE_BUILDS}
    t0 = time.perf_counter()
    build.build_all(libs.values())
    log(f"segment-sum tune: {len(libs)} builds in {time.perf_counter() - t0:.1f}s")
    with open(os.path.join(ROOT, "bench", "configs", "icd-mf.json")) as f:
        cfg_mf = json.load(f)
    with open(os.path.join(ROOT, "bench", "traffic", "youtube.json")) as f:
        mix = json.load(f)
    n_ctx, n_items = int(cfg_mf["n_ctx"]), int(cfg_mf["n_items"])
    ctx, item = traffic.draw_log(n_ctx, n_items, mix["log"], dev)
    t_item = torch.sort(item, stable=True).values
    ptrs = {"context": torch.searchsorted(ctx, torch.arange(n_ctx + 1, device=dev)),
            "item": torch.searchsorted(t_item, torch.arange(n_items + 1, device=dev))}
    nnz = int(ctx.shape[0])
    del ctx, item, t_item
    gen = torch.Generator(device=dev).manual_seed(28)
    values = [torch.randn((nnz,), generator=gen, device=dev) for _ in range(4)]
    truth = {(side, nv): (sr.segment_sum_sorted_ref([v.double() for v in values[:nv]], ptr),
                          sr.segment_sum_sorted_ref([v.double().abs() for v in values[:nv]], ptr))
             for side, ptr in ptrs.items() for nv in (2, 4)}
    for (threads, items), lib in libs.items():
        so = lib.load()
        tile = threads * items
        ptx = " | ".join(ln.split("'")[1][:40] if "Compiling entry" in ln else ln.strip()
                         for ln in lib.build_log.splitlines()
                         if "Compiling entry" in ln or "registers" in ln or "spill" in ln)
        times = []
        for side, ptr in ptrs.items():
            n = ptr.shape[0] - 1
            for nv in (2, 4):
                vals = values[:nv]
                per = ctypes.c_int(0)
                lib.check(so.segment_sum_blocks(nv, ctypes.byref(per)), "segment_sum")
                blocks = min(per.value, -(-(n + nnz) // tile))
                scratch = torch.empty(blocks * threads // 32 * (12 + 8 * nv),
                                      dtype=torch.uint8, device=dev)
                outs = torch.empty((nv, n), device=dev)

                def call(j):
                    rc = so.segment_sum_f32(
                        ptr.data_ptr(), n, nnz, nv, *[v.data_ptr() for v in vals],
                        *[None] * (4 - nv), *[o.data_ptr() for o in outs], *[None] * (4 - nv),
                        blocks, scratch.data_ptr(), torch.cuda.current_stream().cuda_stream)
                    lib.check(rc, "segment_sum")

                call(0)
                torch.cuda.synchronize()
                exact, mass = truth[(side, nv)]
                err = max(float(((o.double() - x).abs() / (m + 1.0)).max())
                          for o, x, m in zip(outs, exact, mass))
                assert err <= 1e-6, (threads, items, side, nv, err)
                ms = device_ms(call)
                nbytes = nv * nnz * 4 + (n + 1) * 8 + nv * n * 4
                times.append(f"{side} {nv}v {ms:.4f} ms "
                             f"({ms / (nbytes / H100_BYTES_PER_S * 1e3):.2f}x, {blocks} blocks)")
        log(f"segment-sum tune {threads} threads x {items} items: "
            f"{'; '.join(times)}; ptxas {ptx}")


def segment_sum_only() -> None:
    """Phase 28 alone, after building the segment-sum kernel."""
    from repro_torch.kernels import build
    from repro_torch.kernels.segment_sum import kernel as sk

    t0 = time.perf_counter()
    build.build_all([sk.LIB])
    ptxas = [ln.strip() for ln in sk.LIB.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    log(f"phase 1 build: {sk.LIB.path().name} in {time.perf_counter() - t0:.1f}s; "
        f"ptxas: {' | '.join(ptxas)}")
    segment_sums_at_cell_shape(torch.device("cuda", 0))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])


def _cuda_launches(fn) -> int:
    """CUDA kernels one call of ``fn`` launches, by the profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(ev.count for ev in prof.key_averages() if ev.device_type.name == "CUDA"
               and (getattr(ev, "self_device_time_total", 0) or 0) > 0)


def tucker_core_at_cell_shape(dev) -> dict:
    """Phase 29: Tucker's core sweep by core slab (``kernels/tucker_core``)
    at the ``tucker-train-youtube-hourly`` cell's shape (the benchmark's
    own inputs: icd-tucker's ranks 16, 4, 32 on the hourly log, ≈ 2.8 M
    (user, hour) pairs, seed 29): the kernels' steps and residuals against
    the blocked plain form in float64 (beside the plain form in float32)
    and twice for the same bits; one slab pass and one solve (the
    profiler's ms a launch), the kernels' sweep and ``tucker.core_sweep``
    whole (CUDA events) beside the pass's bounds, the plain form and the
    per-coordinate loop it replaced; one ``tucker.epoch``: its seconds,
    kernel launches and slabs swept by the kernel."""
    import dataclasses
    import importlib.util

    from bench.harness import hours
    from bench.models import tucker as bench_tucker
    from repro_torch.core.gram import full_fp32, gram
    from repro_torch.core.models import tucker
    from repro_torch.kernels.tucker_core import ops as to, ref as tr

    spec = importlib.util.spec_from_file_location(  # the tests' oracle: the loop it replaced
        "test_torch_tucker_core", os.path.join(ROOT, "tests", "test_torch_tucker_core.py"))
    oracle = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(oracle)
    with open(os.path.join(ROOT, "bench", "configs", "icd-tucker.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(ROOT, "bench", "traffic", "youtube-hourly.json")) as f:
        mix = json.load(f)
    t0 = time.perf_counter()
    prog = bench_tucker.Program(cfg, hours.make_inputs(cfg, mix, 29, dev), dev)
    params, tc, data, hp, e = prog.params, prog.tc, prog.data, prog.hp, prog.e
    torch.cuda.synchronize()
    nnz, pairs = data.nnz, tc.n_ctx
    k1, k2, k3 = hp.k1, hp.k2, hp.k3
    log(f"phase 29 log: {nnz} interactions, {pairs} (user, hour) pairs, ranks "
        f"({k1}, {k2}, {k3}), built in {time.perf_counter() - t0:.1f}s")
    kw = dict(alpha0=hp.alpha0, l2_core=hp.l2_core, eta=hp.eta)
    with full_fp32():
        j_i = gram(params.w)
        phi_m = tucker.phi(params, tc)

        def inputs(dtype):
            return tucker.core_sweep_inputs(
                tucker.TuckerParams(*(x.to(dtype) for x in params)), phi_m.to(dtype),
                j_i.to(dtype), tc, dataclasses.replace(data, alpha=data.alpha.to(dtype)),
                e.to(dtype))

        x32 = inputs(torch.float32)
        got = to.core_sweep_slabs(*x32, **kw)
        again = to.core_sweep_slabs(*x32, **kw)
        plain = tr.core_sweep_slabs_ref(*x32, **kw)
        want = tr.core_sweep_slabs_ref(*inputs(torch.float64), **kw)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, again)), \
            "two calls of the core-sweep kernels differ"

        def gap(a, b):
            return float(torch.linalg.vector_norm(a.double() - b)
                         / torch.linalg.vector_norm(b))

        gaps = [gap(g, w) for g, w in zip(got, want)]
        plain_gaps = [gap(p, w) for p, w in zip(plain, want)]
        assert max(gaps) <= 2e-5, (gaps, plain_gaps)
        del plain, want, again
        sweep_ms = device_ms(lambda j: to.core_sweep_slabs(*x32, **kw), n=10)
        whole_ms = device_ms(lambda j: tucker.core_sweep(
            params, phi_m.clone(), j_i, tc, data, e, hp), n=10)
        by_kernel = _kernel_ms_by_name(lambda j: to.core_sweep_slabs(*x32, **kw),
                                       ("tucker_core",))
        plain_ms = device_ms(lambda j: tr.core_sweep_slabs_ref(*x32, **kw), n=3)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        oracle.per_coordinate_core_sweep(params, phi_m.clone(), j_i, tc, data, e, hp)
        b.record()
        torch.cuda.synchronize()
        loop_ms = a.elapsed_time(b)
    # a pass: the item id, ᾱ, e read and written, the offsets, two g rows (HBM); K's 528
    # and L'⁰'s 32 FMAs, the patch's 32 an interaction
    pass_bytes = nnz * 16 + (pairs + 1) * 8 + 2 * pairs * 4
    pass_flops = nnz * 2 * (k3 * (k3 + 1) // 2 + 2 * k3 + 3)
    pass_bound, pass_by = bound(pass_bytes, pass_flops)
    l2_bytes = nnz * 4 * k3  # the w rows, from L2
    slabs, kernel_launches = to.core_sweep_slabs.slabs, to.core_sweep_slabs.launches
    t1 = time.perf_counter()
    tucker.epoch(params, tc, data, e, hp)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t1
    epoch_slabs = to.core_sweep_slabs.slabs - slabs
    kernel_launches = to.core_sweep_slabs.launches - kernel_launches
    assert epoch_slabs == k1 * k2 and kernel_launches == 2 * k1 * k2 + 1, \
        (epoch_slabs, kernel_launches)
    launches = _cuda_launches(lambda: tucker.epoch(params, tc, data, e, hp))
    parts = ", ".join(f"{k} {ms:.4f} ms x {c:.0f}" for k, (ms, c) in by_kernel.items())
    log(f"phase 29 hold: kernels against the float64 blocked form, norm gaps delta "
        f"{gaps[0]:.3g}, e {gaps[1]:.3g} (the plain form in fp32 {plain_gaps[0]:.3g}, "
        f"{plain_gaps[1]:.3g}); two calls bit for bit")
    log(f"phase 29 time: the kernels' sweep {sweep_ms:.3f} ms ({2 * k1 * k2 + 1} launches: "
        f"{parts or 'by kernel not measured'}); tucker.core_sweep whole {whole_ms:.3f} ms; "
        f"a pass's bound {pass_bound:.4f} ms ({pass_by}: {pass_bytes} B from HBM, "
        f"{pass_flops} FLOP; the w rows {l2_bytes} B from L2); the plain form "
        f"{plain_ms:.3f} ms; the per-coordinate loop {loop_ms:.3f} ms")
    log(f"phase 29 epoch: tucker.epoch {epoch_s:.4f} s (wall, after the sweeps above), "
        f"{launches} kernel launches, {epoch_slabs} slabs by the core-sweep kernels "
        f"({kernel_launches} launches)")
    return {"gaps": gaps, "plain_gaps": plain_gaps, "sweep_ms": sweep_ms,
            "whole_ms": whole_ms, "by_kernel": by_kernel, "plain_ms": plain_ms,
            "loop_ms": loop_ms, "pass_bound_ms": pass_bound, "epoch_s": epoch_s,
            "launches": launches, "kernel_launches": kernel_launches}


def tucker_mode_at_cell_shape(dev) -> dict:
    """Phase 30: Tucker's mode sweeps by column (``kernels/tucker_mode``) at
    the ``tucker-train-youtube-hourly`` cell's shape (the benchmark's own
    inputs, seed 30): the u sweep, then the v sweep from its u, by the
    kernels against the per-column body they replaced (the tests' oracle) in
    float64: the norm gaps of u, v, Φ and e, beside the plain form's in
    float32; two runs give the same bits; each kernel's ms a launch (the
    profiler) and each sweep whole (CUDA events) beside a column's bound,
    the plain form and the per-column body in float32; one ``tucker.epoch``:
    its seconds, kernel launches and the columns the kernels swept."""
    import dataclasses
    import importlib.util

    from torch.profiler import ProfilerActivity, profile

    from bench.harness import hours
    from bench.models import tucker as bench_tucker
    from repro_torch.core.gram import full_fp32, gram
    from repro_torch.core.models import tucker
    from repro_torch.kernels.tucker_mode import ops as mo, ref as mr

    spec = importlib.util.spec_from_file_location(  # the tests' oracle: the body it replaced
        "test_torch_tucker_mode", os.path.join(ROOT, "tests", "test_torch_tucker_mode.py"))
    oracle = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(oracle)
    with open(os.path.join(ROOT, "bench", "configs", "icd-tucker.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(ROOT, "bench", "traffic", "youtube-hourly.json")) as f:
        mix = json.load(f)
    t0 = time.perf_counter()
    prog = bench_tucker.Program(cfg, hours.make_inputs(cfg, mix, 30, dev), dev)
    params, tc, data, hp, e = prog.params, prog.tc, prog.data, prog.hp, prog.e
    torch.cuda.synchronize()
    nnz, pairs = data.nnz, tc.n_ctx
    k1, k2, k3 = hp.k1, hp.k2, hp.k3
    log(f"phase 30 log: {nnz} interactions, {pairs} (user, hour) pairs, ranks "
        f"({k1}, {k2}, {k3}), built in {time.perf_counter() - t0:.1f}s")
    kw = dict(alpha0=hp.alpha0, l2=hp.l2, eta=hp.eta)

    def side_call(fn, side, p, fac, partner, phi_m, j_i, alpha, ee):
        """One sweep of every column of ``side`` by ``fn`` (``ops.mode_sweep``'s
        signature): (fac, Φ, e)."""
        if side == "u":
            head = (fac, p.b, partner, tc.c2, tc.c1, *tc.c1_groups)
        else:
            head = (fac, p.b.transpose(0, 1), partner, tc.c1, tc.c2, *tc.c2_groups)
        return fn(*head, phi_m, j_i, p.w, data.ctx_ptr, data.item, alpha, ee,
                  columns=tuple(range(fac.shape[1])), **kw)

    def old_body(fac, b_s, partner, pop, gop, order, ptr, phi_m, j_i, w, ctx_ptr, item,
                 alpha, ee, *, columns, **_):
        return oracle.per_column_mode_sweep(
            fac, (lambda f: b_s[f]), pop, partner, gop, fac.shape[0], fac.shape[1], phi_m,
            j_i, dataclasses.replace(data, alpha=alpha), w, ee, hp)

    def both_sides(fn, dtype):
        """u then v from the start, by ``fn`` in ``dtype``: (u, v, Φ, e)."""
        p = tucker.TuckerParams(*(x.to(dtype) for x in params))
        u, v, phi_m, ee = p.u.clone(), p.v.clone(), tucker.phi(p, tc).contiguous(), e.to(dtype)
        j_i, alpha = p.w.T @ p.w, data.alpha.to(dtype)
        u, phi_m, ee = side_call(fn, "u", p, u, v, phi_m, j_i, alpha, ee)
        v, phi_m, ee = side_call(fn, "v", p, v, u, phi_m, j_i, alpha, ee)
        return u, v, phi_m, ee

    def gap(a, b):
        return float(torch.linalg.vector_norm(a.double() - b) / torch.linalg.vector_norm(b))

    names = ("u", "v", "phi", "e")
    with full_fp32():
        got = both_sides(mo.mode_sweep, torch.float32)
        again = both_sides(mo.mode_sweep, torch.float32)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, again)), \
            "two runs of the mode-sweep kernels differ"
        plain = both_sides(mr.mode_sweep_ref, torch.float32)
        want = both_sides(old_body, torch.float64)
        gaps = {n: gap(g, w) for n, g, w in zip(names, got, want)}
        plain_gaps = {n: gap(p, w) for n, p, w in zip(names, plain, want)}
        assert max(gaps.values()) <= 2e-5, (gaps, plain_gaps)
        del plain, want, again, got

        j_i = gram(params.w)
        phi0 = tucker.phi(params, tc).contiguous()
        times = {}
        for side, fac, partner in (("u", params.u, params.v), ("v", params.v, params.u)):
            def call(j, side=side, fac=fac, partner=partner, fn=mo.mode_sweep):
                return side_call(fn, side, params, fac.clone(), partner, phi0.clone(), j_i,
                                 data.alpha, e)

            call(0)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                call(0)
                torch.cuda.synchronize()
            by_kernel = {ev.key.split("(")[0].replace("void ", ""):
                         ((ev.self_device_time_total or 0) / ev.count / 1e3, ev.count)
                         for ev in prof.key_averages()
                         if ev.device_type.name == "CUDA" and "tucker_mode" in ev.key}
            times[side] = {
                "sweep_ms": device_ms(call, n=10), "by_kernel": by_kernel,
                "plain_ms": device_ms(lambda j: call(j, fn=mr.mode_sweep_ref), n=3),
                "old_ms": device_ms(lambda j: call(j, fn=old_body), n=3)}
    # a column: the item id, ᾱ, e and s read and written an interaction, Φ read and
    # written, the offsets, the group and partner ids a pair (HBM); s and the pair
    # products' FMAs; the w rows from L2
    col_bytes = nnz * 24 + pairs * (2 * 4 * k3 + 8 + 8 + 8)
    col_flops = {side: nnz * (2 * k3 + 6) + pairs * (6 * k_o * k3 + 6 * k3)
                 for side, k_o in (("u", k2), ("v", k1))}
    col_bound = {side: bound(col_bytes, f) for side, f in col_flops.items()}
    l2_bytes = nnz * 4 * k3
    launches0, cols0 = mo.mode_sweep.launches, mo.mode_sweep.columns
    t1 = time.perf_counter()
    tucker.epoch(params, tc, data, e, hp)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t1
    kernel_launches = mo.mode_sweep.launches - launches0
    columns = mo.mode_sweep.columns - cols0
    assert columns == k1 + k2 and kernel_launches == 2 * (k1 + k2) + 2, \
        (columns, kernel_launches)
    launches = _cuda_launches(lambda: tucker.epoch(params, tc, data, e, hp))
    log(f"phase 30 hold: u, v by the kernels against the float64 per-column body, norm "
        f"gaps {', '.join(f'{n} {x:.3g}' for n, x in gaps.items())} (the plain form in "
        f"fp32 {', '.join(f'{n} {x:.3g}' for n, x in plain_gaps.items())}); two runs bit "
        f"for bit")
    for side in ("u", "v"):
        t = times[side]
        parts = "; ".join(f"{k} {ms:.4f} ms x {c}" for k, (ms, c) in t["by_kernel"].items())
        b_ms, b_by = col_bound[side]
        log(f"phase 30 time {side}: the kernels' sweep {t['sweep_ms']:.3f} ms "
            f"({parts or 'by kernel not measured'}); a column's bound {b_ms:.4f} ms "
            f"({b_by}: {col_bytes} B from HBM, {col_flops[side]} FLOP; the w rows "
            f"{l2_bytes} B from L2); the plain form {t['plain_ms']:.3f} ms; the "
            f"per-column body it replaced {t['old_ms']:.3f} ms")
    log(f"phase 30 epoch: tucker.epoch {epoch_s:.4f} s (wall, after the sweeps above), "
        f"{launches} kernel launches, {columns} columns by the mode-sweep kernels "
        f"({kernel_launches} launches)")
    return {"gaps": gaps, "plain_gaps": plain_gaps, "times": times,
            "bound_ms": {s: b[0] for s, b in col_bound.items()}, "epoch_s": epoch_s,
            "launches": launches, "kernel_launches": kernel_launches}


def tucker_mode_only() -> None:
    """Phase 30 alone, after building the mode-sweep kernel at k3 = 32."""
    from repro_torch.kernels import build
    from repro_torch.kernels.tucker_core import kernel as tk
    from repro_torch.kernels.tucker_mode import kernel as mk

    t0 = time.perf_counter()
    libs = [mk.library(mk.width_of(32)), tk.library(tk.width_of(32))]
    build.build_all(libs)
    for lib in libs:
        ptxas = [ln.split("'")[1][:48] if "Compiling entry" in ln else ln.strip()
                 for ln in lib.build_log.splitlines()
                 if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
        log(f"phase 1 build: {lib.path().name} in {time.perf_counter() - t0:.1f}s; "
            f"ptxas: {' | '.join(ptxas)}")
    tucker_mode_at_cell_shape(torch.device("cuda", 0))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])


def tucker_core_only() -> None:
    """Phase 29 alone, after building the core-sweep kernel at k3 = 32."""
    from repro_torch.kernels import build
    from repro_torch.kernels.tucker_core import kernel as tk

    t0 = time.perf_counter()
    lib = tk.library(tk.width_of(32))
    build.build_all([lib])
    ptxas = [ln.split("'")[1][:40] if "Compiling entry" in ln else ln.strip()
             for ln in lib.build_log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    log(f"phase 1 build: {lib.path().name} in {time.perf_counter() - t0:.1f}s; "
        f"ptxas: {' | '.join(ptxas)}")
    tucker_core_at_cell_shape(torch.device("cuda", 0))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        sys.exit(1)
    from repro_torch.kernels import build
    from repro_torch.kernels.cd_sweep import kernel as cd_kernel
    from repro_torch.kernels.gram import kernel as gram_kernel
    from repro_torch.kernels.segment_sum import kernel as seg_kernel
    from repro_torch.kernels.topk_score import kernel, ops, ref
    from repro_torch.kernels.tucker_core import kernel as tucker_kernel
    from repro_torch.kernels.tucker_mode import kernel as mode_kernel
    from repro_torch.launch import serve

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)

    # 1. build every kernel, one nvcc per source, all at once
    libs = [kernel.LIB, gram_kernel.LIB, cd_kernel.LIB, cd_kernel.SLAB_LIB,
            cd_kernel.GATHER_LIB, seg_kernel.LIB, tucker_kernel.library(32),
            mode_kernel.library(32)]
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
    form_errs = check_forms_random(ops, ref, gen, dev)
    check_forms_exact(ops, ref, np.random.default_rng(3), dev)
    log(f"phase 2 hold forms: random at the same shard, max |score err| "
        f"bf16 {form_errs['bf16']:.3g}, int8 {form_errs['int8']:.3g}, dense "
        f"mask (whole and a middle shard's strided slice) "
        f"{form_errs['mask']:.3g} (rtol {RTOL}, atol {ATOL}); small-integer "
        f"int8 (scale 1), bf16 (|x| <= 256), ties across chunks, fully "
        f"masked rows, and K = 8193, 10000, 20000 over 40000 rows exact; "
        f"the one-launch form equal bit for bit to the three-launch chain in "
        f"all {CHAIN_HELD['calls']} calls at K <= 256 (fp32, bf16, int8, "
        f"mask)")

    # 3. the serving path at full icd-mf width. A first, shorter run of the
    # same driver takes the process's one-time costs (CUDA modules load at
    # a kernel's first launch, the allocator's first blocks), which would
    # otherwise land in the timed run by an amount that depends on what
    # ran before it; the timed run then measures serving alone
    warm = check_serve(ref, serve, SERVE_ARGV + ["--requests", "32"], dev)
    ops.topk_score.launches = 0
    ops.topk_score.launches_chain = 0
    report = check_serve(ref, serve, SERVE_ARGV + ["--requests", "256"], dev)
    launches = ops.topk_score.launches
    ms = report["mesh_stats"]
    assert launches >= 1 and launches == ms["dispatches"] - ms["faults"], (
        "every successful mesh dispatch must launch the kernel once",
        launches, dict(ms))
    assert ops.topk_score.launches_chain == 0, "the serving path took the chain"
    flushes = report["batcher_stats"]["flushes"]
    log(f"phase 3 serve: 256 requests, {flushes} flushes, "
        f"{launches} kernel launches, all in the one-launch form "
        f"({launches / flushes:.2f} per flush), "
        f"{ms['dispatches']} dispatches, {ms['faults']} faults, "
        f"coverage 1.0, 16 users match the plain recompute; "
        f"{256 / report['seconds']:.1f} req/s (after a 32-request warm-up "
        f"run of {warm['seconds'] * 1e3:.3f} ms), completion "
        f"p50 {np.percentile(report['completion_s'], 50) * 1e3:.3f} ms "
        f"p99 {np.percentile(report['completion_s'], 99) * 1e3:.3f} ms")

    # 4. time at the serving shapes
    b, rows, d, k = (SERVE_SHAPE[x] for x in ("b", "rows", "d", "k"))
    phi = torch.randn((b, d), generator=gen, device=dev)
    slabs = [torch.randn((rows, d), generator=gen, device=dev) for _ in range(4)]

    def serve_call(j):
        return ops.topk_score(phi, slabs[j % 4], k, id_offset=rows, n_valid=rows)

    def chain_call(j):  # the three-launch chain the one-launch form replaced
        return ops.topk_score(phi, slabs[j % 4], k, id_offset=rows,
                              n_valid=rows, form="chain")

    eids = torch.randint(rows, 2 * rows, (b, 20), generator=gen, device=dev,
                         dtype=torch.int32)

    def excl_call(j):  # the serving trace's form: up to 20 excluded ids a row
        return ops.topk_score(phi, slabs[j % 4], k, exclude_ids=eids,
                              id_offset=rows, n_valid=rows)

    kernel_ms = device_ms(serve_call)
    chain_ms = device_ms(chain_call)
    excl_ms = device_ms(excl_call)
    excl_chain_ms = device_ms(lambda j: ops.topk_score(
        phi, slabs[j % 4], k, exclude_ids=eids, id_offset=rows, n_valid=rows,
        form="chain"))
    plain_ms = device_ms(lambda j: ref.topk_score_ref(
        phi, slabs[j % 4], k, id_offset=rows, n_valid=rows))
    library_ms = device_ms(lambda j: torch.topk(phi @ slabs[j % 4].T, k))
    parts = kernel_breakdown(serve_call, as_list=True)
    assert len(parts) == 1 and "topk_fused_kernel" in parts[0], (
        "the one-launch form must show one kernel a call", parts)
    log(f"phase 4 breakdown (torch.profiler, per call): {parts[0]} (one "
        f"kernel a call); the chain it replaced: {kernel_breakdown(chain_call)}")
    log(f"phase 4 time, 20 excluded ids a row (the serving trace's form): "
        f"one launch {excl_ms:.4f} ms, the chain {excl_chain_ms:.4f} ms")
    # the large-K path at the same shard (K = 1,000: whole sorted chunks,
    # pairwise merge levels in device memory)
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
    log(f"phase 4 time: topk_score {kernel_ms:.4f} ms in one launch (the "
        f"three-launch chain it replaced {chain_ms:.4f} ms in the same call), "
        f"plain {plain_ms:.4f} ms, "
        f"torch.topk(phi @ psi.T) {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}: {nbytes} B, {flops} FLOP); phase 3's {launches} launches "
        f"at this time are {launches * kernel_ms:.3f} ms of its "
        f"{report['seconds'] * 1e3:.3f} ms trace "
        f"({100 * launches * kernel_ms / (report['seconds'] * 1e3):.1f}%)")

    del phi, slabs, report, warm, eids

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
        f"|a e psi| / den); edge cases pass, each form twice for the same "
        f"bits; split-row on 70,000 rows (fault 3.4) max |err| "
        f"{rp_errs['many_rows']:.3g}; {time.perf_counter() - t0:.1f}s")
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

    # 16.-17. the quantized IVF serving tier, delta publish, rollout
    t0 = time.perf_counter()
    ivf = serve_ivf_full_width(dev, tr["params"], tr["pdata"])
    log(f"phase 16 done in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    form_times = time_topk_forms(dev, ivf)
    log(f"phase 17 done in {time.perf_counter() - t0:.1f}s")
    run_serve_retrieval(dev)

    # 19.-22. FM at icd-fm width, rows 1 and 6-9 at its shapes, FM served
    # from the Model API, fold-in, the serve driver's --continual
    t0 = time.perf_counter()
    fmx = train_fm_full_width(dev, fm["x"], fm["z"], fm["data"], fm["pdata"])
    log(f"phase 19 done in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    fm_gram = time_gram_fm(dev, fmx["params"], fm["x"], fm["z"], fmx["hp"])
    fm_slab = time_slab_kernels(dev, fm["pdata"], m=FM_M, phase=20, ld=FM_M)
    log(f"phase 20 done in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    fm_serve = serve_and_fold_in(dev, fmx, fm["x"], fm["z"], fm["data"], tr["params"])
    log(f"phase 21 done in {time.perf_counter() - t0:.1f}s")
    del fm["pdata"], fm["data"], fm["x"], fm["z"]
    t0 = time.perf_counter()
    serve_continual(ref, serve, dev)
    log(f"phase 22 done in {time.perf_counter() - t0:.1f}s")

    # 23.-25. the continual-learning loop at full width, the training
    # stack, the CLIs and twins
    t0 = time.perf_counter()
    cont = continual_full_width(dev)
    log(f"phase 23 done in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    training_stack_full_width(dev)
    log(f"phase 24 done in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    run_clis_and_twins(dev)
    log(f"phase 25 done in {time.perf_counter() - t0:.1f}s")

    # 26. the distribution layer in an NCCL world of one
    t0 = time.perf_counter()
    dist26 = distribution_full_width(dev)
    log(f"phase 26 done in {time.perf_counter() - t0:.1f}s")

    # 27. the launch tooling's cells on the card
    t0 = time.perf_counter()
    cells27 = cells_full_width(dev)
    log(f"phase 27 done in {time.perf_counter() - t0:.1f}s")

    # 28. the sorted segment sum at the cells' log shape
    t0 = time.perf_counter()
    seg28 = segment_sums_at_cell_shape(dev)
    log(f"phase 28 done in {time.perf_counter() - t0:.1f}s")

    # 29. Tucker's core sweep by core slab at the Tucker cell's shape
    t0 = time.perf_counter()
    core29 = tucker_core_at_cell_shape(dev)
    log(f"phase 29 done in {time.perf_counter() - t0:.1f}s")

    # 30. Tucker's mode sweeps by column at the Tucker cell's shape
    t0 = time.perf_counter()
    mode30 = tucker_mode_at_cell_shape(dev)
    log(f"phase 30 done in {time.perf_counter() - t0:.1f}s")

    form_launches = {"bf16": ivf["launches"]["bf16"]["launches_bf16"],
                     "int8": ivf["launches"]["int8"]["launches_int8"],
                     "mask": ivf["launches"]["mask"],
                     "ivf": sum(ivf["launches"][q]["launches_ivf"]
                                for q in ("none", "bf16", "int8"))}
    form_times["ivf"] = form_times["ivf_none"]
    form_errs["ivf"] = max(form_times[f"ivf_{q}"]["err"]
                           for q in ("none", "bf16", "int8"))
    assert all(n > 0 for n in form_launches.values()), form_launches

    def row(name, source, replaces, launches, err, t, library, forms=None):
        """A kernel's JSON row; times are per launch, averaged over the
        two sides' launches an epoch makes; ``forms``: the main path's
        launches by launch form."""
        mean = lambda xs: float(np.mean(xs))  # noqa: E731
        by = {b for _, b in t["bound"]}
        out = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": launches,
               "max_abs_err": err, "ms": mean(t["ms"]),
               "plain_ms": mean(t["plain"]),
               "bound_ms": mean([b for b, _ in t["bound"]]),
               "bound_by": by.pop() if len(by) == 1 else "bytes",
               "library_ms": None if library is None else mean(library)}
        if forms is not None:
            out["forms"] = forms
        return out

    def fm_of(launches, t, library):
        """FM's own launches (phase 19's main path) and times at its shapes
        (phase 20), as ``row`` gives them."""
        r = row("", "", "", launches, None, t, library)
        return {key: r[key] for key in ("launches", "ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms")}

    def row_forms(counts, name):
        return {f: counts[f"{name}:{f}"] for f in ("reg_row", "split_row")}

    cd_src = "src/repro_torch/kernels/cd_sweep/csrc/cd_sweep.cu"
    gather_src = "src/repro_torch/kernels/cd_sweep/csrc/cd_gather.cu"
    kernels = [{
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
       row("cd_block_sweep_gather", gather_src,
           "src/repro/kernels/cd_sweep/kernel.py:429",
           tr["launches"]["cd_block_sweep_gather"],
           errs["cd_block_sweep_gather"], times["gather"], None),
       row("cd_block_sweep_rowpatch", gather_src,
           "src/repro/kernels/cd_sweep/kernel.py:207",
           ctx["pre_launches"]["cd_block_sweep_rowpatch"],
           rp_errs["cd_block_sweep_rowpatch"], rp_times["pregather"], None,
           row_forms(ctx["pre_launches"], "cd_block_sweep_rowpatch")),
       row("cd_block_sweep_rowpatch_gather", gather_src,
           "src/repro/kernels/cd_sweep/kernel.py:519",
           ctx["launches"]["cd_block_sweep_rowpatch_gather"],
           rp_errs["cd_block_sweep_rowpatch_gather"], rp_times["gather"],
           None, row_forms(ctx["launches"], "cd_block_sweep_rowpatch_gather"))] + [
        row(name, gather_src if name.endswith("gather") else
            "src/repro_torch/kernels/cd_sweep/csrc/cd_slab.cu",
            f"src/repro/kernels/cd_sweep/kernel.py:{line}",
            (fm["launches"] if name.endswith("gather") else fm["pre_launches"])[name],
            slab_errs[name], slab_times[name],
            None if name.endswith("gather") else slab_times[name]["lib"])
        for name, line in (("cd_slab_reduce", 275), ("cd_slab_reduce_gather", 585),
                           ("cd_resid_patch", 331), ("cd_resid_patch_gather", 646))] + [{
        "name": f"topk_score_{form}", "route": "cuda",
        "source": "src/repro_torch/kernels/topk_score/csrc/topk_score.cu",
        "replaces": "src/repro/kernels/topk_score/kernel.py:159",
        "launches": form_launches[form], "max_abs_err": form_errs[form],
        "ms": form_times[form]["ms"], "plain_ms": form_times[form]["plain"],
        "bound_ms": form_times[form]["bound"],
        "bound_by": form_times[form]["bound_by"],
        "library_ms": form_times[form]["lib"]}
        for form in ("bf16", "int8", "mask", "ivf")]
    # rows 6 and 7 at FM's m = 9 (the one-tile form's wide instance):
    # launches of phase 19's main path, errors of phase 13, times of
    # phase 20 beside the tiled form it replaced
    for name, line in (("cd_slab_reduce", 275), ("cd_slab_reduce_gather", 585)):
        gather = name.endswith("gather")
        r9 = row(f"{name}_m9", gather_src, f"src/repro/kernels/cd_sweep/kernel.py:{line}",
                 (fmx["launches"] if gather else fmx["pre_launches"])[f"{name}:one_tile"],
                 slab_errs[f"{name}:m9"], fm_slab[name],
                 None if gather else fm_slab[name]["lib"])
        r9["tiled_ms"] = float(np.mean(fm_slab[name]["tiled"]))
        kernels.append(r9)
    # FM's path (phases 19-21): its launches and its shapes' times
    fm_rows = {"gram": fm_of(fmx["launches"]["gram"], fm_gram, fm_gram["lib"])}
    for name in ("cd_slab_reduce", "cd_slab_reduce_gather", "cd_resid_patch",
                 "cd_resid_patch_gather"):
        gather = name.endswith("gather")
        fm_rows[name] = fm_of(
            (fmx["launches"] if gather else fmx["pre_launches"])[name],
            fm_slab[name], None if gather else fm_slab[name]["lib"])
    t = fm_serve["topk"]
    fm_rows["topk_score"] = {"launches": t["launches"], "ms": t["ms"],
                             "plain_ms": t["plain"], "bound_ms": t["bound"],
                             "bound_by": t["bound_by"], "library_ms": t["lib"]}
    for r in kernels:
        if r["name"] in fm_rows:
            r["fm"] = fm_rows[r["name"]]
        if r["name"] in cont["launches"]:
            # the continual loop's launches (phase 23's main path)
            r["continual"] = {"launches": cont["launches"][r["name"]]}
    # the distribution layer's launches (phase 26's main path: the mf_dist
    # epochs' Grams, one shard_map_topk call)
    dist_launches = {"gram": dist26["gram_launches"],
                     "topk_score": dist26["topk_launches"]}
    for r in kernels:
        if r["name"] in dist_launches:
            r["dist"] = {"launches": dist_launches[r["name"]]}
    # the cells' launches (phase 27's main path: the train cell's epoch's
    # two Grams, the retrieval cell's one top-K)
    cell_launches = {"gram": cells27["gram_launches"],
                     "topk_score": cells27["topk_launches"]}
    for r in kernels:
        if r["name"] in cell_launches:
            r["cells"] = {"launches": cell_launches[r["name"]]}
    # the sorted segment sum (phase 28's times, two values a call, the two
    # sides' mean; launches of phase 6's flat mf.epoch, the main path, and
    # of phase 19's flat fm.epoch)
    seg = {key: [seg28[f"{side}_v2"][key] for side in ("context", "item")]
           for key in ("ms", "plain", "bound", "lib", "err")}
    kernels.append({
        "name": "segment_sum", "route": "cuda",
        "source": "src/repro_torch/kernels/segment_sum/csrc/segment_sum.cu",
        "replaces": "none (jax.ops.segment_sum under XLA)",
        "launches": tr["segment_sum_launches"],
        "fm": {"launches": fmx["segment_sum_launches"]},
        "max_abs_err": max(seg["err"]),
        "ms": float(np.mean(seg["ms"])), "plain_ms": float(np.mean(seg["plain"])),
        "bound_ms": float(np.mean(seg["bound"])), "bound_by": "bytes",
        "library_ms": float(np.mean(seg["lib"]))})
    # Tucker's core sweep (phase 29): a pass's time and bound; its launches
    # in one tucker.epoch at the cell's shape (2·k1·k2 + 1); the error is the
    # worst norm gap against the float64 blocked form
    kernels.append({
        "name": "tucker_core", "route": "cuda",
        "source": "src/repro_torch/kernels/tucker_core/csrc/tucker_core.cu",
        "replaces": "none (the core sweep's lax.fori_loop under XLA)",
        "launches": core29["kernel_launches"], "max_abs_err": max(core29["gaps"]),
        "ms": core29["by_kernel"].get("tucker_core_pass_kernel", (None,))[0],
        "sweep_ms": core29["sweep_ms"], "plain_ms": core29["plain_ms"],
        "loop_ms": core29["loop_ms"], "bound_ms": core29["pass_bound_ms"],
        "bound_by": "operations", "library_ms": None})
    # Tucker's mode sweeps (phase 30): a u column's pass and solve, its bound;
    # launches in one tucker.epoch at the cell's shape (2·(k1 + k2) + 2); the
    # error is the worst norm gap against the float64 per-column body
    mode_u = mode30["times"]["u"]
    kernels.append({
        "name": "tucker_mode", "route": "cuda",
        "source": "src/repro_torch/kernels/tucker_mode/csrc/tucker_mode.cu",
        "replaces": "none (the mode sweeps' XLA ops, repro/core/models/tucker.py:_mode_sweep)",
        "launches": mode30["kernel_launches"], "max_abs_err": max(mode30["gaps"].values()),
        "ms": {k: ms for k, (ms, _) in mode_u["by_kernel"].items()},
        "sweep_ms": {s: t["sweep_ms"] for s, t in mode30["times"].items()},
        "plain_ms": {s: t["plain_ms"] for s, t in mode30["times"].items()},
        "old_ms": {s: t["old_ms"] for s, t in mode30["times"].items()},
        "bound_ms": mode30["bound_ms"]["u"], "bound_by": "bytes", "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--serve-order"] and len(sys.argv) == 3:
        serve_first_runs(sys.argv[2])
    elif sys.argv[1:] == ["--gram-tune"]:
        gram_tune()
    elif sys.argv[1:] == ["--sweep-tune"]:
        sweep_tune()
    elif sys.argv[1:] == ["--slab-tune"]:
        slab_tune()
    elif sys.argv[1:] == ["--topk-tune"]:
        topk_tune()
    elif sys.argv[1:] == ["--dist"]:
        dist_only()
    elif sys.argv[1:] == ["--cells"]:
        cells_only()
    elif sys.argv[1:] == ["--segment-sum"]:
        segment_sum_only()
    elif sys.argv[1:] == ["--segment-sum-tune"]:
        segment_sum_tune()
    elif sys.argv[1:] == ["--tucker-core"]:
        tucker_core_only()
    elif sys.argv[1:] == ["--tucker-mode"]:
        tucker_mode_only()
    else:
        main()
