"""The port's quantized IVF serving tier held against the JAX package's on
the same numpy inputs: ``core/quant``, ``serve/ann`` (layout, query, delta
fold, Lloyd steps, recall curve), ``serve/publish`` (delta helpers,
publisher, staged rollout), the IVF and delta paths of the engine, cluster
and mesh, the plain top-K in its bf16, int8 and dense-mask forms, and the
``serve_retrieval`` twin on the CPU.

k-means seeds differ between the packages (a torch ``Generator`` cannot
reproduce ``jax.random.choice``), so the port's index is built from the
reference's k-means result with ``index_from_numpy`` wherever pruned
results are compared. Tolerances: ids and layouts exactly; fp32 scores to
rtol 1e-5 / atol 1e-6 (the packages sum in different orders); int8 scales
to rtol 1e-7; Lloyd centroids to rtol 1e-5 / atol 1e-6 on well-separated
blobs, where no assignment sits near a tie. The JAX kernel runs in
interpret mode on toy sizes (at most 8 clusters, a few hundred rows)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jquant
from repro.eval.ranking import ann_recall_curve as jax_recall_curve
from repro.kernels.topk_score import topk_score as jax_topk
from repro.serve import ann as jann
from repro.serve import publish as jpublish
from repro.serve.cluster import ShardedRetrievalCluster as JaxCluster
from repro.serve.cluster import shard_psi as jax_shard_psi
from repro.serve.mesh import FaultTolerantRetrievalMesh as JaxMesh
from repro_torch.core import quant
from repro_torch.eval.ranking import ann_recall_curve
from repro_torch.kernels.topk_score import ops
from repro_torch.kernels.topk_score.ref import topk_score_ref
from repro_torch.obs import (
    MetricsRegistry,
    topk_score_cost,
    topk_score_ivf_cost,
)
from repro_torch.serve import ann
from repro_torch.serve.cluster import ShardedRetrievalCluster, shard_psi
from repro_torch.serve.engine import RetrievalEngine
from repro_torch.serve.mesh import FaultInjector, FaultTolerantRetrievalMesh
from repro_torch.serve.publish import (
    PsiPublisher,
    StagedRollout,
    apply_delta,
    dense_table,
)

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
QUANTS = ("none", "bf16", "int8")


def _clustered(n, d, n_centers, seed=0, spread=4.0):
    """ψ with real cluster structure (the reference tests' generator)."""
    rng = np.random.default_rng(seed)
    cents = rng.normal(size=(n_centers, d)) * spread
    per = -(-n // n_centers)
    rows = np.concatenate(
        [cents[i] + rng.normal(size=(per, d)) for i in range(n_centers)])[:n]
    rng.shuffle(rows)
    return rows.astype(np.float32)


def _queries(b, d, seed=100):
    return np.random.default_rng(seed).normal(size=(b, d)).astype(np.float32)


def _exclude(b, hi, width, seed):
    rng = np.random.default_rng(seed)
    out = np.full((b, width), -1, np.int32)
    for r in range(b):
        n = int(rng.integers(0, width + 1))
        out[r, :n] = rng.choice(hi, size=n, replace=False)
    return out


def _np(x):
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _same(port, ref, exact_scores=False):
    (ps, pi), (js, ji) = port, ref
    np.testing.assert_array_equal(_np(pi), _np(ji))
    if exact_scores:
        np.testing.assert_array_equal(_np(ps), _np(js))
    else:
        np.testing.assert_allclose(_np(ps), _np(js), rtol=RTOL, atol=ATOL)


def _pair(psi, cfg, id_offset=0):
    """The reference's index and the port's over the same k-means result."""
    ref = jann.PsiIndex.build(jnp.asarray(psi), cfg, id_offset=id_offset)
    c = cfg.resolve_clusters(psi.shape[0])
    cents, assign = jann.kmeans(jnp.asarray(psi), c, n_iters=cfg.kmeans_iters,
                                seed=cfg.seed)
    port = ann.index_from_numpy(psi, np.asarray(cents), np.asarray(assign),
                                _cfg(cfg), id_offset=id_offset, device="cpu")
    return ref, port


def _cfg(jcfg):
    return ann.AnnConfig(**{f: getattr(jcfg, f) for f in (
        "n_clusters", "n_probe", "quant", "kmeans_iters", "seed",
        "reindex_after")})


def _total(reg, name) -> float:
    """Sum of a metric family's children; 0 before its first record."""
    fam = {f.name: f for f in reg.families()}.get(name)
    return 0.0 if fam is None else sum(c.value for c in fam.children())


def _same_layout(port, ref):
    np.testing.assert_array_equal(_np(port.psi_q), _np(ref.psi_q))
    if ref.scales is None:
        assert port.scales is None
    else:
        np.testing.assert_allclose(_np(port.scales), _np(ref.scales), rtol=1e-7)
    for name in ("ids_global", "inv_pos", "counts"):
        np.testing.assert_array_equal(_np(getattr(port, name)),
                                      _np(getattr(ref, name)))
    assert (port.block_rows, port.n_rows, port.staleness, port.id_offset) == (
        ref.block_rows, ref.n_rows, ref.staleness, ref.id_offset)


# ------------------------------------------------------------ core/quant
def test_quant_matches_reference():
    x = np.random.default_rng(0).normal(size=(12, 9)).astype(np.float32)
    x[3] *= 100.0
    x[5] = 0.0                                   # the floor scale
    x[7, :4] = [0.5, -0.5, 1.5, 2.5]             # round half to even
    q, s = quant.int8_quantize_rows(torch.from_numpy(x))
    jq, js = jquant.int8_quantize_rows(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-7)
    np.testing.assert_allclose(
        quant.int8_dequantize_rows(q, s).numpy(),
        np.asarray(jquant.int8_dequantize_rows(jq, js)), rtol=1e-7)
    q1, s1 = quant.int8_quantize(torch.from_numpy(x))
    jq1, js1 = jquant.int8_quantize(jnp.asarray(x))
    np.testing.assert_array_equal(q1.numpy(), np.asarray(jq1))
    np.testing.assert_allclose(float(s1), float(js1), rtol=1e-7)
    np.testing.assert_allclose(quant.int8_dequantize(q1, s1).numpy(),
                               np.asarray(jquant.int8_dequantize(jq1, js1)),
                               rtol=1e-7)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    with pytest.raises(ValueError, match="2-D"):
        quant.int8_quantize_rows(torch.zeros(4))


# --------------------------------------------------- the plain top-K forms
@pytest.mark.parametrize("form", ["bf16", "int8", "mask", "mask_bool"])
def test_plain_quantized_and_mask_forms_match_jax(form):
    """``topk_score_ref`` in the forms the IVF tier and the dense-mask
    callers use, against the JAX kernel in interpret mode."""
    phi, psi = _queries(7, 16, 1), _clustered(203, 16, 4, seed=2)
    kw, jkw = {}, {}
    if form == "bf16":
        p, jp = torch.from_numpy(psi).bfloat16(), jnp.asarray(psi).astype(jnp.bfloat16)
    elif form == "int8":
        q, s = quant.int8_quantize_rows(torch.from_numpy(psi))
        p, jp = q, jnp.asarray(q.numpy())
        kw["psi_scale"], jkw["psi_scale"] = s, jnp.asarray(s.numpy())
    else:
        p, jp = torch.from_numpy(psi), jnp.asarray(psi)
        mask = np.random.default_rng(3).random((7, 203)) < 0.3
        mask[2] = True
        m = mask if form == "mask_bool" else mask.astype(np.int8)
        kw["exclude_mask"], jkw["exclude_mask"] = torch.from_numpy(m), jnp.asarray(m)
    for off, nv in ((0, None), (500, 190)):
        s, i = ops.topk_score(torch.from_numpy(phi), p, 30, id_offset=off,
                              n_valid=nv, **kw)
        js, ji = jax_topk(jnp.asarray(phi), jp, 30, id_offset=off,
                          n_valid=nv, block_items=128, **jkw)
        _same((s, i), (js, ji))
    if form.startswith("mask"):
        assert (i[2] == -1).all() and torch.isneginf(s[2]).all()
    with pytest.raises(ValueError, match="not both"):
        ops.topk_score(torch.from_numpy(phi), p, 3,
                       torch.zeros(7, 203, dtype=torch.bool),
                       exclude_ids=torch.zeros(7, 1, dtype=torch.int32))


def test_int8_without_scale_and_bad_scale_raise():
    phi, psi = torch.zeros(2, 4), torch.zeros(6, 4, dtype=torch.int8)
    with pytest.raises(ValueError, match="psi_scale"):
        ops.topk_score(phi, psi, 2)
    with pytest.raises(ValueError, match="psi_scale has 5 rows"):
        ops.topk_score(phi, psi, 2, psi_scale=torch.ones(5))


# ---------------------------------------------------------------- kmeans
def test_lloyd_matches_reference_steps():
    """``_lloyd`` from the reference's own initial rows (the same
    ``jax.random.choice``) gives the reference's centroids and
    assignment on well-separated blobs."""
    psi = _clustered(240, 8, 6, seed=4, spread=10.0)
    c, iters, seed = 6, 5, 3
    jc, ja = jann.kmeans(jnp.asarray(psi), c, n_iters=iters, seed=seed)
    init = np.array(jax.random.choice(jax.random.PRNGKey(seed), 240, (c,),
                                      replace=False))
    t = torch.from_numpy(psi)
    pc, pa = ann._lloyd(t, t[torch.from_numpy(init)], iters)
    np.testing.assert_array_equal(pa.numpy(), np.asarray(ja))
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), rtol=RTOL, atol=ATOL)
    # the port's own seeding: distinct rows, deterministic, empty clusters
    # keep their centroid (more clusters than distinct rows)
    dup = torch.from_numpy(np.repeat(np.eye(4, 8, dtype=np.float32), 10, 0))
    cents, assign = ann.kmeans(dup, 16, n_iters=6, seed=3)
    again = ann.kmeans(dup, 16, n_iters=6, seed=3)
    assert torch.equal(cents, again[0]) and torch.equal(assign, again[1])
    assert cents.shape == (16, 8) and torch.isfinite(cents).all()
    assert 0 <= int(assign.min()) and int(assign.max()) < 16
    with pytest.raises(ValueError, match="n_clusters"):
        ann.kmeans(dup, 41)


# ---------------------------------------------------------------- layout
@pytest.mark.parametrize("q", QUANTS)
def test_index_from_numpy_layout_matches_reference(q):
    psi = _clustered(300, 16, 6, seed=5)
    ref, port = _pair(psi, jann.AnnConfig(n_clusters=6, quant=q, seed=6),
                      id_offset=1_000)
    _same_layout(port, ref)
    np.testing.assert_array_equal(port.centroids.numpy(), np.asarray(ref.centroids))
    assert port.psi_q.dtype == {"none": torch.float32, "bf16": torch.bfloat16,
                                "int8": torch.int8}[q]
    # the port's own build: same invariants (blocks in ascending id, the
    # inverse positions, the counts)
    own = ann.PsiIndex.build(torch.from_numpy(psi), ann.AnnConfig(
        n_clusters=6, quant=q, seed=6), id_offset=1_000)
    ids = own.ids_global.numpy().reshape(6, own.block_rows)
    for cl in range(6):
        blk = ids[cl][ids[cl] >= 0]
        assert len(blk) == own.counts[cl] and (np.diff(blk) > 0).all()
        assert (ids[cl][len(blk):] == -1).all()
    np.testing.assert_array_equal(own.ids_global.numpy()[own.inv_pos.numpy()],
                                  np.arange(1_000, 1_300))


# ----------------------------------------------------------------- query
@pytest.mark.parametrize("q", QUANTS)
def test_index_topk_matches_reference(q):
    """Pruned and oracle probes, with and without exclusions (some ids
    outside the index), ids exact."""
    psi = _clustered(240, 8, 6, seed=7)
    phi = _queries(6, 8, 8)
    ref, port = _pair(psi, jann.AnnConfig(n_clusters=6, quant=q, seed=9))
    eids = _exclude(6, 260, 30, 10)
    for n_probe in (2, 6):
        for ex in (None, eids):
            got = port.topk(torch.from_numpy(phi), 12, n_probe=n_probe,
                            exclude_ids=None if ex is None else torch.from_numpy(ex))
            want = ref.topk(jnp.asarray(phi), 12, n_probe=n_probe,
                            exclude_ids=None if ex is None else jnp.asarray(ex))
            _same(got, want)
    # the oracle probe is the exact path over the stored table
    if q == "none":
        _same(port.topk(torch.from_numpy(phi), 12, n_probe=6),
              topk_score_ref(torch.from_numpy(phi), torch.from_numpy(psi), 12))


def test_index_edges_match_reference():
    """Tie stability through the permutation in every storage form, every
    probed id excluded, out-of-range exclusions ignored."""
    row = np.random.default_rng(18).normal(size=16).astype(np.float32)
    tied = np.tile(row, (24, 1))
    phi = row[None, :] * 0.5
    for q in QUANTS:
        ref, port = _pair(tied, jann.AnnConfig(n_clusters=3, quant=q, seed=19))
        s, i = port.topk(torch.from_numpy(phi), 8, n_probe=3)
        assert (i.numpy()[0] == np.arange(8)).all(), q
        _same((s, i), ref.topk(jnp.asarray(phi), 8, n_probe=3))
    psi = _clustered(64, 8, 2, seed=10)
    ref, port = _pair(psi, jann.AnnConfig(n_clusters=2, seed=11))
    everything = torch.from_numpy(np.tile(np.arange(64, dtype=np.int32), (2, 1)))
    s, i = port.topk(torch.from_numpy(_queries(2, 8)), 4, n_probe=2,
                     exclude_ids=everything)
    assert (i == -1).all() and torch.isneginf(s).all()
    far = torch.full((2, 3), 10_000, dtype=torch.int32)
    base = port.topk(torch.from_numpy(_queries(2, 8)), 6, n_probe=2)
    _same(port.topk(torch.from_numpy(_queries(2, 8)), 6, n_probe=2,
                    exclude_ids=far), base, exact_scores=True)


def test_index_records_probe_counters_and_costs():
    """The probed-block counter keeps the reference's meaning (blocks in
    the probed union that hold rows); the kernel cost is ONE launch of the
    IVF form a query, over the rows it scored."""
    psi = _clustered(120, 8, 4, seed=12)
    port = ann.PsiIndex.build(torch.from_numpy(psi), ann.AnnConfig(
        n_clusters=4, n_probe=2, quant="int8"))
    reg = MetricsRegistry()
    phi = torch.from_numpy(_queries(1, 8))
    port.topk(phi, 5, registry=reg)
    assert reg.get("ann_queries_total") == 1
    probed = reg.get("ann_probed_blocks_total")
    assert 1 <= probed <= 2
    assert reg.get("kernel_calls_total", kernel="topk_score_ivf") == 1
    cost = topk_score_cost(1, port.block_rows, 8, 5, psi_bytes=1,
                           per_row_scale=True)
    assert cost["hbm_bytes"] == port.block_rows * (8 + 4) + 4 * 8 + 8 * 5
    # the IVF launch's bytes: the probed clusters' valid rows, their global
    # ids, the counts and the (B, C) probe mask
    with torch.no_grad():
        cs = (phi @ port.centroids.T)[0].numpy()
    top2 = np.argsort(-cs, kind="stable")[:2]
    rows = int(sum(port.counts[c] for c in top2))
    ivf = topk_score_ivf_cost(1, rows, 8, 5, 4, psi_bytes=1,
                              per_row_scale=True)
    assert ivf["hbm_bytes"] == topk_score_cost(
        1, rows, 8, 5, psi_bytes=1, per_row_scale=True)["hbm_bytes"] \
        + 4 * rows + 4 * 4 + 1 * 4
    assert reg.get("kernel_hbm_bytes_total", kernel="topk_score_ivf") == \
        ivf["hbm_bytes"]
    # at the oracle probe every block is probed: the rows are all of them
    before = reg.get("kernel_hbm_bytes_total", kernel="topk_score_ivf")
    port.topk(phi, 5, n_probe=4, registry=reg)
    every = topk_score_ivf_cost(1, int(port.counts.sum()), 8, 5, 4,
                                psi_bytes=1, per_row_scale=True)["hbm_bytes"]
    assert reg.get("kernel_hbm_bytes_total",
                   kernel="topk_score_ivf") - before == every
    assert reg.get("kernel_calls_total", kernel="topk_score_ivf") == 2
    assert reg.get("ann_probed_blocks_total") == probed + int(
        (port.counts > 0).sum())
    assert reg.get("ann_queries_total") == 2
    masked = topk_score_cost(3, 100, 8, 5, mask=True)["hbm_bytes"]
    assert masked - topk_score_cost(3, 100, 8, 5)["hbm_bytes"] == 3 * 100
    port.topk(phi, 5)   # None records nothing
    assert reg.get("ann_queries_total") == 2


# ------------------------------------------ the top-K kernel's IVF form
def _tied_pair(q, seed=40):
    """The port's index and the reference's over one hand-made clustering
    of integer ψ rows: 50 distinct rows drawn with repeats into 5 clusters
    of 3, 40, 60, 25 and 72 rows, so equal scores fall inside a block and
    across blocks in every storage form (equal rows quantize alike).
    Cluster 0's centroid points along the first axis."""
    rng = np.random.default_rng(seed)
    counts, d = (3, 40, 60, 25, 72), 8
    base = rng.integers(-2, 3, size=(50, d)).astype(np.float32)
    psi = base[rng.integers(0, 50, size=sum(counts))]
    assign = np.repeat(np.arange(5), counts)
    rng.shuffle(assign)
    cents = rng.normal(size=(5, d)).astype(np.float32)
    cents[0] = 0.0
    cents[0, 0] = 20.0
    jcfg = jann.AnnConfig(n_clusters=5, quant=q, seed=seed)
    port = ann.index_from_numpy(psi, cents, assign, _cfg(jcfg), device="cpu")
    psi_q = _np(port.psi_q)
    ref = jann.PsiIndex(
        cfg=jcfg, centroids=jnp.asarray(cents),
        psi_q=jnp.asarray(psi_q, jnp.bfloat16 if q == "bf16" else psi_q.dtype),
        scales=None if port.scales is None else jnp.asarray(_np(port.scales)),
        ids_global=jnp.asarray(_np(port.ids_global)),
        inv_pos=jnp.asarray(_np(port.inv_pos)), counts=port.counts.copy(),
        block_rows=port.block_rows, id_offset=0, n_rows=port.n_rows,
        staleness=0)
    return psi, ref, port


def _tied_queries(b=5, d=8, seed=41):
    """Integer φ rows; row 0 is the first axis (it probes cluster 0, of 3
    rows, first), row 1 a small multiple of it (many equal scores)."""
    phi = np.random.default_rng(seed).integers(-2, 3, size=(b, d))
    phi[0] = 0
    phi[0, 0] = 1
    phi[1] = 2 * phi[0]
    return phi.astype(np.float32)


def _per_block_loop(index, phi, k, n_probe, exclude_ids):
    """The port's former query, one plain top-K a probed block: a block's
    valid rows by position, the rows that did not probe it masked, the
    positions mapped to global ids, then the merge by (−score, global id)."""
    b, c = phi.shape[0], index.n_clusters
    cs = phi @ index.centroids.T
    sel = torch.sort(cs, dim=1, descending=True, stable=True).indices[:, :n_probe]
    probe = torch.zeros((b, c), dtype=torch.bool).scatter_(1, sel, True)
    ex = None
    if exclude_ids is not None:   # global ids → positions, as before
        e = torch.as_tensor(exclude_ids).long()
        ok = (e >= 0) & (e < index.n_rows)
        ex = torch.where(ok, index.inv_pos[e.clamp(0, index.n_rows - 1)], -1)
        ex = ex.to(torch.int32)
    parts_s, parts_i = [], []
    for cl in range(c):
        if not bool(probe[:, cl].any()) or index.counts[cl] == 0:
            continue
        lo = cl * index.block_rows
        hi = lo + int(index.counts[cl])
        ss, ii = topk_score_ref(
            phi, index.psi_q[lo:hi], k, exclude_ids=ex, id_offset=lo,
            psi_scale=None if index.scales is None else index.scales[lo:hi])
        m = probe[:, cl][:, None]
        ss = torch.where(m, ss, float("-inf"))
        ii = torch.where(m & (ii >= 0),
                         index.ids_global[ii.clamp(min=0).long()], -1)
        parts_s.append(ss)
        parts_i.append(ii)
    return ops.topk_merge_shards(torch.stack(parts_s), torch.stack(parts_i), k)


@pytest.mark.parametrize("q", QUANTS)
def test_ivf_form_ties_short_rows_and_wide_k_match_reference(q):
    """The IVF form against the reference's per-block loop: ties at the K
    boundary inside and across blocks, exclusion lists, a row whose probed
    cluster holds fewer than K rows (row 0 at n_probe 1), K = 257 (more
    than the index holds) and the oracle probe; ids exact."""
    psi, ref, port = _tied_pair(q)
    phi = _tied_queries()
    eids = _exclude(5, 230, 12, 42)
    eids[1, :3] = [int(port.ids_global[port.block_rows * 2]), -1, 7]
    for k, n_probe, ex in ((10, 1, None), (10, 2, eids), (257, 2, eids),
                           (12, 5, eids), (257, 5, None)):
        t_ex = None if ex is None else torch.from_numpy(ex)
        got = port.topk(torch.from_numpy(phi), k, n_probe=n_probe,
                        exclude_ids=t_ex)
        _same(got, ref.topk(jnp.asarray(phi), k, n_probe=n_probe,
                            exclude_ids=None if ex is None else jnp.asarray(ex)))
        _same(got, _per_block_loop(port, torch.from_numpy(phi), k, n_probe,
                                   t_ex), exact_scores=True)
        if n_probe == 1:   # row 0 probes cluster 0 only: 3 rows, then empty
            assert (got[1][0, 3:] == -1).all()
            assert torch.isneginf(got[0][0, 3:]).all()
    # the ties really straddle the boundary: row 1's 10th and 11th scores
    s, _ = port.topk(torch.from_numpy(phi), 11, n_probe=5)
    assert s[1, 9] == s[1, 10]


@pytest.mark.parametrize("q", QUANTS)
def test_ivf_form_after_delta_patches_appends_and_grow_matches_reference(q):
    """Patched rows keep their slot, appended ids join their nearest
    centroid's block at its tail (ascending global id), and a full block
    grows every block: the IVF form still equals the reference."""
    psi, ref, port = _tied_pair(q, seed=43)
    full = int(np.argmax(port.counts))
    assert port.counts[full] == port.block_rows     # an append grows it
    rng = np.random.default_rng(44)
    rows = rng.integers(-2, 3, size=(6, 8)).astype(np.float32)
    rows[2:] = _np(port.centroids)[full] * 3        # nearest to that block
    ids = np.asarray([4, 77, 200, 201, 202, 203], np.int64)
    r2 = ref.apply_delta(jnp.asarray(rows), ids)
    p2 = port.apply_delta(rows, ids)
    _same_layout(p2, r2)
    assert p2.block_rows > port.block_rows
    phi = _tied_queries(seed=45)
    eids = _exclude(5, 204, 10, 46)
    for k, n_probe in ((9, 2), (257, 5)):
        got = p2.topk(torch.from_numpy(phi), k, n_probe=n_probe,
                      exclude_ids=torch.from_numpy(eids))
        _same(got, r2.topk(jnp.asarray(phi), k, n_probe=n_probe,
                           exclude_ids=jnp.asarray(eids)))
        _same(got, _per_block_loop(p2, torch.from_numpy(phi), k, n_probe,
                                   torch.from_numpy(eids)), exact_scores=True)


@pytest.mark.parametrize("q", QUANTS)
def test_ivf_cluster_topk_matches_reference_by_form(q):
    """Two shards' indexes over the reference's k-means results: the
    sharded IVF top-K with exclusions (ids in both shards) at a pruned
    and at the oracle probe."""
    psi = _clustered(160, 8, 4, seed=47)
    jcfg = jann.AnnConfig(n_clusters=3, quant=q, seed=48)
    pairs = [_pair(psi[s * 80:(s + 1) * 80], jcfg, id_offset=s * 80)
             for s in range(2)]
    jt = jax_shard_psi(jnp.asarray(psi), 2)
    pt = shard_psi(torch.from_numpy(psi), 2)
    phi = _queries(4, 8, 49)
    eids = _exclude(4, 160, 20, 50)
    for n_probe in (1, 3):
        _same(ann.ivf_cluster_topk(pt, [p for _, p in pairs],
                                   torch.from_numpy(phi), 11, n_probe=n_probe,
                                   exclude_ids=torch.from_numpy(eids)),
              jann.ivf_cluster_topk(jt, [r for r, _ in pairs],
                                    jnp.asarray(phi), 11, n_probe=n_probe,
                                    exclude_ids=jnp.asarray(eids)))


def test_ivf_form_plain_version_matches_the_per_block_loop():
    """``topk_score_ivf``'s plain version against the per-block loop on
    random fp32 data, all-false and all-true probe masks, and an empty
    cluster."""
    psi = _clustered(200, 16, 5, seed=51)
    rng = np.random.default_rng(52)
    assign = rng.integers(0, 4, size=200)          # cluster 4 stays empty
    cents = rng.normal(size=(5, 16)).astype(np.float32)
    index = ann.index_from_numpy(psi, cents, assign, ann.AnnConfig(
        n_clusters=5), device="cpu")
    assert index.counts[4] == 0
    phi = torch.from_numpy(_queries(6, 16, 53))
    eids = torch.from_numpy(_exclude(6, 200, 15, 54))
    for n_probe in (2, 5):
        _same(index.topk(phi, 20, n_probe=n_probe, exclude_ids=eids),
              _per_block_loop(index, phi, 20, n_probe, eids))
    args = dict(counts=index.counts_dev, ids_global=index.ids_global,
                block_rows=index.block_rows)
    none = torch.zeros((6, 5), dtype=torch.bool)
    s, i = ops.topk_score_ivf(phi, index.psi_q, 7, probe_mask=none, **args)
    assert (i == -1).all() and torch.isneginf(s).all()
    every = torch.ones((6, 5), dtype=torch.uint8)
    _same(ops.topk_score_ivf(phi, index.psi_q, 7, probe_mask=every, **args),
          topk_score_ref(phi, torch.from_numpy(psi), 7))
    assert ops.topk_score.launches_ivf == 0         # CPU tensors never launch


def test_ann_recall_curve_matches_reference():
    psi = _clustered(320, 16, 8, seed=13)
    phi = _queries(10, 16, 14)
    ref, port = _pair(psi, jann.AnnConfig(n_clusters=8, seed=15))
    excl = [np.arange(r, r + 5) for r in range(10)]
    got = ann_recall_curve(port, torch.from_numpy(phi), torch.from_numpy(psi),
                           k=20, n_probes=(1, 2, 4, 8), exclude=excl)
    want = jax_recall_curve(ref, jnp.asarray(phi), jnp.asarray(psi), k=20,
                            n_probes=(1, 2, 4, 8), exclude=excl)
    assert got == want and got[-1]["recall@20"] == 1.0


# ----------------------------------------------------------------- delta
@pytest.mark.parametrize("q", QUANTS)
def test_apply_delta_matches_reference(q):
    """Patches re-quantize in place, appends join the nearest centroid,
    a full block grows by 8 rows, the hole rule raises."""
    psi = _clustered(40, 4, 2, seed=16)
    ref, port = _pair(psi, jann.AnnConfig(n_clusters=2, quant=q, seed=17))
    rng = np.random.default_rng(18)
    rows = (rng.normal(size=(14, 4)) * 5).astype(np.float32)
    ids = np.asarray([3, 39, *range(40, 52)], np.int64)   # 2 patches, 12 appends
    r2, p2 = ref.apply_delta(jnp.asarray(rows), ids), port.apply_delta(rows, ids)
    _same_layout(p2, ref2 := r2)
    assert p2.block_rows > port.block_rows and p2.staleness == 14
    phi = _queries(3, 4, 19)
    _same(p2.topk(torch.from_numpy(phi), 9, n_probe=2),
          ref2.topk(jnp.asarray(phi), 9, n_probe=2))
    with pytest.raises(ValueError, match="contiguous"):
        p2.apply_delta(rows[:1], [99])
    assert not p2.needs_reindex()
    assert p2.apply_delta(rows[:1], [0]).staleness == 15


def test_fold_delta_indexes_matches_reference():
    psi = _clustered(90, 8, 3, seed=20)
    rows = np.random.default_rng(21).normal(size=(3, 8)).astype(np.float32)
    ids = np.asarray([0, 40, 75], np.int64)                 # shards 0, 1, 2
    jcfg = jann.AnnConfig(n_clusters=2, seed=22, reindex_after=1)
    jt = jax_shard_psi(jnp.asarray(psi), 3)
    pt = shard_psi(torch.from_numpy(psi), 3)
    pairs = [_pair(psi[s * 30:(s + 1) * 30], jcfg, id_offset=s * 30)
             for s in range(3)]
    jt2 = jax_shard_psi(jnp.asarray(jpublish.apply_delta(psi, rows, ids)), 3)
    pt2 = shard_psi(apply_delta(torch.from_numpy(psi), rows, ids), 3)
    reg = MetricsRegistry()
    jidx = jann.fold_delta_indexes([r for r, _ in pairs], jt2, rows, ids, jcfg)
    pidx = ann.fold_delta_indexes([p for _, p in pairs], pt2, rows, ids,
                                  _cfg(jcfg), registry=reg)
    assert _total(reg, "ann_reindexes_total") == 0  # one row a shard: folded
    for p, r in zip(pidx, jidx):
        _same_layout(p, r)
    phi = _queries(4, 8, 23)
    _same(ann.ivf_cluster_topk(pt2, pidx, torch.from_numpy(phi), 9, n_probe=2),
          jann.ivf_cluster_topk(jt2, jidx, jnp.asarray(phi), 9, n_probe=2))
    # two rows into shard 0 spend its budget of 1: rebuilt from the table
    more = ann.fold_delta_indexes(pidx, pt2, rows[:2], [1, 2], _cfg(jcfg),
                                  registry=reg)
    assert _total(reg, "ann_reindexes_total") == 1 and more[0].staleness == 0
    assert more[1] is pidx[1] and more[2] is pidx[2]
    del jt


# --------------------------------------------------- publish helpers
def test_publish_apply_delta_matches_reference_and_raises():
    psi = np.random.default_rng(24).normal(size=(17, 6)).astype(np.float32)
    rows = np.arange(12, dtype=np.float32).reshape(2, 6)
    for r, i in ((rows, [3, 17]), (np.ones(6, np.float32), 0),
                 (np.stack([rows[0], 2 * rows[0]]), [18, 17]), (rows[:0], [])):
        if len(np.atleast_1d(i)) and max(np.atleast_1d(i)) == 18:
            base = apply_delta(torch.from_numpy(psi), rows[:1], [17])
            jbase = jpublish.apply_delta(psi, rows[:1], [17])
        else:
            base, jbase = torch.from_numpy(psi), psi
        out = apply_delta(base, r, i)
        np.testing.assert_array_equal(out.numpy(), jpublish.apply_delta(jbase, r, i))
    assert psi.shape == (17, 6)                      # the input is not changed
    row = np.ones(6, np.float32)
    for r, i, msg in ((row, 19, "hole"), (np.stack([row, row]), [3, 3], "duplicate"),
                      (row, -1, "negative"), (np.ones((2, 6), np.float32), [0],
                                              "rows must be")):
        with pytest.raises(ValueError, match=msg):
            apply_delta(torch.from_numpy(psi), r, i)
        with pytest.raises(ValueError, match=msg):
            jpublish.apply_delta(psi, r, i)


def test_psi_publisher_versions_match_reference():
    psi = np.random.default_rng(25).normal(size=(17, 6)).astype(np.float32)
    reg = MetricsRegistry()
    cl = ShardedRetrievalCluster(lambda c: torch.ones(len(c), 6), n_shards=3, k=5)
    jcl = JaxCluster(lambda c: jnp.ones((len(c), 6)), n_shards=3, k=5)
    pub = PsiPublisher(cl, lambda p: torch.from_numpy(psi * p), every=2,
                       registry=reg)
    jpub = jpublish.PsiPublisher(jcl, lambda p: jnp.asarray(psi * p), every=2)
    for ep in range(5):
        pub(ep, float(ep + 1))
        jpub(ep, float(ep + 1))
    assert pub.versions == jpub.versions == [(0, 1), (2, 2), (4, 3)]
    row = 10 * np.ones(6, np.float32)
    assert pub.publish_delta(row, 17) == jpub.publish_delta(row, 17) == 4
    assert pub.deltas == jpub.deltas == [(4, 1)]
    assert cl.n_items == 18 and int(cl.topk_phi(torch.from_numpy(row)[None]).ids[0, 0]) == 17
    np.testing.assert_array_equal(dense_table(cl.table).numpy(),
                                  np.asarray(jpublish.dense_table(jcl.table)))
    assert _total(reg, "serve_psi_version") == 4
    assert _total(reg, "serve_psi_publishes_total") == 3
    assert _total(reg, "serve_psi_delta_rows_total") == 1


def test_staged_rollout_promotes_good_and_rolls_back_bad():
    """The test_fault rollout, on the port's mesh and the reference's side
    by side: a good table promotes, a NaN table rolls back with the live
    version untouched, a caller policy can veto."""
    rng = np.random.default_rng(26)
    phi = rng.normal(size=(6, 8)).astype(np.float32)
    psi = rng.normal(size=(40, 8)).astype(np.float32)
    outcomes = []
    for mk, arr in ((FaultTolerantRetrievalMesh, torch.from_numpy),
                    (JaxMesh, jnp.asarray)):
        mesh = mk(lambda *_, a=arr: a(phi), n_shards=2, n_replicas=2, k=9,
                  psi_table=arr(psi))
        roll_cls = StagedRollout if mk is FaultTolerantRetrievalMesh else jpublish.StagedRollout
        rollout = roll_cls(mesh, mirror_phi=arr(phi))
        ok, report = rollout.publish(arr(psi * 0.5))
        assert ok and mesh.version == 2 and report["promoted_version"] == 2
        good = mesh.topk()
        ok2, report2 = rollout.publish(arr(np.full((40, 8), np.nan, np.float32)))
        assert not ok2 and not report2["checks"]["scores_finite"]
        assert mesh.version == 2
        np.testing.assert_array_equal(_np(mesh.topk().ids), _np(good.ids))
        assert not any(r.canary for row in mesh.replica_set.replicas for r in row)
        ok3, _ = roll_cls(mesh, mirror_phi=arr(phi), validate=lambda live, can: bool(
            (_np(live.ids) == _np(can.ids)).all())).publish(arr(psi[::-1].copy()))
        assert not ok3 and mesh.version == 2
        outcomes.append(([h[1] for h in rollout.history], good))
    assert outcomes[0][0] == outcomes[1][0] == [True, False]
    _same(outcomes[0][1], outcomes[1][1])
    _same(outcomes[0][1], topk_score_ref(torch.from_numpy(phi),
                                         torch.from_numpy(psi * 0.5), 9))
    mesh = FaultTolerantRetrievalMesh(n_shards=2, n_replicas=1, k=3,
                                      psi_table=torch.from_numpy(psi))
    with pytest.raises(RuntimeError, match="no canary"):
        mesh.promote_canary()
    mesh.begin_canary(torch.from_numpy(psi))
    with pytest.raises(RuntimeError, match="already staged"):
        mesh.begin_canary(torch.from_numpy(psi))
    with pytest.raises(RuntimeError, match="canary"):
        mesh.publish_delta(psi[0], 3)
    mesh.rollback_canary()
    with pytest.raises(RuntimeError, match="no canary"):
        mesh.rollback_canary()


# ------------------------------------------- engine / cluster / mesh wiring
def test_cluster_ivf_and_publish_delta_match_reference():
    """The cluster at the oracle probe, exact and IVF, before and after a
    delta (patches and an append, folded into the live indexes), with
    exclusions: equal to the reference's exact cluster."""
    psi = _clustered(240, 8, 4, seed=27)
    phi = _queries(6, 8, 28)
    cfg = dict(n_clusters=4, n_probe=4, seed=29)
    ex = ShardedRetrievalCluster(n_shards=3, k=10, psi_table=torch.from_numpy(psi))
    iv = ShardedRetrievalCluster(n_shards=3, k=10, retrieval="ivf",
                                 ann=ann.AnnConfig(**cfg),
                                 psi_table=torch.from_numpy(psi))
    jex = JaxCluster(n_shards=3, k=10, psi_table=jnp.asarray(psi))
    eids = np.tile(np.arange(20, dtype=np.int32), (6, 1))
    _same(iv.topk_phi(torch.from_numpy(phi), exclude_ids=torch.from_numpy(eids)),
          jex.topk_phi(jnp.asarray(phi), exclude_ids=jnp.asarray(eids)))
    rows = np.random.default_rng(30).normal(size=(3, 8)).astype(np.float32)
    ids = np.asarray([2, 100, 210], np.int64)
    for c in (ex, iv, jex):
        assert c.publish_delta(rows, ids) == 2
    assert iv._ivf[2][0].staleness == 1              # folded, not rebuilt
    for c in (ex, iv):
        _same(c.topk_phi(torch.from_numpy(phi), exclude_ids=torch.from_numpy(eids)),
              jex.topk_phi(jnp.asarray(phi), exclude_ids=jnp.asarray(eids)))
    mask = torch.zeros(6, 240, dtype=torch.bool)
    mask[:, 90:130] = True                           # spans a shard boundary
    jmask = jnp.asarray(mask.numpy())
    _same(ex.topk_phi(torch.from_numpy(phi), exclude_mask=mask),
          jex.topk_phi(jnp.asarray(phi), exclude_mask=jmask))
    with pytest.raises(ValueError, match="exclude_mask"):
        iv.topk_phi(torch.from_numpy(phi), exclude_mask=mask)
    with pytest.raises(ValueError, match="retrieval"):
        ShardedRetrievalCluster(retrieval="hnsw")
    assert ex.table.offsets == (0, 80, 160) and ex.table.d == 8
    assert tuple(ex.table.stacked().shape) == (3, 80, 8)


def test_mesh_ivf_and_publish_delta_match_reference():
    psi = _clustered(180, 8, 3, seed=31)
    phi = _queries(4, 8, 32)
    cfg = dict(n_clusters=3, n_probe=3, seed=33)
    jm = JaxMesh(n_shards=3, n_replicas=2, k=8, psi_table=jnp.asarray(psi))
    inj = FaultInjector()
    inj.fail(0, 0, "error")
    reg = MetricsRegistry()
    pm = FaultTolerantRetrievalMesh(n_shards=3, n_replicas=2, k=8,
                                    retrieval="ivf", ann=ann.AnnConfig(**cfg),
                                    injector=inj, registry=reg,
                                    psi_table=torch.from_numpy(psi))
    res = pm.topk_phi(torch.from_numpy(phi))
    _same(res, jm.topk_phi(jnp.asarray(phi)))
    assert res.coverage == 1.0 and pm.stats["failovers"] == 1
    assert reg.get("ann_queries_total") == 3
    row = 10 * _queries(1, 8, 34)[0]
    assert pm.publish_delta(row, 180) == jm.publish_delta(row, 180) == 2
    got = pm.topk_phi(torch.from_numpy(row)[None])
    _same(got, jm.topk_phi(jnp.asarray(row)[None]))
    assert int(got.ids[0, 0]) == 180
    for shard_replicas in pm.replica_set.replicas:
        assert all(rep.version == pm.version for rep in shard_replicas)
    # a patch keeps the geometry: the live indexes fold it in place
    assert pm.publish_delta(2 * row, 5) == 3 and pm._ivf[3][0].staleness == 1
    assert int(pm.topk_phi(torch.from_numpy(row)[None]).ids[0, 0]) == 5
    with pytest.raises(ValueError, match="exclude_mask"):
        pm.topk_phi(torch.from_numpy(phi), exclude_mask=torch.zeros(4, 181))


def test_engine_ivf_matches_reference_engine():
    psi = _clustered(200, 8, 4, seed=35)
    phi = _queries(5, 8, 36)
    for q in QUANTS:
        iv = RetrievalEngine(torch.from_numpy(psi), lambda x: x, k=12,
                             retrieval="ivf", ann=ann.AnnConfig(
                                 n_clusters=4, n_probe=4, quant=q, seed=37))
        stored = torch.zeros(200, 8)
        live = iv.index.ids_global >= 0
        deq = iv.index.psi_q.float()
        if iv.index.scales is not None:
            deq = deq * iv.index.scales[:, None]
        stored[iv.index.ids_global[live].long()] = deq[live]
        _same(iv.topk_phi(torch.from_numpy(phi)),
              jax_topk(jnp.asarray(phi), jnp.asarray(stored.numpy()), 12))
    assert iv.ann.quant == "int8" and iv.index.n_clusters == 4


# ------------------------------------------------------------------- twin
def test_serve_retrieval_twin_cli_on_cpu():
    from repro_torch.examples import serve_retrieval

    out = serve_retrieval.main(["--device", "cpu"])
    assert out["versions"] == [1, 2] and out["mesh_version"] == 2
    assert out["recall_curve"][-1]["recall@100"] == 1.0
    assert out["int8_recall"] > 0.9 and out["degraded_coverage"] == 0.75
