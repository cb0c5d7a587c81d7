"""The port's fused score + top-K (``repro_torch.kernels.topk_score``) held
against the JAX package's kernel and merge on the same numpy inputs.

On the CPU the port runs its plain version and the JAX kernel runs in
interpret mode. Tolerances: ids exactly; fp32 scores to rtol 1e-5 /
atol 1e-6, because the two sum the D products in different orders; the
tie and edge cases use small-integer φ/ψ, whose scores are exact in fp32
in any order, so there scores and ids must be equal. The kernel itself
runs only on the card: its tests are in ``test_torch_launch.py``, which
imports no JAX, so that they run where the card is."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.topk_score import topk_merge_shards as jax_merge
from repro.kernels.topk_score import topk_score as jax_topk
from repro.kernels.topk_score.ref import exclude_ids_to_mask as jax_mask
from repro.kernels.topk_score.ref import retrieval_topk as jax_retrieval
from repro_torch.kernels import vmem
from repro_torch.kernels.topk_score import ops, ref

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


def _normal(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _ints(shape, seed):
    return np.random.default_rng(seed).integers(-3, 4, shape).astype(np.float32)


def _exclude_lists(b, lo, hi, width, seed):
    rng = np.random.default_rng(seed)
    out = np.full((b, width), -1, np.int32)
    for r in range(b):
        n = int(rng.integers(0, width + 1))
        out[r, :n] = rng.choice(np.arange(lo, hi), size=n, replace=False)
    return out


def _port(phi, psi, k, **kw):
    eids = kw.pop("exclude_ids", None)
    s, i = ops.topk_score(torch.from_numpy(phi), torch.from_numpy(psi), k,
                          exclude_ids=None if eids is None
                          else torch.from_numpy(eids), **kw)
    return s.numpy(), i.numpy()


def _jax(phi, psi, k, **kw):
    eids = kw.pop("exclude_ids", None)
    s, i = jax_topk(jnp.asarray(phi), jnp.asarray(psi), k,
                    exclude_ids=None if eids is None else jnp.asarray(eids),
                    **kw)
    return np.asarray(s), np.asarray(i)


@pytest.mark.parametrize("exclude", [False, True])
def test_plain_matches_jax_topk_score(exclude):
    phi, psi = _normal((9, 16), 0), _normal((301, 16), 1)  # 301 % 128 != 0
    eids = _exclude_lists(9, 0, 301, 12, 2) if exclude else None
    before = ops.topk_score.launches
    s, i = _port(phi, psi, 17, exclude_ids=eids)
    js, ji = _jax(phi, psi, 17, exclude_ids=eids, block_items=128)
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_allclose(s, js, rtol=RTOL, atol=ATOL)
    assert s.dtype == np.float32 and i.dtype == np.int32
    assert ops.topk_score.launches == before  # CPU tensors never launch


def test_shard_meta_id_offset_and_n_valid():
    """A padded row-range shard emits GLOBAL ids and keeps pad rows and
    rows past n_valid inadmissible, as the JAX kernel does."""
    phi, psi = _normal((5, 8), 12), _normal((64, 8), 13)
    shard = np.pad(psi[40:], ((0, 8), (0, 0)))      # global rows [40, 64)
    eids = _exclude_lists(5, 30, 70, 6, 14)          # some ids outside
    for kw in ({}, {"exclude_ids": eids}):
        s, i = _port(phi, shard, 30, id_offset=40, n_valid=24, **kw)
        js, ji = _jax(phi, shard, 30, id_offset=40, n_valid=24,
                      block_items=32, **kw)
        np.testing.assert_array_equal(i, ji)
        np.testing.assert_allclose(s, js, rtol=RTOL, atol=ATOL)
        assert (i < 64).all() and ((i == -1) | (i >= 40)).all()


def test_ties_across_block_boundaries_rank_ascending_id():
    base = _ints((40, 6), 4)
    psi = np.concatenate([base, base, base])  # ids i, i+40, i+80 tie exactly
    phi = _ints((5, 6), 5)
    s, i = _port(phi, psi, 30)
    js, ji = _jax(phi, psi, 30, block_items=64)
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_array_equal(s, js)
    # and the policy itself: within equal scores, ids ascend
    for r in range(5):
        for a in range(29):
            if s[r, a] == s[r, a + 1]:
                assert i[r, a] < i[r, a + 1]


def test_fully_excluded_row_is_neginf_minus_one():
    phi, psi = _ints((4, 8), 6), _ints((40, 8), 7)
    eids = _exclude_lists(4, 0, 40, 10, 8)
    eids = np.pad(eids, ((0, 0), (0, 30)), constant_values=-1)
    eids[2] = np.arange(40)                       # row 2: nothing admissible
    s, i = _port(phi, psi, 12, exclude_ids=eids)
    js, ji = _jax(phi, psi, 12, exclude_ids=eids, block_items=128)
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_array_equal(s, js)
    assert (i[2] == -1).all() and np.isneginf(s[2]).all()
    for r in range(4):
        real = i[r][i[r] >= 0]
        assert not np.isin(real, eids[r]).any()


def test_k_larger_than_n_valid():
    phi, psi = _ints((3, 5), 8), _ints((16, 5), 9)
    s, i = _port(phi, psi, 20, n_valid=11)
    js, ji = _jax(phi, psi, 20, n_valid=11, block_items=128)
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_array_equal(s, js)
    assert (i[:, 11:] == -1).all() and np.isneginf(s[:, 11:]).all()


@pytest.mark.parametrize("n_rows,block_items", [(301, 128), (129, 64), (7, 128)])
def test_nondivisible_blocks(n_rows, block_items):
    phi, psi = _ints((6, 12), n_rows), _ints((n_rows, 12), n_rows + 1)
    k = min(10, n_rows + 3)
    s, i = _port(phi, psi, k, block_items=block_items)
    js, ji = _jax(phi, psi, k, block_items=block_items)
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_array_equal(s, js)


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4])
def test_merge_shards_matches_jax(n_shards):
    """Per-shard candidate lists with cross-shard ties and (−inf, −1)
    tails merge to the same (B, k) as the JAX two-key sort."""
    phi, psi = _ints((7, 4), 20), _ints((90, 4), 21)
    rows_per = -(-90 // n_shards)
    parts_s, parts_i = [], []
    for sh in range(n_shards):
        blk = psi[sh * rows_per:(sh + 1) * rows_per]
        n_valid = blk.shape[0]
        blk = np.pad(blk, ((0, rows_per - n_valid), (0, 0)))
        s, i = _port(phi, blk, 15, id_offset=sh * rows_per, n_valid=n_valid)
        parts_s.append(s)
        parts_i.append(i)
    ss, ii = np.stack(parts_s), np.stack(parts_i)
    for k in (15, 30, 15 * n_shards + 3):  # incl. k beyond the candidates
        ms, mi = ops.topk_merge_shards(torch.from_numpy(ss),
                                       torch.from_numpy(ii), k)
        js, ji = jax_merge(jnp.asarray(ss), jnp.asarray(ii), k)
        np.testing.assert_array_equal(mi.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(ms.numpy(), np.asarray(js))
    # the sharded result is the single-table result
    fs, fi = _port(phi, psi, 15)
    ms, mi = ops.topk_merge_shards(torch.from_numpy(ss), torch.from_numpy(ii), 15)
    np.testing.assert_array_equal(mi.numpy(), fi)
    np.testing.assert_array_equal(ms.numpy(), fs)


def test_exclude_ids_to_mask_matches_jax():
    eids = _exclude_lists(5, 0, 50, 7, 30)
    got = ref.exclude_ids_to_mask(torch.from_numpy(eids), 50).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_mask(jnp.asarray(eids), 50)))


@pytest.mark.parametrize("batched", [False, True])
def test_retrieval_topk_matches_jax(batched):
    table = _ints((500, 6), 31)
    users = _ints((3, 6) if batched else (6,), 32)
    s, i = ref.retrieval_topk(
        lambda ids: torch.from_numpy(users) @ torch.from_numpy(table)[ids.long()].T,
        500, k=40, chunk=77)
    js, ji = jax_retrieval(
        lambda ids: jnp.asarray(users) @ jnp.asarray(table)[ids].T,
        500, k=40, chunk=77)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    short_s, short_i = ref.retrieval_topk(
        lambda ids: torch.zeros(ids.shape[0]), 5, k=8, chunk=3)
    assert (short_i[5:] == -1).all() and torch.isneginf(short_s[5:]).all()


def test_block_items_budget_raises_instead_of_shrinking():
    assert vmem.TOPK_MAX_CHUNK == 256
    assert vmem.topk_smem_bytes(vmem.TOPK_MAX_CHUNK) <= vmem.SMEM_STATIC_BYTES
    assert vmem.topk_k_pad(100) == 128 and vmem.topk_k_pad(1) == 1
    # every table, the serving driver's shard and a small one alike, takes
    # full 256-row chunks (a narrower chunk for a small table lost at B = 16)
    assert vmem.topk_block_items(128) == 256
    assert vmem.topk_block_items(16) == 256 and vmem.topk_block_items(1) == 256
    with pytest.raises(ValueError):
        vmem.topk_block_items(0)
    # K above 256 takes the large-K path: chunks smaller than k_pad, whose
    # merge levels keep every key until lists reach k_pad
    assert vmem.topk_block_items(512) == 256
    assert vmem.topk_block_items(1024) == 256
    assert vmem.topk_block_items(8192) == 256
    # K past 8,192 no longer raises: k_pad 16,384 merges in device memory,
    # whose two key buffers hold the largest level a row writes
    assert vmem.topk_block_items(16384) == 256
    # 40,000 rows: 157 chunks of 256 (40,192 keys); an odd list's empty
    # partner pads each level, and the sixth writes 3 lists of 16,384
    assert vmem.topk_large_k_keys(157, 256, 16384) == 3 * 16384
    # at k_pad 8,192 the second level writes 40 lists of 1,024 (40,960
    # keys), more than pass 1's 40,192
    assert vmem.topk_large_k_keys(157, 256, 8192) == 40 * 1024
    assert vmem.topk_large_k_keys(1, 256, 512) == 256
    assert vmem.psi_row_bytes(128, psi_bytes=1, per_row_scale=True) == 132
    assert vmem.shard_capacity_rows(512 * 132, 128, psi_bytes=1,
                                    per_row_scale=True) == 512
    assert vmem.shard_capacity_rows(512 * 132, 128) == 132
    with pytest.raises(vmem.VmemBudgetError, match="minimal 8-row"):
        vmem.fit_block_rows(8 * 1024, budget=16 * 1024)
    with pytest.raises(vmem.VmemBudgetError, match="minimal"):
        vmem.fit_block_rows(1024, fixed_bytes=48 * 1024)
    assert vmem.fit_block_rows(100, n_rows=20) == 24


def test_mixed_devices_and_bad_inputs_raise():
    with pytest.raises(ValueError, match="one device"):
        ops.topk_score(torch.zeros(2, 3), torch.zeros(4, 3, device="meta"), 2)
