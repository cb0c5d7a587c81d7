"""Shared-memory and register budget for the Hopper kernels (port of
``repro.kernels.vmem``, re-derived for an H100).

A TPU kernel fits its tiles into ~16 MiB of VMEM; a Hopper block has at
most 227 KB of shared memory (232,448 bytes, above 48 KB only as dynamic
shared memory after an opt-in) and 65,536 registers per SM, at most 1,024
threads a block. The tiles are therefore far smaller, and the sizes the
kernels are compiled with are derived here, in one place: ``kernel.py``
passes them to ``nvcc`` as ``-D`` flags, so the source and this budget
cannot drift apart.

The rule from the reference stays: a tile that does not fit raises
:class:`VmemBudgetError`; nothing shrinks below what the caller asked for
in silence.
"""
from __future__ import annotations

SMEM_STATIC_BYTES = 48 * 1024     # static __shared__ arrays, no opt-in
SMEM_BLOCK_MAX = 232_448          # dynamic shared memory a block can opt into

# topk_score geometry (csrc/topk_score.cu). A pass-1 block scores one chunk
# of ψ rows (one thread per row) against TOPK_ROW_BLOCK φ rows, staging ψ
# through shared memory TOPK_D_SLAB columns at a time, and a warp sorts a
# row's chunk keys in registers, 8 a lane (TOPK_SORT_KEYS in all); pass 2
# merges TOPK_MERGE_SLOTS candidate lists at a time per φ row.
TOPK_ROW_BLOCK = 16
TOPK_D_SLAB = 32
TOPK_SORT_KEYS = 32 * 8
TOPK_MERGE_SLOTS = 16
TOPK_MERGE_THREADS = 256
_KEY_BYTES = 8                    # packed (−score, id) sort key


class VmemBudgetError(ValueError):
    """The requested tile cannot fit the shared-memory budget."""


def fit_block_rows(
    per_row_bytes: int,
    *,
    fixed_bytes: int = 0,
    n_rows: int | None = None,
    budget: int | None = None,
    multiple: int = 8,
    lo: int = 8,
    hi: int = 2048,
) -> int:
    """Largest row tile (a multiple of ``multiple`` in [lo, hi]) whose
    footprint ``fixed_bytes + rows·per_row_bytes`` fits ``budget``
    (default :data:`SMEM_STATIC_BYTES`). ``n_rows`` caps the tile at the
    padded problem size. Raises :class:`VmemBudgetError` when even the
    ``lo``-row tile does not fit."""
    if budget is None:
        budget = SMEM_STATIC_BYTES
    if fixed_bytes + lo * per_row_bytes > budget:
        raise VmemBudgetError(
            f"minimal {lo}-row tile does not fit the shared-memory budget: "
            f"fixed_bytes={fixed_bytes} + {lo} rows * {per_row_bytes} B/row "
            f"= {fixed_bytes + lo * per_row_bytes} > budget={budget}"
        )
    rows = min((budget - fixed_bytes) // max(1, per_row_bytes), hi)
    if n_rows is not None:
        rows = min(rows, -(-n_rows // multiple) * multiple)
    return max(lo, (rows // multiple) * multiple)


def _pow2_floor(x: int) -> int:
    return 1 << (int(x).bit_length() - 1)


def _pow2_ceil(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


def topk_k_pad(k: int) -> int:
    """Slots a candidate list holds: the next power of two ≥ k (the
    bitonic networks sort power-of-two lengths)."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    return _pow2_ceil(k)


def topk_smem_bytes(chunk: int) -> int:
    """Static shared memory of one pass-1 block for a ``chunk``-row ψ
    chunk: the φ slab, plus one pool that first holds the transposed ψ
    slab (pitch chunk+1 against bank conflicts) and then the
    (TOPK_ROW_BLOCK, chunk) sort keys, rows padded by one key in 8."""
    phi_slab = 4 * TOPK_D_SLAB * TOPK_ROW_BLOCK
    pool = max(4 * TOPK_D_SLAB * (chunk + 1),
               _KEY_BYTES * TOPK_ROW_BLOCK * (chunk + chunk // 8))
    return phi_slab + pool


def topk_max_chunk() -> int:
    """Largest power-of-two ψ chunk a pass-1 block can hold in static
    shared memory, and at most TOPK_SORT_KEYS (the keys a warp sorts in
    registers). One thread scores one ψ row, so the chunk is also the
    block's thread count, which ``__launch_bounds__`` in the source turns
    into the register cap (65,536 registers / chunk threads)."""
    per_row = max(4 * TOPK_D_SLAB, _KEY_BYTES * TOPK_ROW_BLOCK * 9 // 8)
    fixed = 4 * TOPK_D_SLAB * TOPK_ROW_BLOCK + 4 * TOPK_D_SLAB
    rows = fit_block_rows(per_row, fixed_bytes=fixed, multiple=32, lo=32,
                          hi=TOPK_SORT_KEYS)
    return _pow2_floor(rows)


# compiled into the kernel as TOPK_MAX_CHUNK (256 under the 48 KB budget)
TOPK_MAX_CHUNK = topk_max_chunk()


# Large K (k_pad > TOPK_MAX_CHUNK): pass 1 keeps whole sorted chunks and the
# merge levels, pairwise in device memory, keep every key until lists reach
# k_pad, then the first k_pad.
def topk_large_k_keys(n_chunks: int, chunk: int, k_pad: int) -> int:
    """Keys a φ row needs in each of the two candidate buffers of the
    large-K merge. A level merges lists in pairs into lists of
    min(2·len, k_pad), an odd last list against an empty partner, so a
    level may write more than it read: the buffers hold the largest."""
    keys = n_chunks * chunk
    n, length = n_chunks, chunk
    while n > 1:
        length, n = min(2 * length, k_pad), -(-n // 2)
        keys = max(keys, n * length)
    return keys


def topk_block_items(k_pad: int) -> int:
    """ψ rows per pass-1 block for the ``topk_score`` kernel (the
    counterpart of the TPU kernel's ``block_items``): TOPK_MAX_CHUNK for
    every K and table.

    Up to TOPK_MAX_CHUNK, a block keeps the best ``k_pad`` keys of its
    chunk, and pass 2 holds TOPK_MERGE_SLOTS lists of ``k_pad`` keys; above
    it (large K) a chunk keeps all its rows and is smaller than ``k_pad``
    (:func:`topk_large_k_keys`). A table smaller than a chunk still takes
    the full chunk: a chunk's warps share the φ rows' sorts, so at B = 16 a
    narrower chunk lost up to 3× (``chip_smoke.py`` phase 17). Any K fits:
    the device memory of the key buffers is the only limit, and the
    wrapper checks it."""
    topk_k_pad(k_pad)
    return TOPK_MAX_CHUNK


# The exact form in one launch (csrc/topk_score.cu, topk_fused_kernel), for
# k_pad ≤ TOPK_MAX_CHUNK: blocks of TOPK_FUSED_THREADS threads (TF_HALVES =
# threads / TOPK_MAX_CHUNK share a ψ row of each chunk), at most
# TOPK_FUSED_MIN_BLOCKS of them an SM (the register cap __launch_bounds__
# sets), in clusters of TOPK_FUSED_CLUSTER blocks whose shared memory holds
# the running lists the cluster merges; the exclusion ids of a block's φ
# rows are staged in shared memory up to TOPK_FUSED_EXCL_STAGE a row. The
# values are the fastest of ``chip_smoke.py --topk-tune``'s variants at the
# serving shard (PERF.md).
TOPK_FUSED_THREADS = 512
TOPK_FUSED_MIN_BLOCKS = 2
TOPK_FUSED_CLUSTER = 8
TOPK_FUSED_EXCL_STAGE = 256
TOPK_FUSED, TOPK_CHAIN = "fused", "chain"


def topk_fused_list(k_pad: int) -> int:
    """Keys a running list of the fused form holds: 128 (4 a lane) while
    k_pad allows, else 256 (8 a lane); a merge of two lists costs one
    bitonic merge level of that width."""
    return 128 if k_pad <= 128 else 256


def topk_fused_blocks(n_rows: int, n_sms: int, *,
                      min_blocks: int = TOPK_FUSED_MIN_BLOCKS,
                      cluster: int = TOPK_FUSED_CLUSTER) -> int:
    """Blocks of one fused launch along the ψ rows: one a chunk of
    TOPK_MAX_CHUNK rows up to ``min_blocks`` an SM of the card's ``n_sms``
    (beyond, a block walks several chunks), a whole number of clusters,
    at least one."""
    chunks = -(-max(0, int(n_rows)) // TOPK_MAX_CHUNK)
    cap = max(cluster, min_blocks * int(n_sms) // cluster * cluster)
    return min(max(cluster, -(-chunks // cluster) * cluster), cap)


def topk_fused_smem_bytes(n_excl: int, k_pad: int = TOPK_MAX_CHUNK, *,
                          threads: int = TOPK_FUSED_THREADS,
                          cluster: int = TOPK_FUSED_CLUSTER) -> int:
    """Dynamic shared memory of one fused block: the running lists
    (TOPK_ROW_BLOCK × :func:`topk_fused_list` keys), one pool that holds
    the transposed ψ slab, then the chunk's keys, then the merges' partial
    lists, the φ slab, a flag, each row's bound and 32 lane minima, and
    the staged exclusion ids."""
    lw = topk_fused_list(k_pad)
    key_pitch = TOPK_MAX_CHUNK + TOPK_MAX_CHUNK // 8
    rows_merged = TOPK_ROW_BLOCK // cluster
    warps_a_row = threads // 32 // rows_merged
    pool = max(4 * TOPK_D_SLAB * (TOPK_MAX_CHUNK + 1),
               _KEY_BYTES * TOPK_ROW_BLOCK * key_pitch,
               _KEY_BYTES * rows_merged * warps_a_row * lw)
    misc = 16 + (_KEY_BYTES * (1 + 32) + 4) * TOPK_ROW_BLOCK  # flag, bounds, minima
    staged = n_excl if n_excl <= TOPK_FUSED_EXCL_STAGE else 0
    return (_KEY_BYTES * TOPK_ROW_BLOCK * lw + pool
            + 4 * TOPK_D_SLAB * TOPK_ROW_BLOCK + misc + 4 * TOPK_ROW_BLOCK * staged)


def topk_form(k: int, form=None) -> str:
    """The exact form's launch form: :data:`TOPK_FUSED` (one launch) for
    k_pad ≤ TOPK_MAX_CHUNK unless the caller names :data:`TOPK_CHAIN`, the
    three-launch chain it replaced (pass 1, then merge levels); K above
    TOPK_MAX_CHUNK takes the chain with its device-memory merges."""
    if form not in (None, TOPK_FUSED, TOPK_CHAIN):
        raise ValueError(f"form must be {TOPK_FUSED!r} or {TOPK_CHAIN!r}, got {form!r}")
    if topk_k_pad(k) > TOPK_MAX_CHUNK:
        if form == TOPK_FUSED:
            raise ValueError(f"k={k}: the fused form holds k_pad ≤ {TOPK_MAX_CHUNK}")
        return TOPK_CHAIN
    return form or TOPK_FUSED


def psi_row_bytes(d: int, *, psi_bytes: int = 4,
                  per_row_scale: bool = False) -> int:
    """Device-memory bytes one ψ catalogue row occupies in serving
    storage: ``d·psi_bytes`` plus the fp32 per-row scale (int8 form)."""
    return d * psi_bytes + (4 if per_row_scale else 0)


def shard_capacity_rows(hbm_bytes: int, d: int, *, psi_bytes: int = 4,
                        per_row_scale: bool = False) -> int:
    """ψ rows one shard device can hold in ``hbm_bytes`` of slab budget:
    int8 with its per-row scale at D = 128 holds 512/132 ≈ 3.9× the fp32
    rows."""
    return hbm_bytes // psi_row_bytes(
        d, psi_bytes=psi_bytes, per_row_scale=per_row_scale)


# ---------------------------------------------------------------------------
# Gram (csrc/gram.cu). J is cut into GRAM_PANEL-wide panels; a block owns one
# panel pair on or below the diagonal (one diagonal panel for k ≤ 128, so X
# is read once) over one range of rows, and streams the rows through a ring
# of GRAM_STAGES stages of GRAM_CHUNK rows in dynamic shared memory (the
# pair's column strips and the rows' weights). A diagonal block has 128
# threads (the lower triangle's 136 tiles of 8 × 8, folded), an
# off-diagonal one 256. __launch_bounds__ lets GRAM_BLOCKS_PER_SM diagonal
# blocks share an SM (the register cap it implies must hold the 68
# accumulators and two sets of operands). The rows are split so that about
# GRAM_TARGET_BLOCKS diagonal blocks (all resident at once on an H100's
# 132 SMs) share the work, but no split has fewer than
# GRAM_MIN_SPLIT_CHUNKS chunks: each split costs a partial triangle that
# the second pass reads back, summing the splits in GRAM_REDUCE_RUNS
# interleaved runs, in a fixed order. The sizes are the fastest of
# ``chip_smoke.py --gram-tune``'s variants at icd-mf's two shapes (PERF.md).
# ---------------------------------------------------------------------------
GRAM_PANEL = 128
GRAM_CHUNK = 16
GRAM_STAGES = 6
GRAM_DIAG_THREADS = 128
GRAM_BLOCKS_PER_SM = 3
GRAM_TARGET_BLOCKS = 2 * 132
GRAM_MIN_SPLIT_CHUNKS = 32
GRAM_REDUCE_RUNS = 8
SM_SMEM_BYTES = 233_472            # shared memory of one H100 SM (228 KB)
SMEM_PER_BLOCK_RESERVED = 1024     # the runtime's share of each block


def gram_smem_bytes(strips: int) -> int:
    """Dynamic shared memory of one Gram block: GRAM_STAGES stages, each
    GRAM_CHUNK rows of ``strips`` GRAM_PANEL-column strips (1 on the
    diagonal, 2 off it) and the chunk's weights."""
    return 4 * GRAM_STAGES * (strips * GRAM_CHUNK * GRAM_PANEL + GRAM_CHUNK)


assert gram_smem_bytes(2) <= SMEM_BLOCK_MAX
assert GRAM_BLOCKS_PER_SM * (gram_smem_bytes(1) + SMEM_PER_BLOCK_RESERVED) \
    <= SM_SMEM_BYTES
assert TOPK_FUSED_MIN_BLOCKS * (topk_fused_smem_bytes(TOPK_FUSED_EXCL_STAGE)
                                + SMEM_PER_BLOCK_RESERVED) <= SM_SMEM_BYTES
assert topk_fused_smem_bytes(TOPK_FUSED_EXCL_STAGE) <= SMEM_BLOCK_MAX
assert 65_536 // (GRAM_BLOCKS_PER_SM * GRAM_DIAG_THREADS) >= 128  # registers


def gram_row_splits(rows: int, k: int) -> tuple:
    """``(splits, rows_per_split)`` for one Gram launch: enough row splits
    to give the card about GRAM_TARGET_BLOCKS diagonal blocks, each split a
    whole number of staged chunks and at least GRAM_MIN_SPLIT_CHUNKS of
    them where the rows allow. The second pass sums the splits in a fixed
    order, so the result depends only on ``rows`` and ``k``."""
    panels = -(-k // GRAM_PANEL)
    chunks = max(1, -(-rows // GRAM_CHUNK))
    splits = max(1, min(-(-GRAM_TARGET_BLOCKS // panels),
                        chunks // GRAM_MIN_SPLIT_CHUNKS))
    rows_per_split = -(-chunks // splits) * GRAM_CHUNK
    return -(-max(rows, 1) // rows_per_split), rows_per_split


# ---------------------------------------------------------------------------
# Block sweep (csrc/cd_sweep.cu), in two launch forms.
#
# Warp-row form: one warp owns one row; a block of warps keeps each row's
# e, α and a ψ_j scratch row (and ids, in the gather form) of D_pad slots
# plus its R' and W slabs (k_b each) in dynamic shared memory, beside either
# one shared (k_b, k_b) Gram block or, in the row-patch form, each row's own
# (k_b, k_b) patch P. The ψ slab of the gather form is not resident: the
# kernel reads it through L2 (the TPU kernel's "slab fits VMEM" rule does
# not carry over).
#
# Block-row form, for rows too long for that: one thread block of
# CD_BLOCK_ROW_THREADS threads owns one row; e, α and ids stay in device
# memory and are read on each of the row's k_b steps, and shared memory
# holds only the row's coupling block (J or P), R', W and the reduction's
# per-warp partial sums.
#
# cd_sweep_form picks the form: the register-row form below for the gather
# sweep and the pre-gathered row-patch sweep where it takes the row, else
# warp-row when one row fits a block's shared memory; beyond that the
# split-row form below for those sweeps at k_b ≤ CDG_KB, block-row
# otherwise (the pre-gathered shared-J sweep keeps warp-row and block-row).
# VmemBudgetError is left for what no form can launch (a k_b whose k_b × k_b
# block alone overflows a block).
# ---------------------------------------------------------------------------
CD_SWEEP_SMEM_TARGET = 96 * 1024  # two blocks per SM's 228 KB
CD_SWEEP_MAX_ROWS = 8             # warps (rows) per block
CD_BLOCK_ROW_THREADS = 1024       # threads of one block-row block
WARP_ROW, BLOCK_ROW = "warp_row", "block_row"


def cd_sweep_smem_bytes(d_pad: int, k_b: int, rows: int, *,
                        gather: bool, rowpatch: bool = False) -> int:
    """Dynamic shared memory of one warp-row block of ``rows`` rows: the
    shared J block, or, in the row-patch form, k_b² floats a row for the
    row's own patch P."""
    patch = k_b * k_b
    per_row = 4 * (2 * k_b + (patch if rowpatch else 0)
                   + (4 if gather else 3) * d_pad)
    return (0 if rowpatch else 4 * patch) + rows * per_row


def cd_sweep_block_row_smem_bytes(k_b: int) -> int:
    """Dynamic shared memory of one block-row block: the row's coupling
    block (J or P), R' and W, and two partial sums per warp."""
    return 4 * (k_b * k_b + 2 * k_b + 2 * (CD_BLOCK_ROW_THREADS // 32))


# ---------------------------------------------------------------------------
# The redesigned forms (csrc/cd_gather.cu), gathered and, for the row-patch
# sweep, the slab reduce and the residual patch, also from the pre-gathered
# tile. Register-row sweep and one-tile slab reduce: a group of `lanes`
# threads owns a row and every thread holds `slots` slots' e, α and k_b ≤
# CDG_KB ψ values in registers for the whole launch (the slab reduce: Q and
# P's upper triangle, 44 sums at m ≤ 8, 54 in its m = 9 instance, which has
# its own blocks an SM and slots in flight); shared memory holds only the
# coupling block (the shared J, or each row's patch P) and per-warp partial
# sums. Blocks have CDG_THREADS threads; __launch_bounds__ asks for
# CDG_*_MIN_BLOCKS of them an SM. A sweep thread of more than
# CDG_SWEEP_REG_SLOTS slots re-reads ψ_j from L1 a step ahead instead of
# holding it. Split-row sweep (rows
# longer than a block's shared memory): pass 1 gives each chunk of a row one
# block, which writes the chunk's 44 moments to a scratch; a solve runs the
# k_b steps on them; pass 2 is the residual patch. The residual patch's
# register-slot form gives a thread CDG_PATCH_SLOTS consecutive slots. The
# values are the fastest of ``chip_smoke.py --sweep-tune``'s variants (the
# m = 9 slab reduce's: ``--slab-tune``) at the full-width shapes (PERF.md).
# ---------------------------------------------------------------------------
CDG_THREADS = 256
CDG_KB = 8                          # block columns held in registers
CDG_SWEEP_LANES = (8, 16, 32, 64, 128, 256)   # compiled group sizes
CDG_SWEEP_SLOTS = (4, 8, 16)                  # compiled slots a thread
CDG_SWEEP_WARP_SLOTS = 4            # slots a thread while a row fits a warp
CDG_SWEEP_MAX_SLOTS = 8             # beyond: the form's longest row 256 × 8
CDG_SWEEP_MIN_LANES = 8
CDG_SWEEP_MIN_BLOCKS = 3
CDG_SWEEP_REG_SLOTS = 4             # ψ in registers up to this many slots
CDG_SLAB_LANES = (8, 16, 32)        # compiled group sizes (32 only at m = 9)
CDG_SLAB_MIN_BLOCKS = 3
CDG_SLAB_INFLIGHT = 2               # slots a thread gathers at once
CDG_KB_WIDE = 9                     # the slab reduce's wide instance: m = 9
CDG_SLAB_WIDE_MIN_BLOCKS = 2        # the m = 9 instance's blocks an SM
CDG_SLAB_WIDE_INFLIGHT = 4          # and its slots in flight
CDG_NSUM = CDG_KB + CDG_KB * (CDG_KB + 1) // 2   # Q and P's triangle: 44
CDG_SPLIT_CHUNK = 4_096             # most slots a split-row pass-1 block
CDG_SPLIT_TARGET_BLOCKS = 4 * 132   # pass-1 blocks to aim for: 4 an SM
CDG_PATCH_SLOTS = 4                 # residual patch: slots a thread
REG_ROW, SPLIT_ROW = "reg_row", "split_row"
SLAB_ONE_TILE, SLAB_TILED = "one_tile", "tiled"
PATCH_REG_SLOTS, PATCH_ONE_SLOT = "reg_slots", "one_slot"


def cd_sweep_reg_group(d_pad: int, k_b: int):
    """``(lanes, slots)`` of the register-row sweep for rows of ``d_pad``
    slots: while a row fits one warp at CDG_SWEEP_WARP_SLOTS slots a
    thread, the fewest lanes (a power of two, at least
    CDG_SWEEP_MIN_LANES) that hold it so; a longer row takes
    CDG_SWEEP_MAX_SLOTS slots a thread and the fewest warps that hold it
    (each extra warp costs a barrier a step, so it packs more slots a
    thread). None where the form does not take the row (k_b > CDG_KB, or
    more than CDG_THREADS · CDG_SWEEP_MAX_SLOTS slots): those rows keep
    the shared-memory forms (:func:`cd_sweep_form`). The same sizing
    serves both couplings."""
    if k_b > CDG_KB or d_pad < 1:
        return None
    lanes = max(CDG_SWEEP_MIN_LANES, _pow2_ceil(-(-d_pad // CDG_SWEEP_WARP_SLOTS)))
    if lanes <= 32:
        return lanes, CDG_SWEEP_WARP_SLOTS
    lanes = _pow2_ceil(-(-d_pad // CDG_SWEEP_MAX_SLOTS))
    return (lanes, CDG_SWEEP_MAX_SLOTS) if lanes <= CDG_THREADS else None


def cd_sweep_reg_smem_bytes(lanes: int = CDG_THREADS, *,
                            rowpatch: bool = False) -> int:
    """Static shared memory of one register-row block of ``lanes``-thread
    groups: the J block (a row patch: one block a group) and two
    double-buffered partial sums per warp."""
    blocks = CDG_THREADS // lanes if rowpatch else 1
    return 4 * (blocks * CDG_KB * CDG_KB + 4 * (CDG_THREADS // 32))


def cd_sweep_split_chunk(d_pad: int, n_rows: int) -> int:
    """Slots a pass-1 block of the split-row sweep takes from its row: at
    most CDG_SPLIT_CHUNK, fewer where the rows would otherwise give the
    card fewer than CDG_SPLIT_TARGET_BLOCKS blocks, a multiple of
    CDG_THREADS. A row has ⌈d_pad / chunk⌉ chunks."""
    want = -(-max(1, d_pad * n_rows) // CDG_SPLIT_TARGET_BLOCKS)
    return min(CDG_SPLIT_CHUNK, -(-want // CDG_THREADS) * CDG_THREADS)


def cd_sweep_split_smem_bytes() -> int:
    """Static shared memory of one split-row pass-1 block: the 44 sums of
    each warp."""
    return 4 * (CDG_THREADS // 32) * CDG_NSUM


def cd_resid_patch_form(d_pad: int, m: int, *, gather: bool) -> str:
    """:data:`PATCH_REG_SLOTS` for the gather residual patch at m ≤ CDG_KB
    and D_pad a multiple of 4 (a thread's slots loaded four at a time;
    the wrapper also needs ids and e 16-byte aligned), else
    :data:`PATCH_ONE_SLOT` (``csrc/cd_slab.cu``, one slot a thread)."""
    ok = gather and m <= CDG_KB and d_pad % 4 == 0
    return PATCH_REG_SLOTS if ok else PATCH_ONE_SLOT


def cd_slab_reduce_form(m: int) -> str:
    """:data:`SLAB_ONE_TILE` for the slab reduce at m ≤ CDG_KB_WIDE (an
    instance at m ≤ 8 and one at FM's m = k_b + 1 = 9), in either ψ
    routing (Q and P's triangle in registers, each slot read once; its m
    values gathered through the ids, or read from the pre-gathered tile),
    else :data:`SLAB_TILED` (``csrc/cd_slab.cu``'s tile loop, any m, both
    routings)."""
    return SLAB_ONE_TILE if m <= CDG_KB_WIDE else SLAB_TILED


def cd_slab_reduce_lanes(d_pad: int) -> int:
    """Threads a row of the one-tile slab reduce: 32, whatever the row.
    At 32 lanes a thread sums the slots d ≡ lane (mod 32) in order and
    the transpose-reduce's trees are the butterfly's, so the form gives
    the tiled form's bits. 8 and 16 lanes (compiled at m ≤ 8 for
    ``chip_smoke.py --sweep-tune``) took up to 22% less time at icd-mf's
    shapes but sum in another order (PERF.md, kernel table row 7); the
    m = 9 instance is compiled at 32 lanes only."""
    return 32


def cd_sweep_form(d_pad: int, k_b: int, *, gather: bool,
                  rowpatch: bool = False) -> str:
    """The launch form of one sweep. The gather sweep (either coupling)
    and the pre-gathered row-patch sweep take :data:`REG_ROW` where
    :func:`cd_sweep_reg_group` takes the row, else :data:`WARP_ROW` when
    one row fits a block's shared memory, else :data:`SPLIT_ROW` at k_b ≤
    CDG_KB. The pre-gathered shared-J sweep takes :data:`WARP_ROW` while a
    row fits. What is left takes :data:`BLOCK_ROW`. Raises
    :class:`VmemBudgetError` when no form can launch."""
    redesigned = gather or rowpatch
    if redesigned and cd_sweep_reg_group(d_pad, k_b) is not None:
        return REG_ROW
    if cd_sweep_smem_bytes(d_pad, k_b, 1, gather=gather,
                           rowpatch=rowpatch) <= SMEM_BLOCK_MAX:
        return WARP_ROW
    if redesigned and k_b <= CDG_KB:
        return SPLIT_ROW
    need = cd_sweep_block_row_smem_bytes(k_b)
    if need > SMEM_BLOCK_MAX:
        raise VmemBudgetError(
            f"k_b={k_b} does not fit the block sweep in either form: the "
            f"block-row form needs {need} B > {SMEM_BLOCK_MAX} B; lower k_b")
    return BLOCK_ROW


def _cd_sweep_rows(d_pad: int, k_b: int, n_rows, gather: bool,
                   rowpatch: bool = False) -> int:
    one = cd_sweep_smem_bytes(d_pad, k_b, 1, gather=gather, rowpatch=rowpatch)
    if one > SMEM_BLOCK_MAX:
        raise VmemBudgetError(
            f"one block-sweep row does not fit a block's shared memory: "
            f"D_pad={d_pad}, k_b={k_b} need {one} B > {SMEM_BLOCK_MAX} B; "
            "degree-bucket the rows or lower k_b")
    fixed = cd_sweep_smem_bytes(d_pad, k_b, 0, gather=gather,
                                rowpatch=rowpatch)
    per_row = one - fixed
    rows = (CD_SWEEP_SMEM_TARGET - fixed) // per_row
    rows = max(1, min(CD_SWEEP_MAX_ROWS, rows))
    if n_rows is not None:
        rows = max(1, min(rows, n_rows))
    return rows


def cd_sweep_block_ctx(d_pad: int, k_b: int, *, n_rows: int | None = None,
                       rowpatch: bool = False) -> int:
    """Rows per block of the PRE-GATHERED warp-row sweep (the Ψ tile is
    read from device memory, so a row holds e, α and the ψ_j scratch).
    Raises :class:`VmemBudgetError` when one row does not fit."""
    return _cd_sweep_rows(d_pad, k_b, n_rows, gather=False, rowpatch=rowpatch)


def cd_sweep_gather_block_ctx(d_pad: int, m: int, *,
                              n_rows: int | None = None,
                              rowpatch: bool = False) -> int:
    """Rows per block of the IN-KERNEL-GATHER warp-row sweep: a row also
    holds its clipped ids. The ψ slab costs no shared memory: it is read
    through L2. Raises :class:`VmemBudgetError` when one row does not
    fit."""
    return _cd_sweep_rows(d_pad, m, n_rows, gather=True, rowpatch=rowpatch)


def resolve_cd_sweep_dispatch(d_pad: int, m: int, *,
                              prefer_gather: bool = True) -> bool:
    """``use_gather`` for one fused MF sweep. On CUDA the gather is
    native, so the caller's preference decides. The launch form is sized
    once here, before the sweep starts, with :func:`cd_sweep_form`: a row
    too long for one block's shared memory takes the split-row form
    (gather) or the block-row form (pre-gathered), and only a k_b that no
    form can launch raises :class:`VmemBudgetError`, rather than
    shrinking, as in the reference. Each launch sizes itself the same
    way."""
    cd_sweep_form(d_pad, m, gather=prefer_gather)
    return prefer_gather
