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


# Large K (k_pad > TOPK_MAX_CHUNK): the merge levels hold up to
# TOPK_WIDE_KEYS keys a block in dynamic shared memory (128 KB), two lists of
# k_pad at least, so k_pad stops at TOPK_WIDE_KEYS / 2.
TOPK_WIDE_KEYS = 16_384
TOPK_WIDE_MAX_K_PAD = TOPK_WIDE_KEYS // 2
assert _KEY_BYTES * TOPK_WIDE_KEYS <= SMEM_BLOCK_MAX


def topk_block_items(k_pad: int, *, n_items: int | None = None) -> int:
    """ψ rows per pass-1 block for the ``topk_score`` kernel (the
    counterpart of the TPU kernel's ``block_items``).

    Up to TOPK_MAX_CHUNK, a block keeps the best ``k_pad`` keys of its
    chunk, so the chunk is at least ``k_pad``, and pass 2 holds
    TOPK_MERGE_SLOTS lists of ``k_pad`` keys. Above it (the large-K path)
    a chunk keeps all its rows and is smaller than ``k_pad``; the merge
    levels keep every key until lists reach ``k_pad``, in blocks of
    TOPK_WIDE_KEYS keys. ``n_items`` shrinks the chunk for a small table
    (one block, fewer idle threads). Raises :class:`VmemBudgetError` when
    ``k_pad`` exceeds TOPK_WIDE_MAX_K_PAD."""
    chunk = TOPK_MAX_CHUNK
    if k_pad > TOPK_WIDE_MAX_K_PAD:
        raise VmemBudgetError(
            f"k_pad={k_pad} does not fit the topk_score blocks: a large-K "
            f"merge block holds {TOPK_WIDE_KEYS} keys, two lists of at most "
            f"{TOPK_WIDE_MAX_K_PAD}")
    lo = max(k_pad, 32) if k_pad <= chunk else 32
    if n_items is not None:
        chunk = min(chunk, max(lo, _pow2_ceil(max(1, n_items))))
    return chunk


def cluster_block_items(k_pad: int, *, shard_items: int) -> int:
    """Per-shard ψ chunk for the sharded cluster (``serve/cluster.py``).

    On the TPU the cross-shard merge scratch was charged to VMEM; here the
    merge (``ops.topk_merge_shards``) is a PyTorch sort in device memory,
    so a shard's blocks cost what :func:`topk_block_items` says for its
    row count, and the same :class:`VmemBudgetError` propagates."""
    return topk_block_items(k_pad, n_items=shard_items)


# ---------------------------------------------------------------------------
# Gram (csrc/gram.cu). A block owns one GRAM_TILE × GRAM_TILE tile of J over
# one range of rows and stages GRAM_CHUNK rows of its two column strips in
# static shared memory (2 · 32 · 64 · 4 B = 16 KB); the rows are split so
# that about GRAM_TARGET_BLOCKS blocks (4 per SM of an H100) share the work.
# ---------------------------------------------------------------------------
GRAM_TILE = 64
GRAM_CHUNK = 32
GRAM_TARGET_BLOCKS = 4 * 132
assert 2 * 4 * GRAM_CHUNK * GRAM_TILE <= SMEM_STATIC_BYTES


def gram_row_splits(rows: int, k: int) -> tuple:
    """``(splits, rows_per_split)`` for one Gram launch: enough row splits
    to give the card about GRAM_TARGET_BLOCKS blocks, each split a whole
    number of staged chunks. The splits are summed in order by the second
    pass, so the result depends only on ``rows`` and ``k``."""
    tiles = -(-k // GRAM_TILE)
    pairs = tiles * (tiles + 1) // 2  # J is symmetric: lower-triangle tiles
    chunks = max(1, -(-rows // GRAM_CHUNK))
    splits = max(1, min(-(-GRAM_TARGET_BLOCKS // pairs), chunks))
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
# cd_sweep_form picks the form: warp-row when one row fits a block's shared
# memory, block-row otherwise. VmemBudgetError is left for what neither
# form can launch (a k_b whose k_b × k_b block alone overflows a block).
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


def cd_sweep_form(d_pad: int, k_b: int, *, gather: bool,
                  rowpatch: bool = False) -> str:
    """The launch form of one sweep: :data:`WARP_ROW` when one row fits a
    block's shared memory, else :data:`BLOCK_ROW`. Raises
    :class:`VmemBudgetError` when neither form can launch."""
    if cd_sweep_smem_bytes(d_pad, k_b, 1, gather=gather,
                           rowpatch=rowpatch) <= SMEM_BLOCK_MAX:
        return WARP_ROW
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
    native, so the caller's preference decides. The chosen form is sized
    once here, before the sweep starts, so a row that cannot stay resident
    raises :class:`VmemBudgetError` rather than shrinking, as in the
    reference (each launch sizes its own rows the same way). The tensor
    models' context modes size theirs with :func:`cd_sweep_form`, which
    takes the block-row form for such rows."""
    _cd_sweep_rows(d_pad, m, None, gather=prefer_gather)
    return prefer_gather
