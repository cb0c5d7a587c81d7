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


def topk_block_items(k_pad: int, *, n_items: int | None = None) -> int:
    """ψ rows per pass-1 block for the ``topk_score`` kernel (the
    counterpart of the TPU kernel's ``block_items``).

    A block keeps the best ``k_pad`` keys of its chunk, so the chunk is at
    least ``k_pad``; pass 2 holds TOPK_MERGE_SLOTS lists of ``k_pad`` keys.
    ``n_items`` shrinks the chunk for a small table (one block, fewer idle
    threads). Raises :class:`VmemBudgetError` when ``k_pad`` needs more
    shared memory than a block has."""
    chunk = TOPK_MAX_CHUNK
    merge = _KEY_BYTES * TOPK_MERGE_SLOTS * k_pad
    if k_pad > chunk or merge > SMEM_STATIC_BYTES:
        raise VmemBudgetError(
            f"k_pad={k_pad} does not fit the topk_score blocks: the chunk "
            f"holds at most {chunk} rows and the merge needs {merge} B of "
            f"{SMEM_STATIC_BYTES} B"
        )
    if n_items is not None:
        chunk = min(chunk, max(k_pad, 32, _pow2_ceil(max(1, n_items))))
    return chunk


def cluster_block_items(k_pad: int, *, shard_items: int) -> int:
    """Per-shard ψ chunk for the sharded cluster (``serve/cluster.py``).

    On the TPU the cross-shard merge scratch was charged to VMEM; here the
    merge (``ops.topk_merge_shards``) is a PyTorch sort in device memory,
    so a shard's blocks cost what :func:`topk_block_items` says for its
    row count, and the same :class:`VmemBudgetError` propagates."""
    return topk_block_items(k_pad, n_items=shard_items)
