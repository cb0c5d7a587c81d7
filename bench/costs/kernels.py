"""One count a kernel family: (FLOPs, bytes) of one launch.

``nnz`` is the real interactions a launch covers, ``n`` the rows of the
side being updated, ``n_other`` the rows of the table the ψ slab is cut
from. Bytes: each input read once and each output written once, in
float32 and int32 (4 bytes each); FLOPs: a multiply and an add are two.
"""
from __future__ import annotations

F = 4  # bytes of a float32 or an int32


def gram(n: int, k: int) -> tuple:
    """J = XᵀX of an (n, k) matrix: the k(k+1)/2 distinct entries, each n
    multiply-adds; X read, J written."""
    return n * k * (k + 1), F * (n * k + k * k)


def sweep_block(nnz: int, n: int, n_other: int, kb: int) -> tuple:
    """The shared-J block sweep of ``kb`` columns (every launch form).

    Per real slot and column: ᾱ·e·ψ and ᾱ·ψ² accumulated (3 + 3) and
    e += Δ·ψ (2). Per row and column: the Newton step (10), and the R'
    patch of the block's later columns (2 a later column). Bytes: id, α
    and e read and e written a slot; the ψ slab's kb columns once; w read
    and written and R' read a row; the kb × kb J block."""
    flops = 8 * kb * nnz + n * (10 * kb + kb * (kb - 1))
    nbytes = F * (4 * nnz + n_other * kb + 3 * n * kb + kb * kb)
    return flops, nbytes


def slab_reduce(nnz: int, n: int, n_other: int, m: int) -> tuple:
    """q = Σ ᾱ e ψ_a and P = Σ ᾱ ψ_a ψ_b (a ≤ b) over an m-column slab.

    Per real slot: ᾱ·e (1), ᾱ·ψ_a (m), q (2m), P's m(m+1)/2 entries (2
    each). Bytes: id, α and e a slot; the slab once; q (n, m) and P (n,
    m, m) written."""
    flops = nnz * (1 + 3 * m + m * (m + 1))
    nbytes = F * (3 * nnz + n_other * m + n * (m + m * m))
    return flops, nbytes


def resid_patch(nnz: int, n: int, n_other: int, m: int) -> tuple:
    """e += Σ_a Δφ_a ψ_a over an m-column slab: 2m a real slot; id and e
    read and e written a slot, the slab and Δφ (n, m) once."""
    return 2 * m * nnz, F * (3 * nnz + n_other * m + n * m)


def matmul(n: int, k: int, cols: int) -> tuple:
    """An (n, k) @ (k, cols) product (the R' products)."""
    return 2 * n * k * cols, F * (n * k + k * cols + n * cols)
