// Tucker's core sweep by core slab, hand-written for Hopper (sm_90a): every scalar Newton
// step of b_{f1,f2,f3} in the reference's order idx = (f1·k2 + f2)·k3 + f3, with one pass
// over the interaction log a slab (f1, f2) of the core instead of one a coordinate.
//
// Replaces no TPU kernel. The JAX package's core sweep is a lax.fori_loop of XLA ops, one
// step a coordinate, each a pass over nnz (repro/core/models/tucker.py).
//
// The algebra (ref.py is the same in PyTorch). During the core sweep u, v, w and ᾱ are
// fixed; only e, Φ and b move. The k3 steps of slab ab = f1·k2 + f2 share one
// g_ab(p) = u[c1(p), f1]·v[c2(p), f2] over the pairs p, so
//   L''_f = K[f, f], K = Σₙ ᾱ g² w_i w_iᵀ (k3 × k3), which no step changes;
//   L'_f  = L'⁰_f + Σ_{f'<f} δ_{f'} K[f', f], L'⁰ = Σₙ ᾱ e⁰ g w_i, e⁰ the slab's start;
//   Φᵀg_ab = R[ab] with R = Gₚ·Φ₀ (k1·k2 × k3), moved by each step (a'b', f'):
//   R[cd, f'] += δ·G[a'b', cd], G = Gₚ·Gₚᵀ the Gram of the g rows.
// So a slab needs one pass over the log (K and L'⁰), then its k3 steps in sequence on
// k3² numbers. The caller forms Gₚ, G and R by matrix products before the sweep and
// Φ += Gₚᵀ·Δ after it.
//
// Launches: per slab ab, the pass kernel (apply the previous slab's steps to e, then sum
// K's upper triangle and L'⁰ into block partials) and the solve kernel (one block: add
// the partials in block order, run the k3 steps, move R); then one patch-only pass.
// 2·k1·k2 + 1 launches a sweep, no host synchronisation between them.
//
// What bounds the pass on an H100 at ranks (16, 4, 32) over 19.99 M interactions: the
// FMAs (K's 528 entries and L'⁰'s 32 a nonzero, ≈ 23.7 GFLOP: ≈ 0.35 ms at 67 TFLOP/s) and
// the w rows, 128 bytes an interaction from L2 (w is 8.7 MB); HBM carries e (read and
// written), ᾱ, the item id and the pairs' g, ≈ 0.4 GB (≈ 0.12 ms at 3.35 TB/s).
//
// Design of the pass: each warp of a block (TCORE_GROUPS of them) walks its own equal
// share of the log in tiles of 32 interactions, a lane each. The lanes find their pairs
// from the CSR offsets by a binary search over 32 row ends held one a lane (shuffles).
// The tiles are pipelined: while tile k is summed, tile k + 1's w rows are copied by
// cp.async into the second of two buffers, and tile k + 2's pairs are found and its item,
// ᾱ, e and g loaded into registers. For tile k the lanes patch e, and write their rows
// scaled by t = ᾱ g² (and x = ᾱ g e) to shared memory; then every lane accumulates its
// own slice of K's upper triangle and of L'⁰ over the tile: K is cut in 4 × 4 blocks on
// or above the diagonal (36 at k3 = 32), one block a lane, and the blocks left over are
// cut by rows into 1 × 4 pieces beside L'⁰'s eight pieces (L'⁰ is the 33rd row of the
// scaled tile): 20 FMAs a lane an interaction, 640 a warp where K and L'⁰ need 560. The
// sums are bound by those shared-memory loads (4 a row) more than by the FMAs. A tile's
// sums start from zero and are added to the lane's running sums, so no sum is a long
// chain. Above k3 = 64 four warps share a tile (k3 = 128: 528 blocks over 128 lanes).
// The block's warps' sums are added in warp order and written as the block's partials:
// no atomics, so every sum is taken in an order fixed by the offsets, nnz and the grid,
// and two runs give the same bits.
//
// Interface: plain C functions bound with ctypes. tucker_core_sweep_f32 launches on the
// caller's stream, allocates nothing and returns cudaGetLastError(); tucker_core_layout
// reports the grid, the partials and the tile of the pass.

#include <cuda_runtime.h>
#include <stdint.h>

#if !defined(TCORE_WIDTH) || !defined(TCORE_GROUPS)
#error "build through repro_torch/kernels/tucker_core/kernel.py, which passes the width"
#endif

constexpr int W = TCORE_WIDTH;                   // k3 rounded up: 8, 16, 32, 64 or 128
constexpr int NW = W > 64 ? 4 : 1;               // warps that share a tile
constexpr int T = 32 * NW;                       // lanes of a group (the warps of a tile)
constexpr int GROUPS = W > 64 ? 1 : TCORE_GROUPS;  // groups a block
constexpr int THREADS = T * GROUPS;
constexpr int TILE = 32;                         // interactions a tile, a lane of warp 0 each
constexpr int LD = W + 4;                        // row stride of a staged tile: float4 rows
constexpr int NB = W / 4;                        // K's 4-wide blocks a side
constexpr int U = NB * (NB + 1) / 2;             // 4 × 4 blocks on or above the diagonal
constexpr int M = U / T;                         // whole blocks a lane
constexpr int LEFT = U - M * T;                  // blocks left over, cut into 1 × 4 rows
constexpr int X = 4 * LEFT + NB;                 // 1 × 4 pieces: those rows and L'⁰'s
constexpr int E = (X + T - 1) / T;               // pieces a lane (some lanes' are empty)
constexpr int S = 16 * M + 4 * E;                // sums a lane
constexpr int SLOTS = S * T;                     // a block's partial sums
constexpr int Q4 = TILE * W / 4 / T;             // 16-byte copies of a tile's w rows a lane
constexpr int Q1 = TILE * W / T;                 // 4-byte copies, where k3 % 4 != 0
constexpr int SOLVE_THREADS = 1024;
constexpr int WSLOTS = (W + 31) / 32;            // k3 values a lane of the solve's warp
constexpr int MIN_BLOCKS = S <= 32 ? 2 : 1;      // blocks an SM the registers leave room for
#define FULL_MASK 0xffffffffu

static_assert(W % 8 == 0 && W <= 128, "the widths the wrapper builds");
static_assert(THREADS <= 1024 && T % 32 == 0, "whole warps");
static_assert(Q4 * 4 * T == TILE * W, "a tile's rows split evenly over a group");

// The staged tiles of a group: two buffers of w rows (the next tile's copied while this
// one is summed), the rows scaled by t (column W holds x, W+1..W+3 zeros), and the two
// buffers' item ids.
constexpr int GROUP_FLOATS = 3 * TILE * LD + 2 * TILE;
constexpr size_t PASS_SMEM = sizeof(float) * ((size_t)GROUPS * GROUP_FLOATS + W);
static_assert(GROUPS == 1 || (size_t)GROUPS * SLOTS <= (size_t)GROUPS * GROUP_FLOATS,
              "the warps' sums are added in the staged tiles' memory");

// Block bi of K's upper triangle, numbered row by row: block row r, block column c ≥ r.
__host__ __device__ inline void block_rc(int bi, int& r, int& c) {
    r = 0;
    int len = NB;
    while (bi >= len) {
        bi -= len;
        ++r;
        --len;
    }
    c = r + bi;
}

// Piece x: the row (of the scaled tile: K's row, W for L'⁰, W + 1 for an empty piece)
// and the first column of its four.
__host__ __device__ inline void piece_of(int x, int& row, int& col) {
    if (x < 4 * LEFT) {
        int r, c;
        block_rc(M * T + x / 4, r, c);
        row = 4 * r + x % 4;
        col = 4 * c;
    } else if (x < X) {
        row = W;
        col = 4 * (x - 4 * LEFT);
    } else {
        row = W + 1;
        col = 0;
    }
}

// Pairs whose end lies at or before n: the pair of interaction n (ptr[pairs] = nnz > n).
__device__ __forceinline__ int64_t pair_of(const int64_t* __restrict__ ptr, int64_t pairs,
                                           int64_t n) {
    int64_t lo = 0, hi = pairs;
    while (lo < hi) {
        const int64_t mid = (lo + hi) >> 1;
        if (__ldg(ptr + mid + 1) <= n)
            lo = mid + 1;
        else
            hi = mid;
    }
    return lo;
}

// The end of pair base + 1 + lane (nnz past the last pair): a lane's share of a search.
__device__ __forceinline__ int64_t end_of(const int64_t* __restrict__ ptr, int64_t pairs,
                                          int64_t base, int lane) {
    const int64_t j = base + 1 + lane;
    return __ldg(ptr + (j < pairs ? j : pairs));
}

// The pair of interaction nq (base ≤ it), from the ends of pairs base + 1.. held a lane
// each (end, loaded by end_of): the ends at or before nq, 32 at a time. Warp-wide.
__device__ __forceinline__ int64_t pair_from(const int64_t* __restrict__ ptr, int64_t pairs,
                                             int64_t base, int64_t end, int64_t nq, int lane) {
    int64_t pair = 0;
    bool done = false;
    for (;;) {
        int lo = 0, hi = 32;
#pragma unroll
        for (int it = 0; it < 6; ++it) {
            const int mid = (lo + hi) >> 1;
            const int64_t em = __shfl_sync(FULL_MASK, end, mid < 32 ? mid : 31);
            if (lo < hi) {
                if (em <= nq)
                    lo = mid + 1;
                else
                    hi = mid;
            }
        }
        if (!done && lo < 32) {
            pair = base + lo;
            done = true;
        }
        if (__all_sync(FULL_MASK, done)) return pair;
        base += 32;  // more than 32 pairs end in the tile: only with empty pairs
        end = end_of(ptr, pairs, base, lane);
    }
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, bool full) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
                 "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem, bool full) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
                 "r"(full ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n" ::); }

__device__ __forceinline__ void group_sync() {
    if (NW == 1)
        __syncwarp();
    else
        __syncthreads();  // above k3 = 64 the block is one group
}

// One interaction of a tile, held by a lane of the group's warp 0.
struct Entry {
    int item;
    float alpha, e, g, gq;  // ᾱ, the residual, this slab's g and the previous slab's
};

// One pass of slab ab over the log: with ab > 0 the residuals take the previous slab's
// steps (e += g_{ab-1}·⟨w_i, δ_{ab-1}⟩, written back); with ab < slabs the block's sums
// of K's upper triangle and L'⁰ go to part[block][s][lane]. A group's tiles are
// pipelined: tile k + 2's pairs are found and its entries loaded, and tile k + 1's w rows
// copied, while tile k is summed.
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) tucker_core_pass_kernel(
    const float* __restrict__ w, int k3, const float* __restrict__ gp, int64_t pairs,
    const int64_t* __restrict__ ptr, const int* __restrict__ item,
    const float* __restrict__ alpha, float* __restrict__ e, int64_t nnz, int ab, int slabs,
    const float* __restrict__ delta, float* __restrict__ part) {
    extern __shared__ __align__(16) float smem[];
    const int tid = threadIdx.x, group = tid / T, tl = tid % T, lane = tid & 31;
    const bool lead = tl < 32;  // warp 0 of the group: the tile's interactions, a lane each
    float* s_wbuf = smem + group * GROUP_FLOATS;   // [2][TILE][LD]
    float* s_a = s_wbuf + 2 * TILE * LD;           // [TILE][LD]
    int* s_item = reinterpret_cast<int*>(s_a + TILE * LD);  // [2][TILE]
    float* s_delta = smem + GROUPS * GROUP_FLOATS;
    const bool patch = ab > 0, acc_on = ab < slabs;
    const float* g_now = gp + (int64_t)(acc_on ? ab : 0) * pairs;
    const float* g_prev = gp + (int64_t)(patch ? ab - 1 : 0) * pairs;
    // the w rows in 16-byte copies where k3 keeps them on 16 bytes
    const bool vec4 = (k3 & 3) == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;

    for (int f = tid; f < W; f += THREADS)
        s_delta[f] = patch && f < k3 ? delta[(int64_t)(ab - 1) * k3 + f] : 0.f;

    // this lane's blocks and pieces of K and L'⁰
    int arow[M > 0 ? M : 1], wcol[M > 0 ? M : 1], prow[E], pcol[E];
#pragma unroll
    for (int m = 0; m < M; ++m) {
        int r, c;
        block_rc(tl + m * T, r, c);
        arow[m] = 4 * r;
        wcol[m] = 4 * c;
    }
#pragma unroll
    for (int q = 0; q < E; ++q) piece_of(tl + q * T, prow[q], pcol[q]);
    float acc[S];
#pragma unroll
    for (int s = 0; s < S; ++s) acc[s] = 0.f;
    __syncthreads();

    const int64_t ngroups = (int64_t)gridDim.x * GROUPS, gid = (int64_t)blockIdx.x * GROUPS + group;
    const int64_t n_begin = nnz * gid / ngroups, n_end = nnz * (gid + 1) / ngroups;
    const int64_t tiles = (n_end - n_begin + TILE - 1) / TILE;

    // a tile's entries (lead lanes): its pairs from base on, then the loads; base moves
    // to the pair of the tile's last interaction
    auto fetch = [&](int64_t k, int64_t& base, int64_t end) {
        Entry x = {0, 0.f, 0.f, 0.f, 0.f};
        const int64_t n = n_begin + k * TILE + lane, last = n_end - 1;
        const int64_t pair = pair_from(ptr, pairs, base, end, n < last ? n : last, lane);
        base = __shfl_sync(FULL_MASK, pair, 31);
        if (n < n_end) {
            x.item = __ldg(item + n);
            x.alpha = __ldg(alpha + n);
            x.e = e[n];
            if (acc_on) x.g = __ldg(g_now + pair);
            if (patch) x.gq = __ldg(g_prev + pair);
        }
        return x;
    };
    // tile k's w rows into buffer k & 1 (zeros past k3; an invalid lane's row is item 0's,
    // scaled by 0), by every lane of the group
    auto stage = [&](int64_t k) {
        float* buf = s_wbuf + (k & 1) * TILE * LD;
        const int* ids = s_item + (k & 1) * TILE;
        if (vec4) {
#pragma unroll
            for (int q = 0; q < Q4; ++q) {
                const int idx = tl + q * T, row = idx / (W / 4), c4 = idx % (W / 4);
                const bool full = 4 * c4 < k3;
                cp_async16(buf + row * LD + 4 * c4,
                           full ? w + (int64_t)ids[row] * k3 + 4 * c4 : w, full);
            }
        } else {
#pragma unroll 8
            for (int q = 0; q < Q1; ++q) {
                const int idx = tl + q * T, row = idx / W, col = idx % W;
                const bool full = col < k3;
                cp_async4(buf + row * LD + col, full ? w + (int64_t)ids[row] * k3 + col : w, full);
            }
        }
    };

    Entry cur = {0, 0.f, 0.f, 0.f, 0.f}, nxt = cur;
    int64_t base = 0, end = 0;
    if (tiles > 0) {
        if (lead) {
            base = pair_of(ptr, pairs, n_begin);
            cur = fetch(0, base, end_of(ptr, pairs, base, lane));
            if (tiles > 1) nxt = fetch(1, base, end_of(ptr, pairs, base, lane));
            end = end_of(ptr, pairs, base, lane);  // tile 2's search
            s_item[lane] = cur.item;
        }
        group_sync();
        stage(0);
    }
    cp_async_commit();

    for (int64_t k = 0; k < tiles; ++k) {
        const float* s_w = s_wbuf + (k & 1) * TILE * LD;
        Entry after = {0, 0.f, 0.f, 0.f, 0.f};
        if (lead) {
            if (k + 2 < tiles) {  // tile k + 2: its pairs, its loads, and tile k + 3's ends
                after = fetch(k + 2, base, end);
                end = end_of(ptr, pairs, base, lane);
            }
            if (k + 1 < tiles) s_item[((k + 1) & 1) * TILE + lane] = nxt.item;
        }
        group_sync();
        if (k + 1 < tiles) stage(k + 1);
        cp_async_commit();
        cp_async_wait1();  // tile k's rows have landed
        group_sync();
        if (lead) {  // the patch and the scaled row, from one read of the w row
            const int64_t n = n_begin + k * TILE + lane;
            const float4* wr = reinterpret_cast<const float4*>(s_w + lane * LD);
            float4* ar = reinterpret_cast<float4*>(s_a + lane * LD);
            const float t = cur.alpha * cur.g * cur.g;
            float dot = 0.f;
#pragma unroll
            for (int q = 0; q < W / 4; ++q) {
                const float4 v = wr[q];
                if (patch) {
                    const float4 d = reinterpret_cast<const float4*>(s_delta)[q];
                    dot = fmaf(v.x, d.x, fmaf(v.y, d.y, fmaf(v.z, d.z, fmaf(v.w, d.w, dot))));
                }
                if (acc_on) ar[q] = make_float4(t * v.x, t * v.y, t * v.z, t * v.w);
            }
            const float ev = fmaf(cur.gq, dot, cur.e);
            if (patch && n < n_end) e[n] = ev;
            if (acc_on) ar[W / 4] = make_float4(cur.alpha * cur.g * ev, 0.f, 0.f, 0.f);
        }
        group_sync();
        if (acc_on) {
            float tacc[S];
#pragma unroll
            for (int s = 0; s < S; ++s) tacc[s] = 0.f;
#pragma unroll 4
            for (int r = 0; r < TILE; ++r) {
                const float* a = s_a + r * LD;
                const float* wr = s_w + r * LD;
#pragma unroll
                for (int m = 0; m < M; ++m) {
                    const float4 av = *reinterpret_cast<const float4*>(a + arow[m]);
                    const float4 wv = *reinterpret_cast<const float4*>(wr + wcol[m]);
                    const float ai[4] = {av.x, av.y, av.z, av.w}, wj[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
                    for (int i = 0; i < 4; ++i)
#pragma unroll
                        for (int jj = 0; jj < 4; ++jj)
                            tacc[16 * m + 4 * i + jj] = fmaf(ai[i], wj[jj], tacc[16 * m + 4 * i + jj]);
                }
#pragma unroll
                for (int q = 0; q < E; ++q) {
                    const float as = a[prow[q]];
                    const float4 wv = *reinterpret_cast<const float4*>(wr + pcol[q]);
                    const int o = 16 * M + 4 * q;
                    tacc[o] = fmaf(as, wv.x, tacc[o]);
                    tacc[o + 1] = fmaf(as, wv.y, tacc[o + 1]);
                    tacc[o + 2] = fmaf(as, wv.z, tacc[o + 2]);
                    tacc[o + 3] = fmaf(as, wv.w, tacc[o + 3]);
                }
            }
#pragma unroll
            for (int s = 0; s < S; ++s) acc[s] += tacc[s];
        }
        group_sync();  // the tile's memory is read; the copies of tile k + 2 may land there
        cur = nxt;
        nxt = after;
    }
    if (!acc_on) return;
    float* out = part + (int64_t)blockIdx.x * SLOTS;
    if (GROUPS == 1) {
#pragma unroll
        for (int s = 0; s < S; ++s) out[s * T + tl] = acc[s];
        return;
    }
    asm volatile("cp.async.wait_all;\n" ::);
    __syncthreads();  // every group is done with its tiles: their memory holds the sums
#pragma unroll
    for (int s = 0; s < S; ++s) smem[(group * S + s) * T + tl] = acc[s];
    __syncthreads();
    for (int idx = tid; idx < SLOTS; idx += THREADS) {
        float v = 0.f;
        for (int gi = 0; gi < GROUPS; ++gi) v += smem[gi * SLOTS + idx];
        out[idx] = v;
    }
}

// Packed upper triangle of a W × W matrix: (r, c), r ≤ c.
__device__ __forceinline__ int tri(int r, int c) { return r * W - r * (r - 1) / 2 + (c - r); }

// The steps of slab ab: add the pass's partials in block order into K and L'⁰, run the
// k3 Newton steps in sequence (warp 0, a lane per f'' mod 32), write δ, and move R's
// later rows: R[cd] += δ·G[ab, cd] for cd > ab.
__global__ void __launch_bounds__(SOLVE_THREADS) tucker_core_solve_kernel(
    const float* __restrict__ part, int blocks, int k3, int ab, int slabs,
    const float* __restrict__ gram_g, float* __restrict__ r, const float* __restrict__ b,
    const float* __restrict__ j_i, float* __restrict__ delta, float alpha0, float l2,
    float eta) {
    __shared__ float s_k[W * (W + 1) / 2];
    __shared__ float s_l[W + 4];
    __shared__ float s_d[W];
    const int tid = threadIdx.x;
    for (int idx = tid; idx < SLOTS; idx += SOLVE_THREADS) {
        float v = 0.f;
#pragma unroll 8
        for (int bl = 0; bl < blocks; ++bl) v += part[(int64_t)bl * SLOTS + idx];
        const int s = idx / T, t = idx % T;
        int row, col;
        if (s < 16 * M) {
            int br, bc;
            block_rc(t + (s / 16) * T, br, bc);
            row = 4 * br + (s % 16) / 4;
            col = 4 * bc + s % 4;
        } else {
            piece_of(t + ((s - 16 * M) / 4) * T, row, col);
            col += s % 4;
        }
        if (row < W) {
            if (row <= col) s_k[tri(row, col)] = v;  // a diagonal block's lower half is K's too
        } else if (row == W) {
            s_l[col] = v;
        }
    }
    __syncthreads();
    if (tid < 32) {
        const int lane = tid;
        const float g_ab = gram_g[(int64_t)ab * slabs + ab];
        float rl[WSLOTS], ll[WSLOTS], dl[WSLOTS];
#pragma unroll
        for (int i = 0; i < WSLOTS; ++i) {
            const int f = lane + 32 * i;
            rl[i] = f < k3 ? r[(int64_t)ab * k3 + f] : 0.f;
            ll[i] = f < k3 ? s_l[f] : 0.f;
            dl[i] = 0.f;
        }
        for (int f = 0; f < k3; ++f) {
            float rp = 0.f;
#pragma unroll
            for (int i = 0; i < WSLOTS; ++i) {
                const int fr = lane + 32 * i;
                if (fr < k3) rp = fmaf(rl[i], __ldg(j_i + (int64_t)fr * k3 + f), rp);
            }
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) rp += __shfl_xor_sync(FULL_MASK, rp, o);
            float mine = 0.f;
#pragma unroll
            for (int i = 0; i < WSLOTS; ++i)
                if (i == (f >> 5)) mine = ll[i];
            const float lf = __shfl_sync(FULL_MASK, mine, f & 31);
            const float num = lf + alpha0 * rp + l2 * b[(int64_t)ab * k3 + f];
            const float den = s_k[tri(f, f)] + alpha0 * __ldg(j_i + (int64_t)f * k3 + f) * g_ab + l2;
            const float d = -eta * num / fmaxf(den, 1e-12f);
#pragma unroll
            for (int i = 0; i < WSLOTS; ++i) {
                const int fr = lane + 32 * i;
                if (fr < k3) {
                    ll[i] = fmaf(d, s_k[fr < f ? tri(fr, f) : tri(f, fr)], ll[i]);
                    if (fr == f) {
                        rl[i] = fmaf(d, g_ab, rl[i]);
                        dl[i] = d;
                    }
                }
            }
        }
#pragma unroll
        for (int i = 0; i < WSLOTS; ++i) {
            const int f = lane + 32 * i;
            if (f < k3) {
                delta[(int64_t)ab * k3 + f] = dl[i];
                s_d[f] = dl[i];
            }
        }
    }
    __syncthreads();
    const int later = (slabs - ab - 1) * k3;
    for (int idx = tid; idx < later; idx += SOLVE_THREADS) {
        const int cd = ab + 1 + idx / k3, f = idx % k3;
        r[(int64_t)cd * k3 + f] = fmaf(s_d[f], gram_g[(int64_t)ab * slabs + cd],
                                       r[(int64_t)cd * k3 + f]);
    }
}

static cudaError_t pass_smem_attr() {
    static bool set = false;
    if (set) return cudaSuccess;
    const cudaError_t rc = cudaFuncSetAttribute(
        tucker_core_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)PASS_SMEM);
    set = rc == cudaSuccess;
    return rc;
}

// The most blocks the pass keeps resident on the current device, the floats of a block's
// partials, and the interactions a block takes a tile.
extern "C" int tucker_core_layout(int* blocks, int* slots, int* tile) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t rc = pass_smem_attr();
    if (rc == cudaSuccess) rc = cudaGetDevice(&dev);
    if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc == cudaSuccess)
        rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tucker_core_pass_kernel,
                                                           THREADS, PASS_SMEM);
    *blocks = sms * (per_sm > 0 ? per_sm : 1);
    *slots = SLOTS;
    *tile = TILE * GROUPS;
    return (int)rc;
}

// w: (n_items, k3); gp: (slabs, pairs) the g rows; gram_g: (slabs, slabs); r: (slabs, k3),
// = gp·Φ₀, moved in place; b: (slabs, k3); j_i: (k3, k3); ptr: (pairs + 1,) int64 CSR
// offsets; item (int32), alpha, e (moved in place): (nnz,); delta: (slabs, k3) out;
// part: blocks · SLOTS floats. 1 ≤ k3 ≤ W, slabs ≥ 1, blocks ≥ 1.
extern "C" int tucker_core_sweep_f32(const float* w, int k3, const float* gp, long long pairs,
                                     const float* gram_g, int slabs, float* r, const float* b,
                                     const float* j_i, const int64_t* ptr, const int* item,
                                     const float* alpha, float* e, long long nnz, float* delta,
                                     float* part, int blocks, float alpha0, float l2, float eta,
                                     void* stream) {
    if (k3 < 1 || k3 > W || slabs < 1 || blocks < 1 || pairs < 0 || nnz < 0)
        return (int)cudaErrorInvalidValue;
    cudaError_t rc = pass_smem_attr();
    if (rc != cudaSuccess) return (int)rc;
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    for (int ab = 0; ab <= slabs; ++ab) {
        tucker_core_pass_kernel<<<blocks, THREADS, PASS_SMEM, st>>>(
            w, k3, gp, pairs, ptr, item, alpha, e, nnz, ab, slabs, delta, part);
        if (ab < slabs)
            tucker_core_solve_kernel<<<1, SOLVE_THREADS, 0, st>>>(
                part, blocks, k3, ab, slabs, gram_g, r, b, j_i, delta, alpha0, l2, eta);
    }
    return (int)cudaGetLastError();
}

extern "C" const char* tucker_core_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
