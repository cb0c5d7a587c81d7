// Slab moments and the rank-m residual patch of the feature models' fused
// block (MFSI and FM, paper Algorithm 3), hand-written for Hopper (sm_90a).
//
// Replaces: repro/kernels/cd_sweep/kernel.py, cd_slab_reduce_pallas (body
// _slab_reduce_kernel), cd_slab_reduce_gather_pallas (body
// _slab_reduce_gather_kernel), cd_resid_patch_pallas (body
// _resid_patch_kernel) and cd_resid_patch_gather_pallas (body
// _resid_patch_gather_kernel). Per context row r of the padded (C, D_pad)
// layout and m block columns:
//   slab reduce:  Q[r, j]    = Σ_d α·e·ψ_j
//                 P[r, i, j] = Σ_d α·ψ_i·ψ_j       (P symmetric)
//   resid patch:  e[r, d]   += Σ_j Δφ[r, j]·ψ_j[r, d]   (j ascending, in place)
// ψ_j[r, d] comes from a pre-gathered (C, m, D_pad) tile, or, in the gather
// form, from tab[ids[r, d], j] of the (n_src, m) ψ slab (row stride ld_tab,
// columns contiguous) with the id clipped to [0, n_src) as
// jnp.take(mode="clip") does.
//
// What bounds it on an H100: the bytes. The gather slab reduce reads ids, α
// and e once (12 B a slot), the ψ slab once and writes m + m² floats a row;
// it does ≈ m² + 3m FLOP a slot, so at m = 8 it is bytes-bound (8 FLOP a
// byte against the card's 20), at m ≥ 17 operations-bound. The residual
// patch reads ids and e and writes e (12 B a slot) for 2m FLOP a slot.
//
// Slab reduce design. One warp owns one row and streams its slots once per
// tile of columns (a lane owns the slots d ≡ lane mod 32), so nothing per
// slot is held in shared memory and any D_pad runs. The m columns are cut
// into tiles of SLAB_TILE; a pass over the row accumulates one
// (SLAB_TILE × SLAB_TILE) block of P in registers — on a diagonal block the
// upper triangle only, with that tile's entries of Q — so any m ≥ 1 runs in
// ⌈m/T⌉(⌈m/T⌉+1)/2 passes (one at m ≤ 8). Each sum is then reduced across
// the warp by an xor butterfly: a fixed order, and + is commutative, so every
// lane ends with the same bits and every run gives the same bits. P is
// written symmetric from the one sum of each pair (i, j).
//
// Residual patch design. One thread owns one slot and adds the m products
// in ascending j to the caller's e (the reference gather form's order).
//
// Interface: plain C functions bound with ctypes. They launch on the caller's
// stream, allocate nothing and return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#define SLAB_TILE 8   // columns of a P tile
#define SLAB_WARPS 8  // rows (warps) per block
#define PATCH_THREADS 256
#define FULL_MASK 0xffffffffu

template <bool GATHER>
__device__ __forceinline__ void load_cols(float (&x)[SLAB_TILE], const float* __restrict__ psi_blk,
                                          const float* __restrict__ tab, long long ld_tab,
                                          long long tab_row, long long row, int m, int D,
                                          int c0, int d) {
#pragma unroll
    for (int a = 0; a < SLAB_TILE; ++a) {
        const int c = c0 + a;
        x[a] = c < m ? (GATHER ? tab[tab_row * ld_tab + c]
                               : psi_blk[((size_t)row * m + c) * D + d])
                     : 0.f;
    }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
    return v;
}

template <bool GATHER>
__global__ void __launch_bounds__(32 * SLAB_WARPS)
cd_slab_reduce_kernel(const float* __restrict__ psi_blk,  // (C, m, D)
                      const float* __restrict__ tab, long long ld_tab, int n_src,
                      const int* __restrict__ ids,        // (C, D)
                      const float* __restrict__ alpha,    // (C, D)
                      const float* __restrict__ e,        // (C, D)
                      float* __restrict__ q_out,          // (C, m)
                      float* __restrict__ p_out,          // (C, m, m)
                      int C, int D, int m) {
    const int lane = threadIdx.x & 31;
    const long long row = (long long)blockIdx.x * SLAB_WARPS + (threadIdx.x >> 5);
    if (row >= C) return;  // whole warps leave together
    const size_t g = (size_t)row * D;
    const int n_tiles = (m + SLAB_TILE - 1) / SLAB_TILE;

    for (int bi = 0; bi < n_tiles; ++bi) {
        for (int bj = bi; bj < n_tiles; ++bj) {
            const bool diag = bi == bj;
            const int i0 = bi * SLAB_TILE, j0 = bj * SLAB_TILE;
            float acc[SLAB_TILE][SLAB_TILE], q[SLAB_TILE];
#pragma unroll
            for (int a = 0; a < SLAB_TILE; ++a) {
                q[a] = 0.f;
#pragma unroll
                for (int b = 0; b < SLAB_TILE; ++b) acc[a][b] = 0.f;
            }
            for (int d = lane; d < D; d += 32) {
                const float al = alpha[g + d];
                long long id = 0;
                if (GATHER) id = min(max(ids[g + d], 0), n_src - 1);
                float pj[SLAB_TILE], pi[SLAB_TILE];
                load_cols<GATHER>(pj, psi_blk, tab, ld_tab, id, row, m, D, j0, d);
                if (diag) {
                    const float ae = al * e[g + d];
#pragma unroll
                    for (int b = 0; b < SLAB_TILE; ++b) {
                        q[b] += pj[b] * ae;
                        pi[b] = pj[b];
                    }
                } else {
                    load_cols<GATHER>(pi, psi_blk, tab, ld_tab, id, row, m, D, i0, d);
                }
#pragma unroll
                for (int a = 0; a < SLAB_TILE; ++a) {
                    const float api = al * pi[a];
#pragma unroll
                    for (int b = 0; b < SLAB_TILE; ++b)
                        if (!diag || a <= b) acc[a][b] += api * pj[b];
                }
            }
            // reduce and write; the bounds below are the same in every lane
            const size_t pr = (size_t)row * m * m;
#pragma unroll
            for (int a = 0; a < SLAB_TILE; ++a) {
                const int i = i0 + a;
                if (i >= m) break;
                if (diag) {
                    const float s = warp_sum(q[a]);
                    if (lane == a) q_out[(size_t)row * m + i] = s;
                }
#pragma unroll
                for (int b = 0; b < SLAB_TILE; ++b) {
                    const int j = j0 + b;
                    if (j >= m || (diag && b < a)) continue;
                    const float s = warp_sum(acc[a][b]);
                    if (lane == (a * SLAB_TILE + b) % 32) {
                        p_out[pr + (size_t)i * m + j] = s;
                        p_out[pr + (size_t)j * m + i] = s;
                    }
                }
            }
        }
    }
}

template <bool GATHER>
__global__ void __launch_bounds__(PATCH_THREADS)
cd_resid_patch_kernel(const float* __restrict__ psi_blk,  // (C, m, D)
                      const float* __restrict__ tab, long long ld_tab, int n_src,
                      const int* __restrict__ ids,        // (C, D)
                      float* __restrict__ e,              // (C, D), in place
                      const float* __restrict__ dphi, long long ld_dphi,  // (C, m)
                      long long n_slots, int D, int m) {
    const long long s = (long long)blockIdx.x * PATCH_THREADS + threadIdx.x;
    if (s >= n_slots) return;
    const long long row = s / D;
    const int d = (int)(s - row * D);
    const float* dp = dphi + row * ld_dphi;
    float v = e[s];
    if (GATHER) {
        const float* t = tab + (long long)min(max(ids[s], 0), n_src - 1) * ld_tab;
        for (int j = 0; j < m; ++j) v += dp[j] * t[j];
    } else {
        const float* p = psi_blk + (size_t)row * m * D + d;
        for (int j = 0; j < m; ++j) v += dp[j] * p[(size_t)j * D];
    }
    e[s] = v;
}

// psi_blk: (C, m, D) contiguous, or null in the gather form; tab: the ψ slab
// (n_src, m), row stride ld_tab, columns contiguous, or null in the
// pre-gathered form; ids, alpha, e: (C, D) contiguous; q_out (C, m) and
// p_out (C, m, m) contiguous.
extern "C" int cd_slab_reduce_f32(const float* psi_blk, const float* tab, long long ld_tab,
                                  int n_src, const int* ids, const float* alpha, const float* e,
                                  float* q_out, float* p_out, int C, int D, int m,
                                  void* stream) {
    const bool gather = tab != nullptr;
    if (C < 0 || D < 1 || m < 1 || alpha == nullptr || e == nullptr || q_out == nullptr ||
        p_out == nullptr || (gather && (n_src < 1 || ids == nullptr || ld_tab < m)) ||
        (!gather && psi_blk == nullptr))
        return (int)cudaErrorInvalidValue;
    if (C == 0) return (int)cudaSuccess;
    const int blocks = (C + SLAB_WARPS - 1) / SLAB_WARPS;
    cudaStream_t st = (cudaStream_t)stream;
    if (gather)
        cd_slab_reduce_kernel<true><<<blocks, 32 * SLAB_WARPS, 0, st>>>(
            psi_blk, tab, ld_tab, n_src, ids, alpha, e, q_out, p_out, C, D, m);
    else
        cd_slab_reduce_kernel<false><<<blocks, 32 * SLAB_WARPS, 0, st>>>(
            psi_blk, tab, ld_tab, n_src, ids, alpha, e, q_out, p_out, C, D, m);
    return (int)cudaGetLastError();
}

// dphi: (C, m), row stride ld_dphi, columns contiguous; e: (C, D)
// contiguous, updated in place; the rest as above.
extern "C" int cd_resid_patch_f32(const float* psi_blk, const float* tab, long long ld_tab,
                                  int n_src, const int* ids, float* e, const float* dphi,
                                  long long ld_dphi, int C, int D, int m, void* stream) {
    const bool gather = tab != nullptr;
    if (C < 0 || D < 1 || m < 1 || e == nullptr || dphi == nullptr || ld_dphi < 0 ||
        (gather && (n_src < 1 || ids == nullptr || ld_tab < m)) ||
        (!gather && psi_blk == nullptr))
        return (int)cudaErrorInvalidValue;
    if (C == 0) return (int)cudaSuccess;
    const long long n_slots = (long long)C * D;
    const long long blocks = (n_slots + PATCH_THREADS - 1) / PATCH_THREADS;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (gather)
        cd_resid_patch_kernel<true><<<(unsigned)blocks, PATCH_THREADS, 0, st>>>(
            psi_blk, tab, ld_tab, n_src, ids, e, dphi, ld_dphi, n_slots, D, m);
    else
        cd_resid_patch_kernel<false><<<(unsigned)blocks, PATCH_THREADS, 0, st>>>(
            psi_blk, tab, ld_tab, n_src, ids, e, dphi, ld_dphi, n_slots, D, m);
    return (int)cudaGetLastError();
}

extern "C" const char* cd_slab_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
