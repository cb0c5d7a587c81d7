// Fused multi-column iCD block sweep (the f*-loop of the paper's
// Algorithm 2, k_b columns at a time), hand-written for Hopper (sm_90a).
//
// Replaces: repro/kernels/cd_sweep/kernel.py, cd_block_sweep_pallas (body
// _sweep_kernel), cd_block_sweep_gather_pallas (body _sweep_gather_kernel),
// cd_block_sweep_rowpatch_pallas (body _sweep_rowpatch_kernel) and
// cd_block_sweep_rowpatch_gather_pallas (body _sweep_rowpatch_gather_kernel);
// repro/kernels/cd_update/kernel.py's cd_column_update_pallas is the k_b = 1
// launch of the first. Same function, per context row r of the padded
// (C, D_pad) layout, for j = 0 .. k_b−1 in order (exact Gauss–Seidel):
//   L'/2  = Σ_d α·e·ψ_j        L''/2 = Σ_d α·ψ_j²
//   Δ     = −η·(L'/2 + α₀R'_j + λw_j) / max(L''/2 + α₀P(j,j) + λ, 1e-12)
//   w_j  += Δ      e += Δ·ψ_j      R' += Δ·P(j,·)
// P is the coupling block: one (k_b, k_b) Gram block J shared by every row
// (MF, the item sweep of the tensor models), or the row's own patch P[r]
// (the context modes of PARAFAC, CtxMF and Tucker, whose R'/R'' coupling
// depends on the row). ψ_j[r,d] comes from a pre-gathered (C, k_b, D_pad)
// tile, or, in the gather form, from tab[ids[r,d], j] of the (n_src, k_b) ψ
// slab with the id clipped to [0, n_src) as jnp.take(mode="clip") does. e is
// updated in place.
//
// What bounds it on an H100: the bytes. One dispatch must read ids, α and
// e and write e (16 B a slot), read W and R' and write W (12 B a row and
// column), read P (4·k_b² B a row, row-patch form) and read the ψ slab once;
// it does ≈ 8 FLOP a slot and column, far below the card's rate.
//
// Two launch forms (kernels/vmem.py cd_sweep_form picks one):
//
// Warp-row form. Rows are independent and the k_b steps of a row are
// sequential, so one warp owns one row. A block of warps stages each row's
// e, α (and ids) in shared memory once, runs all k_b steps on them — two
// warp reductions per step, Δ broadcast by the butterfly (every lane ends
// with the same sum), the e patch, and the R' patch by the warp's lanes
// over the k_b columns of P(j,·) — and writes e and W back once. A lane owns
// the slots d ≡ lane (mod 32), so only R', W and P are shared inside the
// warp. ψ_j is loaded once a step into a per-row shared scratch row for the
// e patch. Rows past C are skipped, so no padding is needed. Shared memory
// per block: J (k_b² floats, shared form) plus, per row, R' and W (k_b
// each), P (k_b², row-patch form) and e, α, ψ_j (and ids) of D_pad slots;
// above 48 KB it is opted into at launch.
//
// Block-row form, for rows too long for a block's shared memory (a context
// mode of a few hour-of-day buckets has rows of ≈ 142,000 slots). One
// block of CD_BLOCK_ROW_THREADS threads owns one row; e, α and ids stay in
// device memory (a thread owns the slots d ≡ tid mod the block size, so e
// needs no synchronisation). Each step is a pass over the row accumulating
// L'/2 and L''/2 per thread, a block reduction in a fixed order (warp
// butterflies, then every thread sums the per-warp partials in warp order,
// so every run gives the same bits), Δ, the e patch over the row, and the R'
// patch. Its traffic is two passes over the row a step, 2·k_b in all, not
// one; with few rows it also leaves most SMs idle.
//
// Interface: a plain C function bound with ctypes. It launches on the
// caller's stream, allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef CD_BLOCK_ROW_THREADS
#define CD_BLOCK_ROW_THREADS 1024
#endif

#define FULL_MASK 0xffffffffu

template <bool GATHER>
__device__ __forceinline__ float psi_at(const float* __restrict__ psi_blk,
                                        const float* __restrict__ tab, long long ld_tab,
                                        int n_src, const int* __restrict__ ids,
                                        long long row, int kb, int D, int j, int d) {
    if (GATHER) {
        const int id = min(max(ids[(size_t)row * D + d], 0), n_src - 1);
        return tab[(long long)id * ld_tab + j];
    }
    return psi_blk[((size_t)row * kb + j) * D + d];
}

// Warp-row form. ROWPATCH: each row stages its own P[r] (read with P's
// strides cs0, cs1, cs2); otherwise one J block (strides cs1, cs2) is shared.
template <bool GATHER, bool ROWPATCH>
__global__ void cd_sweep_kernel(const float* __restrict__ psi_blk,  // (C, kb, D)
                                const float* __restrict__ tab, long long ld_tab, int n_src,
                                const int* __restrict__ ids,        // (C, D)
                                const float* __restrict__ alpha,    // (C, D)
                                float* __restrict__ e,              // (C, D), in place
                                const float* __restrict__ w_in, long long ld_w,
                                const float* __restrict__ r1_in, long long ld_r1,
                                const float* __restrict__ cpl, long long cs0,
                                long long cs1, long long cs2,
                                float* __restrict__ w_out,          // (C, kb)
                                int C, int D, int kb, float alpha0, float l2, float eta,
                                int rows_per_block) {
    extern __shared__ float smem[];
    const int shared_j = ROWPATCH ? 0 : kb * kb;
    if (!ROWPATCH) {
        for (int t = threadIdx.x; t < kb * kb; t += blockDim.x)
            smem[t] = cpl[(long long)(t / kb) * cs1 + (long long)(t % kb) * cs2];
        __syncthreads();
    }

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const long long row = (long long)blockIdx.x * rows_per_block + warp;
    if (row >= C) return;
    const int per_row = 2 * kb + (ROWPATCH ? kb * kb : 0) + (GATHER ? 4 : 3) * D;
    float* r1 = smem + shared_j + (size_t)warp * per_row;
    float* wv = r1 + kb;
    float* P = ROWPATCH ? wv + kb : smem;
    float* es = wv + kb + (ROWPATCH ? kb * kb : 0);
    float* as = es + D;
    float* ps = as + D;
    int* is = reinterpret_cast<int*>(ps + D);

    const size_t g = (size_t)row * D;
    for (int f = lane; f < kb; f += 32) {
        r1[f] = r1_in[row * ld_r1 + f];
        wv[f] = w_in[row * ld_w + f];
    }
    if (ROWPATCH)
        for (int t = lane; t < kb * kb; t += 32)
            P[t] = cpl[row * cs0 + (long long)(t / kb) * cs1 + (long long)(t % kb) * cs2];
    for (int d = lane; d < D; d += 32) {
        es[d] = e[g + d];
        as[d] = alpha[g + d];
        if (GATHER) is[d] = min(max(ids[g + d], 0), n_src - 1);
    }
    __syncwarp();

    for (int j = 0; j < kb; ++j) {
        float lp = 0.f, lpp = 0.f;
        for (int d = lane; d < D; d += 32) {
            const float p = GATHER ? tab[(long long)is[d] * ld_tab + j]
                                   : psi_blk[((size_t)row * kb + j) * D + d];
            ps[d] = p;
            const float a = as[d];
            lp += a * es[d] * p;
            lpp += a * p * p;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
            lp += __shfl_xor_sync(FULL_MASK, lp, o);
            lpp += __shfl_xor_sync(FULL_MASK, lpp, o);
        }
        const float num = lp + alpha0 * r1[j] + l2 * wv[j];
        const float den = lpp + alpha0 * P[j * kb + j] + l2;
        const float delta = -eta * num / fmaxf(den, 1e-12f);
        __syncwarp();  // every lane has read r1[j] and wv[j]
        for (int d = lane; d < D; d += 32) es[d] += delta * ps[d];
        for (int f = lane; f < kb; f += 32) r1[f] += delta * P[j * kb + f];
        if (lane == 0) wv[j] += delta;
        __syncwarp();
    }

    for (int d = lane; d < D; d += 32) e[g + d] = es[d];
    for (int f = lane; f < kb; f += 32) w_out[row * kb + f] = wv[f];
}

// Block-row form: one block per row, e/α/ids read from device memory on
// every step. cs0 = 0 reads the one shared J block for every row.
template <bool GATHER>
__global__ void __launch_bounds__(CD_BLOCK_ROW_THREADS)
cd_sweep_block_row_kernel(const float* __restrict__ psi_blk,
                          const float* __restrict__ tab, long long ld_tab, int n_src,
                          const int* __restrict__ ids, const float* __restrict__ alpha,
                          float* __restrict__ e,
                          const float* __restrict__ w_in, long long ld_w,
                          const float* __restrict__ r1_in, long long ld_r1,
                          const float* __restrict__ cpl, long long cs0, long long cs1,
                          long long cs2, float* __restrict__ w_out, int D, int kb,
                          float alpha0, float l2, float eta) {
    constexpr int WARPS = CD_BLOCK_ROW_THREADS / 32;
    extern __shared__ float smem[];
    float* P = smem;          // (kb, kb) coupling block of this row
    float* r1 = P + kb * kb;  // R' slab
    float* wv = r1 + kb;      // W slab
    float* red = wv + kb;     // 2·WARPS per-warp partial sums
    const long long row = blockIdx.x;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const size_t g = (size_t)row * D;

    for (int t = tid; t < kb * kb; t += CD_BLOCK_ROW_THREADS)
        P[t] = cpl[row * cs0 + (long long)(t / kb) * cs1 + (long long)(t % kb) * cs2];
    for (int f = tid; f < kb; f += CD_BLOCK_ROW_THREADS) {
        r1[f] = r1_in[row * ld_r1 + f];
        wv[f] = w_in[row * ld_w + f];
    }
    __syncthreads();

    for (int j = 0; j < kb; ++j) {
        float lp = 0.f, lpp = 0.f;
#pragma unroll 4
        for (int d = tid; d < D; d += CD_BLOCK_ROW_THREADS) {
            const float p = psi_at<GATHER>(psi_blk, tab, ld_tab, n_src, ids, row, kb, D, j, d);
            const float a = alpha[g + d];
            lp += a * e[g + d] * p;
            lpp += a * p * p;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
            lp += __shfl_xor_sync(FULL_MASK, lp, o);
            lpp += __shfl_xor_sync(FULL_MASK, lpp, o);
        }
        if (lane == 0) {
            red[warp] = lp;
            red[WARPS + warp] = lpp;
        }
        __syncthreads();
        lp = 0.f;
        lpp = 0.f;
        for (int w = 0; w < WARPS; ++w) {  // the same order in every thread
            lp += red[w];
            lpp += red[WARPS + w];
        }
        const float num = lp + alpha0 * r1[j] + l2 * wv[j];
        const float den = lpp + alpha0 * P[j * kb + j] + l2;
        const float delta = -eta * num / fmaxf(den, 1e-12f);
        __syncthreads();  // every thread has read red, r1[j] and wv[j]
        for (int f = tid; f < kb; f += CD_BLOCK_ROW_THREADS) r1[f] += delta * P[j * kb + f];
        if (tid == 0) wv[j] += delta;
#pragma unroll 4
        for (int d = tid; d < D; d += CD_BLOCK_ROW_THREADS)
            e[g + d] += delta * psi_at<GATHER>(psi_blk, tab, ld_tab, n_src, ids, row, kb, D, j, d);
    }
    __syncthreads();
    for (int f = tid; f < kb; f += CD_BLOCK_ROW_THREADS) w_out[row * kb + f] = wv[f];
}

template <typename Kernel, typename... Args>
static cudaError_t launch(Kernel kernel, int blocks, int threads, size_t smem,
                          cudaStream_t st, Args... args) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<blocks, threads, smem, st>>>(args...);
    return cudaGetLastError();
}

// psi_blk: (C, kb, D) contiguous, or null in the gather form; tab: the ψ
// slab, row stride ld_tab, columns contiguous, or null in the pre-gathered
// form; ids, alpha, e: (C, D) contiguous; w_in, r1_in: (C, kb) with row
// strides; cpl: the coupling block, element (r, i, f) at r·cs0 + i·cs1 +
// f·cs2 — cs0 = 0 for one (kb, kb) block J shared by every row, else the
// per-row patch P; w_out: (C, kb) contiguous. rows_per_block ≥ 1 launches
// the warp-row form with that many rows (warps) a block; 0 launches the
// block-row form, one row a block.
extern "C" int cd_sweep_f32(const float* psi_blk, const float* tab, long long ld_tab,
                            int n_src, const int* ids, const float* alpha, float* e,
                            const float* w_in, long long ld_w, const float* r1_in,
                            long long ld_r1, const float* cpl, long long cs0, long long cs1,
                            long long cs2, float* w_out, int C, int D, int kb, float alpha0,
                            float l2, float eta, int rows_per_block, void* stream) {
    const bool gather = tab != nullptr;
    const bool rowpatch = cs0 != 0;
    if (C < 0 || D < 1 || kb < 1 || rows_per_block < 0 || rows_per_block > 32 ||
        cpl == nullptr || (gather && (n_src < 1 || ids == nullptr)) ||
        (!gather && psi_blk == nullptr))
        return (int)cudaErrorInvalidValue;
    if (C == 0) return (int)cudaSuccess;
    cudaStream_t st = (cudaStream_t)stream;

    if (rows_per_block == 0) {
        const size_t smem =
            sizeof(float) * ((size_t)kb * kb + 2 * kb + 2 * (CD_BLOCK_ROW_THREADS / 32));
        auto kernel = gather ? cd_sweep_block_row_kernel<true> : cd_sweep_block_row_kernel<false>;
        return (int)launch(kernel, C, CD_BLOCK_ROW_THREADS, smem, st, psi_blk, tab, ld_tab,
                           n_src, ids, alpha, e, w_in, ld_w, r1_in, ld_r1, cpl, cs0, cs1, cs2,
                           w_out, D, kb, alpha0, l2, eta);
    }

    const size_t per_row = 2 * (size_t)kb + (rowpatch ? (size_t)kb * kb : 0) +
                           (size_t)(gather ? 4 : 3) * D;
    const size_t smem =
        sizeof(float) * ((rowpatch ? 0 : (size_t)kb * kb) + (size_t)rows_per_block * per_row);
    const int blocks = (C + rows_per_block - 1) / rows_per_block;
    auto kernel = gather ? (rowpatch ? cd_sweep_kernel<true, true> : cd_sweep_kernel<true, false>)
                         : (rowpatch ? cd_sweep_kernel<false, true> : cd_sweep_kernel<false, false>);
    return (int)launch(kernel, blocks, 32 * rows_per_block, smem, st, psi_blk, tab, ld_tab, n_src,
                       ids, alpha, e, w_in, ld_w, r1_in, ld_r1, cpl, cs0, cs1, cs2, w_out, C, D,
                       kb, alpha0, l2, eta, rows_per_block);
}

extern "C" const char* cd_sweep_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
