// Fused multi-column iCD block sweep (the f*-loop of the paper's
// Algorithm 2, k_b columns at a time), hand-written for Hopper (sm_90a).
//
// Replaces: repro/kernels/cd_sweep/kernel.py, cd_block_sweep_pallas (body
// _sweep_kernel) and cd_block_sweep_gather_pallas (body
// _sweep_gather_kernel); repro/kernels/cd_update/kernel.py's
// cd_column_update_pallas is the k_b = 1 launch of the first. Same
// function, per context row r of the padded (C, D_pad) layout, for
// j = 0 .. k_b−1 in order (exact Gauss–Seidel):
//   L'/2  = Σ_d α·e·ψ_j        L''/2 = Σ_d α·ψ_j²
//   Δ     = −η·(L'/2 + α₀R'_j + λw_j) / max(L''/2 + α₀J(j,j) + λ, 1e-12)
//   w_j  += Δ      e += Δ·ψ_j      R' += Δ·J(j,·)
// ψ_j[r,d] comes from a pre-gathered (C, k_b, D_pad) tile, or, in the
// gather form, from tab[ids[r,d], j] of the (n_src, k_b) ψ slab with the id
// clipped to [0, n_src) as jnp.take(mode="clip") does. e is updated in
// place.
//
// What bounds it on an H100: the bytes. One dispatch must read ids, α and
// e and write e (16 B a slot), read W and R' and write W (12 B a row and
// column), and read the ψ slab once; it does ≈ 7 FLOP a slot and column, far
// below the card's rate. At icd-mf's full width that is ≈ 0.12 ms on the
// context side (200,000 × 128 slots) and ≈ 0.33 ms on the item side
// (68,000 × 1,024 slots) at 3.35 TB/s. The gather reads 32-byte sectors of
// the slab at random; the slab (≤ 6.4 MB of sectors) stays in the 50 MB L2.
//
// Design. Rows are independent and the k_b steps of a row are sequential,
// so one warp owns one row. A block of CD_ROWS warps stages each row's e,
// α (and ids) in shared memory once, runs all k_b steps on them — two warp
// reductions per step, Δ broadcast by the butterfly (every lane ends with
// the same sum), the e patch, and the R' patch by the warp's lanes over
// the k_b columns of J(j,·) — and writes e and W back once. A lane owns the
// slots d ≡ lane (mod 32), so only R' and W are shared inside the warp. ψ_j
// is loaded once a step into a per-row shared scratch row for the e patch.
// Rows past C are skipped, so no padding is needed. Shared memory per
// block: J (k_b² floats) plus, per row, R' and W (k_b each) and e, α, ψ_j
// (and ids) of D_pad slots; above 48 KB it is opted into at launch.
//
// Interface: a plain C function bound with ctypes. It launches on the
// caller's stream, allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#define FULL_MASK 0xffffffffu

template <bool GATHER>
__global__ void cd_sweep_kernel(const float* __restrict__ psi_blk,  // (C, kb, D)
                                const float* __restrict__ tab, long long ld_tab, int n_src,
                                const int* __restrict__ ids,        // (C, D)
                                const float* __restrict__ alpha,    // (C, D)
                                float* __restrict__ e,              // (C, D), in place
                                const float* __restrict__ w_in, long long ld_w,
                                const float* __restrict__ r1_in, long long ld_r1,
                                const float* __restrict__ jblk, long long ld_j,
                                float* __restrict__ w_out,          // (C, kb)
                                int C, int D, int kb, float alpha0, float l2, float eta,
                                int rows_per_block) {
    extern __shared__ float smem[];
    float* J = smem;
    for (int t = threadIdx.x; t < kb * kb; t += blockDim.x)
        J[t] = jblk[(long long)(t / kb) * ld_j + t % kb];
    __syncthreads();

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const long long row = (long long)blockIdx.x * rows_per_block + warp;
    if (row >= C) return;
    const int per_row = 2 * kb + (GATHER ? 4 : 3) * D;
    float* r1 = smem + kb * kb + (size_t)warp * per_row;
    float* wv = r1 + kb;
    float* es = wv + kb;
    float* as = es + D;
    float* ps = as + D;
    int* is = reinterpret_cast<int*>(ps + D);

    const size_t g = (size_t)row * D;
    for (int f = lane; f < kb; f += 32) {
        r1[f] = r1_in[row * ld_r1 + f];
        wv[f] = w_in[row * ld_w + f];
    }
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
        const float den = lpp + alpha0 * J[j * kb + j] + l2;
        const float delta = -eta * num / fmaxf(den, 1e-12f);
        __syncwarp();  // every lane has read r1[j] and wv[j]
        for (int d = lane; d < D; d += 32) es[d] += delta * ps[d];
        for (int f = lane; f < kb; f += 32) r1[f] += delta * J[j * kb + f];
        if (lane == 0) wv[j] += delta;
        __syncwarp();
    }

    for (int d = lane; d < D; d += 32) e[g + d] = es[d];
    for (int f = lane; f < kb; f += 32) w_out[row * kb + f] = wv[f];
}

// psi_blk: (C, kb, D) contiguous, or null in the gather form; tab: the ψ
// slab, row stride ld_tab, columns contiguous, or null in the pre-gathered
// form; ids, alpha, e: (C, D) contiguous; w_in, r1_in: (C, kb) with row
// strides; jblk: (kb, kb) with row stride ld_j; w_out: (C, kb) contiguous.
extern "C" int cd_sweep_f32(const float* psi_blk, const float* tab, long long ld_tab,
                            int n_src, const int* ids, const float* alpha, float* e,
                            const float* w_in, long long ld_w, const float* r1_in,
                            long long ld_r1, const float* jblk, long long ld_j,
                            float* w_out, int C, int D, int kb, float alpha0, float l2,
                            float eta, int rows_per_block, void* stream) {
    const bool gather = tab != nullptr;
    if (C < 0 || D < 1 || kb < 1 || rows_per_block < 1 || rows_per_block > 32 ||
        (gather && (n_src < 1 || ids == nullptr)) || (!gather && psi_blk == nullptr))
        return (int)cudaErrorInvalidValue;
    if (C == 0) return (int)cudaSuccess;
    const size_t smem =
        sizeof(float) * ((size_t)kb * kb + (size_t)rows_per_block * (2 * kb + (gather ? 4 : 3) * D));
    const int blocks = (C + rows_per_block - 1) / rows_per_block;
    cudaStream_t st = (cudaStream_t)stream;
    cudaError_t err;
    if (gather) {
        err = cudaFuncSetAttribute(cd_sweep_kernel<true>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        cd_sweep_kernel<true><<<blocks, 32 * rows_per_block, smem, st>>>(
            psi_blk, tab, ld_tab, n_src, ids, alpha, e, w_in, ld_w, r1_in, ld_r1, jblk,
            ld_j, w_out, C, D, kb, alpha0, l2, eta, rows_per_block);
    } else {
        err = cudaFuncSetAttribute(cd_sweep_kernel<false>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        cd_sweep_kernel<false><<<blocks, 32 * rows_per_block, smem, st>>>(
            psi_blk, tab, ld_tab, n_src, ids, alpha, e, w_in, ld_w, r1_in, ld_r1, jblk,
            ld_j, w_out, C, D, kb, alpha0, l2, eta, rows_per_block);
    }
    return (int)cudaGetLastError();
}

extern "C" const char* cd_sweep_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
