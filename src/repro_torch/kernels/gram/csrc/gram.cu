// Gram matrix J = XᵀX, or Xᵀ·diag(w)·X, of a tall-skinny fp32 matrix,
// hand-written for Hopper (sm_90a).
//
// Replaces: repro/kernels/gram/kernel.py, gram_pallas (bodies _gram_kernel
// and _gram_weighted_kernel). Same function: X (rows, k) fp32, optional
// per-row weights w (rows,), result (k, k) fp32 with fp32 accumulation.
//
// What bounds it on an H100: at icd-mf's full width (200,000 × 128 and
// 68,000 × 128) a call reads X once (102 MB / 35 MB, ≈ 0.031 / 0.010 ms at
// 3.35 TB/s). J is symmetric, so the function needs only its k(k+1)/2
// distinct entries, each a rows-long dot product: rows·k·(k+1) FLOP
// (3.3 / 1.1 GFLOP, ≈ 0.049 / 0.017 ms at the 67 TFLOP/s fp32 rate of the
// CUDA cores; no TF32). It is bound by operations.
//
// Design. The TPU kernel walked row blocks in order into one resident
// (k_pad, k_pad) accumulator; Hopper runs blocks in parallel and in no
// order. So:
//   pass 1 — grid (lower-triangle tile pairs × row splits). A block owns
//     one GRAM_TILE × GRAM_TILE tile of J on or below the diagonal (tile
//     row ≥ tile column) and one contiguous range of rows. It
//     stages GRAM_CHUNK rows of the tile's two column strips in shared
//     memory (the weight folded into the first strip) and each of its 256
//     threads accumulates a 4 × 4 patch of the tile in registers with fp32
//     FMAs. The block writes its partial tile to scratch.
//   pass 2 — each thread sums one element of J over the row splits in
//     split order, reading an element above the diagonal tiles from its
//     mirror below them. No atomics: the result is the same on every run.
// Columns past k and rows past the range load as zeros, so any k and any
// row count work without padding; only valid elements are stored.
//
// Interface: a plain C function bound with ctypes. It launches on the
// caller's stream, allocates nothing (the partial tiles come from the
// wrapper) and returns cudaGetLastError().

#include <cuda_runtime.h>

#if !defined(GRAM_TILE) || !defined(GRAM_CHUNK)
#error "build through repro_torch/kernels/gram/kernel.py, which passes the tile sizes"
#endif

#define GRAM_THREADS 256
#define GRAM_SUB 4  // each thread owns a GRAM_SUB × GRAM_SUB patch of the tile

static_assert((GRAM_TILE / GRAM_SUB) * (GRAM_TILE / GRAM_SUB) == GRAM_THREADS,
              "a 256-thread block covers the tile in 4 x 4 patches");
static_assert((GRAM_CHUNK * GRAM_TILE) % GRAM_THREADS == 0,
              "the staged strips split evenly over the threads");

template <bool WEIGHTED>
__global__ void __launch_bounds__(GRAM_THREADS)
gram_partial_kernel(const float* __restrict__ x, int ldx, const float* __restrict__ w,
                    int rows, int k, int rows_per_split, float* __restrict__ partial) {
    __shared__ __align__(16) float a_s[GRAM_CHUNK][GRAM_TILE];
    __shared__ __align__(16) float b_s[GRAM_CHUNK][GRAM_TILE];

    // blockIdx.x enumerates the tiles (ti, tj) with tj ≤ ti row by row
    int ti = 0;
    while ((ti + 1) * (ti + 2) / 2 <= (int)blockIdx.x) ++ti;
    const int tj = blockIdx.x - ti * (ti + 1) / 2;
    const int i0 = ti * GRAM_TILE;  // J rows of this tile
    const int j0 = tj * GRAM_TILE;  // J columns of this tile
    const int split = blockIdx.y;
    const int r_begin = split * rows_per_split;
    const int r_end = min(rows, r_begin + rows_per_split);
    const int tid = threadIdx.x;
    const int ty = tid / (GRAM_TILE / GRAM_SUB);
    const int tx = tid % (GRAM_TILE / GRAM_SUB);

    float acc[GRAM_SUB][GRAM_SUB];
#pragma unroll
    for (int i = 0; i < GRAM_SUB; ++i)
#pragma unroll
        for (int j = 0; j < GRAM_SUB; ++j) acc[i][j] = 0.f;

    for (int r0 = r_begin; r0 < r_end; r0 += GRAM_CHUNK) {
#pragma unroll
        for (int q = 0; q < GRAM_CHUNK * GRAM_TILE / GRAM_THREADS; ++q) {
            const int idx = tid + q * GRAM_THREADS;
            const int rr = idx / GRAM_TILE, c = idx % GRAM_TILE;
            const int r = r0 + rr;
            float av = 0.f, bv = 0.f;
            if (r < r_end) {
                const float* row = x + (size_t)r * ldx;
                if (i0 + c < k) av = row[i0 + c];
                if (j0 + c < k) bv = row[j0 + c];
                if (WEIGHTED) av *= w[r];
            }
            a_s[rr][c] = av;
            b_s[rr][c] = bv;
        }
        __syncthreads();
#pragma unroll 8
        for (int rr = 0; rr < GRAM_CHUNK; ++rr) {
            const float4 a = *reinterpret_cast<const float4*>(&a_s[rr][ty * GRAM_SUB]);
            const float4 b = *reinterpret_cast<const float4*>(&b_s[rr][tx * GRAM_SUB]);
            const float av[4] = {a.x, a.y, a.z, a.w};
            const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
            for (int i = 0; i < GRAM_SUB; ++i)
#pragma unroll
                for (int j = 0; j < GRAM_SUB; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
        __syncthreads();
    }

    float* out = partial + (size_t)split * k * k;
#pragma unroll
    for (int i = 0; i < GRAM_SUB; ++i) {
        const int gi = i0 + ty * GRAM_SUB + i;
        if (gi >= k) continue;
#pragma unroll
        for (int j = 0; j < GRAM_SUB; ++j) {
            const int gj = j0 + tx * GRAM_SUB + j;
            if (gj < k) out[(size_t)gi * k + gj] = acc[i][j];
        }
    }
}

// J[i][j] = Σ_s partial[s][i][j], summed in split order; pass 1 wrote only
// the tiles on or below the diagonal, so an element of a tile above it is
// read from its mirror J[j][i].
__global__ void gram_reduce_kernel(const float* __restrict__ partial, int splits, int k,
                                   float* __restrict__ out) {
    const int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= k * k) return;
    const int i = p / k, j = p % k;
    const int src = (i / GRAM_TILE >= j / GRAM_TILE) ? p : j * k + i;
    const size_t kk = (size_t)k * k;
    float s = 0.f;
    for (int t = 0; t < splits; ++t) s += partial[t * kk + src];
    out[p] = s;
}

// x: (rows, k) with row stride ldx ≥ k, columns contiguous; w: (rows,) or
// null; partial: (splits, k, k) scratch; out: (k, k).
extern "C" int gram_f32(const float* x, int ldx, const float* w, int rows, int k,
                        int splits, int rows_per_split, float* partial, float* out,
                        void* stream) {
    if (rows < 0 || k < 1 || ldx < k || splits < 1 || splits > 65535 ||
        rows_per_split < 1 || (long long)splits * rows_per_split < rows)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const int tiles = (k + GRAM_TILE - 1) / GRAM_TILE;
    const dim3 grid(tiles * (tiles + 1) / 2, splits);
    if (w != nullptr)
        gram_partial_kernel<true><<<grid, GRAM_THREADS, 0, st>>>(x, ldx, w, rows, k,
                                                                 rows_per_split, partial);
    else
        gram_partial_kernel<false><<<grid, GRAM_THREADS, 0, st>>>(x, ldx, w, rows, k,
                                                                  rows_per_split, partial);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    gram_reduce_kernel<<<(k * k + 255) / 256, 256, 0, st>>>(partial, splits, k, out);
    return (int)cudaGetLastError();
}

extern "C" const char* gram_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
