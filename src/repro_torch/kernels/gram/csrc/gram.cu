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
// CUDA cores). It is bound by operations, and stays on the CUDA cores in
// fp32 FMAs: the tensor cores take no fp32 inputs, and TF32 or 3xTF32 is
// not what the reference computes.
//
// Design. The TPU kernel walked row blocks in order into one resident
// (k_pad, k_pad) accumulator; Hopper runs blocks in parallel and in no
// order. So:
//   pass 1 — J is cut into GRAM_PANEL-wide panels (one panel for k ≤ 128).
//     A block owns one panel pair on or below the diagonal over one
//     contiguous range of rows, so X is read once for k ≤ 128. It streams
//     its rows through a GRAM_STAGES-deep ring of GRAM_CHUNK-row stages in
//     shared memory, filled by cp.async (16-byte copies where the rows are
//     16-byte aligned, zero-filled past k and past the range), so the next
//     chunks are in flight while the FMAs run on the current one.
//     A diagonal panel's lower triangle holds 136 tiles of 8 × 8, 8 · 17:
//     tile row p is folded onto tile row 15 − p, which gives 8 folded rows
//     of 17 tiles. Each of the block's 128 threads keeps one 8 × 8 tile of
//     its folded row in registers plus one 2 × 2 piece of the folded row's
//     17th tile (a diagonal tile, split over the row's 16 threads): 68 FMAs
//     a staged row against 6 shared-memory loads, and no thread computes a
//     tile above the diagonal. An off-diagonal panel pair (k > 128) gives
//     each of 256 threads one 8 × 8 tile of the 128 × 128 product. Within
//     a staged row the 16-byte groups are swizzled (group q at q ^ bit 3 of
//     q) so that a warp's 16 distinct column groups spread over all banks.
//     The weight is staged beside the rows and folded into the row-side
//     operand in registers. A thread loads the next staged row's operands
//     while its FMAs run on the current one (two register sets), and
//     __launch_bounds__ keeps GRAM_MIN_BLOCKS blocks on an SM.
//   pass 2 — J[i][j] for i ≥ j is the sum of the row splits' partial tiles
//     in a fixed order (8 interleaved runs in split order, then the 8 run
//     sums in order), written to J[i][j] and J[j][i]. No atomics: the
//     result depends only on rows and k, the same on every run.
//
// Interface: a plain C function bound with ctypes. It launches on the
// caller's stream, allocates nothing (the partial tiles come from the
// wrapper) and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#if !defined(GRAM_PANEL) || !defined(GRAM_CHUNK) || !defined(GRAM_STAGES) || \
    !defined(GRAM_REDUCE_RUNS) || !defined(GRAM_MIN_BLOCKS)
#error "build through repro_torch/kernels/gram/kernel.py, which passes the tile sizes"
#endif

static_assert(GRAM_PANEL == 128, "the fold maps 16 tile rows of 8 onto 128 threads");
static_assert(GRAM_STAGES >= 2, "a ring of at least two stages");

#define DIAG_THREADS 128  // 8 folded tile rows × 16 threads
#define OFF_THREADS 256   // 16 × 16 tiles of 8 × 8
#define ROW_VEC (GRAM_PANEL / 4)  // 16-byte groups in a staged row

static_assert((GRAM_CHUNK * ROW_VEC) % DIAG_THREADS == 0, "copies split evenly");
static_assert(GRAM_CHUNK <= DIAG_THREADS, "one thread stages each row's weight");

// Bytes of one ring stage: the strips' rows, then the rows' weights.
__host__ __device__ constexpr int stage_floats(int strips) {
    return strips * GRAM_CHUNK * GRAM_PANEL + GRAM_CHUNK;
}

// Physical 16-byte group of logical group q in a staged row.
__device__ __forceinline__ int swz(int q) { return q ^ ((q >> 3) & 1); }

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, int bytes) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
                 "r"(bytes));
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem, int bytes) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
                 "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy rows [r0, r0 + GRAM_CHUNK) ∩ [.., r_end) of the STRIPS column strips
// starting at columns col[s] into one stage; zeros past k and past r_end.
template <int STRIPS, int THREADS, bool VEC, bool WEIGHTED>
__device__ __forceinline__ void stage_rows(float* st, const float* __restrict__ x, int ldx,
                                           const float* __restrict__ w, int k, int r0,
                                           int r_end, const int (&col)[STRIPS]) {
    const int t = threadIdx.x;
#pragma unroll
    for (int s = 0; s < STRIPS; ++s) {
#pragma unroll
        for (int i = 0; i < GRAM_CHUNK * ROW_VEC / THREADS; ++i) {
            const int idx = t + i * THREADS;
            const int rr = idx / ROW_VEC, q = idx % ROW_VEC;
            const int r = r0 + rr, c = col[s] + 4 * q;
            float* dst = st + (s * GRAM_CHUNK + rr) * GRAM_PANEL + 4 * swz(q);
            const float* src = x + (size_t)r * ldx + c;
            if (VEC) {
                const int bytes = r < r_end ? 4 * max(0, min(4, k - c)) : 0;
                cp_async16(dst, bytes ? src : x, bytes);
            } else {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const bool in = r < r_end && c + e < k;
                    cp_async4(dst + e, in ? src + e : x, in ? 4 : 0);
                }
            }
        }
    }
    if (WEIGHTED && t < GRAM_CHUNK) {
        const bool in = r0 + t < r_end;
        cp_async4(st + STRIPS * GRAM_CHUNK * GRAM_PANEL + t, in ? w + r0 + t : w, in ? 4 : 0);
    }
}

// Offset (in floats, within a staged row) of logical columns 4q' .. of an
// 8-column group g: its two 16-byte halves.
__device__ __forceinline__ int grp_lo(int g) { return 4 * swz(2 * g); }
__device__ __forceinline__ int grp_hi(int g) { return 4 * swz(2 * g + 1); }

__device__ __forceinline__ void load8(const float* row, int lo, int hi, float (&v)[8]) {
    const float4 a = *reinterpret_cast<const float4*>(row + lo);
    const float4 b = *reinterpret_cast<const float4*>(row + hi);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// Pass 1, diagonal panels. grid = (panels, splits), DIAG_THREADS threads.
// Thread t: folded row p = t / 16, f = t % 16; its 8 × 8 tile is (p, f) for
// f ≤ p, else (15 − p, f − p − 1); its 2 × 2 piece is piece (f / 4, f % 4)
// of the diagonal tile (15 − p, 15 − p). Partial tiles go to
// partial[split][i][j] for i ≥ j only.
template <bool VEC, bool WEIGHTED>
__global__ void __launch_bounds__(DIAG_THREADS, GRAM_MIN_BLOCKS)
gram_diag_kernel(const float* __restrict__ x, int ldx, const float* __restrict__ w, int rows,
                 int k, int rows_per_split, float* __restrict__ partial) {
    extern __shared__ __align__(16) float smem[];
    const int panel = blockIdx.x, split = blockIdx.y;
    const int c0 = panel * GRAM_PANEL;
    const int r_begin = split * rows_per_split;
    const int r_end = min(rows, r_begin + rows_per_split);
    const int n_chunks = r_end > r_begin ? (r_end - r_begin + GRAM_CHUNK - 1) / GRAM_CHUNK : 0;
    const int t = threadIdx.x;
    const int p = t >> 4, f = t & 15;
    const int ti = f <= p ? p : 15 - p;
    const int tj = f <= p ? f : f - p - 1;
    const int dg = 15 - p, si = f >> 2, sj = f & 3;
    const int a_lo = grp_lo(ti), a_hi = grp_hi(ti), b_lo = grp_lo(tj), b_hi = grp_hi(tj);
    // the 2 × 2 piece: columns 8·dg + 2·si (+1) and 8·dg + 2·sj (+1)
    const int a2 = 4 * swz(2 * dg + (si >> 1)) + 2 * (si & 1);
    const int b2 = 4 * swz(2 * dg + (sj >> 1)) + 2 * (sj & 1);
    const int col[1] = {c0};

    float acc[8][8], acc2[2][2];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    acc2[0][0] = acc2[0][1] = acc2[1][0] = acc2[1][1] = 0.f;

#pragma unroll
    for (int s = 0; s < GRAM_STAGES - 1; ++s) {
        if (s < n_chunks)
            stage_rows<1, DIAG_THREADS, VEC, WEIGHTED>(smem + s * stage_floats(1), x, ldx, w,
                                                       k, r_begin + s * GRAM_CHUNK, r_end, col);
        cp_async_commit();
    }
    for (int c = 0; c < n_chunks; ++c) {
        cp_async_wait<GRAM_STAGES - 2>();
        __syncthreads();
        const int nc = c + GRAM_STAGES - 1;
        if (nc < n_chunks)
            stage_rows<1, DIAG_THREADS, VEC, WEIGHTED>(
                smem + (nc % GRAM_STAGES) * stage_floats(1), x, ldx, w, k,
                r_begin + nc * GRAM_CHUNK, r_end, col);
        cp_async_commit();
        const float* st = smem + (c % GRAM_STAGES) * stage_floats(1);
        // the next row's operands are loaded while this row's FMAs run
        float a[2][8], b[2][8];
        float2 u[2], v[2];
        auto operands = [&](int rr, int s) {
            const float* row = st + rr * GRAM_PANEL;
            load8(row, a_lo, a_hi, a[s]);
            load8(row, b_lo, b_hi, b[s]);
            u[s] = *reinterpret_cast<const float2*>(row + a2);
            v[s] = *reinterpret_cast<const float2*>(row + b2);
            if (WEIGHTED) {
                const float wr = st[GRAM_CHUNK * GRAM_PANEL + rr];
#pragma unroll
                for (int i = 0; i < 8; ++i) a[s][i] *= wr;
                u[s].x *= wr;
                u[s].y *= wr;
            }
        };
        operands(0, 0);
#pragma unroll
        for (int rr = 0; rr < GRAM_CHUNK; ++rr) {
            const int s = rr & 1;
            if (rr + 1 < GRAM_CHUNK) operands(rr + 1, s ^ 1);
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[s][i], b[s][j], acc[i][j]);
            acc2[0][0] = fmaf(u[s].x, v[s].x, acc2[0][0]);
            acc2[0][1] = fmaf(u[s].x, v[s].y, acc2[0][1]);
            acc2[1][0] = fmaf(u[s].y, v[s].x, acc2[1][0]);
            acc2[1][1] = fmaf(u[s].y, v[s].y, acc2[1][1]);
        }
    }
    cp_async_wait<0>();

    float* out = partial + (size_t)split * k * k;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int gi = c0 + 8 * ti + i;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int gj = c0 + 8 * tj + j;
            if (gi < k && gj <= gi) out[(size_t)gi * k + gj] = acc[i][j];
        }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int gi = c0 + 8 * dg + 2 * si + i;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            const int gj = c0 + 8 * dg + 2 * sj + j;
            if (gi < k && gj <= gi) out[(size_t)gi * k + gj] = acc2[i][j];
        }
    }
}

// Pass 1, off-diagonal panel pairs (k > GRAM_PANEL). grid = (pairs, splits),
// OFF_THREADS threads; blockIdx.x enumerates (P, Q), Q < P, row by row.
// Thread t owns tile (t / 16, t % 16) of J's rows of panel P × columns of
// panel Q.
template <bool VEC, bool WEIGHTED>
__global__ void __launch_bounds__(OFF_THREADS, 2)
gram_off_kernel(const float* __restrict__ x, int ldx, const float* __restrict__ w, int rows,
                int k, int rows_per_split, float* __restrict__ partial) {
    extern __shared__ __align__(16) float smem[];
    int pi = 1;
    while ((pi + 1) * pi / 2 <= (int)blockIdx.x) ++pi;
    const int pj = blockIdx.x - pi * (pi - 1) / 2;
    const int split = blockIdx.y;
    const int r_begin = split * rows_per_split;
    const int r_end = min(rows, r_begin + rows_per_split);
    const int n_chunks = r_end > r_begin ? (r_end - r_begin + GRAM_CHUNK - 1) / GRAM_CHUNK : 0;
    const int t = threadIdx.x, ti = t >> 4, tj = t & 15;
    const int a_lo = grp_lo(ti), a_hi = grp_hi(ti);
    const int b_lo = GRAM_CHUNK * GRAM_PANEL + grp_lo(tj);
    const int b_hi = GRAM_CHUNK * GRAM_PANEL + grp_hi(tj);
    const int col[2] = {pi * GRAM_PANEL, pj * GRAM_PANEL};

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
    for (int s = 0; s < GRAM_STAGES - 1; ++s) {
        if (s < n_chunks)
            stage_rows<2, OFF_THREADS, VEC, WEIGHTED>(smem + s * stage_floats(2), x, ldx, w, k,
                                                      r_begin + s * GRAM_CHUNK, r_end, col);
        cp_async_commit();
    }
    for (int c = 0; c < n_chunks; ++c) {
        cp_async_wait<GRAM_STAGES - 2>();
        __syncthreads();
        const int nc = c + GRAM_STAGES - 1;
        if (nc < n_chunks)
            stage_rows<2, OFF_THREADS, VEC, WEIGHTED>(
                smem + (nc % GRAM_STAGES) * stage_floats(2), x, ldx, w, k,
                r_begin + nc * GRAM_CHUNK, r_end, col);
        cp_async_commit();
        const float* st = smem + (c % GRAM_STAGES) * stage_floats(2);
        float a[2][8], b[2][8];
        auto operands = [&](int rr, int s) {
            const float* row = st + rr * GRAM_PANEL;
            load8(row, a_lo, a_hi, a[s]);
            load8(row, b_lo, b_hi, b[s]);
            if (WEIGHTED) {
                const float wr = st[2 * GRAM_CHUNK * GRAM_PANEL + rr];
#pragma unroll
                for (int i = 0; i < 8; ++i) a[s][i] *= wr;
            }
        };
        operands(0, 0);
#pragma unroll
        for (int rr = 0; rr < GRAM_CHUNK; ++rr) {
            const int s = rr & 1;
            if (rr + 1 < GRAM_CHUNK) operands(rr + 1, s ^ 1);
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[s][i], b[s][j], acc[i][j]);
        }
    }
    cp_async_wait<0>();

    float* out = partial + (size_t)split * k * k;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int gi = col[0] + 8 * ti + i;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int gj = col[1] + 8 * tj + j;
            if (gi < k && gj < k) out[(size_t)gi * k + gj] = acc[i][j];
        }
    }
}

// Pass 2. 32 elements a block, GRAM_REDUCE_RUNS warps: warp g sums splits
// g, g + RUNS, g + 2·RUNS, … in order, then thread e of warp 0 sums the RUNS
// run sums in order. Only the lower triangle is summed; each sum is written
// to J[i][j] and J[j][i].
__global__ void __launch_bounds__(32 * GRAM_REDUCE_RUNS)
gram_reduce_kernel(const float* __restrict__ partial, int splits, int k,
                   float* __restrict__ out) {
    __shared__ float run[GRAM_REDUCE_RUNS][32];
    const int e = threadIdx.x & 31, g = threadIdx.x >> 5;
    const long long p = (long long)blockIdx.x * 32 + e;
    const long long kk = (long long)k * k;
    const int i = (int)(p / k), j = (int)(p % k);
    const bool live = p < kk && j <= i;
    float s = 0.f;
    if (live) {
#pragma unroll 4
        for (int t = g; t < splits; t += GRAM_REDUCE_RUNS) s += partial[t * kk + p];
    }
    run[g][e] = s;
    __syncthreads();
    if (g == 0 && live) {
        float total = run[0][e];
#pragma unroll
        for (int r = 1; r < GRAM_REDUCE_RUNS; ++r) total += run[r][e];
        out[p] = total;
        out[(size_t)j * k + i] = total;
    }
}

template <bool VEC, bool WEIGHTED>
static cudaError_t launch_pass1(const float* x, int ldx, const float* w, int rows, int k,
                                int splits, int rows_per_split, float* partial,
                                cudaStream_t st) {
    const int panels = (k + GRAM_PANEL - 1) / GRAM_PANEL;
    const size_t diag_bytes = sizeof(float) * GRAM_STAGES * stage_floats(1);
    cudaError_t err = cudaFuncSetAttribute(gram_diag_kernel<VEC, WEIGHTED>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)diag_bytes);
    if (err != cudaSuccess) return err;
    gram_diag_kernel<VEC, WEIGHTED><<<dim3(panels, splits), DIAG_THREADS, diag_bytes, st>>>(
        x, ldx, w, rows, k, rows_per_split, partial);
    err = cudaGetLastError();
    if (err != cudaSuccess || panels < 2) return err;
    const size_t off_bytes = sizeof(float) * GRAM_STAGES * stage_floats(2);
    err = cudaFuncSetAttribute(gram_off_kernel<VEC, WEIGHTED>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)off_bytes);
    if (err != cudaSuccess) return err;
    gram_off_kernel<VEC, WEIGHTED><<<dim3(panels * (panels - 1) / 2, splits), OFF_THREADS,
                                     off_bytes, st>>>(x, ldx, w, rows, k, rows_per_split,
                                                      partial);
    return cudaGetLastError();
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
    const bool vec = ((uintptr_t)x & 15) == 0 && ldx % 4 == 0;
    cudaError_t err;
    if (vec)
        err = w != nullptr
                  ? launch_pass1<true, true>(x, ldx, w, rows, k, splits, rows_per_split, partial, st)
                  : launch_pass1<true, false>(x, ldx, w, rows, k, splits, rows_per_split, partial, st);
    else
        err = w != nullptr
                  ? launch_pass1<false, true>(x, ldx, w, rows, k, splits, rows_per_split, partial, st)
                  : launch_pass1<false, false>(x, ldx, w, rows, k, splits, rows_per_split, partial, st);
    if (err != cudaSuccess) return (int)err;
    const long long kk = (long long)k * k;
    gram_reduce_kernel<<<(unsigned)((kk + 31) / 32), 32 * GRAM_REDUCE_RUNS, 0, st>>>(
        partial, splits, k, out);
    return (int)cudaGetLastError();
}

extern "C" const char* gram_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
