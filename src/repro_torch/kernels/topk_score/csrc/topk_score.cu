// Fused score + top-K retrieval over a ψ table (or one row-range shard of
// it), hand-written for Hopper (sm_90a).
//
// Replaces: repro/kernels/topk_score/kernel.py, topk_score_pallas (body
// _score_and_merge). Same function: S = φψᵀ with fp32 accumulation; a
// candidate is admissible when its local row < n_valid and its global id
// (id_offset + local) is not in its φ row's −1-padded exclude-id list; the
// result is the K best per φ row, descending score, ties in ascending
// global id, and (−inf, −1) in every slot no admissible candidate fills.
//
// What bounds it on an H100: at the serving driver's shapes (B = 16 φ rows,
// one shard of 34,000 ψ rows × D = 128, K = 100) one call reads the
// 17.4 MB shard once, ≈ 5.2 µs at 3.35 TB/s, and does 2·16·34,000·128 ≈
// 139 MFLOP, ≈ 2 µs at the 67 TFLOP/s fp32 (non-tensor-core) rate. It is
// memory-bound, ≈ 5 µs a call.
//
// Design. The TPU kernel walked ψ blocks in order with the running top-K
// resident in VMEM; Hopper runs blocks in parallel and in no order, and
// 16 φ rows are far too few to fill 132 SMs by rows. So:
//   pass 1 — one block per (ψ chunk × 16-row φ block): ψ is read from
//     device memory once per φ block, TOPK_DSLAB columns at a time, in
//     coalesced float4 loads that are in flight while the previous slab is
//     used, and staged transposed through shared memory. Each thread
//     accumulates one ψ row's dot products with the 16 φ rows in fp32 FMAs
//     on the CUDA cores (no TF32). Each score becomes one 64-bit key: the
//     order-preserving bits of −score above the global id. Then one warp
//     per φ row sorts the row's keys in registers (a bitonic network over
//     8 keys a lane, with warp shuffles) and writes the first k_pad as
//     candidates.
//   pass 2 — a tree of merge levels: a block merges TOPK_MERGE_SLOTS sorted
//     candidate lists of one φ row in shared memory (pairwise: keep the
//     smaller half as a bitonic sequence, then a bitonic merge), so 133
//     lists take two levels; the last level decodes keys into scores and
//     ids.
// Every size in the sorting networks is a power of two, so all indices
// come from shifts and masks: no integer division on the sorting path.
// The register sort holds 256 keys a row, so a chunk is at most 256 rows.
//
// Large K (k_pad > TOPK_MAX_CHUNK, up to TOPK_WIDE_KEYS / 2): a chunk then
// holds fewer rows than k_pad, so pass 1 keeps its whole sorted chunk, and
// the merge levels run in dynamic shared memory (TOPK_WIDE_KEYS keys, 128
// KB, opted into at launch) with as many lists a block as fit: two sorted
// lists of length n < k_pad merge into one of 2n (a flip and half-cleaners,
// keeping every key) until lists reach k_pad, and from there keep the
// k_pad smallest, as the small-K merge does. Fewer lists a block for longer
// lists, so a level of k_pad = 8,192 merges two.
// Because one key orders "descending score, then ascending id" exactly,
// the result does not depend on the order in which blocks finish.
// Inadmissible candidates carry the largest key, which decodes to
// (−inf, −1). A −0.0 score is stored as +0.0 so that it ties with +0.0,
// as it does in the plain version's sort.
//
// Interface: a plain C function bound with ctypes. It launches on the
// caller's stream, allocates nothing (outputs and the candidate scratch
// come from the wrapper) and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#if !defined(TOPK_ROWS) || !defined(TOPK_DSLAB) || !defined(TOPK_MAX_CHUNK) || \
    !defined(TOPK_MERGE_SLOTS) || !defined(TOPK_MERGE_THREADS) || !defined(TOPK_WIDE_KEYS)
#error "build through repro_torch/kernels/topk_score/kernel.py, which passes the tile sizes"
#endif

#if TOPK_MAX_CHUNK > 256
#error "the warp-register sort holds 256 keys per chunk row"
#endif

typedef unsigned long long key_t64;

#define KEY_NONE 0xFFFFFFFFFFFFFFFFull
#define POOL_BYTES_A (4 * TOPK_DSLAB * (TOPK_MAX_CHUNK + 1))
// key rows are padded by one key per 8 (index t + t/8): a lane then reads
// its 8 consecutive keys without piling onto the same banks
#define KEY_PITCH (TOPK_MAX_CHUNK + TOPK_MAX_CHUNK / 8)
#define POOL_BYTES_B (8 * TOPK_ROWS * KEY_PITCH)
#define POOL_BYTES (POOL_BYTES_A > POOL_BYTES_B ? POOL_BYTES_A : POOL_BYTES_B)

// Ascending order of the result = descending order of the score.
__device__ __forceinline__ uint32_t desc_bits(float s) {
    if (s == 0.0f) s = 0.0f;  // −0.0 → +0.0
    uint32_t u = __float_as_uint(s);
    u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
    return ~u;
}

__device__ __forceinline__ float desc_score(uint32_t hi) {
    uint32_t u = ~hi;
    u = (u & 0x80000000u) ? (u & 0x7FFFFFFFu) : ~u;
    return __uint_as_float(u);
}

// Sorts the 256 keys a warp holds, 8 per lane (lane l holds elements
// 8l .. 8l+7), ascending, with no shared memory and no barrier: partners
// closer than 8 are in the same lane, farther ones one shuffle away.
__device__ __forceinline__ void warp_sort256(key_t64 (&x)[8], int lane) {
#pragma unroll
    for (int lk = 1; lk <= 8; ++lk) {
#pragma unroll
        for (int lj = lk - 1; lj >= 0; --lj) {
            if (lj < 3) {
#pragma unroll
                for (int e = 0; e < 8; ++e) {
                    if ((e & (1 << lj)) == 0) {
                        const bool up = (((lane * 8 + e) >> lk) & 1) == 0;
                        key_t64& a = x[e];
                        key_t64& b = x[e + (1 << lj)];
                        const key_t64 lo = a < b ? a : b, hi = a < b ? b : a;
                        a = up ? lo : hi;
                        b = up ? hi : lo;
                    }
                }
            } else {
                const int m = 1 << (lj - 3);
                const bool keep_lo = ((lane & m) == 0) == ((((lane * 8) >> lk) & 1) == 0);
#pragma unroll
                for (int e = 0; e < 8; ++e) {
                    const key_t64 y = __shfl_xor_sync(0xffffffffu, x[e], m);
                    const key_t64 lo = x[e] < y ? x[e] : y, hi = x[e] < y ? y : x[e];
                    x[e] = keep_lo ? lo : hi;
                }
            }
        }
    }
}

// Pass 1. grid = (n_chunks, ceil(B / TOPK_ROWS)), blockDim.x = chunk = 1 << lchunk.
// VEC: D % 4 == 0 and ψ 16-byte aligned, so ψ moves as float4.
template <bool VEC>
__global__ void __launch_bounds__(TOPK_MAX_CHUNK)
topk_chunk_kernel(const float* __restrict__ phi, const float* __restrict__ psi,
                  const int* __restrict__ excl, int B, int n_rows, int D, int L,
                  int id_offset, int n_valid, int lchunk, int lk_pad,
                  key_t64* __restrict__ cand) {
    __shared__ __align__(16) float phi_s[TOPK_DSLAB][TOPK_ROWS];
    __shared__ __align__(16) unsigned char pool[POOL_BYTES];
    float* psi_s = reinterpret_cast<float*>(pool);      // [TOPK_DSLAB][chunk + 1]
    key_t64* keys = reinterpret_cast<key_t64*>(pool);   // [TOPK_ROWS][KEY_PITCH]

    constexpr int VW = VEC ? 4 : 1;                     // floats per load
    constexpr int PER_ITEM = TOPK_DSLAB / VW;           // loads per ψ row and slab
    const int chunk = 1 << lchunk;
    const int t = threadIdx.x;
    const int c = blockIdx.x;
    const int r0 = blockIdx.y * TOPK_ROWS;
    const int item0 = c << lchunk;
    const int pitch = chunk + 1;

    // the next ψ slab rides in registers while the current one is used:
    // each thread holds PER_ITEM loads (a warp covers whole 128-byte rows)
    float4 reg4[VEC ? PER_ITEM : 1];
    float reg1[VEC ? 1 : PER_ITEM];
    auto load = [&](int d0) {
#pragma unroll
        for (int j = 0; j < PER_ITEM; ++j) {
            const int i = t + (j << lchunk);
            const int g = item0 + i / PER_ITEM, d = d0 + (i % PER_ITEM) * VW;
            const bool in = g < n_rows && d < D;
            if constexpr (VEC) {
                reg4[j] = in ? __ldg(reinterpret_cast<const float4*>(psi + (size_t)g * D + d))
                             : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            } else {
                reg1[j] = in ? __ldg(psi + (size_t)g * D + d) : 0.0f;
            }
        }
    };
    // transposed store; pitch = chunk + 1 puts a warp's stores on distinct banks
    auto store = [&]() {
#pragma unroll
        for (int j = 0; j < PER_ITEM; ++j) {
            const int i = t + (j << lchunk);
            const int it = i / PER_ITEM, dd = (i % PER_ITEM) * VW;
            if constexpr (VEC) {
                psi_s[(dd + 0) * pitch + it] = reg4[j].x;
                psi_s[(dd + 1) * pitch + it] = reg4[j].y;
                psi_s[(dd + 2) * pitch + it] = reg4[j].z;
                psi_s[(dd + 3) * pitch + it] = reg4[j].w;
            } else {
                psi_s[dd * pitch + it] = reg1[j];
            }
        }
    };

    float acc[TOPK_ROWS];
#pragma unroll
    for (int r = 0; r < TOPK_ROWS; ++r) acc[r] = 0.0f;

    load(0);
    for (int d0 = 0; d0 < D; d0 += TOPK_DSLAB) {
        for (int i = t; i < TOPK_DSLAB * TOPK_ROWS; i += blockDim.x) {
            const int r = i / TOPK_DSLAB, dd = i % TOPK_DSLAB;
            const int row = r0 + r, d = d0 + dd;
            phi_s[dd][r] = (row < B && d < D) ? phi[(size_t)row * D + d] : 0.0f;
        }
        store();
        __syncthreads();
        if (d0 + TOPK_DSLAB < D) load(d0 + TOPK_DSLAB);
#pragma unroll 4
        for (int dd = 0; dd < TOPK_DSLAB; ++dd) {
            const float p = psi_s[dd * pitch + t];
            const float4* ph = reinterpret_cast<const float4*>(&phi_s[dd][0]);
#pragma unroll
            for (int r4 = 0; r4 < TOPK_ROWS / 4; ++r4) {
                const float4 f = ph[r4];
                acc[4 * r4 + 0] = fmaf(f.x, p, acc[4 * r4 + 0]);
                acc[4 * r4 + 1] = fmaf(f.y, p, acc[4 * r4 + 1]);
                acc[4 * r4 + 2] = fmaf(f.z, p, acc[4 * r4 + 2]);
                acc[4 * r4 + 3] = fmaf(f.w, p, acc[4 * r4 + 3]);
            }
        }
        __syncthreads();
    }

    // the ψ slab is dead: the pool now holds the keys
    const int local = item0 + t;
    const bool in_range = local < n_valid;
    const int gid = id_offset + local;
#pragma unroll
    for (int r = 0; r < TOPK_ROWS; ++r) {
        const int row = r0 + r;
        key_t64 key = KEY_NONE;
        if (in_range && row < B) {
            bool hit = false;
            for (int l = 0; l < L; ++l) hit |= (__ldg(&excl[(size_t)row * L + l]) == gid);
            if (!hit) key = ((key_t64)desc_bits(acc[r]) << 32) | (uint32_t)gid;
        }
        keys[r * KEY_PITCH + t + (t >> 3)] = key;
    }
    __syncthreads();

    // one warp per φ row at a time: load the row's keys (KEY_NONE past the
    // chunk), sort them in registers, write the first k_pad as candidates
    const int lane = t & 31, k_pad = 1 << lk_pad;
    for (int r = t >> 5; r < TOPK_ROWS; r += chunk >> 5) {
        const int row = r0 + r;
        if (row >= B) break;  // r is the same across the warp
        key_t64 x[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
            const int i = lane * 8 + e;
            x[e] = i < chunk ? keys[r * KEY_PITCH + i + (i >> 3)] : KEY_NONE;
        }
        warp_sort256(x, lane);
        key_t64* out = cand + ((size_t)c * B + row) * k_pad;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
            if (lane * 8 + e < k_pad) out[lane * 8 + e] = x[e];
        }
    }
}

// Pass 2, one level. grid = (ceil(n_lists / TOPK_MERGE_SLOTS), B): each block
// merges up to TOPK_MERGE_SLOTS sorted k_pad-lists of one φ row into one.
// FINAL (one block per row) decodes the merged list into scores and ids;
// otherwise the list goes to `out` for the next level.
template <bool FINAL>
__global__ void __launch_bounds__(TOPK_MERGE_THREADS)
topk_merge_kernel(const key_t64* __restrict__ in, int n_lists, int B, int lk_pad,
                  key_t64* __restrict__ out, int K, float* __restrict__ out_s,
                  int* __restrict__ out_i) {
    __shared__ key_t64 slots[TOPK_MERGE_SLOTS * TOPK_MAX_CHUNK];
    const int g = blockIdx.x, row = blockIdx.y, t = threadIdx.x;
    const int k_pad = 1 << lk_pad;

    for (int p = t; p < (TOPK_MERGE_SLOTS << lk_pad); p += blockDim.x) {
        const int c = g * TOPK_MERGE_SLOTS + (p >> lk_pad), s = p & (k_pad - 1);
        slots[p] = c < n_lists ? in[((size_t)c * B + row) * k_pad + s] : KEY_NONE;
    }
    __syncthreads();
    for (int lw = 0; (1 << lw) < TOPK_MERGE_SLOTS; ++lw) {
        const int w = 1 << lw;
        const int pairs = TOPK_MERGE_SLOTS >> (lw + 1);
        // the k_pad smallest of two sorted lists, as a bitonic sequence
        for (int p = t; p < (pairs << lk_pad); p += blockDim.x) {
            const int pr = p >> lk_pad, i = p & (k_pad - 1);
            key_t64* a = slots + ((2 * w * pr) << lk_pad);
            const key_t64 x = a[i], y = a[(w << lk_pad) + k_pad - 1 - i];
            a[i] = x < y ? x : y;
        }
        __syncthreads();
        for (int lj = lk_pad - 1; lj >= 0; --lj) {
            for (int p = t; p < (pairs << (lk_pad - 1)); p += blockDim.x) {
                const int pr = p >> (lk_pad - 1), q = p & ((k_pad >> 1) - 1);
                key_t64* a = slots + ((2 * w * pr) << lk_pad);
                const int i = ((q >> lj) << (lj + 1)) | (q & ((1 << lj) - 1));
                const key_t64 x = a[i], y = a[i + (1 << lj)];
                if (x > y) { a[i] = y; a[i + (1 << lj)] = x; }
            }
            __syncthreads();
        }
    }

    if (FINAL) {
        for (int s = t; s < K; s += blockDim.x) {
            const key_t64 key = slots[s];
            float score = -INFINITY;
            int id = -1;
            if (key != KEY_NONE) {
                score = desc_score((uint32_t)(key >> 32));
                id = isinf(score) && score < 0.0f ? -1 : (int)(uint32_t)key;
            }
            out_s[(size_t)row * K + s] = score;
            out_i[(size_t)row * K + s] = id;
        }
    } else {
        for (int s = t; s < k_pad; s += blockDim.x)
            out[((size_t)g * B + row) * k_pad + s] = slots[s];
    }
}

// Large-K merge level. grid = (ceil(n_lists / G), B), G = 1 << lg lists of
// lin = 1 << llin keys a block in dynamic shared memory. Lists shorter than
// k_pad merge pairwise into sorted lists of twice the length; lists of k_pad
// keep their k_pad smallest. The block's result (length min(G·lin, k_pad))
// goes to `out` as (groups, B, lout) lists, or, FINAL, is decoded into the
// K slots (past the merged length: −inf, −1).
template <bool FINAL>
__global__ void __launch_bounds__(TOPK_MERGE_THREADS)
topk_merge_wide_kernel(const key_t64* __restrict__ in, int n_lists, int B, int lg,
                       int llin, int lk_pad, key_t64* __restrict__ out, int K,
                       float* __restrict__ out_s, int* __restrict__ out_i) {
    extern __shared__ key_t64 wide[];
    const int g = blockIdx.x, row = blockIdx.y, t = threadIdx.x;
    const int lin = 1 << llin, k_pad = 1 << lk_pad;
    for (int p = t; p < (1 << (lg + llin)); p += blockDim.x) {
        const int c = (g << lg) + (p >> llin), s = p & (lin - 1);
        wide[p] = c < n_lists ? in[((size_t)c * B + row) * lin + s] : KEY_NONE;
    }
    __syncthreads();
    int llen = llin;  // log2 of the length of each list at this level
    for (int lw = 0; lw < lg; ++lw) {
        const int lspan = llin + lw;          // slots a list occupies
        const int pairs = 1 << (lg - lw - 1);
        const int len = 1 << llen;
        if (llen < lk_pad) {
            // keep every key: flip-compare A[i] with B[len-1-i], then sort
            // both bitonic halves; the merged list is [base, base + 2·len)
            for (int p = t; p < (pairs << llen); p += blockDim.x) {
                key_t64* a = wide + ((size_t)(p >> llen) << (lspan + 1));
                const int i = p & (len - 1), j = 2 * len - 1 - i;
                const key_t64 x = a[i], y = a[j];
                if (x > y) { a[i] = y; a[j] = x; }
            }
            __syncthreads();
            for (int lj = llen - 1; lj >= 0; --lj) {
                for (int p = t; p < (pairs << llen); p += blockDim.x) {
                    key_t64* a = wide + ((size_t)(p >> llen) << (lspan + 1));
                    const int q = p & (len - 1);
                    const int h = q >> (llen - 1);  // which half
                    const int qq = q & ((len >> 1) - 1);
                    key_t64* b = a + (h << llen);
                    const int i = ((qq >> lj) << (lj + 1)) | (qq & ((1 << lj) - 1));
                    const key_t64 x = b[i], y = b[i + (1 << lj)];
                    if (x > y) { b[i] = y; b[i + (1 << lj)] = x; }
                }
                __syncthreads();
            }
            ++llen;
        } else {
            // keep the k_pad smallest of A and B (B at base + span)
            for (int p = t; p < (pairs << lk_pad); p += blockDim.x) {
                key_t64* a = wide + ((size_t)(p >> lk_pad) << (lspan + 1));
                const int i = p & (k_pad - 1);
                const key_t64 x = a[i], y = a[(1 << lspan) + k_pad - 1 - i];
                a[i] = x < y ? x : y;
            }
            __syncthreads();
            for (int lj = lk_pad - 1; lj >= 0; --lj) {
                for (int p = t; p < (pairs << (lk_pad - 1)); p += blockDim.x) {
                    key_t64* a = wide + ((size_t)(p >> (lk_pad - 1)) << (lspan + 1));
                    const int q = p & ((k_pad >> 1) - 1);
                    const int i = ((q >> lj) << (lj + 1)) | (q & ((1 << lj) - 1));
                    const key_t64 x = a[i], y = a[i + (1 << lj)];
                    if (x > y) { a[i] = y; a[i + (1 << lj)] = x; }
                }
                __syncthreads();
            }
        }
    }
    const int len = 1 << llen;
    if (FINAL) {
        for (int s = t; s < K; s += blockDim.x) {
            const key_t64 key = s < len ? wide[s] : KEY_NONE;
            float score = -INFINITY;
            int id = -1;
            if (key != KEY_NONE) {
                score = desc_score((uint32_t)(key >> 32));
                id = isinf(score) && score < 0.0f ? -1 : (int)(uint32_t)key;
            }
            out_s[(size_t)row * K + s] = score;
            out_i[(size_t)row * K + s] = id;
        }
    } else {
        for (int s = t; s < len; s += blockDim.x)
            out[((size_t)g * B + row) * len + s] = wide[s];
    }
}

static int log2_exact(int x) {
    if (x <= 0 || (x & (x - 1)) != 0) return -1;
    int l = 0;
    while ((1 << l) < x) ++l;
    return l;
}

// cand holds (n_chunks, B, k_pad) keys and cand2 (ceil(n_chunks / SLOTS), B,
// k_pad); merge levels ping-pong between them until one list per row is left.
extern "C" int topk_score_f32(const float* phi, const float* psi, const int* excl,
                              int B, int n_rows, int D, int L, int id_offset,
                              int n_valid, int K, int k_pad, int chunk,
                              key_t64* cand, key_t64* cand2, float* out_s,
                              int* out_i, void* stream) {
    const int lk_pad = log2_exact(k_pad), lchunk = log2_exact(chunk);
    if (B < 1 || B > 65535 || n_rows < 0 || D < 1 || L < 0 || K < 1 || K > k_pad ||
        lk_pad < 0 || lchunk < 5 || chunk < k_pad || chunk > TOPK_MAX_CHUNK ||
        n_valid < 0 || n_valid > n_rows)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSuccess;
    cudaStream_t st = (cudaStream_t)stream;
    const int n_chunks = (n_rows + chunk - 1) / chunk;
    if (n_chunks > 0) {
        dim3 grid(n_chunks, (B + TOPK_ROWS - 1) / TOPK_ROWS);
        const bool vec = D % 4 == 0 && ((uintptr_t)psi & 15) == 0;
        if (vec)
            topk_chunk_kernel<true><<<grid, chunk, 0, st>>>(
                phi, psi, excl, B, n_rows, D, L, id_offset, n_valid, lchunk, lk_pad, cand);
        else
            topk_chunk_kernel<false><<<grid, chunk, 0, st>>>(
                phi, psi, excl, B, n_rows, D, L, id_offset, n_valid, lchunk, lk_pad, cand);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    const key_t64* src = cand;
    key_t64* bufs[2] = {cand2, cand};
    int n = n_chunks, level = 0;
    while (n > TOPK_MERGE_SLOTS) {
        const int groups = (n + TOPK_MERGE_SLOTS - 1) / TOPK_MERGE_SLOTS;
        key_t64* dst = bufs[level++ & 1];
        topk_merge_kernel<false><<<dim3(groups, B), TOPK_MERGE_THREADS, 0, st>>>(
            src, n, B, lk_pad, dst, K, out_s, out_i);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        src = dst;
        n = groups;
    }
    topk_merge_kernel<true><<<dim3(1, B), TOPK_MERGE_THREADS, 0, st>>>(
        src, n, B, lk_pad, nullptr, K, out_s, out_i);
    return (int)cudaGetLastError();
}

// Large K: chunk < k_pad ≤ TOPK_WIDE_KEYS / 2. cand and cand2 each hold
// `scratch` keys a φ row: pass 1 writes (n_chunks, B, chunk) whole sorted
// chunks, and each merge level (groups, B, lout) lists, at most half the
// keys it reads, since lout ≤ k_pad ≤ TOPK_WIDE_KEYS / 2.
extern "C" int topk_score_wide_f32(const float* phi, const float* psi, const int* excl,
                                   int B, int n_rows, int D, int L, int id_offset,
                                   int n_valid, int K, int k_pad, int chunk, long long scratch,
                                   key_t64* cand, key_t64* cand2, float* out_s, int* out_i,
                                   void* stream) {
    const int lk_pad = log2_exact(k_pad), lchunk = log2_exact(chunk);
    if (B < 1 || B > 65535 || n_rows < 0 || D < 1 || L < 0 || K < 1 || K > k_pad ||
        lk_pad < 0 || lchunk < 5 || chunk >= k_pad || chunk > TOPK_MAX_CHUNK ||
        2 * k_pad > TOPK_WIDE_KEYS || n_valid < 0 || n_valid > n_rows)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSuccess;
    cudaStream_t st = (cudaStream_t)stream;
    const int n_chunks = (n_rows + chunk - 1) / chunk;
    if ((long long)n_chunks * chunk > scratch) return (int)cudaErrorInvalidValue;
    if (n_chunks > 0) {
        dim3 grid(n_chunks, (B + TOPK_ROWS - 1) / TOPK_ROWS);
        const bool vec = D % 4 == 0 && ((uintptr_t)psi & 15) == 0;
        if (vec)
            topk_chunk_kernel<true><<<grid, chunk, 0, st>>>(
                phi, psi, excl, B, n_rows, D, L, id_offset, n_valid, lchunk, lchunk, cand);
        else
            topk_chunk_kernel<false><<<grid, chunk, 0, st>>>(
                phi, psi, excl, B, n_rows, D, L, id_offset, n_valid, lchunk, lchunk, cand);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    const size_t smem = sizeof(key_t64) * TOPK_WIDE_KEYS;
    err = cudaFuncSetAttribute(topk_merge_wide_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(topk_merge_wide_kernel<true>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const key_t64* src = cand;
    key_t64* bufs[2] = {cand2, cand};
    int n = n_chunks, llin = lchunk, level = 0;
    for (;;) {
        const int lg = log2_exact(TOPK_WIDE_KEYS) - llin;  // lists a block holds
        if (n <= (1 << lg)) break;
        const int groups = (n + (1 << lg) - 1) >> lg;
        const int llout = llin + lg < lk_pad ? llin + lg : lk_pad;
        if ((long long)groups << llout > scratch) return (int)cudaErrorInvalidValue;
        key_t64* dst = bufs[level++ & 1];
        topk_merge_wide_kernel<false><<<dim3(groups, B), TOPK_MERGE_THREADS,
                                        sizeof(key_t64) << (lg + llin), st>>>(
            src, n, B, lg, llin, lk_pad, dst, K, out_s, out_i);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        src = dst;
        n = groups;
        llin = llout;
    }
    int lg = 0;
    while ((1 << lg) < n) ++lg;
    topk_merge_wide_kernel<true><<<dim3(1, B), TOPK_MERGE_THREADS,
                                   sizeof(key_t64) << (lg + llin), st>>>(
        src, n, B, lg, llin, lk_pad, nullptr, K, out_s, out_i);
    return (int)cudaGetLastError();
}

extern "C" const char* topk_score_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
