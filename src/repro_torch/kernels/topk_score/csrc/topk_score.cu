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
// Two launch forms compute the exact top-K. For k_pad ≤ TOPK_MAX_CHUNK the
// wrapper launches the one-launch form (topk_fused_kernel, below the merge
// kernels); the chain described here (pass 1, then merge levels in further
// launches) is the form it replaced, kept for comparison, and serves every
// larger K and, with its plan kernel, the IVF form.
//
// Design of the chain. The TPU kernel walked ψ blocks in order with the
// running top-K resident in VMEM; Hopper runs blocks in parallel and in no
// order, and 16 φ rows are far too few to fill 132 SMs by rows. So:
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
// Large K (k_pad > TOPK_MAX_CHUNK): a chunk then holds fewer rows than
// k_pad, so pass 1 keeps its whole sorted chunk, and the merge levels run in
// device memory, any K: lists merge in pairs, a thread takes one key and
// places it at its index in its own list plus its rank in the partner list
// (a binary search, lower bound from the left list and upper bound from the
// right, so equal keys keep their order), keeping the first k_pad.
// Because one key orders "descending score, then ascending id" exactly,
// the result does not depend on the order in which blocks finish.
// Inadmissible candidates carry the largest key, which decodes to
// (−inf, −1). A −0.0 score is stored as +0.0 so that it ties with +0.0,
// as it does in the plain version's sort. A NaN score keeps a key below
// KEY_NONE and decodes back to NaN with its id, so a NaN table shows as NaN
// scores, never as empty slots.
//
// The IVF form (the reference's serving tier launches the TPU kernel once
// per probed cluster block and merges the blocks by global id): one chain
// a shard and query. The plan kernel builds, on the device, the list of
// (cluster, chunk) pairs of the clusters that any φ row probed; pass 1 runs
// over that list (the blocks past its live length exit at once), scoring
// only each cluster's valid rows, and a (φ row, row) pair is admissible only
// if the row probed the cluster; each key carries the row's GLOBAL id
// (ids_global), so the merge levels, sized on the host for an upper bound
// of the list and reading its live length, order ties as the reference's
// merge does. Within a cluster's block positions ascend with global id, so
// this top-K over the union equals the reference's per-block top-K and
// merge.
//
// ψ storage (the TPU kernel's quantized forms, dequantized per tile in
// VMEM): fp32, bf16, or int8 with an optional per-row fp32 scale. Only the
// loads change: a thread loads the stored elements (16 bytes a load where
// the rows allow it), converts each to fp32, multiplies it by its row's
// scale, and stores fp32 into the transposed slab; the products stay fp32
// FMAs. Exclusion comes as −1-padded global-id lists or as a dense (B,
// n_rows) byte mask with its own row stride (a column slice of a wider
// mask is read in place).
//
// Interface: one plain C function bound with ctypes. It launches on the
// caller's stream, allocates nothing (outputs and the candidate scratch
// come from the wrapper) and returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#if !defined(TOPK_ROWS) || !defined(TOPK_DSLAB) || !defined(TOPK_MAX_CHUNK) || \
    !defined(TOPK_MERGE_SLOTS) || !defined(TOPK_MERGE_THREADS) ||                \
    !defined(TOPK_FUSED_THREADS) || !defined(TOPK_FUSED_MIN_BLOCKS) ||           \
    !defined(TOPK_FUSED_CLUSTER) || !defined(TOPK_FUSED_EXCL_STAGE)
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

// Slot value of a merged key: (score, id), or (−inf, −1) for an empty slot
// or an admissible −inf score (indistinguishable from an excluded one).
__device__ __forceinline__ void decode_key(key_t64 key, float& score, int& id) {
    score = -INFINITY;
    id = -1;
    if (key != KEY_NONE) {
        score = desc_score((uint32_t)(key >> 32));
        id = isinf(score) && score < 0.0f ? -1 : (int)(uint32_t)key;
    }
}

// ψ storage types: float, uint16_t (bf16 bits) and int8_t. word_elem reads
// element e of a 32-bit word of stored elements (little-endian), load_elem
// one stored element, both as fp32 (bf16 → fp32 is exact: the high half).
template <typename T> __device__ __forceinline__ float word_elem(uint32_t w, int e);
template <> __device__ __forceinline__ float word_elem<float>(uint32_t w, int) {
    return __uint_as_float(w);
}
template <> __device__ __forceinline__ float word_elem<uint16_t>(uint32_t w, int e) {
    return __uint_as_float(e ? (w & 0xFFFF0000u) : (w << 16));
}
template <> __device__ __forceinline__ float word_elem<int8_t>(uint32_t w, int e) {
    return (float)((int)(w << (24 - 8 * e)) >> 24);
}
__device__ __forceinline__ float load_elem(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_elem(const uint16_t* p) {
    return __uint_as_float((uint32_t)*p << 16);
}
__device__ __forceinline__ float load_elem(const int8_t* p) { return (float)*p; }

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

// The IVF form's block list (see topk_ivf_plan_kernel): entry e of `list`
// is cluster e / chunks_per_block, chunk e % chunks_per_block of its block;
// the first *n_active entries are live. A cluster's block starts at row
// cluster · block_rows and holds counts[cluster] valid rows; ids_global maps
// a row to its global id and probe (B, n_clusters) says which φ rows probed
// which cluster.
struct IvfArgs {
    const int* ids_global;
    const int* counts;
    const int* list;
    const int* n_active;
    const unsigned char* probe;
    int n_clusters, block_rows, chunks_per_block;
};

// Pass 1. grid = (n_chunks, ceil(B / TOPK_ROWS)), blockDim.x = chunk = 1 << lchunk.
// T is the ψ storage type; VEC: D·sizeof(T) % 16 == 0 and ψ 16-byte aligned,
// so ψ moves in 16-byte loads. scale (n_rows,) multiplies each row after the
// conversion to fp32 (nullptr: none). mask (B rows of mask_stride bytes,
// nullptr: none) and excl (B × L global ids) exclude candidates. Each chunk
// writes its best 1 << lk_keep keys. IVF: blockIdx.x walks the block list
// instead of the table's chunks; a pair is admissible only if its φ row
// probed the cluster and the row is below the cluster's count.
template <typename T, bool VEC, bool IVF>
__global__ void __launch_bounds__(TOPK_MAX_CHUNK)
topk_chunk_kernel(const float* __restrict__ phi, const T* __restrict__ psi,
                  const float* __restrict__ scale, const int* __restrict__ excl, int L,
                  const unsigned char* __restrict__ mask, long long mask_stride,
                  int B, int n_rows, int D, int id_offset, int n_valid, int lchunk,
                  int lk_pad, key_t64* __restrict__ cand, IvfArgs ivf) {
    __shared__ __align__(16) float phi_s[TOPK_DSLAB][TOPK_ROWS];
    __shared__ __align__(16) unsigned char pool[POOL_BYTES];
    float* psi_s = reinterpret_cast<float*>(pool);      // [TOPK_DSLAB][chunk + 1]
    key_t64* keys = reinterpret_cast<key_t64*>(pool);   // [TOPK_ROWS][KEY_PITCH]

    constexpr int EPW = 4 / (int)sizeof(T);             // stored elements a 32-bit word
    constexpr int VW = VEC ? 4 * EPW : 1;               // elements a load
    constexpr int PER_ITEM = TOPK_DSLAB / VW;           // loads per ψ row and slab
    const int chunk = 1 << lchunk;
    const int t = threadIdx.x;
    const int c = blockIdx.x;
    const int r0 = blockIdx.y * TOPK_ROWS;
    const int pitch = chunk + 1;
    // rows this block scores: [item0, row_end), admissible below valid_end
    int item0 = c << lchunk, row_end = n_rows, valid_end = n_valid, cl = 0;
    if constexpr (IVF) {
        // list entry c is (cluster, chunk of its block); past the live
        // entries, nothing to score (the merges read live lists only)
        if (c >= __ldg(ivf.n_active)) return;
        const int entry = __ldg(ivf.list + c);
        cl = entry / ivf.chunks_per_block;
        const int base = cl * ivf.block_rows;
        item0 = base + ((entry - cl * ivf.chunks_per_block) << lchunk);
        row_end = valid_end = base + __ldg(ivf.counts + cl);
    }

    // the next ψ slab rides in registers while the current one is used:
    // each thread holds PER_ITEM loads (a warp covers whole 128-byte rows
    // of fp32, or several rows' 32-byte slab segments of bf16 and int8)
    uint4 reg4[VEC ? PER_ITEM : 1];
    float sc4[VEC ? PER_ITEM : 1];
    float reg1[VEC ? 1 : PER_ITEM];
    auto load = [&](int d0) {
#pragma unroll
        for (int j = 0; j < PER_ITEM; ++j) {
            const int i = t + (j << lchunk);
            const int g = item0 + i / PER_ITEM, d = d0 + (i % PER_ITEM) * VW;
            const bool in = g < row_end && d < D;
            if constexpr (VEC) {
                reg4[j] = in ? __ldg(reinterpret_cast<const uint4*>(psi + (size_t)g * D + d))
                             : make_uint4(0u, 0u, 0u, 0u);
                if (scale != nullptr) sc4[j] = in ? __ldg(scale + g) : 0.0f;
            } else {
                float v = in ? load_elem(psi + (size_t)g * D + d) : 0.0f;
                if (scale != nullptr && in) v *= __ldg(scale + g);
                reg1[j] = v;
            }
        }
    };
    // transposed fp32 store (dequantized: q·scale, element by element);
    // pitch = chunk + 1 puts a warp's stores on distinct banks
    auto store = [&]() {
#pragma unroll
        for (int j = 0; j < PER_ITEM; ++j) {
            const int i = t + (j << lchunk);
            const int it = i / PER_ITEM, dd = (i % PER_ITEM) * VW;
            if constexpr (VEC) {
                const uint32_t w[4] = {reg4[j].x, reg4[j].y, reg4[j].z, reg4[j].w};
#pragma unroll
                for (int e = 0; e < VW; ++e) {
                    float v = word_elem<T>(w[e / EPW], e % EPW);
                    if (scale != nullptr) v *= sc4[j];
                    psi_s[(dd + e) * pitch + it] = v;
                }
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
    const bool in_range = local < valid_end;
    // the key carries the GLOBAL id, so ties order as the reference's
    // final merge by global id orders them
    const int gid = IVF ? (in_range ? __ldg(ivf.ids_global + local) : -1) : id_offset + local;
#pragma unroll
    for (int r = 0; r < TOPK_ROWS; ++r) {
        const int row = r0 + r;
        key_t64 key = KEY_NONE;
        if (in_range && row < B && (!IVF || ivf.probe[(size_t)row * ivf.n_clusters + cl] != 0)) {
            bool hit = mask != nullptr && mask[(size_t)row * mask_stride + local] != 0;
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

// Lists a merge level reads: n_lists, or, in the IVF form (dev_n set),
// the live lists of pass 1 (*dev_n) divided `level` times by `fan` with
// rounding up, as the host sized the levels from an upper bound.
__device__ __forceinline__ int level_lists(int n_lists, const int* dev_n, int level, int fan) {
    if (dev_n == nullptr) return n_lists;
    int n = __ldg(dev_n);
    for (int l = 0; l < level; ++l) n = (n + fan - 1) / fan;
    return n;
}

// Pass 2, one level. grid = (ceil(n_lists / TOPK_MERGE_SLOTS), B): each block
// merges up to TOPK_MERGE_SLOTS sorted k_pad-lists of one φ row into one.
// FINAL (one block per row) decodes the merged list into scores and ids;
// otherwise the list goes to `out` for the next level.
template <bool FINAL>
__global__ void __launch_bounds__(TOPK_MERGE_THREADS)
topk_merge_kernel(const key_t64* __restrict__ in, int n_lists, const int* dev_n, int level,
                  int B, int lk_pad, key_t64* __restrict__ out, int K,
                  float* __restrict__ out_s, int* __restrict__ out_i) {
    __shared__ key_t64 slots[TOPK_MERGE_SLOTS * TOPK_MAX_CHUNK];
    const int g = blockIdx.x, row = blockIdx.y, t = threadIdx.x;
    const int k_pad = 1 << lk_pad;
    n_lists = level_lists(n_lists, dev_n, level, TOPK_MERGE_SLOTS);
    if (!FINAL && g * TOPK_MERGE_SLOTS >= n_lists) return;  // no list of this group

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
        for (int s = t; s < K; s += blockDim.x)
            decode_key(slots[s], out_s[(size_t)row * K + s], out_i[(size_t)row * K + s]);
    } else {
        for (int s = t; s < k_pad; s += blockDim.x)
            out[((size_t)g * B + row) * k_pad + s] = slots[s];
    }
}

// Device-memory merge level (k_pad > chunk). grid = (ceil(pairs ·
// 2·lin / 256), B): lists (n_lists, B, lin) merge in pairs into (pairs, B,
// lout) lists, lout = min(2·lin, k_pad); the odd last list's partner is
// empty (all KEY_NONE). A thread places one key at its index in its own list
// plus its rank in the partner: keys below it from the right list, keys not
// above it from the left, so equal keys (KEY_NONE) keep left before right
// and every output slot is written exactly once.
__global__ void __launch_bounds__(256)
topk_merge_global_kernel(const key_t64* __restrict__ in, int n_lists, const int* dev_n,
                         int level, int B, int llin, int llout, key_t64* __restrict__ out) {
    const int row = blockIdx.y;
    n_lists = level_lists(n_lists, dev_n, level, 2);
    const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const int pairs = (n_lists + 1) >> 1;
    if (p >= ((long long)pairs << (llin + 1))) return;
    const int lin = 1 << llin;
    const int pair = (int)(p >> (llin + 1));
    const int side = (int)(p >> llin) & 1;  // 0: the left list, 1: the right
    const int i = (int)(p & (lin - 1));
    const int own = 2 * pair + side, other = 2 * pair + 1 - side;
    const key_t64 x = own < n_lists ? in[((size_t)own * B + row) * lin + i] : KEY_NONE;
    const key_t64* o = other < n_lists ? in + ((size_t)other * B + row) * lin : nullptr;
    int lo = 0, hi = lin;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        const key_t64 y = o != nullptr ? o[mid] : KEY_NONE;
        if (side == 0 ? y < x : y <= x) lo = mid + 1; else hi = mid;
    }
    const int pos = i + lo;
    if (pos < (1 << llout)) out[(((size_t)pair * B + row) << llout) + pos] = x;
}

// The device-memory merge's last step: the first K keys of the one list
// (B, 1 << llen) a row, decoded (nullptr, or no live list in the IVF form:
// every slot empty).
__global__ void __launch_bounds__(256)
topk_decode_kernel(const key_t64* __restrict__ in, const int* dev_n, int B, int llen, int K,
                   float* __restrict__ out_s, int* __restrict__ out_i) {
    const int row = blockIdx.y, s = blockIdx.x * blockDim.x + threadIdx.x;
    if (s >= K) return;
    if (dev_n != nullptr && __ldg(dev_n) == 0) in = nullptr;
    const key_t64 key = in != nullptr && s < (1 << llen) ? in[((size_t)row << llen) + s]
                                                          : KEY_NONE;
    decode_key(key, out_s[(size_t)row * K + s], out_i[(size_t)row * K + s]);
}

// ---------------------------------------------------------------------------
// The exact form in one launch (k_pad ≤ TOPK_MAX_CHUNK): pass 1, a running
// list a φ row and block, and the merges, fused. grid = (n_blocks, ⌈B /
// TOPK_ROWS⌉) in clusters of TOPK_FUSED_CLUSTER blocks along x.
//   * Pass 1: block b walks chunks b, b + n_blocks, … of TOPK_MAX_CHUNK ψ
//     rows; TF_HALVES threads share a ψ row, each scoring TF_ROWS_T of the
//     TOPK_ROWS φ rows with the same fmaf chain over d as topk_chunk_kernel,
//     so every key has its bits. The next slab of ψ and of φ rides in
//     registers while the current one is used. The exclusion ids of the
//     block's φ rows are staged in shared memory once (up to
//     TOPK_FUSED_EXCL_STAGE a row; longer lists are read where they lie).
//   * A bound a row and cluster: after the cluster's first chunks are
//     scored, each block sorts its 32 lane minima of a row (a lane's
//     smallest of its 8 keys; one key a lane, 15 shuffle stages) and
//     publishes them in shared memory. After one cluster barrier each
//     block reads the cluster's counts of real minima, finds the least m
//     with Σ_b min(real_b, m) ≥ k_pad, and takes T = the largest of the
//     blocks' min(m, real_b)-th smallest minima. At least k_pad keys of the
//     cluster are ≤ T, so no key above T can be in the result, and a block
//     keeps only its keys ≤ T (on random scores at k_pad 128, about one in
//     eight) instead of sorting all 256 a row.
//   * The running list: one warp a φ row keeps the row's best 32·KPL keys
//     in shared memory, KPL = 4 (128 keys) for k_pad ≤ 128, else 8. A
//     chunk's keys that pass the bound (and, on a later chunk, lie below
//     the list's k_pad-th) are compacted and sorted in the smallest network
//     that holds them (32 keys one a lane, 64 two, 128 four, else
//     warp_sort256); the first chunk's become the list, a later chunk's
//     are merged in (min against the reversed list, then one bitonic merge
//     level); a chunk with none is skipped after one ballot.
//   * Cluster merge: after a cluster barrier, block q of the cluster merges
//     rows q·TF_RPB … of the cluster's TOPK_FUSED_CLUSTER lists, read from
//     the other blocks' shared memory, TF_WPR warps a row, then a tree over
//     the warps' lists. One cluster: that list is the result.
//   * Completion: otherwise each cluster writes its rows' first k_pad keys
//     to cand, fences, and one thread counts the cluster in counters[y];
//     the cluster that counts last merges the n_clusters lists of each row
//     the same way from device memory, decodes them and resets the counter
//     for the next call. The counter is the only atomic; the wrapper owns
//     one array of counters a device and stream.
// Every merge keeps the smallest keys of a union, and one key orders
// "descending score, then ascending id" totally, so the result is the
// chain's (topk_score_run) bit for bit whatever the order blocks finish in.
// ---------------------------------------------------------------------------
namespace cg = cooperative_groups;

#define TF_WARPS (TOPK_FUSED_THREADS / 32)
#define TF_HALVES (TOPK_FUSED_THREADS / TOPK_MAX_CHUNK)  // threads a ψ row
#define TF_ROWS_T (TOPK_ROWS / TF_HALVES)                // φ rows a thread scores
#define TF_RPB (TOPK_ROWS / TOPK_FUSED_CLUSTER)          // rows a block merges
#define TF_WPR (TF_WARPS / TF_RPB)                       // warps a merged row
#define TF_PHI_PT (TOPK_DSLAB * TOPK_ROWS / TOPK_FUSED_THREADS)
static_assert(TOPK_MAX_CHUNK == 256, "a chunk row's keys are one warp's 256");
static_assert(TOPK_FUSED_THREADS % TOPK_MAX_CHUNK == 0 && TF_ROWS_T % 4 == 0,
              "threads share ψ rows evenly, four φ rows at a time");
static_assert(TOPK_ROWS % TOPK_FUSED_CLUSTER == 0 && TF_WARPS % TF_RPB == 0 &&
                  (TF_WPR & (TF_WPR - 1)) == 0,
              "a cluster's blocks share the rows, a power of two of warps a row");
static_assert(TF_PHI_PT >= 1 && TF_PHI_PT * TOPK_FUSED_THREADS == TOPK_DSLAB * TOPK_ROWS,
              "the φ slab is whole values a thread");

// Shared memory of a fused block whose lists hold 32·KPL keys (KPL keys a
// lane): the lists, one pool (the transposed ψ slab, then the chunk's keys,
// then the merges' partial lists), the φ slab and a flag; the staged
// exclusion ids follow.
__host__ __device__ constexpr int tf_max(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int tf_lists_bytes(int kpl) { return 8 * TOPK_ROWS * 32 * kpl; }
__host__ __device__ constexpr int tf_pool_bytes(int kpl) {
    return tf_max(tf_max(4 * TOPK_DSLAB * (TOPK_MAX_CHUNK + 1), 8 * TOPK_ROWS * KEY_PITCH),
                  8 * TF_RPB * TF_WPR * 32 * kpl);
}
constexpr int TF_PHI_BYTES = 4 * TOPK_DSLAB * TOPK_ROWS;
// a flag, the bound T of each row, the sorted lane minima of each row and
// their count of real keys
constexpr int TF_MISC_BYTES = 16 + 8 * TOPK_ROWS + 8 * TOPK_ROWS * 32 + 4 * TOPK_ROWS;
__host__ __device__ constexpr int tf_fixed_bytes(int kpl) {
    return tf_lists_bytes(kpl) + tf_pool_bytes(kpl) + TF_PHI_BYTES + TF_MISC_BYTES;
}

// Sorts 32·KPL keys, lane l holding keys KPL·l … KPL·l + KPL − 1, ascending
// (the network of warp_sort256, which is KPL = 8, for KPL = 1 and 4).
template <int KPL>
__device__ __forceinline__ void warp_sort_kpl(key_t64 (&x)[KPL], int lane) {
    constexpr int LK = KPL == 8 ? 3 : KPL == 4 ? 2 : KPL == 2 ? 1 : 0;  // log2(KPL)
#pragma unroll
    for (int lk = 1; lk <= LK + 5; ++lk) {
#pragma unroll
        for (int lj = lk - 1; lj >= 0; --lj) {
            if (lj < LK) {
#pragma unroll
                for (int e = 0; e < KPL; ++e) {
                    if ((e & (1 << lj)) == 0) {
                        const bool up = (((lane * KPL + e) >> lk) & 1) == 0;
                        const key_t64 a = x[e], b = x[e + (1 << lj)];
                        const key_t64 lo = a < b ? a : b, hi = a < b ? b : a;
                        x[e] = up ? lo : hi;
                        x[e + (1 << lj)] = up ? hi : lo;
                    }
                }
            } else {
                const int m = 1 << (lj - LK);
                const bool keep_lo = ((lane & m) == 0) == ((((lane * KPL) >> lk) & 1) == 0);
#pragma unroll
                for (int e = 0; e < KPL; ++e) {
                    const key_t64 y = __shfl_xor_sync(0xffffffffu, x[e], m);
                    x[e] = keep_lo ? (x[e] < y ? x[e] : y) : (x[e] < y ? y : x[e]);
                }
            }
        }
    }
}

// A sorted list held SRC keys a lane, as KPL keys a lane (the first 32·KPL
// of it; KEY_NONE past its end).
template <int KPL, int SRC>
__device__ __forceinline__ void relayout(key_t64 (&out)[KPL], const key_t64 (&x)[SRC],
                                         int lane) {
#pragma unroll
    for (int e = 0; e < KPL; ++e) {
        const int i = lane * KPL + e;  // the index lane·KPL + e, at lane i / SRC, i % SRC
        key_t64 v = KEY_NONE;
#pragma unroll
        for (int h = 0; h < SRC; ++h) {
            const key_t64 y = __shfl_sync(0xffffffffu, x[h], (i / SRC) & 31);
            if (i % SRC == h && i < 32 * SRC) v = y;
        }
        out[e] = v;
    }
}

// Sorts a bitonic sequence of 32·KPL keys, lane l holding keys KPL·l …
// KPL·l + KPL − 1, ascending: the last level of a bitonic sort
// (warp_sort256's at KPL = 8).
template <int KPL>
__device__ __forceinline__ void warp_merge_bitonic(key_t64 (&x)[KPL], int lane) {
    constexpr int LK = KPL == 8 ? 3 : KPL == 4 ? 2 : KPL == 2 ? 1 : 0;  // log2(KPL)
#pragma unroll
    for (int lj = LK + 4; lj >= LK; --lj) {
        const int m = 1 << (lj - LK);
        const bool keep_lo = (lane & m) == 0;
#pragma unroll
        for (int e = 0; e < KPL; ++e) {
            const key_t64 y = __shfl_xor_sync(0xffffffffu, x[e], m);
            x[e] = keep_lo ? (x[e] < y ? x[e] : y) : (x[e] < y ? y : x[e]);
        }
    }
#pragma unroll
    for (int lj = LK - 1; lj >= 0; --lj) {
#pragma unroll
        for (int e = 0; e < KPL; ++e) {
            if ((e & (1 << lj)) == 0) {
                const key_t64 a = x[e], b = x[e + (1 << lj)];
                x[e] = a < b ? a : b;
                x[e + (1 << lj)] = a < b ? b : a;
            }
        }
    }
}

// y ← the 32·KPL smallest keys of y ∪ x, both sorted ascending: the minimum
// of y[i] and x[32·KPL − 1 − i] (lane 31 − l, element KPL − 1 − e) is bitonic.
template <int KPL>
__device__ __forceinline__ void warp_merge_into(key_t64 (&y)[KPL], const key_t64 (&x)[KPL],
                                                int lane) {
#pragma unroll
    for (int e = 0; e < KPL; ++e) {
        const key_t64 xr = __shfl_xor_sync(0xffffffffu, x[KPL - 1 - e], 31);
        y[e] = y[e] < xr ? y[e] : xr;
    }
    warp_merge_bitonic<KPL>(y, lane);
}

// A list of 32·KPL keys, lane l holding keys KPL·l … (shared memory of this
// block or, through the cluster, of another).
template <int KPL>
__device__ __forceinline__ void load_list(key_t64 (&x)[KPL], const key_t64* p, int lane) {
    const ulonglong2* q = reinterpret_cast<const ulonglong2*>(p + KPL * lane);
#pragma unroll
    for (int h = 0; h < KPL / 2; ++h) {
        const ulonglong2 v = q[h];
        x[2 * h] = v.x;
        x[2 * h + 1] = v.y;
    }
}
template <int KPL>
__device__ __forceinline__ void store_list(key_t64* p, const key_t64 (&x)[KPL], int lane) {
    ulonglong2* q = reinterpret_cast<ulonglong2*>(p + KPL * lane);
#pragma unroll
    for (int h = 0; h < KPL / 2; ++h) q[h] = make_ulonglong2(x[2 * h], x[2 * h + 1]);
}

// Block q's part of a merge: row j < TF_RPB of the block takes warps
// j·TF_WPR …; warp s merges lists s, s + TF_WPR, … < n of its row (src(x,
// g) loads list g, the next one in flight while the current one merges)
// into a running list, then the warps' lists merge in a tree. The row's
// list ends in part[j·TF_WPR].
template <int KPL, typename Src>
__device__ __forceinline__ void merge_rows(key_t64* part, int n, bool live, int warp, int lane,
                                           Src src) {
    constexpr int LW = 32 * KPL;
    const int s = warp % TF_WPR;
    key_t64* mine = part + (size_t)warp * LW;  // = (j·TF_WPR + s)·LW
    if (live) {
        key_t64 acc[KPL], nxt[KPL];
#pragma unroll
        for (int e = 0; e < KPL; ++e) acc[e] = nxt[e] = KEY_NONE;
        if (s < n) src(nxt, s);
        for (int g = s; g < n; g += TF_WPR) {
            key_t64 x[KPL];
#pragma unroll
            for (int e = 0; e < KPL; ++e) x[e] = nxt[e];
            if (g + TF_WPR < n) src(nxt, g + TF_WPR);
            if (g == s) {
#pragma unroll
                for (int e = 0; e < KPL; ++e) acc[e] = x[e];
            } else {
                warp_merge_into<KPL>(acc, x, lane);
            }
        }
        store_list<KPL>(mine, acc, lane);
    }
#pragma unroll
    for (int w = TF_WPR / 2; w >= 1; w >>= 1) {
        __syncthreads();
        if (live && s < w) {
            key_t64 x[KPL], y[KPL];
            load_list<KPL>(x, mine + (size_t)w * LW, lane);
            load_list<KPL>(y, mine, lane);
            warp_merge_into<KPL>(y, x, lane);
            store_list<KPL>(mine, y, lane);
        }
    }
    __syncthreads();
}

// The first K keys of a merged row, decoded (lane l holds slots KPL·l …).
template <int KPL>
__device__ __forceinline__ void decode_row(const key_t64* list, int row, int K, int lane,
                                           float* __restrict__ out_s, int* __restrict__ out_i) {
#pragma unroll
    for (int e = 0; e < KPL; ++e) {
        const int slot = lane * KPL + e;
        if (slot < K)
            decode_key(list[slot], out_s[(size_t)row * K + slot], out_i[(size_t)row * K + slot]);
    }
}

// KPL: keys a lane of a running list (lists of 32·KPL ≥ k_pad keys).
template <typename T, bool VEC, int KPL>
__global__ void __cluster_dims__(TOPK_FUSED_CLUSTER, 1, 1)
__launch_bounds__(TOPK_FUSED_THREADS, TOPK_FUSED_MIN_BLOCKS)
topk_fused_kernel(const float* __restrict__ phi, const T* __restrict__ psi,
                  const float* __restrict__ scale, const int* __restrict__ excl, int L,
                  const unsigned char* __restrict__ mask, long long mask_stride, int B,
                  int n_rows, int D, int id_offset, int n_valid, int K, int lk_pad,
                  key_t64* __restrict__ cand, int* __restrict__ counters,
                  float* __restrict__ out_s, int* __restrict__ out_i) {
    constexpr int LW = 32 * KPL;
    extern __shared__ __align__(16) unsigned char tf_smem[];
    key_t64* lists = reinterpret_cast<key_t64*>(tf_smem);           // [ROWS][LW]
    unsigned char* pool = tf_smem + tf_lists_bytes(KPL);
    float* psi_s = reinterpret_cast<float*>(pool);                  // [DSLAB][chunk + 1]
    key_t64* keys = reinterpret_cast<key_t64*>(pool);               // [ROWS][KEY_PITCH]
    key_t64* part = reinterpret_cast<key_t64*>(pool);               // merge scratch
    float* phi_s = reinterpret_cast<float*>(pool + tf_pool_bytes(KPL));  // [DSLAB][ROWS]
    int* flag = reinterpret_cast<int*>(pool + tf_pool_bytes(KPL) + TF_PHI_BYTES);
    key_t64* thr_s = reinterpret_cast<key_t64*>(flag + 4);          // [ROWS]
    key_t64* lmin_s = thr_s + TOPK_ROWS;                            // [ROWS][32]
    int* real_s = reinterpret_cast<int*>(lmin_s + TOPK_ROWS * 32);  // [ROWS]
    int* excl_s = real_s + TOPK_ROWS;                               // [ROWS][L]

    cg::cluster_group cluster = cg::this_cluster();
    constexpr int EPW = 4 / (int)sizeof(T);
    constexpr int VW = VEC ? 4 * EPW : 1;
    constexpr int PER_ITEM = TOPK_DSLAB / VW;
    constexpr int PT = TOPK_MAX_CHUNK * PER_ITEM / TOPK_FUSED_THREADS;  // loads a thread
    static_assert(PT >= 1 && PT * TOPK_FUSED_THREADS == TOPK_MAX_CHUNK * PER_ITEM,
                  "a slab's loads spread evenly over the threads");
    constexpr int pitch = TOPK_MAX_CHUNK + 1;
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    const int r0 = blockIdx.y * TOPK_ROWS;
    const int k_pad = 1 << lk_pad;
    const int n_blocks = gridDim.x, n_clusters = n_blocks / TOPK_FUSED_CLUSTER;
    const int n_chunks = (n_rows + TOPK_MAX_CHUNK - 1) / TOPK_MAX_CHUNK;
    const bool staged = L <= TOPK_FUSED_EXCL_STAGE;
    if (staged)
        for (int q = t; q < TOPK_ROWS * L; q += TOPK_FUSED_THREADS) {
            const int row = r0 + q / L;
            excl_s[q] = row < B ? __ldg(excl + (size_t)row * L + q % L) : -1;
        }
    for (int q = t; q < TOPK_ROWS * LW; q += TOPK_FUSED_THREADS) lists[q] = KEY_NONE;
    const int it = t % TOPK_MAX_CHUNK, hf = t / TOPK_MAX_CHUNK;

    // chunk c's keys into the pool, [ROWS][KEY_PITCH] (KEY_NONE past the table)
    auto score_chunk = [&](int c) {
        const int item0 = c * TOPK_MAX_CHUNK;
        uint4 reg4[VEC ? PT : 1];
        float sc4[VEC ? PT : 1];
        float reg1[VEC ? 1 : PT];
        float phv[TF_PHI_PT];
        auto load = [&](int d0) {
#pragma unroll
            for (int j = 0; j < PT; ++j) {
                const int i = t + j * TOPK_FUSED_THREADS;
                const int g = item0 + i / PER_ITEM, d = d0 + (i % PER_ITEM) * VW;
                const bool in = g < n_rows && d < D;
                if constexpr (VEC) {
                    reg4[j] = in ? __ldg(reinterpret_cast<const uint4*>(psi + (size_t)g * D + d))
                                 : make_uint4(0u, 0u, 0u, 0u);
                    if (scale != nullptr) sc4[j] = in ? __ldg(scale + g) : 0.0f;
                } else {
                    float v = in ? load_elem(psi + (size_t)g * D + d) : 0.0f;
                    if (scale != nullptr && in) v *= __ldg(scale + g);
                    reg1[j] = v;
                }
            }
#pragma unroll
            for (int j = 0; j < TF_PHI_PT; ++j) {
                const int i = t + j * TOPK_FUSED_THREADS;
                const int row = r0 + i / TOPK_DSLAB, d = d0 + i % TOPK_DSLAB;
                phv[j] = (row < B && d < D) ? __ldg(phi + (size_t)row * D + d) : 0.0f;
            }
        };
        auto store = [&]() {
#pragma unroll
            for (int j = 0; j < PT; ++j) {
                const int i = t + j * TOPK_FUSED_THREADS;
                const int ii = i / PER_ITEM, dd = (i % PER_ITEM) * VW;
                if constexpr (VEC) {
                    const uint32_t w[4] = {reg4[j].x, reg4[j].y, reg4[j].z, reg4[j].w};
#pragma unroll
                    for (int e = 0; e < VW; ++e) {
                        float v = word_elem<T>(w[e / EPW], e % EPW);
                        if (scale != nullptr) v *= sc4[j];
                        psi_s[(dd + e) * pitch + ii] = v;
                    }
                } else {
                    psi_s[dd * pitch + ii] = reg1[j];
                }
            }
#pragma unroll
            for (int j = 0; j < TF_PHI_PT; ++j) {
                const int i = t + j * TOPK_FUSED_THREADS;
                phi_s[(i % TOPK_DSLAB) * TOPK_ROWS + i / TOPK_DSLAB] = phv[j];
            }
        };

        float acc[TF_ROWS_T];
#pragma unroll
        for (int r = 0; r < TF_ROWS_T; ++r) acc[r] = 0.0f;
        if (c < n_chunks) {
            load(0);
            for (int d0 = 0; d0 < D; d0 += TOPK_DSLAB) {
                store();
                __syncthreads();
                if (d0 + TOPK_DSLAB < D) load(d0 + TOPK_DSLAB);
#pragma unroll 4
                for (int dd = 0; dd < TOPK_DSLAB; ++dd) {
                    const float p = psi_s[dd * pitch + it];
                    const float4* ph =
                        reinterpret_cast<const float4*>(phi_s + dd * TOPK_ROWS + hf * TF_ROWS_T);
#pragma unroll
                    for (int r4 = 0; r4 < TF_ROWS_T / 4; ++r4) {
                        const float4 f = ph[r4];
                        acc[4 * r4 + 0] = fmaf(f.x, p, acc[4 * r4 + 0]);
                        acc[4 * r4 + 1] = fmaf(f.y, p, acc[4 * r4 + 1]);
                        acc[4 * r4 + 2] = fmaf(f.z, p, acc[4 * r4 + 2]);
                        acc[4 * r4 + 3] = fmaf(f.w, p, acc[4 * r4 + 3]);
                    }
                }
                __syncthreads();
            }
        }

        // the ψ slab is dead: the pool now holds the chunk's keys
        const int local = item0 + it;
        const bool in_range = c < n_chunks && local < n_valid;
        const int gid = id_offset + local;
#pragma unroll
        for (int r = 0; r < TF_ROWS_T; ++r) {
            const int rr = hf * TF_ROWS_T + r, row = r0 + rr;
            key_t64 key = KEY_NONE;
            if (in_range && row < B) {
                bool hit = mask != nullptr && mask[(size_t)row * mask_stride + local] != 0;
                const int* ex = staged ? excl_s + rr * L : excl + (size_t)row * L;
                for (int l = 0; l < L; ++l) hit |= ex[l] == gid;
                if (!hit) key = ((key_t64)desc_bits(acc[r]) << 32) | (uint32_t)gid;
            }
            keys[rr * KEY_PITCH + it + (it >> 3)] = key;
        }
        __syncthreads();
    };

    // the chunk's keys of row rr that are ≤ bound and below the row's
    // list's k_pad-th, compacted, sorted in the smallest network that holds
    // them, and merged into the list (one warp, its own row)
    auto select_row = [&](int rr, key_t64 bound, bool empty) {
        key_t64 x[8];
        key_t64* kr = keys + rr * KEY_PITCH;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
            const int i = lane * 8 + e;
            x[e] = kr[i + (i >> 3)];
        }
        key_t64* lst = lists + rr * LW;
        const key_t64 kth = lst[k_pad - 1];
        int n = 0;
        unsigned keep_bits = 0;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
            const bool keep = x[e] <= bound && x[e] < kth;
            n += __popc(__ballot_sync(0xffffffffu, keep));
            if (keep) keep_bits |= 1u << e;
            else x[e] = KEY_NONE;
        }
        if (n == 0) return;
        key_t64 f[KPL];
        if (n <= 128) {
            // compact the kept keys into the row's own key region
            __syncwarp();
            int base = 0;
#pragma unroll
            for (int e = 0; e < 8; ++e) {
                const unsigned bal = __ballot_sync(0xffffffffu, (keep_bits >> e) & 1u);
                if ((keep_bits >> e) & 1u) kr[base + __popc(bal & ((1u << lane) - 1u))] = x[e];
                base += __popc(bal);
            }
            __syncwarp();
            if (n <= 32) {
                key_t64 z[1];
                z[0] = lane < n ? kr[lane] : KEY_NONE;
                warp_sort_kpl<1>(z, lane);
                relayout<KPL, 1>(f, z, lane);
            } else if (n <= 64) {
                key_t64 z[2];
#pragma unroll
                for (int e = 0; e < 2; ++e) z[e] = lane * 2 + e < n ? kr[lane * 2 + e] : KEY_NONE;
                warp_sort_kpl<2>(z, lane);
                relayout<KPL, 2>(f, z, lane);
            } else {
                key_t64 z[4];
#pragma unroll
                for (int e = 0; e < 4; ++e) z[e] = lane * 4 + e < n ? kr[lane * 4 + e] : KEY_NONE;
                warp_sort_kpl<4>(z, lane);
                relayout<KPL, 4>(f, z, lane);
            }
        } else {
            warp_sort256(x, lane);
            relayout<KPL, 8>(f, x, lane);
        }
        if (!empty) {  // the list holds keys: merge (an empty list takes f as it is)
            key_t64 y[KPL];
            load_list<KPL>(y, lst, lane);
            warp_merge_into<KPL>(y, f, lane);
#pragma unroll
            for (int e = 0; e < KPL; ++e) f[e] = y[e];
        }
        store_list<KPL>(lst, f, lane);
    };

    // round 0: the block's first chunk, then the cluster's bound T a row.
    // Each row's 32 lane minima (distinct keys, or KEY_NONE) are sorted and
    // published with their count of real keys; every block then reads the
    // cluster's counts, finds the least m with Σ_b min(real_b, m) ≥ k_pad,
    // and takes T = max over the blocks of their min(m, real_b)-th smallest
    // minimum: at least k_pad keys of the cluster are ≤ T.
    score_chunk(blockIdx.x);
    for (int rr = warp; rr < TOPK_ROWS; rr += TF_WARPS) {
        const key_t64* kr = keys + rr * KEY_PITCH;
        key_t64 m[1] = {KEY_NONE};
#pragma unroll
        for (int e = 0; e < 8; ++e) {
            const int i = lane * 8 + e;
            const key_t64 v = kr[i + (i >> 3)];
            m[0] = v < m[0] ? v : m[0];
        }
        warp_sort_kpl<1>(m, lane);
        lmin_s[rr * 32 + lane] = m[0];
        const int real = __popc(__ballot_sync(0xffffffffu, m[0] != KEY_NONE));
        if (lane == 0) real_s[rr] = real;
    }
    cluster.sync();
    for (int rr = warp; rr < TOPK_ROWS; rr += TF_WARPS) {
        if (r0 + rr >= B) break;  // rr is the same across the warp
        // lane b < TOPK_FUSED_CLUSTER: block b's sorted minima and their count
        const bool reader = lane < TOPK_FUSED_CLUSTER;
        const key_t64* lb = reader ? cluster.map_shared_rank(lmin_s, lane) + rr * 32 : nullptr;
        const int real = reader ? cluster.map_shared_rank(real_s, lane)[rr] : 0;
        auto total = [&](int m) {
            int v = min(real, m);
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
            return v;
        };
        key_t64 bound = KEY_NONE;
        if (total(32) >= k_pad) {
            int lo = 1, hi = 32;  // the least m with total(m) ≥ k_pad
            while (lo < hi) {
                const int mid = (lo + hi) >> 1;
                if (total(mid) >= k_pad) hi = mid; else lo = mid + 1;
            }
            key_t64 v = real > 0 ? lb[min(lo, real) - 1] : 0ull;
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) {
                const key_t64 y = __shfl_xor_sync(0xffffffffu, v, o);
                v = v > y ? v : y;
            }
            bound = v;
        }
        if (lane == 0) thr_s[rr] = bound;
        select_row(rr, bound, true);
    }
    __syncthreads();
    // later chunks (tables past the grid): the same bound and the running list
    for (int c = blockIdx.x + n_blocks; c < n_chunks; c += n_blocks) {
        score_chunk(c);
        for (int rr = warp; rr < TOPK_ROWS; rr += TF_WARPS)
            if (r0 + rr < B) select_row(rr, thr_s[rr], false);
        __syncthreads();  // the next chunk's ψ slab overwrites the keys
    }

    // the cluster's lists are complete: block q merges rows q·TF_RPB …
    cluster.sync();
    const int q = (int)cluster.block_rank();
    const int j = warp / TF_WPR, s = warp % TF_WPR;
    const int row = r0 + q * TF_RPB + j;
    const bool live = row < B;
    merge_rows<KPL>(part, TOPK_FUSED_CLUSTER, live, warp, lane,
                    [&](key_t64 (&x)[KPL], int g) {
                        load_list<KPL>(x, cluster.map_shared_rank(lists, g) +
                                              (q * TF_RPB + j) * LW, lane);
                    });
    const key_t64* merged = part + (size_t)j * TF_WPR * LW;
    if (n_clusters > 1 && live && s == 0) {
        key_t64* out = cand + ((size_t)(blockIdx.x / TOPK_FUSED_CLUSTER) * B + row) * k_pad;
#pragma unroll
        for (int e = 0; e < KPL; ++e)
            if (lane * KPL + e < k_pad) out[lane * KPL + e] = merged[lane * KPL + e];
    }
    __threadfence();
    cluster.sync();  // no block leaves while another reads its lists
    if (n_clusters == 1) {
        if (live && s == 0) decode_row<KPL>(merged, row, K, lane, out_s, out_i);
        return;
    }
    if (q == 0 && t == 0) {
        __threadfence();
        const int last = atomicAdd(counters + blockIdx.y, 1) == n_clusters - 1;
        if (last) counters[blockIdx.y] = 0;  // every cluster has counted: ready for the next call
        for (int g = 0; g < TOPK_FUSED_CLUSTER; ++g) *cluster.map_shared_rank(flag, g) = last;
    }
    cluster.sync();
    if (!*flag) return;
    __threadfence();

    // the last cluster: the n_clusters lists of each row, from device memory
    merge_rows<KPL>(part, n_clusters, live, warp, lane, [&](key_t64 (&x)[KPL], int g) {
        const key_t64* p = cand + ((size_t)g * B + row) * k_pad;
#pragma unroll
        for (int e = 0; e < KPL; ++e)
            x[e] = lane * KPL + e < k_pad ? __ldcg(p + lane * KPL + e) : KEY_NONE;
    });
    if (live && s == 0) decode_row<KPL>(merged, row, K, lane, out_s, out_i);
}

template <typename T, int KPL>
static cudaError_t launch_fused(const float* phi, const void* psi, const float* scale,
                                const int* excl, int L, const unsigned char* mask,
                                long long mask_stride, int B, int n_rows, int D, int id_offset,
                                int n_valid, int K, int lk_pad, int n_blocks, key_t64* cand,
                                int* counters, float* out_s, int* out_i, cudaStream_t st) {
    const T* p = static_cast<const T*>(psi);
    const bool vec = ((size_t)D * sizeof(T)) % 16 == 0 && ((uintptr_t)p & 15) == 0;
    const size_t smem =
        tf_fixed_bytes(KPL) + (L <= TOPK_FUSED_EXCL_STAGE ? 4 * TOPK_ROWS * L : 0);
    const dim3 grid(n_blocks, (B + TOPK_ROWS - 1) / TOPK_ROWS);
    auto kern = vec ? topk_fused_kernel<T, true, KPL> : topk_fused_kernel<T, false, KPL>;
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err == cudaSuccess && TOPK_FUSED_CLUSTER > 8)  // past 8 blocks: non-portable
        err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    kern<<<grid, TOPK_FUSED_THREADS, smem, st>>>(phi, p, scale, excl, L, mask, mask_stride, B,
                                                 n_rows, D, id_offset, n_valid, K, lk_pad, cand,
                                                 counters, out_s, out_i);
    return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_fused_k(const float* phi, const void* psi, const float* scale,
                                  const int* excl, int L, const unsigned char* mask,
                                  long long mask_stride, int B, int n_rows, int D,
                                  int id_offset, int n_valid, int K, int lk_pad, int n_blocks,
                                  key_t64* cand, int* counters, float* out_s, int* out_i,
                                  cudaStream_t st) {
    // lists of 128 keys while k_pad allows (a merge half the work), else 256
    if (lk_pad <= 7)
        return launch_fused<T, 4>(phi, psi, scale, excl, L, mask, mask_stride, B, n_rows, D,
                                  id_offset, n_valid, K, lk_pad, n_blocks, cand, counters,
                                  out_s, out_i, st);
    return launch_fused<T, 8>(phi, psi, scale, excl, L, mask, mask_stride, B, n_rows, D,
                              id_offset, n_valid, K, lk_pad, n_blocks, cand, counters, out_s,
                              out_i, st);
}

static int log2_exact(int x) {
    if (x <= 0 || (x & (x - 1)) != 0) return -1;
    int l = 0;
    while ((1 << l) < x) ++l;
    return l;
}

// The IVF form's plan: one block walks the clusters in tiles of its
// threads. A cluster is live if any of the B φ rows probed it and it holds
// rows; it contributes ceil(count / chunk) list entries, written in cluster
// order at the exclusive prefix sum of the live clusters' entries. *n_active
// gets the total. Nothing here leaves the device. The caller's max_lists
// must bound the total (the wrapper's default, clusters × chunks a block,
// always does); the list is never written past it.
#define PLAN_THREADS 1024
__global__ void __launch_bounds__(PLAN_THREADS)
topk_ivf_plan_kernel(const unsigned char* __restrict__ probe, int B, int C,
                     const int* __restrict__ counts, int lchunk, int chunks_per_block,
                     int max_lists, int* __restrict__ list, int* __restrict__ n_active) {
    __shared__ int warp_sum[PLAN_THREADS / 32];
    __shared__ int carry;
    const int t = threadIdx.x, lane = t & 31, wid = t >> 5;
    if (t == 0) carry = 0;
    __syncthreads();
    for (int base = 0; base < C; base += PLAN_THREADS) {
        const int c = base + t;
        int n = 0;
        if (c < C) {
            const int cnt = counts[c];
            bool hit = false;
            for (int b = 0; b < B && !hit; ++b) hit = probe[(size_t)b * C + c] != 0;
            if (hit && cnt > 0) n = (cnt + (1 << lchunk) - 1) >> lchunk;
        }
        // block-wide inclusive scan of n: warps, then the warps' totals
        int inc = n;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int y = __shfl_up_sync(0xffffffffu, inc, o);
            if (lane >= o) inc += y;
        }
        if (lane == 31) warp_sum[wid] = inc;
        __syncthreads();
        if (wid == 0) {
            int v = lane < PLAN_THREADS / 32 ? warp_sum[lane] : 0;
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const int y = __shfl_up_sync(0xffffffffu, v, o);
                if (lane >= o) v += y;
            }
            if (lane < PLAN_THREADS / 32) warp_sum[lane] = v;  // inclusive
        }
        __syncthreads();
        const int start = carry + (wid > 0 ? warp_sum[wid - 1] : 0) + inc - n;
        for (int j = 0; j < n && start + j < max_lists; ++j)
            list[start + j] = c * chunks_per_block + j;
        __syncthreads();
        if (t == PLAN_THREADS - 1) carry += warp_sum[PLAN_THREADS / 32 - 1];
        __syncthreads();
    }
    if (t == 0) *n_active = min(carry, max_lists);
}

template <typename T, bool IVF>
static cudaError_t launch_chunks(const float* phi, const void* psi, const float* scale,
                                 const int* excl, int L, const unsigned char* mask,
                                 long long mask_stride, int B, int n_rows, int D,
                                 int id_offset, int n_valid, int lchunk, int lk_keep,
                                 int n_chunks, key_t64* cand, const IvfArgs& ivf,
                                 cudaStream_t st) {
    const int chunk = 1 << lchunk;
    if (n_chunks == 0) return cudaSuccess;
    const T* p = static_cast<const T*>(psi);
    dim3 grid(n_chunks, (B + TOPK_ROWS - 1) / TOPK_ROWS);
    const bool vec = ((size_t)D * sizeof(T)) % 16 == 0 && ((uintptr_t)p & 15) == 0;
    if (vec)
        topk_chunk_kernel<T, true, IVF><<<grid, chunk, 0, st>>>(
            phi, p, scale, excl, L, mask, mask_stride, B, n_rows, D, id_offset, n_valid,
            lchunk, lk_keep, cand, ivf);
    else
        topk_chunk_kernel<T, false, IVF><<<grid, chunk, 0, st>>>(
            phi, p, scale, excl, L, mask, mask_stride, B, n_rows, D, id_offset, n_valid,
            lchunk, lk_keep, cand, ivf);
    return cudaGetLastError();
}

template <bool IVF>
static cudaError_t launch_pass1(int psi_type, const float* phi, const void* psi,
                                const float* scale, const int* excl, int L,
                                const unsigned char* mask, long long mask_stride, int B,
                                int n_rows, int D, int id_offset, int n_valid, int lchunk,
                                int lk_keep, int n_chunks, key_t64* cand, const IvfArgs& ivf,
                                cudaStream_t st) {
    if (psi_type == 0)
        return launch_chunks<float, IVF>(phi, psi, scale, excl, L, mask, mask_stride, B, n_rows,
                                         D, id_offset, n_valid, lchunk, lk_keep, n_chunks,
                                         cand, ivf, st);
    if (psi_type == 1)
        return launch_chunks<uint16_t, IVF>(phi, psi, scale, excl, L, mask, mask_stride, B,
                                            n_rows, D, id_offset, n_valid, lchunk, lk_keep,
                                            n_chunks, cand, ivf, st);
    return launch_chunks<int8_t, IVF>(phi, psi, scale, excl, L, mask, mask_stride, B, n_rows,
                                      D, id_offset, n_valid, lchunk, lk_keep, n_chunks, cand,
                                      ivf, st);
}

// The merge levels after pass 1 over n_lists candidate lists (an upper bound
// when dev_n holds the live count). chunk ≥ k_pad: each list holds k_pad
// keys, cand holds (n_lists, B, k_pad) keys and cand2 (ceil(n_lists /
// SLOTS), B, k_pad), and the shared-memory levels ping-pong between them;
// chunk < k_pad (large K), pass 1 wrote (n_lists, B, chunk) whole sorted
// chunks, cand and cand2 each hold `scratch` keys a φ row, and the
// device-memory levels ping-pong between them.
static cudaError_t launch_merges(int n_lists, const int* dev_n, int B, int K, int lk_pad,
                                 int lchunk, long long scratch, key_t64* cand,
                                 key_t64* cand2, float* out_s, int* out_i, cudaStream_t st) {
    cudaError_t err = cudaSuccess;
    const key_t64* src = cand;
    key_t64* bufs[2] = {cand2, cand};
    int n = n_lists, level = 0;
    if (lchunk >= lk_pad) {
        while (n > TOPK_MERGE_SLOTS) {
            const int groups = (n + TOPK_MERGE_SLOTS - 1) / TOPK_MERGE_SLOTS;
            key_t64* dst = bufs[level & 1];
            topk_merge_kernel<false><<<dim3(groups, B), TOPK_MERGE_THREADS, 0, st>>>(
                src, n, dev_n, level, B, lk_pad, dst, K, out_s, out_i);
            err = cudaGetLastError();
            if (err != cudaSuccess) return err;
            src = dst;
            n = groups;
            ++level;
        }
        topk_merge_kernel<true><<<dim3(1, B), TOPK_MERGE_THREADS, 0, st>>>(
            src, n, dev_n, level, B, lk_pad, nullptr, K, out_s, out_i);
        return cudaGetLastError();
    }
    int llen = lchunk;
    while (n > 1) {
        const int llout = llen + 1 < lk_pad ? llen + 1 : lk_pad;
        const int groups = (n + 1) >> 1;
        if ((long long)groups << llout > scratch) return cudaErrorInvalidValue;
        key_t64* dst = bufs[level & 1];
        const long long threads = (long long)groups << (llen + 1);
        topk_merge_global_kernel<<<dim3((unsigned)((threads + 255) / 256), B), 256, 0, st>>>(
            src, n, dev_n, level, B, llen, llout, dst);
        err = cudaGetLastError();
        if (err != cudaSuccess) return err;
        src = dst;
        n = groups;
        llen = llout;
        ++level;
    }
    topk_decode_kernel<<<dim3((K + 255) / 256, B), 256, 0, st>>>(
        n > 0 ? src : nullptr, dev_n, B, llen, K, out_s, out_i);
    return cudaGetLastError();
}

// psi_type: 0 fp32, 1 bf16, 2 int8. The merges: see launch_merges.
extern "C" int topk_score_run(const float* phi, const void* psi, int psi_type,
                              const float* scale, const int* excl, int L,
                              const unsigned char* mask, long long mask_stride, int B,
                              int n_rows, int D, int id_offset, int n_valid, int K,
                              int k_pad, int chunk, long long scratch,
                              key_t64* cand, key_t64* cand2, float* out_s, int* out_i,
                              void* stream) {
    const int lk_pad = log2_exact(k_pad), lchunk = log2_exact(chunk);
    if (B < 1 || B > 65535 || n_rows < 0 || D < 1 || L < 0 || K < 1 || K > k_pad ||
        lk_pad < 0 || lchunk < 5 || chunk > TOPK_MAX_CHUNK || n_valid < 0 ||
        n_valid > n_rows || psi_type < 0 || psi_type > 2 ||
        (mask != nullptr && B > 1 && mask_stride < n_rows))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const int n_chunks = (n_rows + chunk - 1) / chunk;
    const bool large_k = chunk < k_pad;
    if (large_k && (long long)n_chunks * chunk > scratch) return (int)cudaErrorInvalidValue;
    const int lk_keep = large_k ? lchunk : lk_pad;
    cudaError_t err = launch_pass1<false>(psi_type, phi, psi, scale, excl, L, mask,
                                          mask_stride, B, n_rows, D, id_offset, n_valid,
                                          lchunk, lk_keep, n_chunks, cand, IvfArgs{}, st);
    if (err != cudaSuccess) return (int)err;
    return (int)launch_merges(n_chunks, nullptr, B, K, lk_pad, lchunk, scratch, cand, cand2,
                              out_s, out_i, st);
}

// The IVF form over an index of n_clusters cluster-contiguous blocks of
// block_rows rows (psi, scale and ids_global have n_clusters · block_rows
// rows; counts holds each cluster's valid rows; probe is (B, n_clusters),
// nonzero where a φ row probed a cluster). One chain: the plan (the live
// (cluster, chunk) list and its length, on the device), pass 1 over at most
// max_lists list entries, the merge levels sized for max_lists and reading
// the live count, the decode. list holds max_lists ints, n_active one.
// Exclusion compares the global ids of excl with ids_global.
extern "C" int topk_score_ivf_run(const float* phi, const void* psi, int psi_type,
                                  const float* scale, const int* excl, int L,
                                  const int* ids_global, const int* counts,
                                  const unsigned char* probe, int n_clusters, int block_rows,
                                  int B, int D, int K, int k_pad, int chunk, int max_lists,
                                  long long scratch, int* list, int* n_active, key_t64* cand,
                                  key_t64* cand2, float* out_s, int* out_i, void* stream) {
    const int lk_pad = log2_exact(k_pad), lchunk = log2_exact(chunk);
    if (B < 1 || B > 65535 || n_clusters < 1 || block_rows < 1 || D < 1 || L < 0 || K < 1 ||
        K > k_pad || lk_pad < 0 || lchunk < 5 || chunk > TOPK_MAX_CHUNK || max_lists < 1 ||
        psi_type < 0 || psi_type > 2 ||
        (long long)n_clusters * block_rows > 0x7FFFFFFFLL)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const bool large_k = chunk < k_pad;
    if (large_k && (long long)max_lists * chunk > scratch) return (int)cudaErrorInvalidValue;
    const int chunks_per_block = (block_rows + chunk - 1) / chunk;
    topk_ivf_plan_kernel<<<1, PLAN_THREADS, 0, st>>>(probe, B, n_clusters, counts, lchunk,
                                                     chunks_per_block, max_lists, list,
                                                     n_active);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const IvfArgs ivf{ids_global, counts, list, n_active, probe, n_clusters, block_rows,
                      chunks_per_block};
    const int n_rows = n_clusters * block_rows;
    err = launch_pass1<true>(psi_type, phi, psi, scale, excl, L, nullptr, 0, B, n_rows, D, 0,
                             n_rows, lchunk, large_k ? lchunk : lk_pad, max_lists, cand, ivf,
                             st);
    if (err != cudaSuccess) return (int)err;
    return (int)launch_merges(max_lists, n_active, B, K, lk_pad, lchunk, scratch, cand, cand2,
                              out_s, out_i, st);
}

// The exact form in one launch (topk_fused_kernel), k_pad ≤ TOPK_MAX_CHUNK.
// n_blocks: a multiple of TOPK_FUSED_CLUSTER; cand holds (n_blocks /
// TOPK_FUSED_CLUSTER, B, k_pad) keys (unused, may be null, for one cluster);
// counters holds ⌈B / TOPK_ROWS⌉ ints, zero before the call and after it.
// The other arguments as topk_score_run's.
extern "C" int topk_score_fused_run(const float* phi, const void* psi, int psi_type,
                                    const float* scale, const int* excl, int L,
                                    const unsigned char* mask, long long mask_stride, int B,
                                    int n_rows, int D, int id_offset, int n_valid, int K,
                                    int k_pad, int n_blocks, key_t64* cand, int* counters,
                                    float* out_s, int* out_i, void* stream) {
    const int lk_pad = log2_exact(k_pad);
    const int n_clusters = n_blocks / TOPK_FUSED_CLUSTER;
    if (B < 1 || B > 65535 * TOPK_ROWS || n_rows < 0 || D < 1 || L < 0 || K < 1 ||
        K > k_pad || lk_pad < 0 || k_pad > TOPK_MAX_CHUNK || n_valid < 0 || n_valid > n_rows ||
        psi_type < 0 || psi_type > 2 || n_clusters < 1 ||
        n_clusters * TOPK_FUSED_CLUSTER != n_blocks || counters == nullptr ||
        (n_clusters > 1 && cand == nullptr) || (L > 0 && excl == nullptr) ||
        (mask != nullptr && B > 1 && mask_stride < n_rows))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (psi_type == 0)
        return (int)launch_fused_k<float>(phi, psi, scale, excl, L, mask, mask_stride, B, n_rows,
                                        D, id_offset, n_valid, K, lk_pad, n_blocks, cand,
                                        counters, out_s, out_i, st);
    if (psi_type == 1)
        return (int)launch_fused_k<uint16_t>(phi, psi, scale, excl, L, mask, mask_stride, B,
                                           n_rows, D, id_offset, n_valid, K, lk_pad, n_blocks,
                                           cand, counters, out_s, out_i, st);
    return (int)launch_fused_k<int8_t>(phi, psi, scale, excl, L, mask, mask_stride, B, n_rows, D,
                                     id_offset, n_valid, K, lk_pad, n_blocks, cand, counters,
                                     out_s, out_i, st);
}

extern "C" const char* topk_score_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
