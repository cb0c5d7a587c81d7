// Segment sums over sorted rows: out_v[r] = Σ_{j ∈ [offsets[r], offsets[r+1])} in_v[j]
// for 1 to 4 fp32 value vectors that share one CSR offsets vector, hand-written for
// Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package sums the flat log's per-entry values with
// jax.ops.segment_sum under XLA (repro/sparse/segment.py); the port's scatter form,
// a zeros fill and an atomic index_add_, reads the int64 row ids besides the values
// and lets every entry of a hot row contend for one address. The log's entries are
// already sorted by row on both sides (sparse/interactions.py keeps the CSR offsets
// of the context-major and the item-major order), so this kernel reads only the
// values and the offsets, and sums in a fixed order.
//
// What bounds it on an H100: bytes. A call reads V·nnz·4 bytes of values, the
// (n + 1)·8 bytes of offsets, and writes V·n·4 bytes: at icd-mf's full width (19.99 M
// entries) two values are 163.1 MB on the context side (n = 200,000) and 161.0 MB on
// the item side (n = 68,000), ≈ 48.7 and 48.1 µs at 3.35 TB/s; four values twice that.
// The work per entry is a few instructions, so the design keeps the fixed cost of a
// tile (its searches, its scan, its synchronisation) small beside its entries.
//
// Design (Merrill and Garland, "Merge-based Parallel Sparse Matrix-Vector
// Multiplication", SC 2016): the work is the merge path of the n row ends and the nnz
// entries, n + nnz items, cut into equal slices, one slice a warp, so a warp's work
// does not depend on how the entries fall into rows: the top item's 97,294 entries
// spread over many slices, and runs of empty rows cost one step each.
//   pass 1 — each warp finds the edges of its slice's tiles (32 × SEGSUM_ITEMS path
//     items each) by binary searches in the offsets, a lane an edge, and walks them in
//     order with no block-wide synchronisation. A tile's values are copied into the
//     warp's shared memory by cp.async, 16 bytes at a time (4-byte copies for the few
//     entries before the first 16-byte boundary and after the last) into one of two
//     buffers, the next tile's while this one is summed, and its row ends beside them
//     (more buffers gained nothing; 16-byte loads into shared memory, which leave each
//     warp's wait exposed, took 4–15% longer a call). Each lane finds its own
//     SEGSUM_ITEMS-item stretch of the tile's path by a short binary search in shared
//     memory and sums its entries in registers, writing each row it both opens and
//     closes. The partial sums of rows that cross lanes are joined by a segmented scan
//     over the warp (shuffles), carried from tile to tile; a row that opens and closes
//     inside the slice is written there. The slice's first row (its
//     partial sum up to its close or the slice's end) and the row still open at the
//     slice's end (its partial sum) go to scratch.
//   pass 2 — one block adds the slices' partials in slice order by the same
//     segmented scan and writes each row that a slice edge cut.
// An empty row sums to 0 on the path, so nothing is filled first. No atomics: every
// sum is taken in an order fixed by the offsets, nnz and the grid alone, so the result
// is the same bits on every run over the same layout. Two launches a call.
//
// Interface: plain C functions bound with ctypes. segment_sum_f32 launches on the
// caller's stream, allocates nothing (the wrapper passes the scratch) and returns
// cudaGetLastError(); segment_sum_blocks reports the grid a call may use.

#include <cuda_runtime.h>
#include <stdint.h>

#if !defined(SEGSUM_THREADS) || !defined(SEGSUM_ITEMS)
#error "build through repro_torch/kernels/segment_sum/kernel.py, which passes the tile sizes"
#endif

#define THREADS SEGSUM_THREADS   // a block of pass 1: THREADS / 32 warps, a slice each
#define ITEMS SEGSUM_ITEMS       // path items a lane walks in a tile
#define WARPS (THREADS / 32)
#define WTILE (32 * ITEMS)       // path items of a warp's tile
#define CHUNK 31                 // tiles whose edges a warp searches at once, a lane each
#define VAL_STRIDE (WTILE + 4)   // floats a staged value vector holds: room to align
#define END_STRIDE (WTILE + 4)   // a tile's row ends, and one past them
#define PASS2_THREADS 1024
#define PASS2_SLICES 2           // slices a thread of pass 2 holds in registers
#define FULL_MASK 0xffffffffu

static_assert(THREADS % 32 == 0 && THREADS <= 1024, "whole warps");
static_assert(VAL_STRIDE % 4 == 0 && END_STRIDE % 4 == 0, "staged vectors start on 16 bytes");
static_assert(CHUNK + 1 <= 32, "a lane holds each of a chunk's CHUNK + 1 tile edges");

// floats of shared memory a warp of pass 1 holds for V values: two tiles' values, a
// tile's row ends
__host__ __device__ constexpr int warp_floats(int V) { return 2 * V * VAL_STRIDE + END_STRIDE; }

struct Vectors {
    const float* in[4];
    float* out[4];
};

// One element of the segmented scan: whether a row closed inside it, and the sum of
// the entries after its last close (or of all its entries, if none closed).
template <int V>
struct Seg {
    int closed;
    float v[V];
};

template <int V>
__device__ __forceinline__ Seg<V> seg_zero() {
    Seg<V> s;
    s.closed = 0;
#pragma unroll
    for (int i = 0; i < V; ++i) s.v[i] = 0.f;
    return s;
}

// a then b: b's sums start afresh where b closed a row.
template <int V>
__device__ __forceinline__ Seg<V> seg_join(const Seg<V>& a, const Seg<V>& b) {
    Seg<V> s;
    s.closed = a.closed | b.closed;
#pragma unroll
    for (int i = 0; i < V; ++i) s.v[i] = b.closed ? b.v[i] : a.v[i] + b.v[i];
    return s;
}

template <int V>
__device__ __forceinline__ Seg<V> seg_shfl_up(const Seg<V>& s, int delta) {
    Seg<V> r;
    r.closed = __shfl_up_sync(FULL_MASK, s.closed, delta);
#pragma unroll
    for (int i = 0; i < V; ++i) r.v[i] = __shfl_up_sync(FULL_MASK, s.v[i], delta);
    return r;
}

template <int V>
__device__ __forceinline__ Seg<V> seg_shfl(const Seg<V>& s, int lane) {
    Seg<V> r;
    r.closed = __shfl_sync(FULL_MASK, s.closed, lane);
#pragma unroll
    for (int i = 0; i < V; ++i) r.v[i] = __shfl_sync(FULL_MASK, s.v[i], lane);
    return r;
}

// Exclusive segmented scan of one element a lane over the warp, and the warp's total.
template <int V>
__device__ __forceinline__ Seg<V> warp_exclusive(const Seg<V>& x, Seg<V>& total) {
    const int lane = threadIdx.x & 31;
    Seg<V> inc = x;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const Seg<V> up = seg_shfl_up(inc, o);
        if (lane >= o) inc = seg_join(up, inc);
    }
    total = seg_shfl(inc, 31);
    Seg<V> ex = seg_shfl_up(inc, 1);
    if (lane == 0) ex = seg_zero<V>();
    return ex;
}

// The same over a block of NWARPS warps: warp 0 scans the warps' totals. s_warp holds
// NWARPS + 1 elements; the caller synchronises the block before s_warp is written again.
template <int V, int NWARPS>
__device__ __forceinline__ Seg<V> block_exclusive(const Seg<V>& x, Seg<V>* s_warp,
                                                  Seg<V>& total) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    Seg<V> wtotal;
    const Seg<V> ex = warp_exclusive(x, wtotal);
    if (lane == 0) s_warp[warp] = wtotal;
    __syncthreads();
    if (warp == 0) {
        const Seg<V> w = lane < NWARPS ? s_warp[lane] : seg_zero<V>();
        Seg<V> all;
        const Seg<V> wex = warp_exclusive(w, all);
        if (lane < NWARPS) s_warp[lane] = wex;  // what the warps before it hold
        if (lane == 0) s_warp[NWARPS] = all;    // the block's total
    }
    __syncthreads();
    total = s_warp[NWARPS];
    return seg_join(s_warp[warp], ex);
}

// Rows closed before path item d: the merge path's row coordinate at diagonal d, for
// row ends offsets[1..n] against entries 0..nnz-1 (an entry goes before a row end that
// lies past it).
__device__ __forceinline__ int64_t path_row(const int64_t* __restrict__ offsets,
                                            int64_t n, int64_t nnz, int64_t d) {
    int64_t lo = d > nnz ? d - nnz : 0, hi = d < n ? d : n;
    while (lo < hi) {
        const int64_t mid = (lo + hi) >> 1;
        if (__ldg(offsets + mid + 1) <= d - mid - 1)
            lo = mid + 1;
        else
            hi = mid;
    }
    return lo;
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Where the values p[0..n) of a tile sit in a staged region (VAL_STRIDE floats on 16
// bytes): s[i] = p[i], with s placed so that p's 16-byte groups land on 16 bytes.
__device__ __forceinline__ int lead_of(const float* p) {
    return (int)((4 - (((uintptr_t)p >> 2) & 3)) & 3);  // entries before a 16-byte boundary
}

__device__ __forceinline__ float* staged(const float* p, float* region) {
    return region + ((4 - lead_of(p)) & 3);
}

// The warp starts copying p[0..n) into its staged place: 16-byte copies of the whole
// groups, 4-byte copies of the few entries before the first and after the last.
__device__ __forceinline__ void stage_async(const float* __restrict__ p, int n, float* region,
                                            int lane) {
    float* s = staged(p, region);
    const int lead = lead_of(p), h = lead < n ? lead : n, nvec = (n - h) >> 2;
    for (int i = lane; i < nvec; i += 32) cp_async16(s + h + 4 * i, p + h + 4 * i);
    const int tail = n - h - 4 * nvec, t = h + 4 * nvec + lane - 4;
    if (lane < h) cp_async4(s + lane, p + lane);
    if (lane >= 4 && lane - 4 < tail) cp_async4(s + t, p + t);
}

// A warp's tile: path items [d0, d1), rows x0.. (nrows of them closing in it),
// entries y0.. (nent of them).
struct Tile {
    int64_t x0, y0;
    int nrows, nent, len;
};

__device__ __forceinline__ Tile tile_of(int64_t d0, int64_t d1, int64_t x0, int64_t x1) {
    Tile tl;
    tl.x0 = x0;
    tl.y0 = d0 - x0;
    tl.nrows = (int)(x1 - x0);
    tl.len = (int)(d1 - d0);
    tl.nent = tl.len - tl.nrows;
    return tl;
}

// The end of the tile's i-th row: offsets[x0 + i + 1], nnz past the last row.
__device__ __forceinline__ int64_t row_end(const int64_t* __restrict__ offsets, int64_t n,
                                           int64_t nnz, const Tile& tl, int i) {
    const int64_t row = tl.x0 + i;
    return row < n ? __ldg(offsets + row + 1) : nnz;
}

// A row end relative to the tile's first entry, clamped to the tile.
__device__ __forceinline__ int rel_end(int64_t e, const Tile& tl) {
    e -= tl.y0;
    return (int)(e < 0 ? 0 : (e > tl.nent ? tl.nent : e));
}

template <int V>
__global__ void __launch_bounds__(THREADS) segment_sum_pass1_kernel(
    const int64_t* __restrict__ offsets, int64_t n, int64_t nnz, Vectors vec,
    int64_t* __restrict__ part_row, int* __restrict__ part_closed,
    float* __restrict__ part_head, float* __restrict__ part_tail) {
    extern __shared__ __align__(16) float smem[];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    // this warp's shared memory: [2][V][VAL_STRIDE] values, then the row ends
    float* s_val = smem + warp * warp_floats(V);
    int* s_end = reinterpret_cast<int*>(s_val + 2 * V * VAL_STRIDE);

    const int64_t S = (int64_t)gridDim.x * WARPS, s = (int64_t)blockIdx.x * WARPS + warp;
    const int64_t total_path = n + nnz;
    const int64_t d_begin = total_path * s / S, d_end = total_path * (s + 1) / S;
    Seg<V> carry = seg_zero<V>();  // the slice so far
    int64_t first_row = 0;         // the row at d_begin (read only if the slice closes it)

    for (int64_t c0 = d_begin; c0 < d_end; c0 += (int64_t)CHUNK * WTILE) {
        const int64_t c1 = d_end - c0 < (int64_t)CHUNK * WTILE ? d_end : c0 + (int64_t)CHUNK * WTILE;
        const int ntiles = (int)((c1 - c0 + WTILE - 1) / WTILE);
        // lane i holds the chunk's i-th tile edge: its path item and its row
        const int64_t edge_d = c0 + (int64_t)lane * WTILE < c1 ? c0 + (int64_t)lane * WTILE : c1;
        const int64_t edge_row = lane <= ntiles ? path_row(offsets, n, nnz, edge_d) : 0;
        if (c0 == d_begin) first_row = __shfl_sync(FULL_MASK, edge_row, 0);
        auto tile_at = [&](int t) {
            return tile_of(__shfl_sync(FULL_MASK, edge_d, t), __shfl_sync(FULL_MASK, edge_d, t + 1),
                           __shfl_sync(FULL_MASK, edge_row, t),
                           __shfl_sync(FULL_MASK, edge_row, t + 1));
        };
        // tile t's values go to buffer t & 1
        auto stage_tile = [&](const Tile& tj, int t) {
#pragma unroll
            for (int v = 0; v < V; ++v)
                stage_async(vec.in[v] + tj.y0, tj.nent, s_val + ((t & 1) * V + v) * VAL_STRIDE, lane);
        };

        // tile 0's row ends (a lane each) and values
        Tile next = tile_at(0);
        int64_t next_end = lane <= next.nrows ? row_end(offsets, n, nnz, next, lane) : 0;
        stage_tile(next, 0);
        cp_async_commit();

        for (int t = 0; t < ntiles; ++t) {
            const Tile tl = next;
            float* buf = s_val + (t & 1) * V * VAL_STRIDE;
            if (t + 1 < ntiles) {  // the next tile's values start while this one is summed
                next = tile_at(t + 1);
                stage_tile(next, t + 1);
            }
            cp_async_commit();  // a group a tile, empty or not
            if (lane <= tl.nrows) s_end[lane] = rel_end(next_end, tl);
            for (int i = lane + 32; i <= tl.nrows; i += 32)
                s_end[i] = rel_end(row_end(offsets, n, nnz, tl, i), tl);
            if (t + 1 < ntiles)  // the next tile's first row ends
                next_end = lane <= next.nrows ? row_end(offsets, n, nnz, next, lane) : 0;
            cp_async_wait<1>();  // tile t's values have landed
            __syncwarp();
            const float* sv[V];
#pragma unroll
            for (int v = 0; v < V; ++v) sv[v] = staged(vec.in[v] + tl.y0, buf + v * VAL_STRIDE);

            // this lane's stretch of the tile's path
            Seg<V> mine = seg_zero<V>();
            float head[V];
            int64_t row_open = 0;
            const int d = lane * ITEMS;
            if (d < tl.len) {
                int lo = d > tl.nent ? d - tl.nent : 0, hi = d < tl.nrows ? d : tl.nrows;
                while (lo < hi) {
                    const int mid = (lo + hi) >> 1;
                    if (s_end[mid] <= d - mid - 1)
                        lo = mid + 1;
                    else
                        hi = mid;
                }
                int x = lo, y = d - lo, end = s_end[x];
                row_open = tl.x0 + x;
                float acc[V];
#pragma unroll
                for (int v = 0; v < V; ++v) acc[v] = 0.f;
                const int steps = tl.len - d < ITEMS ? tl.len - d : ITEMS;
                for (int k = 0;;) {
                    // row x's entries in this stretch, summed as one run
                    int e = end < y + steps - k ? end : y + steps - k;
                    e = e > y ? e : y;
                    k += e - y;
                    for (; y < e; ++y) {
#pragma unroll
                        for (int v = 0; v < V; ++v) acc[v] += sv[v][y];
                    }
                    if (k >= steps) break;
                    if (mine.closed) {  // a row this lane opened: complete
                        if (tl.x0 + x < n) {
#pragma unroll
                            for (int v = 0; v < V; ++v) vec.out[v][tl.x0 + x] = acc[v];
                        }
                    } else {
#pragma unroll
                        for (int v = 0; v < V; ++v) head[v] = acc[v];
                        mine.closed = 1;
                    }
#pragma unroll
                    for (int v = 0; v < V; ++v) acc[v] = 0.f;
                    ++k;
                    end = s_end[++x];
                }
#pragma unroll
                for (int v = 0; v < V; ++v) mine.v[v] = acc[v];
            }
            Seg<V> tile_total;
            const Seg<V> before = seg_join(carry, warp_exclusive(mine, tile_total));
            if (mine.closed) {  // the row this lane entered open closes here
                if (before.closed) {
#pragma unroll
                    for (int v = 0; v < V; ++v) vec.out[v][row_open] = before.v[v] + head[v];
                } else {  // the slice's first row: pass 2 adds what came before
#pragma unroll
                    for (int v = 0; v < V; ++v) part_head[v * S + s] = before.v[v] + head[v];
                }
            }
            carry = seg_join(carry, tile_total);
            __syncwarp();  // every lane has read this tile's shared memory
        }
    }
    if (lane == 0) {
        part_row[s] = first_row;
        part_closed[s] = carry.closed;
#pragma unroll
        for (int v = 0; v < V; ++v) (carry.closed ? part_tail : part_head)[v * S + s] = carry.v[v];
    }
}

template <int V>
__global__ void __launch_bounds__(PASS2_THREADS) segment_sum_pass2_kernel(
    int S, Vectors vec, const int64_t* __restrict__ part_row,
    const int* __restrict__ part_closed, const float* __restrict__ part_head,
    const float* __restrict__ part_tail) {
    __shared__ Seg<V> s_warp[PASS2_THREADS / 32 + 1];
    Seg<V> carry = seg_zero<V>();  // the slices before this sweep
    // sweeps of PASS2_THREADS × PASS2_SLICES slices, a thread's in registers
    for (int base = 0; base < S; base += PASS2_THREADS * PASS2_SLICES) {
        const int b0 = base + (int)threadIdx.x * PASS2_SLICES;
        Seg<V> e[PASS2_SLICES];
        float head[PASS2_SLICES][V];
        Seg<V> mine = seg_zero<V>();
#pragma unroll
        for (int k = 0; k < PASS2_SLICES; ++k) {
            const int sl = b0 + k;
            e[k] = seg_zero<V>();
            if (sl < S) {
                e[k].closed = part_closed[sl];
#pragma unroll
                for (int v = 0; v < V; ++v) {
                    head[k][v] = part_head[(int64_t)v * S + sl];
                    e[k].v[v] = part_tail[(int64_t)v * S + sl];
                }
                if (!e[k].closed) {
#pragma unroll
                    for (int v = 0; v < V; ++v) e[k].v[v] = head[k][v];
                }
            }
            mine = seg_join(mine, e[k]);
        }
        Seg<V> total;
        Seg<V> run = seg_join(carry, block_exclusive<V, PASS2_THREADS / 32>(mine, s_warp, total));
#pragma unroll
        for (int k = 0; k < PASS2_SLICES; ++k) {
            if (b0 + k < S && e[k].closed) {  // the slice closes the row it began in
#pragma unroll
                for (int v = 0; v < V; ++v) vec.out[v][part_row[b0 + k]] = run.v[v] + head[k][v];
            }
            run = seg_join(run, e[k]);
        }
        carry = seg_join(carry, total);
        __syncthreads();  // s_warp is written again by the next sweep
    }
}

// Pass 1's dynamic shared memory, allowed past 48 KB once.
template <int V>
static cudaError_t pass1_smem(size_t* bytes) {
    static bool set = false;
    *bytes = sizeof(float) * WARPS * warp_floats(V);
    if (set) return cudaSuccess;
    const cudaError_t rc = cudaFuncSetAttribute(
        segment_sum_pass1_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*bytes);
    set = rc == cudaSuccess;
    return rc;
}

template <int V>
static int blocks_of(int* out) {
    int dev = 0, sms = 0, per_sm = 0;
    size_t smem = 0;
    cudaError_t rc = pass1_smem<V>(&smem);
    if (rc == cudaSuccess) rc = cudaGetDevice(&dev);
    if (rc == cudaSuccess)
        rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc == cudaSuccess)
        rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, segment_sum_pass1_kernel<V>, THREADS, smem);
    *out = sms * (per_sm > 0 ? per_sm : 1);
    return (int)rc;
}

// The most blocks pass 1 runs at once for V values: the grid of a call whose path has
// at least that many blocks' tiles (the wrapper sizes the scratch from it).
extern "C" int segment_sum_blocks(int V, int* blocks) {
    switch (V) {
        case 1: return blocks_of<1>(blocks);
        case 2: return blocks_of<2>(blocks);
        case 3: return blocks_of<3>(blocks);
        case 4: return blocks_of<4>(blocks);
    }
    return (int)cudaErrorInvalidValue;
}

template <int V>
static void launch(const int64_t* offsets, int64_t n, int64_t nnz, const Vectors& vec,
                   int G, char* scratch, cudaStream_t st) {
    const int S = G * WARPS;  // slices: one a warp
    int64_t* part_row = reinterpret_cast<int64_t*>(scratch);
    float* part_head = reinterpret_cast<float*>(part_row + S);
    float* part_tail = part_head + (int64_t)V * S;
    int* part_closed = reinterpret_cast<int*>(part_tail + (int64_t)V * S);
    size_t smem = 0;
    if (pass1_smem<V>(&smem) != cudaSuccess) return;  // cudaGetLastError reports it
    segment_sum_pass1_kernel<V><<<G, THREADS, smem, st>>>(offsets, n, nnz, vec, part_row,
                                                          part_closed, part_head, part_tail);
    segment_sum_pass2_kernel<V><<<1, PASS2_THREADS, 0, st>>>(S, vec, part_row, part_closed,
                                                             part_head, part_tail);
}

// offsets: (n + 1,) int64, non-decreasing from 0 to nnz; in0..in3: (nnz,) fp32 (the
// first V used), out0..out3: (n,) fp32; G blocks, 1 ≤ G ≤ ceil((n + nnz) / (THREADS ·
// ITEMS)); scratch: G · THREADS / 32 · (12 + 8·V) bytes, 8-byte aligned.
extern "C" int segment_sum_f32(const int64_t* offsets, long long n, long long nnz, int V,
                               const float* in0, const float* in1, const float* in2,
                               const float* in3, float* out0, float* out1, float* out2,
                               float* out3, int G, void* scratch, void* stream) {
    if (n < 1 || nnz < 0 || V < 1 || V > 4 || G < 1 ||
        (long long)G > (n + nnz + THREADS * ITEMS - 1) / (THREADS * ITEMS))
        return (int)cudaErrorInvalidValue;
    const Vectors vec = {{in0, in1, in2, in3}, {out0, out1, out2, out3}};
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    char* s = static_cast<char*>(scratch);
    switch (V) {
        case 1: launch<1>(offsets, n, nnz, vec, G, s, st); break;
        case 2: launch<2>(offsets, n, nnz, vec, G, s, st); break;
        case 3: launch<3>(offsets, n, nnz, vec, G, s, st); break;
        case 4: launch<4>(offsets, n, nnz, vec, G, s, st); break;
    }
    return (int)cudaGetLastError();
}

extern "C" const char* segment_sum_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
