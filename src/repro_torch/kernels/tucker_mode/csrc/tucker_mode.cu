// Tucker's mode sweeps by column, hand-written for Hopper (sm_90a): each column f* of the
// context factor u (or v) takes one pass over the (user, hour) pairs and their
// interactions, then one small solve of the Newton steps of every row of that factor.
//
// Replaces no Pallas kernel. The JAX package's mode sweep is a loop of XLA ops a column
// (repro/core/models/tucker.py:_mode_sweep): D over the pairs, its (nnz, k3) gather, the
// products, four segment sums; the port ran the same as ≈ 45 PyTorch launches a column.
//
// The algebra (ref.py is the same in PyTorch). For column c of the side (u: rows are
// users, the partner is v by c2, B_c = b[c] is k2 × k3; v: rows are hours, the partner is
// u by c1, B_c = b[:, c] is k1 × k3), with pp the pair's partner row:
//   d_c(p) = pp·B_c (k3),  s_c(n) = ⟨d_c(pair(n)), w_item(n)⟩,
//   L'/2  = Σ_n ᾱ e s_c,   L''/2 = Σ_n ᾱ s_c²,
//   R'/2  = Σ_p ⟨pp·(B_c J), Φ(p)⟩,  R''/2 = Σ_p ⟨pp·(B_c J), d_c(p)⟩,
// each summed by the pair's group (its user, or its hour); then per group the η-damped
// Newton step δ[g] (denominator clamped at 1e-12, l2 on θ), θ += δ, and the step reaches
// Φ(p) += δ[g]·d_c(p) and e(n) += δ[g]·s_c(n) before the next column reads them.
//
// Launches a sweep of n columns: per column a pass and a solve, then one closing pass;
// 2n + 1, no host synchronisation between them. The pass of column c also applies the
// previous column's step: Φ from d_prev, recomputed from pp and the previous slice, and
// e from s_prev, which the previous pass stored (nnz floats, read and rewritten in place).
//
// What bounds a pass at the Tucker cell's shape (19.99 M interactions, 2.80 M pairs,
// k3 32): HBM carries the item id (int32), ᾱ, e read and written and s read and written,
// 24 B an interaction (≈ 0.48 GB), and per pair Φ read and written, the offsets, the
// group and partner ids (≈ 290 B a pair, ≈ 0.81 GB): ≈ 1.3 GB, ≈ 0.39 ms at 3.35 TB/s.
// The w rows come from L2 (w is 8.7 MB), 128 B an interaction, 2.56 GB a column.
//
// Design. Each warp owns CHUNK consecutive pairs of the group order (the pairs listed
// group by group: as they are for the users, an order by hour for the hours) and walks
// them 32 at a time. The warp stages the batch's 32 Φ rows in shared memory, a 16-byte
// copy instruction covering four whole rows (a row a lane would touch 32 rows an
// instruction). Then a lane a pair: the lane forms d_c, d_prev and pp·(B_c J) in chunks
// of 8 columns from its pp row (shared memory, its own) and the slices (shared memory,
// broadcast), patches its staged Φ row, sums its R parts in registers and stages d_c; the
// warp writes the patched rows back as it read them. Then the warp walks the 32 pairs'
// interactions in tiles of 32, a lane an interaction: its pair by a binary search of the
// pairs' ends (shuffles); the tile's w rows staged from L2 as the Φ rows were; s of the
// lane's row against its pair's d_c row, while the item, ᾱ, e and s_prev of the tile two
// ahead are loaded; the L parts are added by pair with a segmented scan over the lanes
// (pairs are contiguous in a tile) into per-pair sums in shared memory. Neither D
// (pairs × k3) nor its (nnz × k3) gather is ever written to device memory.
// The sums by group are a segmented scan over the 32 pairs' lanes (groups contiguous in
// the order) and a carry across the warp's batches: a group inside the warp's range is
// written whole, the warp's first and last groups as the warp's head and tail partials.
// The solve, a thread a group, adds a group's partials in warp order. No atomics in any
// sum: every sum is taken in an order fixed by the offsets, the group order and CHUNK,
// and two runs give the same bits.
//
// Interface: plain C functions bound with ctypes. tucker_mode_sweep_f32 launches on the
// caller's stream, allocates nothing and returns cudaGetLastError(); tucker_mode_chunk gives
// the pairs a warp takes.

#include <cuda_runtime.h>
#include <stdint.h>

#if !defined(TMODE_WIDTH)
#error "build through repro_torch/kernels/tucker_mode/kernel.py, which passes the width"
#endif

constexpr int W = TMODE_WIDTH;                         // k3 rounded up: 8, 16, 32, 64 or 128
constexpr int WARPS = W <= 32 ? 8 : (W == 64 ? 4 : 2);  // warps a block of the pass
constexpr int THREADS = 32 * WARPS;
constexpr int LD = W + 4;                               // row stride of a staged row
constexpr int CH = 8;                                   // columns a chunk of the pair products
constexpr int CHUNK = 32 * 8;                           // pairs a warp: 8 batches of 32
constexpr int SOLVE_THREADS = 256;
#define FULL_MASK 0xffffffffu

static_assert(W % CH == 0 && W <= 128, "the widths the wrapper builds");

struct Sweep {
    const float* w;                  // (n_items, k3)
    const float* b;                  // slice c, row o, column f at c·b_slice + o·b_row + f
    const float* j_i;                // (k3, k3)
    const float* partner;            // (n_partner, k_o)
    const int64_t* partner_of_pair;  // (pairs,)
    const int64_t* group_of_pair;    // (pairs,)
    const int* order;                // (pairs,) the group order, or null: the pairs' own
    const int64_t* gptr;             // (n_side + 1,) the groups' offsets in the order
    const int64_t* ptr;              // (pairs + 1,) the pairs' offsets in the log
    const int* item;                 // (nnz,)
    const float* alpha;              // (nnz,)
    float* phi;                      // (pairs, k3), in place
    float* e;                        // (nnz,), in place
    float* s;                        // (nnz,) this column's s, for the next pass
    float* side;                     // (n_side, k_side), in place
    float* delta;                    // (n_side,) the last solve's steps
    float4* head;                    // (warps,) a warp's first group's sums
    float4* tail;                    // (warps,) a warp's last group's sums
    float4* out;                     // (n_side,) sums of the groups inside one warp
    long long b_slice, b_row, pairs, nnz;
    int k3, k_o, n_side, k_side;
    float alpha0, l2, eta;
};

// Floats of a warp's shared memory: the staged d rows, the staged Φ or w rows, the pp
// rows, the per-pair L sums.
__host__ __device__ inline int pp_stride(int k_o) { return k_o | 1; }
__host__ __device__ inline int warp_floats(int k_o) { return 64 * LD + 32 * pp_stride(k_o) + 64; }
static size_t pass_smem(int k_o) {
    return sizeof(float) * ((size_t)3 * k_o * W + (size_t)WARPS * warp_floats(k_o));
}

__device__ __forceinline__ float4 f4add(float4 a, float4 b) {
    return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float4 shfl4(float4 v, int src) {
    return make_float4(__shfl_sync(FULL_MASK, v.x, src), __shfl_sync(FULL_MASK, v.y, src),
                       __shfl_sync(FULL_MASK, v.z, src), __shfl_sync(FULL_MASK, v.w, src));
}

// One interaction of a tile, held by its lane: its pair's lane j in the batch, its log
// index, the item, the residual, ᾱ, the previous column's s and step.
struct Entry {
    int64_t n;
    int j, item;
    float e, alpha, sp, dl;
};

// 32 rows copied between device memory (row r at off + its k3 values, off held by lane r)
// and a staged [32][LD] block by the whole warp, so that a 16-byte copy instruction covers
// four whole rows: LOAD fills the block (zeros past k3 and in rows r ≥ n_rows), else the
// block's rows r < n_rows are written back.
template <bool LOAD, typename G>
__device__ __forceinline__ void copy_rows(float* st, G* g, int64_t off, int n_rows, int k3,
                                          bool vec4, int lane) {
    if (vec4) {
#pragma unroll
        for (int q = 0; q < W / 4; ++q) {
            const int i = lane + 32 * q, r = i / (W / 4), c = 4 * (i % (W / 4));
            const int64_t o = __shfl_sync(FULL_MASK, off, r);
            float4* sp = reinterpret_cast<float4*>(st + r * LD + c);
            const bool in = r < n_rows && c < k3;
            if constexpr (LOAD)
                *sp = in ? *reinterpret_cast<const float4*>(g + o + c)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
            else if (in)
                *reinterpret_cast<float4*>(g + o + c) = *sp;
        }
    } else {
        for (int q = 0; q < W; ++q) {
            const int i = lane + 32 * q, r = i / W, f = i % W;
            const int64_t o = __shfl_sync(FULL_MASK, off, r);
            const bool in = r < n_rows && f < k3;
            if constexpr (LOAD)
                st[r * LD + f] = in ? g[o + f] : 0.f;
            else if (in)
                g[o + f] = st[r * LD + f];
        }
    }
}

// A group's sums, once no later pair of this warp can add to them: the warp's first group
// goes to its head, any other to the group's own slot.
__device__ __forceinline__ void finish_group(const Sweep& a, int64_t wid, int g, int gfirst,
                                             float4 v) {
    if (g == gfirst)
        a.head[wid] = v;
    else
        a.out[g] = v;
}

// One pass of column cur (CUR), applying the step of column prev first (PREV); with CUR
// false it is the closing patch after a sweep's last column. e_in is read where e is
// written: the caller's residuals in a sweep's first pass, e itself after.
template <bool CUR, bool PREV>
__global__ void __launch_bounds__(THREADS) tucker_mode_pass_kernel(const Sweep a,
                                                                   const float* e_in,
                                                                   int cur, int prev) {
    extern __shared__ __align__(16) float smem[];
    const int k3 = a.k3, k_o = a.k_o, kw = k_o * W, kos = pp_stride(k_o);
    float* s_bc = smem;               // [k_o][W] B_cur
    float* s_ec = smem + kw;          // [k_o][W] B_cur·J
    float* s_bp = smem + 2 * kw;      // [k_o][W] B_prev
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    float* s_d = smem + 3 * kw + warp * warp_floats(k_o);  // [32][LD] the batch's d rows
    float* s_w = s_d + 32 * LD;                             // [32][LD] Φ rows, then w rows
    float* s_pp = s_w + 32 * LD;                            // [32][kos] the pp rows
    float* s_acc = s_pp + 32 * kos;                         // [32][2] L'/2, L''/2 a pair

    for (int idx = threadIdx.x; idx < kw; idx += THREADS) {
        const int o = idx / W, f = idx % W;
        if (CUR) s_bc[idx] = f < k3 ? a.b[cur * a.b_slice + o * a.b_row + f] : 0.f;
        if (PREV) s_bp[idx] = f < k3 ? a.b[prev * a.b_slice + o * a.b_row + f] : 0.f;
    }
    __syncthreads();
    if (CUR) {
        for (int idx = threadIdx.x; idx < kw; idx += THREADS) {
            const int o = idx / W, f = idx % W;
            float v = 0.f;
            if (f < k3)
                for (int g = 0; g < k3; ++g)
                    v = fmaf(s_bc[o * W + g], __ldg(a.j_i + g * k3 + f), v);
            s_ec[idx] = v;
        }
        __syncthreads();
    }

    const int64_t wid = (int64_t)blockIdx.x * WARPS + warp;
    const int64_t b0 = wid * CHUNK;
    if (b0 >= a.pairs) return;
    const int64_t b1 = b0 + CHUNK < a.pairs ? b0 + CHUNK : a.pairs;
    // w and Φ rows in 16-byte loads where k3 keeps them on 16 bytes
    const bool w4 = (k3 & 3) == 0 && (reinterpret_cast<uintptr_t>(a.w) & 15) == 0;
    const bool phi4 = (k3 & 3) == 0 && (reinterpret_cast<uintptr_t>(a.phi) & 15) == 0;

    int gfirst = -1, ckey = -1;  // the warp's first group; the group the carry holds
    float4 carry = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int64_t q0 = b0; q0 < b1; q0 += 32) {
        const int nb = (int)(b1 - q0 < 32 ? b1 - q0 : 32);
        const bool valid = lane < nb;
        int64_t p = 0, lo = 0;
        int sz = 0, grp = -2 - lane;  // a lane past the batch: a group no pair has
        float dl = 0.f, rp = 0.f, rpp = 0.f;
        if (valid) p = a.order ? (int64_t)a.order[q0 + lane] : q0 + lane;
        copy_rows<true>(s_w, a.phi, p * k3, nb, k3, phi4, lane);  // the batch's Φ rows
        if (valid) {
            lo = a.ptr[p];
            sz = (int)(a.ptr[p + 1] - lo);
            grp = (int)a.group_of_pair[p];
            const float* pr = a.partner + a.partner_of_pair[p] * k_o;
            for (int o = 0; o < k_o; ++o) s_pp[lane * kos + o] = __ldg(pr + o);
            if (PREV) dl = a.delta[grp];
        }
        __syncwarp();
        if (valid) {
            float* st = s_w + lane * LD;
            float* sd = s_d + lane * LD;

            // the pair products, a lane a pair: d_cur, d_prev and pp·(B_cur J) in chunks of CH
            for (int c0 = 0; c0 < W; c0 += CH) {
                float d[CH], dp[CH], dj[CH];
#pragma unroll
                for (int i = 0; i < CH; ++i) d[i] = dp[i] = dj[i] = 0.f;
                for (int o = 0; o < k_o; ++o) {
                    const float x = s_pp[lane * kos + o];
#pragma unroll
                    for (int h = 0; h < CH / 4; ++h) {
                        const int at = o * W + c0 + 4 * h;
                        if (CUR) {
                            const float4 bc = *reinterpret_cast<const float4*>(s_bc + at);
                            const float4 ec = *reinterpret_cast<const float4*>(s_ec + at);
                            d[4 * h] = fmaf(x, bc.x, d[4 * h]);
                            d[4 * h + 1] = fmaf(x, bc.y, d[4 * h + 1]);
                            d[4 * h + 2] = fmaf(x, bc.z, d[4 * h + 2]);
                            d[4 * h + 3] = fmaf(x, bc.w, d[4 * h + 3]);
                            dj[4 * h] = fmaf(x, ec.x, dj[4 * h]);
                            dj[4 * h + 1] = fmaf(x, ec.y, dj[4 * h + 1]);
                            dj[4 * h + 2] = fmaf(x, ec.z, dj[4 * h + 2]);
                            dj[4 * h + 3] = fmaf(x, ec.w, dj[4 * h + 3]);
                        }
                        if (PREV) {
                            const float4 bp = *reinterpret_cast<const float4*>(s_bp + at);
                            dp[4 * h] = fmaf(x, bp.x, dp[4 * h]);
                            dp[4 * h + 1] = fmaf(x, bp.y, dp[4 * h + 1]);
                            dp[4 * h + 2] = fmaf(x, bp.z, dp[4 * h + 2]);
                            dp[4 * h + 3] = fmaf(x, bp.w, dp[4 * h + 3]);
                        }
                    }
                }
                float v[CH];
#pragma unroll
                for (int h = 0; h < CH / 4; ++h) {
                    const float4 x = *reinterpret_cast<const float4*>(st + c0 + 4 * h);
                    v[4 * h] = x.x, v[4 * h + 1] = x.y, v[4 * h + 2] = x.z, v[4 * h + 3] = x.w;
                }
                if (PREV) {  // the previous column's step reaches Φ
#pragma unroll
                    for (int i = 0; i < CH; ++i) v[i] = fmaf(dl, dp[i], v[i]);
#pragma unroll
                    for (int h = 0; h < CH / 4; ++h)
                        *reinterpret_cast<float4*>(st + c0 + 4 * h) =
                            make_float4(v[4 * h], v[4 * h + 1], v[4 * h + 2], v[4 * h + 3]);
                }
                if (CUR) {
#pragma unroll
                    for (int i = 0; i < CH; ++i) {
                        rp = fmaf(dj[i], v[i], rp);
                        rpp = fmaf(dj[i], d[i], rpp);
                    }
#pragma unroll
                    for (int h = 0; h < CH / 4; ++h)
                        *reinterpret_cast<float4*>(sd + c0 + 4 * h) =
                            make_float4(d[4 * h], d[4 * h + 1], d[4 * h + 2], d[4 * h + 3]);
                }
            }
        }
        __syncwarp();
        if (PREV) copy_rows<false>(s_w, a.phi, p * k3, nb, k3, phi4, lane);  // the patched Φ
        if (q0 == b0) gfirst = __shfl_sync(FULL_MASK, grp, 0);
        if (CUR) s_acc[2 * lane] = s_acc[2 * lane + 1] = 0.f;

        // the pairs' interactions in tiles of 32, a lane an interaction
        int cend = sz;  // the batch's interactions up to this lane's pair's end
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int t = __shfl_up_sync(FULL_MASK, cend, o);
            if (lane >= o) cend += t;
        }
        const int total = __shfl_sync(FULL_MASK, cend, 31);
        const long long base = lo - (cend - sz);  // log index of batch position 0 of this pair
        __syncwarp();
        // a tile's entries: each lane's position, its pair's lane j (the first whose end
        // passes it, by a binary search over the lanes), its log index and loads; the next
        // tile's are loaded while this one is summed
        auto fetch = [&](int t0) {
            Entry x = {0, 0, 0, 0.f, 0.f, 0.f, 0.f};
            const int pos = t0 + lane;
#pragma unroll
            for (int step = 16; step > 0; step >>= 1) {
                const int c = __shfl_sync(FULL_MASK, cend, x.j + step - 1);
                if (c <= pos) x.j += step;
            }
            x.n = __shfl_sync(FULL_MASK, base, x.j) + pos;
            if (PREV) x.dl = __shfl_sync(FULL_MASK, dl, x.j);
            if (pos < total) {
                x.e = e_in[x.n];
                if (CUR) {
                    x.item = a.item[x.n];
                    x.alpha = a.alpha[x.n];
                }
                if (PREV) x.sp = a.s[x.n];
            }
            return x;
        };
        Entry cur = {0, 0, 0, 0.f, 0.f, 0.f, 0.f}, nxt = cur;
        if (total > 0) cur = fetch(0);
        if (total > 32) nxt = fetch(32);
        for (int t0 = 0; t0 < total; t0 += 32) {
            Entry after = {0, 0, 0, 0.f, 0.f, 0.f, 0.f};
            if (t0 + 64 < total) after = fetch(t0 + 64);
            const bool live = t0 + lane < total;
            const int j = cur.j;
            float va = 0.f, vb = 0.f;
            if (CUR) {  // the tile's w rows, four a copy instruction
                copy_rows<true>(s_w, a.w, (int64_t)cur.item * k3, total - t0, k3, w4, lane);
                __syncwarp();
            }
            if (live) {
                float ev = cur.e;
                if (PREV) ev = fmaf(cur.dl, cur.sp, ev);  // the previous column's step reaches e
                a.e[cur.n] = ev;
                if (CUR) {  // s against the staged rows, zero past k3
                    const float* wr = s_w + lane * LD;
                    const float* dr = s_d + j * LD;
                    float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
                    for (int q = 0; q < W / 4; ++q) {
                        const float4 wv = *reinterpret_cast<const float4*>(wr + 4 * q);
                        const float4 dv = *reinterpret_cast<const float4*>(dr + 4 * q);
                        s0 = fmaf(dv.x, wv.x, s0);
                        s1 = fmaf(dv.y, wv.y, s1);
                        s2 = fmaf(dv.z, wv.z, s2);
                        s3 = fmaf(dv.w, wv.w, s3);
                    }
                    const float s = (s0 + s1) + (s2 + s3);
                    a.s[cur.n] = s;
                    va = cur.alpha * ev * s;
                    vb = cur.alpha * s * s;
                }
            }
            if (CUR) {  // sums by pair: a segmented scan over the lanes, the pairs in order
                const int key = live ? j : 32 + lane;
#pragma unroll
                for (int o = 1; o < 32; o <<= 1) {
                    const float ta = __shfl_up_sync(FULL_MASK, va, o);
                    const float tb = __shfl_up_sync(FULL_MASK, vb, o);
                    const int tk = __shfl_up_sync(FULL_MASK, key, o);
                    if (lane >= o && tk == key) {
                        va += ta;
                        vb += tb;
                    }
                }
                const int knext = __shfl_down_sync(FULL_MASK, key, 1);
                if (live && (lane == 31 || knext != key)) {
                    s_acc[2 * j] += va;
                    s_acc[2 * j + 1] += vb;
                }
                __syncwarp();
            }
            cur = nxt;
            nxt = after;
        }
        if (!CUR) continue;

        // sums by group: a segmented scan over the batch's pairs, then the carry
        __syncwarp();
        float4 v = valid ? make_float4(s_acc[2 * lane], s_acc[2 * lane + 1], rp, rpp)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const float4 t = make_float4(__shfl_up_sync(FULL_MASK, v.x, o),
                                         __shfl_up_sync(FULL_MASK, v.y, o),
                                         __shfl_up_sync(FULL_MASK, v.z, o),
                                         __shfl_up_sync(FULL_MASK, v.w, o));
            const int tk = __shfl_up_sync(FULL_MASK, grp, o);
            if (lane >= o && tk == grp) v = f4add(v, t);
        }
        const int key0 = __shfl_sync(FULL_MASK, grp, 0);
        if (ckey >= 0 && key0 != ckey) {  // the carried group ended at the last batch's end
            if (lane == 0) finish_group(a, wid, ckey, gfirst, carry);
            ckey = -1;
        }
        const int knext = __shfl_down_sync(FULL_MASK, grp, 1);
        const bool last = lane == nb - 1;
        const bool tail = valid && (last || knext != grp);
        if (tail && grp == ckey) v = f4add(carry, v);  // only the batch's first group
        if (tail && !last) finish_group(a, wid, grp, gfirst, v);
        carry = shfl4(v, nb - 1);
        ckey = __shfl_sync(FULL_MASK, grp, nb - 1);
        __syncwarp();
    }
    if (CUR && lane == 0) {
        if (ckey == gfirst)
            a.head[wid] = carry;
        else
            a.tail[wid] = carry;
    }
}

// The steps of column cur, a thread a group: the group's sums from its warps' partials in
// warp order, the Newton step, θ += δ.
__global__ void __launch_bounds__(SOLVE_THREADS) tucker_mode_solve_kernel(const Sweep a, int cur) {
    const int g = blockIdx.x * SOLVE_THREADS + threadIdx.x;
    if (g >= a.n_side) return;
    const int64_t gb = a.gptr[g], ge = a.gptr[g + 1];
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (ge > gb) {
        const int64_t wf = gb / CHUNK, wl = (ge - 1) / CHUNK;
        const bool first = gb == wf * CHUNK;  // the group is warp wf's first
        if (wf == wl) {
            const int64_t end = (wf + 1) * CHUNK < a.pairs ? (wf + 1) * CHUNK : a.pairs;
            v = first ? a.head[wf] : (ge == end ? a.tail[wf] : a.out[g]);
        } else {
            v = first ? a.head[wf] : a.tail[wf];
            for (int64_t w = wf + 1; w <= wl; ++w) v = f4add(v, a.head[w]);
        }
    }
    float* th = a.side + (int64_t)g * a.k_side + cur;
    const float theta = *th;
    const float grad = v.x + a.alpha0 * v.z, hess = v.y + a.alpha0 * v.w;
    const float num = grad + a.l2 * theta, den = hess + a.l2;
    const float d = -a.eta * num / fmaxf(den, 1e-12f);
    a.delta[g] = d;
    *th = theta + d;
}

template <bool CUR, bool PREV>
static cudaError_t launch_pass(const Sweep& a, const float* e_in, int cur, int prev, int blocks,
                               size_t smem, cudaStream_t st) {
    static size_t set = 0;
    if (smem > set) {
        const cudaError_t rc = cudaFuncSetAttribute(
            tucker_mode_pass_kernel<CUR, PREV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (rc != cudaSuccess) return rc;
        set = smem;
    }
    tucker_mode_pass_kernel<CUR, PREV><<<blocks, THREADS, smem, st>>>(a, e_in, cur, prev);
    return cudaSuccess;
}

// The pairs a warp of the pass takes: the wrapper sizes the warps' partials by it.
extern "C" int tucker_mode_chunk() { return CHUNK; }

// The sweep of columns[0..n_columns) of side (n_side, k_side), in that order, then the
// closing patch. b at c·b_slice + o·b_row + f: the slice of column c; partner (·, k_o);
// phi (pairs, k3), e (nnz,) and side moved in place (e read from e_in in the first pass);
// s (nnz,) scratch; delta (n_side,), head and tail (one a warp), out (n_side,) scratch.
extern "C" int tucker_mode_sweep_f32(const float* w, int k3, const float* b, long long b_slice,
                                     long long b_row, int k_o, const float* j_i,
                                     const float* partner, const int64_t* partner_of_pair,
                                     const int64_t* group_of_pair, const int* order,
                                     const int64_t* gptr, int n_side, float* phi,
                                     long long pairs, const int64_t* ptr, const int* item,
                                     const float* alpha, const float* e_in, float* e, float* s,
                                     long long nnz, float* side, int k_side,
                                     const int* columns, int n_columns, float* delta,
                                     float* head, float* tail, float* out, float alpha0,
                                     float l2, float eta, void* stream) {
    if (k3 < 1 || k3 > W || k_o < 1 || n_side < 0 || k_side < 1 || pairs < 0 || nnz < 0 ||
        n_columns < 0)
        return (int)cudaErrorInvalidValue;
    for (int i = 0; i < n_columns; ++i)
        if (columns[i] < 0 || columns[i] >= k_side) return (int)cudaErrorInvalidValue;
    Sweep a;
    a.w = w, a.b = b, a.j_i = j_i, a.partner = partner, a.partner_of_pair = partner_of_pair;
    a.group_of_pair = group_of_pair, a.order = order, a.gptr = gptr, a.ptr = ptr;
    a.item = item, a.alpha = alpha, a.phi = phi, a.e = e, a.s = s, a.side = side;
    a.delta = delta, a.head = reinterpret_cast<float4*>(head);
    a.tail = reinterpret_cast<float4*>(tail), a.out = reinterpret_cast<float4*>(out);
    a.b_slice = b_slice, a.b_row = b_row, a.pairs = pairs, a.nnz = nnz;
    a.k3 = k3, a.k_o = k_o, a.n_side = n_side, a.k_side = k_side;
    a.alpha0 = alpha0, a.l2 = l2, a.eta = eta;
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    const size_t smem = pass_smem(k_o);
    const long long warps = (pairs + CHUNK - 1) / CHUNK;
    const int blocks = (int)((warps + WARPS - 1) / WARPS);
    const int solve_blocks = (n_side + SOLVE_THREADS - 1) / SOLVE_THREADS;
    cudaError_t rc = cudaSuccess;
    for (int i = 0; i < n_columns && rc == cudaSuccess; ++i) {
        if (blocks > 0)
            rc = i == 0
                     ? launch_pass<true, false>(a, e_in, columns[i], -1, blocks, smem, st)
                     : launch_pass<true, true>(a, e, columns[i], columns[i - 1], blocks, smem, st);
        if (rc == cudaSuccess && solve_blocks > 0)
            tucker_mode_solve_kernel<<<solve_blocks, SOLVE_THREADS, 0, st>>>(a, columns[i]);
    }
    if (rc == cudaSuccess && n_columns > 0 && blocks > 0)
        rc = launch_pass<false, true>(a, e, -1, columns[n_columns - 1], blocks, smem, st);
    if (rc != cudaSuccess) return (int)rc;
    return (int)cudaGetLastError();
}

extern "C" const char* tucker_mode_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
