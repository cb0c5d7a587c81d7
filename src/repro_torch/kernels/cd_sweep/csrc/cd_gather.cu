// The gather forms of the block sweep, the slab reduce and the residual
// patch, redesigned for Hopper (sm_90a): each slot's ψ gathered once a pass,
// the row held in registers or split over the card; and the same forms of
// the pre-gathered row-patch sweep and slab reduce, reading ψ from the tile.
//
// Replaces: repro/kernels/cd_sweep/kernel.py, cd_block_sweep_gather_pallas
// (body _sweep_gather_kernel), cd_block_sweep_rowpatch_gather_pallas (body
// _sweep_rowpatch_gather_kernel), cd_block_sweep_rowpatch_pallas (body
// _sweep_rowpatch_kernel) at k_b ≤ 8, cd_slab_reduce_gather_pallas (body
// _slab_reduce_gather_kernel) and cd_slab_reduce_pallas (body
// _slab_reduce_kernel) at m ≤ 9, and cd_resid_patch_gather_pallas (body
// _resid_patch_gather_kernel) at m ≤ 8. The functions are those of
// csrc/cd_sweep.cu's cd_sweep_kernel and cd_sweep_block_row_kernel, and
// csrc/cd_slab.cu's cd_slab_reduce_kernel and cd_resid_patch_kernel, which
// keep the rows and widths these forms do not take (kernels/vmem.py:
// cd_sweep_form, cd_slab_reduce_form, cd_resid_patch_form). Gathered, ψ_j[r,
// d] = tab[ids[r, d], j] of the (n_src, ld_tab) ψ slab, the id clipped to
// [0, n_src) as jnp.take(mode="clip") does; pre-gathered (TILE), ψ_j[r, d] =
// psi_blk[(r·k_b + j)·D + d] of the (C, k_b, D) tile, D contiguous, so a
// column's loads are coalesced across the lanes that own consecutive slots.
//
// What bounds them on an H100: the bytes. The sweep must read ids, α and e
// and write e (16 B a slot), read W, R' (and the row patch P) and write W,
// and read the ψ slab once; the slab reduce reads ids, α and e (12 B a slot)
// and the slab once and writes Q and P; the residual patch reads ids and e
// and writes e (12 B a slot) and reads the slab and Δφ once. What held the
// forms they replace far above that bound was latency, issue and idle SMs:
//   * the warp-row sweep re-gathered ψ_j from a slot's 32-byte slab row on
//     each of its k_b steps, a dependent 4-byte load inside a serial chain
//     (shared id read, gather, FMAs, butterfly, division, e patch through
//     shared memory), and staged 16 B a slot in shared memory, which held a
//     1,024-slot row to 10 warps an SM;
//   * the block-row sweep gave one 1,024-thread block to each long row (24
//     hour-of-day rows of 142,464 slots: 24 of 132 SMs busy) and made two
//     passes over the row on each of its k_b steps, re-gathering ψ_j from a
//     slab (109 MB) that does not fit the 50 MB L2, 16 times a launch;
//   * the slab reduce gathered a slot's columns as guarded scalar loads, kept
//     a run-time tile loop's 8 × 8 accumulators and operands live across a
//     branch (118–143 registers, one 256-thread block an SM), and reduced
//     each of its 44 sums by a full butterfly (220 shuffles a row); at FM's
//     m = 9 it made three passes over each row, (0, 0), (0, 1) and (1, 1),
//     two of them for one live column, each re-reading ids and α (and e)
//     and re-gathering ψ: 32 B a slot against 12;
//   * the residual patch gave a thread one slot: m guarded scalar loads of
//     the row's Δφ and m scalar gathers, one slot in flight a thread.
// The pre-gathered row-patch sweep had the first two faults with the tile in
// place of the slab: a 4-byte tile load at the head of each step's chain in
// the warp-row form, and 2·k_b passes of 24 B a slot over 24 rows on 24 SMs
// in the block-row form (657 MB a launch, the 109 MB tile past the L2).
//
// Sweep, register-row form (rows of up to CDG_THREADS · 8 slots). A group of
// LANES threads owns one row, a thread SLOTS fixed slots, d = (t mod W) +
// W·(⌊t/W⌋·SLOTS + s) for W = min(LANES, 32), so every load is coalesced.
// Before the first step a thread loads its slots' ids, α and e and starts
// their ψ gathers, so every gather of the launch is in flight at once. Up to
// CDG_SWEEP_REG_SLOTS slots a thread it gathers a slot's k_b ψ values once,
// with two 16-byte loads of the 32-byte slab row where the slab allows (else
// scalar loads), and holds them in registers; with more slots (long rows),
// where those registers would spill, it keeps each slot's row pointer and
// reads ψ_j a step ahead, so the row's sector comes from L2 once and from L1
// after (chip_smoke.py --sweep-tune measured both). From the tile (TILE, row
// patch only) it reads a slot's k_b values the same two ways, column j of
// its row block at a stride of D, each column coalesced across the group's
// lanes; ids, the slab and the clip are not used. The k_b steps then run
// on registers: two group sums a step (xor levels over the row's lanes in a
// warp, shared by the two sums; for a row of several warps, the per-warp
// partials summed in warp order by every thread, through a double-buffered
// shared array, one barrier a step), Δ, the e patch, W, and R'_j, built on
// step j from the earlier steps' Δ and the coupling block (R' is no output,
// so only its j-th entry is needed then), all kept by every thread of the
// group (its sums are the same bits in every thread). The coupling block is
// the shared J, staged once a block, or (ROWPATCH) each row's own patch P,
// staged once a group (k_b² floats a row of shared memory). A k_b of 8 is a
// compile-time constant. e and W are written once, at the end. At LANES = 32
// a thread sums its slots in the order of the warp-row form, which it
// therefore matches bit for bit, in both couplings and both ψ sources.
//
// Sweep, split-row form (rows too long for one block). For one row, with e
// as it stands before the launch, let Q_j = Σ_d α·e·ψ_j and G_ij = Σ_d
// α·ψ_i·ψ_j. The k_b Gauss–Seidel steps are then exactly
//   L'_j/2  = Q_j + Σ_{i<j} Δ_i·G_ij        L''_j/2 = G_jj
//   R'_j    = R'_j + Σ_{i<j} Δ_i·P(i, j)
//   Δ_j     = −η·(L'_j/2 + α₀R'_j + λw_j) / max(L''_j/2 + α₀P(j, j) + λ, 1e-12)
// and then, once, e += Σ_j Δ_j·ψ_j. Three launches on the caller's stream:
// pass 1 cuts each row into chunks of `chunk` slots, one block a (row,
// chunk), numbered row-major in one grid dimension (any number of rows), so
// a few long rows fill every SM; a thread gathers each slot's k_b ψ values
// once (or reads them from the tile) and adds the 44 sums (Q and G's upper
// triangle) in registers, as the one-tile slab reduce does, then the block
// reduces them in a fixed order (a transpose-reduce in each warp, the warps'
// partials summed in warp order) into a (C, n_chunks, 44) scratch; the solve
// sums a row's chunk partials in chunk order and runs the k_b-step
// recurrence above on one thread a row (P read with its strides; cs0 = 0 is
// one J for every row), writing W and Δ; pass 2 is the residual patch below
// with Δφ = Δ. Each pass moves 12 B and one slab row a slot (pre-gathered,
// 8 + 4·k_b B): two passes in all, not 2·k_b. The sums are taken in another
// order than the block-row form's, so the bits differ from it; every run
// gives the same bits.
//
// Slab reduce, one-tile form (m ≤ CDG_KB_WIDE). One instance a column count
// KB: KB = CDG_KB (8) takes m ≤ 8, KB = CDG_KB_WIDE (9) takes FM's m = k_b +
// 1 = 9. A group of LANES ≤ 32 threads owns one row and streams its slots
// (d ≡ t mod LANES), CDG_SLAB_INFLIGHT at a time (the wide instance
// CDG_SLAB_WIDE_INFLIGHT), gathered with 16-byte loads where the slab
// allows (KB = 8 only: FM's 9-column slab takes scalar loads) while the
// next chunk's ids, α and e are already in flight. A thread keeps Q (KB sums) and P's upper
// triangle (KB(KB+1)/2) as named registers, 44 at KB = 8 and 54 at KB = 9:
// no tile loop, no branch in the slot loop, each slot's α, e, id and ψ row
// read once. The sums are then reduced across the group by a
// transpose-reduce: at each xor level a lane keeps one half of its values
// and sends the other half to its partner, which keeps that half, so the
// levels cost 22 + 11 + 6 + 3 + 2 shuffles at 32 lanes and KB = 8 (27 + 14
// + 7 + 4 + 2 at KB = 9) against one butterfly a sum, and each lane ends
// with the final sums it writes, its (a, b) decoded without a loop. Each
// final sum is one fixed tree over the lanes — at 32 lanes the
// butterfly's, so the form matches the tiled one bit for bit — and every
// run gives the same bits. P is written symmetric from the one sum of each
// pair. The 54 sums of KB = 9 and its ψ values in flight do not fit the 80
// registers a thread has at three 256-thread blocks an SM (two slots in
// flight spilled 144 bytes); its __launch_bounds__ asks for
// CDG_SLAB_WIDE_MIN_BLOCKS = 2 (128 registers), which holds four slots in
// flight without a spill: the fastest of chip_smoke.py --slab-tune's
// variants at FM's gather shapes (PERF.md).
//
// Residual patch, register-slot form (m ≤ 8). A thread takes CDG_PATCH_SLOTS
// consecutive slots of one row (16-byte loads of ids and e where D_pad is a
// multiple of 4 and both grids start 16-byte aligned, else scalar loads),
// holds the row's Δφ in registers, issues every slot's ψ gather (two
// 16-byte loads where the slab allows) before its first FMA, and sums e +
// Σ_j Δφ_j·ψ_j in ascending j, as cd_resid_patch_kernel does: the same bits.
// From the tile (TILE: the split-row form's pass 2 pre-gathered) a thread
// reads its slots of each of the m tile rows, 16 bytes at a time where e and
// the tile allow.
//
// Interface: plain C functions bound with ctypes. They launch on the
// caller's stream, allocate nothing and return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef CDG_THREADS
#define CDG_THREADS 256           // threads of a block, both kernels
#endif
#ifndef CDG_SWEEP_MIN_BLOCKS
#define CDG_SWEEP_MIN_BLOCKS 3    // __launch_bounds__: blocks an SM
#endif
#ifndef CDG_SWEEP_REG_SLOTS
#define CDG_SWEEP_REG_SLOTS 4     // ψ in registers up to this many slots a thread
#endif
#ifndef CDG_SLAB_MIN_BLOCKS
#define CDG_SLAB_MIN_BLOCKS 3
#endif
#ifndef CDG_SLAB_INFLIGHT
#define CDG_SLAB_INFLIGHT 2       // slots a thread gathers at once
#endif
#ifndef CDG_PATCH_SLOTS
#define CDG_PATCH_SLOTS 4         // residual patch: slots a thread, a multiple of 4
#endif
// The slab reduce's KB = 9 instance: blocks an SM and slots a thread gathers
// at once, passed only by kernels/vmem.py (kernel.GATHER_DEFINES).
#if !defined(CDG_SLAB_WIDE_MIN_BLOCKS) || !defined(CDG_SLAB_WIDE_INFLIGHT)
#error "build with -DCDG_SLAB_WIDE_MIN_BLOCKS and -DCDG_SLAB_WIDE_INFLIGHT (kernel.GATHER_DEFINES)"
#endif

#define CDG_KB 8                                      // columns in registers
#define CDG_KB_WIDE 9                                 // the slab reduce's wide instance
#define CDG_NSUM (CDG_KB + CDG_KB * (CDG_KB + 1) / 2)  // Q and P's triangle: 44
#define FULL_MASK 0xffffffffu
static_assert(CDG_PATCH_SLOTS % 4 == 0, "the patch loads slots four at a time");

// Sums a thread of the slab reduce keeps at KB columns: Q and P's upper
// triangle (44 at KB = 8, 54 at KB = 9).
template <int KB>
struct Sums {
    static constexpr int n = KB + KB * (KB + 1) / 2;
};
static_assert(Sums<CDG_KB>::n == CDG_NSUM, "the split-row scratch holds 44 sums a chunk");

// Slab row ``id``'s first kb ≤ KB columns into x, zeros beyond. vec (KB =
// 8 only): every slab row starts 16-byte aligned and kb is 4 or 8.
template <int KB>
__device__ __forceinline__ void gather_cols(float (&x)[KB], const float* __restrict__ tab,
                                            long long ld_tab, int id, int kb, bool vec) {
    const float* r = tab + (long long)id * ld_tab;
    if constexpr (KB == CDG_KB) {
        if (vec) {
            const float4 lo = __ldg(reinterpret_cast<const float4*>(r));
            const float4 hi = kb == 8 ? __ldg(reinterpret_cast<const float4*>(r) + 1)
                                      : make_float4(0.f, 0.f, 0.f, 0.f);
            x[0] = lo.x; x[1] = lo.y; x[2] = lo.z; x[3] = lo.w;
            x[4] = hi.x; x[5] = hi.y; x[6] = hi.z; x[7] = hi.w;
            return;
        }
    }
#pragma unroll
    for (int c = 0; c < KB; ++c) x[c] = c < kb ? __ldg(r + c) : 0.f;
}

__device__ __forceinline__ int clip_id(int id, int n_src) {
    return min(max(id, 0), n_src - 1);
}

// The two sums of a step over a row's W ≤ 32 lanes of one warp, the same
// bits in every lane: the first xor level leaves L' in the lanes with bit
// W/2 clear and L'' in the others, the remaining levels reduce one value,
// and a last shuffle hands each lane the other sum — the trees of two xor
// butterflies, with log2(W) + 1 shuffles where they take 2·log2(W).
template <int W>
__device__ __forceinline__ void row_sums(float& lp, float& lpp, int lane) {
    const bool hi = (lane & (W / 2)) != 0;
    float v = (hi ? lpp : lp) + __shfl_xor_sync(FULL_MASK, hi ? lp : lpp, W / 2);
#pragma unroll
    for (int o = W / 4; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
    const float other = __shfl_xor_sync(FULL_MASK, v, W / 2);
    lp = hi ? other : v;
    lpp = hi ? v : other;
}

// KB: k_b fixed at compile time (8, the fused epochs' block), or 0 for any
// k_b ≤ CDG_KB given at run time. ROWPATCH: each row's own coupling block P
// (element (r, i, f) at r·cs0 + i·cs1 + f·cs2), else one J (cs0 = 0). TILE:
// ψ from the pre-gathered tile (tab, ids unused), else gathered.
template <int LANES, int SLOTS, int KB, bool ROWPATCH, bool TILE>
__global__ void __launch_bounds__(CDG_THREADS, CDG_SWEEP_MIN_BLOCKS)
cd_sweep_gather_reg_kernel(const float* __restrict__ psi_blk,  // (C, kb, D)
                           const float* __restrict__ tab, long long ld_tab, int n_src, int vec,
                           const int* __restrict__ ids,      // (C, D)
                           const float* __restrict__ alpha,  // (C, D)
                           float* __restrict__ e,            // (C, D), in place
                           const float* __restrict__ w_in, long long ld_w,
                           const float* __restrict__ r1_in, long long ld_r1,
                           const float* __restrict__ cpl, long long cs0, long long cs1,
                           long long cs2,
                           float* __restrict__ w_out,        // (C, kb)
                           int C, int D, int kb_run, float alpha0, float l2, float eta) {
    const int kb = KB ? KB : kb_run;
    constexpr bool PSI_REG = SLOTS <= CDG_SWEEP_REG_SLOTS;
    constexpr int W = LANES < 32 ? LANES : 32;  // a row's lanes in one warp
    constexpr int WARPS_ROW = LANES / W;
    constexpr int ROWS = CDG_THREADS / LANES;
    constexpr int NCPL = ROWPATCH ? ROWS : 1;   // coupling blocks a block stages
    static_assert(CDG_THREADS % LANES == 0 && LANES % W == 0, "whole rows a block");
    __shared__ float J[NCPL][CDG_KB * CDG_KB];
    __shared__ float red[2][2][CDG_THREADS / 32];  // [step parity][L', L''][warp]

    const int tid = threadIdx.x;
    for (int i = tid; i < NCPL * kb * kb; i += CDG_THREADS) {
        const int r = i / (kb * kb), a = i % (kb * kb) / kb, f = i % kb;
        const long long src = min((long long)blockIdx.x * ROWS + r, (long long)C - 1);
        J[r][a * CDG_KB + f] = cpl[src * cs0 + (long long)a * cs1 + (long long)f * cs2];
    }
    __syncthreads();
    const float* Jr = J[ROWPATCH ? tid / LANES : 0];  // this row's coupling block

    const int t = tid % LANES;
    const long long row = (long long)blockIdx.x * ROWS + tid / LANES;
    const bool live = row < C;
    const long long rr = live ? row : C - 1;  // a row past C reads the last one, writes nothing
    const size_t g = (size_t)rr * D;
    const int d0 = t % W + W * (t / W) * SLOTS;

    // R' is needed only at R'_j on step j: R'_j + Σ_{i<j} Δ_i·J(i, j), summed
    // in the order of the warp-row form's patch R' += Δ_i·J(i, ·) (J: this
    // row's coupling block)
    float r1[CDG_KB], wv[CDG_KB], dl[CDG_KB];
#pragma unroll
    for (int f = 0; f < CDG_KB; ++f) {
        r1[f] = f < kb ? r1_in[rr * ld_r1 + f] : 0.f;
        wv[f] = f < kb ? w_in[rr * ld_w + f] : 0.f;
    }
    float ev[SLOTS], av[SLOTS];
    float pv[PSI_REG ? SLOTS : 1][CDG_KB];      // ψ held in registers, or
    const float* pr[PSI_REG ? 1 : SLOTS];       // each slot's slab row (tile: its
    float pn[PSI_REG ? 1 : SLOTS];              // ψ_0), and the next step's ψ
    const float* tr = TILE ? psi_blk + g * kb : nullptr;  // the row's (kb, D) block
    const size_t col = TILE ? (size_t)D : 1;    // from ψ_j to ψ_{j+1}
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
        const int d = d0 + W * s;
        const bool in = d < D;
        av[s] = in ? alpha[g + d] : 0.f;
        ev[s] = in ? e[g + d] : 0.f;
        if constexpr (TILE) {
            // a slot past the row reads zeros, as the gather form reads the
            // slab's row 0 with α = e = 0
            if constexpr (PSI_REG) {
#pragma unroll
                for (int c = 0; c < CDG_KB; ++c)
                    pv[s][c] = in && c < kb ? __ldg(tr + c * col + d) : 0.f;
            } else {
                pr[s] = tr + (in ? d : 0);
                pn[s] = in ? __ldg(pr[s]) : 0.f;
            }
        } else {
            const int id = in ? clip_id(ids[g + d], n_src) : 0;
            if constexpr (PSI_REG) {
                gather_cols(pv[s], tab, ld_tab, id, kb, vec);
            } else {
                pr[s] = tab + (long long)id * ld_tab;
                pn[s] = __ldg(pr[s]);
            }
        }
    }

#pragma unroll
    for (int j = 0; j < CDG_KB; ++j) {
        if (j >= kb) break;
        float pj[SLOTS];
#pragma unroll
        for (int s = 0; s < SLOTS; ++s) {
            if constexpr (PSI_REG) {
                pj[s] = pv[s][j];
            } else {
                pj[s] = pn[s];
                if (j + 1 < kb)
                    pn[s] = !TILE || d0 + W * s < D ? __ldg(pr[s] + (j + 1) * col) : 0.f;
            }
        }
        float lp = 0.f, lpp = 0.f;
#pragma unroll
        for (int s = 0; s < SLOTS; ++s) {
            lp += av[s] * ev[s] * pj[s];
            lpp += av[s] * pj[s] * pj[s];
        }
        row_sums<W>(lp, lpp, tid & 31);
        if constexpr (WARPS_ROW > 1) {
            const int warp = tid >> 5, first = warp - (t >> 5);
            if ((tid & 31) == 0) {
                red[j & 1][0][warp] = lp;
                red[j & 1][1][warp] = lpp;
            }
            __syncthreads();
            lp = 0.f;
            lpp = 0.f;
#pragma unroll
            for (int w = 0; w < WARPS_ROW; ++w) {  // the same order in every thread
                lp += red[j & 1][0][first + w];
                lpp += red[j & 1][1][first + w];
            }
        }
        float r1j = r1[j];
#pragma unroll
        for (int i = 0; i < j; ++i) r1j += dl[i] * Jr[i * CDG_KB + j];
        const float num = lp + alpha0 * r1j + l2 * wv[j];
        const float den = lpp + alpha0 * Jr[j * CDG_KB + j] + l2;
        const float delta = -eta * num / fmaxf(den, 1e-12f);
#pragma unroll
        for (int s = 0; s < SLOTS; ++s) ev[s] += delta * pj[s];
        dl[j] = delta;
        wv[j] += delta;
    }

    if (!live) return;
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
        const int d = d0 + W * s;
        if (d < D) e[g + d] = ev[s];
    }
    if (t == 0) {
#pragma unroll
        for (int f = 0; f < CDG_KB; ++f)
            if (f < kb) w_out[row * kb + f] = wv[f];
    }
}

// Where Q_a and P(a, b), a ≤ b, sit among a thread's Sums<KB>::n sums: Q
// first, then P's upper triangle row by row (row a holds KB − a sums).
template <int KB>
__host__ __device__ constexpr int q_at(int a) { return a; }
template <int KB>
__host__ __device__ constexpr int p_at(int a, int b) {
    return KB + a * KB - a * (a - 1) / 2 + (b - a);
}

// Row a of P's triangle entry r = p_at(a, b) − KB, without a loop: the
// number of rows after the first that start at or before r (each start a
// compile-time constant).
template <int KB>
__device__ __forceinline__ int tri_row(int r) {
    int a = 0;
#pragma unroll
    for (int i = 1; i < KB; ++i) a += r >= p_at<KB>(i, i) - KB;
    return a;
}

// One level of the transpose-reduce over a lane's first N of NS values with
// the lane at xor O, then the next level at O / 2: the lane whose bit O is
// clear keeps [0, H), its partner [H, N) (H = ⌈N/2⌉; an odd N pads the upper
// half with a zero), and each adds the partner's copy of the half it keeps.
template <int N, int O, int NS>
__device__ __forceinline__ void transpose_reduce(float (&v)[NS], int lane) {
    if constexpr (O > 0) {
        constexpr int H = (N + 1) / 2;
        const bool hi = (lane & O) != 0;
#pragma unroll
        for (int k = 0; k < H; ++k) {
            const float lo_v = v[k];
            const float hi_v = H + k < N ? v[H + k] : 0.f;
            v[k] = (hi ? hi_v : lo_v) + __shfl_xor_sync(FULL_MASK, hi ? lo_v : hi_v, O);
        }
        transpose_reduce<H, O / 2>(v, lane);
    }
}

// Values a lane holds after transpose_reduce<N, O>.
template <int N, int O>
struct Reduced {
    static constexpr int n = Reduced<(N + 1) / 2, O / 2>::n;
};
template <int N>
struct Reduced<N, 0> {
    static constexpr int n = N;
};

// Which of the N values the lane's k-th reduced value is the sum of, or −1
// for a padding zero.
template <int N, int O>
__device__ __forceinline__ int reduced_index(int k, int lane) {
    if constexpr (O == 0) {
        return k;
    } else {
        constexpr int H = (N + 1) / 2;
        const int i = reduced_index<H, O / 2>(k, lane);
        const int idx = ((lane & O) ? H : 0) + i;
        return i < 0 || idx >= N ? -1 : idx;
    }
}

// Adds to acc the Sums<KB>::n moments (Q_a, and P(a, b) for a ≤ b) of the
// slots d = d_first, d_first + STEP, … < d_end of the row at offset g, m ≤
// KB columns (zeros beyond; a wide KB takes m = KB only),
// CDG_SLAB_INFLIGHT slots at a time (wide: CDG_SLAB_WIDE_INFLIGHT). A
// slot's m values are gathered through ids from the slab (TILE false) or
// read from the row's (m, D) block of the pre-gathered (C, m, D) tile (TILE
// true: column a of slot d at tile[g·m + a·D + d], coalesced across the
// lanes).
template <int KB, int STEP, bool TILE = false>
__device__ __forceinline__ void add_moments(float (&acc)[Sums<KB>::n],
                                            const float* __restrict__ tab, long long ld_tab,
                                            int n_src, int vec, const int* __restrict__ ids,
                                            const float* __restrict__ alpha,
                                            const float* __restrict__ e, size_t g, int d_first,
                                            int d_end, int m, const float* __restrict__ tile = nullptr,
                                            int D = 0) {
    constexpr int U = KB == CDG_KB ? CDG_SLAB_INFLIGHT : CDG_SLAB_WIDE_INFLIGHT;
    if constexpr (KB != CDG_KB) m = KB;  // a compile-time width for the wide instance
    if constexpr (TILE) {
        // every load is independent of the others: a chunk's U slots issue
        // their α, e and m values at once
        const float* tr = tile + g * m;
        for (int d0 = d_first; d0 < d_end; d0 += U * STEP) {
            float al[U], ae[U], x[U][KB];
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const int d = d0 + u * STEP;
                const bool in = d < d_end;
                al[u] = in ? alpha[g + d] : 0.f;
                ae[u] = in ? e[g + d] : 0.f;
#pragma unroll
                for (int a = 0; a < KB; ++a)
                    x[u][a] = in && a < m ? __ldg(tr + (size_t)a * D + d) : 0.f;
            }
#pragma unroll
            for (int u = 0; u < U; ++u) {
                ae[u] = al[u] * ae[u];
#pragma unroll
                for (int a = 0; a < KB; ++a) {
                    acc[q_at<KB>(a)] += x[u][a] * ae[u];
                    const float api = al[u] * x[u][a];
#pragma unroll
                    for (int b = a; b < KB; ++b) acc[p_at<KB>(a, b)] += api * x[u][b];
                }
            }
        }
        return;
    }
    // the next chunk's ids, α and e load while this chunk's ψ rows are
    // gathered: one round trip a chunk, not two
    int idn[U];
    float aln[U], en[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
        const int d = d_first + u * STEP;
        idn[u] = d < d_end ? ids[g + d] : 0;
        aln[u] = d < d_end ? alpha[g + d] : 0.f;
        en[u] = d < d_end ? e[g + d] : 0.f;
    }
    for (int d0 = d_first; d0 < d_end; d0 += U * STEP) {
        float al[U], ae[U], x[U][KB];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            gather_cols(x[u], tab, ld_tab, clip_id(idn[u], n_src), m, vec);
            al[u] = aln[u];
            ae[u] = aln[u] * en[u];
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int d = d0 + (U + u) * STEP;
            idn[u] = d < d_end ? ids[g + d] : 0;
            aln[u] = d < d_end ? alpha[g + d] : 0.f;
            en[u] = d < d_end ? e[g + d] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
#pragma unroll
            for (int a = 0; a < KB; ++a) {
                acc[q_at<KB>(a)] += x[u][a] * ae[u];
                const float api = al[u] * x[u][a];
#pragma unroll
                for (int b = a; b < KB; ++b) acc[p_at<KB>(a, b)] += api * x[u][b];
            }
        }
    }
}

// KB: the instance's column count (CDG_KB for m ≤ 8, CDG_KB_WIDE for m =
// 9). TILE: the pre-gathered form, ψ from the (C, m, D) tile (tab, ids
// unused).
template <int LANES, int KB, bool TILE>
__global__ void __launch_bounds__(CDG_THREADS,
                                  KB == CDG_KB ? CDG_SLAB_MIN_BLOCKS : CDG_SLAB_WIDE_MIN_BLOCKS)
cd_slab_reduce_reg_kernel(const float* __restrict__ tab, long long ld_tab, int n_src,
                          int vec, const int* __restrict__ ids,  // (C, D)
                          const float* __restrict__ tile,        // (C, m, D)
                          const float* __restrict__ alpha,       // (C, D)
                          const float* __restrict__ e,           // (C, D)
                          float* __restrict__ q_out,             // (C, m)
                          float* __restrict__ p_out,             // (C, m, m)
                          int C, int D, int m) {
    constexpr int ROWS = CDG_THREADS / LANES;
    constexpr int NS = Sums<KB>::n;
    static_assert(LANES <= 32 && 32 % LANES == 0, "a row's lanes share a warp");
    if constexpr (KB != CDG_KB) m = KB;
    const int lane = threadIdx.x & 31, t = threadIdx.x % LANES;
    const long long row = (long long)blockIdx.x * ROWS + threadIdx.x / LANES;
    const bool live = row < C;
    const size_t g = (size_t)(live ? row : C - 1) * D;

    float acc[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) acc[i] = 0.f;
    add_moments<KB, LANES, TILE>(acc, tab, ld_tab, n_src, vec, ids, alpha, e, g, t, D, m, tile,
                                 D);

    transpose_reduce<NS, LANES / 2>(acc, lane);
    if (!live) return;
    const size_t qr = (size_t)row * m, pr = (size_t)row * m * m;
#pragma unroll
    for (int k = 0; k < Reduced<NS, LANES / 2>::n; ++k) {
        const int idx = reduced_index<NS, LANES / 2>(k, lane);
        if (idx < 0) continue;
        if (idx < KB) {
            if (idx < m) q_out[qr + idx] = acc[k];
            continue;
        }
        const int r = idx - KB, a = tri_row<KB>(r);
        const int b = a + r - (p_at<KB>(a, a) - KB);
        if (b < m) {
            p_out[pr + (size_t)a * m + b] = acc[k];
            p_out[pr + (size_t)b * m + a] = acc[k];
        }
    }
}

// Split-row sweep, pass 1: block b = row·n_chunks + chunk adds the 44
// moments of the chunk's slots, reduces them in a fixed order and writes
// them to part[b] (44 floats). TILE: ψ from the (C, kb, D) tile.
template <bool TILE>
__global__ void __launch_bounds__(CDG_THREADS, CDG_SLAB_MIN_BLOCKS)
cd_split_reduce_kernel(const float* __restrict__ psi_blk,  // (C, kb, D)
                       const float* __restrict__ tab, long long ld_tab, int n_src, int vec,
                       const int* __restrict__ ids,      // (C, D)
                       const float* __restrict__ alpha,  // (C, D)
                       const float* __restrict__ e,      // (C, D)
                       float* __restrict__ part,         // (C, n_chunks, CDG_NSUM)
                       int D, int kb, int chunk, int n_chunks) {
    constexpr int WARPS = CDG_THREADS / 32;
    __shared__ float red[WARPS][CDG_NSUM];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const long long row = blockIdx.x / n_chunks;
    const int c0 = (int)(blockIdx.x - row * n_chunks) * chunk;
    float acc[CDG_NSUM];
#pragma unroll
    for (int i = 0; i < CDG_NSUM; ++i) acc[i] = 0.f;
    add_moments<CDG_KB, CDG_THREADS, TILE>(acc, tab, ld_tab, n_src, vec, ids, alpha, e,
                                           (size_t)row * D, c0 + threadIdx.x, min(D, c0 + chunk),
                                           kb, psi_blk, D);
    transpose_reduce<CDG_NSUM, 16>(acc, lane);
#pragma unroll
    for (int k = 0; k < Reduced<CDG_NSUM, 16>::n; ++k) {
        const int idx = reduced_index<CDG_NSUM, 16>(k, lane);
        if (idx >= 0) red[warp][idx] = acc[k];
    }
    __syncthreads();
    if (threadIdx.x < CDG_NSUM) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) s += red[w][threadIdx.x];  // warp order
        part[(size_t)blockIdx.x * CDG_NSUM + threadIdx.x] = s;
    }
}

// Split-row sweep, the solve: one warp a row sums the chunk partials in
// chunk order, then one thread runs the k_b Gauss–Seidel steps on the sums
// (Q_j + Σ_{i<j} Δ_i·G_ij for L'/2, G_jj for L''/2, R'_j built on step j as
// the register-row form builds it) and writes W and Δ.
__global__ void __launch_bounds__(32)
cd_split_solve_kernel(const float* __restrict__ part, int n_chunks,
                      const float* __restrict__ w_in, long long ld_w,
                      const float* __restrict__ r1_in, long long ld_r1,
                      const float* __restrict__ cpl, long long cs0, long long cs1, long long cs2,
                      float* __restrict__ w_out,      // (C, kb)
                      float* __restrict__ delta_out,  // (C, kb)
                      int kb, float alpha0, float l2, float eta) {
    __shared__ float S[CDG_NSUM];
    const long long row = blockIdx.x;
    const float* pr = part + (size_t)row * n_chunks * CDG_NSUM;
    for (int i = threadIdx.x; i < CDG_NSUM; i += 32) {
        float s = 0.f;
        for (int c = 0; c < n_chunks; ++c) s += pr[(size_t)c * CDG_NSUM + i];
        S[i] = s;
    }
    __syncwarp();
    if (threadIdx.x != 0) return;
    const float* P = cpl + row * cs0;
    float dl[CDG_KB];
    for (int j = 0; j < kb; ++j) {
        float lp = S[q_at<CDG_KB>(j)];
        float r1j = r1_in[row * ld_r1 + j];
        for (int i = 0; i < j; ++i) {
            lp += dl[i] * S[p_at<CDG_KB>(i, j)];
            r1j += dl[i] * P[i * cs1 + j * cs2];
        }
        const float wj = w_in[row * ld_w + j];
        const float num = lp + alpha0 * r1j + l2 * wj;
        const float den = S[p_at<CDG_KB>(j, j)] + alpha0 * P[j * cs1 + j * cs2] + l2;
        const float delta = -eta * num / fmaxf(den, 1e-12f);
        dl[j] = delta;
        w_out[row * kb + j] = wj + delta;
        delta_out[row * kb + j] = delta;
    }
}

// Residual patch, register-slot form: thread t takes slots d0 … d0 +
// CDG_PATCH_SLOTS − 1 of one row. VEC: D a multiple of 4 and ids (or the
// tile), e 16-byte aligned, so a slot quad is one int4 (or one float4 of
// each tile row) and one float4 of e (whole or past D). TILE: ψ from the
// (C, m, D) tile (tab, ids unused), else gathered.
template <bool VEC, bool TILE>
__global__ void __launch_bounds__(CDG_THREADS)
cd_resid_patch_reg_kernel(const float* __restrict__ psi_blk,  // (C, m, D)
                          const float* __restrict__ tab, long long ld_tab, int n_src, int vec,
                          const int* __restrict__ ids,  // (C, D)
                          float* __restrict__ e,        // (C, D), in place
                          const float* __restrict__ dphi, long long ld_dphi,  // (C, m)
                          long long n_threads, int per_row, int D, int m) {
    constexpr int S = CDG_PATCH_SLOTS;
    const long long t = (long long)blockIdx.x * CDG_THREADS + threadIdx.x;
    if (t >= n_threads) return;
    const long long row = t / per_row;
    const int d0 = (int)(t - row * per_row) * S;
    const size_t g = (size_t)row * D + d0;
    float dp[CDG_KB];
#pragma unroll
    for (int j = 0; j < CDG_KB; ++j) dp[j] = j < m ? dphi[row * ld_dphi + j] : 0.f;
    int id[S];
    float ev[S];
#pragma unroll
    for (int q = 0; q < S / 4; ++q) {
        if (VEC) {
            const bool in = d0 + 4 * q < D;
            const int4 iv = in && !TILE ? __ldg(reinterpret_cast<const int4*>(ids + g) + q)
                                        : make_int4(0, 0, 0, 0);
            const float4 fv = in ? reinterpret_cast<const float4*>(e + g)[q]
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
            id[4 * q] = iv.x; id[4 * q + 1] = iv.y; id[4 * q + 2] = iv.z; id[4 * q + 3] = iv.w;
            ev[4 * q] = fv.x; ev[4 * q + 1] = fv.y; ev[4 * q + 2] = fv.z; ev[4 * q + 3] = fv.w;
        } else {
#pragma unroll
            for (int s = 4 * q; s < 4 * q + 4; ++s) {
                const bool in = d0 + s < D;
                id[s] = in && !TILE ? ids[g + s] : 0;
                ev[s] = in ? e[g + s] : 0.f;
            }
        }
    }
    float x[S][CDG_KB];
    if constexpr (TILE) {
        // tile row j of this row's (m, D) block at g·m + j·D; slots past D
        // read zeros
        const float* tr = psi_blk + (size_t)row * m * D + d0;
#pragma unroll
        for (int j = 0; j < CDG_KB; ++j) {
#pragma unroll
            for (int q = 0; q < S / 4; ++q) {
                if (VEC) {
                    const float4 v = j < m && d0 + 4 * q < D
                                         ? __ldg(reinterpret_cast<const float4*>(tr + (size_t)j * D) + q)
                                         : make_float4(0.f, 0.f, 0.f, 0.f);
                    x[4 * q][j] = v.x; x[4 * q + 1][j] = v.y;
                    x[4 * q + 2][j] = v.z; x[4 * q + 3][j] = v.w;
                } else {
#pragma unroll
                    for (int s = 4 * q; s < 4 * q + 4; ++s)
                        x[s][j] = j < m && d0 + s < D ? __ldg(tr + (size_t)j * D + s) : 0.f;
                }
            }
        }
    } else {
#pragma unroll
        for (int s = 0; s < S; ++s) gather_cols(x[s], tab, ld_tab, clip_id(id[s], n_src), m, vec);
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
        float v = ev[s];
#pragma unroll
        for (int j = 0; j < CDG_KB; ++j)
            if (j < m) v += dp[j] * x[s][j];
        ev[s] = v;
    }
#pragma unroll
    for (int q = 0; q < S / 4; ++q) {
        if (VEC) {
            if (d0 + 4 * q < D)
                reinterpret_cast<float4*>(e + g)[q] =
                    make_float4(ev[4 * q], ev[4 * q + 1], ev[4 * q + 2], ev[4 * q + 3]);
        } else {
#pragma unroll
            for (int s = 4 * q; s < 4 * q + 4; ++s)
                if (d0 + s < D) e[g + s] = ev[s];
        }
    }
}

static bool vec_loads(const float* tab, long long ld_tab, int cols) {
    return ((uintptr_t)tab & 15) == 0 && ld_tab % 4 == 0 && (cols == 4 || cols == 8);
}

static bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// psi_blk non-null: the tile source (tab, ids unused), else the gather.
static cudaError_t launch_patch(const float* psi_blk, const float* tab, long long ld_tab,
                                int n_src, const int* ids, float* e, const float* dphi,
                                long long ld_dphi, int C, int D, int m, cudaStream_t st) {
    const bool tile = psi_blk != nullptr;
    const int vec = tile ? 0 : vec_loads(tab, ld_tab, m);
    const bool quads = D % 4 == 0 && aligned16(tile ? (const void*)psi_blk : ids) && aligned16(e);
    const int per_row = (D + CDG_PATCH_SLOTS - 1) / CDG_PATCH_SLOTS;
    const long long n_threads = (long long)C * per_row;
    const long long blocks = (n_threads + CDG_THREADS - 1) / CDG_THREADS;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
#define CDG_PATCH_LAUNCH(V, T)                                                                 \
    cd_resid_patch_reg_kernel<V, T><<<(unsigned)blocks, CDG_THREADS, 0, st>>>(                 \
        psi_blk, tab, ld_tab, n_src, vec, ids, e, dphi, ld_dphi, n_threads, per_row, D, m)
    if (tile && quads)
        CDG_PATCH_LAUNCH(true, true);
    else if (tile)
        CDG_PATCH_LAUNCH(false, true);
    else if (quads)
        CDG_PATCH_LAUNCH(true, false);
    else
        CDG_PATCH_LAUNCH(false, false);
#undef CDG_PATCH_LAUNCH
    return cudaGetLastError();
}

// The tile source is compiled for the row patch only: the pre-gathered
// shared-J sweep keeps csrc/cd_sweep.cu's forms.
template <int LANES, int SLOTS, typename... Args>
static cudaError_t launch_sweep(int C, int kb, bool rowpatch, bool tile, cudaStream_t st,
                                Args... args) {
    constexpr int rows = CDG_THREADS / LANES;
    const int blocks = (C + rows - 1) / rows;
#define CDG_SWEEP_LAUNCH(K, P, T)                                                              \
    cd_sweep_gather_reg_kernel<LANES, SLOTS, K, P, T><<<blocks, CDG_THREADS, 0, st>>>(args...)
    if (tile && kb == CDG_KB)
        CDG_SWEEP_LAUNCH(CDG_KB, true, true);
    else if (tile)
        CDG_SWEEP_LAUNCH(0, true, true);
    else if (kb == CDG_KB && rowpatch)
        CDG_SWEEP_LAUNCH(CDG_KB, true, false);
    else if (kb == CDG_KB)
        CDG_SWEEP_LAUNCH(CDG_KB, false, false);
    else if (rowpatch)
        CDG_SWEEP_LAUNCH(0, true, false);
    else
        CDG_SWEEP_LAUNCH(0, false, false);
#undef CDG_SWEEP_LAUNCH
    return cudaGetLastError();
}

// The ψ source of an entry point: the (C, cols, D) tile psi_blk
// (contiguous; tab and ids null), or the slab tab of at least cols columns
// with the id grid (psi_blk null).
static bool source_ok(const float* psi_blk, const float* tab, long long ld_tab, int n_src,
                      const int* ids, int cols) {
    if (psi_blk != nullptr) return tab == nullptr && ids == nullptr;
    return tab != nullptr && ids != nullptr && n_src >= 1 && ld_tab >= cols;
}

// psi_blk or tab (source_ok): the ψ source, the tile with the per-row
// patch only; tab: the ψ slab, row stride ld_tab, columns contiguous; ids,
// alpha, e: (C, D) contiguous; w_in, r1_in: (C, kb) with row strides; cpl:
// the coupling block, element (r, i, f) at r·cs0 + i·cs1 + f·cs2 — cs0 = 0
// for one (kb, kb) block J shared by every row, else the per-row patch P;
// w_out: (C, kb) contiguous. lanes (8 … CDG_THREADS, a power of two)
// threads own a row, slots (4, 8 or 16) slots each; lanes · slots ≥ D.
extern "C" int cd_sweep_reg_f32(const float* psi_blk, const float* tab, long long ld_tab,
                                int n_src, const int* ids, const float* alpha, float* e,
                                const float* w_in, long long ld_w, const float* r1_in,
                                long long ld_r1, const float* cpl, long long cs0, long long cs1,
                                long long cs2, float* w_out, int C, int D, int kb, float alpha0,
                                float l2, float eta, int lanes, int slots, void* stream) {
    if (C < 0 || D < 1 || kb < 1 || kb > CDG_KB ||
        !source_ok(psi_blk, tab, ld_tab, n_src, ids, kb) ||
        (psi_blk != nullptr && cs0 == 0) || alpha == nullptr || e == nullptr ||
        w_in == nullptr || r1_in == nullptr || cpl == nullptr || w_out == nullptr ||
        (long long)lanes * slots < D)
        return (int)cudaErrorInvalidValue;
    if (C == 0) return (int)cudaSuccess;
    const bool tile = psi_blk != nullptr;
    const int vec = tile ? 0 : vec_loads(tab, ld_tab, kb);
    const bool rowpatch = cs0 != 0;
    cudaStream_t st = (cudaStream_t)stream;
#define CDG_SWEEP_CASE(L, S)                                                                  \
    if (lanes == L && slots == S)                                                             \
        return (int)launch_sweep<L, S>(C, kb, rowpatch, tile, st, psi_blk, tab, ld_tab,       \
                                       n_src, vec, ids, alpha, e, w_in, ld_w, r1_in, ld_r1,   \
                                       cpl, cs0, cs1, cs2, w_out, C, D, kb, alpha0, l2, eta);
#define CDG_SWEEP_LANES(S)                                                                    \
    CDG_SWEEP_CASE(8, S) CDG_SWEEP_CASE(16, S) CDG_SWEEP_CASE(32, S) CDG_SWEEP_CASE(64, S)   \
    CDG_SWEEP_CASE(128, S) CDG_SWEEP_CASE(256, S)
    CDG_SWEEP_LANES(4)
    CDG_SWEEP_LANES(8)
    CDG_SWEEP_LANES(16)
#undef CDG_SWEEP_LANES
#undef CDG_SWEEP_CASE
    return (int)cudaErrorInvalidValue;
}

// As csrc/cd_slab.cu's cd_slab_reduce_f32 for m ≤ CDG_KB_WIDE: the gather
// form (tab, ids; psi_blk null) or the pre-gathered form (psi_blk (C, m, D)
// contiguous; tab, ids null); lanes threads own a row: 8, 16 or 32 at m ≤ 8
// (the KB = 8 instance), 32 at m = 9 (KB = 9).
extern "C" int cd_slab_reduce_reg_f32(const float* psi_blk, const float* tab, long long ld_tab,
                                      int n_src, const int* ids, const float* alpha,
                                      const float* e, float* q_out, float* p_out, int C, int D,
                                      int m, int lanes, void* stream) {
    const bool tile = psi_blk != nullptr;
    if (C < 0 || D < 1 || m < 1 || m > CDG_KB_WIDE || (m > CDG_KB && lanes != 32) ||
        alpha == nullptr || e == nullptr || q_out == nullptr || p_out == nullptr ||
        !source_ok(psi_blk, tab, ld_tab, n_src, ids, m))
        return (int)cudaErrorInvalidValue;
    if (C == 0) return (int)cudaSuccess;
    const int vec = tile ? 0 : vec_loads(tab, ld_tab, m);
    cudaStream_t st = (cudaStream_t)stream;
#define CDG_SLAB_LAUNCH(L, K)                                                                 \
    {                                                                                         \
        constexpr int rows = CDG_THREADS / L;                                                 \
        if (tile)                                                                             \
            cd_slab_reduce_reg_kernel<L, K, true><<<(C + rows - 1) / rows, CDG_THREADS, 0, st>>>( \
                tab, ld_tab, n_src, vec, ids, psi_blk, alpha, e, q_out, p_out, C, D, m);      \
        else                                                                                  \
            cd_slab_reduce_reg_kernel<L, K, false><<<(C + rows - 1) / rows, CDG_THREADS, 0, st>>>( \
                tab, ld_tab, n_src, vec, ids, psi_blk, alpha, e, q_out, p_out, C, D, m);      \
        return (int)cudaGetLastError();                                                       \
    }
    if (m > CDG_KB) CDG_SLAB_LAUNCH(32, CDG_KB_WIDE)
    if (lanes == 8) CDG_SLAB_LAUNCH(8, CDG_KB)
    if (lanes == 16) CDG_SLAB_LAUNCH(16, CDG_KB)
    if (lanes == 32) CDG_SLAB_LAUNCH(32, CDG_KB)
#undef CDG_SLAB_LAUNCH
    return (int)cudaErrorInvalidValue;
}

// The split-row sweep: the arguments of cd_sweep_reg_f32 (the tile with
// either coupling), and part (C, ⌈D/chunk⌉, CDG_NSUM) and delta (C, kb),
// contiguous scratch the caller allocates; chunk ≥ 1 slots a pass-1 block.
// Any number of rows whose chunks number at most 2^31 − 1.
extern "C" int cd_sweep_split_row_f32(const float* psi_blk, const float* tab, long long ld_tab,
                                      int n_src, const int* ids, const float* alpha, float* e,
                                      const float* w_in, long long ld_w, const float* r1_in,
                                      long long ld_r1, const float* cpl, long long cs0,
                                      long long cs1, long long cs2, float* w_out, float* part,
                                      float* delta, int C, int D, int kb, float alpha0,
                                      float l2, float eta, int chunk, void* stream) {
    if (C < 0 || D < 1 || kb < 1 || kb > CDG_KB || chunk < 1 ||
        !source_ok(psi_blk, tab, ld_tab, n_src, ids, kb) || alpha == nullptr ||
        e == nullptr || w_in == nullptr || r1_in == nullptr || cpl == nullptr ||
        w_out == nullptr || part == nullptr || delta == nullptr)
        return (int)cudaErrorInvalidValue;
    if (C == 0) return (int)cudaSuccess;
    const int n_chunks = (D + chunk - 1) / chunk;
    const long long blocks = (long long)C * n_chunks;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const bool tile = psi_blk != nullptr;
    const int vec = tile ? 0 : vec_loads(tab, ld_tab, kb);
    cudaStream_t st = (cudaStream_t)stream;
    if (tile)
        cd_split_reduce_kernel<true><<<(unsigned)blocks, CDG_THREADS, 0, st>>>(
            psi_blk, tab, ld_tab, n_src, vec, ids, alpha, e, part, D, kb, chunk, n_chunks);
    else
        cd_split_reduce_kernel<false><<<(unsigned)blocks, CDG_THREADS, 0, st>>>(
            psi_blk, tab, ld_tab, n_src, vec, ids, alpha, e, part, D, kb, chunk, n_chunks);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    cd_split_solve_kernel<<<C, 32, 0, st>>>(part, n_chunks, w_in, ld_w, r1_in, ld_r1, cpl, cs0,
                                            cs1, cs2, w_out, delta, kb, alpha0, l2, eta);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    return (int)launch_patch(psi_blk, tab, ld_tab, n_src, ids, e, delta, kb, C, D, kb, st);
}

// As csrc/cd_slab.cu's cd_resid_patch_f32 for m ≤ 8: the gather form (tab,
// ids; psi_blk null) or the pre-gathered form (psi_blk (C, m, D)
// contiguous; tab, ids null).
extern "C" int cd_resid_patch_reg_f32(const float* psi_blk, const float* tab, long long ld_tab,
                                      int n_src, const int* ids, float* e, const float* dphi,
                                      long long ld_dphi, int C, int D, int m, void* stream) {
    if (C < 0 || D < 1 || m < 1 || m > CDG_KB || ld_dphi < 0 || e == nullptr ||
        dphi == nullptr || !source_ok(psi_blk, tab, ld_tab, n_src, ids, m))
        return (int)cudaErrorInvalidValue;
    if (C == 0) return (int)cudaSuccess;
    return (int)launch_patch(psi_blk, tab, ld_tab, n_src, ids, e, dphi, ld_dphi, C, D, m,
                             (cudaStream_t)stream);
}

extern "C" const char* cd_gather_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
