// iCD-FM's embedding field layer, hand-written for Hopper (sm_90a): the Newton step of every
// feature of one field (or of a whole bag, as one damped Jacobi step) in one dimension f*,
// with the per-row caches patched, in three launches (four for a bag).
//
// Replaces no Pallas kernel. The JAX package's embedding layer is XLA ops
// (repro/core/models/fm.py:_embed_layer_update); the port ran the same as ≈ 78 PyTorch
// launches a layer, four index_add_ sums among them, so that at icd-fm's A+P+H width (1,024
// layers an epoch) the host's launches took as long as the device's work.
//
// The algebra (ref.py is the same in PyTorch, and each product and sum here is rounded once,
// as there: no contraction into fused multiply-adds). For the layer's entries n (feature
// v = id − offset, weight x, row c), the rows' Φe columns φ_f (f*) and φ_s (the special
// column), the caches q, u, r_a, r_b, p2, p1, p0 of f* and J's jff, jfs, jss:
//   sums    g = φ_f[c] − x·θ[v]   (θ before the step)
//           S[v] += (x·(q + g·u), x²·(p2 + 2g·p1 + g²·p0), x·(r_a + g·r_b),
//                    x²·(jff + 2g·jfs + g²·jss))                          (atomics)
//   step    grad = S0 + α0·S2,  hess = S1 + α0·S3
//           δ[v] = (−η·(grad + l2·θ[v])) / max(hess + l2, 1e-12),  θ[v] += δ[v]
//   apply   dφ_f[c] = Σ x·δ[v],  dφ_s[c] = Σ (x·δ[v])·g  over c's entries;
//           φ_f += dφ_f,  φ_s += dφ_s,  q += dφ_f·p2 + dφ_s·p1,  u += dφ_f·p1 + dφ_s·p0,
//           r_a += dφ_f·jff + dφ_s·jfs,  r_b += dφ_f·jfs + dφ_s·jss
// The step keeps θ before it beside δ, so the apply pass computes each entry's g again from
// φ_f (not yet moved) and that θ: the same inputs, the same operations, the same bits as the
// sums pass used. A layer with one entry a row (a one-hot field, a bag slot) applies in one
// pass over its entries (entry n is row n); a bag scatters x·δ and x·δ·g onto its rows
// (atomics) and a pass over the rows applies. J's entries are read on the device, so nothing
// waits for the host.
//
// Sums by atomics, as the index_add_ sums they replace: their last bits can change from run
// to run. Device memory takes a feature's four sums (a row's two) in one vector atomic, each
// float atomic on its own (sm_90). A field of at most SMEM_VOCAB features (age, gender,
// country, device) sums into shared memory first, one block's partials a feature, so that a
// few addresses do not take every entry's atomic. The step reads and zeroes S and the pass over a bag's rows reads and
// zeroes its row sums, so the scratch is zero again for the next layer without a fill.
//
// Interface: plain C functions bound with ctypes. fm_layer_step_f32 launches on the caller's
// stream, allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int THREADS = 256;
constexpr int SMEM_VOCAB = 1024;  // features a block's shared sums hold (16 KB)

struct Layer {
    const int64_t* ids;   // (n,) global feature ids
    const float* xw;      // (n,) weights
    const int64_t* rows;  // (n,) rows; not read where entry n is row n
    const float* p2;      // (n_rows,) each
    const float* p1;
    const float* p0;
    const float* jff;     // J(f*, f*), J(f*, s), J(s, s): one float each, on the device
    const float* jfs;
    const float* jss;
    float* table;         // θ of global id at table[id·ld_t], in place
    float* phi_f;         // φ_f[c] at phi_f[c·ld_p], in place
    float* phi_s;         // φ_s[c] at phi_s[c·ld_p], in place
    float* q;             // (n_rows,) each, in place
    float* u;
    float* ra;
    float* rb;
    float* sums;          // (4·vocab,) zeros on entry and on exit
    float2* step;         // (vocab,) {δ, θ before the step}
    float2* acc;          // (n_rows,) {Σ x·δ, Σ x·δ·g}: zeros on entry and on exit (a bag only)
    float* dphi;          // (2·n_rows,) the rows' dφ_f, then dφ_s, for the caller's patch
    long long n, n_rows, offset, ld_t, ld_p;
    int vocab;
    float alpha0, l2, eta;
};

template <bool SHARED, bool IDENTITY>
__global__ void __launch_bounds__(THREADS) fm_layer_sums_kernel(Layer a) {
    __shared__ float sh[SHARED ? 4 * SMEM_VOCAB : 1];
    if constexpr (SHARED) {
        for (int i = threadIdx.x; i < 4 * a.vocab; i += THREADS) sh[i] = 0.f;
        __syncthreads();
    }
    const float jff = *a.jff, jfs = *a.jfs, jss = *a.jss;
    const long long stride = (long long)gridDim.x * THREADS;
    for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < a.n; i += stride) {
        const float x = a.xw[i];
        if (x == 0.f) continue;  // adds ±0 to its sums
        const long long c = IDENTITY ? i : a.rows[i];
        const long long id = a.ids[i];
        const float g = __fsub_rn(a.phi_f[c * a.ld_p], __fmul_rn(x, a.table[id * a.ld_t]));
        const float g2 = __fmul_rn(2.f, g), gg = __fmul_rn(g, g), xx = __fmul_rn(x, x);
        const float4 t = make_float4(
            __fmul_rn(x, __fadd_rn(a.q[c], __fmul_rn(g, a.u[c]))),
            __fmul_rn(xx, __fadd_rn(__fadd_rn(a.p2[c], __fmul_rn(g2, a.p1[c])),
                                    __fmul_rn(gg, a.p0[c]))),
            __fmul_rn(x, __fadd_rn(a.ra[c], __fmul_rn(g, a.rb[c]))),
            __fmul_rn(xx, __fadd_rn(__fadd_rn(jff, __fmul_rn(g2, jfs)), __fmul_rn(gg, jss))));
        if constexpr (SHARED) {
            float* s = sh + 4 * (id - a.offset);
            atomicAdd(s, t.x);
            atomicAdd(s + 1, t.y);
            atomicAdd(s + 2, t.z);
            atomicAdd(s + 3, t.w);
        } else {  // one vector atomic (each float atomic on its own), not four
            atomicAdd(reinterpret_cast<float4*>(a.sums) + (id - a.offset), t);
        }
    }
    if constexpr (SHARED) {
        __syncthreads();
        for (int i = threadIdx.x; i < 4 * a.vocab; i += THREADS)
            if (sh[i] != 0.f) atomicAdd(a.sums + i, sh[i]);
    }
}

__global__ void __launch_bounds__(THREADS) fm_layer_solve_kernel(Layer a) {
    const int v = blockIdx.x * THREADS + threadIdx.x;
    if (v >= a.vocab) return;
    float4* s = reinterpret_cast<float4*>(a.sums) + v;
    const float4 t = *s;
    *s = make_float4(0.f, 0.f, 0.f, 0.f);
    const float grad = __fadd_rn(t.x, __fmul_rn(a.alpha0, t.z));
    const float hess = __fadd_rn(t.y, __fmul_rn(a.alpha0, t.w));
    float* th = a.table + (a.offset + v) * a.ld_t;
    const float theta = *th;
    const float num = __fadd_rn(grad, __fmul_rn(a.l2, theta));
    const float den = __fadd_rn(hess, a.l2);
    const float d = __fdiv_rn(__fmul_rn(-a.eta, num), den < 1e-12f ? 1e-12f : den);
    *th = __fadd_rn(theta, d);
    a.step[v] = make_float2(d, theta);
}

// A row's Φe entries and caches, loaded before any store: as far as the compiler knows the
// arrays alias, so a load placed after a store would wait for it.
struct Row {
    float ph, ps, q, u, ra, rb, p2, p1, p0;
};

__device__ __forceinline__ Row load_row(const Layer& a, long long c) {
    return {a.phi_f[c * a.ld_p], a.phi_s[c * a.ld_p], a.q[c], a.u[c], a.ra[c], a.rb[c],
            a.p2[c], a.p1[c], a.p0[c]};
}

// Row c's (dφ_f, dφ_s) reach Φe and the caches; each was summed into zeros, as 0 + Σ.
__device__ __forceinline__ void apply_row(const Layer& a, long long c, const Row& r, float df,
                                          float ds, float jff, float jfs, float jss) {
    a.dphi[c] = df;
    a.dphi[a.n_rows + c] = ds;
    a.phi_f[c * a.ld_p] = __fadd_rn(r.ph, df);
    a.phi_s[c * a.ld_p] = __fadd_rn(r.ps, ds);
    a.q[c] = __fadd_rn(__fadd_rn(r.q, __fmul_rn(df, r.p2)), __fmul_rn(ds, r.p1));
    a.u[c] = __fadd_rn(__fadd_rn(r.u, __fmul_rn(df, r.p1)), __fmul_rn(ds, r.p0));
    a.ra[c] = __fadd_rn(__fadd_rn(r.ra, __fmul_rn(df, jff)), __fmul_rn(ds, jfs));
    a.rb[c] = __fadd_rn(__fadd_rn(r.rb, __fmul_rn(df, jfs)), __fmul_rn(ds, jss));
}

template <bool IDENTITY>
__global__ void __launch_bounds__(THREADS) fm_layer_apply_kernel(Layer a) {
    const float jff = *a.jff, jfs = *a.jfs, jss = *a.jss;
    const long long stride = (long long)gridDim.x * THREADS;
    for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < a.n; i += stride) {
        const float x = a.xw[i];
        if (!IDENTITY && x == 0.f) continue;  // scatters ±0
        const long long c = IDENTITY ? i : a.rows[i];
        const float2 st = a.step[a.ids[i] - a.offset];
        if constexpr (IDENTITY) {
            const Row r = load_row(a, i);
            const float g = __fsub_rn(r.ph, __fmul_rn(x, st.y));
            const float de = __fmul_rn(x, st.x);
            apply_row(a, i, r, __fadd_rn(0.f, de), __fadd_rn(0.f, __fmul_rn(de, g)), jff, jfs,
                      jss);
        } else {
            const float g = __fsub_rn(a.phi_f[c * a.ld_p], __fmul_rn(x, st.y));
            const float de = __fmul_rn(x, st.x);
            atomicAdd(a.acc + c, make_float2(de, __fmul_rn(de, g)));
        }
    }
}

__global__ void __launch_bounds__(THREADS) fm_layer_rows_kernel(Layer a) {
    const float jff = *a.jff, jfs = *a.jfs, jss = *a.jss;
    const long long stride = (long long)gridDim.x * THREADS;
    for (long long c = (long long)blockIdx.x * THREADS + threadIdx.x; c < a.n_rows; c += stride) {
        const float2 d = a.acc[c];
        const Row r = load_row(a, c);
        a.acc[c] = make_float2(0.f, 0.f);
        apply_row(a, c, r, d.x, d.y, jff, jfs, jss);
    }
}

static int grid_of(long long n, int cap) {
    const long long b = (n + THREADS - 1) / THREADS;
    return (int)(b < 1 ? 1 : (b > cap ? cap : b));
}

// One embedding field layer: sums, step, apply (and a pass over the rows for a bag).
// identity: the layer has one entry a row, entry n on row n (n == n_rows), and rows is not
// read. step (2·vocab floats), acc (2·n_rows floats, a bag only) and sums (4·vocab floats) are
// scratch; sums and acc hold zeros on entry and are left so. sms: the device's SMs.
extern "C" int fm_layer_step_f32(const int64_t* ids, const float* xw, const int64_t* rows,
                                 int identity, long long n, long long offset, int vocab,
                                 long long n_rows,
                                 float* table, long long ld_t, float* phi_f, float* phi_s,
                                 long long ld_p, float* q, float* u, float* ra, float* rb,
                                 const float* p2, const float* p1, const float* p0,
                                 const float* jff, const float* jfs, const float* jss,
                                 float* sums, float* step, float* acc, float* dphi,
                                 float alpha0, float l2, float eta, int sms, void* stream) {
    if (n < 0 || vocab < 1 || n_rows < 0 || ld_t < 1 || ld_p < 1 || sms < 1 ||
        (identity && n != n_rows) || (!identity && n_rows > 0 && acc == nullptr) ||
        reinterpret_cast<uintptr_t>(sums) % 16 != 0 || reinterpret_cast<uintptr_t>(step) % 8 != 0 ||
        reinterpret_cast<uintptr_t>(acc) % 8 != 0)
        return (int)cudaErrorInvalidValue;
    Layer a;
    a.ids = ids, a.xw = xw, a.rows = rows, a.p2 = p2, a.p1 = p1, a.p0 = p0;
    a.jff = jff, a.jfs = jfs, a.jss = jss;
    a.table = table, a.phi_f = phi_f, a.phi_s = phi_s, a.q = q, a.u = u, a.ra = ra, a.rb = rb;
    a.sums = sums, a.step = reinterpret_cast<float2*>(step);
    a.acc = reinterpret_cast<float2*>(acc), a.dphi = dphi;
    a.n = n, a.n_rows = n_rows, a.offset = offset, a.ld_t = ld_t, a.ld_p = ld_p;
    a.vocab = vocab, a.alpha0 = alpha0, a.l2 = l2, a.eta = eta;
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    const int wide = grid_of(n, 16 * sms);
    if (n > 0) {
        if (vocab <= SMEM_VOCAB) {
            const int g = grid_of(n, 2 * sms);  // few blocks: each adds its vocab partials
            if (identity) fm_layer_sums_kernel<true, true><<<g, THREADS, 0, st>>>(a);
            else fm_layer_sums_kernel<true, false><<<g, THREADS, 0, st>>>(a);
        } else if (identity) {
            fm_layer_sums_kernel<false, true><<<wide, THREADS, 0, st>>>(a);
        } else {
            fm_layer_sums_kernel<false, false><<<wide, THREADS, 0, st>>>(a);
        }
    }
    fm_layer_solve_kernel<<<(vocab + THREADS - 1) / THREADS, THREADS, 0, st>>>(a);
    if (identity) {
        if (n > 0) fm_layer_apply_kernel<true><<<wide, THREADS, 0, st>>>(a);
    } else {
        if (n > 0) fm_layer_apply_kernel<false><<<wide, THREADS, 0, st>>>(a);
        if (n_rows > 0)
            fm_layer_rows_kernel<<<grid_of(n_rows, 16 * sms), THREADS, 0, st>>>(a);
    }
    return (int)cudaGetLastError();
}

extern "C" const char* fm_layer_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
