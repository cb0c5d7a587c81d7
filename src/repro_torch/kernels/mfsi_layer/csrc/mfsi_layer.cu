// iCD-MFSI's field layer, hand-written for Hopper (sm_90a): the Newton step of every
// feature of one field (or of a whole bag, as one damped Jacobi step) in one dimension f*,
// with the per-row caches patched, in three launches (four for a bag).
//
// Replaces no Pallas kernel. The JAX package's field layer is XLA ops
// (repro/core/models/mfsi.py:_field_layer_update); the port ran the same as ≈ 28 PyTorch
// launches a layer, each over a few hundred thousand entries, so that at icd-fm's A+P+H
// width (1,024 layers an epoch) the host's launches took as long as the device's work.
//
// The algebra (ref.py is the same in PyTorch, and each product and sum here is rounded
// once, as there: no contraction into fused multiply-adds). For the layer's entries n
// (feature v = id − offset, weight x, row c) and the per-row caches q, p2, r of f*:
//   sums    S[v] += (x·q[c], (x·x)·p2[c], x·r[c])                    (atomics)
//   step    grad = S0 + α0·S2,  hess = S1 + α0·(jff·cnt[v]),  cnt[v] = Σ x²
//           δ[v] = (−η·(grad + l2·θ[v])) / max(hess + l2, 1e-12),  θ[v] += δ[v]
//   apply   dφ[c] = Σ x·δ[v] over c's entries;  φ[c] += dφ[c],  q[c] += dφ[c]·p2[c],
//           r[c] += dφ[c]·jff
// A layer with one entry a row (a one-hot field, a bag slot) applies in one pass over its
// entries (entry n is row n); a bag scatters x·δ[v] onto its rows (atomics) and a pass over
// the rows applies. jff = J(f*, f*) is read on the device, so nothing waits for the host.
//
// Sums by atomics, as the index_add_ sums they replace: their last bits can change from run
// to run. A field of at most SMEM_VOCAB features (age, gender, country, device) sums into
// shared memory first, one block's partials a feature, so that a few addresses do not take
// every entry's atomic. The step reads and zeroes S and the apply pass reads and zeroes the
// bag's row sums, so the scratch is zero again for the next layer without a fill.
//
// Interface: plain C functions bound with ctypes. mfsi_layer_step_f32 launches on the
// caller's stream, allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int THREADS = 256;
constexpr int SMEM_VOCAB = 1024;  // features a block's shared sums hold (12 KB)

struct Layer {
    const int64_t* ids;   // (n,) global feature ids
    const float* xw;      // (n,) weights
    const int64_t* rows;  // (n,) rows, or null: entry n is row n
    const float* cnt;     // (vocab,) Σ x² a feature
    const float* p2;      // (n_rows,)
    const float* jff;     // J(f*, f*), one float on the device
    float* table;         // θ[v] at table[(offset + v)·ld_t], in place
    float* phi;           // φ[c] at phi[c·ld_p], in place
    float* q;             // (n_rows,), in place
    float* r;             // (n_rows,), in place
    float* sums;          // (3·vocab,) zeros on entry and on exit
    float* delta;         // (vocab,) the steps
    float* acc;           // (n_rows,) zeros on entry and on exit (a bag only)
    float* dphi;          // (n_rows,) the rows' dφ, for the caller's residual patch
    long long n, n_rows, offset, ld_t, ld_p;
    int vocab;
    float alpha0, l2, eta;
};

template <bool SHARED, bool IDENTITY>
__global__ void __launch_bounds__(THREADS) mfsi_layer_sums_kernel(Layer a) {
    __shared__ float sh[SHARED ? 3 * SMEM_VOCAB : 1];
    if constexpr (SHARED) {
        for (int i = threadIdx.x; i < 3 * a.vocab; i += THREADS) sh[i] = 0.f;
        __syncthreads();
    }
    float* dst = SHARED ? sh : a.sums;
    const long long stride = (long long)gridDim.x * THREADS;
    for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < a.n; i += stride) {
        const float x = a.xw[i];
        if (x == 0.f) continue;  // adds ±0 to its sums
        const long long c = IDENTITY ? i : a.rows[i];
        const int v = (int)(a.ids[i] - a.offset);
        atomicAdd(dst + 3 * v, __fmul_rn(x, a.q[c]));
        atomicAdd(dst + 3 * v + 1, __fmul_rn(__fmul_rn(x, x), a.p2[c]));
        atomicAdd(dst + 3 * v + 2, __fmul_rn(x, a.r[c]));
    }
    if constexpr (SHARED) {
        __syncthreads();
        for (int i = threadIdx.x; i < 3 * a.vocab; i += THREADS)
            if (sh[i] != 0.f) atomicAdd(a.sums + i, sh[i]);
    }
}

__global__ void __launch_bounds__(THREADS) mfsi_layer_solve_kernel(Layer a) {
    const int v = blockIdx.x * THREADS + threadIdx.x;
    if (v >= a.vocab) return;
    float* s = a.sums + 3 * (long long)v;
    const float lp = s[0], lpp = s[1], rp = s[2];
    s[0] = s[1] = s[2] = 0.f;
    const float rpp = __fmul_rn(*a.jff, a.cnt[v]);
    const float grad = __fadd_rn(lp, __fmul_rn(a.alpha0, rp));
    const float hess = __fadd_rn(lpp, __fmul_rn(a.alpha0, rpp));
    float* th = a.table + (a.offset + v) * a.ld_t;
    const float theta = *th;
    const float num = __fadd_rn(grad, __fmul_rn(a.l2, theta));
    const float den = __fadd_rn(hess, a.l2);
    const float d = __fdiv_rn(__fmul_rn(-a.eta, num), den < 1e-12f ? 1e-12f : den);
    *th = __fadd_rn(theta, d);
    a.delta[v] = d;
}

// Row c's dφ reaches φ, q and r; it was summed into zeros, as 0 + Σ.
__device__ __forceinline__ void apply_row(const Layer& a, long long c, float d) {
    a.dphi[c] = d;
    float* ph = a.phi + c * a.ld_p;
    *ph = __fadd_rn(*ph, d);
    a.q[c] = __fadd_rn(a.q[c], __fmul_rn(d, a.p2[c]));
    a.r[c] = __fadd_rn(a.r[c], __fmul_rn(d, *a.jff));
}

template <bool IDENTITY>
__global__ void __launch_bounds__(THREADS) mfsi_layer_apply_kernel(Layer a) {
    const long long stride = (long long)gridDim.x * THREADS;
    for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < a.n; i += stride) {
        const float x = a.xw[i];
        const float dv = __fmul_rn(x, a.delta[a.ids[i] - a.offset]);
        if constexpr (IDENTITY)
            apply_row(a, i, __fadd_rn(0.f, dv));
        else if (x != 0.f)
            atomicAdd(a.acc + a.rows[i], dv);
    }
}

__global__ void __launch_bounds__(THREADS) mfsi_layer_rows_kernel(Layer a) {
    const long long stride = (long long)gridDim.x * THREADS;
    for (long long c = (long long)blockIdx.x * THREADS + threadIdx.x; c < a.n_rows; c += stride) {
        const float d = a.acc[c];
        a.acc[c] = 0.f;
        apply_row(a, c, d);
    }
}

static int grid_of(long long n, int cap) {
    const long long b = (n + THREADS - 1) / THREADS;
    return (int)(b < 1 ? 1 : (b > cap ? cap : b));
}

// One field layer: sums, step, apply (and a pass over the rows for a bag). rows null: the
// layer has one entry a row, entry n on row n (n == n_rows). sms: the device's SMs.
extern "C" int mfsi_layer_step_f32(const int64_t* ids, const float* xw, const int64_t* rows,
                                   long long n, long long offset, int vocab, long long n_rows,
                                   const float* cnt, float* table, long long ld_t, float* phi,
                                   long long ld_p, float* q, float* r, const float* p2,
                                   const float* jff, float* sums, float* delta, float* acc,
                                   float* dphi, float alpha0, float l2, float eta, int sms,
                                   void* stream) {
    if (n < 0 || vocab < 1 || n_rows < 0 || ld_t < 1 || ld_p < 1 || sms < 1 ||
        (rows == nullptr && n != n_rows) || (rows != nullptr && acc == nullptr))
        return (int)cudaErrorInvalidValue;
    Layer a;
    a.ids = ids, a.xw = xw, a.rows = rows, a.cnt = cnt, a.p2 = p2, a.jff = jff;
    a.table = table, a.phi = phi, a.q = q, a.r = r, a.sums = sums, a.delta = delta;
    a.acc = acc, a.dphi = dphi;
    a.n = n, a.n_rows = n_rows, a.offset = offset, a.ld_t = ld_t, a.ld_p = ld_p;
    a.vocab = vocab, a.alpha0 = alpha0, a.l2 = l2, a.eta = eta;
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    const bool identity = rows == nullptr;
    const int wide = grid_of(n, 16 * sms);
    if (n > 0) {
        if (vocab <= SMEM_VOCAB) {
            const int g = grid_of(n, 2 * sms);  // few blocks: each adds its vocab partials
            if (identity) mfsi_layer_sums_kernel<true, true><<<g, THREADS, 0, st>>>(a);
            else mfsi_layer_sums_kernel<true, false><<<g, THREADS, 0, st>>>(a);
        } else if (identity) {
            mfsi_layer_sums_kernel<false, true><<<wide, THREADS, 0, st>>>(a);
        } else {
            mfsi_layer_sums_kernel<false, false><<<wide, THREADS, 0, st>>>(a);
        }
    }
    mfsi_layer_solve_kernel<<<(vocab + THREADS - 1) / THREADS, THREADS, 0, st>>>(a);
    if (identity) {
        if (n > 0) mfsi_layer_apply_kernel<true><<<wide, THREADS, 0, st>>>(a);
    } else {
        if (n > 0) mfsi_layer_apply_kernel<false><<<wide, THREADS, 0, st>>>(a);
        if (n_rows > 0)
            mfsi_layer_rows_kernel<<<grid_of(n_rows, 16 * sms), THREADS, 0, st>>>(a);
    }
    return (int)cudaGetLastError();
}

extern "C" const char* mfsi_layer_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
