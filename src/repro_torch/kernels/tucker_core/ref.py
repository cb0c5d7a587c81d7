"""Plain PyTorch version of Tucker's blocked core sweep: the same algebra
as the kernel, a slab (f1, f2) of the core at a time.

Within a slab the k3 steps share g = u[c1, f1]·v[c2, f2] over the pairs,
and u, v, w and ᾱ are fixed during the sweep, so one pass over the log
gives every step of the slab: L'' is K[f, f] with
K = Σₙ ᾱ g² w_i w_iᵀ, L' after the slab's earlier steps is
L'⁰_f + Σ_{f'<f} δ_{f'} K[f', f] (e⁰ the residual at the slab's start),
and Φᵀg follows from R = Gₚ·Φ₀ and the Gram G = Gₚ·Gₚᵀ of the g rows."""
import torch


def core_sweep_slabs_ref(w, gp, gram_g, r, b, j_i, ctx_ptr, item, alpha, e, *,
                         alpha0: float, l2_core: float, eta: float):
    n_slabs, k3 = b.shape
    n_pairs, nnz = gp.shape[1], item.shape[0]
    pair = torch.repeat_interleave(torch.arange(n_pairs, device=gp.device),
                                   torch.diff(ctx_ptr), output_size=nnz)
    w_nnz = w[item]                                          # (nnz, k3)
    r, delta = r.clone(), torch.zeros_like(b)
    for ab in range(n_slabs + 1):
        if ab:  # the previous slab's steps reach the residuals
            e = e + gp[ab - 1][pair] * (w_nnz @ delta[ab - 1])
        if ab == n_slabs:
            break
        g = gp[ab][pair]
        lp = w_nnz.T @ (alpha * g * e)                       # L'⁰ (k3,)
        kk = w_nnz.T @ ((alpha * g * g)[:, None] * w_nnz)    # K (k3, k3)
        g_ab = gram_g[ab, ab]
        for f in range(k3):
            num = lp[f] + alpha0 * (r[ab] @ j_i[:, f]) + l2_core * b[ab, f]
            den = kk[f, f] + alpha0 * j_i[f, f] * g_ab + l2_core
            d = -eta * num / torch.clamp(den, min=1e-12)
            delta[ab, f] = d
            lp = lp + d * kk[f]
            r[ab, f] += d * g_ab
        r[ab + 1:] += gram_g[ab, ab + 1:, None] * delta[ab]
    return delta, e
