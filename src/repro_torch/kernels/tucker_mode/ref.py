"""Plain PyTorch version of Tucker's mode sweep by column: the same algebra
as the kernels, one column of the side at a time.

For column c, with pp the pair's partner row and B_c the core's slice,
d_c = pp·B_c over the pairs and s_c = ⟨d_c(pair), w_item⟩ over the log;
L'/2 = Σ ᾱ e s_c, L''/2 = Σ ᾱ s_c², R'/2 = Σ ⟨pp·(B_c J), Φ⟩ and
R''/2 = Σ ⟨pp·(B_c J), d_c⟩, summed by the pair's group; then the Newton
step of every group. The sums are taken as the kernels take them: by
pair (the log's rows), then by group over the pairs listed group by group.
The step reaches Φ and e at the start of the next column's pass (the last
one's in a closing patch), from the previous column's d (recomputed) and
s (kept)."""
import torch

from repro_torch.sparse.segment import segment_sum_sorted


def mode_sweep_ref(side, b_slices, partner, partner_of_pair, group_of_pair, order,
                   group_ptr, phi, j_i, w, ctx_ptr, item, alpha, e, *, columns,
                   alpha0: float, l2: float, eta: float):
    n_pairs, nnz = phi.shape[0], item.shape[0]
    pair = torch.repeat_interleave(torch.arange(n_pairs, device=phi.device),
                                   torch.diff(ctx_ptr), output_size=nnz)
    grp_nnz = group_of_pair[pair]
    pp = partner[partner_of_pair]                            # (n_pairs, k_o)
    w_nnz = w[item]                                          # (nnz, k3)

    prev = None
    for c in (*columns, None):
        if prev is not None:  # the previous column's step reaches Φ and e
            phi += delta[group_of_pair][:, None] * (pp @ b_slices[prev])
            e = e + delta[grp_nnz] * s
        if c is None:
            break
        d = pp @ b_slices[c]                                 # (n_pairs, k3)
        dj = pp @ (b_slices[c] @ j_i)
        s = torch.sum(d[pair] * w_nnz, dim=1)                # (nnz,)
        by_pair = (*segment_sum_sorted((alpha * e * s, alpha * s * s), ctx_ptr),
                   torch.sum(dj * phi, dim=1), torch.sum(dj * d, dim=1))
        if order is not None:
            by_pair = tuple(x[order] for x in by_pair)
        lp, lpp, rp, rpp = segment_sum_sorted(by_pair, group_ptr)
        theta = side[:, c]
        # the step of sweeps.newton_delta
        num = (lp + alpha0 * rp) + l2 * theta
        den = (lpp + alpha0 * rpp) + l2
        delta = -eta * num / torch.clamp(den, min=1e-12)
        side[:, c] = theta + delta
        prev = c
    return side, phi, e
