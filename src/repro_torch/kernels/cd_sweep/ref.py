"""Plain PyTorch versions of the fused block-sweep kernels (port of
``repro.kernels.cd_sweep.ref``): sequential per-column Newton steps with
the Gauss–Seidel R' patch between columns (shared-Gram and per-row-patch
variants), the slab-moment and rank-k_b residual-patch reductions, and the
gather forms, which build the (C, m, D_pad) Ψ tile the gather kernel
avoids and reuse the pre-gathered versions. All are pure: ``e`` comes back
as a new tensor."""
import torch


def _newton_steps(psi_blk, alpha, e, w_blk, r1_blk, coupling, diag, *,
                  alpha0, l2, eta):
    """The k_b sequential steps; ``coupling(j)`` is the R' patch row for
    column j and ``diag(j)`` its R''/2."""
    w_cols = []
    r1 = r1_blk
    for j in range(psi_blk.shape[1]):
        psi_j = psi_blk[:, j, :]
        lp = torch.sum(alpha * e * psi_j, dim=1)
        lpp = torch.sum(alpha * psi_j * psi_j, dim=1)
        num = lp + alpha0 * r1[:, j] + l2 * w_blk[:, j]
        den = lpp + alpha0 * diag(j) + l2
        delta = -eta * num / torch.clamp(den, min=1e-12)
        w_cols.append(w_blk[:, j] + delta)
        e = e + delta[:, None] * psi_j
        r1 = r1 + delta[:, None] * coupling(j)
    return torch.stack(w_cols, dim=1), e


def cd_block_sweep_ref(psi_blk, alpha, e, w_blk, r1_blk, j_blk, *, alpha0,
                       l2, eta=1.0):
    return _newton_steps(psi_blk, alpha, e, w_blk, r1_blk,
                         lambda j: j_blk[j, :][None, :],
                         lambda j: j_blk[j, j],
                         alpha0=alpha0, l2=l2, eta=eta)


def cd_block_sweep_rowpatch_ref(psi_blk, alpha, e, w_blk, r1_blk, p_blk, *,
                                alpha0, l2, eta=1.0):
    """Per-row patch variant: P[r, j, f] patches R'_f after column j moves;
    P[r, f, f] is the per-row R''/2."""
    return _newton_steps(psi_blk, alpha, e, w_blk, r1_blk,
                         lambda j: p_blk[:, j, :],
                         lambda j: p_blk[:, j, j],
                         alpha0=alpha0, l2=l2, eta=eta)


def cd_slab_reduce_ref(psi_blk, alpha, e):
    q = torch.einsum("cmd,cd->cm", psi_blk, alpha * e)
    p = torch.einsum("cmd,cnd->cmn", psi_blk * alpha[:, None, :], psi_blk)
    return q, p


def cd_resid_patch_ref(psi_blk, e, dphi_blk):
    return e + torch.einsum("cm,cmd->cd", dphi_blk, psi_blk)


def gather_psi_blk(psi_tab, ids):
    """(n_src, m) slab + (C, D_pad) ids → (C, m, D_pad) Ψ tile, ids
    clipped to the slab as ``jnp.take(mode="clip")`` does."""
    ids = ids.long().clamp(0, psi_tab.shape[0] - 1)
    return psi_tab[ids].movedim(-1, 1)


def cd_block_sweep_gather_ref(psi_tab, ids, alpha, e, w_blk, r1_blk, j_blk,
                              *, alpha0, l2, eta=1.0):
    return cd_block_sweep_ref(gather_psi_blk(psi_tab, ids), alpha, e, w_blk,
                              r1_blk, j_blk, alpha0=alpha0, l2=l2, eta=eta)


def cd_block_sweep_rowpatch_gather_ref(psi_tab, ids, alpha, e, w_blk, r1_blk,
                                       p_blk, *, alpha0, l2, eta=1.0):
    return cd_block_sweep_rowpatch_ref(
        gather_psi_blk(psi_tab, ids), alpha, e, w_blk, r1_blk, p_blk,
        alpha0=alpha0, l2=l2, eta=eta)


def cd_slab_reduce_gather_ref(psi_tab, ids, alpha, e):
    return cd_slab_reduce_ref(gather_psi_blk(psi_tab, ids), alpha, e)


def cd_resid_patch_gather_ref(psi_tab, ids, e, dphi_blk):
    return cd_resid_patch_ref(gather_psi_blk(psi_tab, ids), e, dphi_blk)
