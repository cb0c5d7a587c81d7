"""Plain PyTorch version of the fused CD column update (port of
``repro.kernels.cd_update.ref``)."""
import torch


def cd_column_update_ref(psi, alpha, e, w_col, r1, jff, *, alpha0, l2,
                         eta=1.0):
    lp = torch.sum(alpha * e * psi, dim=1)
    lpp = torch.sum(alpha * psi * psi, dim=1)
    num = lp + alpha0 * r1 + l2 * w_col
    den = lpp + alpha0 * jff + l2
    delta = -eta * num / torch.clamp(den, min=1e-12)
    return w_col + delta, e + delta[:, None] * psi
