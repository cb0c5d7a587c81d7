"""The fused CD column update (port of ``repro.kernels.cd_update``).

As in the reference, it is not a kernel of its own: the block sweep at
k_b = 1 is this program, so :func:`cd_column_update` is one k_b = 1 launch
of ``cd_sweep.ops.cd_block_sweep`` (counted there). ``e`` is updated in
place; callers rebind."""
from __future__ import annotations

import torch

from repro_torch.kernels.cd_sweep.ops import cd_block_sweep


def cd_column_update(psi, alpha, e, w_col, r1, jff, *, alpha0, l2, eta=1.0,
                     weights=None):
    """One Newton column step over the padded layout: ``psi``, ``alpha``,
    ``e`` are (C, D_pad), ``w_col`` and ``r1`` (C,), ``jff`` = J(f,f).
    Returns ``(w_col_new (C,), e)``."""
    jff = torch.as_tensor(jff, dtype=torch.float32, device=e.device)
    w_new, e = cd_block_sweep(
        psi[:, None, :], alpha, e, w_col[:, None], r1[:, None],
        jff.reshape(1, 1), alpha0=alpha0, l2=l2, eta=eta, weights=weights)
    return w_new[:, 0], e
