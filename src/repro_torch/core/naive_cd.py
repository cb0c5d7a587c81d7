"""Conventional CD over the FULL implicit matrix, the paper's strawman
(port of ``repro.core.naive_cd``).

This is the O(|C||I|k) per-epoch solver of §3.2 applied directly to
``S_impl`` (eq. 5): every context-item cell, including all zeros, enters
the loss. It exists for two reasons:

1. **Exactness oracle**: iCD (Lemma 1 + Lemma 2) must produce the same
   parameter trajectories: same init, same sweep order ⇒ same Newton
   steps (``tests/test_torch_foldin.py`` holds ``mf.epoch`` to it).
2. **Figure 8**: the cost gap between conventional CD and iCD, from the
   FLOP counts of the two implementations.

Only feasible for tiny |C|, |I|. Matrix products run in full fp32.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import sweeps
from repro_torch.core.gram import full_fp32
from repro_torch.core.models.mf import MFHyperParams, MFParams
from repro_torch.kernels import resolve_device


def dense_from_observed(ctx, item, y, alpha, n_ctx: int, n_items: int,
                        alpha0: float, *, device=None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Materialize (Y, A) of S_impl: zeros with confidence α₀ everywhere
    except the observed cells (y with confidence α). On the device of ``y``
    when it is a tensor; host data goes to ``device``, CUDA unless the
    caller names the CPU."""
    dev = (y.device if isinstance(y, torch.Tensor) and device is None
           else resolve_device(device))
    y = torch.as_tensor(y, dtype=torch.float32, device=dev)
    ctx = torch.as_tensor(ctx, dtype=torch.long, device=dev)
    item = torch.as_tensor(item, dtype=torch.long, device=dev)
    y_dense = torch.zeros((n_ctx, n_items), dtype=torch.float32, device=dev)
    y_dense[ctx, item] = y
    a_dense = torch.full((n_ctx, n_items), float(alpha0), dtype=torch.float32,
                         device=dev)
    a_dense[ctx, item] = torch.as_tensor(alpha, dtype=torch.float32, device=dev)
    return y_dense, a_dense


def epoch_dense(params: MFParams, y_dense: torch.Tensor, a_dense: torch.Tensor,
                hp: MFHyperParams) -> MFParams:
    """One conventional-CD epoch on the dense objective, with the same
    column-major sweep order as ``repro_torch.core.models.mf.epoch``."""
    w, h = params.w.clone(), params.h.clone()
    with full_fp32():
        for f in range(w.shape[1]):
            err = w @ h.T - y_dense                  # (C, I): the O(|C||I|) part
            h_col, w_col = h[:, f], w[:, f]
            num = (a_dense * err) @ h_col + hp.l2 * w_col
            den = a_dense @ (h_col * h_col) + hp.l2
            sweeps.put_col(w, f, w_col - hp.eta * num / den)
        for f in range(h.shape[1]):
            err = w @ h.T - y_dense
            w_col, h_col = w[:, f], h[:, f]
            num = (a_dense * err).T @ w_col + hp.l2 * h_col
            den = a_dense.T @ (w_col * w_col) + hp.l2
            sweeps.put_col(h, f, h_col - hp.eta * num / den)
    return MFParams(w, h)


def epoch_dense_mfsi(params, x_dense, z_dense, field_slices,
                     field_slices_item, y_dense, a_dense, hp):
    """Conventional CD for MFSI on the dense implicit matrix, sweeping in
    the same order as ``repro_torch.core.models.mfsi.epoch`` (dim-major,
    fields sequential, one-hot features vectorized). ``x_dense`` (C, p)
    and ``z_dense`` (I, p') are the materialized designs; ``field_slices``
    the (offset, vocab) of each context field, ``field_slices_item`` of
    each item field. Oracle for exactness tests."""
    w, h = params.w.clone(), params.h.clone()
    with full_fp32():
        for f in range(w.shape[1]):
            for off, voc in field_slices:
                x_g = x_dense[:, off:off + voc]
                err = (x_dense @ w) @ (z_dense @ h).T - y_dense
                psi_col = z_dense @ h[:, f]
                num = x_g.T @ ((a_dense * err) @ psi_col) + hp.l2 * w[off:off + voc, f]
                den = (x_g * x_g).T @ (a_dense @ (psi_col * psi_col)) + hp.l2
                w[off:off + voc, f] -= hp.eta * num / torch.clamp(den, min=1e-12)
        for f in range(h.shape[1]):
            for off, voc in field_slices_item:
                z_g = z_dense[:, off:off + voc]
                err = (x_dense @ w) @ (z_dense @ h).T - y_dense
                phi_col = x_dense @ w[:, f]
                num = z_g.T @ ((a_dense * err).T @ phi_col) + hp.l2 * h[off:off + voc, f]
                den = (z_g * z_g).T @ (a_dense.T @ (phi_col * phi_col)) + hp.l2
                h[off:off + voc, f] -= hp.eta * num / torch.clamp(den, min=1e-12)
    return type(params)(w, h)


def flops_per_epoch_dense(n_ctx: int, n_items: int, k: int) -> float:
    """Conventional CD: each of the 2k column updates recomputes the dense
    error (|C||I|k) and reduces over |C||I|. ≈ 2k·(|C||I|(k+4))."""
    return 2.0 * k * (n_ctx * n_items * (k + 4.0))


def flops_per_epoch_icd(n_ctx: int, n_items: int, nnz: int, k: int) -> float:
    """iCD (paper §5.1): O((|C|+|I|)k² + |S|k) per epoch.
    Grams: (|C|+|I|)k² MACs; sweeps: per column ~6·nnz + (|C|+|I|)·k."""
    return 2.0 * ((n_ctx + n_items) * k * k) + 2.0 * k * (
        6.0 * nnz + (n_ctx + n_items) * k
    )
