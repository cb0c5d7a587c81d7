"""Plain PyTorch version of the Gram kernel (port of
``repro.kernels.gram.ref``): J = xᵀx, or xᵀ·diag(w)·x, in fp32."""
import torch


def gram_ref(x: torch.Tensor, weights=None) -> torch.Tensor:
    xf = x.float()
    if weights is None:
        return xf.T @ xf
    return xf.T @ (xf * weights.float()[:, None])
