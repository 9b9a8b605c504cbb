"""Field BLAS used by cg and invert, with QUDA's names.

Reductions return 0-d real tensors on the field's device, so a solver
decides where it synchronises with the host.  They work on complex
fields and on real planar-channel fields alike; ``cDotProduct_ch`` and
``cscale_ch`` give a planar-channel field (channel axis -3, channel
a*2 + re/im, see ``ops/dslash_kernel``) the complex inner product and
complex scaling of the field it stands for.
"""

from __future__ import annotations

import torch


def norm2(x: torch.Tensor) -> torch.Tensor:
    """|x|² as a real 0-d tensor."""
    return torch.vdot(x.reshape(-1), x.reshape(-1)).real


def cDotProduct(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """<x, y> = Σ conj(x) y as a 0-d tensor."""
    return torch.vdot(x.reshape(-1), y.reshape(-1))


def reDotProduct(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Re <x, y> as a real 0-d tensor."""
    return torch.vdot(x.reshape(-1), y.reshape(-1)).real


def axpy(a, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """y += a*x in place (a a number or a 0-d tensor); returns y."""
    return y.add_(x * a)


def xpay(x: torch.Tensor, a, y: torch.Tensor) -> torch.Tensor:
    """y = x + a*y in place; returns y."""
    return y.mul_(a).add_(x)


def _ri(x: torch.Tensor):
    """(re, im) views of a planar-channel field [..., 2k, Z, W]."""
    v = x.unflatten(-3, (-1, 2))
    return v[..., 0, :, :], v[..., 1, :, :]


def cDotProduct_ch(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """<x, y> of the complex fields that two planar-channel fields stand
    for, as a complex 0-d tensor."""
    xr, xi = _ri(x)
    yr, yi = _ri(y)
    re = torch.vdot(x.reshape(-1), y.reshape(-1))
    im = (xr * yi).sum() - (xi * yr).sum()
    return torch.complex(re, im)


def cscale_ch(a, x: torch.Tensor) -> torch.Tensor:
    """The complex number ``a`` (a 0-d tensor or a Python number) times
    the complex field that the planar-channel field ``x`` stands for."""
    a = torch.as_tensor(a, device=x.device)
    ar, ai = (a.real, a.imag) if a.is_complex() else (a, torch.zeros_like(a))
    xr, xi = _ri(x)
    return torch.stack([ar * xr - ai * xi, ar * xi + ai * xr],
                       dim=-3).reshape(x.shape)
