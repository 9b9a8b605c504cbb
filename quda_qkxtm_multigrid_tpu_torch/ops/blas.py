"""Field BLAS used by cg and invert, with QUDA's names.

Reductions return 0-d real tensors on the field's device, so a solver
decides where it synchronises with the host.  They work on complex
fields and on real planar-channel fields alike.
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
