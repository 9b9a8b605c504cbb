"""Conjugate gradient on a hermitian positive-definite operator.

A Python loop over eager PyTorch ops: the stopping test reads |r|² on
the host, so each iteration synchronises with the device once.  Works
on complex fields and on real planar-channel fields alike.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from quda_qkxtm_multigrid_tpu_torch.ops.blas import (
    axpy, norm2, reDotProduct, xpay)


class CGResult(NamedTuple):
    x: torch.Tensor
    iters: int             # iterations used
    r2: torch.Tensor       # final |r|² of the solved system (0-d)


def cg(matvec: Callable, b: torch.Tensor, x0: Optional[torch.Tensor] = None,
       tol: float = 1e-10, maxiter: int = 1000,
       abs_b2: Optional[torch.Tensor] = None) -> CGResult:
    """Solve A x = b, A hermitian positive definite.

    Stops on |r|² ≤ tol²·|b|² or after ``maxiter`` iterations; ``iters``
    counts the matvecs of the loop, as the JAX package counts them."""
    if x0 is None:
        x = torch.zeros_like(b)
        r = b.clone()
    else:
        x = x0.clone()
        r = b - matvec(x0)
    b2 = norm2(b) if abs_b2 is None else abs_b2
    target = (tol * tol) * b2
    r2 = norm2(r)
    p = r.clone()
    k = 0
    while k < maxiter and bool(r2 > target):
        ap = matvec(p)
        alpha = r2 / reDotProduct(p, ap)
        axpy(alpha, p, x)
        axpy(-alpha, ap, r)
        r2_new = norm2(r)
        xpay(r, r2_new / r2, p)
        r2 = r2_new
        k += 1
    return CGResult(x, k, r2)
