"""BiCGstab on the non-hermitian operator M (no normal equations): the
null-vector solver of the multigrid setup when the operator has no
fused multi-source chain.

A Python loop over eager PyTorch ops; the stopping test reads |r|² on
the host once per iteration.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from quda_qkxtm_multigrid_tpu_torch.ops.blas import cDotProduct as _dot
from quda_qkxtm_multigrid_tpu_torch.ops.blas import norm2


class BiCGStabResult(NamedTuple):
    x: torch.Tensor
    iters: int
    r2: torch.Tensor       # final |r|² (0-d)


def bicgstab(matvec: Callable, b: torch.Tensor,
             x0: Optional[torch.Tensor] = None, tol: float = 1e-10,
             maxiter: int = 1000) -> BiCGStabResult:
    """Solve M x = b; stops on |r|² ≤ tol²|b|² or after ``maxiter``."""
    if x0 is None:
        x = torch.zeros_like(b)
        r = b
    else:
        x = x0
        r = b - matvec(x0)
    r0 = r                                   # shadow residual
    target = (tol * tol) * norm2(b)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    rho = alpha = omega = one
    p = torch.zeros_like(b)
    v = torch.zeros_like(b)
    r2 = norm2(r)
    k = 0
    while k < maxiter and bool(r2 > target):
        rho_new = _dot(r0, r)
        beta = (rho_new / rho) * (alpha / omega)
        p = r + beta * (p - omega * v)
        v = matvec(p)
        alpha = rho_new / _dot(r0, v)
        s = r - alpha * v
        t = matvec(s)
        omega = _dot(t, s) / _dot(t, t)
        x = x + alpha * p + omega * s
        r = s - omega * t
        rho = rho_new
        r2 = norm2(r)
        k += 1
    return BiCGStabResult(x, k, r2)
