"""Steepest descent, the reference's SD solver (reference
include/invert_quda.h:564, lib/inv_sd_quda.cpp), kept for smoother and
sanity duty; its extended-precision form is ``pcg.xsd``.

A Python loop; the stopping test reads |r|² on the host once per
iteration.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from quda_qkxtm_multigrid_tpu_torch.ops.blas import norm2, reDotProduct
from quda_qkxtm_multigrid_tpu_torch.solvers.cg import CGResult


def sd(matvec: Callable, b: torch.Tensor, x0: Optional[torch.Tensor] = None,
       tol: float = 1e-10, maxiter: int = 100) -> CGResult:
    """x ← x + (r·r / r·Ar) r on a hermitian positive-definite operator,
    until |r|² ≤ tol²|b|² or ``maxiter`` steps."""
    x = torch.zeros_like(b) if x0 is None else x0
    r = b if x0 is None else b - matvec(x)
    target = (tol * tol) * norm2(b)
    r2 = norm2(r)
    k = 0
    while k < maxiter and bool(r2 > target):
        ar = matvec(r)
        alpha = (r2 / reDotProduct(r, ar)).to(b.dtype)
        x = x + alpha * r
        r = r - alpha * ar
        r2 = norm2(r)
        k += 1
    return CGResult(x, k, r2)
