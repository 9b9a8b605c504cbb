"""Minimal residual, the multigrid smoother: a fixed number of steps

    x += ω <Ar, r>/<Ar, Ar> r,   r -= ω <Ar, r>/<Ar, Ar> Ar

with ω = 0.85, the reference's production relaxation.  A smoother runs
an exact step count, so there is no stopping test and no host sync.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from quda_qkxtm_multigrid_tpu_torch.ops.blas import cDotProduct


def mr(matvec: Callable, b: torch.Tensor, x0: Optional[torch.Tensor] = None,
       niter: int = 4, omega: float = 0.85) -> torch.Tensor:
    x = torch.zeros_like(b) if x0 is None else x0
    r = b if x0 is None else b - matvec(x)
    for _ in range(niter):
        ar = matvec(r)
        # a step needs |Ar|² to be a normal number: below it (a residual
        # of ~1e-19 in float32, behind a near-exact coarser level) the
        # quotient overflows, and the step is skipped
        d = cDotProduct(ar, ar).real
        alpha = torch.where(d > torch.finfo(d.dtype).tiny,
                            cDotProduct(ar, r) / d,
                            torch.zeros_like(r.flatten()[0]))
        alpha = omega * alpha
        x = x + alpha * r
        r = r - alpha * ar
    return x
