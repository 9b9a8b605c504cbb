"""Minimal residual, the multigrid smoother: a fixed number of steps

    x += ω <Ar, r>/<Ar, Ar> r,   r -= ω <Ar, r>/<Ar, Ar> Ar

with ω = 0.85, the reference's production relaxation.  A smoother runs
an exact step count, so there is no stopping test and no host sync.
A call is the span ``mr`` (``utils.profiling``).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from quda_qkxtm_multigrid_tpu_torch.ops.blas import cDotProduct
from quda_qkxtm_multigrid_tpu_torch.solvers.support import summed
from quda_qkxtm_multigrid_tpu_torch.utils.profiling import spanned


@spanned("mr")
def mr(matvec: Callable, b: torch.Tensor, x0: Optional[torch.Tensor] = None,
       niter: int = 4, omega: float = 0.85,
       allreduce: Optional[Callable] = None) -> torch.Tensor:
    """``niter`` MR steps on A x = b from ``x0`` (zero if not given).
    ``allreduce`` sums a step's two reductions, as one vector, over the
    ranks of a sharded field (``parallel.mesh.TMesh.allreduce``)."""
    x = torch.zeros_like(b) if x0 is None else x0
    r = b if x0 is None else b - matvec(x)
    for _ in range(niter):
        ar = matvec(r)
        # a step needs |Ar|² to be a normal number: below it (a residual
        # of ~1e-19 in float32, behind a near-exact coarser level) the
        # quotient overflows, and the step is skipped
        d, num = summed(allreduce, cDotProduct(ar, ar), cDotProduct(ar, r))
        d = d.real
        alpha = torch.where(d > torch.finfo(d.dtype).tiny, num / d,
                            torch.zeros_like(r.flatten()[0]))
        alpha = omega * alpha
        x = x + alpha * r
        r = r - alpha * ar
    return x
