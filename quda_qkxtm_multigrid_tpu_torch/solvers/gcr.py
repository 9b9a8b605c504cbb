"""Flexible GCR with right preconditioning: the outer solver of the
multigrid runs and the coarse-level solver inside the V-cycle.

``gcr_cycle`` is one fixed-length cycle of n_krylov directions: each
direction is K(r) for the preconditioner K (which may be nonlinear, an
MG V-cycle), orthogonalised by modified Gram-Schmidt against the earlier
ones.  It needs no host sync.  ``gcr`` restarts cycles until
|b − M x|² ≤ tol²|b|², recomputing the true residual at each restart and
reading it on the host once per restart.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from quda_qkxtm_multigrid_tpu_torch.ops.blas import cDotProduct, norm2


class GCRResult(NamedTuple):
    x: torch.Tensor
    iters: int             # n_krylov per cycle run
    r2: torch.Tensor       # final |b − M x|² (0-d)


def gcr_cycle(matvec: Callable, b: torch.Tensor, n_krylov: int = 10,
              precond: Optional[Callable] = None,
              x0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One GCR(n_krylov) cycle from ``x0`` (zero if not given); returns x.

    A direction that orthogonalisation annihilates (|v|² below eps² of
    its norm before, eps² = 1e-10 in single precision, 1e-24 in double)
    is skipped instead of amplifying round-off, and so is one whose |v|²
    is below the smallest normal number."""
    if precond is None:
        precond = lambda r: r        # noqa: E731
    x = torch.zeros_like(b) if x0 is None else x0
    r = b if x0 is None else b - matvec(x)
    single = b.dtype in (torch.complex64, torch.float32)
    eps2 = 1e-10 if single else 1e-24
    # a direction needs |v|² to be a normal number too (a residual below
    # ~1e-19 in single precision): 1/|v| would overflow or mis-normalise
    tiny = torch.finfo(torch.float32 if single else torch.float64).tiny
    zs, vs = [], []
    for _ in range(n_krylov):
        z = precond(r)
        v = matvec(z)
        v0n2 = norm2(v)
        for zj, vj in zip(zs, vs):
            c = cDotProduct(vj, v)
            z = z - c * zj
            v = v - c * vj
        vnorm2 = norm2(v)
        inv = torch.where((vnorm2 > eps2 * v0n2) & (vnorm2 > tiny),
                          1.0 / torch.sqrt(torch.clamp(vnorm2, min=tiny)),
                          torch.zeros_like(vnorm2)).to(b.dtype)
        z = z * inv
        v = v * inv
        alpha = cDotProduct(v, r)
        x = x + alpha * z
        r = r - alpha * v
        zs.append(z)
        vs.append(v)
    return x


def gcr(matvec: Callable, b: torch.Tensor, x0: Optional[torch.Tensor] = None,
        tol: float = 1e-10, n_krylov: int = 10, max_restarts: int = 50,
        precond: Optional[Callable] = None) -> GCRResult:
    """Restarted GCR(n_krylov) on M x = b.  ``precond`` maps r to an
    approximation of M⁻¹ r."""
    x = torch.zeros_like(b) if x0 is None else x0
    r = b if x0 is None else b - matvec(x)
    target = (tol * tol) * norm2(b)
    iters = 0
    for _ in range(max_restarts):
        if not bool(norm2(r) > target):
            break
        x = gcr_cycle(matvec, r, n_krylov, precond) + x
        # the recursed residual drifts in single precision: recompute it
        r = b - matvec(x)
        iters += n_krylov
    return GCRResult(x, iters, norm2(r))
