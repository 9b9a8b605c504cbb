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
from quda_qkxtm_multigrid_tpu_torch.solvers.support import summed


class GCRResult(NamedTuple):
    x: torch.Tensor
    iters: int             # n_krylov per cycle run
    r2: torch.Tensor       # final |b − M x|² (0-d)


def gcr_cycle(matvec: Callable, b: torch.Tensor, n_krylov: int = 10,
              precond: Optional[Callable] = None,
              x0: Optional[torch.Tensor] = None,
              allreduce: Optional[Callable] = None) -> torch.Tensor:
    """One GCR(n_krylov) cycle from ``x0`` (zero if not given); returns x.

    A direction that orthogonalisation annihilates (|v|² below eps² of
    its norm before, eps² = 1e-10 in single precision, 1e-24 in double)
    is skipped instead of amplifying round-off, and so is one whose |v|²
    is below the smallest normal number.

    ``allreduce`` sums the reductions over the ranks of a sharded field
    (``parallel.mesh.TMesh.allreduce``), those of one direction that do
    not wait on each other as one vector: |v|² with the first
    projection, each further projection of the modified Gram-Schmidt on
    its own, and the orthogonalised |v|² with <v, r> (α is then
    <v, r>/|v| rather than <v/|v|, r>)."""
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
        if allreduce is None:
            v0n2 = norm2(v)
            for zj, vj in zip(zs, vs):
                c = cDotProduct(vj, v)
                z = z - c * zj
                v = v - c * vj
            vnorm2 = norm2(v)
        else:
            if vs:
                v0n2, c = summed(allreduce, norm2(v), cDotProduct(vs[0], v))
            else:
                (v0n2,) = summed(allreduce, norm2(v))
            for j, (zj, vj) in enumerate(zip(zs, vs)):
                if j > 0:
                    c = allreduce(cDotProduct(vj, v))
                z = z - c * zj
                v = v - c * vj
            vnorm2, vr = summed(allreduce, norm2(v), cDotProduct(v, r))
        inv = torch.where((vnorm2 > eps2 * v0n2) & (vnorm2 > tiny),
                          1.0 / torch.sqrt(torch.clamp(vnorm2, min=tiny)),
                          torch.zeros_like(vnorm2)).to(b.dtype)
        z = z * inv
        v = v * inv
        alpha = cDotProduct(v, r) if allreduce is None else inv * vr
        x = x + alpha * z
        r = r - alpha * v
        zs.append(z)
        vs.append(v)
    return x


def gcr(matvec: Callable, b: torch.Tensor, x0: Optional[torch.Tensor] = None,
        tol: float = 1e-10, n_krylov: int = 10, max_restarts: int = 50,
        precond: Optional[Callable] = None,
        allreduce: Optional[Callable] = None) -> GCRResult:
    """Restarted GCR(n_krylov) on M x = b.  ``precond`` maps r to an
    approximation of M⁻¹ r.  ``allreduce`` sums every reduction over the
    ranks of a sharded field (``gcr_cycle``)."""
    red = (lambda v: v) if allreduce is None else allreduce
    x = torch.zeros_like(b) if x0 is None else x0
    r = b if x0 is None else b - matvec(x)
    target = (tol * tol) * red(norm2(b))
    iters = 0
    r2 = red(norm2(r))
    for _ in range(max_restarts):
        if not bool(r2 > target):
            break
        x = gcr_cycle(matvec, r, n_krylov, precond,
                      allreduce=allreduce) + x
        # the recursed residual drifts in single precision: recompute it
        r = b - matvec(x)
        r2 = red(norm2(r))
        iters += n_krylov
    return GCRResult(x, iters, r2)
