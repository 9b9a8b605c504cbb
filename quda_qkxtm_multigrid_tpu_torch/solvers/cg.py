"""Conjugate gradient on a hermitian positive-definite operator, and its
mixed-precision form ``cg_mixed`` (a sloppy inner CG inside
high-precision defect-correction restarts).

A Python loop over eager PyTorch ops: the stopping test reads |r|² on
the host, so each iteration synchronises with the device once.  Works
on complex fields and on real planar-channel fields alike.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from quda_qkxtm_multigrid_tpu_torch.ops.blas import (
    axpy, norm2, reDotProduct, xpay)
from quda_qkxtm_multigrid_tpu_torch.solvers.support import (
    ReliableStats, defect_correction, heavy_quark_residual_sq)


class CGResult(NamedTuple):
    x: torch.Tensor
    iters: int             # iterations used
    r2: torch.Tensor       # final |r|² of the solved system (0-d)
    stats: Optional[ReliableStats] = None   # of the mixed-precision solver


def cg(matvec: Callable, b: torch.Tensor, x0: Optional[torch.Tensor] = None,
       tol: float = 1e-10, maxiter: int = 1000,
       abs_b2: Optional[torch.Tensor] = None,
       allreduce: Optional[Callable] = None,
       tol_hq: Optional[float] = None) -> CGResult:
    """Solve A x = b, A hermitian positive definite.

    Stops on |r|² ≤ tol²·|b|² or after ``maxiter`` iterations; ``iters``
    counts the matvecs of the loop, as the JAX package counts them.
    With ``tol_hq`` the heavy-quark residual hq(x, r) must also fall
    below it (both conditions of the bitmask, quda.h:252-260; fields in
    the canonical complex layout [..., 4, 3, T, Z, W]); the two tests
    reach the host in one read.  ``allreduce`` sums each local reduction
    over the ranks of a sharded field (``parallel.mesh.TMesh.allreduce``);
    None leaves them local."""
    if tol_hq is not None and allreduce is not None:
        raise ValueError("tol_hq has no sharded form: its site mean would "
                         "stay on this rank's box")
    red = (lambda v: v) if allreduce is None else allreduce
    if x0 is None:
        x = torch.zeros_like(b)
        r = b.clone()
    else:
        x = x0.clone()
        r = b - matvec(x0)
    b2 = red(norm2(b)) if abs_b2 is None else abs_b2
    target = (tol * tol) * b2
    r2 = red(norm2(r))
    p = r.clone()
    k = 0

    def not_done(r2):
        if tol_hq is None:
            return bool(r2 > target)
        return bool((r2 > target)
                    | (heavy_quark_residual_sq(x, r) > tol_hq * tol_hq))

    while k < maxiter and not_done(r2):
        ap = matvec(p)
        alpha = r2 / red(reDotProduct(p, ap))
        axpy(alpha, p, x)
        axpy(-alpha, ap, r)
        r2_new = red(norm2(r))
        xpay(r, r2_new / r2, p)
        r2 = r2_new
        k += 1
    return CGResult(x, k, r2)


def cg_mixed(matvec_hi: Callable, matvec_lo: Callable, b: torch.Tensor,
             tol: float = 1e-10, maxiter: int = 2000,
             inner_tol: float = 1e-3, inner_maxiter: int = 500,
             lo_dtype: torch.dtype = torch.complex64, max_restarts: int = 20,
             max_res_increase: int = 1,
             max_res_increase_total: int = 10,
             allreduce: Optional[Callable] = None) -> CGResult:
    """Mixed-precision CG: a sloppy inner CG on ``matvec_lo`` in
    ``lo_dtype`` to ``inner_tol``, inside high-precision defect-correction
    restarts on ``matvec_hi`` in b's precision (the role of matSloppy and
    reliable updates, reference inv_cg_quda.cpp:207-311).  The restart
    loop and its residual-increase counters are
    ``support.defect_correction``; ``stats.diverged`` reports a stop at
    the sloppy operator's precision floor.  ``iters`` sums the inner
    iterations, and ``maxiter`` caps that sum (the JAX package takes
    ``maxiter`` and does not use it).  ``allreduce`` sums the reductions
    of both loops over the ranks of a sharded field."""
    x, r2, iters, stats = defect_correction(
        matvec_hi,
        lambda r, cap: cg(matvec_lo, r, tol=inner_tol,
                          maxiter=min(inner_maxiter, cap),
                          allreduce=allreduce),
        b, lo_dtype, tol, maxiter, max_restarts, max_res_increase,
        max_res_increase_total, allreduce)
    return CGResult(x, iters, r2, stats)
