"""Pipelined conjugate gradient: one reduction point an iteration (the
JAX package's ``solvers/pipelined.py``; the reference's ``pipeline``
knob, include/quda.h:130, "trade extra flops for fewer global sums").

The Ghysels-Vanroose recurrence carries w = A r, s = A p and z = A s, so
the two dependent reductions of classic CG become one:

    β = γ/γ_old                    α = γ / (δ − β γ / α_old)
    m = A w
    p = r + β p;  s = w + β s;  z = m + β z
    x += α p;     r −= α s;     w −= α z
    (γ, δ) = (<r,r>, <w,r>)        ← the one reduction

Here r, w, m share one buffer [3, ...field] and p, s, z another, so the
three updates of each line are one operation each, and (γ, δ) is one
matrix-vector product of [r; w]† with r whose two numbers reach the host
in one read; α and β are then host numbers.  Same matvec count as
classic CG.  The round-off drift of the extra recurrences is absorbed by
the defect-correction restarts of ``pipelined_cg_reliable``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from quda_qkxtm_multigrid_tpu_torch.ops.blas import norm2
from quda_qkxtm_multigrid_tpu_torch.solvers.cg import CGResult
from quda_qkxtm_multigrid_tpu_torch.solvers.support import defect_correction


def _gamma_delta(rwm: torch.Tensor):
    """(<r,r>, <w,r>) of the buffer's rows r = rwm[0], w = rwm[1], from
    one matrix-vector product and one read: (real, complex)."""
    rw = rwm[:2].reshape(2, -1)
    g, d = torch.mv(rw, rw[0].conj()).conj().tolist()
    return g.real, d


def pipelined_cg(matvec: Callable, b: torch.Tensor,
                 x0: Optional[torch.Tensor] = None, tol: float = 1e-10,
                 maxiter: int = 1000,
                 abs_b2: Optional[torch.Tensor] = None) -> CGResult:
    """Solve A x = b, A hermitian positive definite, with one reduction
    an iteration (Ghysels & Vanroose 2014, Alg. 3).  Stops on
    |r|² ≤ tol²|b|² or after ``maxiter`` iterations."""
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    rwm = torch.empty((3,) + tuple(b.shape), dtype=b.dtype, device=b.device)
    rwm[0] = b if x0 is None else b - matvec(x0)
    rwm[1] = matvec(rwm[0])
    psz = torch.zeros_like(rwm)
    target = (tol * tol) * float(norm2(b) if abs_b2 is None else abs_b2)
    gamma, delta = _gamma_delta(rwm)
    gamma_old = alpha_old = 1.0
    k = 0
    while gamma > target and k < maxiter:
        if k == 0:
            beta, alpha = 0.0, gamma / delta
        else:
            beta = gamma / gamma_old
            alpha = gamma / (delta - beta * gamma / alpha_old)
        rwm[2] = matvec(rwm[1])              # the only matvec
        psz.mul_(beta).add_(rwm)             # p, s, z
        x.add_(psz[0], alpha=alpha)
        rwm[:2].add_(psz[1:], alpha=-alpha)  # r, w
        gamma_old, alpha_old = gamma, alpha
        gamma, delta = _gamma_delta(rwm)
        k += 1
    return CGResult(x, k, torch.tensor(gamma, dtype=b.real.dtype,
                                       device=b.device))


def pipelined_cg_reliable(matvec_hi: Callable, matvec_lo: Callable,
                          b: torch.Tensor, tol: float = 1e-10,
                          maxiter: int = 2000, inner_tol: float = 1e-3,
                          inner_maxiter: int = 500,
                          lo_dtype: torch.dtype = torch.complex64,
                          max_restarts: int = 20) -> CGResult:
    """Pipelined CG in ``lo_dtype`` on ``matvec_lo`` inside
    high-precision defect-correction restarts on ``matvec_hi`` (the
    reliable-update discipline, reference inv_cg_quda.cpp:207-311), the
    loop of ``support.defect_correction`` with its residual-increase
    counters out of reach (at most ``max_restarts`` increases, as the
    JAX function has no counters).  ``iters`` sums the inner iterations,
    and ``maxiter`` caps that sum (the JAX package takes ``maxiter`` and
    does not use it)."""
    x, r2, iters, stats = defect_correction(
        matvec_hi,
        lambda r, cap: pipelined_cg(matvec_lo, r, tol=inner_tol,
                                    maxiter=min(inner_maxiter, cap)),
        b, lo_dtype, tol, maxiter, max_restarts, max_restarts, max_restarts)
    return CGResult(x, iters, r2, stats)
