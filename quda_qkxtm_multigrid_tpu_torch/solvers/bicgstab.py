"""BiCGstab on the non-hermitian operator M (no normal equations): the
null-vector solver of the multigrid setup when the operator has no
fused multi-source chain, the ``invert`` solver "bicgstab", and the
mixed-precision form ``bicgstab_mixed`` (BASELINE parity config 2).

A Python loop over eager PyTorch ops; the stopping test reads |r|² on
the host once per iteration.  The scalars are complex: on complex fields
the products are plain ones; a real field is a planar-channel field
(the only real fields of this package), which takes the channel forms
``ops.blas.cDotProduct_ch`` / ``cscale_ch``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from quda_qkxtm_multigrid_tpu_torch.ops.blas import (
    cDotProduct, cDotProduct_ch, cscale_ch, norm2)
from quda_qkxtm_multigrid_tpu_torch.solvers.support import (
    ReliableStats, defect_correction, summed)


class BiCGStabResult(NamedTuple):
    x: torch.Tensor
    iters: int
    r2: torch.Tensor       # final |r|² (0-d)
    stats: Optional[ReliableStats] = None   # of the mixed-precision solver


def _scale(a, v: torch.Tensor) -> torch.Tensor:
    return a * v


def bicgstab(matvec: Callable, b: torch.Tensor,
             x0: Optional[torch.Tensor] = None, tol: float = 1e-10,
             maxiter: int = 1000,
             allreduce: Optional[Callable] = None) -> BiCGStabResult:
    """Solve M x = b; stops on |r|² ≤ tol²|b|² or after ``maxiter``.
    On a real (planar-channel) b the complex products are the channel
    forms.  ``allreduce`` sums each reduction over the ranks of a
    sharded field (``parallel.mesh.TMesh.allreduce``; ω's two dots as
    one vector); None leaves them local."""
    dot, scale = ((cDotProduct, _scale) if b.is_complex()
                  else (cDotProduct_ch, cscale_ch))
    red = (lambda v: v) if allreduce is None else allreduce
    if x0 is None:
        x = torch.zeros_like(b)
        r = b
    else:
        x = x0
        r = b - matvec(x0)
    r0 = r                                   # shadow residual
    target = (tol * tol) * red(norm2(b))
    rho = alpha = omega = 1.0
    p = torch.zeros_like(b)
    v = torch.zeros_like(b)
    r2 = red(norm2(r))
    k = 0
    while k < maxiter and bool(r2 > target):
        rho_new = red(dot(r0, r))
        beta = (rho_new / rho) * (alpha / omega)
        p = r + scale(beta, p - scale(omega, v))
        v = matvec(p)
        alpha = rho_new / red(dot(r0, v))
        s = r - scale(alpha, v)
        t = matvec(s)
        ts, tt = summed(allreduce, dot(t, s), dot(t, t))
        omega = ts / tt
        x = x + scale(alpha, p) + scale(omega, s)
        r = s - scale(omega, t)
        rho = rho_new
        r2 = red(norm2(r))
        k += 1
    return BiCGStabResult(x, k, r2)


def bicgstab_mixed(matvec_hi: Callable, matvec_lo: Callable,
                   b: torch.Tensor, tol: float = 1e-10, maxiter: int = 2000,
                   inner_tol: float = 1e-3, inner_maxiter: int = 300,
                   lo_dtype: torch.dtype = torch.complex64,
                   max_restarts: int = 20, max_res_increase: int = 1,
                   max_res_increase_total: int = 10) -> BiCGStabResult:
    """Mixed-precision BiCGstab: a sloppy inner BiCGstab on
    ``matvec_lo`` in ``lo_dtype`` inside high-precision
    defect-correction restarts on ``matvec_hi`` (BASELINE parity
    config 2; reference lib/inv_bicgstab_quda.cpp:240-320), with
    ``cg_mixed``'s restart loop and residual-increase counters
    (``support.defect_correction``).  ``iters`` sums the inner
    iterations, and ``maxiter`` caps that sum (the JAX package takes
    ``maxiter`` and does not use it)."""
    x, r2, iters, stats = defect_correction(
        matvec_hi,
        lambda r, cap: bicgstab(matvec_lo, r, tol=inner_tol,
                                maxiter=min(inner_maxiter, cap)),
        b, lo_dtype, tol, maxiter, max_restarts, max_res_increase,
        max_res_increase_total)
    return BiCGStabResult(x, iters, r2, stats)
