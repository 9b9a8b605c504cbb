"""Multi-shift CG: (A + σ_i) x_i = b for every shift in one Krylov pass
(reference lib/inv_multi_cg_quda.cpp:157, entry invertMultiShiftQuda
interface_quda.cpp:2913), the JAX package's ``solvers/multishift.py``.

The shifted systems follow the σ = 0 base system through the ζ
recurrences; the shift axis is the leading axis of one tensor
[n_shift, ...field], so each per-shift update is one broadcast
multiply-add.  The ζ of a large shift shrinks about geometrically with
the iterations, and in single precision it underflows within a few tens
of them, after which α_σ = α ζ_new / ζ is 0/0.  The reference stops
updating a shift once its residual ζ|r| meets the target; so does this
port, through a mask on the device: a shift whose |ζ|²|r|² ≤ tol²|b|²
keeps its x, p and ζ from then on (the JAX function updates every shift to the end,
and its single-precision result turns NaN where ζ underflows).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import torch

from quda_qkxtm_multigrid_tpu_torch.ops.blas import norm2, reDotProduct
from quda_qkxtm_multigrid_tpu_torch.solvers.cg import cg


class MultiShiftResult(NamedTuple):
    x: torch.Tensor       # [n_shift, ...field]
    iters: int
    r2: torch.Tensor      # base-system |r|² (0-d)


class RefinedMultiShiftResult(NamedTuple):
    x: torch.Tensor          # [n_shift, ...field] refined solutions
    iters: int               # iterations of the shifted pass
    refine_iters: list       # each shift's refinement CG iterations
    r2: torch.Tensor         # [n_shift] each shift's final |r|²


def multishift_cg(matvec: Callable, b: torch.Tensor, shifts: Sequence[float],
                  tol: float = 1e-10, maxiter: int = 1000) -> MultiShiftResult:
    """``matvec`` applies the base operator A (σ = 0; the caller may fold
    the smallest shift into A, as the reference's caller does).  Stops
    when the base system's |r|² ≤ tol²|b|² or after ``maxiter``."""
    n = len(shifts)
    lead = (n,) + (1,) * b.dim()
    sig = torch.tensor(list(shifts), dtype=b.dtype, device=b.device)
    r2 = norm2(b)
    target = (tol * tol) * r2
    x = torch.zeros((n,) + tuple(b.shape), dtype=b.dtype, device=b.device)
    p_s = b.expand((n,) + tuple(b.shape)).clone()
    r, p = b, b
    zeta = torch.ones(n, dtype=b.dtype, device=b.device)
    zeta_old = torch.ones_like(zeta)
    beta_old = torch.zeros((), dtype=b.dtype, device=b.device)
    alpha_old = torch.ones((), dtype=b.dtype, device=b.device)
    active = torch.ones(n, dtype=torch.bool, device=b.device)
    k = 0
    while k < maxiter and bool(r2 > target):
        # a shift whose own residual meets the target stops for good
        active &= (zeta.real ** 2 + zeta.imag ** 2) * r2 > target
        ap = matvec(p)
        alpha = (r2 / reDotProduct(p, ap)).to(b.dtype)   # base step (> 0)
        # the shifted ζ recurrence (reference inv_multi_cg_quda.cpp:60-80)
        zeta_new = (zeta * zeta_old * alpha_old) / (
            alpha * beta_old * (zeta_old - zeta)
            + zeta_old * alpha_old * (1.0 + sig * alpha))
        zeta_new = torch.where(active, zeta_new, zeta)
        alpha_s = torch.where(active, alpha * zeta_new / zeta, 0.0)
        x = x + alpha_s.reshape(lead) * p_s
        r = r - alpha * ap
        r2_new = norm2(r)
        beta = (r2_new / r2).to(b.dtype)
        beta_s = beta * (zeta_new * alpha_s) / (zeta * alpha)
        p = r + beta * p
        p_s = torch.where(active.reshape(lead),
                          zeta_new.reshape(lead) * r[None]
                          + beta_s.reshape(lead) * p_s, p_s)
        zeta_old = torch.where(active, zeta, zeta_old)
        zeta = zeta_new
        beta_old, alpha_old, r2 = beta, alpha, r2_new
        k += 1
    return MultiShiftResult(x, k, r2)


def multishift_cg_refined(matvec: Callable, b: torch.Tensor,
                          shifts: Sequence[float], tol: float = 1e-10,
                          maxiter: int = 1000, refine_tol: float | None = None,
                          refine_maxiter: int = 500) -> RefinedMultiShiftResult:
    """The shifted pass, then a CG on each (A + σ_i) from the pass's
    solution to ``refine_tol`` (``tol`` if None): the reference's
    per-offset refinement (interface_quda.cpp:3083-3112, with
    use_init_guess)."""
    base = multishift_cg(matvec, b, shifts, tol=tol, maxiter=maxiter)
    rtol = tol if refine_tol is None else refine_tol
    xs, its, r2s = [], [], []
    for sigma, x0 in zip(shifts, base.x):
        res = cg(lambda v, s=float(sigma): matvec(v) + s * v, b, x0=x0,
                 tol=rtol, maxiter=refine_maxiter)
        xs.append(res.x)
        its.append(res.iters)
        r2s.append(res.r2)
    return RefinedMultiShiftResult(torch.stack(xs), base.iters, its,
                                   torch.stack(r2s))
