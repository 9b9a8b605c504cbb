"""Solver support machinery: stopping conditions, normalisation
conventions, and reliable-update bookkeeping (the JAX package's
``solvers/support.py``).

  - the residual-type bitmask with the Fermilab heavy-quark residual
    (reference include/quda.h:252-260, blas::HeavyQuarkResidualNorm
    lib/reduce_quda.cu:761-790);
  - massRescale's source normalisation conventions
    (lib/interface_quda.cpp:1412-1494, enum_quda.h:191-193);
  - the counters of the reliable-update discipline and the
    defect-correction restart loop around a sloppy inner solve
    (lib/inv_cg_quda.cpp:260-311).
"""

from __future__ import annotations

import enum
from typing import Callable, NamedTuple

import torch

from quda_qkxtm_multigrid_tpu_torch.ops.blas import norm2


class ResidualType(enum.Flag):
    """Stopping-condition bitmask (quda.h QudaResidualType)."""
    L2_RELATIVE = enum.auto()
    L2_ABSOLUTE = enum.auto()
    HEAVY_QUARK = enum.auto()


class MassNormalization(enum.Enum):
    """Source normalisation conventions (enum_quda.h:191-193)."""
    KAPPA = "kappa"
    MASS = "mass"
    ASYMMETRIC_MASS = "asymmetric-mass"


def heavy_quark_residual_sq(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Fermilab heavy-quark residual squared as a 0-d tensor:
    hq² = (1/V) Σ_sites |r(site)|² / |x(site)|²; a site with |x|² = 0
    contributes 1 (reference reduce_quda.cu:776-779).  Fields in the
    canonical complex layout [..., 4, 3, T, Z, W]: the site norm sums
    over the spin-colour axes only."""
    sc = (-5, -4)
    xn = (x.real ** 2 + x.imag ** 2).sum(dim=sc)
    rn = (r.real ** 2 + r.imag ** 2).sum(dim=sc)
    pos = xn > 0
    return torch.where(pos, rn / torch.where(pos, xn, 1.0), 1.0).mean()


def l2_stop_target(b2, tol: float, tol_abs: float,
                   residual_type: ResidualType) -> torch.Tensor:
    """The |r|² stopping target of the L2 parts of the bitmask
    (reference Solver::stopping, lib/solver.cpp): the larger of
    tol²|b|² (L2_RELATIVE) and tol_abs² (L2_ABSOLUTE); infinite for a
    heavy-quark-only solve, whose L2 check is vacuous."""
    b2 = torch.as_tensor(b2)
    target = torch.zeros((), dtype=torch.promote_types(b2.dtype,
                                                       torch.float32),
                         device=b2.device)
    if residual_type & ResidualType.L2_RELATIVE:
        target = torch.maximum(target, (tol * tol) * b2)
    if residual_type & ResidualType.L2_ABSOLUTE:
        target = torch.clamp(target, min=tol_abs * tol_abs)
    if target == 0.0 and not (residual_type & ResidualType.L2_RELATIVE):
        target = torch.full_like(target, float("inf"))
    return target


def mass_rescale_factor(solution_type: str,
                        normalization: MassNormalization,
                        kappa: float, m5: float | None = None,
                        domain_wall: bool = False) -> float:
    """Source scale factor of massRescale (reference
    interface_quda.cpp:1412-1494).  ``solution_type`` is one of "mat",
    "matdag-mat", "matpc", "matpcdag-matpc"; a domain-wall operator
    takes κ5 = 1 / (2 (5 + m5)) for κ."""
    k = (0.5 / (5.0 + m5)) if (domain_wall and m5 is not None) else kappa
    n = normalization
    if n == MassNormalization.KAPPA:
        return 1.0
    table = {
        ("mat", MassNormalization.MASS): 2.0 * k,
        ("mat", MassNormalization.ASYMMETRIC_MASS): 2.0 * k,
        ("matdag-mat", MassNormalization.MASS): 4.0 * k * k,
        ("matdag-mat", MassNormalization.ASYMMETRIC_MASS): 4.0 * k * k,
        ("matpc", MassNormalization.MASS): 4.0 * k * k,
        ("matpc", MassNormalization.ASYMMETRIC_MASS): 2.0 * k,
        ("matpcdag-matpc", MassNormalization.MASS): 16.0 * k ** 4,
        ("matpcdag-matpc", MassNormalization.ASYMMETRIC_MASS): 4.0 * k * k,
    }
    try:
        return table[(solution_type, n)]
    except KeyError:
        raise ValueError(
            f"unsupported ({solution_type}, {n}) combination") from None


def mass_rescale(b: torch.Tensor, shifts=None, **kw):
    """Scale the source (and the multi-shift offsets) by the convention's
    factor (``mass_rescale_factor(**kw)``); returns (b_scaled,
    shifts_scaled or None)."""
    f = mass_rescale_factor(**kw)
    bs = b if f == 1.0 else b * f
    if shifts is None:
        return bs, None
    return bs, tuple(s * f for s in shifts)


class ReliableStats(NamedTuple):
    """Counters of the reliable-update discipline (the diagnostics the
    reference tracks at inv_cg_quda.cpp:260-311)."""
    restarts: int             # reliable updates performed
    res_increase: int         # consecutive true-residual increases
    res_increase_total: int   # total increases over the solve
    diverged: bool            # True if terminated by the counters


def summed(allreduce: Callable, *values: torch.Tensor) -> tuple:
    """0-d reductions (real or complex) of one local field, each summed
    over the ranks of a sharded field by one ``allreduce`` call on their
    stacked vector (``parallel.mesh.TMesh.allreduce``, which sums a
    complex vector as its real pairs); the values themselves when
    ``allreduce`` is None."""
    if allreduce is None:
        return values
    cdt = torch.promote_types(values[0].dtype, torch.complex64)
    for v in values[1:]:
        cdt = torch.promote_types(cdt, v.dtype)
    out = allreduce(torch.stack([v.to(cdt) for v in values])).unbind()
    return tuple(o if v.is_complex() else o.real.to(v.dtype)
                 for o, v in zip(out, values))


def defect_correction(matvec_hi: Callable, solve_lo: Callable, b,
                      lo_dtype: torch.dtype, tol: float, maxiter: int,
                      max_restarts: int, max_res_increase: int,
                      max_res_increase_total: int,
                      allreduce: Callable | None = None):
    """The restart loop of ``cg_mixed`` and ``bicgstab_mixed`` (the JAX
    package's loop, reference inv_cg_quda.cpp:207-311): from x = 0,
    repeat x += solve_lo(r in ``lo_dtype``, cap) and r = b − matvec_hi(x)
    in b's precision until |r|² ≤ tol²|b|², ``max_restarts`` restarts,
    ``maxiter`` inner iterations in all, or the residual-increase
    counters stop it.

    ``solve_lo(r, cap)`` runs at most ``cap`` iterations (what is left
    of ``maxiter``) and returns a result with ``.x`` and ``.iters``.  The
    counters: a restart whose true |r|² exceeds the previous one counts
    as an increase; more than ``max_res_increase`` in a row or more than
    ``max_res_increase_total`` in all ends the solve at the sloppy
    operator's precision floor, and ``diverged`` reports it.  The JAX
    loop recomputes b − matvec_hi(x) at the top of each restart; here
    the residual that ended the previous restart is reused (the same
    function of the same x), which saves one high-precision matvec a
    restart.  ``allreduce`` sums the outer loop's |r|² over the ranks of
    a sharded field.  Returns (x, |r|², summed inner iterations,
    ReliableStats)."""
    red = (lambda v: v) if allreduce is None else allreduce
    b2 = red(norm2(b))
    target = (tol * tol) * b2
    x = torch.zeros_like(b)
    r = b
    r2 = b2
    restarts = iters = inc = inc_tot = 0
    while (bool(r2 > target) and restarts < max_restarts and iters < maxiter
           and inc <= max_res_increase and inc_tot <= max_res_increase_total):
        e = solve_lo(r.to(lo_dtype), maxiter - iters)
        x = x + e.x.to(b.dtype)
        r = b - matvec_hi(x)
        r2_new = red(norm2(r))
        increased = bool(r2_new > r2)
        inc = inc + 1 if increased else 0
        inc_tot += int(increased)
        r2 = r2_new
        restarts += 1
        iters += e.iters
    diverged = bool(r2 > target) and (inc > max_res_increase
                                      or inc_tot > max_res_increase_total)
    return x, r2, iters, ReliableStats(restarts, inc, inc_tot, diverged)
