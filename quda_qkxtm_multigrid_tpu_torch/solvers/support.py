"""Solver support shared by the mixed-precision solvers: the counters of
the reliable-update discipline (the JAX package's
``solvers/support.ReliableStats``; the rest of that module is not ported
yet) and the defect-correction restart loop around a sloppy inner
solve.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from quda_qkxtm_multigrid_tpu_torch.ops.blas import norm2


class ReliableStats(NamedTuple):
    """Counters of the reliable-update discipline (the diagnostics the
    reference tracks at inv_cg_quda.cpp:260-311)."""
    restarts: int             # reliable updates performed
    res_increase: int         # consecutive true-residual increases
    res_increase_total: int   # total increases over the solve
    diverged: bool            # True if terminated by the counters


def defect_correction(matvec_hi: Callable, solve_lo: Callable, b,
                      lo_dtype: torch.dtype, tol: float, maxiter: int,
                      max_restarts: int, max_res_increase: int,
                      max_res_increase_total: int):
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
    restart.  Returns (x, |r|², summed inner iterations, ReliableStats)."""
    b2 = norm2(b)
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
        r2_new = norm2(r)
        increased = bool(r2_new > r2)
        inc = inc + 1 if increased else 0
        inc_tot += int(increased)
        r2 = r2_new
        restarts += 1
        iters += e.iters
    diverged = bool(r2 > target) and (inc > max_res_increase
                                      or inc_tot > max_res_increase_total)
    return x, r2, iters, ReliableStats(restarts, inc, inc_tot, diverged)
