"""Communication-avoiding (s-step) solvers, the JAX package's
``solvers/ca.py``: the reference's MPCG (lib/inv_mpcg_quda.cpp) and
MPBiCGstab (lib/inv_mpbicgstab_quda.cpp:318) amortise global reductions
over s matvecs; here the reductions of a block are one Gram matrix.

  mpcg        s-step block CG: the monomial basis V = [r, Ar, …], the new
              block A-conjugated against the previous one
              (Chronopoulos / Gear; s CG steps a block in exact
              arithmetic).  ``matvec_batched`` applies A to the whole
              block at once (on the card the multi-source chain, K2 at
              n = s); the basis itself stays sequential.
  bicgstab_l  BiCGstab(L) (Sleijpen-Fokkema): BiCG steps and a degree-L
              minimal-residual polynomial.

Fields are complex; a block is [s, ...field], its Gram matrices and the
s×s solves stay on the device, and each block reads |r|² on the host
once.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from quda_qkxtm_multigrid_tpu_torch.ops.blas import cDotProduct, norm2
from quda_qkxtm_multigrid_tpu_torch.solvers.cg import CGResult


def _gram(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """[i, j] = <a_i, c_j> of two blocks [n, ...] and [m, ...]."""
    return a.reshape(a.shape[0], -1).conj() @ c.reshape(c.shape[0], -1).T


def _combine(coef: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Σ_i coef_i v_i of a block v [n, ...field]."""
    return (coef @ v.reshape(v.shape[0], -1)).view(v.shape[1:])


def mpcg(matvec: Callable, b: torch.Tensor, s: int = 4, tol: float = 1e-10,
         max_blocks: int = 500,
         matvec_batched: Optional[Callable] = None) -> CGResult:
    """s-step CG; ``iters`` counts s a block, as the JAX package does.
    Monomial bases limit practical s to ≤ ~6 in single precision (the
    reference's MPCG shares the caveat).  ``matvec_batched`` applies
    ``matvec`` to a block [s, ...field] (default: one at a time)."""
    if matvec_batched is None:
        matvec_batched = lambda v: torch.stack([matvec(a) for a in v])  # noqa: E731,E501
    x = torch.zeros_like(b)
    r = b
    r2 = norm2(b)
    target = (tol * tol) * r2
    p = ap = g_prev = None
    k = 0
    while k < max_blocks * s and bool(r2 > target):
        vs = [r]
        for _ in range(s - 1):                 # r, Ar, ..., A^{s-1} r
            vs.append(matvec(vs[-1]))
        v = torch.stack(vs)
        if p is not None:                      # A-conjugate to the last block
            coef = torch.linalg.solve(g_prev, _gram(ap, v))
            v = v - (coef.T @ p.reshape(s, -1)).view(v.shape)
        av = matvec_batched(v)
        g = _gram(v, av)                       # V† A V (hermitian s×s)
        y = torch.linalg.solve(g, _gram(v, r[None])[:, 0])
        x = x + _combine(y, v)
        r = r - _combine(y, av)
        p, ap, g_prev = v, av, g
        r2 = norm2(r)
        k += s
    return CGResult(x, k, r2)


def bicgstab_l(matvec: Callable, b: torch.Tensor, L: int = 2,
               tol: float = 1e-10, maxiter: int = 1000) -> CGResult:
    """BiCGstab(L): L BiCG steps, then a degree-L minimal-residual
    polynomial update (Sleijpen-Fokkema); L = 1 is BiCGstab.  ``iters``
    counts 2L matvecs a cycle."""
    x = torch.zeros_like(b)
    r0 = b
    r2 = norm2(b)
    target = (tol * tol) * r2
    one = torch.ones((), dtype=b.dtype, device=b.device)
    rho0 = alpha = omega = one
    rs = [b] + [torch.zeros_like(b) for _ in range(L)]
    us = [torch.zeros_like(b) for _ in range(L + 1)]
    k = 0
    while k < maxiter and bool(r2 > target):
        rho0 = -omega * rho0
        for j in range(L):                     # the BiCG part
            rho1 = cDotProduct(r0, rs[j])
            beta = alpha * (rho1 / rho0)
            rho0 = rho1
            for i in range(j + 1):
                us[i] = rs[i] - beta * us[i]
            us[j + 1] = matvec(us[j])
            alpha = rho0 / cDotProduct(r0, us[j + 1])
            for i in range(j + 1):
                rs[i] = rs[i] - alpha * us[i + 1]
            rs[j + 1] = matvec(rs[j])
            x = x + alpha * us[0]
        # the MR part: γ = argmin |r_0 − Σ_{j≥1} γ_j r_j|
        rm = torch.stack(rs[1:])
        gamma = torch.linalg.solve(_gram(rm, rm), _gram(rm, rs[0][None])[:, 0])
        x = x + _combine(gamma, torch.stack(rs[:L]))
        r_new = rs[0] - _combine(gamma, rm)
        u_new = us[0] - _combine(gamma, torch.stack(us[1:]))
        omega = gamma[L - 1]
        rs = [r_new] + [torch.zeros_like(b) for _ in range(L)]
        us = [u_new] + [torch.zeros_like(b) for _ in range(L)]
        r2 = norm2(r_new)
        k += 2 * L
    return CGResult(x, k, r2)
