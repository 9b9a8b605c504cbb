"""Preconditioned CG, simple BiCGstab and extended-precision SD, the
reference's auxiliary solver tail (reference lib/inv_pcg_quda.cpp:358,
inv_sbicgstab_quda.cpp, inv_xsd_quda.cpp via lib/inv_sd_quda.cpp): the
JAX package's ``solvers/pcg.py``.

The flexible (Polak-Ribière) β makes ``pcg`` robust to a nonlinear
preconditioner (a fixed MR or CG cycle, the reference's K solver);
``xsd`` accumulates its iterate with Kahan compensation, the JAX
package's stand-in for the reference's extended-storage precision.  It
is kept as that package computes it, although the H100 has native
float64.  Python loops on complex fields; each stopping test reads |r|²
on the host once per iteration.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from quda_qkxtm_multigrid_tpu_torch.ops.blas import (
    cDotProduct, norm2, reDotProduct)
from quda_qkxtm_multigrid_tpu_torch.solvers.cg import CGResult


def pcg(matvec: Callable, b: torch.Tensor, precond: Optional[Callable] = None,
        x0: Optional[torch.Tensor] = None, tol: float = 1e-10,
        maxiter: int = 1000, flexible: bool = True) -> CGResult:
    """Left-preconditioned CG (reference PreconCG, inv_pcg_quda.cpp:358,
    with K an inner CG / MR cycle).  ``flexible`` uses the Polak-Ribière
    β = <z_new, r_new − r_old> / <z, r>, which a nonlinear ``precond``
    (a fixed-count MR or CG cycle) needs."""
    if precond is None:
        precond = lambda r: r        # noqa: E731
    if x0 is None:
        x = torch.zeros_like(b)
        r = b
    else:
        x = x0
        r = b - matvec(x0)
    target = (tol * tol) * norm2(b)
    z = precond(r)
    rz = reDotProduct(r, z)
    p = z
    r2 = norm2(r)
    k = 0
    while k < maxiter and bool(r2 > target):
        ap = matvec(p)
        alpha = (rz / reDotProduct(p, ap)).to(b.dtype)
        x = x + alpha * p
        r_new = r - alpha * ap
        z_new = precond(r_new)
        num = reDotProduct(z_new, r_new)
        if flexible:
            num = num - reDotProduct(z_new, r)
        beta = (num / rz).to(b.dtype)
        p = z_new + beta * p
        rz = reDotProduct(r_new, z_new)
        r, z = r_new, z_new
        r2 = norm2(r)
        k += 1
    return CGResult(x, k, r2)


def simple_bicgstab(matvec: Callable, b: torch.Tensor,
                    x0: Optional[torch.Tensor] = None, tol: float = 1e-10,
                    maxiter: int = 1000,
                    precond: Optional[Callable] = None) -> CGResult:
    """Textbook BiCGstab without the fused restructuring, the reference's
    SimpleBiCGstab (lib/inv_sbicgstab_quda.cpp), with optional right
    preconditioning."""
    K = (lambda v: v) if precond is None else precond   # noqa: E731
    if x0 is None:
        x = torch.zeros_like(b)
        r = b
    else:
        x = x0
        r = b - matvec(x0)
    r0 = r
    target = (tol * tol) * norm2(b)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    rho = alpha = omega = one
    p = torch.zeros_like(b)
    v = torch.zeros_like(b)
    r2 = norm2(r)
    k = 0
    while k < maxiter and bool(r2 > target):
        rho_new = cDotProduct(r0, r)
        beta = (rho_new / rho) * (alpha / omega)
        p = r + beta * (p - omega * v)
        kp = K(p)
        v = matvec(kp)
        alpha = rho_new / cDotProduct(r0, v)
        s = r - alpha * v
        ks = K(s)
        t = matvec(ks)
        omega = cDotProduct(t, s) / norm2(t).to(b.dtype)
        x = x + alpha * kp + omega * ks
        r = s - omega * t
        rho = rho_new
        r2 = norm2(r)
        k += 1
    return CGResult(x, k, r2)


def xsd(matvec: Callable, b: torch.Tensor, tol: float = 1e-8,
        maxiter: int = 200, omega_scale: float = 1.0) -> CGResult:
    """Extended-precision steepest descent (reference XSD,
    invert_quda.h:581): SD whose iterate is accumulated with Kahan
    compensation, recovering mantissa bits where the working dtype
    limits plain SD."""
    x = torch.zeros_like(b)
    c = torch.zeros_like(b)          # Kahan compensation term
    r = b
    r2 = norm2(b)
    target = (tol * tol) * r2
    k = 0
    while k < maxiter and bool(r2 > target):
        ar = matvec(r)
        alpha = (omega_scale * r2 / reDotProduct(r, ar)).to(b.dtype)
        yv = alpha * r - c           # compensated x += alpha r
        t = x + yv
        c = (t - x) - yv
        x = t
        r = r - alpha * ar
        r2 = norm2(r)
        k += 1
    return CGResult(x, k, r2)
