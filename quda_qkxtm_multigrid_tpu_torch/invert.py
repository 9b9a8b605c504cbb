"""High-level solve entry point.

Factorise the solve (even-odd preconditioned normal equations), prepare
the Schur source, run CG, reconstruct the full-lattice solution, and
report the true residual of the full operator in the source's precision.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from quda_qkxtm_multigrid_tpu_torch.dirac import Dirac
from quda_qkxtm_multigrid_tpu_torch.ops.blas import norm2
from quda_qkxtm_multigrid_tpu_torch.ops.dslash_kernel import (
    from_channels, to_channels)
from quda_qkxtm_multigrid_tpu_torch.solvers.cg import cg
from quda_qkxtm_multigrid_tpu_torch.solvers.msrc import msrc_cg


class InvertResult(NamedTuple):
    x: torch.Tensor       # full solution [2,4,3,T,Z,W]
    iters: int
    true_res: float       # |M x − b| / |b|


def invert(dirac: Dirac, b: torch.Tensor, tol: float = 1e-10,
           maxiter: int = 1000, solver: str = "cg") -> InvertResult:
    """Solve M x = b via CG on M_pc† M_pc x_p = M_pc† src.

    When the operator has the fused kernel chain (``use_kernels`` with a
    twisted or clover kind, symmetric Schur form), the CG loop runs on
    float32 planar-channel fields and each matvec is four fused hops;
    source preparation, reconstruction and the true residual stay in the
    fields' precision."""
    if solver != "cg":
        raise ValueError(f"unknown solver {solver!r}; only 'cg' is ported")
    src = dirac.prepare(b)
    rhs = dirac.matpc(src, dagger=True)
    if dirac._has_fused_matpc:
        rhs_ch = to_channels(rhs).to(torch.float32)
        res = cg(dirac._fused_matpc_dagm_ch, rhs_ch, tol=tol,
                 maxiter=maxiter)
        x_p = from_channels(res.x, (4, 3)).to(rhs.dtype)
    else:
        res = cg(dirac.matpc_dagm, rhs, tol=tol, maxiter=maxiter)
        x_p = res.x
    x = dirac.reconstruct(x_p, b)
    _, rel = true_residual(dirac, x, b)
    return InvertResult(x, res.iters, float(rel))


def invert_msrc(dirac: Dirac, bs: torch.Tensor, tol: float = 1e-10,
                maxiter: int = 1000) -> InvertResult:
    """Solve M x_i = b_i for a batch bs [n, 2,4,3,T,Z,W] with one
    multi-source CG on M_pc† M_pc (``solvers.msrc.msrc_cg``).

    Source preparation, the M_pc† of the right-hand side, the
    reconstruction and the true residual run source by source.  On the
    fused kernel chain the CG runs on float32 channels [n, T, 24, Z, W]
    and each matvec is two multi-source matpc halves, i.e. four
    multi-source kernel launches.  ``true_res`` is the worst source's
    |M x_i − b_i| / |b_i|."""
    rhs = torch.stack([dirac.matpc(dirac.prepare(b), dagger=True)
                       for b in bs])
    if dirac._has_fused_matpc:
        def matvec_b(v_ch_b):
            return dirac._fused_matpc_ch_msrc(
                dirac._fused_matpc_ch_msrc(v_ch_b, False), True)

        rhs_ch = torch.stack([to_channels(r) for r in rhs]).to(torch.float32)
        res = msrc_cg(matvec_b, rhs_ch, tol=tol, maxiter=maxiter)
        x_p = torch.stack([from_channels(v, (4, 3)) for v in res.x]).to(
            rhs.dtype)
    else:
        res = msrc_cg(lambda v: torch.stack([dirac.matpc_dagm(a) for a in v]),
                      rhs, tol=tol, maxiter=maxiter)
        x_p = res.x
    del rhs
    x = torch.stack([dirac.reconstruct(a, b) for a, b in zip(x_p, bs)])
    worst = max(float(true_residual(dirac, a, b)[1]) for a, b in zip(x, bs))
    return InvertResult(x, res.iters, worst)


def true_residual(dirac: Dirac, x: torch.Tensor, b: torch.Tensor):
    """(r, |r|/|b|) of the full operator, |r|/|b| as a 0-d tensor."""
    r = b - dirac.m(x)
    return r, torch.sqrt(norm2(r) / norm2(b))
