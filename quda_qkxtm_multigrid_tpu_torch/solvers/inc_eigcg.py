"""Incremental eigCG: CG solves over a sequence of right-hand sides that
accumulate a deflation space and deflate every later solve (reference
IncEigCG / incrementalEigQuda, lib/inv_eigcg_quda.cpp:453,
ExpandDeflationSpace :747, API quda.h:682): the JAX package's
``solvers/inc_eigcg.py``.

Each solve harvests ``nev_per_solve`` low eigenpairs with a
thick-restart Lanczos pass (``solvers.eigen.lanczos`` in its plain
form, as the JAX package's: no Chebyshev filter), keeps only the
accurate ones, and merges them into the accumulated space V, which is
then orthonormalised and re-diagonalised (``_rayleigh_ritz``).  Later
solves run a Galerkin correction on V and a CG on the projected operator
P A P (P = 1 − V V†) inside up to four defect-correction outers.  V is
one tensor [n, ...field] on the fields' device.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from quda_qkxtm_multigrid_tpu_torch.ops.blas import norm2
from quda_qkxtm_multigrid_tpu_torch.solvers.cg import CGResult, cg
from quda_qkxtm_multigrid_tpu_torch.solvers.eigen import (
    deflate_guess, lanczos, project_out)


class IncEigCG:
    """Deflation-space accumulator over a right-hand-side sequence:

        inc = IncEigCG(matvec, nev_per_solve=8, max_nev=48)
        for b in rhs_sequence:
            x = inc.solve(b, tol=1e-8)

    ``harvests`` holds one record a Lanczos pass: its ``restarts``,
    ``matvecs`` and ``secs`` (``lanczos(stats=)``), the pairs it
    ``found`` and the pairs it ``kept``."""

    def __init__(self, matvec: Callable, nev_per_solve: int = 8,
                 max_nev: int = 64, lanczos_ncv: Optional[int] = None,
                 lanczos_tol: float = 1e-3):
        self.matvec = matvec
        self.nev_per_solve = nev_per_solve
        self.max_nev = max_nev
        self.lanczos_ncv = lanczos_ncv
        self.lanczos_tol = lanczos_tol
        self.evecs = None          # [n, ...field]
        self.evals = None          # [n] real
        self.harvests: list = []

    @property
    def n_deflated(self) -> int:
        return 0 if self.evecs is None else self.evecs.shape[0]

    def _expand(self, b: torch.Tensor, gen: torch.Generator):
        """Harvest up to nev_per_solve new eigenpairs and merge them into
        the space, Rayleigh-Ritz included."""
        if self.n_deflated >= self.max_nev:
            return
        want = min(self.nev_per_solve, self.max_nev - self.n_deflated)
        if self.evecs is not None:
            # search the orthogonal complement of the space: P A P has a
            # null space on span(V), where a plain projected operator
            # would hand the "smallest" Ritz pairs back inside V, so V is
            # shifted to the top of the spectrum instead
            vs = self.evecs
            sigma = 10.0 * float(self.evals.abs().max()) + 1.0

            def op(v):
                pv = project_out(vs, v)
                return project_out(vs, self.matvec(pv)) + sigma * (v - pv)
        else:
            op = self.matvec
        st = {}
        eig = lanczos(op, b, nev=want, ncv=self.lanczos_ncv,
                      tol=self.lanczos_tol, max_restarts=30, gen=gen,
                      stats=st)
        # accept only accurate pairs: one inaccurate vector in V poisons
        # every later Galerkin correction
        scale = max(float(eig.evals.abs().max()), 1e-30)
        keep = torch.nonzero(eig.resid <= 20.0 * self.lanczos_tol * scale
                             ).flatten()
        self.harvests.append(dict(st, found=want, kept=int(keep.numel())))
        if keep.numel() == 0:
            return
        new = eig.evecs[keep.to(eig.evecs.device)]
        v = new if self.evecs is None else torch.cat([self.evecs, new])
        self.evecs, self.evals = _rayleigh_ritz(self.matvec, v)

    def solve(self, b: torch.Tensor, tol: float = 1e-8, maxiter: int = 1000,
              expand: bool = True,
              gen: Optional[torch.Generator] = None) -> CGResult:
        """Deflated solve of matvec x = b, then (until max_nev) a harvest
        from b.  ``gen`` draws the Lanczos start vector (default: a
        generator on b's device seeded n_deflated + 1, the JAX package's
        key).  With a space, the Krylov part runs on P A P: a deflated
        initial guess alone loses its gain to round-off drift back into
        the low modes (the reference's init-CG projection); the
        defect-correction outers absorb the space's invariance defect."""
        if gen is None:
            gen = torch.Generator(device=b.device).manual_seed(
                self.n_deflated + 1)
        if self.evecs is not None:
            vs, lam, mv = self.evecs, self.evals, self.matvec

            def op(v):
                return project_out(vs, mv(project_out(vs, v)))

            b2 = norm2(b)
            x = torch.zeros_like(b)
            iters = 0
            for _ in range(4):
                r = b - mv(x)
                x = x + deflate_guess(vs, lam, r)   # the in-span block
                r = b - mv(x)
                inner = cg(op, project_out(vs, r), tol=tol, maxiter=maxiter,
                           abs_b2=b2)
                x = x + project_out(vs, inner.x)
                rn = b - mv(x)
                r2 = norm2(rn)
                iters += inner.iters
                if bool(r2 <= tol * tol * b2):
                    break
            res = CGResult(x, iters, r2)
        else:
            res = cg(self.matvec, b, tol=tol, maxiter=maxiter)
        if expand:
            self._expand(b, gen)
        return res


def _rayleigh_ritz(matvec: Callable, v: torch.Tensor):
    """Orthonormalise the space v [n, ...field] (one QR) and diagonalise
    the projected operator (one eigh): (evecs, real evals ascending)."""
    n = v.shape[0]
    q, _ = torch.linalg.qr(v.reshape(n, -1).T)          # [dim, n]
    qv = q.T.reshape(v.shape)
    av = torch.stack([matvec(a) for a in qv])
    h = q.conj().T @ av.reshape(n, -1).T                # [n, n]
    evals, w = torch.linalg.eigh(0.5 * (h + h.conj().T))
    evecs = (w.T @ qv.reshape(n, -1)).view(v.shape)
    return evecs, evals
