"""Hermitian eigensolver: thick-restart Lanczos with full
reorthogonalisation, a Chebyshev filter, and the deflation helpers: the
counterpart of the JAX package's ``solvers/eigen.py`` (the reference's
ARPACK loop in ``QKXTM_Deflation``, its ``polynomialOperator``,
``deflateVector`` and ``projectVector``).

The Krylov basis is one [ncv + 1, N] matrix of flattened fields on the
fields' device; the reorthogonalisation against the active rows is two
passes of two matrix-vector products each (classical Gram-Schmidt
twice; the JAX package runs the modified form over every row, the
inactive ones masked to zero).  The projected problem, tridiagonal with
the thick restart's arrow, is small and is solved on the host in float64
(``torch.linalg.eigh``).  Restarts keep the ``nev`` lowest Ritz vectors
and the residual vector.

``lanczos(chebyshev=(amin, amax, degree))`` runs the same iteration on
−T_degree of the operator mapped from [amin, amax] onto [−1, 1] (the
reference's polynomial acceleration, ``chebyshev_op``): the modes below
amin become its lowest and the rest are pressed into [−1, 1], so a dense
low spectrum (a hot gauge at 32³×64, where the plain iteration stalls)
resolves in a few restarts.  The eigenvalues are then the Rayleigh
quotients of the operator itself.  ``spectrum_bounds`` gives amin and
amax from one short unfiltered cycle.

On a process grid (``allreduce=``, ``parallel.mesh.TMesh.allreduce``) the
fields are this rank's boxes and every inner product is summed over
the ring: a CGS2 pass's dots as one vector, the diagonal entry and the
norm of a Lanczos step as one scalar each, the Rayleigh quotients and
residuals of a restart as one vector each.  The projected problem is
then the same bytes on every rank, and so are its ``eigh`` and the
restart's rotation of the basis rows.  ``chebyshev_op`` sums nothing:
the matvec carries its own exchange.  The start vector is drawn by the
caller (``v0``): the whole field from the generator, then this rank's
box of it, so a grid takes the unsharded start.  ``allreduce=None``
leaves every path as it was.
"""

from __future__ import annotations

import math
import time
from typing import Callable, NamedTuple, Optional

import torch


class EigResult(NamedTuple):
    evals: torch.Tensor      # [nev] ascending (real)
    evecs: torch.Tensor      # [nev, ...field]
    resid: torch.Tensor      # [nev] |A v − λ v| (real)


def _start_vector(example: torch.Tensor,
                  gen: Optional[torch.Generator]) -> torch.Tensor:
    """The normalised complex Gaussian start vector of ``example``'s
    shape, dtype and device, drawn from ``gen`` (a generator on that
    device seeded 7 if None)."""
    if gen is None:
        gen = torch.Generator(device=example.device).manual_seed(7)
    rdt = torch.float64 if example.dtype == torch.complex128 else torch.float32
    re = torch.randn(example.shape, generator=gen, dtype=rdt,
                     device=example.device)
    im = torch.randn(example.shape, generator=gen, dtype=rdt,
                     device=example.device)
    v = torch.complex(re, im).to(example.dtype)
    return v / torch.linalg.vector_norm(v)


def _dots(rows: torch.Tensor, w: torch.Tensor,
          allreduce: Optional[Callable] = None) -> torch.Tensor:
    """<rows_j, w> for every row (the conjugate falls on the one vector,
    never on the basis), summed over the grid by one ``allreduce`` of
    the vector."""
    d = torch.mv(rows, w.conj()).conj()
    return d if allreduce is None else allreduce(d)


def _orthogonalise(w: torch.Tensor, rows: torch.Tensor,
                   allreduce: Optional[Callable] = None) -> torch.Tensor:
    """w minus its components along ``rows``, twice."""
    for _ in range(2):
        w = w - torch.mv(rows.transpose(0, 1), _dots(rows, w, allreduce))
    return w


def _norm(w: torch.Tensor, allreduce: Optional[Callable]) -> float:
    """|w| on the host, summed over the grid."""
    if allreduce is None:
        return float(torch.linalg.vector_norm(w))
    return math.sqrt(float(allreduce(torch.vdot(w, w).real)))


def chebyshev_op(matvec: Callable, amin: float, amax: float,
                 degree: int) -> Callable:
    """The Chebyshev polynomial T_degree of the operator mapped from
    [amin, amax] onto [−1, 1]: it amplifies the low end of the spectrum
    (the reference's ``polynomialOperator``)."""
    d = (amax + amin) / 2.0
    c = (amax - amin) / 2.0

    def op(v):
        tm1 = v
        t = (matvec(v) - d * v) * (1.0 / c)
        for _ in range(degree - 1):
            tp1 = 2.0 / c * (matvec(t) - d * t) - tm1
            tm1, t = t, tp1
        return t

    return op


def _cycle_tmat(op: Callable, basis: torch.Tensor, tmat: torch.Tensor,
                k_keep: int, shape, allreduce: Optional[Callable] = None):
    """Extend the factorisation from row ``k_keep`` to the last row of
    ``tmat`` (ncv), the normalised residual vector into ``basis[ncv]``."""
    ncv = tmat.shape[0] - 1
    for k in range(k_keep, ncv):
        w = op(basis[k].view(shape)).reshape(-1)
        alpha = torch.vdot(basis[k], w).real
        tmat[k, k] += float(alpha if allreduce is None else allreduce(alpha))
        w = _orthogonalise(w, basis[:k + 1], allreduce)
        beta = _norm(w, allreduce)
        basis[k + 1] = w / (beta if beta > 0 else 1.0)
        tmat[k + 1, k] = tmat[k, k + 1] = beta


def _residual_norms(triples, allreduce: Optional[Callable]) -> torch.Tensor:
    """|a − λ v| for each (a, λ, v) of ``triples`` (an iterable, made one
    at a time), summed over the grid as one vector of squares."""
    if allreduce is None:
        return torch.stack([torch.linalg.vector_norm(a - lam_i * v)
                            for a, lam_i, v in triples])
    sq = []
    for a, lam_i, v in triples:
        d = a - lam_i * v
        sq.append(torch.vdot(d, d).real)
    return torch.sqrt(allreduce(torch.stack(sq)))


def _rayleigh_ritz(matvec: Callable, ritz: torch.Tensor, shape,
                   allreduce: Optional[Callable] = None):
    """The Rayleigh quotients of ``matvec`` on the rows of ``ritz``,
    ascending, the rows in that order, and their residuals."""
    av = torch.stack([matvec(v.view(shape)).reshape(-1) for v in ritz])
    lam = torch.stack([torch.vdot(v, a).real for v, a in zip(ritz, av)])
    if allreduce is not None:
        lam = allreduce(lam)
    lam, order = torch.sort(lam)
    ritz, av = ritz[order], av[order]
    return lam, ritz, _residual_norms(zip(av, lam, ritz), allreduce)


def _first_row(example: torch.Tensor, gen, v0) -> torch.Tensor:
    """The normalised start vector, flat: ``v0`` (this rank's box of a
    whole normalised field) or ``_start_vector(example, gen)``."""
    return (_start_vector(example, gen) if v0 is None else v0).reshape(-1)


def spectrum_bounds(matvec: Callable, example: torch.Tensor, nev: int,
                    steps: int = 40, gen: Optional[torch.Generator] = None,
                    allreduce: Optional[Callable] = None,
                    v0: Optional[torch.Tensor] = None):
    """(amin, amax) for ``lanczos(chebyshev=...)`` from one unfiltered
    cycle of ``steps``: amin the ``nev``-th lowest Ritz value, which is
    at least the ``nev``-th eigenvalue (interlacing), and amax the
    highest Ritz value plus 5 % of the Ritz spread, above the top of the
    spectrum.  ``allreduce`` and ``v0`` as in ``lanczos``."""
    basis = torch.empty((steps + 1, example.numel()), dtype=example.dtype,
                        device=example.device)
    basis[0] = _first_row(example, gen, v0)
    tmat = torch.zeros((steps + 1, steps + 1), dtype=torch.float64)
    _cycle_tmat(matvec, basis, tmat, 0, example.shape, allreduce)
    theta = torch.linalg.eigvalsh(tmat[:steps, :steps])
    spread = float(theta[-1] - theta[0])
    return float(theta[nev - 1]), float(theta[-1]) + 0.05 * spread


def lanczos(matvec: Callable, example: torch.Tensor, nev: int,
            ncv: Optional[int] = None, tol: float = 1e-8,
            max_restarts: int = 100, gen: Optional[torch.Generator] = None,
            stats: Optional[dict] = None,
            chebyshev: Optional[tuple] = None,
            allreduce: Optional[Callable] = None,
            v0: Optional[torch.Tensor] = None) -> EigResult:
    """The ``nev`` lowest eigenpairs of the hermitian ``matvec`` by
    thick-restart Lanczos; ``example`` gives the field's shape, dtype and
    device, and the start vector is ``_start_vector(example, gen)``.
    Stops when every kept Ritz pair's residual estimate is below ``tol``
    or after ``max_restarts`` cycles; the returned residuals are the true
    |A v − λ v|.  ``chebyshev=(amin, amax, degree)`` iterates on the
    filtered operator (module docstring) and stops when the Ritz pairs
    of ``matvec`` itself have residuals below ``tol``.  ``stats``, if
    given, receives the cycles (``restarts``), the applications of
    ``matvec`` (``matvecs``) and the host seconds (``secs``, the device
    synchronised).  ``allreduce`` sums every inner product over the
    ranks of a sharded field (module docstring); ``v0``, the start
    vector, replaces the draw from ``gen``."""
    if ncv is None:
        ncv = max(2 * nev + 8, nev + 16)
    t0 = time.perf_counter()
    shape, dtype, dev = example.shape, example.dtype, example.device
    calls = [0]

    def counted(v):
        calls[0] += 1
        return matvec(v)

    op = counted
    if chebyshev is not None:
        poly = chebyshev_op(counted, *chebyshev)

        def op(v):
            return -poly(v)
    basis = torch.empty((ncv + 1, example.numel()), dtype=dtype, device=dev)
    basis[0] = _first_row(example, gen, v0)
    tmat = torch.zeros((ncv + 1, ncv + 1), dtype=torch.float64)
    k_keep, cycles = 0, 0
    for cycles in range(1, max_restarts + 1):
        _cycle_tmat(op, basis, tmat, k_keep, shape, allreduce)
        evals, q = torch.linalg.eigh(tmat[:ncv, :ncv])
        beta_last = float(tmat[ncv, ncv - 1])
        s = beta_last * q[ncv - 1, :nev]
        ritz = q[:, :nev].T.to(dev, dtype) @ basis[:ncv]
        basis[:nev] = ritz
        basis[nev] = basis[ncv]
        k_keep = nev
        tmat.zero_()
        idx = torch.arange(nev)
        tmat[idx, idx] = evals[:nev]
        tmat[nev, :nev] = tmat[:nev, nev] = s
        if chebyshev is None:
            if float(s.abs().max()) < tol:
                break
            continue
        # the filter's values run to ~1e10: test the pairs of the
        # operator itself
        lam, ritz, res = _rayleigh_ritz(counted, ritz, shape, allreduce)
        if float(res.max()) < tol:
            break
    if chebyshev is None:
        lam = evals[:nev].to(dev, basis.real.dtype)
        res = _residual_norms(((counted(v.view(shape)).reshape(-1), lam_i, v)
                               for lam_i, v in zip(lam, ritz)), allreduce)
    if stats is not None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        stats.update(restarts=cycles, matvecs=calls[0],
                     secs=time.perf_counter() - t0)
    return EigResult(evals=lam, evecs=ritz.view((nev,) + tuple(shape)),
                     resid=res)


def deflate_guess(evecs: torch.Tensor, evals: torch.Tensor,
                  b: torch.Tensor,
                  allreduce: Optional[Callable] = None) -> torch.Tensor:
    """x0 = V diag(1/λ) V† b, the exact low-mode solution as an initial
    guess (the reference's ``deflateVector``); ``allreduce`` sums the
    nev dots over the ring as one vector."""
    e = evecs.reshape(evecs.shape[0], -1)
    c = _dots(e, b.reshape(-1), allreduce) / evals.to(b.dtype)
    return torch.mv(e.transpose(0, 1), c).view(b.shape)


def project_out(evecs: torch.Tensor, v: torch.Tensor,
                allreduce: Optional[Callable] = None) -> torch.Tensor:
    """v without its component in the deflation space (the reference's
    ``projectVector``); ``allreduce`` as in ``deflate_guess``."""
    e = evecs.reshape(evecs.shape[0], -1)
    return v - torch.mv(e.transpose(0, 1),
                        _dots(e, v.reshape(-1), allreduce)).view(v.shape)
