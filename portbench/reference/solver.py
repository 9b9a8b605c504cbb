"""A plain solver for the controls: CG on the normal equations
M†M x = M†b, with M† = γ5 M(−μ) γ5 (the twisted-clover operator is
γ5-hermitian up to the sign of the twist)."""

from __future__ import annotations

import torch

from portbench.reference.operator import TwistedClover


def _g5(psi: torch.Tensor) -> torch.Tensor:
    sign = torch.tensor([1.0, 1.0, -1.0, -1.0], dtype=psi.real.dtype,
                        device=psi.device).reshape(4, 1)
    return psi * sign


def _dot(a, b) -> float:
    return float(torch.vdot(a.reshape(-1), b.reshape(-1)).real)


def cgnr(op: TwistedClover, b: torch.Tensor, tol: float,
         maxiter: int) -> tuple[torch.Tensor, int]:
    """x with |M†(b − M x)| ≤ tol |M†b| by CG's own residual, or after
    ``maxiter`` iterations; ``b`` lexicographic [T, Z, Y, X, 4, 3], every
    vector in ``op.dtype``.  Returns (x, iterations)."""
    minus = TwistedClover(op.u, op.dims, op.kappa, -op.mu, op.csw,
                          dtype=op.dtype, slab=op.slab, round_fn=op.round,
                          keep_clover=op.kept is not None)
    if op.kept is not None:
        minus.kept = op.kept        # F does not depend on μ

    def mdag(v):
        return _g5(minus.apply_lex(_g5(v)))

    b = b.to(op.dtype)
    x = torch.zeros_like(b)
    r = mdag(b)
    p = r.clone()
    rr = _dot(r, r)
    target = tol * tol * rr
    it = 0
    while it < maxiter and rr > target:
        q = op.apply_lex(p)
        alpha = rr / _dot(q, q)
        x = x + alpha * p
        r = r - alpha * mdag(q)
        rr_new = _dot(r, r)
        p = r + (rr_new / rr) * p
        rr = rr_new
        it += 1
    return x, it
