"""Multi-source CG: independent CG solves over a batch of right-hand
sides that share every operator application (the analogue of QUDA's
invertMultiSrcQuda).

The batch is the leading axis of every field; α and β are per-source
vectors.  A source that has converged is frozen (α = β = 0) until the
slowest one finishes.  A Python loop: the stopping test reads the
per-source |r|² on the host once per iteration.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class MultiSrcResult(NamedTuple):
    x: torch.Tensor        # [n_src, ...field]
    iters: int
    r2: torch.Tensor       # [n_src]


def _dots(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Re <a_i, c_i> per source: [n_src]."""
    n = a.shape[0]
    return (a.conj() * c).reshape(n, -1).sum(dim=1).real


def msrc_cg(matvec_batched: Callable, b: torch.Tensor, tol: float = 1e-10,
            maxiter: int = 1000) -> MultiSrcResult:
    """``matvec_batched`` applies A to [n_src, ...field]."""
    n = b.shape[0]
    lead = (n,) + (1,) * (b.dim() - 1)
    b2 = _dots(b, b)
    target = (tol * tol) * b2
    x = torch.zeros_like(b)
    r = b.clone()
    p = b.clone()
    r2 = b2
    k = 0
    while k < maxiter and bool((r2 > target).any()):
        active = r2 > target
        ap = matvec_batched(p)
        pap = _dots(p, ap)
        alpha = torch.where(active, r2 / torch.where(pap > 0, pap, 1.0), 0.0)
        al = alpha.to(b.dtype).reshape(lead)
        x = x + al * p
        r = r - al * ap
        r2_new = _dots(r, r)
        beta = torch.where(active, r2_new / torch.where(r2 > 0, r2, 1.0), 0.0)
        p = r + beta.to(b.dtype).reshape(lead) * p
        r2 = r2_new
        k += 1
    return MultiSrcResult(x, k, r2)
