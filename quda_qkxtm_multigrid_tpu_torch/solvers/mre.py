"""Minimum-residual extrapolation over earlier solutions, the
chronological initial guess (reference MinResExt, include/invert_quda.h:664,
lib/inv_mre.cpp): the JAX package's ``solvers/mre.py``.

For a history {x_i} of solutions of nearby systems, the guess for a new
right-hand side b is x = Σ c_i x_i minimising |b − A x|², the small
hermitian system

    G c = h,   G_ij = <A x_i, A x_j>,   h_i = <A x_i, b>.

The history is one tensor [n, ...field]; A is applied to all of it at
once through ``matvec_batched`` where the caller has one (on the card
the multi-source chain, K2 at n = depth), and G and h are two matrix
products on the device.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


def min_res_ext(matvec: Callable, b: torch.Tensor, history: torch.Tensor,
                matvec_batched: Optional[Callable] = None) -> torch.Tensor:
    """The minimum-residual combination of ``history`` [n, ...field] as an
    initial guess for A x = b.  ``matvec_batched`` applies A to the whole
    history (default: one field at a time)."""
    n = history.shape[0]
    ax = (matvec_batched(history) if matvec_batched is not None
          else torch.stack([matvec(h) for h in history]))
    flat = ax.reshape(n, -1)
    g = flat.conj() @ flat.T                     # [n, n] Gram
    h = flat.conj() @ b.reshape(-1)              # [n]
    # Tikhonov floor: nearly parallel history vectors (successive sources
    # that differ little) make G singular
    eps = 1e-10 if b.dtype == torch.complex128 else 1e-5
    g = g + (eps * torch.trace(g).real).to(g.dtype) * torch.eye(
        n, dtype=g.dtype, device=g.device)
    c = torch.linalg.solve(g, h)
    return (c @ history.reshape(n, -1)).view(b.shape)


class ChronoHistory:
    """Rolling store of the last ``depth`` solutions (the reference's
    resident chrono basis, quda.h make_resident_solution / chrono_*);
    ``guess`` projects a new right-hand side onto it with
    ``min_res_ext``."""

    def __init__(self, depth: int = 8):
        self.depth = depth
        self._xs: list = []

    def push(self, x: torch.Tensor) -> None:
        self._xs.append(x)
        if len(self._xs) > self.depth:
            self._xs.pop(0)

    def __len__(self) -> int:
        return len(self._xs)

    def guess(self, matvec: Callable, b: torch.Tensor,
              matvec_batched: Optional[Callable] = None) -> torch.Tensor:
        if not self._xs:
            return torch.zeros_like(b)
        return min_res_ext(matvec, b, torch.stack(self._xs), matvec_batched)
