"""Twisted-mass term: A = 1 + i·2κμ·flavor·γ5 (degenerate doublet).

DIRECT applies (1 + i a γ5), INVERSE applies (1 − i a γ5)/(1+a²),
a = 2κμ·flavor, dagger flips the sign of a; γ5 = diag(+,+,−,−).
Spin is axis -5 of a spinor [..., 4, 3, T, Z, W].
"""

from __future__ import annotations

import torch


def twist_apply(psi: torch.Tensor, kappa: float, mu: float, flavor: int = +1,
                dagger: bool = False, inverse: bool = False) -> torch.Tensor:
    """Apply the twist (or its inverse) to a spinor [..., 4, 3, T, Z, W]."""
    a = 2.0 * kappa * mu * flavor
    b = 1.0
    if inverse:
        a = -a
        b = 1.0 / (1.0 + a * a)
    if dagger:
        a = -a
    g5 = torch.tensor([1.0, 1.0, -1.0, -1.0], dtype=psi.real.dtype,
                      device=psi.device).reshape(4, 1, 1, 1, 1)
    return b * (psi + (1j * a) * g5 * psi)
