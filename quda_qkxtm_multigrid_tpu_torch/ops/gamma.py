"""Dirac gamma matrices in the DeGrand-Rossi basis and spin projectors.

A copy of the JAX package's numpy tables (importing that module would
import ``jax``).  ``PROJ[mu, 0] = 1 - gamma_mu`` (forward hop, no
dagger) and ``PROJ[mu, 1] = 1 + gamma_mu``; gamma5 = diag(+1,+1,-1,-1).
The conventional 1/2 of the Wilson projectors is folded into kappa.
"""

from __future__ import annotations

import numpy as np
import torch

_i = 1j

# gamma_mu, mu = 0(x), 1(y), 2(z), 3(t), DeGrand-Rossi basis.
GAMMA = np.zeros((4, 4, 4), dtype=np.complex128)
GAMMA[0] = [[0, 0, 0, _i], [0, 0, _i, 0], [0, -_i, 0, 0], [-_i, 0, 0, 0]]
GAMMA[1] = [[0, 0, 0, -1], [0, 0, 1, 0], [0, 1, 0, 0], [-1, 0, 0, 0]]
GAMMA[2] = [[0, 0, _i, 0], [0, 0, 0, -_i], [-_i, 0, 0, 0], [0, _i, 0, 0]]
GAMMA[3] = [[0, 0, 1, 0], [0, 0, 0, 1], [1, 0, 0, 0], [0, 1, 0, 0]]

GAMMA5 = (GAMMA[0] @ GAMMA[1] @ GAMMA[2] @ GAMMA[3]).real.astype(np.complex128)
if not np.allclose(GAMMA5, np.diag([1, 1, -1, -1])):
    raise AssertionError(f"gamma5 sign convention broken: {GAMMA5}")

IDENTITY = np.eye(4, dtype=np.complex128)

# PROJ[mu, 0] = 1 - gamma_mu (forward, no dagger); PROJ[mu, 1] = 1 + gamma_mu.
PROJ = np.stack(
    [np.stack([IDENTITY - GAMMA[mu], IDENTITY + GAMMA[mu]]) for mu in range(4)]
)

# The 16-element basis of the contractions: index g holds the product
# gamma_1^a gamma_2^b gamma_3^c gamma_4^d with bits (a, b, c, d) of g.
GAMMA_BASIS = np.zeros((16, 4, 4), dtype=np.complex128)
for _g in range(16):
    _m = IDENTITY
    for _mu in range(4):
        if (_g >> _mu) & 1:
            _m = _m @ GAMMA[_mu]
    GAMMA_BASIS[_g] = _m


def apply_gamma5(psi: torch.Tensor) -> torch.Tensor:
    """gamma5 psi for a canonical spinor [..., 4, 3, T, Z, W] (spin at
    axis -5; diagonal in the DR basis)."""
    sign = torch.tensor([1.0, 1.0, -1.0, -1.0], dtype=psi.real.dtype,
                        device=psi.device).reshape(4, 1, 1, 1, 1)
    return psi * sign


def apply_gamma(mu_or_matrix, psi: torch.Tensor) -> torch.Tensor:
    """A 4×4 spin matrix (an index into ``GAMMA``, or an explicit matrix)
    over the spin axis of a spinor [..., 4, 3, T, Z, W] (axis −5): Σ_t
    m[s, t] ψ[t], each output spin a sum of four terms, in ψ's
    precision."""
    m = GAMMA[mu_or_matrix] if isinstance(mu_or_matrix, int) \
        else np.asarray(mu_or_matrix)
    g = torch.as_tensor(m, dtype=psi.dtype, device=psi.device)
    return sum(g[:, t].reshape(4, 1, 1, 1, 1) * psi.narrow(-5, t, 1)
               for t in range(4))
