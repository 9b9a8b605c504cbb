"""Forward propagators: the counterpart of the JAX package's
``physics/propagator.py`` (the twelve spin-colour solves, the
twisted → physical basis rotation, the sink smearing).

Propagator layout [2(parity), 4(sink spin), 4(source spin), 3(sink
colour), 3(source colour), T, Z, W].
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from quda_qkxtm_multigrid_tpu_torch import fields
from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry
from quda_qkxtm_multigrid_tpu_torch.ops.smear import gaussian_smear


def assemble_prop(cols) -> torch.Tensor:
    """The 12 solutions of the columns (spin-major, then colour; each
    [2, 4, 3, T, Z, W], or one tensor [12, 2, 4, 3, T, Z, W]) → the
    propagator [2, 4, 4, 3, 3, T, Z, W]."""
    sols = torch.stack(list(cols)) if not torch.is_tensor(cols) else cols
    sols = sols.reshape((4, 3) + tuple(sols.shape[1:]))
    # [src_s, src_c, parity, snk_s, snk_c, T, Z, W] → canonical
    return sols.permute(2, 3, 0, 4, 1, 5, 6, 7)


def forward_propagator(solve: Callable, geom: Geometry, coords,
                       dtype=torch.complex64,
                       smear: Optional[Callable] = None, device="cuda"):
    """12 point-source solves → propagator.  ``solve(b) -> x`` solves
    M x = b; ``smear`` optionally smears each source first."""
    cols = []
    for spin in range(4):
        for col in range(3):
            b = fields.point_source(geom, coords, spin, col, dtype=dtype,
                                    device=device)
            if smear is not None:
                b = smear(b)
            cols.append(solve(b))
    return assemble_prop(cols)


def _g5(prop: torch.Tensor) -> torch.Tensor:
    return torch.tensor([1.0, 1.0, -1.0, -1.0], dtype=prop.real.dtype,
                        device=prop.device)


def rotate_to_physical(prop: torch.Tensor, sign: int) -> torch.Tensor:
    """S_phys = Ω S Ω, Ω = (1 + i·sign·γ5)/√2: the twisted → physical
    basis rotation (sign +1 for the up quark, −1 for the down)."""
    g5 = _g5(prop)
    left = prop + (1j * sign) * g5.reshape(1, 4, 1, 1, 1, 1, 1, 1) * prop
    out = left + (1j * sign) * left * g5.reshape(1, 1, 4, 1, 1, 1, 1, 1)
    return 0.5 * out


def propagator_gamma5_dag(prop: torch.Tensor) -> torch.Tensor:
    """γ5 S† γ5 with source and sink swapped: the opposite flavour's
    propagator by twisted-mass γ5-hermiticity."""
    g5 = _g5(prop)
    s = prop.transpose(1, 2).transpose(3, 4).conj()
    return (g5.reshape(1, 4, 1, 1, 1, 1, 1, 1) * s
            * g5.reshape(1, 1, 4, 1, 1, 1, 1, 1))


def smear_propagator(prop: torch.Tensor, u_smeared: torch.Tensor,
                     geom: Geometry, alpha: float, n: int,
                     t0: int | None = None, mesh=None) -> torch.Tensor:
    """Gaussian-smear the sink of all 12 columns at once (with ``t0``:
    ``prop`` is the timeslice t0 alone, ``gaussian_smear``'s; ``mesh``
    as there)."""
    p = prop.permute(2, 4, 0, 1, 3, 5, 6, 7)   # [src_s, src_c, 2, 4, 3, ...]
    p = gaussian_smear(p, u_smeared, geom, alpha, n, t0, mesh)
    return p.permute(2, 3, 0, 4, 1, 5, 6, 7)
