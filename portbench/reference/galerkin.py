"""The aggregation transfer and the Galerkin coarse operator, plain.

V (the port's set-up output, judged here) is [2(chirality), Tc, Zc, Yc,
Xc, nvec, bdof]: for each chirality and aggregate, nvec vectors over the
block's sites (t-major, x-minor), the chirality's two spins and three
colours.  A coarse field is [2, nvec, Tc, Zc, Yc, Xc].  The coarse
operator is read from its own matrices: X [cvol, dof, dof] on the site
and Y [8, cvol, dof, dof] on the hops, direction d = 2μ + (0 forward,
reading the field at x + μ | 1 backward, at x − μ), dof = chirality ·
nvec + vector.
"""

from __future__ import annotations

import torch

_COARSE_AXIS = {0: -1, 1: -2, 2: -3, 3: -4}    # of [.., Tc, Zc, Yc, Xc]


def prolong(v: torch.Tensor, e: torch.Tensor, block) -> torch.Tensor:
    """P e: coarse [2, nvec, Tc, Zc, Yc, Xc] → lexicographic fine [T, Z,
    Y, X, 4, 3] (in ``e``'s dtype)."""
    bx, by, bz, bt = block
    _, tc, zc, yc, xc, nvec, bdof = v.shape
    f = torch.einsum("ctzyxnd,cntzyx->ctzyxd", v.to(e.dtype), e)
    f = f.reshape(2, tc, zc, yc, xc, bt, bz, by, bx, 2, 3)
    f = f.permute(1, 5, 2, 6, 3, 7, 4, 8, 0, 9, 10)
    return f.reshape(tc * bt, zc * bz, yc * by, xc * bx, 4, 3)


def restrict(v: torch.Tensor, psi: torch.Tensor, block) -> torch.Tensor:
    """V† ψ: lexicographic fine [T, Z, Y, X, 4, 3] → coarse [2, nvec, Tc,
    Zc, Yc, Xc]."""
    bx, by, bz, bt = block
    _, tc, zc, yc, xc, nvec, bdof = v.shape
    f = psi.reshape(tc, bt, zc, bz, yc, by, xc, bx, 2, 2, 3)
    f = f.permute(8, 0, 2, 4, 6, 1, 3, 5, 7, 9, 10).reshape(
        2, tc, zc, yc, xc, bdof)
    return torch.einsum("ctzyxnd,ctzyxd->cntzyx", v.to(psi.dtype).conj(), f)


def coarse_apply(x: torch.Tensor, y: torch.Tensor, e: torch.Tensor,
                 dtype=torch.complex128) -> torch.Tensor:
    """D_c e from the matrices X and Y, in ``dtype``."""
    shape = e.shape
    dof, cvol = shape[0] * shape[1], e[0, 0].numel()
    e = e.to(dtype)
    flat = e.reshape(dof, cvol)
    out = torch.einsum("sab,bs->as", x.to(dtype), flat)
    lat = e.reshape((dof,) + tuple(shape[2:]))
    for d in range(8):
        mu, back = divmod(d, 2)
        nb = torch.roll(lat, 1 if back else -1, dims=_COARSE_AXIS[mu])
        out = out + torch.einsum("sab,bs->as", y[d].to(dtype),
                                 nb.reshape(dof, cvol))
    return out.reshape(shape)


def orthonormality_gap(v: torch.Tensor) -> float:
    """max |V V† − 1| over every (chirality, aggregate), in complex128,
    one coarse t row at a time."""
    worst = 0.0
    nvec = v.shape[-2]
    eye = torch.eye(nvec, dtype=torch.complex128, device=v.device)
    for t in range(v.shape[1]):
        row = v[:, t].to(torch.complex128)
        g = torch.einsum("...nd,...md->...nm", row, row.conj())
        worst = max(worst, float((g - eye).abs().max()))
    return worst
