"""Aggregation transfer: geometric blocks, chirality-preserving spin
blocks, block orthonormalisation, restrict (R) and prolong (P).

Conventions (those of the JAX package's ``mg/transfer.py``):
  * geometric blocks (bx, by, bz, bt), 4⁴ by default;
  * spin block size 2 at the fine level: coarse spin = the 2
    chiralities, exact blocks of γ5 = diag(+,+,−,−) in the DeGrand-Rossi
    basis; coarse dof per site = 2 × nvec;
  * coarse field [2(chir), nvec, Tc, Zc, Yc, Xc].

Flat blocked layout, the one ``Transfer`` works in:
[2(ch), Tc, Zc, Yc, Xc, bdof] with bdof = block_volume × 2(spin) × 3
(intra-block site t-major and x-minor, then spin, then colour).  V is
stored complex, aggregate-major: [2(ch), Tc, Zc, Yc, Xc, nvec, bdof], the
JAX package's planar (vr, vi) pair as one complex tensor, so that
restrict and prolong are batched [nvec × bdof] matrix-vector products
over the (chirality, aggregate) pairs, each one pass over V.  Float32
products run in full float32 whatever the caller has set: each product
runs under ``utils.precision.full_float32``.
"""

from __future__ import annotations

import dataclasses

import torch

from quda_qkxtm_multigrid_tpu_torch.lattice import (
    Geometry, spinor_from_lex_dof_leading, spinor_to_lex_dof_leading)
from quda_qkxtm_multigrid_tpu_torch.utils.precision import full_float32


@dataclasses.dataclass(frozen=True)
class BlockGeometry:
    fine: Geometry
    bx: int = 4
    by: int = 4
    bz: int = 4
    bt: int = 4
    nvec: int = 24

    def __post_init__(self):
        for d, b in zip(self.fine.dims, (self.bx, self.by, self.bz, self.bt)):
            if d % b:
                raise ValueError(f"block {b} does not divide dim {d}")

    @property
    def coarse_dims(self):
        f = self.fine
        return (f.X // self.bx, f.Y // self.by, f.Z // self.bz, f.T // self.bt)

    @property
    def block_volume(self) -> int:
        return self.bx * self.by * self.bz * self.bt

    @property
    def coarse_shape(self):
        xc, yc, zc, tc = self.coarse_dims
        return (tc, zc, yc, xc)

    @property
    def coarse_volume(self) -> int:
        xc, yc, zc, tc = self.coarse_dims
        return xc * yc * zc * tc

    @property
    def coarse_dof(self) -> int:
        return 2 * self.nvec

    @property
    def bdof(self) -> int:
        return self.block_volume * 6


def to_blocked_flat(psi: torch.Tensor, bg: BlockGeometry) -> torch.Tensor:
    """[..., 2,4,3,T,Z,W] → [..., 2(ch), Tc,Zc,Yc,Xc, bdof]."""
    g = bg.fine
    xc, yc, zc, tc = bg.coarse_dims
    lead = psi.shape[:-6]
    k = len(lead)
    lexd = spinor_to_lex_dof_leading(psi, g)        # [...,4,3,T,Z,Y,X]
    s = lexd.reshape(*lead, 2, 2, 3, tc, bg.bt, zc, bg.bz, yc, bg.by,
                     xc, bg.bx)
    #      ch s r tc bt zc bz yc by xc bx  →  ch tc zc yc xc bt bz by bx s r
    perm = [0, 3, 5, 7, 9, 4, 6, 8, 10, 1, 2]
    s = s.permute(*range(k), *(k + i for i in perm))
    return s.reshape(*lead, 2, tc, zc, yc, xc, bg.bdof)


def from_blocked_flat(flat: torch.Tensor, bg: BlockGeometry) -> torch.Tensor:
    """[..., 2(ch), Tc,Zc,Yc,Xc, bdof] → [..., 2,4,3,T,Z,W]."""
    g = bg.fine
    xc, yc, zc, tc = bg.coarse_dims
    lead = flat.shape[:-6]
    k = len(lead)
    s = flat.reshape(*lead, 2, tc, zc, yc, xc, bg.bt, bg.bz, bg.by, bg.bx,
                     2, 3)
    #      ch tc zc yc xc bt bz by bx s r  →  ch s r tc bt zc bz yc by xc bx
    perm = [0, 9, 10, 1, 5, 2, 6, 3, 7, 4, 8]
    s = s.permute(*range(k), *(k + i for i in perm))
    lexd = s.reshape(*lead, 4, 3, g.T, g.Z, g.Y, g.X)
    return spinor_from_lex_dof_leading(lexd, g)


@full_float32()
def cholqr_pass(v: torch.Tensor) -> torch.Tensor:
    """One CholQR pass over an aggregate-major stack [..., n, d] of n
    vectors each: per batch row the Gram matrix G = L L† of the vectors,
    then v_n ← Σ_m conj(L⁻¹)[n, m] v_m.  Only the small [A, n, n]
    factors go to the Cholesky and triangular solves."""
    shp = v.shape
    n, d = shp[-2], shp[-1]
    v = v.reshape(-1, n, d)
    # G[m, n] = sum_d conj(v[m, d]) v[n, d] = conj(V V†); V† is a
    # conjugate-transpose view, which the matrix product reads in place
    g = torch.matmul(v, v.mH).conj()
    lower = torch.linalg.cholesky(g)
    eye = torch.eye(n, dtype=v.dtype, device=v.device).expand_as(lower)
    linv = torch.linalg.solve_triangular(lower, eye, upper=False)
    # new v_n = sum_m conj(L⁻¹)[n, m] v_m
    return torch.matmul(linv.conj(), v).reshape(shp)


def block_orthonormalize_flat(v_stacked: torch.Tensor) -> torch.Tensor:
    """CholQR² of stacked flat null vectors [nvec, 2, Tc,Zc,Yc,Xc, bdof]
    → V [2, Tc,Zc,Yc,Xc, nvec, bdof], orthonormal within every
    (chirality, aggregate)."""
    return cholqr_pass(cholqr_pass(torch.movedim(v_stacked, 0, -2)))


@dataclasses.dataclass(frozen=True)
class Transfer:
    """Aggregation V (orthonormal per aggregate and chirality), complex
    [2(ch), Tc,Zc,Yc,Xc, nvec, bdof]."""

    v: torch.Tensor
    bg: BlockGeometry

    def _mat(self) -> torch.Tensor:
        bg = self.bg
        return self.v.reshape(2 * bg.coarse_volume, bg.nvec, bg.bdof)

    @full_float32()
    def restrict_flat(self, flat: torch.Tensor) -> torch.Tensor:
        """A blocked fine field [2, Tc..Xc, bdof] → S = V† f per
        (chirality, aggregate): [2, Tc..Xc, nvec].  Computed as the row
        vector f V†, with V† a conjugate-transpose view: the batched
        product then runs as one matrix-vector pass that reads V once in
        storage layout (V conj(f) with a lazy conj took 9× longer on an
        H100, PERF.md)."""
        bg = self.bg
        f = flat.reshape(2 * bg.coarse_volume, 1, bg.bdof)
        s = torch.matmul(f, self._mat().mH)              # [2A, 1, nvec]
        return s.reshape(2, *bg.coarse_shape, bg.nvec)

    def restrict(self, psi: torch.Tensor) -> torch.Tensor:
        """fine [2,4,3,T,Z,W] → coarse [2(ch), nvec, Tc,Zc,Yc,Xc]."""
        s = self.restrict_flat(to_blocked_flat(psi, self.bg))
        return torch.movedim(s, -1, 1).contiguous()

    @full_float32()
    def prolong(self, vc: torch.Tensor) -> torch.Tensor:
        """coarse [2, nvec, Tc,Zc,Yc,Xc] → fine [2,4,3,T,Z,W]."""
        bg = self.bg
        w = torch.movedim(vc, 1, -1).reshape(2 * bg.coarse_volume, bg.nvec, 1)
        f = torch.matmul(self._mat().transpose(1, 2), w)   # [2A, bdof, 1]
        return from_blocked_flat(f.reshape(2, *bg.coarse_shape, bg.bdof), bg)
