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

The bf16 storage tier (``MGParams.vec_dtype="bf16"``) keeps V as a
planar pair of bf16 tensors, ``Bf16Transfer``: PyTorch has no complex
bf16.  Its restrict and prolong cast the field to bf16 as well and
accumulate in float32 (the JAX package's ``Transfer._ein``).

Between coarse levels (MG level ≥ 2) the transfer is dof-generic,
``CoarseTransfer``: a coarse field [ns=2, nc, T1,Z1,Y1,X1] is blocked
geometrically into [T2,Z2,Y2,X2, bv, ns, nc]; the coarse spin is
preserved, and each (aggregate, spin) holds nvec2 orthonormal vectors
over (bv, nc).
"""

from __future__ import annotations

import dataclasses

import torch

from quda_qkxtm_multigrid_tpu_torch.lattice import (
    Geometry, spinor_from_lex_dof_leading, spinor_to_lex_dof_leading)
from quda_qkxtm_multigrid_tpu_torch.parallel.mesh import local_geometry
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


def slab_block_geometry(bg: BlockGeometry, mesh) -> tuple:
    """(the blocking of this rank's box, ((first, count) of its coarse t,
    z and y rows)): aggregates do not straddle boxes, so the block's t, z
    and y extents must divide the box's.  The box's origin is even, so
    its blocked layout is the whole lattice's restricted to those
    rows."""
    gl = local_geometry(bg.fine, mesh)
    for name, b, n in (("t", bg.bt, gl.T), ("z", bg.bz, gl.Z),
                       ("y", bg.by, gl.Y)):
        if n % b:
            raise ValueError(f"the block's {name} extent {b} does not "
                             f"divide the box's {n}")
    box = BlockGeometry(gl, bg.bx, bg.by, bg.bz, bg.bt, bg.nvec)
    tc, zc, yc, _ = bg.coarse_shape
    return box, tuple(mesh.box_range(a, n)
                      for a, n in enumerate((tc, zc, yc)))


def _narrow_box(v: torch.Tensor, ranges) -> torch.Tensor:
    """V [2, Tc, Zc, Yc, ...] narrowed to a box's coarse rows."""
    for axis, (first, count) in enumerate(ranges, start=1):
        v = v.narrow(axis, first, count)
    return v.contiguous()


@dataclasses.dataclass(frozen=True)
class Transfer:
    """Aggregation V (orthonormal per aggregate and chirality), complex
    [2(ch), Tc,Zc,Yc,Xc, nvec, bdof]."""

    v: torch.Tensor
    bg: BlockGeometry

    def _mat(self) -> torch.Tensor:
        bg = self.bg
        return self.v.reshape(2 * bg.coarse_volume, bg.nvec, bg.bdof)

    def t_slab(self, mesh) -> "Transfer":
        """This rank's aggregates on ``mesh``
        (``parallel.mesh.LatticeMesh``): V narrowed to the rank's coarse
        t, z and y rows (the whole V itself on a mesh of one), on the
        box's fine geometry (``slab_block_geometry``)."""
        bg, ranges = slab_block_geometry(self.bg, mesh)
        return Transfer(v=_narrow_box(self.v, ranges), bg=bg)

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


@dataclasses.dataclass(frozen=True)
class Bf16Transfer:
    """The bf16 storage tier of ``Transfer``: V as the planar pair
    (``vr``, ``vi``) of bf16 tensors [2(ch), Tc,Zc,Yc,Xc, nvec, bdof],
    half the bytes of the complex64 V.  Restrict and prolong round the
    field to bf16 too, and accumulate and return float32: per tc box,
    the box of V is widened to float32 (a product of two bf16 values is
    exact in float32), so no float32 copy of the whole V exists (the
    JAX package's ``lax.map`` over tc boxes)."""

    vr: torch.Tensor
    vi: torch.Tensor
    bg: BlockGeometry

    @classmethod
    def from_transfer(cls, tr: Transfer) -> "Bf16Transfer":
        """The pair rounded from a complex V (which the caller frees)."""
        return cls(vr=tr.v.real.to(torch.bfloat16),
                   vi=tr.v.imag.to(torch.bfloat16), bg=tr.bg)

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (self.vr, self.vi))

    def t_slab(self, mesh) -> "Bf16Transfer":
        """``Transfer.t_slab`` of the bf16 pair: both planes narrowed."""
        bg, ranges = slab_block_geometry(self.bg, mesh)
        return Bf16Transfer(vr=_narrow_box(self.vr, ranges),
                            vi=_narrow_box(self.vi, ranges), bg=bg)

    def _slab(self, a: int) -> torch.Tensor:
        """tc box ``a`` of V, complex64 from the bf16 pair:
        [2, Zc,Yc,Xc, nvec, bdof]."""
        return torch.complex(self.vr[:, a].float(), self.vi[:, a].float())

    @staticmethod
    def _round(f: torch.Tensor) -> torch.Tensor:
        """A complex field with both planes rounded to bf16, complex64."""
        return torch.complex(f.real.to(torch.bfloat16).float(),
                             f.imag.to(torch.bfloat16).float())

    @full_float32()
    def restrict(self, psi: torch.Tensor) -> torch.Tensor:
        """fine [2,4,3,T,Z,W] → coarse [2(ch), nvec, Tc,Zc,Yc,Xc] (S =
        V† f per aggregate, as ``Transfer.restrict``), accumulated in
        float32 and returned in the field's dtype."""
        bg = self.bg
        flat = self._round(to_blocked_flat(psi, bg))   # [2, Tc.., bdof]
        tc, zc, yc, xc = bg.coarse_shape
        out = []
        for a in range(tc):
            f = flat[:, a].reshape(-1, 1, bg.bdof)
            v = self._slab(a).reshape(-1, bg.nvec, bg.bdof)
            out.append(torch.matmul(f, v.mH).reshape(2, zc, yc, xc, bg.nvec))
        s = torch.movedim(torch.stack(out, dim=1), -1, 1)
        return s.to(psi.dtype).contiguous()

    @full_float32()
    def prolong(self, vc: torch.Tensor) -> torch.Tensor:
        """coarse [2, nvec, Tc,Zc,Yc,Xc] → fine [2,4,3,T,Z,W], accumulated
        in float32 and returned in the coarse field's dtype."""
        bg = self.bg
        w = self._round(torch.movedim(vc, 1, -1))    # [2, Tc.., nvec]
        tc = bg.coarse_shape[0]
        out = []
        for a in range(tc):
            wa = w[:, a].reshape(-1, bg.nvec, 1)
            v = self._slab(a).reshape(-1, bg.nvec, bg.bdof)
            out.append(torch.matmul(v.transpose(1, 2), wa).reshape(
                2, *bg.coarse_shape[1:], bg.bdof))
        return from_blocked_flat(torch.stack(out, dim=1), bg).to(vc.dtype)


# ---- between coarse levels (MG level >= 2) -------------------------------

@dataclasses.dataclass(frozen=True)
class CoarseBlockGeometry:
    """Geometric blocking of a coarse lattice of shape ``fine_shape``
    (T1, Z1, Y1, X1), whose fields are [fine_ns, fine_nc, T1,Z1,Y1,X1],
    into aggregates of (bx, by, bz, bt) sites with ``nvec`` vectors each
    per coarse spin."""

    fine_shape: tuple
    fine_ns: int
    fine_nc: int
    bx: int = 2
    by: int = 2
    bz: int = 2
    bt: int = 2
    nvec: int = 24

    def __post_init__(self):
        t1, z1, y1, x1 = self.fine_shape
        for d, b in ((x1, self.bx), (y1, self.by), (z1, self.bz),
                     (t1, self.bt)):
            if d % b:
                raise ValueError(
                    f"block does not divide coarse dim: {self.fine_shape} "
                    f"/ ({self.bt},{self.bz},{self.by},{self.bx})")

    @property
    def coarse_shape(self):
        t1, z1, y1, x1 = self.fine_shape
        return (t1 // self.bt, z1 // self.bz, y1 // self.by, x1 // self.bx)

    @property
    def block_volume(self) -> int:
        return self.bx * self.by * self.bz * self.bt

    @property
    def coarse_volume(self) -> int:
        t2, z2, y2, x2 = self.coarse_shape
        return t2 * z2 * y2 * x2

    @property
    def coarse_dof(self) -> int:
        return self.fine_ns * self.nvec


def to_blocked_coarse(vc: torch.Tensor,
                      bg: CoarseBlockGeometry) -> torch.Tensor:
    """[..., ns, nc, T1,Z1,Y1,X1] → [..., T2,Z2,Y2,X2, bv, ns, nc]."""
    ns, nc = bg.fine_ns, bg.fine_nc
    t2, z2, y2, x2 = bg.coarse_shape
    lead = vc.shape[:-6]
    k = len(lead)
    r = vc.reshape(*lead, ns, nc, t2, bg.bt, z2, bg.bz, y2, bg.by, x2, bg.bx)
    #      ns nc t2 bt z2 bz y2 by x2 bx  →  t2 z2 y2 x2 bt bz by bx ns nc
    perm = [2, 4, 6, 8, 3, 5, 7, 9, 0, 1]
    r = r.permute(*range(k), *(k + i for i in perm))
    return r.reshape(*lead, t2, z2, y2, x2, bg.block_volume, ns, nc)


def from_blocked_coarse(blk: torch.Tensor,
                        bg: CoarseBlockGeometry) -> torch.Tensor:
    """[..., T2,Z2,Y2,X2, bv, ns, nc] → [..., ns, nc, T1,Z1,Y1,X1]."""
    ns, nc = bg.fine_ns, bg.fine_nc
    t2, z2, y2, x2 = bg.coarse_shape
    lead = blk.shape[:-7]
    k = len(lead)
    r = blk.reshape(*lead, t2, z2, y2, x2, bg.bt, bg.bz, bg.by, bg.bx, ns, nc)
    #      t2 z2 y2 x2 bt bz by bx ns nc  →  ns nc t2 bt z2 bz y2 by x2 bx
    perm = [8, 9, 0, 4, 1, 5, 2, 6, 3, 7]
    r = r.permute(*range(k), *(k + i for i in perm))
    return r.reshape(*lead, ns, nc, *bg.fine_shape)


def block_orthonormalize_coarse(v_blocked: torch.Tensor) -> torch.Tensor:
    """v_blocked [nvec2, T2,Z2,Y2,X2, bv, ns, nc] → the same, orthonormal
    within every (aggregate, coarse spin) over the (bv, nc) axes:
    CholQR² on the aggregate-major stack [A, ns, nvec2, bv·nc]."""
    n = v_blocked.shape[0]
    bv, ns, nc = v_blocked.shape[-3:]
    lead = v_blocked.shape[1:5]
    v = v_blocked.reshape(n, -1, bv, ns, nc).permute(1, 3, 0, 2, 4)
    v = cholqr_pass(cholqr_pass(v.reshape(-1, ns, n, bv * nc)))
    v = v.reshape(-1, ns, n, bv, nc).permute(2, 0, 3, 1, 4)
    return v.reshape(n, *lead, bv, ns, nc).contiguous()


@dataclasses.dataclass(frozen=True)
class CoarseTransfer:
    """Aggregation between coarse layouts: restrict [ns, nc1, T1..X1] →
    [ns, nvec2, T2..X2] with the coarse spin preserved, prolong back.  V
    [nvec2, T2,Z2,Y2,X2, bv, ns, nc1], the JAX package's layout; the
    construction stores it aggregate-major, [A, ns, nvec2, bv·nc1] (the
    operand of the per-(aggregate, spin) products), and ``v`` becomes a
    view of that."""

    v: torch.Tensor
    bg: CoarseBlockGeometry

    def __post_init__(self):
        bg = self.bg
        n, bv, ns, nc = bg.nvec, bg.block_volume, bg.fine_ns, bg.fine_nc
        mat = self.v.reshape(n, -1, bv, ns, nc).permute(1, 3, 0, 2, 4) \
            .reshape(-1, ns, n, bv * nc)
        object.__setattr__(self, "_mat", mat)
        object.__setattr__(self, "v", mat.view(-1, ns, n, bv, nc).permute(
            2, 0, 3, 1, 4).unflatten(1, tuple(bg.coarse_shape)))

    def _blocked_rows(self, blk: torch.Tensor) -> tuple:
        """[..., T2..X2, bv, ns, nc] → ([A, ns, B, bv·nc], the leading
        shape (...) whose product is B)."""
        bg = self.bg
        lead = blk.shape[:-7]
        bv, ns, nc = bg.block_volume, bg.fine_ns, bg.fine_nc
        f = blk.reshape(-1, bg.coarse_volume, bv, ns, nc)
        return f.permute(1, 3, 0, 2, 4).reshape(bg.coarse_volume, ns, -1,
                                                 bv * nc), lead

    @full_float32()
    def restrict_blocked(self, blk: torch.Tensor) -> torch.Tensor:
        """A blocked field [..., T2..X2, bv, ns, nc] → [..., ns, nvec2,
        T2..X2]: S = Σ_(bv, nc) conj(V)·blk per (aggregate, spin), as the
        row vectors f V† (V† a conjugate-transpose view)."""
        bg = self.bg
        f, lead = self._blocked_rows(blk)
        s = torch.matmul(f, self._mat.mH)            # [A, ns, B, n]
        s = s.permute(2, 1, 3, 0)
        return s.reshape(*lead, bg.fine_ns, bg.nvec, *bg.coarse_shape)

    def restrict(self, vc: torch.Tensor) -> torch.Tensor:
        """[..., ns, nc1, T1..X1] → [..., ns, nvec2, T2..X2]."""
        return self.restrict_blocked(to_blocked_coarse(vc, self.bg))

    @full_float32()
    def prolong(self, vc2: torch.Tensor) -> torch.Tensor:
        """[..., ns, nvec2, T2..X2] → [..., ns, nc1, T1..X1]."""
        bg = self.bg
        lead = vc2.shape[:-6]
        bv, ns, nc = bg.block_volume, bg.fine_ns, bg.fine_nc
        w = vc2.reshape(-1, ns, bg.nvec, bg.coarse_volume).permute(3, 1, 0, 2)
        f = torch.matmul(w, self._mat)                  # [A, ns, B, bv·nc]
        f = f.reshape(bg.coarse_volume, ns, -1, bv, nc).permute(2, 0, 3, 1, 4)
        blk = f.reshape(*lead, *bg.coarse_shape, bv, ns, nc)
        return from_blocked_coarse(blk, bg)
