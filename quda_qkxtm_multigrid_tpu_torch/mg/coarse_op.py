"""Explicit coarse operator: a site-diagonal term X and 8 directional
links Y, the Galerkin product V†(op)V of the fine operator through the
transfer.

Layouts: coarse field vc [2(chir), nvec, Tc, Zc, Yc, Xc], whose dof
a = chir·nvec + vec; X [cvol, dof, dof] and Y [8, cvol, dof, dof],
site-major (the JAX package keeps the site axis last, [dof, dof, cvol],
for the TPU's tiling).  Direction d = 2·mu + (0 fwd | 1 bwd); the
forward term reads the field at xc + mu.  The operator stores X and Y
side by side, one [cvol, dof, 9·dof] tensor, and ``x`` / ``y`` are views
of it: an application is one gather of each site's 9 stencil entries
and one batched [dof × 9·dof] matrix-vector product, a handful of
kernel launches at every level.

Coarse stencil flops per site: 8·(8n²) − 2n, n = 2·nvec.

The next level down (MG level ≥ 2) is built the same way from a
``CoarseOperator`` through a ``CoarseTransfer``: ``coarse_diag_hops``
splits the operator into its diagonal and its 8 hop terms and
``build_coarse_op_direct_coarse`` runs the masked-source face split over
the dof-generic blocked layout (the reference's CoarseCoarseOp).  Its
``bg`` is then a ``CoarseBlockGeometry``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np
import torch

from quda_qkxtm_multigrid_tpu_torch.mg.transfer import (
    BlockGeometry, CoarseBlockGeometry, CoarseTransfer, Transfer,
    from_blocked_coarse, from_blocked_flat, to_blocked_coarse,
    to_blocked_flat)
from quda_qkxtm_multigrid_tpu_torch.utils.precision import full_float32


def _axis_of_mu(mu: int) -> int:
    """Axis of direction mu in a coarse field's trailing [Tc,Zc,Yc,Xc]."""
    return {0: -1, 1: -2, 2: -3, 3: -4}[mu]


@functools.lru_cache(maxsize=None)
def _stencil_index(coarse_shape: tuple) -> np.ndarray:
    """[9, cvol]: each site's flat index, then that of the site hop
    direction d = 2·mu + (0 fwd | 1 bwd) reads (x + mu, x − mu)."""
    idx = np.arange(int(np.prod(coarse_shape))).reshape(coarse_shape)
    rows = [idx.reshape(-1)]
    for mu in range(4):
        for shift in (-1, 1):
            rows.append(np.roll(idx, shift,
                                axis=_axis_of_mu(mu)).reshape(-1))
    return np.stack(rows)


@dataclasses.dataclass(frozen=True)
class CoarseOperator:
    """X and Y of a coarse level.  Construction copies them into one
    [cvol, dof, 9·dof] tensor (X, then Y_0..Y_7 per site) and replaces
    ``x`` and ``y`` by views of it."""

    x: torch.Tensor            # [cvol, dof, dof]
    y: torch.Tensor            # [8, cvol, dof, dof]
    bg: BlockGeometry | CoarseBlockGeometry

    def __post_init__(self):
        dof, cvol = self.bg.coarse_dof, self.bg.coarse_volume
        w = torch.cat([self.x.unsqueeze(0), self.y]).permute(1, 2, 0, 3)
        w = w.reshape(cvol, dof, 9 * dof)
        wv = w.view(cvol, dof, 9, dof)
        object.__setattr__(self, "_w", w)
        object.__setattr__(self, "x", wv[:, :, 0])
        object.__setattr__(self, "y", wv[:, :, 1:].permute(2, 0, 1, 3))
        object.__setattr__(self, "_idx", torch.tensor(
            _stencil_index(tuple(self.bg.coarse_shape)), device=w.device))

    @full_float32()
    def apply(self, vc: torch.Tensor) -> torch.Tensor:
        """vc [2, nvec, Tc,Zc,Yc,Xc] → D_c vc (same shape), its products
        in full float32."""
        dof, cvol = self.bg.coarse_dof, self.bg.coarse_volume
        g = vc.reshape(dof, cvol)[:, self._idx]            # [dof, 9, cvol]
        g = g.permute(2, 1, 0).reshape(cvol, 9 * dof, 1)
        out = torch.matmul(self._w, g)                     # [cvol, dof, 1]
        return out.reshape(cvol, dof).T.reshape(vc.shape)

    def flops_per_apply(self) -> int:
        n = self.bg.coarse_dof
        return (8 * (8 * n * n) - 2 * n) * self.bg.coarse_volume


def coarse_diag_hops(op: CoarseOperator):
    """(diagonal term, 8 hop terms) of ``op`` on coarse fields [...,
    ns, nc, T,Z,Y,X] (any leading batch): the inputs of the next level's
    build.  Hop d = 2·mu + (0 fwd | 1 bwd) applies Y_d to the field at
    x + mu (fwd: a roll by −1 along mu) or x − mu; the products run in
    full float32."""
    dof, cvol = op.bg.coarse_dof, op.bg.coarse_volume

    @full_float32()
    def sitewise(m, vc):
        v = vc.reshape(-1, dof, cvol).permute(2, 1, 0)     # [cvol, dof, B]
        return torch.matmul(m, v).permute(2, 1, 0).reshape(vc.shape)

    def diag_apply(vc):
        return sitewise(op.x, vc)

    def hop(vc, d):
        shift = -1 if d % 2 == 0 else 1
        return sitewise(op.y[d], torch.roll(vc, shift,
                                            dims=_axis_of_mu(d // 2)))

    return diag_apply, [functools.partial(hop, d=d) for d in range(8)]


def _coarse_parity_mask(coarse_shape) -> np.ndarray:
    tc, zc, yc, xc = coarse_shape
    t = np.arange(tc).reshape(-1, 1, 1, 1)
    z = np.arange(zc).reshape(1, -1, 1, 1)
    y = np.arange(yc).reshape(1, 1, -1, 1)
    x = np.arange(xc).reshape(1, 1, 1, -1)
    return (t + z + y + x) % 2


def _face_masks(bt: int, bz: int, by: int, bx: int) -> np.ndarray:
    """[8, block_volume] masks selecting, per hop direction d, the
    intra-block sites whose hop operand lies in the NEIGHBOURING
    aggregate: the forward term reads psi(x+mu), so the face with
    coordinate b−1 crosses; the backward term the face with coordinate
    0.  Intra-block order t-major, x-minor."""
    it, iz, iy, ix = np.meshgrid(np.arange(bt), np.arange(bz),
                                 np.arange(by), np.arange(bx),
                                 indexing="ij")
    coords = {0: (ix, bx), 1: (iy, by), 2: (iz, bz), 3: (it, bt)}
    masks = []
    for mu in range(4):
        c, b = coords[mu]
        masks.append((c == b - 1).reshape(-1))   # fwd
        masks.append((c == 0).reshape(-1))       # bwd
    return np.stack(masks).astype(np.float64)


def build_coarse_op_direct(transfer: Transfer, diag_apply: Callable,
                           hop_terms: list[Callable],
                           dtype: torch.dtype) -> CoarseOperator:
    """The ``CoarseOperator`` of ``coarse_xy_direct``."""
    x, y = coarse_xy_direct(transfer, diag_apply, hop_terms, dtype)
    return CoarseOperator(x=x, y=y, bg=transfer.bg)


def coarse_xy_direct(transfer: Transfer, diag_apply: Callable,
                     hop_terms: list[Callable], dtype: torch.dtype) -> tuple:
    """(X, Y) by the direct Galerkin construction (the reference's
    calculateY).

    For every coarse column j = (chirality c, vector b) the source is
    the chirality-c part of null vector b, w = P_c v_b, which is what
    prolonging a unit coarse vector at every coarse site gives.  Each
    hop term h_d(w)(x) depends on w at the one site x ± mu only, so in
    the blocked layout its restriction splits exactly by the intra-block
    face mask of direction d: face sites came from the neighbouring
    aggregate (the link Y_d), the others from the same aggregate (part
    of X).  ``diag_apply`` is the fine site-diagonal term; ``hop_terms``
    are the 8 directional hops, each with its −κ.  A plain loop over
    the 2·nvec columns.  On a rank's box of a process grid (``transfer`` the
    rank's aggregates, the hops reading across the box faces) it gives
    the box's rows of X and Y."""
    if len(hop_terms) != 8:
        raise ValueError(f"expected 8 hop terms, got {len(hop_terms)}")
    bg = transfer.bg
    n, dof, cvol = bg.nvec, bg.coarse_dof, bg.coarse_volume
    v = transfer.v
    dev = v.device
    masks = torch.tensor(np.repeat(_face_masks(bg.bt, bg.bz, bg.by, bg.bx),
                                   6, axis=1), dtype=v.real.dtype, device=dev)
    x = torch.zeros((cvol, dof, dof), dtype=dtype, device=dev)
    y = torch.zeros((8, cvol, dof, dof), dtype=dtype, device=dev)

    def column(flat):     # blocked fine field → coarse column [cvol, dof]
        s = transfer.restrict_flat(flat).reshape(2, cvol, n)
        return s.permute(1, 0, 2).reshape(cvol, dof).to(dtype)

    for j in range(dof):
        c, b = divmod(j, n)
        w_flat = torch.zeros_like(v[..., 0, :])
        w_flat[c] = v[c, ..., b, :]
        w = from_blocked_flat(w_flat, bg).to(dtype)
        xcol = column(to_blocked_flat(diag_apply(w), bg))
        for d, h in enumerate(hop_terms):
            hw = to_blocked_flat(h(w), bg)
            tot, face = column(hw), column(hw * masks[d])
            xcol = xcol + (tot - face)
            y[d, :, :, j] = face
        x[:, :, j] = xcol
    return x, y


def build_coarse_op_direct_coarse(transfer2: CoarseTransfer,
                                  diag_apply: Callable,
                                  hop_terms: list[Callable],
                                  dtype: torch.dtype,
                                  batch: int = 16) -> CoarseOperator:
    """``build_coarse_op_direct`` for a coarse → coarser level (the
    reference's CoarseCoarseOp): the source of column j = (spin s, vector
    k) is the spin-s part of V2's vector k, each hop term's restriction
    splits by the intra-block face mask of its direction into the link
    Y_d and a part of X; the coarse spin plays the chirality's role.
    ``diag_apply`` and ``hop_terms`` act on coarse fields with a leading
    batch (``coarse_diag_hops``); the columns run ``batch`` at a time.
    With a block extent of 1 both face masks of that direction are all
    ones, and Y_2mu, Y_2mu+1 stay separate terms."""
    if len(hop_terms) != 8:
        raise ValueError(f"expected 8 hop terms, got {len(hop_terms)}")
    bg = transfer2.bg
    n, dof, cvol = bg.nvec, bg.coarse_dof, bg.coarse_volume
    v = transfer2.v                           # [n, T2..X2, bv, ns, nc]
    dev = v.device
    masks = torch.tensor(_face_masks(bg.bt, bg.bz, bg.by, bg.bx),
                         dtype=v.real.dtype, device=dev)[:, :, None, None]
    x = torch.zeros((cvol, dof, dof), dtype=dtype, device=dev)
    y = torch.zeros((8, cvol, dof, dof), dtype=dtype, device=dev)

    def columns(blk):     # [B, T2..X2, bv, ns, nc] → [cvol, dof, B]
        s = transfer2.restrict_blocked(blk)             # [B, ns, n, T2..]
        return s.reshape(-1, dof, cvol).permute(2, 1, 0).to(dtype)

    for j0 in range(0, dof, batch):
        js = range(j0, min(j0 + batch, dof))
        w_blk = torch.zeros((len(js),) + tuple(v.shape[1:]), dtype=v.dtype,
                            device=dev)
        for i, j in enumerate(js):
            s0, k = divmod(j, n)
            w_blk[i, ..., s0, :] = v[k, ..., s0, :]
        w = from_blocked_coarse(w_blk, bg).to(dtype)
        xcols = columns(to_blocked_coarse(diag_apply(w), bg))
        for d, h in enumerate(hop_terms):
            hb = to_blocked_coarse(h(w), bg)
            face = columns(hb * masks[d])
            xcols = xcols + (columns(hb) - face)
            y[d, :, :, js.start:js.stop] = face
        x[:, :, js.start:js.stop] = xcols
    return CoarseOperator(x=x, y=y, bg=bg)


def build_coarse_op(transfer: Transfer, diag_apply: Callable,
                    hop_terms: list[Callable],
                    dtype: torch.dtype) -> CoarseOperator:
    """Probing construction, kept as the test oracle of
    ``build_coarse_op_direct``: prolong a unit coarse vector placed on
    every coarse site of one colour of a 2-colouring, apply the diagonal
    term and each hop term, restrict.  Same-colour sites give X, the
    other colour the link Y_d.  Needs even coarse dimensions."""
    if len(hop_terms) != 8:
        raise ValueError(f"expected 8 hop terms, got {len(hop_terms)}")
    bg = transfer.bg
    cshape = bg.coarse_shape
    if any(d % 2 for d in cshape):
        raise ValueError(
            f"coarse dims {cshape} must be even for bipartite probing")
    n, dof, cvol = bg.nvec, bg.coarse_dof, bg.coarse_volume
    dev = transfer.v.device
    cpar = torch.tensor(_coarse_parity_mask(cshape), device=dev)
    x = torch.zeros((cvol, dof, dof), dtype=dtype, device=dev)
    y = torch.zeros((8, cvol, dof, dof), dtype=dtype, device=dev)
    for color in (0, 1):
        same = (cpar == color).reshape(cvol, 1)
        for j in range(dof):
            vc = torch.zeros((2, n) + tuple(cshape), dtype=dtype, device=dev)
            vc[j // n, j % n] = (cpar == color).to(dtype)
            fine = transfer.prolong(vc)
            terms = [diag_apply(fine)] + [h(fine) for h in hop_terms]
            for t, out in enumerate(terms):
                col = transfer.restrict(out).reshape(dof, cvol).T
                x[:, :, j] += torch.where(same, col, 0)
                if t > 0:
                    y[t - 1, :, :, j] += torch.where(same, 0, col)
    return CoarseOperator(x=x, y=y, bg=bg)
