"""Explicit coarse operator: a site-diagonal term X and 8 directional
links Y, the Galerkin product V†(op)V of the fine operator through the
transfer.

Layouts: coarse field vc [2(chir), nvec, Tc, Zc, Yc, Xc], whose dof
a = chir·nvec + vec; X [cvol, dof, dof] and Y [8, cvol, dof, dof],
site-major so that an application is one batched [dof × dof] product
per site and direction (the JAX package keeps the site axis last,
[dof, dof, cvol], for the TPU's tiling).  Direction d = 2·mu + (0 fwd |
1 bwd); the forward term reads the field at xc + mu.

Coarse stencil flops per site: 8·(8n²) − 2n, n = 2·nvec.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from quda_qkxtm_multigrid_tpu_torch.mg.transfer import (
    BlockGeometry, Transfer, from_blocked_flat, to_blocked_flat)
from quda_qkxtm_multigrid_tpu_torch.utils.precision import full_float32


def _axis_of_mu(mu: int) -> int:
    """Axis of direction mu in a coarse field's trailing [Tc,Zc,Yc,Xc]."""
    return {0: -1, 1: -2, 2: -3, 3: -4}[mu]


@dataclasses.dataclass(frozen=True)
class CoarseOperator:
    x: torch.Tensor            # [cvol, dof, dof]
    y: torch.Tensor            # [8, cvol, dof, dof]
    bg: BlockGeometry

    @full_float32()
    def apply(self, vc: torch.Tensor) -> torch.Tensor:
        """vc [2, nvec, Tc,Zc,Yc,Xc] → D_c vc (same shape), its products
        in full float32."""
        dof = self.bg.coarse_dof
        v = vc.reshape((dof,) + tuple(vc.shape[2:]))
        shifted = []
        for mu in range(4):
            ax = _axis_of_mu(mu)
            shifted.append(torch.roll(v, -1, dims=ax))     # v(xc + mu)
            shifted.append(torch.roll(v, 1, dims=ax))      # v(xc - mu)
        vs = torch.stack(shifted).reshape(8, dof, -1).transpose(1, 2)
        out = torch.matmul(self.x, v.reshape(dof, -1).T.unsqueeze(-1))
        out = out + torch.matmul(self.y, vs.unsqueeze(-1)).sum(dim=0)
        return out[..., 0].T.reshape(vc.shape)

    def flops_per_apply(self) -> int:
        n = self.bg.coarse_dof
        return (8 * (8 * n * n) - 2 * n) * self.bg.coarse_volume


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
    """Direct Galerkin construction (the reference's calculateY).

    For every coarse column j = (chirality c, vector b) the source is
    the chirality-c part of null vector b, w = P_c v_b, which is what
    prolonging a unit coarse vector at every coarse site gives.  Each
    hop term h_d(w)(x) depends on w at the one site x ± mu only, so in
    the blocked layout its restriction splits exactly by the intra-block
    face mask of direction d: face sites came from the neighbouring
    aggregate (the link Y_d), the others from the same aggregate (part
    of X).  ``diag_apply`` is the fine site-diagonal term; ``hop_terms``
    are the 8 directional hops, each with its −κ.  A plain loop over
    the 2·nvec columns."""
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
