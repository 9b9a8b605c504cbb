"""Lattice geometry and even-odd (checkerboard) indexing.

The canonical layouts are those of the JAX package, so fields cross
between the packages through numpy unchanged:

    spinor  [2(parity), 4(spin), 3(color), T, Z, W]
    gauge   [4(mu), 2(parity), 3, 3, T, Z, W]
    clover  [2(parity), 2(chirality), 6, 6, T, Z, W]

with ``W = Y * X/2``.  Site coords (x,y,z,t), parity = (x+y+z+t) % 2,
direction mu: 0=x, 1=y, 2=z, 3=t.  Within a parity the checkerboard
x-index is k = x//2, the true x coordinate is ``2k + (parity+t+z+y) % 2``
and the merged index is ``w = y * (X/2) + k``.

Neighbour gathers (`gather_neighbor`) are rolls on the trailing axes
plus checkerboard selects for mu=x.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

EVEN = 0
ODD = 1


@dataclasses.dataclass(frozen=True)
class Geometry:
    """Local lattice geometry (X, Y, Z, T), every extent even."""

    X: int
    Y: int
    Z: int
    T: int

    def __post_init__(self):
        for d, n in zip("XYZT", (self.X, self.Y, self.Z, self.T)):
            if n < 2 or n % 2:
                raise ValueError(f"dimension {d}={n} must be even and >= 2")

    @property
    def dims(self) -> tuple[int, int, int, int]:
        return (self.X, self.Y, self.Z, self.T)

    @property
    def volume(self) -> int:
        return self.X * self.Y * self.Z * self.T

    @property
    def half_volume(self) -> int:
        return self.volume // 2

    @property
    def Xh(self) -> int:
        return self.X // 2

    @property
    def W(self) -> int:
        """Merged axis: y * Xh + k."""
        return self.Y * self.Xh

    @property
    def lat_shape(self) -> tuple[int, int, int]:
        """Trailing lattice axes of every canonical array."""
        return (self.T, self.Z, self.W)

    @property
    def cb4_shape(self) -> tuple[int, int, int, int]:
        """Unmerged single-parity shape [T, Z, Y, Xh]."""
        return (self.T, self.Z, self.Y, self.Xh)

    @functools.lru_cache(maxsize=None)
    def _x_masks(self, parity: int):
        """(s0, k_first, k_last) as numpy bools: s0[T,Z,W] true where the
        site's true x coordinate is even; k_first/k_last[1,1,W] true at
        the checkerboard row edges."""
        t = np.arange(self.T).reshape(-1, 1, 1)
        z = np.arange(self.Z).reshape(1, -1, 1)
        w = np.arange(self.W).reshape(1, 1, -1)
        y = w // self.Xh
        k = w % self.Xh
        s0 = ((t + z + y + parity) % 2 == 0)
        return (np.broadcast_to(s0, (self.T, self.Z, self.W)),
                np.broadcast_to(k == 0, (1, 1, self.W)),
                np.broadcast_to(k == self.Xh - 1, (1, 1, self.W)))

    @functools.lru_cache(maxsize=None)
    def _x_mask_tensors(self, parity: int, device: torch.device):
        """``_x_masks`` as bool tensors on ``device``, copied there once."""
        return tuple(torch.tensor(m, device=device)
                     for m in self._x_masks(parity))


def gather_neighbor(f: torch.Tensor, mu: int, forward: bool, parity: int,
                    geom: Geometry, t0: int | None = None,
                    mesh=None) -> torch.Tensor:
    """Gather f(x ± mu) for every site x of ``parity``.

    ``f`` lives on the opposite parity, any leading axes, trailing axes
    [T, Z, W].  Returns the same shape, aligned with sites of ``parity``.
    ``t0``: ``f`` holds only the timeslice t0 (trailing [1, Z, W]); the
    spatial directions only.  ``mesh``: ``f`` is this rank's box on that
    grid (``parallel.mesh.LatticeMesh``, ``geom`` the box's), and a t,
    z or y shift along a split axis crosses to the neighbour ranks
    (``parallel.halo.gather_t`` / ``gather_z`` / ``gather_w``); x stays
    local.  A diagonal neighbour is two such shifts, so the corner
    arrives through the two exchanges.
    """
    if mu == 3:
        if t0 is not None:
            raise ValueError("a single timeslice has no t neighbour")
        if mesh is not None:
            from quda_qkxtm_multigrid_tpu_torch.parallel.halo import gather_t
            return gather_t(f, mesh, forward)
        return torch.roll(f, -1 if forward else 1, dims=-3)
    if mu == 2:
        if mesh is not None and mesh.nz > 1:
            from quda_qkxtm_multigrid_tpu_torch.parallel.halo import gather_z
            return gather_z(f, mesh, forward)
        return torch.roll(f, -1 if forward else 1, dims=-2)
    if mu == 1:                      # y: a roll by Xh of the merged axis
        if mesh is not None and mesh.nw > 1:
            from quda_qkxtm_multigrid_tpu_torch.parallel.halo import gather_w
            return gather_w(f, mesh, forward, geom.Xh)
        return torch.roll(f, -geom.Xh if forward else geom.Xh, dims=-1)
    s0, k_first, k_last = geom._x_mask_tensors(parity, f.device)
    if t0 is not None:
        s0 = s0[t0:t0 + 1]
    if forward:
        # true x even (s0): +x neighbour at the same k; odd: k+1 (wraps)
        fwd_odd = torch.where(k_last, torch.roll(f, geom.Xh - 1, dims=-1),
                              torch.roll(f, -1, dims=-1))
        return torch.where(s0, f, fwd_odd)
    # true x even: -x neighbour at k-1 (wraps); odd: the same k
    bwd_even = torch.where(k_first, torch.roll(f, -(geom.Xh - 1), dims=-1),
                           torch.roll(f, 1, dims=-1))
    return torch.where(s0, bwd_even, f)


def _row_parity(geom: Geometry, device) -> torch.Tensor:
    """(t+z+y) % 2 as a [T, Z, Y, 1] bool tensor: which slot of an x pair
    holds the even site."""
    return _row_parity_dims(geom.T, geom.Z, geom.Y, device)


def _row_parity_dims(T: int, Z: int, Y: int, device) -> torch.Tensor:
    t = torch.arange(T, device=device).reshape(-1, 1, 1, 1)
    z = torch.arange(Z, device=device).reshape(1, -1, 1, 1)
    y = torch.arange(Y, device=device).reshape(1, 1, -1, 1)
    return (t + z + y) % 2 == 1


def _split_parity_sites(full: torch.Tensor) -> torch.Tensor:
    """[T, Z, Y, X, ...] → [2, T, Z, Y, X/2, ...] (even, odd)."""
    T, Z, Y, X = full.shape[:4]
    trailing = tuple(full.shape[4:])
    pairs = full.reshape(T, Z, Y, X // 2, 2, *trailing)
    r = _row_parity_dims(T, Z, Y, full.device).reshape(
        (T, Z, Y, 1) + (1,) * len(trailing))
    even = torch.where(r, pairs[:, :, :, :, 1], pairs[:, :, :, :, 0])
    odd = torch.where(r, pairs[:, :, :, :, 0], pairs[:, :, :, :, 1])
    return torch.stack([even, odd])


def _join_parity_sites(split: torch.Tensor) -> torch.Tensor:
    """[2, T, Z, Y, X/2, ...] → [T, Z, Y, X, ...]."""
    _, T, Z, Y, Xh = split.shape[:5]
    trailing = tuple(split.shape[5:])
    r = _row_parity_dims(T, Z, Y, split.device).reshape(
        (T, Z, Y, 1) + (1,) * len(trailing))
    even, odd = split[0], split[1]
    pairs = torch.stack([torch.where(r, odd, even),
                         torch.where(r, even, odd)], dim=4)
    return pairs.reshape(T, Z, Y, 2 * Xh, *trailing)


def spinor_to_lex(psi: torch.Tensor, geom: Geometry) -> torch.Tensor:
    """canonical [2,4,3,T,Z,W] → lexicographic [T,Z,Y,X,4,3]."""
    even, odd = psi.reshape((2, 4, 3) + geom.cb4_shape).movedim(
        (1, 2), (5, 6))                          # [T,Z,Y,Xh,4,3] each
    r = _row_parity(geom, psi.device).reshape(
        geom.T, geom.Z, geom.Y, 1, 1, 1)
    pairs = torch.stack([torch.where(r, odd, even),
                         torch.where(r, even, odd)], dim=4)
    return pairs.reshape(geom.T, geom.Z, geom.Y, geom.X, 4, 3)


def spinor_from_lex(full: torch.Tensor, geom: Geometry) -> torch.Tensor:
    """[T,Z,Y,X,4,3] → canonical [2,4,3,T,Z,W]."""
    pairs = full.reshape(geom.T, geom.Z, geom.Y, geom.Xh, 2, 4, 3)
    r = _row_parity(geom, full.device).reshape(
        geom.T, geom.Z, geom.Y, 1, 1, 1)
    even = torch.where(r, pairs[:, :, :, :, 1], pairs[:, :, :, :, 0])
    odd = torch.where(r, pairs[:, :, :, :, 0], pairs[:, :, :, :, 1])
    split = torch.stack([even, odd]).movedim((5, 6), (1, 2))
    return split.reshape((2, 4, 3) + geom.lat_shape).contiguous()


def spinor_to_lex_dof_leading(psi: torch.Tensor,
                              geom: Geometry) -> torch.Tensor:
    """canonical [..., 2,4,3,T,Z,W] → [..., 4,3,T,Z,Y,X] (spin and colour
    stay ahead of the site axes; any leading batch axes are kept)."""
    lead = psi.shape[:-6]
    p = psi.reshape(*lead, 2, 4, 3, *geom.cb4_shape)
    even, odd = p.select(-7, 0), p.select(-7, 1)     # [...,4,3,T,Z,Y,Xh]
    r = _row_parity(geom, psi.device)                # [T,Z,Y,1]
    pairs = torch.stack([torch.where(r, odd, even),
                         torch.where(r, even, odd)], dim=-1)
    return pairs.reshape(*lead, 4, 3, geom.T, geom.Z, geom.Y, geom.X)


def spinor_from_lex_dof_leading(full: torch.Tensor,
                                geom: Geometry) -> torch.Tensor:
    """[..., 4,3,T,Z,Y,X] → canonical [..., 2,4,3,T,Z,W]."""
    lead = full.shape[:-6]
    pairs = full.reshape(*lead, 4, 3, geom.T, geom.Z, geom.Y, geom.Xh, 2)
    r = _row_parity(geom, full.device)
    even = torch.where(r, pairs[..., 1], pairs[..., 0])
    odd = torch.where(r, pairs[..., 0], pairs[..., 1])
    return torch.stack([even, odd], dim=-7).reshape(
        *lead, 2, 4, 3, *geom.lat_shape)


def gauge_to_lex(u: torch.Tensor, geom: Geometry) -> torch.Tensor:
    """canonical [4, 2, 3, 3, T, Z, W] → lexicographic [4, T, Z, Y, X, 3, 3]
    (mu in x, y, z, t order): the inverse of ``gauge_from_lex``."""
    g = u.reshape((4, 2, 3, 3) + geom.cb4_shape).movedim(
        (2, 3), (6, 7))                          # [4,2,T,Z,Y,Xh,3,3]
    even, odd = g[:, 0], g[:, 1]
    r = _row_parity(geom, u.device).reshape(
        1, geom.T, geom.Z, geom.Y, 1, 1, 1)
    pairs = torch.stack([torch.where(r, odd, even),
                         torch.where(r, even, odd)], dim=5)
    return pairs.reshape(4, geom.T, geom.Z, geom.Y, geom.X, 3, 3)


def gauge_from_lex(full: torch.Tensor, geom: Geometry) -> torch.Tensor:
    """lexicographic [4, T, Z, Y, X, 3, 3] (mu in x, y, z, t order) →
    canonical [4, 2, 3, 3, T, Z, W]."""
    pairs = full.reshape(4, geom.T, geom.Z, geom.Y, geom.Xh, 2, 3, 3)
    r = _row_parity(geom, full.device).reshape(
        1, geom.T, geom.Z, geom.Y, 1, 1, 1)
    even = torch.where(r, pairs[..., 1, :, :], pairs[..., 0, :, :])
    odd = torch.where(r, pairs[..., 0, :, :], pairs[..., 1, :, :])
    split = torch.stack([even, odd], dim=1)      # [4,2,T,Z,Y,Xh,3,3]
    return split.movedim((6, 7), (2, 3)).reshape(
        (4, 2, 3, 3) + geom.lat_shape).contiguous()


def site_index(geom: Geometry, coords):
    """(x,y,z,t) → (parity, t, z, w) canonical indices."""
    x, y, z, t = coords
    p = (x + y + z + t) % 2
    return p, t, z, y * geom.Xh + x // 2
