"""Field constructors on the canonical layouts (see lattice.py):

  spinor  [2, 4, 3, T, Z, W]          complex
  gauge   [4, 2, 3, 3, T, Z, W]       complex
  clover  [2, 2, 6, 6, T, Z, W]       complex

They make their field on the card unless the caller names another
device (``device="cpu"``).  ``gauge_from_full`` takes a lexicographic
gauge [4, T, Z, Y, X, 3, 3] (what ``io.lime.read_ildg_gauge`` gives).
"""

from __future__ import annotations

import torch

from quda_qkxtm_multigrid_tpu_torch.lattice import (
    Geometry, gauge_from_lex, site_index)


def zeros_spinor(geom: Geometry, dtype=torch.complex128, device="cuda",
                 nspin: int = 4, ncolor: int = 3) -> torch.Tensor:
    return torch.zeros((2, nspin, ncolor) + geom.lat_shape, dtype=dtype,
                       device=device)


def point_source(geom: Geometry, coords, spin: int, color: int,
                 dtype=torch.complex128, device="cuda") -> torch.Tensor:
    """Delta source at global site ``coords=(x,y,z,t)``, unit at
    (spin, color), on the card unless ``device`` says otherwise."""
    p, t, z, w = site_index(geom, coords)
    psi = zeros_spinor(geom, dtype, device)
    psi[p, spin, color, t, z, w] = 1.0
    return psi


def point_source_dyn(geom: Geometry, coords, spin: int, color: int,
                     dtype=torch.complex128, device="cuda") -> torch.Tensor:
    """``point_source`` with the position given as any length-4 integer
    sequence or tensor (x, y, z, t): the JAX package's form for traced
    coordinates, which in eager PyTorch is ``point_source`` itself."""
    x, y, z, t = (int(c) for c in coords)
    return point_source(geom, (x, y, z, t), spin, color, dtype, device)


gauge_from_full = gauge_from_lex
