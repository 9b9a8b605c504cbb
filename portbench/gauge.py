"""The gauge field of a run, made on the device from the seed.

Random SU(3) links (a hot start): complex Gaussian 3×3 matrices, rows 0
and 1 orthonormalised, row 2 = conj(row 0 × row 1), so every link is
unitary with determinant 1.  They are drawn in complex128 a t-slab at a
time, in lexicographic order, and written into the port's canonical
layout.  The t links of the last row carry the antiperiodic fermion
boundary (a factor −1), which the operator of the port reads back from
the links and the plain reference applies as it finds them.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.layout import gauge_slab_to_canonical

SLAB = 8     # t rows drawn per call


def derive_seed(seed: int, *salt) -> int:
    """A 63-bit generator seed for the stream ``salt`` of run ``seed``
    (a whole number of any size)."""
    words = [int(w) for w in salt]
    state = np.random.SeedSequence(
        [seed % 2**64, (seed >> 64) % 2**64] + words).generate_state(
            2, np.uint32)
    return int(state[0]) << 31 | int(state[1]) >> 1


def _su3(a: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] → SU(3) by Gram-Schmidt on rows 0, 1 and
    row 2 = conj(r0 × r1)."""
    r0 = a[..., 0, :]
    r0 = r0 / torch.linalg.vector_norm(r0, dim=-1, keepdim=True)
    r1 = a[..., 1, :]
    r1 = r1 - (r0.conj() * r1).sum(-1, keepdim=True) * r0
    r1 = r1 / torch.linalg.vector_norm(r1, dim=-1, keepdim=True)
    r2 = torch.linalg.cross(r0, r1, dim=-1).conj()
    return torch.stack([r0, r1, r2], dim=-2)


def make_gauge(dims, seed: int, device, boundary: str) -> torch.Tensor:
    """The canonical gauge [4, 2, 3, 3, T, Z, W] in complex128 of the
    lattice ``dims`` (X, Y, Z, T) from ``seed``, made on ``device``, its
    t boundary ``boundary`` ("periodic" or "antiperiodic")."""
    if boundary not in ("periodic", "antiperiodic"):
        raise ValueError(f"boundary {boundary!r}: periodic or antiperiodic")
    xx, yy, zz, tt = dims
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.empty((4, 2, 3, 3, tt, zz, yy * (xx // 2)),
                    dtype=torch.complex128, device=device)
    for t0 in range(0, tt, SLAB):
        nt = min(SLAB, tt - t0)
        shape = (4, nt, zz, yy, xx, 3, 3)
        a = torch.complex(
            torch.randn(shape, generator=gen, dtype=torch.float64,
                        device=device),
            torch.randn(shape, generator=gen, dtype=torch.float64,
                        device=device))
        links = _su3(a)
        del a
        if boundary == "antiperiodic" and t0 + nt == tt:
            links[3, nt - 1] *= -1
        u[:, :, :, :, t0:t0 + nt] = gauge_slab_to_canonical(links, t0)
    return u


def config_gauge(cfg: dict, seed: int, device) -> torch.Tensor:
    """``make_gauge`` of a configuration's lattice and t boundary."""
    return make_gauge(cfg["lattice"], seed, device, cfg["boundary_t"])
