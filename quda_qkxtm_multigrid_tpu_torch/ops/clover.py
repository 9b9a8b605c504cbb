"""Clover term: field-strength tensor, chiral-block construction,
batched 6x6 apply and inverse, on the canonical layout.

  F_idx = (1/8) (Q - Q^dag), Q = sum of the 4 clover leaves in plane
  (mu,nu), component order idx(mu,nu) = (1,0),(2,0),(2,1),(3,0),(3,1),(3,2).
  With c = csw * kappa:
    b1[0] = i c (F[0] - F[5]),  b1[1] = i c (F[0] + F[5])
    b2[0] = c (F[1] + F[4] - i (F[2] - F[3]))
    b2[1] = c (F[1] - F[4] - i (F[2] + F[3]))
    A_ch  = [[I - b1[ch], b2[ch]^dag], [b2[ch], I + b1[ch]]]   (6x6 hermitian)

Chirality blocks in DeGrand-Rossi: spins (0,1) = gamma5=+1 block (ch=0),
spins (2,3) = ch=1.  Layouts: clover [2(parity), 2(ch), 6, 6, T, Z, W],
fmunu [6(pair), 2(parity), 3, 3, T, Z, W].
"""

from __future__ import annotations

import torch

from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry, gather_neighbor
from quda_qkxtm_multigrid_tpu_torch.ops.smallmat import (
    mat_mul, mat_dag as _dag, chiral_mat_mul, mat6_inv_blocks)

CLOVER_APPLY_FLOPS_PER_SITE = 504

FMUNU_PAIRS = ((1, 0), (2, 0), (2, 1), (3, 0), (3, 1), (3, 2))


def _mm(*ms):
    out = ms[0]
    for m in ms[1:]:
        out = mat_mul(out, m)
    return out


def _field_strength_plane(u, geom: Geometry, mu: int, nu: int, p: int,
                          mesh=None):
    """F_{mu nu} on the sites of parity ``p``: [3, 3, T, Z, W].  ``mesh``:
    ``u`` is this rank's box on that grid; a leaf reaches one plane
    along each of two axes, each shift along a split axis reads it from
    the neighbour, and the corner arrives through two such shifts
    (``lattice.gather_neighbor``)."""
    def g(mat_on_parity_q, d, fwd, target_p):
        return gather_neighbor(mat_on_parity_q, d, fwd, target_p, geom,
                               mesh=mesh)

    q = 1 - p
    umu_p, unu_p = u[mu, p], u[nu, p]
    umu_q, unu_q = u[mu, q], u[nu, q]
    # L1 = U_mu(x) U_nu(x+mu) U_mu†(x+nu) U_nu†(x)
    qsum = _mm(umu_p, g(unu_q, mu, True, p),
               _dag(g(umu_q, nu, True, p)), _dag(unu_p))
    # L2 = U_nu(x) U_mu†(x+nu-mu) U_nu†(x-mu) U_mu(x-mu)
    u_numu = g(g(umu_p, nu, True, q), mu, False, p)
    qsum = qsum + _mm(unu_p, _dag(u_numu), _dag(g(unu_q, mu, False, p)),
                      g(umu_q, mu, False, p))
    # L3 = U_mu†(x-mu) U_nu†(x-mu-nu) U_mu(x-mu-nu) U_nu(x-nu)
    u_mn_nu = g(g(unu_p, mu, False, q), nu, False, p)
    u_mn_mu = g(g(umu_p, mu, False, q), nu, False, p)
    qsum = qsum + _mm(_dag(g(umu_q, mu, False, p)), _dag(u_mn_nu),
                      u_mn_mu, g(unu_q, nu, False, p))
    # L4 = U_nu†(x-nu) U_mu(x-nu) U_nu(x+mu-nu) U_mu†(x)
    u_munu = g(g(unu_p, mu, True, q), nu, False, p)
    qsum = qsum + _mm(_dag(g(unu_q, nu, False, p)), g(umu_q, nu, False, p),
                      u_munu, _dag(umu_p))
    return 0.125 * (qsum - _dag(qsum))


def field_strength(u, geom: Geometry):
    """Clover-leaf field strength: u [4,2,3,3,T,Z,W] → F [6,2,3,3,T,Z,W],
    anti-hermitian."""
    return torch.stack([torch.stack([_field_strength_plane(u, geom, mu, nu, p)
                                     for p in (0, 1)])
                        for mu, nu in FMUNU_PAIRS])


def _clover_parity(f, coeff: float):
    """Chiral blocks [2(ch),6,6,T,Z,W] of one parity from F [6,3,3,T,Z,W]."""
    ic = 1j * coeff
    b1 = torch.stack([ic * (f[0] - f[5]), ic * (f[0] + f[5])])
    b2 = torch.stack([coeff * (f[1] + f[4] - 1j * (f[2] - f[3])),
                      coeff * (f[1] - f[4] - 1j * (f[2] + f[3]))])
    eye = torch.eye(3, dtype=f.dtype, device=f.device).reshape(
        1, 3, 3, 1, 1, 1)
    top = torch.cat([eye - b1, b2.transpose(1, 2).conj()], dim=2)
    bot = torch.cat([b2, eye + b1], dim=2)
    return torch.cat([top, bot], dim=1)


def field_strength_parity(u, geom: Geometry, p: int, mesh=None):
    """The six F components of parity ``p``, [6, 3, 3, T, Z, W], written
    plane by plane into one buffer; ``mesh`` as in
    ``_field_strength_plane``."""
    f = torch.empty((6, 3, 3) + tuple(u.shape[-3:]), dtype=u.dtype,
                    device=u.device)
    for i, (mu, nu) in enumerate(FMUNU_PAIRS):
        f[i] = _field_strength_plane(u, geom, mu, nu, p, mesh)
    return f


def make_clover(u, geom: Geometry, coeff: float, mesh=None):
    """Build A [2(parity),2(ch),6,6,T,Z,W], coeff = csw * kappa.

    Built one parity at a time, so the six F components of only one
    parity are alive at once (each [3,3,T,Z,W] c128 temporary is 151 MB
    at 32³×64), and the chiral blocks from them a t-slab at a time into
    the output.  ``mesh``: on this rank's box of ``u``, its t-faces
    exchanged (``_field_strength_plane``)."""
    t_ = u.shape[-3]
    out = torch.empty((2, 2, 6, 6) + tuple(u.shape[-3:]), dtype=u.dtype,
                      device=u.device)
    tb = max(1, t_ // 8)
    for p in (0, 1):
        f = field_strength_parity(u, geom, p, mesh)
        for t0 in range(0, t_, tb):
            out[p, ..., t0:t0 + tb, :, :] = _clover_parity(
                f[..., t0:t0 + tb, :, :], coeff)
        del f
    return out


def clover_with_twist(clover, kappa: float, mu: float, flavor: int):
    """A + i·2κμ·flavor·γ5 as chiral blocks (γ5 = ±1 per chirality)."""
    a = 2.0 * kappa * mu * flavor
    eye = torch.eye(6, dtype=clover.dtype, device=clover.device).reshape(
        1, 6, 6, 1, 1, 1)
    return torch.stack([clover[:, 0] + 1j * a * eye,
                        clover[:, 1] - 1j * a * eye], dim=1)


def invert_clover(clover):
    """Batched 6x6 inverse per (parity, chirality, site): explicit 3x3
    block Schur inversion in leading-axes component form."""
    return torch.stack([torch.stack([mat6_inv_blocks(clover[p, ch])
                                     for ch in range(2)]) for p in range(2)])


def clover_apply(clover_p, psi, dagger: bool = False):
    """clover_p [2(ch),6,6,T,Z,W] applied to psi [4,3,T,Z,W]."""
    shp = psi.shape
    chi = psi.reshape((2, 6) + shp[2:])
    return chiral_mat_mul(clover_p, chi, dagger=dagger).reshape(shp)


def make_clover_pair(u, geom: Geometry, params, mesh=None):
    """clover + inverse (the inverse includes the twist for
    twisted-clover); ``mesh`` as in ``make_clover`` (the inverse is
    site-local)."""
    clov = make_clover(u, geom, params.csw * params.kappa, mesh)
    if params.kind == "twisted-clover" and params.mu != 0.0:
        inv = invert_clover(clover_with_twist(clov, params.kappa, params.mu,
                                              params.flavor))
    else:
        inv = invert_clover(clov)
    return clov, inv
