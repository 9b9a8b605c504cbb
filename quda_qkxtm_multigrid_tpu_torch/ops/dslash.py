"""Wilson hopping term on the canonical layout, plain PyTorch.

    D_{p<-1-p} psi(x) = sum_mu (1 - gamma_mu) U_mu(x)        psi(x+mu)
                              + (1 + gamma_mu) U_mu^dag(x-mu) psi(x-mu)

(no 1/2 — folded into kappa); dagger swaps the projectors.  Full Wilson
operator M = psi - kappa D psi; even-odd preconditioned M_pc =
psi - kappa² D_eo D_oe psi (``wilson_matpc``).  Layouts: psi
[4,3,T,Z,W] per parity, u [4,2,3,3,T,Z,W].  This is the in-port oracle
for the CUDA hop kernel (ops/dslash_kernel.py).

Flops: 1,320 per site per application.
"""

from __future__ import annotations

import torch

from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry, gather_neighbor
from quda_qkxtm_multigrid_tpu_torch.ops import gamma as _g
from quda_qkxtm_multigrid_tpu_torch.ops.smallmat import (
    su3_mul as _su3, su3_dag_mul as _su3_dag, spinmat_mul)

WILSON_DSLASH_FLOPS_PER_SITE = 1320


def _proj(mu: int, plus: bool, psi):
    """(1 ± gamma_mu) psi over the leading spin axis: psi [4,3,T,Z,W]."""
    return spinmat_mul(_g.PROJ[mu, 1 if plus else 0], psi)


def dslash_parity(u, psi_opp, parity: int, geom: Geometry,
                  dagger: bool = False):
    """Hopping term writing sites of ``parity`` from the opposite-parity
    field ``psi_opp`` [4,3,T,Z,W]."""
    out = None
    for mu in range(4):
        fwd_psi = gather_neighbor(psi_opp, mu, True, parity, geom)
        bwd_psi = gather_neighbor(psi_opp, mu, False, parity, geom)
        u_bwd = gather_neighbor(u[mu, 1 - parity], mu, False, parity, geom)
        term = _su3(u[mu, parity], _proj(mu, dagger, fwd_psi))
        term = term + _su3_dag(u_bwd, _proj(mu, not dagger, bwd_psi))
        out = term if out is None else out + term
    return out


def wilson_mat(u, psi, kappa: float, geom: Geometry, dagger: bool = False):
    """Full Wilson operator on [2,4,3,T,Z,W]: out = psi - kappa D psi."""
    d_even = dslash_parity(u, psi[1], 0, geom, dagger)
    d_odd = dslash_parity(u, psi[0], 1, geom, dagger)
    return psi - kappa * torch.stack([d_even, d_odd])


def wilson_matpc(u, psi_p, kappa: float, geom: Geometry, parity: int = 0,
                 dagger: bool = False):
    """Even-odd preconditioned: out = psi − kappa² D_{p,1−p} D_{1−p,p} psi
    (parity 0 is QUDA_MATPC_EVEN_EVEN)."""
    tmp = dslash_parity(u, psi_p, 1 - parity, geom, dagger)
    out = dslash_parity(u, tmp, parity, geom, dagger)
    return psi_p - (kappa * kappa) * out


def dslash_flops(geom: Geometry, sites: str = "half") -> int:
    """Analytic flops of one hop over half the lattice ("half") or all of
    it."""
    v = geom.half_volume if sites == "half" else geom.volume
    return WILSON_DSLASH_FLOPS_PER_SITE * v


def doubled_links(u, geom: Geometry, parity: int, mesh=None):
    """One parity of ``double_gauge``: [4, 2, 3, 3, T, Z, W]."""
    return torch.stack([
        torch.stack([u[mu, parity],
                     gather_neighbor(u[mu, 1 - parity], mu, False, parity,
                                     geom, mesh=mesh)])
        for mu in range(4)])


def double_gauge(u, geom: Geometry, mesh=None):
    """ud[mu, parity, 0] = U_mu(x) and ud[mu, parity, 1] = U_mu(x-mu) for
    x of ``parity``: both hop directions addressable at the output site,
    so the hop reads no gathered links.  [4, 2, 2, 3, 3, T, Z, W].
    ``mesh``: ``u`` is this rank's box on that grid, and the backward
    links of the first row of each split axis come from the neighbour's
    last plane (``lattice.gather_neighbor``)."""
    return torch.stack([doubled_links(u, geom, p, mesh) for p in range(2)],
                       dim=1)


def dslash_parity_doubled(ud, psi_opp, parity: int, geom: Geometry,
                          dagger: bool = False):
    """dslash_parity using a doubled gauge field (no link gathers)."""
    out = None
    for mu in range(4):
        fwd_psi = gather_neighbor(psi_opp, mu, True, parity, geom)
        bwd_psi = gather_neighbor(psi_opp, mu, False, parity, geom)
        term = _su3(ud[mu, parity, 0], _proj(mu, dagger, fwd_psi))
        term = term + _su3_dag(ud[mu, parity, 1],
                               _proj(mu, not dagger, bwd_psi))
        out = term if out is None else out + term
    return out


def hop_apply(u, psi, mu: int, sign: int, geom: Geometry, mesh=None):
    """One of the eight directional hop terms on a full field
    [2,4,3,T,Z,W]:
      sign=+1: out(x) = (1 − γ_mu) U_mu(x) psi(x+mu)
      sign=-1: out(x) = (1 + γ_mu) U_mu†(x-mu) psi(x-mu)
    The coarse-operator build restricts each term separately.  ``mesh``:
    ``u`` and ``psi`` are this rank's boxes on that grid, and a hop along
    a split axis reads the neighbour's plane
    (``lattice.gather_neighbor``)."""
    outs = []
    for parity in (0, 1):
        src = psi[1 - parity]
        if sign > 0:
            fwd = gather_neighbor(src, mu, True, parity, geom, mesh=mesh)
            outs.append(_su3(u[mu, parity], _proj(mu, False, fwd)))
        else:
            bwd = gather_neighbor(src, mu, False, parity, geom, mesh=mesh)
            u_bwd = gather_neighbor(u[mu, 1 - parity], mu, False, parity,
                                    geom, mesh=mesh)
            outs.append(_su3_dag(u_bwd, _proj(mu, True, bwd)))
    return torch.stack(outs)
