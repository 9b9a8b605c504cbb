"""Link smearing (APE, stout), Gaussian quark-field smearing and the
covariant shift: the counterpart of the JAX package's ``ops/smear.py``.

  APE    U' = Proj_SU3[(1−α) U_mu + α/(2(d−1)) Σ staples], spatial
         staples only by default (the reference's ``gauge_ape.cu``);
  stout  U' = exp(Q) U, Q the traceless anti-hermitian part of
         ρ Σ staples U† (8-term Taylor exponential);
  Gauss  ψ' = (ψ + α H ψ)/(1 + 6α), H ψ(x) = Σ_{i=x,y,z} U_i(x) ψ(x+i)
         + U_i†(x−i) ψ(x−i), iterated n times over APE-smeared links
         (the reference's ``Gauss_core_Kepler.h``);
  covdev U_mu(x) ψ(x+mu) forward, U_mu†(x−mu) ψ(x−mu) backward (the
         reference's ``covDev.cu``, the loops' derivative insertions).

Plain PyTorch on the canonical layout, the JAX package's arithmetic in
the same order; ``gaussian_smear`` takes any leading batch axes (the 12
spin-colour sources of a propagator at once) and, with ``t0``, a field
of one timeslice: H is spatial, so smearing the timeslice alone gives
the numbers of the whole field's smearing there (the 3pt smears its
sink timeslice that way).
"""

from __future__ import annotations

import torch

from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry, gather_neighbor
from quda_qkxtm_multigrid_tpu_torch.ops.smallmat import (
    mat_dag, mat_mul, su3_dag_mul, su3_mul)
from quda_qkxtm_multigrid_tpu_torch.utils.rng import su3_project_leading


def _staple_sum(u: torch.Tensor, mu: int, geom: Geometry, dirs, mesh=None):
    """Sum of the upper and lower staples of U_mu over nu in ``dirs``, per
    parity [2, 3, 3, T, Z, W]:
    upper U_nu(x) U_mu(x+nu) U_nu†(x+mu), lower U_nu†(x−nu) U_mu(x−nu)
    U_nu(x−nu+mu).  ``mesh``: ``u`` is this rank's box on that grid,
    and a shift along a split axis reads the neighbour's face."""
    def g(f, d, fwd, parity):
        return gather_neighbor(f, d, fwd, parity, geom, mesh=mesh)

    per_par = []
    for p in (0, 1):
        q = 1 - p
        acc = None
        for nu in dirs:
            if nu == mu:
                continue
            up = mat_mul(mat_mul(u[nu, p], g(u[mu, q], nu, True, p)),
                         mat_dag(g(u[nu, q], mu, True, p)))
            u_nu_b = g(u[nu, q], nu, False, p)
            u_mu_b = g(u[mu, q], nu, False, p)
            u_nu_bm = g(g(u[nu, p], mu, True, q), nu, False, p)
            low = mat_mul(mat_mul(mat_dag(u_nu_b), u_mu_b), u_nu_bm)
            s = up + low
            acc = s if acc is None else acc + s
        per_par.append(acc)
    return torch.stack(per_par)


def _project_links(m: torch.Tensor) -> torch.Tensor:
    """SU(3)-project links [2, 3, 3, T, Z, W]."""
    return torch.stack([su3_project_leading(m[p]) for p in range(2)])


def ape_smear_step(u: torch.Tensor, geom: Geometry, alpha: float,
                   spatial_only: bool = True, mesh=None) -> torch.Tensor:
    """One APE step (the t links untouched when ``spatial_only``, the
    smeared gauge that the Gaussian smearing reads); ``mesh`` as in
    ``ape_smear``."""
    dirs = (0, 1, 2) if spatial_only else (0, 1, 2, 3)
    coeff = alpha / (2.0 * (len(dirs) - 1))
    out = u.clone()
    for mu in dirs:
        st = _staple_sum(u, mu, geom, dirs, mesh)
        out[mu] = _project_links((1.0 - alpha) * u[mu] + coeff * st)
    return out


def ape_smear(u: torch.Tensor, geom: Geometry, alpha: float, n_steps: int,
              spatial_only: bool = True, mesh=None) -> torch.Tensor:
    """``n_steps`` APE steps.  ``mesh``: ``u`` is this rank's box on
    that ring (``geom`` the box's), and each step exchanges the t-faces
    its staples read; the spatial staples read none, so the default
    smearing sends nothing."""
    for _ in range(n_steps):
        u = ape_smear_step(u, geom, alpha, spatial_only, mesh)
    return u


def stout_smear_step(u: torch.Tensor, geom: Geometry, rho: float,
                     spatial_only: bool = True) -> torch.Tensor:
    """One stout step U' = exp(Q) U, Q the traceless anti-hermitian part
    of ρ Σ staples U† (the reference's ``gauge_stout.cu``), the
    exponential by its 8-term Taylor series."""
    dirs = (0, 1, 2) if spatial_only else (0, 1, 2, 3)
    out = u.clone()
    eye = torch.eye(3, dtype=u.dtype, device=u.device).reshape(
        3, 3, 1, 1, 1)
    for mu in dirs:
        st = _staple_sum(u, mu, geom, dirs)
        new = []
        for p in (0, 1):
            omega = rho * mat_mul(st[p], mat_dag(u[mu, p]))
            q = 0.5 * (omega - mat_dag(omega))
            q = q - ((q[0, 0] + q[1, 1] + q[2, 2]) / 3.0) * eye
            acc = term = eye.expand(q.shape)
            for k in range(1, 9):
                term = mat_mul(term, q) / k
                acc = acc + term
            new.append(mat_mul(acc, u[mu, p]))
        out[mu] = torch.stack(new)
    return out


def _gauss_hop(v: torch.Tensor, u: torch.Tensor, u_bwd, geom: Geometry,
               t0, mesh=None):
    """H v over the spatial directions for v [..., 2, 4, 3, T, Z, W];
    ``u_bwd[p][i]`` = U_i(x−i) at the sites x of parity p."""
    outs = []
    for p in (0, 1):
        src = v.select(-6, 1 - p)
        acc = None
        for i in (0, 1, 2):
            fwd = gather_neighbor(src, i, True, p, geom, t0, mesh)
            bwd = gather_neighbor(src, i, False, p, geom, t0, mesh)
            term = su3_mul(u[i, p], fwd) + su3_dag_mul(u_bwd[p][i], bwd)
            acc = term if acc is None else acc + term
        outs.append(acc)
    return torch.stack(outs, dim=-6)


def gaussian_smear(psi: torch.Tensor, u_smeared: torch.Tensor,
                   geom: Geometry, alpha: float, n: int,
                   t0: int | None = None, mesh=None) -> torch.Tensor:
    """``n`` iterations of ψ ← (ψ + α H ψ)/(1 + 6α) over the (APE-)
    smeared links, on a full field [..., 2, 4, 3, T, Z, W]; leading axes
    batch sources.  With ``t0``, ``psi`` is the timeslice t0 alone
    [..., 2, 4, 3, 1, Z, W] (``u_smeared`` stays the whole gauge).  The
    backward links are gathered once for all iterations.  ``mesh``:
    ``psi`` and the links are this rank's box, and the z and y hops
    cross ranks on a split axis (every rank of the box's t rows takes
    part)."""
    norm = 1.0 / (1.0 + 6.0 * alpha)
    if t0 is not None:
        u_smeared = u_smeared[..., t0:t0 + 1, :, :]
    u_bwd = [[gather_neighbor(u_smeared[i, 1 - p], i, False, p, geom, t0,
                              mesh)
              for i in (0, 1, 2)] for p in (0, 1)]
    for _ in range(n):
        psi = norm * (psi + alpha * _gauss_hop(psi, u_smeared, u_bwd, geom,
                                               t0, mesh))
    return psi


def covdev_apply(u: torch.Tensor, psi: torch.Tensor, mu: int,
                 forward: bool, geom: Geometry, mesh=None) -> torch.Tensor:
    """Gauge-covariant shift of a full spinor field [2, 4, 3, T, Z, W]:
    U_mu(x) ψ(x+mu) forward, U_mu†(x−mu) ψ(x−mu) backward (the
    reference's ``covDev.cu``).  ``mesh``: ``u`` and ``psi`` are this
    rank's boxes on that grid, and along a split axis the shifted field
    and the backward link U_mu(x−mu) cross ranks
    (``lattice.gather_neighbor``)."""
    outs = []
    for p in (0, 1):
        src = psi[1 - p]
        if forward:
            outs.append(su3_mul(u[mu, p], gather_neighbor(
                src, mu, True, p, geom, mesh=mesh)))
        else:
            u_b = gather_neighbor(u[mu, 1 - p], mu, False, p, geom,
                                  mesh=mesh)
            outs.append(su3_dag_mul(
                u_b, gather_neighbor(src, mu, False, p, geom, mesh=mesh)))
    return torch.stack(outs)
