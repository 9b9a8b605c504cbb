"""Staggered and improved (asqtad: fat + Naik long links) staggered
operators, plain PyTorch: the counterpart of the JAX package's
``ops/staggered.py`` (the reference's
``tests/staggered_dslash_reference.cpp`` oracle).

  D ψ(x) = Σ_μ [ F_μ(x) ψ(x+μ)  − F_μ†(x−μ)  ψ(x−μ) ]
         + Σ_μ [ L_μ(x) ψ(x+3μ) − L_μ†(x−3μ) ψ(x−3μ) ]

with the staggered η phases folded into the links (MILC convention,
``apply_staggered_phases``), the long-link term only for the improved
operator.  Full operator mat = 2m ψ + D ψ; D is anti-hermitian, so the
even-odd normal operator is matpc = 4m² ψ_e − D_eo D_oe ψ_e.

Fields: colour vectors [3, T, Z, W] per parity, [2, 3, T, Z, W] in
full; links [4, 2, 3, 3, T, Z, W].
"""

from __future__ import annotations

import numpy as np
import torch

from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry, gather_neighbor
from quda_qkxtm_multigrid_tpu_torch.ops.smallmat import (
    mat_dag, mat_mul, su3_dag_mul, su3_mul)

STAGGERED_DSLASH_FLOPS_PER_SITE = 570   # reference lib/dirac_staggered.cpp

# Asqtad path coefficients (MILC asqtad_action.h; the reference's
# act_path_coeff[6]): one-link 5/8 = 1/8 (fat7) + 3/8 (the Lepage
# backtrack correction) + 1/8 (the Naik correction), 3-staple −1/16,
# 5-staple 1/64, 7-staple −1/384, Lepage −1/16, Naik −1/24.
ASQTAD_COEFFS = {
    "one_link": 5.0 / 8.0,
    "three_staple": -1.0 / 16.0,
    "five_staple": 1.0 / 64.0,
    "seven_staple": -1.0 / 384.0,
    "lepage": -1.0 / 16.0,
    "naik": -1.0 / 24.0,
}


def staggered_phases(geom: Geometry, antiperiodic_t: bool = True):
    """MILC η phases per (mu, parity, site), numpy [4, 2, T, Z, W] of ±1:
    η_x = 1, η_y = (−1)^x, η_z = (−1)^(x+y), η_t = (−1)^(x+y+z), times
    −1 on the t links of t = T−1 for the antiperiodic boundary."""
    T, Z, Y, Xh = geom.T, geom.Z, geom.Y, geom.Xh
    t = np.arange(T).reshape(-1, 1, 1, 1)
    z = np.arange(Z).reshape(1, -1, 1, 1)
    y = np.arange(Y).reshape(1, 1, -1, 1)
    k = np.arange(Xh).reshape(1, 1, 1, -1)
    out = np.zeros((4, 2, T, Z, Y, Xh))
    for p in (0, 1):
        x = 2 * k + (p + t + z + y) % 2
        eta = [np.ones((T, Z, Y, Xh)), (-1.0) ** x, (-1.0) ** (x + y),
               (-1.0) ** (x + y + z)]
        for mu in range(4):
            e = np.broadcast_to(eta[mu], (T, Z, Y, Xh)).astype(float)
            if mu == 3 and antiperiodic_t:
                e = e * np.where(t == T - 1, -1.0, 1.0)
            out[mu, p] = e
    return out.reshape(4, 2, T, Z, geom.W)


def apply_staggered_phases(u: torch.Tensor, geom: Geometry,
                           antiperiodic_t: bool = True) -> torch.Tensor:
    """The η phases folded into the links (the reference's
    staggeredPhaseQuda)."""
    ph = torch.tensor(staggered_phases(geom, antiperiodic_t),
                      dtype=u.real.dtype, device=u.device)
    return u * ph[:, :, None, None]


def gen_staple(u: torch.Tensor, w: torch.Tensor, mu: int, nu: int,
               geom: Geometry) -> torch.Tensor:
    """Generalised staple of a link-like field ``w`` [2, 3, 3, T, Z, W]
    (on the mu-link sites) in direction mu, displaced through nu (MILC
    compute_gen_staple):

      up:  U_nu(x)      W(x+nu)  U_nu†(x+mu)
      low: U_nu†(x−nu)  W(x−nu)  U_nu(x−nu+mu)

    Composing it builds the 3-, 5-, 7-link and Lepage paths."""
    per_par = []
    for p in (0, 1):
        q = 1 - p
        up = mat_mul(mat_mul(u[nu, p],
                             gather_neighbor(w[q], nu, True, p, geom)),
                     mat_dag(gather_neighbor(u[nu, q], mu, True, p, geom)))
        u_nu_b = gather_neighbor(u[nu, q], nu, False, p, geom)
        w_b = gather_neighbor(w[q], nu, False, p, geom)
        u_nu_bm = gather_neighbor(
            gather_neighbor(u[nu, p], mu, True, q, geom), nu, False, p, geom)
        low = mat_mul(mat_mul(mat_dag(u_nu_b), w_b), u_nu_bm)
        per_par.append(up + low)
    return torch.stack(per_par)


def naik_links(u: torch.Tensor, geom: Geometry,
               coeff: float = ASQTAD_COEFFS["naik"]) -> torch.Tensor:
    """Third-neighbour (Naik) links L_mu(x) = coeff U_mu(x) U_mu(x+mu)
    U_mu(x+2mu) (the reference's computeLongLink)."""
    out = []
    for mu in range(4):
        per_par = []
        for p in (0, 1):
            q = 1 - p
            u1 = gather_neighbor(u[mu, q], mu, True, p, geom)   # U(x+mu)
            u2 = gather_neighbor(
                gather_neighbor(u[mu, p], mu, True, q, geom),
                mu, True, p, geom)                              # U(x+2mu)
            per_par.append(coeff * mat_mul(mat_mul(u[mu, p], u1), u2))
        out.append(torch.stack(per_par))
    return torch.stack(out)


def asqtad_links(u: torch.Tensor, geom: Geometry, coeffs: dict | None = None):
    """Asqtad fat and long links from the thin links (the reference's
    computeKSLinkQuda), MILC's nested ``gen_staple`` composition:

      fat_mu = c1 U_mu + c3 Σ_nu S_nu(U_mu) + c_lep Σ_nu S_nu(S_nu(U_mu))
             + c5 Σ_{nu,rho} S_rho(S_nu(U_mu))
             + c7 Σ_{nu,rho,sig} S_sig(S_rho(S_nu(U_mu)))

    (indices pairwise distinct and ≠ mu).  Returns (fat, long), each
    [4, 2, 3, 3, T, Z, W], without the staggered phases
    (``apply_staggered_phases`` folds them in)."""
    c = dict(ASQTAD_COEFFS)
    if coeffs:
        c.update(coeffs)
    fat = []
    for mu in range(4):
        acc = c["one_link"] * u[mu]
        for nu in range(4):
            if nu == mu:
                continue
            s3 = gen_staple(u, u[mu], mu, nu, geom)
            acc = acc + c["three_staple"] * s3
            acc = acc + c["lepage"] * gen_staple(u, s3, mu, nu, geom)
            for rho in range(4):
                if rho in (mu, nu):
                    continue
                s5 = gen_staple(u, s3, mu, rho, geom)
                acc = acc + c["five_staple"] * s5
                for sig in range(4):
                    if sig in (mu, nu, rho):
                        continue
                    acc = acc + c["seven_staple"] * gen_staple(
                        u, s5, mu, sig, geom)
        fat.append(acc)
    return torch.stack(fat), naik_links(u, geom, c["naik"])


def shift3(f_opp: torch.Tensor, mu: int, forward: bool, parity: int,
           geom: Geometry) -> torch.Tensor:
    """f(x ± 3mu) for x of ``parity`` (f stored on the opposite parity):
    three single gathers onto parities p, q, p."""
    p, q = parity, 1 - parity
    v = gather_neighbor(f_opp, mu, forward, p, geom)
    v = gather_neighbor(v, mu, forward, q, geom)
    return gather_neighbor(v, mu, forward, p, geom)


def staggered_dslash(fat: torch.Tensor, psi_opp: torch.Tensor, parity: int,
                     geom: Geometry, long_links=None,
                     dagger: bool = False) -> torch.Tensor:
    """Single-parity staggered D (phases in the links): psi_opp
    [3, T, Z, W] → [3, T, Z, W] on ``parity``; ``dagger`` flips the sign
    (D is anti-hermitian)."""
    psi = psi_opp[None]                  # a spin axis for the su3 helpers
    out = None
    for mu in range(4):
        fwd = gather_neighbor(psi, mu, True, parity, geom)
        bwd = gather_neighbor(psi, mu, False, parity, geom)
        f_bwd = gather_neighbor(fat[mu, 1 - parity], mu, False, parity, geom)
        term = su3_mul(fat[mu, parity], fwd) - su3_dag_mul(f_bwd, bwd)
        if long_links is not None:
            fwd3 = shift3(psi, mu, True, parity, geom)
            bwd3 = shift3(psi, mu, False, parity, geom)
            l_bwd = shift3(long_links[mu, 1 - parity], mu, False, parity,
                           geom)                        # L_mu(x−3mu)
            term = term + su3_mul(long_links[mu, parity], fwd3)
            term = term - su3_dag_mul(l_bwd, bwd3)
        out = term if out is None else out + term
    out = out[0]
    return -out if dagger else out


def staggered_mat(fat: torch.Tensor, psi: torch.Tensor, mass: float,
                  geom: Geometry, long_links=None,
                  dagger: bool = False) -> torch.Tensor:
    """Full operator on [2, 3, T, Z, W]: 2m ψ + D ψ."""
    d_e = staggered_dslash(fat, psi[1], 0, geom, long_links, dagger)
    d_o = staggered_dslash(fat, psi[0], 1, geom, long_links, dagger)
    return 2.0 * mass * psi + torch.stack([d_e, d_o])


def staggered_matpc(fat: torch.Tensor, psi_p: torch.Tensor, mass: float,
                    geom: Geometry, long_links=None,
                    parity: int = 0) -> torch.Tensor:
    """Even-odd preconditioned normal operator 4m² ψ − D_{p,1−p} D_{1−p,p}
    ψ (hermitian positive definite: CG)."""
    t = staggered_dslash(fat, psi_p, 1 - parity, geom, long_links)
    t = staggered_dslash(fat, t, parity, geom, long_links)
    return 4.0 * mass * mass * psi_p - t
