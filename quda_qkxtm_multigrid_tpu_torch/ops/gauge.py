"""Gauge-field observables, transformations and gauge fixing on the
canonical layout: the counterpart of the JAX package's ``ops/gauge.py``
(``plaquette``, ``apply_t_boundary``, ``gauge_transform``,
``topological_charge``, ``gauge_fix_fft`` and ``gauge_fix_ovr``; the
reference's gauge_plaq.cu, qcharge_quda.cu, gauge_fix_fft.cu and
gauge_fix_ovr.cu).

Gauge layout [4, 2, 3, 3, T, Z, W]; a gauge transformation g is
[2, 3, 3, T, Z, W].
"""

from __future__ import annotations

import math

import numpy as np
import torch

from quda_qkxtm_multigrid_tpu_torch.lattice import (
    Geometry, gather_neighbor, gauge_from_lex, gauge_to_lex)
from quda_qkxtm_multigrid_tpu_torch.ops.clover import field_strength
from quda_qkxtm_multigrid_tpu_torch.ops.smallmat import mat_dag, mat_mul
from quda_qkxtm_multigrid_tpu_torch.utils.rng import su3_project_leading


def plaquette(u: torch.Tensor, geom: Geometry):
    """Mean plaquette (1/3) Re tr U_mu U_nu U_mu† U_nu† over all sites and
    the 6 planes: (total, spatial, temporal) as 0-d real tensors, the
    JAX package's ``plaquette`` (the reference's ``plaqQuda``)."""
    spatial = temporal = 0.0
    for mu in range(4):
        for nu in range(mu + 1, 4):
            acc = 0.0
            for p in (0, 1):
                m = mat_mul(u[mu, p],
                            gather_neighbor(u[nu, 1 - p], mu, True, p, geom))
                n = mat_mul(u[nu, p],
                            gather_neighbor(u[mu, 1 - p], nu, True, p, geom))
                acc = acc + (m * n.conj()).real.sum()
            if nu == 3:
                temporal = temporal + acc
            else:
                spatial = spatial + acc
    norm = 3.0 * geom.volume * 3.0
    spatial, temporal = spatial / norm, temporal / norm
    return (spatial + temporal) / 2.0, spatial, temporal


def apply_t_boundary(u: torch.Tensor, geom: Geometry,
                     phase: float = -1.0) -> torch.Tensor:
    """U_t at t = T−1 multiplied by ``phase`` (−1: the antiperiodic
    fermion boundary in t), as a new field.  The fused operator reads
    the boundary back from the links (``ops.dslash_kernel.
    antiperiodic_t``)."""
    out = u.clone()
    out[3, :, :, :, geom.T - 1] *= phase
    return out


def gauge_transform(u: torch.Tensor, g: torch.Tensor,
                    geom: Geometry) -> torch.Tensor:
    """u'_mu(x) = g(x) U_mu(x) g†(x+mu); g [2, 3, 3, T, Z, W]."""
    return torch.stack([torch.stack([
        mat_mul(mat_mul(g[p], u[mu, p]),
                mat_dag(gather_neighbor(g[1 - p], mu, True, p, geom)))
        for p in range(2)]) for mu in range(4)])


def topological_charge(u: torch.Tensor, geom: Geometry) -> torch.Tensor:
    """Field-theoretic topological charge from the clover-leaf field
    strength (reference qcharge_quda.cu), a 0-d real tensor:
    Q = (1/4π²) Σ_x Re tr[F_xy F_zt − F_xz F_yt + F_yz F_xt], with the
    stored pairs (yx), (zx), (zy), (tx), (ty), (tz) of
    ``ops.clover.FMUNU_PAIRS``."""
    f = field_strength(u, geom)

    def retr(a, b):
        m = mat_mul(a, b)
        return (m[0, 0] + m[1, 1] + m[2, 2]).real.sum()

    q = 0.0
    for p in (0, 1):
        q = q + retr(f[0, p], f[5, p]) - retr(f[1, p], f[4, p]) \
            + retr(f[2, p], f[3, p])
    return q / (4.0 * math.pi ** 2)


def gauge_fix_fft(u: torch.Tensor, geom: Geometry, gauge_dir: int = 4,
                  n_iter: int = 100, alpha: float = 0.08):
    """Fourier-accelerated steepest-descent gauge fixing (Landau
    ``gauge_dir`` 4, Coulomb 3; the reference's gaugefixingFFT, Davies et
    al.).  Each iteration filters the gauge gradient
    Δ(x) = Σ_μ [A_μ(x−μ̂) − A_μ(x)] (A the traceless anti-hermitian part
    of U_μ) by p̂²max / p̂² in momentum space (zero mode dropped), then
    applies g = Proj_SU3(1 + (α/2) Δ̃).  Runs on the lexicographic sites
    of ``gauge_to_lex`` with the matrix axes leading, [4, 3, 3, T, Z, Y,
    X], so the FFTs (``torch.fft`` over the trailing site axes) and the
    3×3 products (``mat_mul``) read contiguous sites.  Returns
    (u_fixed, θ) with θ = Σ|Δ|² / (3 V) of the fixed links, a 0-d real
    tensor."""
    u_lex = gauge_to_lex(u, geom).movedim((-2, -1), (1, 2))
    dims4 = (geom.T, geom.Z, geom.Y, geom.X)
    ax_of_mu = {0: -1, 1: -2, 2: -3, 3: -4}     # mu (x,y,z,t) → site axis
    dirs = tuple(range(gauge_dir))
    fft_axes = tuple(ax_of_mu[mu] for mu in dirs)

    p2 = np.zeros(dims4)
    for a in fft_axes:
        ln = dims4[a]
        shape = [1, 1, 1, 1]
        shape[a] = ln
        p2 = p2 + (4.0 * np.sin(np.pi * np.arange(ln) / ln) ** 2).reshape(
            shape)
    pmax = 4.0 * len(fft_axes)
    fac = torch.tensor(np.where(p2 > 1e-12, pmax / np.maximum(p2, 1e-12),
                                0.0), dtype=u.real.dtype, device=u.device)
    eye = torch.eye(3, dtype=u.dtype, device=u.device).reshape(
        3, 3, 1, 1, 1, 1)

    def gradient(u_lex):
        delta = None
        for mu in dirs:
            um = u_lex[mu]
            a = 0.5 * (um - mat_dag(um))
            tr = (a[0, 0] + a[1, 1] + a[2, 2]) / 3.0
            a = a - tr * eye
            d = torch.roll(a, 1, dims=ax_of_mu[mu]) - a     # A_mu(x−mu) − A
            delta = d if delta is None else delta + d
        return delta

    for _ in range(n_iter):
        ft = torch.fft.fftn(gradient(u_lex), dim=fft_axes)
        dacc = torch.fft.ifftn(ft * fac, dim=fft_axes).to(u_lex.dtype)
        g = su3_project_leading(eye + (0.5 * alpha) * dacc)
        u_lex = torch.stack([
            mat_mul(mat_mul(g, u_lex[mu]),
                    mat_dag(torch.roll(g, -1, dims=ax_of_mu[mu])))
            for mu in range(4)])
    delta = gradient(u_lex)
    theta = (delta.abs() ** 2).sum() / (3 * geom.volume)
    return gauge_from_lex(u_lex.movedim((1, 2), (-2, -1)), geom), theta


def gauge_fix_ovr(u: torch.Tensor, geom: Geometry, gauge_dir: int = 3,
                  n_iter: int = 100, omega: float = 1.0):
    """Relaxation gauge fixing (Coulomb ``gauge_dir`` 3, Landau 4; the
    role of the reference's gaugefixingOVR).  Checkerboard sweeps: at
    each site of a parity g = Proj_SU3(w†) with w = Σ_μ [U_μ(x) +
    U_μ†(x−μ̂)] over the fixed directions maximises the local functional;
    every direction's links transform.  The full-SU(3) projection stands
    in for the reference's SU(2) subgroup hits (same fixed points), and
    ``omega`` is taken and unused, as in the JAX package.  Returns
    (u_fixed, θ) with θ the anti-hermitian part of Σ_μ [U_μ(x) −
    U_μ(x−μ̂)], squared and summed over 3 V."""
    dirs = tuple(range(gauge_dir))

    def sweep(u, parity):
        w = None
        for mu in dirs:
            t = u[mu, parity] + mat_dag(gather_neighbor(
                u[mu, 1 - parity], mu, False, parity, geom))
            w = t if w is None else w + t
        g = su3_project_leading(mat_dag(w))
        g_fwd = [gather_neighbor(g, mu, True, 1 - parity, geom)
                 for mu in range(4)]
        out = []
        for mu in range(4):
            per = [None, None]
            per[parity] = mat_mul(g, u[mu, parity])
            per[1 - parity] = mat_mul(u[mu, 1 - parity], mat_dag(g_fwd[mu]))
            out.append(torch.stack(per))
        return torch.stack(out)

    for _ in range(n_iter):
        u = sweep(sweep(u, 0), 1)
    w = None
    for mu in dirs:
        d = u[mu] - torch.stack([
            gather_neighbor(u[mu, 1], mu, False, 0, geom),
            gather_neighbor(u[mu, 0], mu, False, 1, geom)])
        w = d if w is None else w + d
    anti = 0.5 * (w - w.transpose(1, 2).conj())
    theta = (anti.abs() ** 2).sum() / (3 * geom.volume)
    return u, theta
