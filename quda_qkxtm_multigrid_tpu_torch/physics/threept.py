"""Nucleon three-point functions: the counterpart of the JAX package's
``physics/threept.py`` (fixed-sink sequential sources and the
ultra-local, conserved (noether) and one-derivative insertions), with
its tables, index strings and signs.

Per projector and flavour part (the reference's
``calcMG_threepTwop_EvenOdd``): the sink-timeslice propagators → the
sequential source (12 columns) → γ5 → Gaussian smearing → a solve with
the opposite twist → the sequential propagator → the fixSink
contractions against the forward propagator → momentum projection with
e^{+ip·x}.

Propagator layout [2(parity), 4(sink spin), 4(source spin), 3(sink
colour), 3(source colour), T, Z, W]; a sink timeslice in lexicographic
order is [4, 4, 3, 3, Z, Y, X].  Every contraction runs through
``utils/precision.heinsum`` (pairwise, optimal order, full float32): the
fixSink ones contract the two propagators over (m, b, a) before the 16
insertion matrices, so no intermediate holds 16 propagators.
"""

from __future__ import annotations

import numpy as np
import torch

from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry, gather_neighbor
from quda_qkxtm_multigrid_tpu_torch.ops import gamma as _g
from quda_qkxtm_multigrid_tpu_torch.ops.smallmat import (
    su3_conj_mul, su3_dag_mul, su3_mul, su3_transp_mul)
from quda_qkxtm_multigrid_tpu_torch.physics.contract import _EPS, _G13
from quda_qkxtm_multigrid_tpu_torch.utils.precision import heinsum

_B = _g.GAMMA_BASIS
# basis indices: bit i of the index = gamma_{i+1} present
_I, _G1, _G2, _G3, _G4i = _B[0], _B[1], _B[2], _B[4], _B[8]
_G14, _G24, _G34 = _B[9], _B[10], _B[12]
_G124, _G134, _G234 = _B[11], _B[13], _B[14]
_G12, _G13b, _G23 = _B[3], _B[5], _B[6]
_G123, _G1234 = _B[7], _B[15]

PROTON, NEUTRON = +1, -1
PROJ_NAMES = ["G4", "G5G123", "G5G1", "G5G2", "G5G3"]


def projector(name: str, particle: int) -> np.ndarray:
    """The twisted-basis sink projector (the reference's
    ``projectors_tm_base.h``, in the gamma basis)."""
    s = 1.0 if particle == PROTON else -1.0
    if name == "G4":
        return 0.25 * (_G1234 + 1j * s * _G4i)
    if name == "G5G1":
        return -0.25j * _G14 - 0.25 * s * _G234
    if name == "G5G2":
        return +0.25j * _G24 - 0.25 * s * _G134
    if name == "G5G3":
        return -0.25j * _G34 - 0.25 * s * _G124
    if name == "G5G123":
        return (projector("G5G1", particle) + projector("G5G2", particle)
                + projector("G5G3", particle))
    raise ValueError(name)


# the 16 twisted-basis ultra-local insertion matrices (the reference's
# gammas_tm_base.h cases 0-15); the flipping set carries s = +1 when
# (partflag == 1) == (particle == PROTON), else -1
_OP_BASE = [1j * _G4i, _G1, -_G2, _G3, _G1234, 1j * _I, -_G14, _G24,
            -_G34, -_G123, -_G124, _G134, -_G234, -_G23, -_G13b, -_G12]
_OP_FLIPS = {0, 5, 10, 11, 12, 13, 14, 15}

# noether (1 ± gamma) matrices: gammas_tm_base.h cases 16-23
_NOETHER_G = [_G1, -_G2, _G3, _G1234]


def insertion_ops(particle: int, partflag: int) -> np.ndarray:
    s = 1.0 if (partflag == 1) == (particle == PROTON) else -1.0
    return np.stack([(s * m if i in _OP_FLIPS else m)
                     for i, m in enumerate(_OP_BASE)])


def _const(a, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=like.dtype,
                           device=like.device)


def _eps2() -> np.ndarray:
    return np.einsum("uvc,xys->uvcxys", _EPS, _EPS)


# ---- sink timeslices ----------------------------------------------------

def _slot_parity(geom: Geometry, t: int, device) -> torch.Tensor:
    """(t+z+y) % 2 == 1 as a [Z, Y, 1] bool tensor: the x pairs of
    timeslice t whose first slot holds the odd site."""
    z = torch.arange(geom.Z, device=device).reshape(-1, 1, 1)
    y = torch.arange(geom.Y, device=device).reshape(1, -1, 1)
    return (t + z + y) % 2 == 1


def timeslice_to_lex(f_t: torch.Tensor, geom: Geometry, t: int):
    """One timeslice of a canonical field [2, ..., Z, W] (parity leading,
    any axes between) → [..., Z, Y, X]."""
    even, odd = (f_t[p].reshape(tuple(f_t.shape[1:-2])
                                + (geom.Z, geom.Y, geom.Xh)) for p in (0, 1))
    r = _slot_parity(geom, t, f_t.device)
    pairs = torch.stack([torch.where(r, odd, even),
                         torch.where(r, even, odd)], dim=-1)
    return pairs.reshape(tuple(f_t.shape[1:-2]) + (geom.Z, geom.Y, geom.X))


def timeslice_from_lex(f_lex: torch.Tensor, geom: Geometry, t: int):
    """[..., Z, Y, X] on timeslice t → [2, ..., Z, W] (parity leading)."""
    lead = tuple(f_lex.shape[:-3])
    pairs = f_lex.reshape(lead + (geom.Z, geom.Y, geom.Xh, 2))
    r = _slot_parity(geom, t, f_lex.device)
    even = torch.where(r, pairs[..., 1], pairs[..., 0])
    odd = torch.where(r, pairs[..., 0], pairs[..., 1])
    return torch.stack([even, odd]).reshape((2,) + lead + (geom.Z, geom.W))


def prop_timeslice_lex(prop: torch.Tensor, geom: Geometry,
                       t: int) -> torch.Tensor:
    """Canonical propagator → its lexicographic sink timeslice [4, 4, 3,
    3, Z, Y, X] (the reference's ``absorbTimeSlice``)."""
    return timeslice_to_lex(prop[..., t, :, :], geom, t)


def timeslice_sources(src_lex: torch.Tensor, geom: Geometry,
                      t: int) -> torch.Tensor:
    """[q, s, 4, 3, Z, Y, X] sequential sources → the canonical timeslice
    t of each [q, s, 2, 4, 3, 1, Z, W]."""
    ts = timeslice_from_lex(src_lex, geom, t)        # [2, q, s, 4, 3, Z, W]
    return ts.movedim(0, 2).unsqueeze(-3)


def embed_timeslice(src_lex: torch.Tensor, geom: Geometry, t: int,
                    dtype) -> torch.Tensor:
    """[q, s, 4, 3, Z, Y, X] sequential sources → canonical full fields
    [q, s, 2, 4, 3, T, Z, W] (zero off the sink timeslice)."""
    q, s = src_lex.shape[:2]
    full = torch.zeros((q, s, 2, 4, 3) + geom.lat_shape, dtype=dtype,
                       device=src_lex.device)
    full[..., t:t + 1, :, :] = timeslice_sources(src_lex, geom, t)
    return full


# ---- sequential sources -------------------------------------------------

def seq_source_part1(t1_lex: torch.Tensor, t2_lex: torch.Tensor,
                     proj) -> torch.Tensor:
    """The mixed-flavour sequential source (the reference's
    ``seqSourceFixSinkPart1_core_Kepler.h``): for every source column
    (q = spin, s = colour) a spinor [4, 3] on the sink timeslice.
    t1_lex / t2_lex: [4, 4, 3, 3, Z, Y, X] sink timeslices.  Returns
    [4(q), 3(s), 4(n), 3(c), Z, Y, X]."""
    A, B = _const(-_G13, t1_lex), _const(_G13, t1_lex)
    ee, P = _const(_eps2(), t1_lex), _const(proj, t1_lex)
    t1 = heinsum("ng,kj,qa,gjuxZYX,akvyZYX,uvcxys->qsncZYX",
                 A, B, P, t2_lex, t1_lex, ee)
    t2 = heinsum("ng,qj,ba,gjuxZYX,abvyZYX,uvcxys->qsncZYX",
                 A, B, P, t2_lex, t1_lex, ee)
    t3 = heinsum("mg,kj,qn,gjuxZYX,mkvyZYX,uvcxys->qsncZYX",
                 A, B, P, t2_lex, t1_lex, ee)
    t4 = heinsum("mg,qj,bn,gjuxZYX,mbvyZYX,uvcxys->qsncZYX",
                 A, B, P, t2_lex, t1_lex, ee)
    return -(t1 + t2 + t3 + t4)


def seq_source_part2(t_lex: torch.Tensor, proj) -> torch.Tensor:
    """The same-flavour sequential source (the reference's
    ``seqSourceFixSinkPart2_core_Kepler.h``)."""
    A, B = _const(-_G13, t_lex), _const(_G13, t_lex)
    ee, P = _const(_eps2(), t_lex), _const(proj, t_lex)
    p1 = heinsum("mn,kq,ba,mbuxZYX,akvyZYX,uvcxys->qsncZYX",
                 A, B, P, t_lex, t_lex, ee)
    p2 = heinsum("mn,kq,ba,mkuxZYX,abvyZYX,uvcxys->qsncZYX",
                 A, B, P, t_lex, t_lex, ee)
    return -(p1 + p2)


# ---- fixed-sink contractions --------------------------------------------

def fixsink_local(seq: torch.Tensor, fwd: torch.Tensor, particle: int,
                  partflag: int) -> torch.Tensor:
    """Ultra-local insertions [16, 2(parity), T, Z, W]: Σ Γ_iop[n, r]
    FWD[r, m] SEQ[n, m] (colour-diagonal trace; the reference's
    ``fixSinkContractions_local_core_Kepler.h``)."""
    ops = _const(insertion_ops(particle, partflag), fwd)
    return heinsum("onr,prmbatzw,pnmbatzw->optzw", ops, fwd, seq)


def _shift_col_fwd(u, prop, mu, geom, mesh=None):
    """U_mu(x) P(x+mu) on the sink colour axis; ``prop`` arranged
    [2, 4(src s), 3(src c), 4(snk s), 3(snk c), T, Z, W].  ``mesh``: the
    fields are boxes on that grid (``lattice.gather_neighbor``)."""
    return torch.stack([su3_mul(u[mu, p],
                                gather_neighbor(prop[1 - p], mu, True, p,
                                                geom, mesh=mesh))
                        for p in (0, 1)])


def _shift_col_bwd(u, prop, mu, geom, mesh=None):
    """U_mu†(x−mu) P(x−mu)."""
    return torch.stack([su3_dag_mul(
        gather_neighbor(u[mu, 1 - p], mu, False, p, geom, mesh=mesh),
        gather_neighbor(prop[1 - p], mu, False, p, geom, mesh=mesh))
        for p in (0, 1)])


def _shift_row_fwd(u, prop, mu, geom, mesh=None):
    """P(x+mu) U_mu(x)† on the sink colour axis (the row side)."""
    return torch.stack([su3_conj_mul(u[mu, p],
                                     gather_neighbor(prop[1 - p], mu, True, p,
                                                     geom, mesh=mesh))
                        for p in (0, 1)])


def _shift_row_bwd(u, prop, mu, geom, mesh=None):
    """P(x−mu) U_mu(x−mu)."""
    return torch.stack([su3_transp_mul(
        gather_neighbor(u[mu, 1 - p], mu, False, p, geom, mesh=mesh),
        gather_neighbor(prop[1 - p], mu, False, p, geom, mesh=mesh))
        for p in (0, 1)])


def _to_shiftable(prop):
    """[2,4,4,3,3,T,Z,W] → [2, src s, src c, snk s, snk c, T, Z, W]."""
    return prop.movedim((1, 3), (3, 4))


def _from_shiftable(prop):
    return prop.movedim((3, 4), (1, 3))


def _shifted_terms(seq, fwd, u, geom: Geometry, particle: int,
                   partflag: int, noether: bool, one_d: bool, mesh=None):
    """The conserved current [4, 2, T, Z, W] and the one-derivative
    insertions [16, 4, 2, T, Z, W] (either None unless asked for), from
    one set of the four covariant shifts a direction (``mesh``: on the
    boxes of that ring, the t shifts crossing ranks)."""
    ops = _const(insertion_ops(particle, partflag), fwd)
    eye = _const(np.eye(4), fwd)
    fwd_s, seq_s = _to_shiftable(fwd), _to_shiftable(seq)
    noe, oned = [], []
    for mu in range(4):
        f_fwd = _from_shiftable(_shift_col_fwd(u, fwd_s, mu, geom, mesh))
        f_bwd = _from_shiftable(_shift_col_bwd(u, fwd_s, mu, geom, mesh))
        s_fwd = _from_shiftable(_shift_row_fwd(u, seq_s, mu, geom, mesh))
        s_bwd = _from_shiftable(_shift_row_bwd(u, seq_s, mu, geom, mesh))
        if one_d:
            t1 = heinsum("okl,pkmbatzw,plmbatzw->optzw", ops, seq,
                         f_fwd - f_bwd)
            t2 = heinsum("okl,pkmbatzw,plmbatzw->optzw", ops,
                         s_fwd - s_bwd, fwd)
            oned.append(0.25 * (t1 - t2))
        if noether:
            g = _const(_NOETHER_G[mu], fwd)
            one_p, one_m = eye + g, eye - g
            t = (-heinsum("kl,pkmbatzw,plmbatzw->ptzw", one_m, seq, f_fwd)
                 + heinsum("kl,pkmbatzw,plmbatzw->ptzw", one_p, seq, f_bwd)
                 + heinsum("kl,pkmbatzw,plmbatzw->ptzw", one_p, s_fwd, fwd)
                 - heinsum("kl,pkmbatzw,plmbatzw->ptzw", one_m, s_bwd, fwd))
            noe.append(0.25 * t)
        del f_fwd, f_bwd, s_fwd, s_bwd
    return (torch.stack(noe) if noether else None,
            torch.stack(oned, dim=1) if one_d else None)


def fixsink_oneD(seq, fwd, u, geom: Geometry, particle: int,
                 partflag: int) -> torch.Tensor:
    """One-derivative insertions [16, 4(dir), 2(parity), T, Z, W] (the
    reference's ``fixSinkContractions_oneD_core_Kepler.h``, with its 0.25
    normalisation): 0.25 Σ Γ[k,l] { SEQ[k] (D FWD)[l] − (D̃ SEQ)[k]
    FWD[l] }."""
    return _shifted_terms(seq, fwd, u, geom, particle, partflag, False,
                          True)[1]


def fixsink_noether(seq, fwd, u, geom: Geometry, particle: int,
                    partflag: int) -> torch.Tensor:
    """The conserved (point-split) vector current [4(dir), 2(parity), T,
    Z, W] (the reference's ``fixSinkContractions_noether_core_Kepler.h``):
    0.25 Σ { −SEQ (1−γ) F⁺ + SEQ (1+γ) F⁻ + S⁺ (1+γ) FWD − S⁻ (1−γ) FWD }
    with F± the covariant shifts of FWD and S± of SEQ."""
    return _shifted_terms(seq, fwd, u, geom, particle, partflag, True,
                          False)[0]


def fixsink_all(seq, fwd, u, geom: Geometry, particle: int, partflag: int,
                mesh=None):
    """(``fixsink_local``, ``fixsink_noether``, ``fixsink_oneD``), the
    last two from one set of covariant shifts; ``mesh``: the fields are
    boxes on that grid, the shifts along split axes crossing ranks."""
    noe, oned = _shifted_terms(seq, fwd, u, geom, particle, partflag, True,
                               True, mesh)
    return fixsink_local(seq, fwd, particle, partflag), noe, oned
