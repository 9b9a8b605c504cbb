"""Hadron 2pt contractions, 10 mesons and 10 baryons, in momentum or
position space: the counterpart of the JAX package's
``physics/contract.py`` (the reference's ``QKXTM_Contraction::
contractMesons`` / ``contractBaryons``), with its tables, index strings
and signs.

  mesons:  C_m = Σ_x G_m[d,a] G_m[b,g] S[a,b,cu,cv] S*[d,g,cu,cv]
  baryons: each term a contraction of three propagators with the
           colour ε of sink and source and the spin matrices A, B,
           open spin (γ, γ') of the third quark.

Propagator layout [2, 4(sink spin), 4(source spin), 3(sink colour),
3(source colour), T, Z, W].  Every spin matrix here (A, B, the γ4
insertions, the meson Γs) is a signed permutation, so it is applied as
an index permutation times its signs (``_apply_spin``), which is exact;
each remaining baryon term (three propagators, two ε) runs through
``utils.precision.heinsum``, pairwise in an optimal order and in full
float32.  The site axes (p, t, z, w) are batch axes throughout, so a
caller may contract a few timeslices at a time (``workflows.run_twop``).
"""

from __future__ import annotations

import numpy as np
import torch

from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry, _row_parity
from quda_qkxtm_multigrid_tpu_torch.ops import gamma as _g
from quda_qkxtm_multigrid_tpu_torch.utils.precision import (
    full_float32, heinsum)

# ---- the tables of the JAX package ------------------------------------
_G = _g.GAMMA
MESON_NAMES = ["pseudoscalar", "scalar", "g5g1", "g5g2", "g5g3", "g5g4",
               "g1", "g2", "g3", "g4"]
MESON_G = np.stack([
    _g.IDENTITY, _G[3], _G[0], _G[1], _G[2], np.asarray(_g.GAMMA5),
    _G[0] @ _G[3], _G[1] @ _G[3], _G[2] @ _G[3], _G[0] @ _G[1] @ _G[2]])

BARYON_NAMES = ["nucl_nucl", "nucl_roper", "roper_nucl", "roper_roper",
                "deltapp_deltamm_11", "deltapp_deltamm_22",
                "deltapp_deltamm_33", "deltap_deltaz_11",
                "deltap_deltaz_22", "deltap_deltaz_33"]
_G13 = _G[0] @ _G[2]
_G134 = _G[0] @ _G[2] @ _G[3]
_G4 = _G[3]
_DELTA_A = [-(_G[2] @ _G[3]), np.asarray(_g.GAMMA5) + 0j, -(_G[0] @ _G[3])]
_DELTA_B = [(_G[2] @ _G[3]), np.asarray(_g.GAMMA5) + 0j, (_G[0] @ _G[3])]

_EPS = np.zeros((3, 3, 3))
for (_a, _b, _c), _s in (((0, 1, 2), 1), ((1, 2, 0), 1), ((2, 0, 1), 1),
                         ((2, 1, 0), -1), ((0, 2, 1), -1), ((1, 0, 2), -1)):
    _EPS[_a, _b, _c] = _s

# propagator factor strings for each (spin-row, spin-col) slot: rows
# alpha = a, beta = b, gamma = g (open); columns alpha' = d, beta' = e,
# gamma' = h (open); colours (u, v, c) with the rows, (x, y, k) with the
# columns
_F = {
    ("a", "d"): "paduxtzw", ("a", "e"): "paeuytzw", ("a", "h"): "pahuktzw",
    ("b", "d"): "pbdvxtzw", ("b", "e"): "pbevytzw", ("b", "h"): "pbhvktzw",
    ("g", "d"): "pgdcxtzw", ("g", "e"): "pgecytzw", ("g", "h"): "pghcktzw",
}

_DELTA6 = [  # (sign, slots) for the single-flavour Delta contraction
    (+1, (("a", "e"), ("b", "h"), ("g", "d"))),
    (-1, (("a", "h"), ("b", "e"), ("g", "d"))),
    (+1, (("a", "h"), ("b", "d"), ("g", "e"))),
    (-1, (("a", "d"), ("b", "h"), ("g", "e"))),
    (-1, (("a", "e"), ("b", "d"), ("g", "h"))),
    (+1, (("a", "d"), ("b", "e"), ("g", "h"))),
]

_DELTAZ8 = [  # (coeff, which factor is the d-quark, slots)
    (-4, 1, (("a", "h"), ("b", "e"), ("g", "d"))),
    (+2, 1, (("a", "e"), ("b", "h"), ("g", "d"))),
    (+2, 2, (("a", "h"), ("b", "d"), ("g", "e"))),
    (-2, 2, (("a", "d"), ("b", "h"), ("g", "e"))),
    (-2, 1, (("a", "d"), ("b", "h"), ("g", "e"))),
    (-1, 2, (("a", "e"), ("b", "d"), ("g", "h"))),
    (+1, 2, (("a", "d"), ("b", "e"), ("g", "h"))),
    (+4, 1, (("a", "d"), ("b", "e"), ("g", "h"))),
]


# ---- signed permutations ------------------------------------------------

def _signed_perm(m: np.ndarray):
    """(columns, values) of a signed permutation matrix: row i has its one
    nonzero entry values[i] in column columns[i]; raises on anything
    else."""
    m = np.asarray(m)
    nz = np.abs(m) > 1e-12
    if not (nz.sum(axis=0) == 1).all() or not (nz.sum(axis=1) == 1).all():
        raise ValueError("not a signed permutation matrix")
    cols = nz.argmax(axis=1)
    return cols, m[np.arange(len(m)), cols]


def _apply_spin(m, f: torch.Tensor, axis: int) -> torch.Tensor:
    """out[.., i, ..] = Σ_j m[i, j] f[.., j, ..] along ``axis`` for a
    constant signed permutation ``m``: an index permutation times the
    signs (±1, ±i), exact."""
    cols, vals = _signed_perm(m)
    idx = torch.as_tensor(cols, device=f.device)
    shape = [1] * f.dim()
    shape[axis] = len(cols)
    sign = torch.as_tensor(vals, dtype=f.dtype, device=f.device)
    return f.index_select(axis, idx) * sign.reshape(shape)


def _eps(dtype, device) -> torch.Tensor:
    return torch.as_tensor(_EPS, dtype=dtype, device=device)


# ---- position / momentum space ------------------------------------------

def corr_to_lex(c: torch.Tensor, geom: Geometry) -> torch.Tensor:
    """Correlation field [..., 2(parity), T, Z, W] → [..., T, Z, Y, X]."""
    lead = tuple(c.shape[:-4])
    r = c.reshape(lead + (2, geom.T, geom.Z, geom.Y, geom.Xh))
    even, odd = r.select(-5, 0), r.select(-5, 1)
    rp = _row_parity(geom, c.device)        # [T, Z, Y, 1]: (t+z+y) odd
    pairs = torch.stack([torch.where(rp, odd, even),
                         torch.where(rp, even, odd)], dim=-1)
    return pairs.reshape(lead + (geom.T, geom.Z, geom.Y, geom.X))


def momentum_list(q_sq_max: int) -> np.ndarray:
    """Integer momenta (px, py, pz) with |p|² <= q_sq_max, the reference's
    order (``GK_moms``)."""
    lim = int(np.floor(np.sqrt(q_sq_max)))
    moms = []
    for pz in range(-lim, lim + 1):
        for py in range(-lim, lim + 1):
            for px in range(-lim, lim + 1):
                if px * px + py * py + pz * pz <= q_sq_max:
                    moms.append((px, py, pz))
    return np.asarray(moms)


def _phases(geom: Geometry, moms, source_coords, box=None) -> np.ndarray:
    """exp(−2πi Σ p_i (x_i − x0_i)/L_i) [nmom, Z, Y, X] over the sites of
    ``geom``; ``box`` = (the whole lattice's geometry, this box's first
    global z, its first global y): the sites' global coordinates, and L
    the whole lattice's."""
    x0, y0, z0, _ = source_coords
    whole, z_first, y_first = (geom, 0, 0) if box is None else box
    x = np.arange(geom.X) - x0
    y = np.arange(geom.Y) + y_first - y0
    z = np.arange(geom.Z) + z_first - z0
    px = moms[:, 0].reshape(-1, 1, 1, 1)
    py = moms[:, 1].reshape(-1, 1, 1, 1)
    pz = moms[:, 2].reshape(-1, 1, 1, 1)
    return np.exp(-2j * np.pi * (px * x.reshape(1, 1, 1, -1) / whole.X
                                 + py * y.reshape(1, 1, -1, 1) / whole.Y
                                 + pz * z.reshape(1, -1, 1, 1) / whole.Z))


def momentum_project(c_lex: torch.Tensor, geom: Geometry, moms,
                     source_coords=(0, 0, 0, 0), box=None) -> torch.Tensor:
    """[..., T, Z, Y, X] → [..., T, nmom] with the phases
    exp(−2πi Σ p_i (x_i − x0_i)/L_i); ``box`` as in ``_phases`` (the
    box's partial sum)."""
    ph = torch.as_tensor(_phases(geom, np.asarray(moms), source_coords,
                                 box),
                         dtype=c_lex.dtype, device=c_lex.device)
    flat = c_lex.reshape(tuple(c_lex.shape[:-3]) + (-1,))
    with full_float32():
        return flat @ ph.reshape(ph.shape[0], -1).T


def momentum_project_dyn(c_lex: torch.Tensor, geom: Geometry, moms,
                         source, box=None) -> torch.Tensor:
    """``momentum_project`` with the source shift as a per-momentum
    factor, e^{−2πi p·(x−x0)/L} = e^{−2πi p·x/L} e^{+2πi p·x0/L}
    (the JAX package's form for a traced source; ``source`` any
    length-4 integers).  ``box`` as in ``_phases``."""
    base = momentum_project(c_lex, geom, moms, (0, 0, 0, 0), box)
    whole = geom if box is None else box[0]
    m = np.asarray(moms, dtype=np.float64)
    x0, y0, z0 = (float(int(v)) for v in list(source)[:3])
    phase = np.exp(2j * np.pi * (m[:, 0] * x0 / whole.X
                                 + m[:, 1] * y0 / whole.Y
                                 + m[:, 2] * z0 / whole.Z))
    return base * torch.as_tensor(phase, dtype=base.dtype,
                                  device=base.device)


def box_of(geom: Geometry, mesh):
    """``_phases``' ``box`` of this rank on ``mesh`` for the whole
    lattice ``geom`` (None without a mesh)."""
    if mesh is None:
        return None
    return (geom, mesh.box_range(1, geom.Z)[0], mesh.box_range(2, geom.Y)[0])


def t_gather(c: torch.Tensor, mesh, space: str = "momentum") -> torch.Tensor:
    """A correlator of this rank's box joined whole on every rank:
    [..., T, nmom] in momentum space, each box's partial sum over its
    sites (projected with the global coordinates' phases) summed over
    the spatial ranks and joined along t (``LatticeMesh.join_t``; on a
    t-ring the all-gather in t), [..., T, Z, Y, X] in position space
    joined by grid coordinates (``allgather_box``).  The momentum
    projection has no t dependence, so each rank projects its own rows
    first.  ``c`` itself when ``mesh`` is None."""
    if mesh is None:
        return c
    if space == "momentum":
        return mesh.join_t(c, -2, partial=True)
    return mesh.allgather_box(c, (-4, -3, -2))


def fft_project(c_lex: torch.Tensor) -> torch.Tensor:
    """The full momentum grid by a spatial FFT (the reference's batched
    CUFFT projection)."""
    return torch.fft.fftn(c_lex, dim=(-3, -2, -1))


def fft_join(c_lex: torch.Tensor, mesh) -> torch.Tensor:
    """``fft_project`` of a field of this rank's box [..., T, Z, Y, X],
    joined whole on every rank: the rank's t rows gathered over its
    spatial ranks only (``allgather_spatial``; never the whole lattice),
    their FFT, then the t rows joined (``join_t``)."""
    if mesh is None:
        return fft_project(c_lex)
    whole = mesh.allgather_spatial(c_lex, (-3, -2))
    return mesh.join_t(fft_project(whole), -4)


# ---- mesons -------------------------------------------------------------

def meson_correlators(prop_up: torch.Tensor,
                      prop_dn: torch.Tensor) -> torch.Tensor:
    """Position-space meson correlators of both flavours
    [10(type), 2(flavour), 2(parity), T, Z, W]: Σ over spins and colours
    of (Γ S Γ)[d, g] S*[d, g]."""
    out = []
    for s in (prop_up, prop_dn):
        per_type = []
        for gm in MESON_G:
            gsg = _apply_spin(gm.T, _apply_spin(gm, s, 1), 2)
            per_type.append((gsg * s.conj()).sum(dim=(1, 2, 3, 4)))
        out.append(torch.stack(per_type))
    return torch.stack(out, dim=1)


# ---- baryons ------------------------------------------------------------

def _absorbed(field, sub: str, A, B):
    """A factor of a baryon term with A (row b → a) and B (column e → d)
    applied to it, where it has those indices: (field, subscripts)."""
    if sub[1] == "b":
        field = _apply_spin(A, field, 1)
        sub = sub[0] + "a" + sub[2:]
    if sub[2] == "e":
        field = _apply_spin(B.T, field, 2)
        sub = sub[:2] + "d" + sub[3:]
    return field, sub


def _term(factors, A, B, eps) -> torch.Tensor:
    """Σ A[a,b] B[e,d] F1 F2 F3 ε_uvc ε_xyk → [4(γ), 4(γ'), p, t, z, w]
    for ``factors`` [(field, subscripts)] with A and B absorbed first."""
    fs = [_absorbed(f, s, A, B) for f, s in factors]
    spec = ",".join(s for _, s in fs) + ",uvc,xyk->ghptzw"
    return heinsum(spec, *(f for f, _ in fs), eps, eps)


def _nucleon_like(u, d, A, B, CL, CR, overall):
    """Nucleon-family contraction (the reference's ``contractBaryons``,
    types 0-3):
    C[γ,γ',p,t,z,w] = overall Σ A[α,β] B[β',α'] εε D[β,β']
    (U[α,α'] Uo[γ,γ'] − Ur[α,γ'] Ul[γ,α']) with Ul = CL·U (sink insertion),
    Ur = U·CRᵀ (source), Uo = CL·U·CRᵀ."""
    eps = _eps(u.dtype, u.device)
    ul = u if CL is None else _apply_spin(CL, u, 1)
    ur = u if CR is None else _apply_spin(CR, u, 2)
    uo = ur if CL is None else (ul if CR is None else _apply_spin(CL, ur, 1))
    t1 = _term([(d, _F[("b", "e")]), (u, _F[("a", "d")]),
                (uo, _F[("g", "h")])], A, B, eps)
    t2 = _term([(d, _F[("b", "e")]), (ur, _F[("a", "h")]),
                (ul, _F[("g", "d")])], A, B, eps)
    return overall * (t1 - t2)


def _delta_like(u, d, A, B, mixed: bool):
    """Delta contractions (the reference's ``contractBaryons``, types
    4-9).  mixed=False: Δ++-type, every quark from ``u`` (6 terms);
    mixed=True: Δ+-type, one quark from ``d`` (8 terms, × 1/3)."""
    eps = _eps(u.dtype, u.device)
    if not mixed:
        terms = [(s, None, slots) for s, slots in _DELTA6]
        scale = 1.0
    else:
        terms = _DELTAZ8
        scale = 1.0 / 3.0
    acc = None
    for coeff, dpos, slots in terms:
        factors = [(d if dpos is not None and i == dpos else u, _F[slot])
                   for i, slot in enumerate(slots)]
        t = coeff * _term(factors, A, B, eps)
        acc = t if acc is None else acc + t
    return scale * acc


def baryon_correlators(prop_up: torch.Tensor,
                       prop_dn: torch.Tensor) -> torch.Tensor:
    """All 10 baryon types with open spin
    [10, 2(flavour), 4, 4, 2(parity), T, Z, W], the first flavour
    ordering first (the reference's accum1, accum2)."""
    out = []
    specs = [
        (+1.0, -_G13, _G13, None, None),        # NTN
        (-1.0, _G13, _G134, None, _G4),         # NTR
        (+1.0, -_G134, _G13, _G4, None),        # RTN
        (-1.0, _G134, _G134, _G4, _G4),         # RTR
    ]
    for overall, A, B, CL, CR in specs:
        out.append(torch.stack([
            _nucleon_like(prop_up, prop_dn, A, B, CL, CR, overall),
            _nucleon_like(prop_dn, prop_up, A, B, CL, CR, overall)]))
    for mixed in (False, True):
        for k in range(3):
            out.append(torch.stack([
                _delta_like(prop_up, prop_dn, _DELTA_A[k], _DELTA_B[k],
                            mixed),
                _delta_like(prop_dn, prop_up, _DELTA_A[k], _DELTA_B[k],
                            mixed)]))
    return torch.stack(out)
