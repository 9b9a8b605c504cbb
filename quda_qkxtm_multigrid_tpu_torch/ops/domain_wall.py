"""Domain-wall fermions, Shamir (4D even-odd) and Möbius / zMöbius: the
counterpart of the JAX package's ``ops/domain_wall.py`` (the reference's
``tests/domain_wall_dslash_reference.cpp`` oracles).

  * 4D part (``dslash4``): the Wilson hop of every s-slice, all slices on
    one gauge (``dslashReference_4d``);
  * 5th dimension (``dslash5``): out(x, s) = PR ψ(x, s+1) + PL ψ(x, s−1)
    with PR = 1 − γ5 = diag(0, 0, 2, 2), PL = 1 + γ5 = diag(2, 2, 0, 0)
    and −mferm on the wrap s = Ls−1 → 0 (forward) and 0 → Ls−1
    (backward); dagger swaps PR and PL;
  * Shamir: ``dw4d_mat`` = ψ − κ5 (D4 + D5) ψ, κ5 = 1 / (2 (5 − M5));
  * Möbius (``mdw_*``): κ_b, κ_c and κ5 per s from b5, c5 (scalars or
    per-s arrays, zMöbius), D̃5⁻¹ as a dense [Ls, Ls] inverse per spin
    built once on the host in float64, and the true adjoint under
    ``dagger`` (the reference oracle keeps C5 on the left, which is the
    adjoint only for s-constant coefficients).

Layouts: a 5D field [Ls, 2, 4, 3, T, Z, W], one parity [Ls, 4, 3, T, Z,
W] (complex).  The same fields on planar channels (real, the layout of
``ops/dslash_kernel``): one parity [Ls, T, 24, Z, W], a full field
[2, Ls, T, 24, Z, W].  The site-local functions (``dslash5``,
``mdw_dslash4_pre``, ``mdw_dslash5``, ``mdw_dslash5_inv``) take either
layout; the operators take either, and the gauge ``u`` or a ``Hop4D``.

The hop (``Hop4D``): on the kernel route (a CUDA gauge, or
``use_kernels=True``) an operator runs on channels from its first hop to
its last.  Its Ls slices are one bare launch of the multi-source hop at
n = Ls in float32 (K2, ``dslash_ch_msrc``), one double-precision launch
a slice in float64 (K1 f64, ``dslash_ch``), recon-12 with the t boundary
read from the links (``antiperiodic_t``), recon-18 where the links are
not SU(3) up to that sign.  A complex field on the kernel route crosses
to channels and back once an operator (once a hop where the ``Hop4D`` is
called on it directly).  On a CPU tensor the wrappers run their plain
versions; off the kernel route (``use_kernels=False``) the hop is the
plain ``dslash_parity`` of each slice.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry
from quda_qkxtm_multigrid_tpu_torch.ops.dslash import (
    double_gauge, dslash_parity)
from quda_qkxtm_multigrid_tpu_torch.ops.dslash_kernel import (
    antiperiodic_t, dslash_ch, dslash_ch_msrc, from_channels, gauge_channels,
    to_channels)
from quda_qkxtm_multigrid_tpu_torch.utils.precision import full_float32

DW_DSLASH_FLOPS_PER_SITE = 1320   # 4D part; +96 bulk / 120 wall for 5th dim

_PR = np.diag([0.0, 0.0, 2.0, 2.0])   # 1 - gamma5
_PL = np.diag([2.0, 2.0, 0.0, 0.0])   # 1 + gamma5


def kappa5(m5: float) -> float:
    return 1.0 / (2.0 * (4.0 - m5 + 1.0))


# ---- the two layouts ------------------------------------------------------

def to_channels5(psi5: torch.Tensor) -> torch.Tensor:
    """complex [Ls, 4, 3, T, Z, W] → real channels [Ls, T, 24, Z, W]."""
    return torch.stack([to_channels(v) for v in psi5])


def from_channels5(ch: torch.Tensor) -> torch.Tensor:
    """real channels [Ls, T, 24, Z, W] → complex [Ls, 4, 3, T, Z, W]."""
    return torch.stack([from_channels(v, (4, 3)) for v in ch])


def _halves(v: torch.Tensor):
    """(spins 0-1, spins 2-3) of one parity in either layout."""
    if v.is_complex():
        return v[:, :2], v[:, 2:]
    return v[:, :, :12], v[:, :, 12:]


def _join(upper: torch.Tensor, lower: torch.Tensor) -> torch.Tensor:
    return torch.cat([upper, lower], dim=1 if upper.is_complex() else 2)


def _spin_mix(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """out[s, spin t] = Σ_r m[t, s, r] v[r, spin t] (m [4, Ls, Ls])."""
    if v.is_complex():
        return torch.einsum("tsr,rtc...->stc...", m, v)
    ls, t, _, z, w = v.shape
    with full_float32():
        out = torch.einsum("tsr,rxtcyz->sxtcyz", m,
                           v.reshape(ls, t, 4, 6, z, w))
    return out.reshape(v.shape)


def _sfac(coef, v: torch.Tensor) -> torch.Tensor:
    """A per-s coefficient (scalar or [Ls]) broadcast over ``v``."""
    dt = v.real.dtype if v.is_complex() else v.dtype
    c = torch.as_tensor(np.asarray(coef, np.float64), dtype=dt,
                        device=v.device)
    return c.reshape((-1,) + (1,) * (v.dim() - 1))


# ---- the 4D hop -----------------------------------------------------------

class Hop4D:
    """The 4D Wilson hop of every s-slice of a 5D field on the links
    ``u`` [4, 2, 3, 3, T, Z, W], with the kernels' gauge operands built
    once per operand dtype (module docstring).  ``use_kernels`` None
    takes the kernel route for a CUDA gauge."""

    def __init__(self, u: torch.Tensor, geom: Geometry,
                 use_kernels: bool | None = None):
        self.u = u
        self.geom = geom
        self.use_kernels = (u.device.type == "cuda" if use_kernels is None
                            else bool(use_kernels))
        self._kw = None
        self._g = {}

    def _gauge(self, dtype: torch.dtype):
        """(gauge channels of parity 0, of parity 1) in the real
        ``dtype``; the first call also reads the gauge form."""
        if dtype not in self._g:
            ud = double_gauge(self.u, self.geom)
            if self._kw is None:
                try:
                    self._kw = dict(recon12=True,
                                    antiperiodic=antiperiodic_t(ud))
                except ValueError:      # links off SU(3): all 18 reals
                    self._kw = dict(recon12=False)
            self._g[dtype] = tuple(gauge_channels(ud, p, self._kw["recon12"],
                                                  dtype) for p in (0, 1))
        return self._g[dtype]

    @property
    def hop_kw(self) -> dict:
        """The gauge keywords of the hops (recon-12 and the t boundary,
        or recon-18)."""
        if self._kw is None:
            self._gauge(torch.float32 if self.u.dtype == torch.complex64
                        else torch.float64)
        return self._kw

    def gauge_ch(self, dtype: torch.dtype, parity: int) -> torch.Tensor:
        return self._gauge(dtype)[parity]

    def ch(self, psi_ch: torch.Tensor, parity: int,
           dagger: bool = False) -> torch.Tensor:
        """The bare hop of channels [Ls, T, 24, Z, W]: one multi-source
        launch at n = Ls in float32, one double-precision launch a slice
        in float64."""
        psi_ch = psi_ch.contiguous()
        g = self.gauge_ch(psi_ch.dtype, parity)
        kw = self.hop_kw
        if psi_ch.dtype == torch.float32:
            return dslash_ch_msrc(g, psi_ch, parity, self.geom, dagger, **kw)
        return torch.stack([dslash_ch(g, v, parity, self.geom, dagger, **kw)
                            for v in psi_ch])

    def plain(self, psi5: torch.Tensor, parity: int,
              dagger: bool = False) -> torch.Tensor:
        """The plain ``dslash_parity`` of each slice of [Ls, 4, 3, T, Z,
        W]."""
        return torch.stack([dslash_parity(self.u, v, parity, self.geom,
                                          dagger) for v in psi5])

    def __call__(self, v: torch.Tensor, parity: int,
                 dagger: bool = False) -> torch.Tensor:
        """The hop of one parity in its layout: channels through ``ch``;
        a complex field through ``ch`` and back on the kernel route,
        through ``plain`` off it."""
        if not v.is_complex():
            return self.ch(v, parity, dagger)
        if not self.use_kernels:
            return self.plain(v, parity, dagger)
        return from_channels5(self.ch(to_channels5(v), parity, dagger))


def _as_hop(u, geom: Geometry) -> Hop4D:
    return u if isinstance(u, Hop4D) else Hop4D(u, geom)


def _apply(op, hop: Hop4D, psi: torch.Tensor, full: bool) -> torch.Tensor:
    """``op(psi)`` in ``psi``'s layout; a complex field on the kernel
    route goes through channels (``full``: [Ls, 2, ...] ↔ [2, Ls, ...])."""
    if not (psi.is_complex() and hop.use_kernels):
        return op(psi)
    if not full:
        return from_channels5(op(to_channels5(psi)))
    out = op(torch.stack([to_channels5(psi[:, p]) for p in (0, 1)]))
    return torch.stack([from_channels5(o) for o in out], dim=1)


def _parities(psi5: torch.Tensor):
    """(even, odd) of a full field in either layout, and the stacking
    axis."""
    axis = 1 if psi5.is_complex() else 0
    return (psi5.select(axis, 0), psi5.select(axis, 1)), axis


def dslash4(u, psi5_opp: torch.Tensor, parity: int, geom: Geometry,
            dagger: bool = False) -> torch.Tensor:
    """4D Wilson hop of every s-slice, writing sites of ``parity``:
    psi5_opp [Ls, 4, 3, T, Z, W] (or channels [Ls, T, 24, Z, W])."""
    return _as_hop(u, geom)(psi5_opp, parity, dagger)


# ---- the 5th dimension ----------------------------------------------------

def _shift_s(h: torch.Tensor, step: int, mferm: float) -> torch.Tensor:
    """2 ψ(s − step) a slice, −2 mferm on the slice the shift wraps onto
    (s = 0 for step 1, s = Ls − 1 for step −1)."""
    ls = h.shape[0]
    fac = np.full(ls, 2.0)
    fac[0 if step == 1 else ls - 1] = -2.0 * mferm
    return torch.roll(h, step, dims=0) * _sfac(fac, h)


def dslash5(psi5_same: torch.Tensor, mferm: float,
            dagger: bool = False) -> torch.Tensor:
    """5th-dimension hop (site-local in 4D) of one parity, either
    layout."""
    upper, lower = _halves(psi5_same)
    if dagger:      # PR ↔ PL: spins 0-1 from s+1, spins 2-3 from s−1
        return _join(_shift_s(upper, -1, mferm), _shift_s(lower, 1, mferm))
    return _join(_shift_s(upper, 1, mferm), _shift_s(lower, -1, mferm))


# ---- Shamir ---------------------------------------------------------------

def dw4d_mat(u, psi5: torch.Tensor, kappa: float, mferm: float,
             geom: Geometry, dagger: bool = False) -> torch.Tensor:
    """Full 4D-PC domain-wall operator on [Ls, 2, 4, 3, T, Z, W] (or
    channels [2, Ls, T, 24, Z, W]): out = ψ − κ (D4 + D5) ψ (the
    reference's dw_4d_mat)."""
    h = _as_hop(u, geom)

    def op(v):
        parts, axis = _parities(v)
        return torch.stack([
            parts[p] - kappa * (h(parts[1 - p], p, dagger)
                                + dslash5(parts[p], mferm, dagger))
            for p in (0, 1)], dim=axis)
    return _apply(op, h, psi5, True)


def dw4d_matpc(u, psi5_p: torch.Tensor, kappa: float, mferm: float,
               geom: Geometry, parity: int = 0,
               dagger: bool = False) -> torch.Tensor:
    """The JAX package's even-odd building block A − κ² D4 D4 with
    A = 1 − κ D5 (not the Schur complement, whose A⁻¹ the Möbius
    ``mdw_dslash5_inv`` holds)."""
    h = _as_hop(u, geom)

    def op(v):
        a = v - kappa * dslash5(v, mferm, dagger)
        t = h(h(v, 1 - parity, dagger), parity, dagger)
        return a - (kappa * kappa) * t
    return _apply(op, h, psi5_p, False)


# ---- Möbius ---------------------------------------------------------------
# κ_b[s] = 1/(2(b5[s](4+m5)+1)), κ_c[s] = 1/(2(c5[s](4+m5)−1)),
# κ5 = κ_b/(2κ_c), κ2 = −κ_b² (reference tests/dslash_test.cpp:877).

def mdw_kappas(b5, c5, m5: float, ls: int):
    """(kappa_b, kappa_c, kappa5) per-s arrays from b5/c5/m5."""
    b5 = np.broadcast_to(np.asarray(b5, np.float64), (ls,))
    c5 = np.broadcast_to(np.asarray(c5, np.float64), (ls,))
    kb = 1.0 / (2.0 * (b5 * (4.0 + m5) + 1.0))
    kc = 1.0 / (2.0 * (c5 * (4.0 + m5) - 1.0))
    return kb, kc, 0.5 * kb / kc


def mdw_dslash4_pre(psi5_same: torch.Tensor, b5, c5, mferm: float,
                    dagger: bool = False) -> torch.Tensor:
    """D4pre = B5 ψ + (1/2) C5 D5hop ψ (the reference's
    mdw_dslash_4_pre); dagger is the true adjoint
    B5 ψ + (1/2) D5hop† (C5 ψ)."""
    v = psi5_same
    if dagger:
        return _sfac(b5, v) * v + 0.5 * dslash5(_sfac(c5, v) * v, mferm,
                                                True)
    return _sfac(b5, v) * v + 0.5 * _sfac(c5, v) * dslash5(v, mferm, False)


def mdw_dslash5(psi5_same: torch.Tensor, kappa5, mferm: float,
                dagger: bool = False) -> torch.Tensor:
    """D̃5 = ψ + K5 D5hop ψ (the reference's mdw_dslash_5); dagger is the
    true adjoint ψ + D5hop† (K5 ψ)."""
    v = psi5_same
    if dagger:
        return v + dslash5(_sfac(kappa5, v) * v, mferm, True)
    return v + _sfac(kappa5, v) * dslash5(v, mferm, False)


def _d5_matrices(ls: int, kappa5, mferm: float) -> np.ndarray:
    """[4, Ls, Ls] matrices of D̃5 = 1 + K5 D5hop per spin (the
    projectors are spin-diagonal with entries 0 / 2), complex128."""
    k5 = np.broadcast_to(np.asarray(kappa5, np.float64), (ls,))
    pr, pl = np.diag(_PR), np.diag(_PL)   # coefficients of ψ(s±1)
    mats = np.zeros((4, ls, ls), np.complex128)
    for t in range(4):
        a = np.eye(ls, dtype=np.complex128)
        for s in range(ls):
            sp, sm = (s + 1) % ls, (s - 1) % ls
            ffac = -mferm if s == ls - 1 else 1.0
            bfac = -mferm if s == 0 else 1.0
            a[s, sp] += k5[s] * pr[t] * ffac
            a[s, sm] += k5[s] * pl[t] * bfac
        mats[t] = a
    return mats


@functools.lru_cache(maxsize=64)
def _d5_inverse(ls: int, kappa5: tuple, mferm: float,
                dagger: bool) -> np.ndarray:
    """D̃5⁻¹ per spin [4, Ls, Ls] (its adjoint with ``dagger``), inverted
    on the host in float64 once for each (Ls, κ5, mferm)."""
    inv = np.stack([np.linalg.inv(m)
                    for m in _d5_matrices(ls, kappa5, mferm)])
    return np.conj(np.swapaxes(inv, 1, 2)) if dagger else inv


@functools.lru_cache(maxsize=64)
def _d5_inverse_tensor(ls: int, kappa5: tuple, mferm: float, dagger: bool,
                       dtype: torch.dtype, device: torch.device):
    """``_d5_inverse`` as a tensor of ``dtype`` on ``device``: complex for
    complex fields, real (the inverse of a real matrix) for channels."""
    inv = _d5_inverse(ls, kappa5, mferm, dagger)
    if not dtype.is_complex:
        if np.any(inv.imag != 0.0):
            raise ValueError("D̃5⁻¹ is not real: the channel layout takes "
                             "real κ5 and mferm only")
        inv = inv.real
    return torch.tensor(inv, dtype=dtype, device=device)


def mdw_dslash5_inv(psi5_same: torch.Tensor, kappa5, mferm: float,
                    dagger: bool = False) -> torch.Tensor:
    """Exact D̃5⁻¹ (the reference's dslashReference_5th_inv, there with
    kappa_mdwf = −κ5) as one contraction with the dense inverse; dagger
    applies (D̃5†)⁻¹ = (D̃5⁻¹)†."""
    ls = psi5_same.shape[0]
    k5 = tuple(float(k) for k in np.broadcast_to(
        np.asarray(kappa5, np.float64), (ls,)))
    inv = _d5_inverse_tensor(ls, k5, float(mferm), dagger, psi5_same.dtype,
                             psi5_same.device)
    return _spin_mix(inv, psi5_same)


def mdw_mat(u, psi5: torch.Tensor, m5: float, mferm: float, b5, c5,
            geom: Geometry, dagger: bool = False) -> torch.Tensor:
    """Full Möbius operator on [Ls, 2, 4, 3, T, Z, W] (or channels [2,
    Ls, T, 24, Z, W]; the reference's mdw_mat):
    out_p = D̃5 ψ_p − κ_b D4_{p,1−p} (D4pre ψ_{1−p}); dagger applies the
    true adjoint (each part daggered, D4 and D4pre in reverse order)."""
    h = _as_hop(u, geom)

    def op(v):
        parts, axis = _parities(v)
        kb, _, k5 = mdw_kappas(b5, c5, m5, parts[0].shape[0])
        outs = []
        for p in (0, 1):
            src = parts[1 - p]
            if not dagger:
                t = h(mdw_dslash4_pre(src, b5, c5, mferm), p)
                t = _sfac(kb, t) * t
            else:
                # (K_b D4 D4pre)† = D4pre† D4† K_b: K_b scales first
                t = h(_sfac(kb, src) * src, p, True)
                t = mdw_dslash4_pre(t, b5, c5, mferm, dagger=True)
            outs.append(mdw_dslash5(parts[p], k5, mferm, dagger) - t)
        return torch.stack(outs, dim=axis)
    return _apply(op, h, psi5, True)


def mdw_matpc(u, psi5_p: torch.Tensor, m5: float, mferm: float, b5, c5,
              geom: Geometry, parity: int = 0,
              dagger: bool = False) -> torch.Tensor:
    """Symmetric even-odd preconditioned Möbius operator (the
    reference's mdw_matpc, QUDA_MATPC_EVEN_EVEN):
    M_pc = 1 + κ2 D̃5⁻¹ D4 D4pre D̃5⁻¹ D4 D4pre, κ2 = −κ_b², with the
    adjoint ordering under ``dagger``."""
    h = _as_hop(u, geom)

    def op(v):
        ls = v.shape[0]
        kb, _, k5 = mdw_kappas(b5, c5, m5, ls)
        kappa2 = -kb * kb
        if not dagger:
            t = h(mdw_dslash4_pre(v, b5, c5, mferm), 1 - parity)
            t = mdw_dslash5_inv(t, k5, mferm)
            t = h(mdw_dslash4_pre(t, b5, c5, mferm), parity)
            t = mdw_dslash5_inv(t, k5, mferm)
            return v + _sfac(kappa2, t) * t
        # adjoint: (1 + K2 C)† = 1 + C† K2: the per-s κ2 scales first
        t = mdw_dslash5_inv(_sfac(kappa2, v) * v, k5, mferm, dagger=True)
        t = mdw_dslash4_pre(h(t, 1 - parity, True), b5, c5, mferm,
                            dagger=True)
        t = mdw_dslash5_inv(t, k5, mferm, dagger=True)
        t = mdw_dslash4_pre(h(t, parity, True), b5, c5, mferm, dagger=True)
        return v + t
    return _apply(op, h, psi5_p, False)
