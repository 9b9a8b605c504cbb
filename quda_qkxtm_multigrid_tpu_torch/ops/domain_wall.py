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
plain ``dslash_parity`` of each slice.  ``Hop4D.ch`` is the span
``op.hop5`` and takes K2's xpay (x + c·hop).

The fifth-dimension passes (M5): every site-local pass of the Möbius
operator is out(s) = Σ_s' A_χ[s, s'] ψ(s') (+ a·x(s)) with a real [Ls,
Ls] matrix a chirality (``mobius5_matrices``, built once in float64:
D4pre, D̃5, D̃5⁻¹, D4pre D̃5⁻¹, κ2 D̃5⁻¹ and their adjoints).
``mobius5_ch`` launches ``csrc/mobius5_ch.cu`` once on CUDA float32
channels (the span and counter ``op.mobius5``) and refuses anything
else; ``mobius5_plain`` is its plain version.  ``MobiusDirac._m5`` is
the one place that picks between them: the kernel for a CUDA field on
the kernel route (so a float64 field there raises), the plain version
for a CPU field or off the kernel route.

The solve path: ``MobiusDirac`` (s-constant b5, c5) keeps the gauge
channels and the M5 matrices once, runs on channels from its first pass
to its last, and has the interface of ``invert``: ``prepare``,
``reconstruct``, ``matpc(dagger=)`` (2 hops and 3 M5 passes, the
symmetric even-even Schur form of ``mdw_matpc``), ``matpc_dagm`` and
``m`` (``mdw_mat``), counted in ``op.applies`` at their outermost
entry.  ``invert(op, b, solver="cg")`` dispatches to ``invert_mobius``
(the span ``dw.solve``): the Schur source, CG on M_pc† M_pc in the
operator's channel dtype (the span ``dw.cg``, whose self time is CG's
own vector updates and reductions), the odd parity rebuilt and the true
residual of the full 5D system.  ``mdw_mat`` and ``mdw_matpc`` stay for their
callers.
"""

from __future__ import annotations

import ctypes
import functools
import numbers

import numpy as np
import torch

from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry
from quda_qkxtm_multigrid_tpu_torch.ops.dslash import (
    double_gauge, dslash_parity)
from quda_qkxtm_multigrid_tpu_torch.ops.dslash_kernel import (
    antiperiodic_t, dslash_ch, dslash_ch_msrc, from_channels, gauge_channels,
    to_channels)
from quda_qkxtm_multigrid_tpu_torch.utils.precision import full_float32
from quda_qkxtm_multigrid_tpu_torch.utils.profiling import (
    PROFILE, op_entry, span, spanned)

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

    def ch(self, psi_ch: torch.Tensor, parity: int, dagger: bool = False,
           xpay_coef: float | None = None,
           x_ch: torch.Tensor | None = None) -> torch.Tensor:
        """The hop of channels [Ls, T, 24, Z, W], bare or, with
        ``xpay_coef``, x + c·hop (``x_ch`` of ψ's shape): one
        multi-source launch at n = Ls in float32, one double-precision
        launch a slice in float64; the span ``op.hop5``."""
        psi_ch = psi_ch.contiguous()
        g = self.gauge_ch(psi_ch.dtype, parity)
        kw = dict(self.hop_kw)
        if xpay_coef is not None:
            kw.update(xpay_coef=float(xpay_coef), x_ch=x_ch.contiguous())
        with span("op.hop5"):
            if psi_ch.dtype == torch.float32:
                return dslash_ch_msrc(g, psi_ch, parity, self.geom, dagger,
                                      **kw)
            xs = kw.pop("x_ch", None)
            return torch.stack([
                dslash_ch(g, v, parity, self.geom, dagger, **kw,
                          **({} if xs is None else {"x_ch": xs[s]}))
                for s, v in enumerate(psi_ch)])

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


# ---- the fifth-dimension passes of the Möbius operator (M5) ---------------
# Every site-local pass of ``mdw_matpc`` and ``mdw_mat`` has one shape:
# out(s) = Σ_s' A_χ[s, s'] ψ(s') (+ a·x(s)), χ the chirality of the spin
# (spins 0-1: channels 0-11, spins 2-3: channels 12-23) and A a real
# [Ls, Ls] matrix a chirality.  ``mobius5_matrices`` builds each A once
# in float64; a pass is one launch of ``csrc/mobius5_ch.cu`` on a CUDA
# float32 field (``mobius5_ch``) or the plain ``mobius5_plain``, as
# ``MobiusDirac._m5`` picks.

MOBIUS5_MAX_LS = 32          # the kernel's largest Ls (csrc/mobius5_ch.cu)


def mobius5_matrices(ls: int, m5: float, mferm: float, b5: float,
                     c5: float) -> dict:
    """The real [2, Ls, Ls] matrices (float64) of the Möbius operator's
    fifth-dimension passes, s-constant b5 and c5:

      pre          D4pre = b5 + (c5/2) D5hop
      d5, inv      D̃5 = 1 + κ5 D5hop and D̃5⁻¹
      pre_inv      D4pre D̃5⁻¹ (between the two hops of M_pc)
      inv_k2       κ2 D̃5⁻¹, κ2 = −κ_b² (M_pc's last pass, with x = ψ)
      *_dag        the adjoints: pre_dag = D4preᵀ, d5_dag = D̃5ᵀ,
                   inv_k2_dag = κ2 D̃5⁻ᵀ, inv_pre_dag = D̃5⁻ᵀ D4preᵀ,
                   kb_pre_dag = −κ_b D4preᵀ (M†'s hop term)
    """
    kb, _, k5 = mdw_kappas(b5, c5, m5, ls)
    kb, k5 = float(kb[0]), float(k5[0])
    one = np.eye(ls)
    # D5hop of spins 0-1 and of spins 2-3, exactly: D̃5 at κ5 = 1, less 1
    hop = _d5_matrices(ls, np.ones(ls), mferm).real[[0, 2]] - one
    pre = b5 * one + 0.5 * c5 * hop
    d5 = one + k5 * hop
    inv = np.linalg.inv(d5)
    t = lambda a: np.swapaxes(a, 1, 2)     # noqa: E731
    return {"pre": pre, "d5": d5, "inv": inv, "pre_inv": pre @ inv,
            "inv_k2": -kb * kb * inv, "pre_dag": t(pre), "d5_dag": t(d5),
            "inv_k2_dag": -kb * kb * t(inv), "inv_pre_dag": t(inv) @ t(pre),
            "kb_pre_dag": -kb * t(pre)}


def mobius5_plain(mat: torch.Tensor, v_ch: torch.Tensor,
                  x_ch: torch.Tensor | None = None,
                  a: float = 0.0) -> torch.Tensor:
    """out(s) = Σ_s' mat[χ, s, s'] v(s') (+ a·x(s)) on channels [Ls, T,
    24, Z, W], ``mat`` [2, Ls, Ls] in ``v_ch``'s dtype (module note
    above): the plain version of ``mobius5_ch``."""
    ls, t, _, z, w = v_ch.shape
    with full_float32():
        out = torch.einsum("hsr,rthczw->sthczw", mat,
                           v_ch.reshape(ls, t, 2, 12, z, w))
    out = out.reshape(v_ch.shape)
    if x_ch is not None:
        out = out.add_(x_ch, alpha=a)
    return out


def mobius5_ch(mat: torch.Tensor, v_ch: torch.Tensor,
               x_ch: torch.Tensor | None = None,
               a: float = 0.0) -> torch.Tensor:
    """``mobius5_plain``'s pass as one launch of ``csrc/mobius5_ch.cu``
    on the current stream for a CUDA float32 ``v_ch`` (Ls ≤
    ``MOBIUS5_MAX_LS``), as the span ``op.mobius5``, counted in
    ``mobius5_ch.launches`` and the counters ``op.mobius5`` (launches)
    and ``op.mobius5.xpay`` (those with ``x_ch``).  Another dtype, a
    tensor off the card, another shape or a larger Ls raises before any
    launch."""
    if v_ch.dim() != 5 or v_ch.shape[2] != 24:
        raise ValueError(f"v_ch shape {tuple(v_ch.shape)} is not "
                         "[Ls, T, 24, Z, W]")
    ls = v_ch.shape[0]
    if tuple(mat.shape) != (2, ls, ls) or mat.dtype != v_ch.dtype:
        raise ValueError(f"mat {tuple(mat.shape)} {mat.dtype} is not "
                         f"[2, {ls}, {ls}] {v_ch.dtype}")
    if x_ch is not None and (x_ch.shape != v_ch.shape
                             or x_ch.dtype != v_ch.dtype):
        raise ValueError(f"x_ch {tuple(x_ch.shape)} {x_ch.dtype} is not "
                         f"v_ch's {tuple(v_ch.shape)} {v_ch.dtype}")
    if v_ch.device.type != "cuda" or any(
            t is not None and t.device != v_ch.device for t in (mat, x_ch)):
        raise ValueError(f"mobius5_ch takes CUDA tensors on one device, "
                         f"not v_ch on {v_ch.device}, mat on {mat.device}")
    if v_ch.dtype != torch.float32:
        raise TypeError(f"mobius5_ch launches on float32 channels, not "
                        f"{v_ch.dtype}")
    t, _, z, w = v_ch.shape[1:]
    if ls > MOBIUS5_MAX_LS:
        raise ValueError(f"Ls {ls} > {MOBIUS5_MAX_LS}, the kernel's most")
    mat, v_ch = mat.contiguous(), v_ch.contiguous()
    x_ch = None if x_ch is None else x_ch.contiguous()
    out = torch.empty_like(v_ch)
    from quda_qkxtm_multigrid_tpu_torch import _build
    stream = torch.cuda.current_stream(v_ch.device).cuda_stream
    with span("op.mobius5"), torch.cuda.device(v_ch.device):
        err = _build.load_library().qkx_mobius5_ch_f32(
            mat.data_ptr(), v_ch.data_ptr(),
            None if x_ch is None else x_ch.data_ptr(), out.data_ptr(),
            ls, t * 24, z * w, float(a), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"mobius5_ch kernel launch failed: CUDA error "
                           f"{err}")
    mobius5_ch.launches += 1
    PROFILE.count("op.mobius5")
    if x_ch is not None:
        PROFILE.count("op.mobius5.xpay")
    return out


mobius5_ch.launches = 0


# ---- the Möbius operator on the solve path --------------------------------

class MobiusDirac:
    """The Möbius domain-wall operator of ``mdw_mat`` / ``mdw_matpc``
    (s-constant b5, c5; QUDA_MATPC_EVEN_EVEN, the symmetric Schur form)
    with the interface ``invert`` uses: ``prepare``, ``reconstruct``,
    ``matpc(dagger=)``, ``matpc_dagm`` and ``m``.

    It keeps the gauge channels of its ``Hop4D`` (float32 for complex64
    links, float64 for complex128) and the M5 matrices
    (``mobius5_matrices``) in that dtype, once.  Every method runs on
    channels from its first pass to its last: a parity [Ls, T, 24, Z,
    W], a full field [2, Ls, T, 24, Z, W]; a complex field ([Ls, 4, 3,
    T, Z, W], [Ls, 2, 4, 3, T, Z, W]) crosses to channels and back once
    a call.  M_pc is 2 hops (K2 at n = Ls) and 3 M5 passes; M is 2 hops
    and 4 passes.  The passes launch ``mobius5_ch`` on a CUDA field
    with ``use_kernels`` (None: a CUDA gauge), which takes float32 only:
    a complex128 operator on the card runs with ``use_kernels=False``.
    A CPU field, or ``use_kernels=False``, runs the plain version."""

    def __init__(self, u: torch.Tensor, geom: Geometry, ls: int, m5: float,
                 mferm: float, b5: float, c5: float,
                 use_kernels: bool | None = None):
        if not all(isinstance(c, numbers.Real) for c in (b5, c5)):
            raise TypeError("MobiusDirac takes s-constant b5 and c5; "
                            "zMöbius runs through mdw_mat / mdw_matpc")
        self.geom, self.ls = geom, int(ls)
        self.m5, self.mferm, self.b5, self.c5 = m5, mferm, b5, c5
        self.hop = Hop4D(u, geom, use_kernels)
        self.dtype = (torch.float32 if u.dtype == torch.complex64
                      else torch.float64)
        self.kappa_b = float(mdw_kappas(b5, c5, m5, self.ls)[0][0])
        self.mats = {k: torch.tensor(v, dtype=self.dtype, device=u.device)
                     for k, v in mobius5_matrices(self.ls, m5, mferm, b5,
                                                  c5).items()}
        for p in (0, 1):
            self.hop.gauge_ch(self.dtype, p)

    # ---- layouts ------------------------------------------------------
    def _parity_ch(self, v: torch.Tensor) -> torch.Tensor:
        return (to_channels5(v) if v.is_complex() else v).to(self.dtype)

    def _full_ch(self, v: torch.Tensor):
        """(even, odd) channels of a full field in either layout."""
        if v.is_complex():
            return tuple(to_channels5(v[:, p]).to(self.dtype)
                         for p in (0, 1))
        return v[0].to(self.dtype), v[1].to(self.dtype)

    @staticmethod
    def _parity_out(out_ch: torch.Tensor, like: torch.Tensor):
        if not like.is_complex():
            return out_ch
        return from_channels5(out_ch).to(like.dtype)

    @staticmethod
    def _full_out(even: torch.Tensor, odd: torch.Tensor,
                  like: torch.Tensor) -> torch.Tensor:
        """The full field of two parities' channels in ``like``'s
        layout, written slice by slice (no stacked copies)."""
        if not like.is_complex():
            return torch.stack([even, odd])
        ls = even.shape[0]
        out = torch.empty((ls, 2, 4, 3) + tuple(even.shape[-4:-3])
                          + tuple(even.shape[-2:]), dtype=like.dtype,
                          device=even.device)
        for p, ch in enumerate((even, odd)):
            for s in range(ls):
                out[s, p] = from_channels(ch[s], (4, 3))
        return out

    # ---- the passes -----------------------------------------------------
    def _m5(self, name: str, v: torch.Tensor, x: torch.Tensor | None = None,
            a: float = 1.0) -> torch.Tensor:
        if self.hop.use_kernels and v.is_cuda:
            return mobius5_ch(self.mats[name], v, x, a)
        return mobius5_plain(self.mats[name], v, x, a)

    def matpc_ch(self, v: torch.Tensor, dagger: bool = False):
        """M_pc (or M_pc†) of channels [Ls, T, 24, Z, W] on the even
        parity: 2 hops, 3 passes (``mdw_matpc``)."""
        h = self.hop.ch
        if not dagger:
            t = h(self._m5("pre", v), 1)
            t = h(self._m5("pre_inv", t), 0)
            return self._m5("inv_k2", t, v)
        t = h(self._m5("inv_k2_dag", v), 1, True)
        t = h(self._m5("inv_pre_dag", t), 0, True)
        return self._m5("pre_dag", t, v)

    def m_ch(self, even: torch.Tensor, odd: torch.Tensor,
             dagger: bool = False):
        """(M ψ)_e, (M ψ)_o of two parities' channels (``mdw_mat``):
        D̃5 ψ_p − κ_b D4 D4pre ψ_{1−p}, or its adjoint."""
        parts, kb = (even, odd), self.kappa_b
        out = []
        for p in (0, 1):
            if not dagger:
                t = self._m5("pre", parts[1 - p])
                out.append(self.hop.ch(t, p, False, -kb,
                                       self._m5("d5", parts[p])))
            else:
                t = self.hop.ch(parts[1 - p], p, True)
                out.append(self._m5("kb_pre_dag", t,
                                    self._m5("d5_dag", parts[p])))
        return out[0], out[1]

    def prepare_ch(self, b_e: torch.Tensor, b_o: torch.Tensor):
        """The Schur source D̃5⁻¹(b_e + κ_b D4 D4pre D̃5⁻¹ b_o)."""
        t = self.hop.ch(self._m5("pre_inv", b_o), 0, False, self.kappa_b,
                        b_e)
        return self._m5("inv", t)

    def reconstruct_ch(self, x_e: torch.Tensor, b_o: torch.Tensor):
        """The odd parity D̃5⁻¹(b_o + κ_b D4 D4pre x_e)."""
        t = self.hop.ch(self._m5("pre", x_e), 1, False, self.kappa_b, b_o)
        return self._m5("inv", t)

    # ---- the interface of ``invert`` --------------------------------
    @op_entry("op.matpc")
    def matpc(self, psi_p: torch.Tensor, dagger: bool = False):
        return self._parity_out(self.matpc_ch(self._parity_ch(psi_p),
                                              dagger), psi_p)

    @op_entry("op.matpc", applies=2)
    def matpc_dagm(self, psi_p: torch.Tensor) -> torch.Tensor:
        v = self._parity_ch(psi_p)
        return self._parity_out(self.matpc_ch(self.matpc_ch(v), True),
                                psi_p)

    @op_entry("op.m")
    def m(self, psi: torch.Tensor, dagger: bool = False) -> torch.Tensor:
        return self._full_out(*self.m_ch(*self._full_ch(psi), dagger), psi)

    def prepare(self, b: torch.Tensor) -> torch.Tensor:
        """b (full) → the Schur source on the even parity."""
        return self._parity_out(self.prepare_ch(*self._full_ch(b)), b)

    def reconstruct(self, x_e: torch.Tensor, b: torch.Tensor):
        """The even-parity solution and the source → the full solution."""
        xe = self._parity_ch(x_e)
        return self._full_out(xe, self.reconstruct_ch(
            xe, self._full_ch(b)[1]), b)


@spanned("dw.solve")
def invert_mobius(op: MobiusDirac, b: torch.Tensor, tol: float = 1e-7,
                  maxiter: int = 2000):
    """Solve M x = b (``invert``'s Möbius route): b (full, either
    layout) to channels, the Schur source, CG on M_pc† M_pc in the
    operator's channel dtype (float32 for complex64 links) to ``tol``
    as the span ``dw.cg``, the odd parity rebuilt, and the true
    residual |b − M x| / |b| of the full system.  Returns an ``invert.InvertResult`` with x in b's
    layout and dtype."""
    from quda_qkxtm_multigrid_tpu_torch.invert import InvertResult
    from quda_qkxtm_multigrid_tpu_torch.ops.blas import norm2
    from quda_qkxtm_multigrid_tpu_torch.solvers.cg import cg
    b_e, b_o = op._full_ch(b)
    src = op.prepare_ch(b_e, b_o)
    rhs = op.matpc(src, dagger=True)
    del src
    with span("dw.cg"):
        res = cg(op.matpc_dagm, rhs, tol=tol, maxiter=maxiter)
    del rhs
    x_e = res.x
    x_o = op.reconstruct_ch(x_e, b_o)
    r2 = b2 = 0.0
    for bp, mp in zip((b_e, b_o), op.m_ch(x_e, x_o)):
        r2 = r2 + norm2(bp - mp)
        b2 = b2 + norm2(bp)
    del b_e, b_o
    rel = float(torch.sqrt(r2 / b2))
    return InvertResult(op._full_out(x_e, x_o, b), res.iters, rel)
