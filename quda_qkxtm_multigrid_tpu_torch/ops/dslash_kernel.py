"""Fused Wilson-hop kernel on the planar-channel layout: the counterpart
of the JAX package's ``ops/dslash_pallas5.py`` (K1, ``_plane_body``).

Channel layout: a complex field [A..., T, Z, W] becomes a real
[T, prod(A)*2, Z, W] tensor with channel ``a*2 + ri``.  So a spinor is
[T, 24, Z, W], a recon-12 doubled gauge of one parity [T, 96, Z, W]
(full: [T, 144, Z, W]) and a chiral-block clover of one parity
[T, 144, Z, W].  Neighbouring w are neighbouring addresses, which is
what the CUDA kernel needs for coalesced loads.

``dslash_ch`` computes, for the output ``parity``,

    D ψ = Σ_μ (1∓γ_μ) U_μ(x) ψ(x+μ̂) + (1±γ_μ) U_μ†(x−μ̂) ψ(x−μ̂)

followed by the epilogues, in order: twist b(1 + i a γ5) or the chiral
6×6 clover ("fwd": A·, "dag": A†·); xpay x + c·(…); and an optional
second output ``post_op``: ("clover",) applies A† to the result,
("twist", a, b) applies b(1 + i a γ5) to it.

On a CUDA tensor it launches ``csrc/dslash_ch.cu`` (float or double);
on a CPU tensor it runs ``dslash_ch_reference``.  There is no fallback
between the two.

``dslash_ch_msrc`` is the multi-source form (K2, the counterpart of
``dslash_ch_pallas5_msrc``): the same hop and epilogues, ``post_op``
included, over a batch ψ [n, T, 24, Z, W] that shares one gauge and one
clover inverse, in float32.  On a CUDA tensor it launches
``csrc/dslash_ch_msrc.cu``; on a CPU tensor it runs
``dslash_ch_msrc_reference``.

The bf16 operand tier (the JAX package's ``bf16=True``, K1d and K2d)
takes bfloat16 gauge and clover-inverse channels beside float32 spinors;
the bare hop also takes a bfloat16 ψ (the form of ``Dirac.dslash`` under
``DiracParams.kernel_bf16``).  Every operand is widened to float32 and
the output is float32.  The compact channel operator (``compact.py``)
adds a bf16 gauge with a float32 clover inverse, and the bf16 spinor
storage (the JAX package's ``out_dtype=jnp.bfloat16``, K1e): bfloat16
ψ, x or output planes, float32 arithmetic, each output rounded once to
bfloat16 (``out_dtype``).  ``recon8`` takes the 8-real gauge of
``gauge_channels(recon8=True)`` [T, 64, Z, W] in float32 (K3).  The
operand dtypes pick the kernel instance (``_kernel_form``, the table
``_FORMS``); on a CUDA tensor a bf16 operand launches its instance in
``csrc/dslash_ch_bf16.cu`` or ``csrc/dslash_ch_bf16s.cu`` or raises,
never a float32 kernel on widened copies.

The sharded solve (``parallel/``) runs the t-local hop of
``csrc/dslash_ch_local.cu``, the counterparts of the JAX package's
``dslash_ch_pallas5_local`` (K4) and ``dslash_ch_pallas5_overlap_local``
(K5): ``dslash_ch_local`` on a t-slab [T_loc, 24, Z, W] and the
neighbour ranks' two planes, in one launch, and ``dslash_ch_overlap``,
which launches the interior rows before the faces have to be there and
the two edge rows after.  Same hop and epilogues (no ``post_op``), no
wrap in t; recon-12, in float32, float64 (bare) or the bf16 operand
tier.  On a grid that splits z or y, ``dslash_ch_local(zw_faces=…)``
launches K4's box instances (``csrc/dslash_ch_box.cu``), which read
the z and y faces as well and wrap no split axis.  One plain version,
``dslash_ch_local_reference``.

The antiperiodic t boundary: a gauge that carries it (the t links of
the last global t row multiplied by −1, the JAX package's
``apply_t_boundary``) loses the sign in recon-12, which rebuilds row 2
as conj(r0 × r1).  ``antiperiodic_t`` reads the boundary from the
doubled links; the recon-12 hops then take ``antiperiodic=True`` (the
t-local hops ``t_boundary``, the box's rows of global t = 0 and T−1)
and negate the rebuilt row 2 of those links, in the kernels
(``csrc/dslash_ch.cuh``) and in their plain versions alike.  The
recon-18 forms read the sign with the links; recon-8 refuses such a
gauge.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry, gather_neighbor
from quda_qkxtm_multigrid_tpu_torch.ops import gamma as _g
from quda_qkxtm_multigrid_tpu_torch.ops.clover import clover_apply
from quda_qkxtm_multigrid_tpu_torch.ops.smallmat import su3_mul, su3_dag_mul

_F32, _F64, _BF16 = torch.float32, torch.float64, torch.bfloat16
_CLOVER_MODES = {None: 0, "fwd": 1, "dag": 2}
# a bit of the kernels' parity argument: the gauge carries the
# antiperiodic t boundary (kAntiperiodicT of csrc/dslash_ch.cuh)
_ANTIPERIODIC_T = 2
# how far a stored row 2 may lie from conj(r0 × r1) (``antiperiodic_t``):
# a link farther from SU(3) gives recon-12 another operator than its
# full links, beyond single-precision storage
_SU3_TOL = {torch.complex64: 1e-5, torch.complex128: 1e-6}


def to_channels(x: torch.Tensor) -> torch.Tensor:
    """complex [A..., T, Z, W] → real [T, prod(A)*2, Z, W] (same precision)."""
    t, z, w = x.shape[-3:]
    flat = x.reshape(-1, t, z, w)
    ri = torch.stack([flat.real, flat.imag], dim=1).reshape(-1, t, z, w)
    return ri.movedim(0, 1).contiguous()


def from_channels(x: torch.Tensor, lead_shape) -> torch.Tensor:
    """real [T, prod(A)*2, Z, W] → complex [A..., T, Z, W]."""
    t, ch, z, w = x.shape
    v = x.movedim(1, 0).reshape(ch // 2, 2, t, z, w)
    return torch.complex(v[:, 0], v[:, 1]).reshape(
        tuple(lead_shape) + (t, z, w))


def cast_channels(ch: torch.Tensor, dtype: torch.dtype | None):
    """Cast real channels to ``dtype`` (None keeps them).  bfloat16 goes
    through float32, as the JAX package's operands do (float32 channels,
    then ``.astype(bf16)``), so the two round alike from complex128."""
    if dtype is None:
        return ch
    if dtype == _BF16:
        ch = ch.to(torch.float32)
    return ch.to(dtype)


def gauge_channels(ud: torch.Tensor, parity: int, recon12: bool,
                   dtype: torch.dtype | None = None,
                   recon8: bool = False) -> torch.Tensor:
    """Doubled gauge [4,2,2,3,3,T,Z,W] → channel operand of one parity:
    [T, 96, Z, W] with rows 0 and 1 only (recon-12) or [T, 144, Z, W].
    ``dtype`` casts the real channels (default: the field's precision;
    bfloat16 is the bf16 operand tier).  ``recon8`` gives the 8-real
    encoding [T, 64, Z, W] instead, channel (mu*2 + fb)*8 + j over
    [Re a2, Im a2, Re a3, Im a3, Re b1, Im b1, arg a1, arg c1] of the
    link's rows a, b, c (the JAX package's ``gauge_channels(recon8=
    True)``), computed in the field's precision and then cast; an
    antiperiodic gauge (``antiperiodic_t``) raises there."""
    if recon8:
        m = ud[:, parity]                    # [4, 2, 3, 3, T, Z, W]
        if antiperiodic_t(m):
            raise ValueError("recon-8 assumes SU(3) links: it has no form "
                             "for the antiperiodic t boundary's −1")
        a1, a2, a3 = m[:, :, 0, 0], m[:, :, 0, 1], m[:, :, 0, 2]
        b1, c1 = m[:, :, 1, 0], m[:, :, 2, 0]
        comps = torch.stack([a2.real, a2.imag, a3.real, a3.imag, b1.real,
                             b1.imag, torch.angle(a1), torch.angle(c1)],
                            dim=2)               # [4, 2, 8, T, Z, W]
        ch = comps.reshape((64,) + comps.shape[3:]).movedim(0, 1)
        return cast_channels(ch.contiguous(), dtype)
    g = ud[:, parity][:, :, :2] if recon12 else ud[:, parity]
    return cast_channels(to_channels(g), dtype)


def _row2(m: torch.Tensor) -> torch.Tensor:
    """conj(r0 × r1) of links [3, 3, ...] (rows first): the row 2 that
    recon-12 rebuilds, [3, ...]."""
    r0, r1 = m[0], m[1]
    return torch.stack([r0[(c + 1) % 3] * r1[(c + 2) % 3]
                        - r0[(c + 2) % 3] * r1[(c + 1) % 3]
                        for c in range(3)]).conj()


def antiperiodic_t(ud: torch.Tensor, t_rows=None, allmax=None) -> bool:
    """Whether doubled links of the whole lattice (``ops.dslash.
    double_gauge`` [4, 2, 2, 3, 3, T, Z, W], or one parity's
    ``doubled_links`` [4, 2, 3, 3, T, Z, W]) carry the antiperiodic t
    boundary, from each stored row 2 against the conj(r0 × r1) that
    recon-12 rebuilds.  All agree: False (periodic).  Only the forward t
    links of row T−1 and the backward t links of row 0 are its negative,
    every one of them: True.  Anything else (a link off SU(3), or
    another phase) raises ``ValueError``: recon-12 would give another
    operator than the links.  One read of the result on the host.

    On a box of the doubled links (``parallel.sharded``): ``t_rows``
    = (the local row of global t = 0, that of global T−1), either
    outside the box where this rank holds neither, and ``allmax`` the
    ring's maximum (``TMesh.allmax``) of the three offsets, so every
    rank reads the whole lattice's boundary from its box alone."""
    if ud.dim() == 7:
        ud = ud[:, None]
    tol = _SU3_TOL.get(ud.dtype)
    if tol is None:
        raise TypeError(f"doubled links of dtype {ud.dtype}: complex64 or "
                        "complex128")
    n_t = ud.shape[-3]
    row_first, row_last = (0, n_t - 1) if t_rows is None else t_rows
    zero = torch.zeros((), dtype=ud.real.dtype, device=ud.device)
    off, plus, minus = [], [zero], [zero]
    for mu in range(4):
        for p in range(ud.shape[1]):
            for fb in (0, 1):
                m = ud[mu, p, fb]
                r2 = _row2(m)
                diff = (m[2] - r2).abs().amax(dim=0)        # [T, Z, W]
                row = row_last if fb == 0 else row_first
                if mu < 3 or not 0 <= row < n_t:
                    off.append(diff.amax())
                    continue
                rest = torch.cat([diff[:row], diff[row + 1:]])
                if rest.numel():
                    off.append(rest.amax())
                plus.append(diff[row].amax())
                minus.append((m[2, :, row] + r2[:, row]).abs().amax())
    offsets = torch.stack([torch.stack(v).amax() for v in (off, plus,
                                                             minus)])
    if allmax is not None:
        offsets = allmax(offsets)
    worst, d_plus, d_minus = (float(v) for v in offsets)
    if worst <= tol and d_plus <= tol:
        return False
    if worst <= tol and d_minus <= tol:
        return True
    raise ValueError(
        f"the gauge is neither periodic nor antiperiodic in t on SU(3) "
        f"links: row 2 differs from conj(r0 × r1) by {worst:.2e} off the "
        f"boundary and by {d_plus:.2e} (periodic) / {d_minus:.2e} "
        f"(antiperiodic) on it, tolerance {tol:.0e}; recon-12 would "
        f"apply another operator")


def clover_channels(clover_field: torch.Tensor, parity: int,
                    dtype: torch.dtype | None = None) -> torch.Tensor:
    """Chiral-block clover (or its inverse) [2p,2ch,6,6,T,Z,W] → channel
    operand [T, 144, Z, W] of one parity (``dtype`` as in
    ``gauge_channels``)."""
    return cast_channels(to_channels(clover_field[parity]), dtype)


def _widen(t):
    """A bf16 operand as float32 (exact), as the kernels load it."""
    return t.to(torch.float32) if t is not None and t.dtype == _BF16 else t


@functools.lru_cache(maxsize=None)
def _proj_rank2(mu: int, plus: bool):
    """Rank-2 structure of 1 ± gamma_mu: the upper rows as (column, coef)
    lists and each lower row as (upper row, phase).  Every phase is one
    of ±1, ±i.  Computed once per (mu, plus): the hops' callers read it
    on every call (do not modify the lists)."""
    P = _g.PROJ[mu, 1 if plus else 0]
    upper = [[(t, complex(P[s, t])) for t in range(4) if abs(P[s, t]) > 1e-12]
             for s in (0, 1)]
    recon = []
    for low in (2, 3):
        hit = None
        for up in (0, 1):
            nz = np.abs(P[up]) > 1e-12
            if np.array_equal(np.abs(P[low]) > 1e-12, nz):
                r = P[low][nz] / P[up][nz]
                if np.allclose(r, r[0]):
                    hit = (up, complex(r[0]))
                    break
        if hit is None:
            raise AssertionError(f"1±gamma_{mu} is not rank 2 ({plus=})")
        recon.append(hit)
    return upper, recon


def _decode_recon8(g_ch: torch.Tensor) -> torch.Tensor:
    """8-real gauge channels [T, 64, Z, W] → complex links [4, 2, 3, 3,
    T, Z, W]: the JAX package's ``_plane_body._mat8``, term for term (it
    divides by |a2|² + |a3|² = 1 − |a1|²)."""
    t, _, z, w = g_ch.shape
    e = g_ch.movedim(1, 0).reshape(4, 2, 8, t, z, w)
    a2r, a2i, a3r, a3i, b1r, b1i, th1, th2 = e.unbind(2)
    n = a2r * a2r + a2i * a2i + a3r * a3r + a3i * a3i
    a1m2 = torch.clamp(1.0 - n, min=0.0)
    a1m = torch.sqrt(a1m2)
    c1m = torch.sqrt(torch.clamp(1.0 - a1m2 - (b1r * b1r + b1i * b1i),
                                 min=0.0))
    a1r, a1i = a1m * torch.cos(th1), a1m * torch.sin(th1)
    c1r, c1i = c1m * torch.cos(th2), c1m * torch.sin(th2)
    rn = 1.0 / n
    tr = a1r * b1r + a1i * b1i              # t = conj(a1) b1
    ti = a1r * b1i - a1i * b1r
    b2r = -(tr * a2r - ti * a2i + (a3r * c1r - a3i * c1i)) * rn
    b2i = -(tr * a2i + ti * a2r - (a3r * c1i + a3i * c1r)) * rn
    b3r = -(tr * a3r - ti * a3i - (a2r * c1r - a2i * c1i)) * rn
    b3i = -(tr * a3i + ti * a3r + (a2r * c1i + a2i * c1r)) * rn
    c2r = (a3r * b1r - a3i * b1i) - (a1r * b3r - a1i * b3i)
    c2i = -((a3r * b1i + a3i * b1r) - (a1r * b3i + a1i * b3r))
    c3r = (a1r * b2r - a1i * b2i) - (a2r * b1r - a2i * b1i)
    c3i = -((a1r * b2i + a1i * b2r) - (a2r * b1i + a2i * b1r))
    rows = [[(a1r, a1i), (a2r, a2i), (a3r, a3i)],
            [(b1r, b1i), (b2r, b2i), (b3r, b3i)],
            [(c1r, c1i), (c2r, c2i), (c3r, c3i)]]
    return torch.stack([torch.stack([torch.complex(re, im) for re, im in r],
                                    dim=2) for r in rows], dim=2)


def _links(g_ch: torch.Tensor, recon12: bool, recon8: bool = False,
           t_boundary=None) -> torch.Tensor:
    """Channel gauge of one parity → complex [4(mu), 2(fb), 3, 3, T, Z, W],
    row 2 rebuilt as conj(r0 × r1) for recon-12, every row decoded for
    recon-8.  ``t_boundary`` (recon-12): the rows (t_first, t_last) of
    global t = 0 and T−1, whose backward / forward t links carry the
    antiperiodic −1 (a row outside the block: none there); None:
    periodic."""
    if recon8:
        return _decode_recon8(g_ch)
    if not recon12:
        return from_channels(g_ch, (4, 2, 3, 3))
    g = from_channels(g_ch, (4, 2, 2, 3))
    r2 = _row2(g.movedim((2, 3), (0, 1)))          # [3, 4, 2, T, Z, W]
    r2 = r2.movedim(0, 2).contiguous()             # [4, 2, 3, T, Z, W]
    if t_boundary is not None:
        for fb, row in ((1, t_boundary[0]), (0, t_boundary[1])):
            if 0 <= row < r2.shape[-3]:
                r2[3, fb, :, row] = -r2[3, fb, :, row]
    return torch.cat([g, r2[:, :, None]], dim=2)


def _g5_rotate(v: torch.Tensor, a: float, b: float) -> torch.Tensor:
    """b (1 + i a γ5) v for a spinor [4, 3, T, Z, W]."""
    g5 = torch.tensor([1.0, 1.0, -1.0, -1.0], dtype=v.real.dtype,
                      device=v.device).reshape(4, 1, 1, 1, 1)
    return b * (v + (1j * a) * g5 * v)


def _project(nb: torch.Tensor, mu: int, plus: bool) -> torch.Tensor:
    """The upper two rows of (1 ± γ_mu) nb for a spinor nb [4, 3, ...]:
    the 2-spinor [2, 3, ...] that the hop multiplies by the link."""
    upper, _ = _proj_rank2(mu, plus)
    return torch.stack([sum(coef * nb[t] for t, coef in upper[s])
                        for s in (0, 1)])


def _hop_plain(psi, u, parity: int, geom: Geometry, dagger: bool,
               t_halves=None, shifted=None) -> torch.Tensor:
    """The rank-2 projected hop of a complex spinor ψ [4, 3, T, Z, W] on
    the links ``u`` [4, 2, 3, 3, T, Z, W] of ``_links``.  ``t_halves``
    gives the projected t neighbours (``_project`` of ψ(x+t̂) and of
    ψ(x−t̂), [2, 3, T, Z, W] each) of a block that does not wrap in t;
    None wraps t periodically.  ``shifted``: {mu: (ψ(x+μ̂), ψ(x−μ̂))}
    for the directions of a box that do not wrap (z, y); the others
    wrap."""
    acc = [None] * 4
    for mu in range(4):
        for fb, (fwd, plus) in enumerate(((True, dagger),
                                          (False, not dagger))):
            if mu == 3 and t_halves is not None:
                h = t_halves[fb]
            elif shifted is not None and mu in shifted:
                h = _project(shifted[mu][fb], mu, plus)
            else:
                h = _project(gather_neighbor(psi, mu, fwd, parity, geom), mu,
                             plus)
            _, recon = _proj_rank2(mu, plus)
            uh = su3_mul(u[mu, 0], h) if fb == 0 else su3_dag_mul(u[mu, 1], h)
            rows = [uh[0], uh[1], recon[0][1] * uh[recon[0][0]],
                    recon[1][1] * uh[recon[1][0]]]
            acc = [r if a is None else a + r for a, r in zip(acc, rows)]
    return torch.stack(acc)


def _epilogues(res, cinv_ch, clover, twist, xpay_coef, x_ch):
    """The chiral clover (or twist), then xpay, on a hop result."""
    if clover is not None:
        res = clover_apply(from_channels(cinv_ch, (2, 6, 6)), res,
                           dagger=clover == "dag")
    if twist is not None:
        res = _g5_rotate(res, *twist)
    if xpay_coef is not None:
        res = from_channels(x_ch, (4, 3)) + xpay_coef * res
    return res


def dslash_ch_reference(g_ch, psi_ch, parity: int, geom: Geometry,
                        dagger: bool = False, recon12: bool = False,
                        twist=None, xpay_coef=None, x_ch=None, clover=None,
                        cinv_ch=None, post_op=None, out_dtype=None,
                        recon8: bool = False, antiperiodic: bool = False):
    """Plain PyTorch version of ``dslash_ch``: channels → complex →
    rank-2 projected hop on the doubled links → epilogues → channels.
    bf16 operands are widened to float32 first, as the kernels (and the
    JAX package's ``_kernel_v5._mk``) widen each load; a bfloat16
    ``out_dtype`` rounds the float32 result once, at the end, as the
    kernels' store does."""
    g_ch, psi_ch, cinv_ch = _widen(g_ch), _widen(psi_ch), _widen(cinv_ch)
    x_ch = _widen(x_ch)
    if out_dtype == _BF16:
        res = dslash_ch_reference(g_ch, psi_ch, parity, geom, dagger,
                                  recon12, twist, xpay_coef, x_ch, clover,
                                  cinv_ch, post_op, recon8=recon8,
                                  antiperiodic=antiperiodic)
        if post_op is None:
            return res.to(_BF16)
        return tuple(r.to(_BF16) for r in res)
    rows = (0, geom.T - 1) if antiperiodic else None
    res = _hop_plain(from_channels(psi_ch, (4, 3)),
                     _links(g_ch, recon12, recon8, rows), parity, geom,
                     dagger)
    res = _epilogues(res, cinv_ch, clover, twist, xpay_coef, x_ch)
    out = to_channels(res)
    if post_op is None:
        return out
    if post_op[0] == "clover":
        res2 = clover_apply(from_channels(cinv_ch, (2, 6, 6)), res,
                            dagger=True)
    else:
        res2 = _g5_rotate(res, post_op[1], post_op[2])
    return out, to_channels(res2)


class _Form(NamedTuple):
    """One kernel instance: its C entry point ``qkx_dslash_ch_<name>``,
    the dtypes of (gauge, clover inverse, ψ, x, out) it takes (None: the
    operand must be absent), whether it takes the bare hop only, the
    gauge forms it is built for (8, 12, 18), the counter on its wrapper
    that its launches add to, and the hop it is an instance of: "k1"
    (``dslash_ch``), "local" (the t-local hop of ``dslash_ch_local``
    and ``dslash_ch_overlap``) or "box" (``dslash_ch_box``, K4 with the
    z and y faces)."""
    name: str
    dtypes: tuple
    bare: bool
    recons: tuple
    counter: str
    kernel: str = "k1"


_FORMS = (
    # K1 (csrc/dslash_ch.cu)
    _Form("f32", (_F32,) * 5, False, (12, 18), "launches"),
    _Form("f64", (_F64,) * 5, False, (12, 18), "launches"),
    # K1d, the bf16 operand tier (csrc/dslash_ch_bf16.cu)
    _Form("f32_g16", (_BF16, _BF16, _F32, _F32, _F32), False, (12, 18),
          "launches_bf16"),
    _Form("f32_g16c32", (_BF16, _F32, _F32, _F32, _F32), False, (12,),
          "launches_bf16"),
    _Form("f32_g16s16", (_BF16, None, _BF16, None, _F32), True, (12, 18),
          "launches_bf16"),
    # K1e, the bf16 spinor storage (csrc/dslash_ch_bf16s.cu)
    _Form("f32_g16c32_o16", (_BF16, _F32, _F32, _F32, _BF16), False, (12,),
          "launches_bf16s"),
    _Form("f32_g16c32_s16o16", (_BF16, _F32, _BF16, _F32, _BF16), False,
          (12,), "launches_bf16s"),
    _Form("f32_g16c32_x16", (_BF16, _F32, _F32, _BF16, _F32), False, (12,),
          "launches_bf16s"),
    _Form("f32_g16c32_s16", (_BF16, _F32, _BF16, _F32, _F32), False, (12,),
          "launches_bf16s"),
    # K3, the recon-8 gauge (csrc/dslash_ch_r8.cu)
    _Form("f32_r8", (_F32,) * 5, False, (8,), "launches_r8"),
    # K4 and K5, the t-local hop of the sharded solve
    # (csrc/dslash_ch_local.cu): the float32 chain, the float64 full
    # operator (bare), the chain in the bf16 operand tier
    _Form("local_f32", (_F32,) * 5, False, (12,), "launches", "local"),
    _Form("local_f64", (_F64,) * 5, True, (12,), "launches", "local"),
    _Form("local_f32_g16", (_BF16, _BF16, _F32, _F32, _F32), False, (12,),
          "launches_bf16", "local"),
    # K4 on a box, with the z and y faces (csrc/dslash_ch_box.cu): the
    # same three
    _Form("box_f32", (_F32,) * 5, False, (12,), "launches", "box"),
    _Form("box_f64", (_F64,) * 5, True, (12,), "launches", "box"),
    _Form("box_f32_g16", (_BF16, _BF16, _F32, _F32, _F32), False, (12,),
          "launches_bf16", "box"),
)
_FORM_BY_NAME = {f.name: f for f in _FORMS}


def _kernel_form(g_ch, psi_ch, cinv_ch, x_ch, bare: bool,
                 out_dtype=None, recon: int = 12, kernel: str = "k1") -> str:
    """The instance of hop ``kernel`` that the operand dtypes,
    ``out_dtype`` (None: float64 for a float64 ψ, else float32) and the
    gauge form ``recon`` select, as the suffix of its C entry point: the
    first entry of ``_FORMS`` for that hop whose dtypes the present
    operands have and that takes this gauge form (and epilogues, for a
    bare-only instance).  Raises on any other mix: no operand is ever
    upcast to reach a kernel."""
    if out_dtype is None:
        out_dtype = _F64 if psi_ch.dtype == _F64 else _F32
    have = (g_ch.dtype, None if cinv_ch is None else cinv_ch.dtype,
            psi_ch.dtype, None if x_ch is None else x_ch.dtype, out_dtype)
    forms = [f for f in _FORMS if f.kernel == kernel]
    for form in forms:
        if recon not in form.recons or (form.bare and not bare):
            continue
        if all(h is None or h == w for h, w in zip(have, form.dtypes)):
            return form.name
    names = ("g_ch", "cinv_ch", "psi_ch", "x_ch", "out_dtype")
    mix = ", ".join(f"{n} {h}" for n, h in zip(names, have) if h is not None)
    raise TypeError(f"no kernel takes {mix} with recon-{recon}"
                    f"{'' if bare else ' and epilogues'}; the forms are "
                    f"{[f.name for f in forms]}")


def _check_operands(g_ch, psi_ch, geom, recon12, twist, xpay_coef, x_ch,
                    clover, cinv_ch, post_op, out_dtype=None,
                    recon8: bool = False, kernel: str = "k1",
                    antiperiodic: bool = False) -> str:
    """Raise on anything the kernel (and its plain version) does not take;
    returns the kernel form (``_kernel_form``)."""
    shape = (geom.T, 24, geom.Z, geom.W)
    if tuple(psi_ch.shape) != shape:
        raise ValueError(f"psi_ch shape {tuple(psi_ch.shape)} != {shape}")
    if recon8 and recon12:
        raise ValueError("recon8 and recon12 are two gauge forms: pick one")
    if recon8 and antiperiodic:
        raise ValueError("recon-8 assumes SU(3) links: it has no form for "
                         "the antiperiodic t boundary's −1")
    recon = 8 if recon8 else (12 if recon12 else 18)
    ng = {8: 64, 12: 96, 18: 144}[recon]
    want = {"g_ch": (g_ch, (geom.T, ng, geom.Z, geom.W))}
    if clover not in _CLOVER_MODES:
        raise ValueError(f"clover={clover!r} not one of None, 'fwd', 'dag'")
    if twist is not None and clover is not None:
        raise ValueError("twist and clover epilogues are mutually exclusive")
    if clover is not None:
        if cinv_ch is None:
            raise ValueError("clover epilogue needs cinv_ch")
        want["cinv_ch"] = (cinv_ch, (geom.T, 144, geom.Z, geom.W))
    if (xpay_coef is None) != (x_ch is None):
        raise ValueError("xpay_coef and x_ch go together")
    if x_ch is not None:
        want["x_ch"] = (x_ch, shape)
    if post_op is not None:
        if post_op == ("clover",):
            if clover is None:
                raise ValueError("post_op ('clover',) needs the clover "
                                 "epilogue's cinv_ch")
        elif not (len(post_op) == 3 and post_op[0] == "twist"):
            raise ValueError(f"post_op={post_op!r} not ('clover',) or "
                             "('twist', a, b)")
    form = _kernel_form(
        g_ch, psi_ch, None if clover is None else cinv_ch, x_ch,
        bare=twist is None and clover is None and x_ch is None
        and post_op is None, out_dtype=out_dtype, recon=recon,
        kernel=kernel)
    tensors = {"psi_ch": psi_ch, **{k: v[0] for k, v in want.items()}}
    for name, (t, shp) in want.items():
        if tuple(t.shape) != shp:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {shp}")
    for name, t in tensors.items():
        if t.device != psi_ch.device:
            raise ValueError(f"{name} on {t.device}, psi_ch on "
                             f"{psi_ch.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    return form


def _post_args(post_op):
    """The kernels' (post, pa, pb) for a ``post_op``: 0 none, 1 A⁻¹† of
    the result, 2 the twist (a, b) of the result."""
    post = {None: 0, "clover": 1, "twist": 2}[
        None if post_op is None else post_op[0]]
    pa, pb = (post_op[1], post_op[2]) if post == 2 else (0.0, 0.0)
    return post, pa, pb


def _parity_arg(parity: int, antiperiodic: bool) -> int:
    """The kernels' parity argument: the output parity, with the bit
    ``_ANTIPERIODIC_T`` for a gauge with the antiperiodic t boundary."""
    return parity | (_ANTIPERIODIC_T if antiperiodic else 0)


def _launch(lib, form: str, g_ch, psi_ch, out, out2, parity: int,
            geom: Geometry, dagger, recon12, twist, xpay_coef, x_ch, clover,
            cinv_ch, post_op, stream: int, antiperiodic: bool = False) -> int:
    """Call the C entry point ``qkx_dslash_ch_<form>`` of the kernel;
    returns its CUDA error code."""
    fn = getattr(lib, f"qkx_dslash_ch_{form}")
    ptr = lambda t: None if t is None else t.data_ptr()
    ta, tb = twist if twist is not None else (0.0, 0.0)
    post, pa, pb = _post_args(post_op)
    return fn(ptr(psi_ch), ptr(g_ch), ptr(cinv_ch), ptr(x_ch), ptr(out),
              ptr(out2), geom.T, geom.Z, geom.W, geom.Xh,
              _parity_arg(parity, antiperiodic),
              int(dagger), int(recon12), int(twist is not None), ta, tb,
              _CLOVER_MODES[clover], int(xpay_coef is not None),
              0.0 if xpay_coef is None else xpay_coef, post, pa, pb,
              ctypes.c_void_p(stream))


def dslash_ch(g_ch, psi_ch, parity: int, geom: Geometry, dagger: bool = False,
              recon12: bool = False, twist=None, xpay_coef=None, x_ch=None,
              clover=None, cinv_ch=None, post_op=None, out_dtype=None,
              recon8: bool = False, antiperiodic: bool = False):
    """Fused Wilson hop with epilogues on channel operands (module
    docstring).  Returns ``out`` or, with ``post_op``, ``(out, out2)``,
    in ``out_dtype``: None for the arithmetic's dtype (float64 for a
    float64 ψ, else float32), or bfloat16 for the bf16 spinor storage.
    ``antiperiodic``: the gauge carries the antiperiodic t boundary
    (``antiperiodic_t``; recon-8 refuses it).

    A CUDA ``psi_ch`` launches the CUDA kernel that the operand dtypes
    select on the current stream (``_kernel_form``), and the launch adds
    one to that kernel's counter: ``dslash_ch.launches`` (K1, float32 and
    float64), ``.launches_bf16`` (K1d), ``.launches_bf16s`` (K1e) or
    ``.launches_r8`` (K3).  A CPU ``psi_ch`` runs ``dslash_ch_reference``.
    Anything else raises."""
    form = _check_operands(g_ch, psi_ch, geom, recon12, twist, xpay_coef,
                           x_ch, clover, cinv_ch, post_op, out_dtype,
                           recon8, antiperiodic=antiperiodic)
    if psi_ch.device.type == "cpu":
        return dslash_ch_reference(g_ch, psi_ch, parity, geom, dagger,
                                   recon12, twist, xpay_coef, x_ch, clover,
                                   cinv_ch, post_op, out_dtype, recon8,
                                   antiperiodic)
    if psi_ch.device.type != "cuda":
        raise ValueError(f"no dslash_ch for device {psi_ch.device}")
    from quda_qkxtm_multigrid_tpu_torch import _build
    lib = _build.load_library()
    out = torch.empty(psi_ch.shape, dtype=_FORM_BY_NAME[form].dtypes[4],
                      device=psi_ch.device)
    out2 = torch.empty_like(out) if post_op is not None else None
    stream = torch.cuda.current_stream(psi_ch.device).cuda_stream
    with torch.cuda.device(psi_ch.device):
        err = _launch(lib, form, g_ch, psi_ch, out, out2, parity, geom,
                      dagger, recon12, twist, xpay_coef, x_ch, clover,
                      cinv_ch, post_op, stream, antiperiodic)
    if err != 0:
        raise RuntimeError(f"dslash_ch kernel launch failed "
                           f"(qkx_dslash_ch_{form}): CUDA error {err}")
    counter = _FORM_BY_NAME[form].counter
    setattr(dslash_ch, counter, getattr(dslash_ch, counter) + 1)
    return out if out2 is None else (out, out2)


dslash_ch.launches = 0
dslash_ch.launches_bf16 = 0
dslash_ch.launches_bf16s = 0
dslash_ch.launches_r8 = 0


def dslash_parity_kernel(ud, psi_opp, parity: int, geom: Geometry,
                         dagger: bool = False, recon12: bool = True):
    """``dslash_parity`` through ``dslash_ch``: complex [4,3,T,Z,W] →
    channels → hop → complex, in the precision of ``psi_opp`` (the
    double kernel for complex128)."""
    psi_ch = to_channels(psi_opp)
    g_ch = gauge_channels(ud, parity, recon12, psi_ch.dtype)
    out = dslash_ch(g_ch, psi_ch, parity, geom, dagger, recon12=recon12)
    return from_channels(out, (4, 3))


def dslash_ch_msrc_reference(g_ch, psi_ch_b, parity: int, geom: Geometry,
                             dagger: bool = False, recon12: bool = False,
                             twist=None, xpay_coef=None, x_ch=None,
                             clover=None, cinv_ch=None, post_op=None,
                             antiperiodic: bool = False):
    """Plain PyTorch version of ``dslash_ch_msrc``: ``dslash_ch_reference``
    on each source (bf16 operands widened to float32)."""
    outs = [dslash_ch_reference(g_ch, psi_ch_b[i], parity, geom, dagger,
                                recon12, twist, xpay_coef,
                                None if x_ch is None else x_ch[i], clover,
                                cinv_ch, post_op, antiperiodic=antiperiodic)
            for i in range(psi_ch_b.shape[0])]
    if post_op is None:
        return torch.stack(outs)
    return tuple(torch.stack(o) for o in zip(*outs))


def _check_msrc_operands(g_ch, psi_ch_b, geom, recon12, twist, xpay_coef,
                         x_ch, clover, cinv_ch, post_op=None) -> str:
    """Raise on anything the multi-source kernel does not take; returns
    the kernel form, "f32" or "f32_g16" (bf16 gauge and clover
    inverse)."""
    if psi_ch_b.dim() != 5 or psi_ch_b.shape[0] < 1:
        raise ValueError(f"psi_ch_b shape {tuple(psi_ch_b.shape)} is not "
                         "[n, T, 24, Z, W]")
    if psi_ch_b.dtype != torch.float32:
        raise TypeError(f"psi_ch_b dtype {psi_ch_b.dtype}: the multi-source "
                        "kernel's spinors are float32 only")
    if not psi_ch_b.is_contiguous():
        raise ValueError("psi_ch_b is not contiguous")
    if x_ch is not None:
        if tuple(x_ch.shape) != tuple(psi_ch_b.shape):
            raise ValueError(f"x_ch shape {tuple(x_ch.shape)} != "
                             f"{tuple(psi_ch_b.shape)}")
        if not x_ch.is_contiguous():
            raise ValueError("x_ch is not contiguous")
    form = _check_operands(g_ch, psi_ch_b[0], geom, recon12, twist,
                           xpay_coef, None if x_ch is None else x_ch[0],
                           clover, cinv_ch, post_op)
    if form not in ("f32", "f32_g16"):
        raise TypeError(f"the multi-source kernel has no {form} instance: "
                        "float32 operands, or a bf16 gauge and clover "
                        "inverse")
    return form


def dslash_ch_msrc(g_ch, psi_ch_b, parity: int, geom: Geometry,
                   dagger: bool = False, recon12: bool = False, twist=None,
                   xpay_coef=None, x_ch=None, clover=None, cinv_ch=None,
                   post_op=None, antiperiodic: bool = False):
    """Fused Wilson hop with epilogues over a batch of sources
    ψ [n, T, 24, Z, W] float32 (module docstring), ``post_op`` as in
    ``dslash_ch``: returns ``out`` or ``(out, out2)``, [n, T, 24, Z, W]
    each.

    A CUDA ``psi_ch_b`` launches the multi-source CUDA kernel once on
    the current stream, K2 or, with bf16 gauge and clover inverse, K2d
    (``dslash_ch_msrc.launches`` and ``dslash_ch_msrc.launches_bf16``
    count the launches); a CPU ``psi_ch_b`` runs
    ``dslash_ch_msrc_reference``.  Anything else raises.
    ``antiperiodic`` as in ``dslash_ch``."""
    form = _check_msrc_operands(g_ch, psi_ch_b, geom, recon12, twist,
                                xpay_coef, x_ch, clover, cinv_ch, post_op)
    if psi_ch_b.device.type == "cpu":
        return dslash_ch_msrc_reference(g_ch, psi_ch_b, parity, geom, dagger,
                                        recon12, twist, xpay_coef, x_ch,
                                        clover, cinv_ch, post_op,
                                        antiperiodic)
    if psi_ch_b.device.type != "cuda":
        raise ValueError(f"no dslash_ch_msrc for device {psi_ch_b.device}")
    from quda_qkxtm_multigrid_tpu_torch import _build
    lib = _build.load_library()
    out = torch.empty_like(psi_ch_b)
    out2 = torch.empty_like(out) if post_op is not None else None
    ptr = lambda t: None if t is None else t.data_ptr()
    ta, tb = twist if twist is not None else (0.0, 0.0)
    post, pa, pb = _post_args(post_op)
    stream = torch.cuda.current_stream(psi_ch_b.device).cuda_stream
    with torch.cuda.device(psi_ch_b.device):
        err = getattr(lib, f"qkx_dslash_ch_msrc_{form}")(
            ptr(psi_ch_b), ptr(g_ch), ptr(cinv_ch), ptr(x_ch), ptr(out),
            ptr(out2), psi_ch_b.shape[0], geom.T, geom.Z, geom.W, geom.Xh,
            _parity_arg(parity, antiperiodic), int(dagger), int(recon12),
            int(twist is not None), ta,
            tb, _CLOVER_MODES[clover], int(xpay_coef is not None),
            0.0 if xpay_coef is None else xpay_coef, post, pa, pb,
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"dslash_ch_msrc kernel launch failed "
                           f"(qkx_dslash_ch_msrc_{form}): CUDA error {err}")
    if form == "f32_g16":
        dslash_ch_msrc.launches_bf16 += 1
    else:
        dslash_ch_msrc.launches += 1
    return out if out2 is None else (out, out2)


dslash_ch_msrc.launches = 0
dslash_ch_msrc.launches_bf16 = 0


# ---- the t-local hop of the t-sharded solve (K4, K5) ----------------------

def _t_halves(fwd_rows, bwd_rows, dagger: bool):
    """The projected t neighbours of a block for ``_hop_plain``: from the
    complex spinors ψ(x+t̂) and ψ(x−t̂) [4, 3, T, Z, W] of its rows."""
    return _project(fwd_rows, 3, dagger), _project(bwd_rows, 3, not dagger)


def dslash_ch_local_reference(g_ch, psi_ch, face_m, face_p, parity: int,
                              geom_local: Geometry, dagger: bool = False,
                              recon12: bool = False, twist=None,
                              xpay_coef=None, x_ch=None, clover=None,
                              cinv_ch=None, faces_projected: bool = False,
                              t_boundary=None, zw_faces=None):
    """Plain PyTorch version of ``dslash_ch_local`` and, with the same
    arguments, of ``dslash_ch_overlap``: the hop of the local rows ψ
    [T, 24, Z, W], whose t−1 neighbour of row 0 is ``face_m`` and t+1
    neighbour of row T−1 is ``face_p`` ([1, 24, Z, W], or the projected
    2-spinors [1, 12, Z, W] of ``halo.project_face`` with
    ``faces_projected``), no wrap in t; then the epilogues, x
    [T, 24, Z, W].  bf16 operands are widened to float32.
    ``t_boundary`` and ``zw_faces`` as in ``dslash_ch_local``: z and y
    do not wrap where their faces are given."""
    g_ch, psi_ch, cinv_ch = _widen(g_ch), _widen(psi_ch), _widen(cinv_ch)
    psi = from_channels(psi_ch, (4, 3))
    shifted = {}
    zm, zp, wm, wp = (None,) * 4 if zw_faces is None else (
        None if f is None else from_channels(_widen(f), (4, 3))
        for f in zw_faces)
    if zm is not None:
        shifted[2] = (torch.cat([psi[..., 1:, :], zp], dim=-2),
                      torch.cat([zm, psi[..., :-1, :]], dim=-2))
    if wm is not None:
        xh = geom_local.Xh
        shifted[1] = (torch.cat([psi[..., xh:], wp], dim=-1),
                      torch.cat([wm, psi[..., :-xh]], dim=-1))

    def face(f, plus):
        if faces_projected:
            return from_channels(f, (2, 3))
        return _project(from_channels(f, (4, 3)), 3, plus)
    up, down = _t_halves(psi[:, :, 1:], psi[:, :, :-1], dagger)
    halves = (torch.cat([up, face(face_p, dagger)], dim=2),
              torch.cat([face(face_m, not dagger), down], dim=2))
    res = _hop_plain(psi, _links(g_ch, recon12, t_boundary=t_boundary),
                     parity, geom_local, dagger, halves, shifted or None)
    return to_channels(_epilogues(res, cinv_ch, clover, twist, xpay_coef,
                                  _widen(x_ch)))


def _launch_local(lib, form: str, g_ch, psi_ch, out, face_m, face_p,
                  face_ch: int, rows, parity: int, geom: Geometry, dagger,
                  twist, xpay_coef, x_ch, clover, cinv_ch, t_boundary,
                  stream: int) -> int:
    """Call the C entry point ``qkx_dslash_ch_<form>`` of the t-local hop
    for the output ``rows`` = (t0, tstep, nrows), the faces of
    ``face_ch`` channels (both None: no output row may read one) and
    ``t_boundary`` as in ``dslash_ch_local``.  Returns its CUDA error
    code."""
    fn = getattr(lib, f"qkx_dslash_ch_{form}")
    ptr = lambda t: None if t is None else t.data_ptr()
    ta, tb = twist if twist is not None else (0.0, 0.0)
    t0, tstep, nrows = rows
    # periodic: rows no launch has, and the bit clear
    t_first, t_last = (-1, -1) if t_boundary is None else t_boundary
    return fn(ptr(psi_ch), ptr(g_ch), ptr(cinv_ch), ptr(x_ch), ptr(out),
              ptr(face_m), ptr(face_p), face_ch, geom.T, geom.Z, geom.W,
              geom.Xh, _parity_arg(parity, t_boundary is not None), t0,
              tstep, nrows, t_first, t_last, int(dagger), 1,
              int(twist is not None), ta, tb, _CLOVER_MODES[clover],
              int(xpay_coef is not None),
              0.0 if xpay_coef is None else xpay_coef,
              ctypes.c_void_p(stream))


def _k4_launches(g_ch, psi_ch, face_m, face_p, parity, geom, dagger, twist,
                 xpay_coef, x_ch, clover, cinv_ch):
    """K4's one launch (keywords of ``_launch_local``): every row, the
    24-channel faces read in place."""
    return [dict(g_ch=g_ch, psi_ch=psi_ch, face_m=face_m, face_p=face_p,
                 face_ch=24, rows=(0, 1, geom.T), parity=parity, geom=geom,
                 dagger=dagger, twist=twist, xpay_coef=xpay_coef, x_ch=x_ch,
                 clover=clover, cinv_ch=cinv_ch)]


def _k5_launches(g_ch, psi_ch, face_m, face_p, parity, geom, dagger, twist,
                 xpay_coef, x_ch, clover, cinv_ch, faces_projected):
    """K5's two launches: the interior rows 1..T−2 without faces, then
    the edge rows 0 and T−1 with them."""
    common = dict(g_ch=g_ch, psi_ch=psi_ch, parity=parity, geom=geom,
                  dagger=dagger, twist=twist, xpay_coef=xpay_coef, x_ch=x_ch,
                  clover=clover, cinv_ch=cinv_ch)
    return [dict(common, face_m=None, face_p=None, face_ch=24,
                 rows=(1, 1, geom.T - 2)),
            dict(common, face_m=face_m, face_p=face_p,
                 face_ch=12 if faces_projected else 24,
                 rows=(0, geom.T - 1, 2))]


def _run_launches(lib, form: str, out, launches, wait, stream: int,
                  name: str, t_boundary=None):
    """Make ``launches`` (keyword sets of ``_launch_local``) in order,
    calling ``wait`` (if given) after the first; raise on a CUDA
    error."""
    for i, kw in enumerate(launches):
        err = _launch_local(lib, form, out=out, stream=stream,
                            t_boundary=t_boundary, **kw)
        if err != 0:
            raise RuntimeError(f"{name} kernel launch failed "
                               f"(qkx_dslash_ch_{form}): CUDA error {err}")
        if i == 0 and wait is not None:
            wait()


def _run_local(wrapper, form, psi_ch, out, launches, wait=None,
               t_boundary=None):
    """``_run_launches`` on ``psi_ch``'s card and current stream; each
    launch adds one to ``wrapper``'s counter."""
    from quda_qkxtm_multigrid_tpu_torch import _build
    lib = _build.load_library()
    stream = torch.cuda.current_stream(psi_ch.device).cuda_stream
    with torch.cuda.device(psi_ch.device):
        _run_launches(lib, form, out, launches, wait, stream,
                      wrapper.__name__, t_boundary)
    counter = _FORM_BY_NAME[form].counter
    setattr(wrapper, counter, getattr(wrapper, counter) + len(launches))


def _device_check(name: str, psi_ch):
    if psi_ch.device.type != "cuda":
        raise ValueError(f"no {name} for device {psi_ch.device}")


def _check_faces(face_m, face_p, psi_ch, faces_projected: bool):
    ch = 12 if faces_projected else 24
    shape = (1, ch) + tuple(psi_ch.shape[2:])
    for name, f in (("face_m", face_m), ("face_p", face_p)):
        if tuple(f.shape) != shape:
            raise ValueError(f"{name} shape {tuple(f.shape)} != {shape}")
        if f.dtype != psi_ch.dtype or f.device != psi_ch.device:
            raise ValueError(f"{name} is {f.dtype} on {f.device}: the faces "
                             f"are in ψ's storage, {psi_ch.dtype} on "
                             f"{psi_ch.device}")
        if not f.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


def _check_zw_faces(zw_faces, psi_ch, geom: Geometry):
    """Raise unless ``zw_faces`` = (z−1, z+1, y−1, y+1) faces holds a
    pair for z or y (or both), each [T, 24, 1, W] or [T, 24, Z, Xh] in
    ψ's storage, both of a pair or neither."""
    if len(zw_faces) != 4:
        raise ValueError("zw_faces is (face_zm, face_zp, face_wm, face_wp)")
    shapes = ((geom.T, 24, 1, geom.W), (geom.T, 24, geom.Z, geom.Xh))
    for k, shape in enumerate(shapes):
        pair = zw_faces[2 * k:2 * k + 2]
        if (pair[0] is None) != (pair[1] is None):
            raise ValueError(f"the {'zy'[k]} faces go together")
        for f in pair:
            if f is None:
                continue
            if tuple(f.shape) != shape:
                raise ValueError(f"a {'zy'[k]} face has shape "
                                 f"{tuple(f.shape)}, not {shape}")
            if f.dtype != psi_ch.dtype or f.device != psi_ch.device:
                raise ValueError(f"a {'zy'[k]} face is {f.dtype} on "
                                 f"{f.device}: the faces are in ψ's "
                                 f"storage, {psi_ch.dtype} on "
                                 f"{psi_ch.device}")
            if not f.is_contiguous():
                raise ValueError(f"a {'zy'[k]} face is not contiguous")
    if all(f is None for f in zw_faces):
        raise ValueError("zw_faces holds no face: the t-local hop takes "
                         "zw_faces=None")


def _launch_box(lib, form: str, g_ch, psi_ch, out, face_m, face_p, zw_faces,
                parity: int, geom: Geometry, dagger, twist, xpay_coef, x_ch,
                clover, cinv_ch, t_boundary, stream: int) -> int:
    """Call the C entry point ``qkx_dslash_ch_<form>`` of K4 on a box
    (every row; the t faces and the z / y faces of ``zw_faces``, None
    for an axis that wraps).  Returns its CUDA error code."""
    fn = getattr(lib, f"qkx_dslash_ch_{form}")
    ptr = lambda t: None if t is None else t.data_ptr()
    ta, tb = twist if twist is not None else (0.0, 0.0)
    t_first, t_last = (-1, -1) if t_boundary is None else t_boundary
    return fn(ptr(psi_ch), ptr(g_ch), ptr(cinv_ch), ptr(x_ch), ptr(out),
              ptr(face_m), ptr(face_p), *(ptr(f) for f in zw_faces),
              geom.T, geom.Z, geom.W, geom.Xh,
              _parity_arg(parity, t_boundary is not None), t_first, t_last,
              int(dagger), 1, int(twist is not None), ta, tb,
              _CLOVER_MODES[clover], int(xpay_coef is not None),
              0.0 if xpay_coef is None else xpay_coef,
              ctypes.c_void_p(stream))


def dslash_ch_local(g_ch, psi_ch, face_m, face_p, parity: int,
                    geom_local: Geometry, dagger: bool = False,
                    recon12: bool = False, twist=None, xpay_coef=None,
                    x_ch=None, clover=None, cinv_ch=None, t_boundary=None,
                    zw_faces=None):
    """K4: the fused hop with epilogues on the local rows ψ
    [T, 24, Z, W] of a t-slab, whose t−1 neighbour of row 0 is
    ``face_m`` and t+1 neighbour of row T−1 is ``face_p`` ([1, 24, Z, W]
    each, in ψ's dtype: the planes of the t−1 and t+1 ranks), out and x
    [T, 24, Z, W]; gauge and clover inverse [T, C, Z, W] of the slab.
    Recon-12, no second output; the slab's origin must be even (T even),
    so the checkerboard phase is the global one.  ``t_boundary``: None
    for a periodic gauge; for one with the antiperiodic t boundary
    (``antiperiodic_t`` of the whole lattice's links), the local rows
    (t_first, t_last) of global t = 0 and T−1, which may lie outside the
    slab (``sharded.ShardedDirac`` gives them).  ``zw_faces``: the box of
    a grid that splits z or y, whose hop is ``dslash_ch_box``'s.

    A CUDA ψ makes one launch of ``csrc/dslash_ch_local.cu`` over every
    row, the faces read where they lie (the instance from ``_FORMS``:
    float32, float64 bare, or the bf16 operand tier), adding one to
    ``dslash_ch_local.launches`` or ``.launches_bf16``; a CPU ψ runs
    ``dslash_ch_local_reference``.  Anything else raises."""
    if zw_faces is not None:
        return dslash_ch_box(g_ch, psi_ch, face_m, face_p, zw_faces, parity,
                             geom_local, dagger, recon12, twist, xpay_coef,
                             x_ch, clover, cinv_ch, t_boundary)
    form = _check_operands(g_ch, psi_ch, geom_local, recon12, twist,
                           xpay_coef, x_ch, clover, cinv_ch, None,
                           kernel="local")
    _check_faces(face_m, face_p, psi_ch, False)
    if psi_ch.device.type == "cpu":
        return dslash_ch_local_reference(g_ch, psi_ch, face_m, face_p,
                                         parity, geom_local, dagger, recon12,
                                         twist, xpay_coef, x_ch, clover,
                                         cinv_ch, t_boundary=t_boundary)
    _device_check("dslash_ch_local", psi_ch)
    out = torch.empty(psi_ch.shape, dtype=_FORM_BY_NAME[form].dtypes[4],
                      device=psi_ch.device)
    _run_local(dslash_ch_local, form, psi_ch, out, _k4_launches(
        g_ch, psi_ch, face_m, face_p, parity, geom_local, dagger, twist,
        xpay_coef, x_ch, clover, cinv_ch), t_boundary=t_boundary)
    return out


def dslash_ch_box(g_ch, psi_ch, face_m, face_p, zw_faces, parity: int,
                  geom_local: Geometry, dagger: bool = False,
                  recon12: bool = False, twist=None, xpay_coef=None,
                  x_ch=None, clover=None, cinv_ch=None, t_boundary=None):
    """K4 on a box of a grid that splits z or y: ``dslash_ch_local``'s
    hop and arguments on the box ψ [T, 24, Z, W], with its t faces, and
    ``zw_faces`` = (z−1, z+1, y−1, y+1) from ``parallel.halo.box_faces``:
    the neighbours' z planes [T, 24, 1, W] of row z = 0 and z = Z−1, and
    their y rows [T, 24, Z, Xh] of y = 0 and y = Y−1 (entries k of the
    merged axis), None for an axis that wraps inside the box.

    A CUDA ψ makes one launch of ``csrc/dslash_ch_box.cu``'s instance for
    the split axes (``_FORMS``: float32, float64 bare, or the bf16
    operand tier), adding one to ``dslash_ch_box.launches`` or
    ``.launches_bf16``; a CPU ψ runs ``dslash_ch_local_reference``.
    Anything else raises."""
    form = _check_operands(g_ch, psi_ch, geom_local, recon12, twist,
                           xpay_coef, x_ch, clover, cinv_ch, None,
                           kernel="box")
    _check_faces(face_m, face_p, psi_ch, False)
    _check_zw_faces(zw_faces, psi_ch, geom_local)
    if psi_ch.device.type == "cpu":
        return dslash_ch_local_reference(g_ch, psi_ch, face_m, face_p,
                                         parity, geom_local, dagger, recon12,
                                         twist, xpay_coef, x_ch, clover,
                                         cinv_ch, t_boundary=t_boundary,
                                         zw_faces=zw_faces)
    _device_check("dslash_ch_box", psi_ch)
    from quda_qkxtm_multigrid_tpu_torch import _build
    lib = _build.load_library()
    out = torch.empty(psi_ch.shape, dtype=_FORM_BY_NAME[form].dtypes[4],
                      device=psi_ch.device)
    stream = torch.cuda.current_stream(psi_ch.device).cuda_stream
    with torch.cuda.device(psi_ch.device):
        err = _launch_box(lib, form, g_ch, psi_ch, out, face_m, face_p,
                          zw_faces, parity, geom_local, dagger, twist,
                          xpay_coef, x_ch, clover, cinv_ch, t_boundary,
                          stream)
    if err != 0:
        raise RuntimeError(f"dslash_ch_box kernel launch failed "
                           f"(qkx_dslash_ch_{form}): CUDA error {err}")
    counter = _FORM_BY_NAME[form].counter
    setattr(dslash_ch_box, counter, getattr(dslash_ch_box, counter) + 1)
    return out


dslash_ch_box.launches = 0
dslash_ch_box.launches_bf16 = 0


dslash_ch_local.launches = 0
dslash_ch_local.launches_bf16 = 0


def dslash_ch_overlap(g_ch, psi_ch, face_m, face_p, parity: int,
                      geom_local: Geometry, dagger: bool = False,
                      recon12: bool = False, twist=None, xpay_coef=None,
                      x_ch=None, clover=None, cinv_ch=None,
                      faces_projected: bool = False, wait=None,
                      t_boundary=None):
    """K5: the t-local hop split into interior and edges, on the local
    rows ψ [T, 24, Z, W], x [T, 24, Z, W], with the t−1 neighbour plane
    of row 0 ``face_m`` and the t+1 neighbour plane of row T−1
    ``face_p``: [1, 24, Z, W], or [1, 12, Z, W] spin-projected by the
    sender (``faces_projected``, ``halo.project_face``), in ψ's dtype.

    On a CUDA ψ one launch covers the interior rows 1..T−2, which need
    no face; then ``wait`` (if given: the halo exchange's, so that the
    faces are in flight during the interior launch) runs; then one launch
    covers the two edge rows.  Each launch adds one to
    ``dslash_ch_overlap.launches`` (``.launches_bf16`` in the bf16 operand
    tier).  A CPU ψ waits, then runs ``dslash_ch_local_reference``.
    For T ≤ 2 there is no interior: the faces must be unprojected, and
    K4 runs (``dslash_ch_local``).  ``t_boundary`` as there."""
    t = geom_local.T
    if t <= 2:
        if faces_projected:
            raise ValueError("projected faces need T_loc > 2 (no "
                             "interior/edge split at T_loc <= 2)")
        if wait is not None:
            wait()
        return dslash_ch_local(g_ch, psi_ch, face_m, face_p, parity,
                               geom_local, dagger, recon12, twist,
                               xpay_coef, x_ch, clover, cinv_ch, t_boundary)
    form = _check_operands(g_ch, psi_ch, geom_local, recon12, twist,
                           xpay_coef, x_ch, clover, cinv_ch, None,
                           kernel="local")
    _check_faces(face_m, face_p, psi_ch, faces_projected)
    if psi_ch.device.type == "cpu":
        if wait is not None:
            wait()
        return dslash_ch_local_reference(
            g_ch, psi_ch, face_m, face_p, parity, geom_local, dagger,
            recon12, twist, xpay_coef, x_ch, clover, cinv_ch,
            faces_projected, t_boundary)
    _device_check("dslash_ch_overlap", psi_ch)
    out = torch.empty(psi_ch.shape, dtype=_FORM_BY_NAME[form].dtypes[4],
                      device=psi_ch.device)
    _run_local(dslash_ch_overlap, form, psi_ch, out, _k5_launches(
        g_ch, psi_ch, face_m, face_p, parity, geom_local, dagger, twist,
        xpay_coef, x_ch, clover, cinv_ch, faces_projected), wait,
        t_boundary)
    return out


dslash_ch_overlap.launches = 0
dslash_ch_overlap.launches_bf16 = 0
