"""Dirac operator layer: fields and parameters bundled in one module.

A `Dirac` holds the gauge (and clover) fields as registered buffers, so
``.to(device)`` moves the whole bundle, and exposes:
  m / mdag / mdagm               — the full even+odd operator
  matpc / matpc_dagm             — the even-odd (Schur) preconditioned op
  prepare / reconstruct          — source preparation, solution rebuild

Operator kinds (kappa normalisation):
  wilson:          M = ψ − κ D ψ
  twisted-mass:    M = (1 + i 2κμ f γ5) ψ − κ D ψ
  clover:          M = A ψ − κ D ψ
  twisted-clover:  M = (A + i 2κμ f γ5) ψ − κ D ψ

Even-odd preconditioning (parity p = solve parity):
  symmetric:   M_pc = 1 − κ² A_p⁻¹ D_{p,1-p} A_{1-p}⁻¹ D_{1-p,p}
  asymmetric:  M_pc = A_p − κ² D_{p,1-p} A_{1-p}⁻¹ D_{1-p,p}
  prepare:     src = [A_p⁻¹](b_p + κ D_{p,1-p} A_{1-p}⁻¹ b_{1-p})
  reconstruct: x_{1-p} = A_{1-p}⁻¹ (b_{1-p} + κ D_{1-p,p} x_p)

With ``use_kernels`` every hop goes through ``ops.dslash_kernel.dslash_ch``
(the CUDA kernel on a CUDA tensor), and the symmetric twisted / clover
Schur operators run as chains of fused hops on planar-channel fields
[T, 24, Z, W] (the ``_..._ch`` methods).  The channel chain computes in
the precision of the field it is given.

The fused chain reads the gauge in recon-12 form, which loses the −1
that the antiperiodic t boundary puts on the last t row's links
(``ops.gauge.apply_t_boundary``): ``_operands`` reads the boundary from
the doubled links (``ops.dslash_kernel.antiperiodic_t``, which raises on
a gauge that is neither periodic nor antiperiodic) and every recon-12
hop restores the sign, so the fused operator is the plain one.

``DiracNdeg`` is the non-degenerate twisted-mass doublet (the ε τ1
coupling of two flavours): its hop is flavour-diagonal, and with
``use_kernels`` both flavours of a complex64 doublet go through one
multi-source launch (``dslash_ch_msrc`` at n = 2, bare: the gauge read
once for both), a complex128 one through the double ``dslash_ch`` once a
flavour; the flavour-mixing A⁻¹ runs in PyTorch between the hops
(``ops.twist.ndeg_twist_apply_ch``).

``kernel_bf16`` is the bf16 operand tier (the JAX package's
``pallas_bf16``, "the 'half' analogue"): the chain reads bfloat16 gauge
and clover-inverse channels and keeps float32 spinors, and ``dslash``
also rounds ψ to bfloat16.  ``as_sloppy`` makes such an operator over
the same fields: the sloppy operator of the mixed-precision solvers.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry
from quda_qkxtm_multigrid_tpu_torch.ops import clover as _cl
from quda_qkxtm_multigrid_tpu_torch.ops import dslash as _dsl
from quda_qkxtm_multigrid_tpu_torch.ops import twist as _twist
from quda_qkxtm_multigrid_tpu_torch.ops.dslash_kernel import (
    antiperiodic_t, cast_channels, clover_channels, dslash_ch,
    dslash_ch_msrc, from_channels, gauge_channels, to_channels)


def _ch_clover_matrix(cinv_ch: torch.Tensor,
                      dtype: torch.dtype) -> torch.Tensor:
    """The chiral-block 6×6 matrices of a channel operand [T, 144, Z, W]
    as a complex field [T, 2, 6, 6, Z, W] of the real ``dtype`` (a bf16
    operand is widened)."""
    t, _, z, w = cinv_ch.shape
    cinv_ch = cinv_ch.to(dtype)
    return torch.complex(cinv_ch[:, 0::2], cinv_ch[:, 1::2]).reshape(
        t, 2, 6, 6, z, w)


def _ch_clover_apply(v_ch: torch.Tensor, cinv_ch: torch.Tensor,
                     dag: bool = False) -> torch.Tensor:
    """Chiral-block 6×6 matrix field (channel operand [T, 144, Z, W])
    applied to a planar-channel spinor [..., T, 24, Z, W] (any leading
    batch axes); ``dag`` applies the conjugate transpose.  Used only for
    the leading A⁻¹† of the dagger ordering; every other application is
    a kernel epilogue.  A bf16 matrix is widened to the spinor's dtype.
    A bf16 spinor (the bf16 spinor storage) is widened to float32 with
    the matrix, and the result is float32, as the JAX package's."""
    if v_ch.dtype == torch.bfloat16:
        v_ch = v_ch.to(torch.float32)
    return _ch_matrix_apply(v_ch, _ch_clover_matrix(cinv_ch, v_ch.dtype),
                            dag)


def _ch_matrix_apply(v_ch: torch.Tensor, m: torch.Tensor,
                     dag: bool = False) -> torch.Tensor:
    """``_ch_clover_apply`` with the matrices given as
    ``_ch_clover_matrix`` makes them."""
    t, _, z, w = v_ch.shape[-4:]
    lead = v_ch.shape[:-4]
    v = torch.complex(v_ch[..., 0::2, :, :], v_ch[..., 1::2, :, :]).reshape(
        *lead, t, 2, 6, z, w)
    if dag:
        out = torch.einsum("thcrzw,...thczw->...thrzw", m.conj(), v)
    else:
        out = torch.einsum("thrczw,...thczw->...thrzw", m, v)
    return torch.stack([out.real, out.imag], dim=-3).reshape(v_ch.shape)


def _ch_twist(psi_ch: torch.Tensor, a: float, b: float) -> torch.Tensor:
    """b (1 + i a γ5) on a planar-channel field [..., T, 24, Z, W]
    (channel (s*3+c)*2 + ri; γ5 = +1 for spins 0,1 and −1 for 2,3)."""
    re, im = psi_ch[..., 0::2, :, :], psi_ch[..., 1::2, :, :]
    g5 = torch.tensor([1.0] * 6 + [-1.0] * 6, dtype=psi_ch.dtype,
                      device=psi_ch.device).reshape(12, 1, 1)
    out_re = b * (re - (a * g5) * im)
    out_im = b * (im + (a * g5) * re)
    return torch.stack([out_re, out_im], dim=-3).reshape(psi_ch.shape)


@dataclasses.dataclass(frozen=True)
class DiracParams:
    """Static operator parameters.

    ``use_kernels`` takes the place of the JAX package's ``use_pallas``:
    hops go through the hand-written kernel wrapper (``dslash_ch``)
    instead of the plain PyTorch stencil.  ``kernel_bf16`` takes the
    place of its ``pallas_bf16``: the kernels read bf16 gauge and
    clover-inverse operands (with ``use_kernels`` only)."""

    kind: str = "wilson"        # wilson | twisted-mass | clover | twisted-clover
    kappa: float = 0.12
    mu: float = 0.0             # twisted mass
    epsilon: float = 0.0        # non-degenerate splitting (DiracNdeg)
    csw: float = 0.0            # clover coefficient
    flavor: int = +1            # twist sign
    matpc_parity: int = 0       # 0 = even-even, 1 = odd-odd
    asymmetric: bool = False    # asymmetric Schur variant
    use_kernels: bool = False   # hops through ops.dslash_kernel.dslash_ch
    kernel_bf16: bool = False   # bf16 operand tier (JAX: pallas_bf16)

    def __post_init__(self):
        kinds = ("wilson", "twisted-mass", "clover", "twisted-clover")
        if self.kind not in kinds:
            raise ValueError(f"unknown operator kind {self.kind!r}; "
                             f"one of {kinds}")
        if not (0.0 < self.kappa < 1.0):
            raise ValueError(f"kappa={self.kappa} outside (0, 1)")
        if self.kind in ("clover", "twisted-clover") and self.csw == 0.0:
            raise ValueError(f"{self.kind} requires csw != 0")
        if self.kind in ("twisted-mass", "twisted-clover") and self.mu == 0.0:
            raise ValueError(f"{self.kind} requires mu != 0")
        if self.flavor not in (+1, -1):
            raise ValueError("flavor must be +1 or -1")
        if self.matpc_parity not in (0, 1):
            raise ValueError("matpc_parity must be 0 or 1")
        if self.kernel_bf16 and not self.use_kernels:
            raise ValueError("kernel_bf16 is a tier of the kernels: it "
                             "needs use_kernels")

    @property
    def has_twist(self) -> bool:
        return self.kind in ("twisted-mass", "twisted-clover")

    @property
    def has_clover(self) -> bool:
        return self.kind in ("clover", "twisted-clover")


class Dirac(nn.Module):
    """Operator bundle: fields (buffers) + params + geometry.

    Buffers: ``u`` [4,2,3,3,T,Z,W]; ``clover`` and ``clover_inv``
    [2,2,6,6,T,Z,W] (the inverse includes the twist for twisted-clover);
    ``u_doubled`` [4,2,2,3,3,T,Z,W], the links of both hop directions at
    each site (present with ``use_kernels``)."""

    def __init__(self, u: torch.Tensor, params: DiracParams, geom: Geometry,
                 clover=None, clover_inv=None, u_doubled=None):
        super().__init__()
        self.params = params
        self.geom = geom
        self.register_buffer("u", u)
        self.register_buffer("clover", clover)
        self.register_buffer("clover_inv", clover_inv)
        self.register_buffer("u_doubled", u_doubled)
        self._ch_cache = {}
        self._antiperiodic = None   # the t boundary, read at first use

    def forward(self, psi: torch.Tensor) -> torch.Tensor:
        return self.m(psi)

    def _apply(self, *args, **kwargs):
        self._ch_cache = {}     # .to() / .cuda(): rebuild on the new device
        return super()._apply(*args, **kwargs)

    @property
    def antiperiodic(self) -> bool:
        """Whether the gauge carries the antiperiodic t boundary, read
        from the doubled links once (``antiperiodic_t``)."""
        if self._antiperiodic is None:
            self._antiperiodic = antiperiodic_t(self.u_doubled)
        return self._antiperiodic

    def _hop_kw(self) -> dict:
        """The gauge keywords of every hop on the channel operands:
        recon-12, and the t boundary that its row 2 carried."""
        return dict(recon12=True, antiperiodic=self.antiperiodic)

    def _operands(self, dtype: torch.dtype, exact: bool = False) -> dict:
        """Channel operands of both parities for spinors of real
        ``dtype``: recon-12 gauge ``g`` [T,96,Z,W] and clover inverse
        ``ci`` [T,144,Z,W], in ``dtype`` or, in the bf16 tier unless
        ``exact``, in bfloat16 (each hop on them takes ``_hop_kw``).
        Built once per operand dtype (which names the tier) and reused
        by every hop; an operator without ``clover_inv`` (the loops'
        untwisted partner, ``physics.loops``) builds the gauge channels
        only, and one that shares its cache with another adds what it
        lacks."""
        op = (torch.bfloat16 if self.params.kernel_bf16 and not exact
              else dtype)
        ops = self._ch_cache.setdefault(op, {})
        if "g" not in ops:
            ops["g"] = [gauge_channels(self.u_doubled, p, True, op)
                        for p in (0, 1)]
        if (self.params.has_clover and self.clover_inv is not None
                and "ci" not in ops):
            ops["ci"] = [clover_channels(self.clover_inv, p, op)
                         for p in (0, 1)]
        return ops

    def _clover_matrix(self, dtype: torch.dtype, parity: int):
        """The clover inverse of ``parity`` as complex matrices
        (``_ch_clover_matrix``) for spinors of real ``dtype``, made from
        the channel operand once and kept: the leading A⁻¹† of the
        multi-source and of the sharded dagger half reads it on every
        call (both run on float32 spinors: one parity in complex64, 0.6
        GB at 32³×64)."""
        key = ("matrix", dtype, parity)
        if key not in self._ch_cache:
            self._ch_cache[key] = _ch_clover_matrix(
                self._operands(dtype)["ci"][parity], dtype)
        return self._ch_cache[key]

    def _chain_channels(self, psi_p: torch.Tensor) -> torch.Tensor:
        """A complex field as the channel spinor of the fused chain: in
        its own precision, or float32 in the bf16 tier (spinors stay
        float32 there, as the JAX package's ``matpc_dagm`` keeps them)."""
        ch = to_channels(psi_p)
        return ch.to(torch.float32) if self.params.kernel_bf16 else ch

    # ---- hopping ----------------------------------------------------
    def dslash(self, psi_opp: torch.Tensor, parity: int,
               dagger: bool = False) -> torch.Tensor:
        if self.params.use_kernels:
            psi_ch = to_channels(psi_opp)
            if self.params.kernel_bf16:
                # the bf16-ψ hop of dslash_parity_pallas5: float32 out,
                # so the result is complex64
                psi_ch = cast_channels(psi_ch, torch.bfloat16)
            ops = self._operands(psi_ch.dtype)
            out = dslash_ch(ops["g"][parity], psi_ch, parity, self.geom,
                            dagger, **self._hop_kw())
            return from_channels(out, (4, 3))
        return _dsl.dslash_parity(self.u, psi_opp, parity, self.geom, dagger)

    def _matpc_tm_ch(self, psi_ch: torch.Tensor, dagger: bool,
                     hop=dslash_ch):
        """Fused twisted-mass symmetric matpc on channels: the A⁻¹ twists
        and the final −κ² xpay run in the hop epilogues.  ``hop`` is
        ``dslash_ch`` or, on a batch of sources, ``dslash_ch_msrc``."""
        p = self.params
        pr, k = p.matpc_parity, p.kappa
        ops = self._operands(psi_ch.dtype)
        g, kw = ops["g"], self._hop_kw()
        a = 2.0 * p.kappa * p.mu * p.flavor
        if dagger:
            a = -a
        tw = (-a, 1.0 / (1.0 + a * a))
        if not dagger:
            t = hop(g[1 - pr], psi_ch, 1 - pr, self.geom, twist=tw, **kw)
            return hop(g[pr], t, pr, self.geom, twist=tw,
                       xpay_coef=-(k * k), x_ch=psi_ch, **kw)
        t = _ch_twist(psi_ch, tw[0], tw[1])
        t = hop(g[1 - pr], t, 1 - pr, self.geom, dagger=True, twist=tw,
                **kw)
        return hop(g[pr], t, pr, self.geom, dagger=True,
                   xpay_coef=-(k * k), x_ch=psi_ch, **kw)

    def _matpc_clover_ch(self, psi_ch: torch.Tensor, dagger: bool,
                         hop=dslash_ch):
        """Fused (twisted-)clover symmetric matpc on channels: the A⁻¹
        chiral 6×6 matvecs run in the hop epilogues (``hop`` as in
        ``_matpc_tm_ch``)."""
        p = self.params
        pr, k = p.matpc_parity, p.kappa
        ops = self._operands(psi_ch.dtype)
        g, ci, kw = ops["g"], ops["ci"], self._hop_kw()
        if not dagger:
            t = hop(g[1 - pr], psi_ch, 1 - pr, self.geom, clover="fwd",
                    cinv_ch=ci[1 - pr], **kw)
            return hop(g[pr], t, pr, self.geom, clover="fwd",
                       cinv_ch=ci[pr], xpay_coef=-(k * k), x_ch=psi_ch, **kw)
        if hop is dslash_ch:
            t = _ch_clover_apply(psi_ch, ci[pr], dag=True)
        else:
            # every matvec of the multi-source CG or of the sharded CG
            # (its halo hop): keep the matrices
            t = _ch_matrix_apply(psi_ch,
                                 self._clover_matrix(psi_ch.dtype, pr),
                                 dag=True)
        t = hop(g[1 - pr], t, 1 - pr, self.geom, dagger=True, clover="dag",
                cinv_ch=ci[1 - pr], **kw)
        return hop(g[pr], t, pr, self.geom, dagger=True,
                   xpay_coef=-(k * k), x_ch=psi_ch, **kw)

    def _fused_matpc_ch(self, psi_ch: torch.Tensor, dagger: bool,
                        hop=dslash_ch):
        if self.params.has_clover:
            return self._matpc_clover_ch(psi_ch, dagger, hop)
        return self._matpc_tm_ch(psi_ch, dagger, hop)

    def _fused_matpc_ch_msrc(self, psi_ch_b: torch.Tensor, dagger: bool):
        """Multi-source fused matpc on float32 channels [n, T, 24, Z, W]:
        the same chain with the multi-source hop, which reads the gauge
        and clover once for all n sources.  The dagger half alone runs
        its leading A⁻¹† (or twist) batched before the first hop; the
        normal operator's chain, ``_fused_matpc_dagm_ch(hop=
        dslash_ch_msrc)``, takes it from the forward half's second
        output instead."""
        return self._fused_matpc_ch(psi_ch_b, dagger, hop=dslash_ch_msrc)

    def _fused_matpc_dagm_ch(self, psi_ch: torch.Tensor, hop=dslash_ch):
        """matpc†·matpc as four fused hops: the leading A⁻¹† of the dagger
        half is the second output (``post_op``) of the forward half's
        last hop.  ``hop`` is the hop function: ``dslash_ch``,
        ``dslash_ch_msrc`` on a batch of sources [n, T, 24, Z, W], or
        the plain ``dslash_ch_reference`` where a caller times the
        chain."""
        p = self.params
        pr, k = p.matpc_parity, p.kappa
        ops = self._operands(psi_ch.dtype)
        g, kw = ops["g"], self._hop_kw()
        if p.has_clover:
            ci = ops["ci"]
            t = hop(g[1 - pr], psi_ch, 1 - pr, self.geom, clover="fwd",
                    cinv_ch=ci[1 - pr], **kw)
            m, m_pre = hop(g[pr], t, pr, self.geom, clover="fwd",
                           cinv_ch=ci[pr], xpay_coef=-(k * k), x_ch=psi_ch,
                           post_op=("clover",), **kw)
            t2 = hop(g[1 - pr], m_pre, 1 - pr, self.geom, dagger=True,
                     clover="dag", cinv_ch=ci[1 - pr], **kw)
            return hop(g[pr], t2, pr, self.geom, dagger=True,
                       xpay_coef=-(k * k), x_ch=m, **kw)
        a = 2.0 * p.kappa * p.mu * p.flavor
        b = 1.0 / (1.0 + a * a)
        # the forward half applies b(1 - i a γ5) = A⁻¹, the sign
        # convention of _matpc_tm_ch (its twist is (-a, b))
        t = hop(g[1 - pr], psi_ch, 1 - pr, self.geom, twist=(-a, b), **kw)
        m, m_pre = hop(g[pr], t, pr, self.geom, twist=(-a, b),
                       xpay_coef=-(k * k), x_ch=psi_ch,
                       post_op=("twist", a, b), **kw)
        t2 = hop(g[1 - pr], m_pre, 1 - pr, self.geom, dagger=True,
                 twist=(a, b), **kw)
        return hop(g[pr], t2, pr, self.geom, dagger=True,
                   xpay_coef=-(k * k), x_ch=m, **kw)

    # ---- parity-diagonal term A ------------------------------------
    def a_apply(self, psi_p: torch.Tensor, parity: int,
                dagger: bool = False) -> torch.Tensor:
        p = self.params
        out = psi_p
        if p.has_clover:
            out = _cl.clover_apply(self.clover[parity], out)
        if p.has_twist:
            if p.has_clover:
                # twisted-clover: A + i 2κμ γ5 (twist added to the clover)
                out = out + (_twist.twist_apply(psi_p, p.kappa, p.mu,
                                                p.flavor, dagger) - psi_p)
            else:
                out = _twist.twist_apply(out, p.kappa, p.mu, p.flavor,
                                         dagger)
        return out

    def a_inv_apply(self, psi_p: torch.Tensor, parity: int,
                    dagger: bool = False) -> torch.Tensor:
        p = self.params
        if p.has_clover:
            return _cl.clover_apply(self.clover_inv[parity], psi_p,
                                    dagger=dagger)
        if p.has_twist:
            return _twist.twist_apply(psi_p, p.kappa, p.mu, p.flavor,
                                      dagger, inverse=True)
        return psi_p

    # ---- full operator ----------------------------------------------
    def m(self, psi: torch.Tensor, dagger: bool = False) -> torch.Tensor:
        k = self.params.kappa
        out_e = self.a_apply(psi[0], 0, dagger) - k * self.dslash(
            psi[1], 0, dagger)
        out_o = self.a_apply(psi[1], 1, dagger) - k * self.dslash(
            psi[0], 1, dagger)
        return torch.stack([out_e, out_o])

    def mdag(self, psi: torch.Tensor) -> torch.Tensor:
        return self.m(psi, dagger=True)

    def mdagm(self, psi: torch.Tensor) -> torch.Tensor:
        return self.mdag(self.m(psi))

    @property
    def _has_fused_matpc(self) -> bool:
        p = self.params
        return (p.use_kernels and self.u_doubled is not None
                and not p.asymmetric
                and (self.clover_inv is not None or not p.has_clover)
                and p.kind in ("twisted-mass", "clover", "twisted-clover"))

    # ---- even-odd preconditioned operator ----------------------------
    def matpc(self, psi_p: torch.Tensor, dagger: bool = False):
        p = self.params
        if self._has_fused_matpc:
            out = self._fused_matpc_ch(self._chain_channels(psi_p), dagger)
            return from_channels(out, (4, 3))
        pr, k = p.matpc_parity, p.kappa
        if p.asymmetric:
            t = self.dslash(psi_p, 1 - pr, dagger)
            t = self.a_inv_apply(t, 1 - pr, dagger)
            t = self.dslash(t, pr, dagger)
            return self.a_apply(psi_p, pr, dagger) - (k * k) * t
        if not dagger:
            t = self.dslash(psi_p, 1 - pr)
            t = self.a_inv_apply(t, 1 - pr)
            t = self.dslash(t, pr)
            return psi_p - (k * k) * self.a_inv_apply(t, pr)
        t = self.a_inv_apply(psi_p, pr, dagger=True)
        t = self.dslash(t, 1 - pr, dagger=True)
        t = self.a_inv_apply(t, 1 - pr, dagger=True)
        t = self.dslash(t, pr, dagger=True)
        return psi_p - (k * k) * t

    def matpc_dagm(self, psi_p: torch.Tensor) -> torch.Tensor:
        if self._has_fused_matpc:
            out = self._fused_matpc_dagm_ch(self._chain_channels(psi_p))
            return from_channels(out, (4, 3))
        return self.matpc(self.matpc(psi_p), dagger=True)

    def matpc_dagm_batched(self, psi_b: torch.Tensor) -> torch.Tensor:
        """``matpc_dagm`` of each field of a batch [n, 4, 3, T, Z, W]: on
        the fused chain in float32 one multi-source chain for all n (four
        ``dslash_ch_msrc`` launches, the sum order of n single chains),
        otherwise one field at a time (a complex128 operator: the double
        ``dslash_ch``, as the multi-source kernel is float32 only)."""
        if self._has_fused_matpc:
            ch = torch.stack([self._chain_channels(v) for v in psi_b])
            if ch.dtype == torch.float32:
                out = self._fused_matpc_dagm_ch(ch, hop=dslash_ch_msrc)
                return torch.stack([from_channels(o, (4, 3)) for o in out])
        return torch.stack([self.matpc_dagm(v) for v in psi_b])

    # ---- Schur source prep / solution rebuild ------------------------
    def prepare(self, b: torch.Tensor) -> torch.Tensor:
        """b [2,...] → preconditioned-system source on the solve parity."""
        p = self.params
        pr, k = p.matpc_parity, p.kappa
        src = b[pr] + k * self.dslash(self.a_inv_apply(b[1 - pr], 1 - pr),
                                      pr)
        if not p.asymmetric:
            src = self.a_inv_apply(src, pr)
        return src

    def reconstruct(self, x_p: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Solve-parity solution + original source → full solution."""
        p = self.params
        pr, k = p.matpc_parity, p.kappa
        x_other = self.a_inv_apply(b[1 - pr] + k * self.dslash(x_p, 1 - pr),
                                   1 - pr)
        parts = [None, None]
        parts[pr] = x_p
        parts[1 - pr] = x_other
        return torch.stack(parts)

    # ---- bookkeeping --------------------------------------------------
    def flops_per_mat(self) -> int:
        """Analytic flops of one full-operator application: 1320 per site
        for the hop, 48 for the diagonal, 48 more with a twist and 504
        more with a clover."""
        extra = 0
        if self.params.has_twist:
            extra += 48
        if self.params.has_clover:
            extra += _cl.CLOVER_APPLY_FLOPS_PER_SITE
        return ((_dsl.WILSON_DSLASH_FLOPS_PER_SITE + 48 + extra)
                * self.geom.volume)


def as_sloppy(dirac: Dirac, **param_overrides) -> Dirac:
    """An operator over the same fields with other parameters, e.g.
    ``as_sloppy(d, kernel_bf16=True)``, the bf16 sloppy operator of the
    mixed-precision solvers.  ``u``, ``clover``, ``clover_inv`` and
    ``u_doubled`` are the same tensors (no copy); only the new
    operator's channel operands are new memory (bf16 gauge and clover
    inverse of both parities: ~1 GB at 32³×64).  The counterpart of the
    JAX package's ``dirac.as_sloppy``."""
    params = dataclasses.replace(dirac.params, **param_overrides)
    out = Dirac(dirac.u, params, dirac.geom, clover=dirac.clover,
                clover_inv=dirac.clover_inv, u_doubled=dirac.u_doubled)
    out._antiperiodic = dirac._antiperiodic     # the same links
    return out


def make_dirac(u: torch.Tensor, params: DiracParams, geom: Geometry,
               clover=None, clover_inv=None) -> Dirac:
    """Build the operator bundle on ``u``'s device.  For clover kinds the
    clover term and its (twisted) inverse are made from the field
    strength unless given.  A non-degenerate ``epsilon`` raises: that
    doublet is ``make_dirac_ndeg``'s."""
    if params.epsilon != 0.0:
        raise ValueError(f"epsilon={params.epsilon}: the non-degenerate "
                         "doublet is make_dirac_ndeg's DiracNdeg")
    if params.has_clover and clover is None:
        clover, clover_inv = _cl.make_clover_pair(u, geom, params)
    u_doubled = _dsl.double_gauge(u, geom) if params.use_kernels else None
    return Dirac(u, params, geom, clover=clover, clover_inv=clover_inv,
                 u_doubled=u_doubled)


class DiracNdeg(nn.Module):
    """Non-degenerate twisted-mass doublet: two flavours coupled by the
    ε τ1 term (the reference's DiracTwistedMass doublet path,
    lib/dslash_ndeg_twisted_mass.cu; oracle tm_ndeg_mat / tm_ndeg_matpc,
    tests/wilson_dslash_reference.cpp), the JAX package's ``DiracNdeg``.

    Fields are doublets [2(flavour), 2(parity), 4, 3, T, Z, W].  The hop
    is flavour-diagonal: it is the hop of ``wilson``, a Wilson ``Dirac``
    on the same links (its gauge channels and the t boundary it reads
    from them, ``antiperiodic_t``); A = 1 + i 2κμ γ5 τ3 − 2κε τ1 mixes
    the flavours site by site (``ops.twist.ndeg_twist_apply``).  No
    clover term.  With ``use_kernels`` the hops run on planar-channel
    doublets [2f, T, 24, Z, W] (module docstring), and ``matpc`` /
    ``matpc_dagm`` stay on channels from the first hop to the last."""

    def __init__(self, u: torch.Tensor, params: DiracParams, geom: Geometry,
                 u_doubled=None):
        super().__init__()
        self.params = params
        self.geom = geom
        self.wilson = Dirac(u, DiracParams(kind="wilson", kappa=params.kappa,
                                           use_kernels=params.use_kernels),
                            geom, u_doubled=u_doubled)

    def forward(self, psi: torch.Tensor) -> torch.Tensor:
        return self.m(psi)

    @property
    def antiperiodic(self) -> bool:
        return self.wilson.antiperiodic

    def _gauge_ch(self, dtype: torch.dtype, parity: int) -> torch.Tensor:
        """Recon-12 gauge channels of ``parity`` in the real ``dtype``."""
        return self.wilson._operands(dtype)["g"][parity]

    def _hop_ch(self, psi_ch: torch.Tensor, parity: int,
                dagger: bool = False) -> torch.Tensor:
        """The bare hop of both flavours [2f, T, 24, Z, W]: one
        multi-source launch in float32, the double single-source kernel
        once a flavour in float64."""
        g = self._gauge_ch(psi_ch.dtype, parity)
        kw = self.wilson._hop_kw()
        if psi_ch.dtype == torch.float32:
            return dslash_ch_msrc(g, psi_ch, parity, self.geom, dagger, **kw)
        return torch.stack([dslash_ch(g, v, parity, self.geom, dagger, **kw)
                            for v in psi_ch])

    @staticmethod
    def to_ch(psi_f: torch.Tensor) -> torch.Tensor:
        """Complex doublet [2f, 4, 3, T, Z, W] → channels [2f, T, 24, Z, W]."""
        return torch.stack([to_channels(v) for v in psi_f])

    @staticmethod
    def from_ch(psi_ch: torch.Tensor) -> torch.Tensor:
        return torch.stack([from_channels(v, (4, 3)) for v in psi_ch])

    def _a_inv_ch(self, psi_ch: torch.Tensor, dagger: bool = False):
        p = self.params
        return _twist.ndeg_twist_apply_ch(psi_ch, p.kappa, p.mu, p.epsilon,
                                          dagger, inverse=True)

    # ---- hopping and A ----------------------------------------------
    def dslash(self, psi_f_opp: torch.Tensor, parity: int,
               dagger: bool = False) -> torch.Tensor:
        """Flavour-diagonal Wilson hop of psi_f_opp [2f, 4, 3, T, Z, W]."""
        if self.params.use_kernels:
            return self.from_ch(self._hop_ch(self.to_ch(psi_f_opp), parity,
                                             dagger))
        return torch.stack([self.wilson.dslash(v, parity, dagger)
                            for v in psi_f_opp])

    def a_apply(self, psi_f_p: torch.Tensor,
                dagger: bool = False) -> torch.Tensor:
        p = self.params
        return _twist.ndeg_twist_apply(psi_f_p, p.kappa, p.mu, p.epsilon,
                                       dagger)

    def a_inv_apply(self, psi_f_p: torch.Tensor,
                    dagger: bool = False) -> torch.Tensor:
        p = self.params
        return _twist.ndeg_twist_apply(psi_f_p, p.kappa, p.mu, p.epsilon,
                                       dagger, inverse=True)

    # ---- full operator ----------------------------------------------
    def m(self, psi: torch.Tensor, dagger: bool = False) -> torch.Tensor:
        k = self.params.kappa
        out = [self.a_apply(psi[:, p], dagger)
               - k * self.dslash(psi[:, 1 - p], p, dagger) for p in (0, 1)]
        return torch.stack(out, dim=1)

    def mdag(self, psi: torch.Tensor) -> torch.Tensor:
        return self.m(psi, dagger=True)

    def mdagm(self, psi: torch.Tensor) -> torch.Tensor:
        return self.mdag(self.m(psi))

    # ---- even-odd preconditioned operator ----------------------------
    def _matpc_ch(self, psi_ch: torch.Tensor, dagger: bool = False):
        """``matpc`` on channel doublets: two hops, each with an A⁻¹ (the
        dagger: A⁻¹† before each)."""
        pr, k = self.params.matpc_parity, self.params.kappa
        if not dagger:
            t = self._a_inv_ch(self._hop_ch(psi_ch, 1 - pr))
            return psi_ch - (k * k) * self._a_inv_ch(self._hop_ch(t, pr))
        t = self._hop_ch(self._a_inv_ch(psi_ch, True), 1 - pr, True)
        return psi_ch - (k * k) * self._hop_ch(self._a_inv_ch(t, True), pr,
                                               True)

    def _matpc_dagm_ch(self, psi_ch: torch.Tensor) -> torch.Tensor:
        return self._matpc_ch(self._matpc_ch(psi_ch), True)

    def matpc(self, psi_f_p: torch.Tensor, dagger: bool = False):
        """Symmetric even-odd Schur operator on one parity of the
        doublet: 1 − κ² A_p⁻¹ D A_{1−p}⁻¹ D."""
        if self.params.use_kernels:
            return self.from_ch(self._matpc_ch(self.to_ch(psi_f_p), dagger))
        pr, k = self.params.matpc_parity, self.params.kappa
        if not dagger:
            t = self.dslash(psi_f_p, 1 - pr)
            t = self.a_inv_apply(t)
            t = self.dslash(t, pr)
            return psi_f_p - (k * k) * self.a_inv_apply(t)
        t = self.a_inv_apply(psi_f_p, dagger=True)
        t = self.dslash(t, 1 - pr, dagger=True)
        t = self.a_inv_apply(t, dagger=True)
        t = self.dslash(t, pr, dagger=True)
        return psi_f_p - (k * k) * t

    def matpc_dagm(self, psi_f_p: torch.Tensor) -> torch.Tensor:
        if self.params.use_kernels:
            return self.from_ch(self._matpc_dagm_ch(self.to_ch(psi_f_p)))
        return self.matpc(self.matpc(psi_f_p), dagger=True)

    # ---- Schur source prep / solution rebuild ------------------------
    def prepare(self, b: torch.Tensor) -> torch.Tensor:
        """b [2f, 2p, ...] → doublet source on the solve parity."""
        pr, k = self.params.matpc_parity, self.params.kappa
        src = b[:, pr] + k * self.dslash(self.a_inv_apply(b[:, 1 - pr]), pr)
        return self.a_inv_apply(src)

    def reconstruct(self, x_f_p: torch.Tensor, b: torch.Tensor):
        pr, k = self.params.matpc_parity, self.params.kappa
        x_other = self.a_inv_apply(b[:, 1 - pr]
                                   + k * self.dslash(x_f_p, 1 - pr))
        parts = [None, None]
        parts[pr] = x_f_p
        parts[1 - pr] = x_other
        return torch.stack(parts, dim=1)

    def flops_per_mat(self) -> int:
        """Analytic flops of one application of the doublet's m: both
        flavours' hop (1320 a site) and A (96 a site)."""
        return 2 * (_dsl.WILSON_DSLASH_FLOPS_PER_SITE + 96) * self.geom.volume


def make_dirac_ndeg(u: torch.Tensor, params: DiracParams,
                    geom: Geometry) -> DiracNdeg:
    """The non-degenerate doublet on ``u``'s device (``params.kind``
    "twisted-mass" with ε ≠ 0: the ε τ1 coupling tells it from two
    independent degenerate operators).  Refuses μ = 0 or ε = 0, as the
    JAX package does, and the bf16 operand tier, which it has no chain
    for."""
    if params.mu == 0.0 or params.epsilon == 0.0:
        raise ValueError("ndeg doublet requires mu != 0 and epsilon != 0")
    if params.kernel_bf16:
        raise ValueError("the doublet has no bf16 operand tier")
    u_doubled = _dsl.double_gauge(u, geom) if params.use_kernels else None
    return DiracNdeg(u, params, geom, u_doubled=u_doubled)
