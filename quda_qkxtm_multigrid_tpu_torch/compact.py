"""Compact channel operator: the counterpart of the JAX package's
``compact.py``.

A ``CompactDirac`` holds only the planar-channel operands that the fused
solve path reads: the recon-12 gauge ``g_ch`` [2, T, 96, Z, W], the
(twisted) clover inverse ``cinv_ch`` and the clover ``cl_ch``
[2, T, 144, Z, W], each stacked over the two parities (``g_ch[p]`` is
parity p's operand).  No canonical gauge or clover field stays on the
card.  At 48³×96 the canonical complex128 bundle (gauge, doubled gauge,
clover, inverse) is 42.8 GB; the compact bfloat16 tier is 11.2 GB and
the float64 channels of the full operator 20.4 GB, so a certified
48³×96 solve fits on one 80 GB card.

Tiers, the channel dtype of ``make_compact``:
  bfloat16  bf16 gauge, float32 A⁻¹ of the bf16-rounded clover, bf16
            clover (the JAX package's ``bf16=True``); float32 spinors,
            or bf16 spinor storage through ``matpc_ch(out_dtype=
            torch.bfloat16)`` (kernel K1e);
  float32   float32 operands and spinors (``bf16=False``);
  float64   float64 operands and spinors: the port's stand-in for the
            host complex128 operator of the JAX package's
            ``solvers/host_dc.py``, since the card has native float64.
Every hop is ``ops.dslash_kernel.dslash_ch`` (a CUDA kernel on a CUDA
tensor); the leading A⁻¹† of a dagger matpc and the A and A⁻¹ of
prepare / reconstruct / the full operator are plain PyTorch
(``dirac._ch_clover_apply``, ``dirac._ch_twist``).

Full-operator residuals use the symmetric even-odd identity
    r = b − M x  with  M_pp = A_p, M_po = −κ D_po,
one xpay hop and one clover apply per parity (``m_ch``).

Left out on purpose, as TPU squeezes: host staging of the build
(``host=``), ``cinv_bf16`` and ``interpret``.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from quda_qkxtm_multigrid_tpu_torch.dirac import (
    DiracParams, _ch_clover_apply, _ch_twist)
from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry
from quda_qkxtm_multigrid_tpu_torch.ops import dslash as _dsl
from quda_qkxtm_multigrid_tpu_torch.ops.blas import norm2
from quda_qkxtm_multigrid_tpu_torch.ops.clover import (
    CLOVER_APPLY_FLOPS_PER_SITE, FMUNU_PAIRS, _clover_parity,
    _field_strength_plane)
from quda_qkxtm_multigrid_tpu_torch.ops.dslash_kernel import (
    antiperiodic_t, cast_channels, dslash_ch, from_channels, to_channels)
from quda_qkxtm_multigrid_tpu_torch.ops.smallmat import mat6_inv_blocks
from quda_qkxtm_multigrid_tpu_torch.solvers.cg import cg

CHANNEL_DTYPES = (torch.bfloat16, torch.float32, torch.float64)


class CompactDirac(nn.Module):
    """Channel-operand bundle (module docstring): buffers ``g_ch``,
    ``cinv_ch`` and ``cl_ch`` ([2, T, C, Z, W], parity first; the clover
    pair is None for twisted mass, and ``cinv_ch`` is None for an
    operator built with ``inverse=False``, which has ``m_ch`` and
    ``mdag_ch`` only).

    A solver backend without the fused extras of the full ``Dirac``
    (multi-source chain, MG): ``_has_fused_matpc`` is False, as in the
    JAX package."""

    _has_fused_matpc = False

    def __init__(self, g_ch: torch.Tensor, cinv_ch, cl_ch,
                 params: DiracParams, geom: Geometry,
                 antiperiodic: bool = False):
        super().__init__()
        self.params = params
        self.geom = geom
        # the gauge's t boundary, which recon-12 drops (make_compact
        # reads it from the links)
        self.antiperiodic = antiperiodic
        self.register_buffer("g_ch", g_ch)
        self.register_buffer("cinv_ch", cinv_ch)
        self.register_buffer("cl_ch", cl_ch)

    @property
    def spinor_dtype(self) -> torch.dtype:
        """Real dtype of the chain's channel spinors: float64 in the
        float64 tier, float32 otherwise."""
        return (torch.float64 if self.g_ch.dtype == torch.float64
                else torch.float32)

    @property
    def field_dtype(self) -> torch.dtype:
        """Complex dtype of the full-field adapters' output."""
        return (torch.complex128 if self.spinor_dtype == torch.float64
                else torch.complex64)

    def flops_per_mat(self) -> int:
        """Analytic flops of one full-operator application, the ledger of
        ``Dirac.flops_per_mat``."""
        extra = 0
        if self.params.has_twist:
            extra += 48
        if self.params.has_clover:
            extra += CLOVER_APPLY_FLOPS_PER_SITE
        return ((_dsl.WILSON_DSLASH_FLOPS_PER_SITE + 48 + extra)
                * self.geom.volume)

    def widened(self, dtype: torch.dtype = torch.float64) -> "CompactDirac":
        """The same stored operator with its channels cast to the wider
        ``dtype`` (exact: every bf16 and float32 value is a float64
        value), e.g. a float64 outer for a solve on this operator."""
        def cast(t):
            return None if t is None else t.to(dtype)
        return CompactDirac(cast(self.g_ch), cast(self.cinv_ch),
                            cast(self.cl_ch),
                            dataclasses.replace(self.params,
                                                kernel_bf16=False),
                            self.geom, self.antiperiodic)

    # ---- fused hot path (the chain of Dirac._fused_matpc_*_ch) ----------
    def _hop(self, parity: int, psi_ch, **kw):
        return dslash_ch(self.g_ch[parity], psi_ch, parity, self.geom,
                         recon12=True, antiperiodic=self.antiperiodic, **kw)

    def _cinv(self, parity: int) -> torch.Tensor:
        if self.cinv_ch is None:
            raise ValueError("this CompactDirac was built without A⁻¹ "
                             "(inverse=False): it has m_ch and mdag_ch only")
        return self.cinv_ch[parity]

    def matpc_ch(self, psi_ch, dagger: bool = False, out_dtype=None):
        """Symmetric Schur operator on a channel spinor.  ``out_dtype=
        torch.bfloat16`` stores the intermediate and output planes in
        bf16 (the bf16 spinor storage, K1e); the arithmetic stays
        float32."""
        p = self.params
        pr, k = p.matpc_parity, p.kappa
        kw = dict(out_dtype=out_dtype)
        if p.has_clover:
            ci_p, ci_o = self._cinv(pr), self._cinv(1 - pr)
            if not dagger:
                t = self._hop(1 - pr, psi_ch, clover="fwd", cinv_ch=ci_o,
                              **kw)
                return self._hop(pr, t, clover="fwd", cinv_ch=ci_p,
                                 xpay_coef=-(k * k), x_ch=psi_ch, **kw)
            t = _ch_clover_apply(psi_ch, ci_p, dag=True)
            t = self._hop(1 - pr, t, dagger=True, clover="dag", cinv_ch=ci_o,
                          **kw)
            return self._hop(pr, t, dagger=True, xpay_coef=-(k * k),
                             x_ch=psi_ch, **kw)
        a = 2.0 * p.kappa * p.mu * p.flavor
        if dagger:
            a = -a
        tw = (-a, 1.0 / (1.0 + a * a))
        if not dagger:
            t = self._hop(1 - pr, psi_ch, twist=tw, **kw)
            return self._hop(pr, t, twist=tw, xpay_coef=-(k * k),
                             x_ch=psi_ch, **kw)
        t = _ch_twist(psi_ch, tw[0], tw[1])
        t = self._hop(1 - pr, t, dagger=True, twist=tw, **kw)
        return self._hop(pr, t, dagger=True, xpay_coef=-(k * k),
                         x_ch=psi_ch, **kw)

    def matpc_dagm_ch(self, psi_ch, storage_dtype=None):
        """Normal operator M†M; ``storage_dtype=torch.bfloat16`` keeps the
        forward half's planes in bf16 (the final output stays in the
        spinors' dtype for the solver's reductions)."""
        t = self.matpc_ch(psi_ch, False, out_dtype=storage_dtype)
        return self.matpc_ch(t, True)

    # ---- the diagonal A and A⁻¹ on channels ------------------------------
    def _a_apply_ch(self, v_ch, parity: int, dag: bool = False):
        """A_p = clover + i a γ5 (a = 2κμ·flavor); ``dag`` applies
        A_p† = clover† − i a γ5."""
        p = self.params
        a = 2.0 * p.kappa * p.mu * p.flavor
        if dag:
            a = -a
        if p.has_clover:
            out = _ch_clover_apply(v_ch, self.cl_ch[parity], dag=dag)
            if p.has_twist:
                out = out + (_ch_twist(v_ch, a, 1.0) - v_ch)
            return out
        if p.has_twist:
            return _ch_twist(v_ch, a, 1.0)
        return v_ch

    def _a_inv_ch(self, v_ch, parity: int):
        p = self.params
        if p.has_clover:
            return _ch_clover_apply(v_ch, self._cinv(parity))
        if p.has_twist:
            a = 2.0 * p.kappa * p.mu * p.flavor
            return _ch_twist(v_ch, -a, 1.0 / (1.0 + a * a))
        return v_ch

    # ---- Schur prepare / reconstruct / full operator ---------------------
    def prepare_ch(self, b_e, b_o):
        """(b_e, b_o) channel fields → the Schur source on parity pr."""
        p = self.params
        pr = p.matpc_parity
        bp, bo = (b_e, b_o) if pr == 0 else (b_o, b_e)
        t = self._a_inv_ch(bo, 1 - pr)
        t = self._hop(pr, t, xpay_coef=p.kappa, x_ch=bp)
        return self._a_inv_ch(t, pr)

    def reconstruct_ch(self, x_p, b_e, b_o):
        """Schur solution → (x_e, x_o) channel fields."""
        p = self.params
        pr = p.matpc_parity
        bo = b_o if pr == 0 else b_e
        t = self._hop(1 - pr, x_p, xpay_coef=p.kappa, x_ch=bo)
        x_o = self._a_inv_ch(t, 1 - pr)
        return (x_p, x_o) if pr == 0 else (x_o, x_p)

    def m_ch(self, x_e, x_o):
        """Full operator per parity: M x|_p = A_p x_p − κ D_{p,1−p}
        x_{1−p}, one xpay hop (x = A_p x_p, coefficient −κ) a parity."""
        k = self.params.kappa
        return (self._hop(0, x_o, xpay_coef=-k, x_ch=self._a_apply_ch(x_e, 0)),
                self._hop(1, x_e, xpay_coef=-k, x_ch=self._a_apply_ch(x_o, 1)))

    def mdag_ch(self, x_e, x_o):
        """M† x|_p = A_p† x_p − κ D†_{p,1−p} x_{1−p}."""
        k = self.params.kappa
        return (self._hop(0, x_o, dagger=True, xpay_coef=-k,
                          x_ch=self._a_apply_ch(x_e, 0, dag=True)),
                self._hop(1, x_e, dagger=True, xpay_coef=-k,
                          x_ch=self._a_apply_ch(x_o, 1, dag=True)))

    # ---- full-field adapters (the Dirac protocol) ------------------------
    def _to_ch(self, x):
        return to_channels(x).to(self.spinor_dtype)

    def _from_ch(self, x_ch):
        return from_channels(x_ch, (4, 3)).to(self.field_dtype)

    def m(self, psi, dagger: bool = False):
        fn = self.mdag_ch if dagger else self.m_ch
        e, o = fn(self._to_ch(psi[0]), self._to_ch(psi[1]))
        return torch.stack([self._from_ch(e), self._from_ch(o)])

    def mdag(self, psi):
        return self.m(psi, dagger=True)

    def mdagm(self, psi):
        return self.mdag(self.m(psi))

    def matpc(self, psi_p, dagger: bool = False):
        return self._from_ch(self.matpc_ch(self._to_ch(psi_p), dagger))

    def matpc_dagm(self, psi_p):
        return self._from_ch(self.matpc_dagm_ch(self._to_ch(psi_p)))

    def a_apply(self, psi_p, parity: int, dagger: bool = False):
        return self._from_ch(self._a_apply_ch(self._to_ch(psi_p), parity,
                                              dagger))

    def prepare(self, b):
        return self._from_ch(self.prepare_ch(self._to_ch(b[0]),
                                             self._to_ch(b[1])))

    def reconstruct(self, x_p, b):
        x_e, x_o = self.reconstruct_ch(self._to_ch(x_p), self._to_ch(b[0]),
                                       self._to_ch(b[1]))
        return torch.stack([self._from_ch(x_e), self._from_ch(x_o)])


def _twisted_inverse(clov_p, params: DiracParams) -> torch.Tensor:
    """(A + i 2κμ·flavor γ5)⁻¹ of one parity's chiral blocks [2, 6, 6,
    ...] (the twist only for twisted-clover with μ ≠ 0, as
    ``ops.clover.make_clover_pair``)."""
    a = 0.0
    if params.kind == "twisted-clover" and params.mu != 0.0:
        a = 2.0 * params.kappa * params.mu * params.flavor
    eye = torch.eye(6, dtype=clov_p.dtype, device=clov_p.device).reshape(
        (6, 6) + (1,) * (clov_p.dim() - 3))
    return torch.stack([mat6_inv_blocks(clov_p[ch] + (sg * 1j * a) * eye)
                        for ch, sg in ((0, 1.0), (1, -1.0))])


def make_compact(u: torch.Tensor, params: DiracParams, geom: Geometry,
                 dtype: torch.dtype = torch.bfloat16,
                 inverse: bool = True) -> CompactDirac:
    """Build the channel bundle from a gauge field ``u`` [4,2,3,3,T,Z,W]
    on ``u``'s device, in ``u``'s precision, then cast to the channel
    ``dtype`` (``CHANNEL_DTYPES``; the JAX package's ``bf16`` flag).

    The bfloat16 tier keeps the precision rule of the JAX package: the
    clover A is rounded to bf16 first, the rounded (twisted) clover is
    inverted, and that inverse is kept in float32.  The stored A and A⁻¹
    then agree to float32, and the Schur solve certifies; independently
    rounded bf16 A and A⁻¹ floor the reconstructed residual at ~1e-3.

    The build goes one parity at a time, the inverse in t-slabs, so only
    ``u`` and one parity's temporaries are alive beside the channels.
    ``inverse=False`` leaves out A⁻¹ (``cinv_ch`` None): an operator for
    ``m_ch`` / ``mdag_ch`` only, such as a defect-correction outer's
    residual.  The t boundary is read from each parity's links before
    they lose row 2 (``antiperiodic_t``; a gauge that is neither
    periodic nor antiperiodic raises)."""
    if dtype not in CHANNEL_DTYPES:
        raise ValueError(f"channel dtype {dtype} not in {CHANNEL_DTYPES}")
    params = dataclasses.replace(params, use_kernels=True,
                                 kernel_bf16=dtype == torch.bfloat16)
    t_, z_, w_ = geom.lat_shape
    dev = u.device
    g = torch.empty((2, t_, 96, z_, w_), dtype=dtype, device=dev)
    bc = set()
    for p in (0, 1):
        links = _dsl.doubled_links(u, geom, p)
        bc.add(antiperiodic_t(links))
        g[p] = cast_channels(to_channels(links[:, :, :2]), dtype)
        del links
    antiperiodic = bc.pop()
    if bc:
        raise ValueError("the two parities' t links disagree on the t "
                         "boundary")
    if not params.has_clover:
        return CompactDirac(g, None, None, params, geom, antiperiodic)
    cinv_dtype = torch.float32 if dtype == torch.bfloat16 else dtype
    cl = torch.empty((2, t_, 144, z_, w_), dtype=dtype, device=dev)
    cinv = (torch.empty((2, t_, 144, z_, w_), dtype=cinv_dtype, device=dev)
            if inverse else None)
    tb = max(1, t_ // 8)
    for p in (0, 1):
        clov = _clover_parity(torch.stack([
            _field_strength_plane(u, geom, mu, nu, p)
            for mu, nu in FMUNU_PAIRS]), params.csw * params.kappa)
        if dtype == torch.bfloat16:
            clov = torch.complex(
                clov.real.to(torch.bfloat16).to(torch.float32),
                clov.imag.to(torch.bfloat16).to(torch.float32)).to(clov.dtype)
        cl[p] = cast_channels(to_channels(clov), dtype)
        if inverse:
            for t0 in range(0, t_, tb):
                cinv[p, t0:t0 + tb] = cast_channels(to_channels(
                    _twisted_inverse(clov[..., t0:t0 + tb, :, :], params)),
                    cinv_dtype)
        del clov
    return CompactDirac(g, cinv, cl, params, geom, antiperiodic)


def invert_compact(cd: CompactDirac, b_e, b_o, tol: float = 1e-7,
                   maxiter: int = 2000):
    """CG on M_pc†M_pc entirely in channel storage, from channel sources
    (b_e, b_o); returns ((x_e, x_o), iterations, the loop's |r|² of the
    normal system relative to |M_pc† src|²)."""
    src = cd.prepare_ch(b_e, b_o)
    rhs = cd.matpc_ch(src, dagger=True)
    res = cg(cd.matpc_dagm_ch, rhs, tol=tol, maxiter=maxiter)
    x_e, x_o = cd.reconstruct_ch(res.x, b_e, b_o)
    return (x_e, x_o), res.iters, res.r2 / norm2(rhs)


def compact_true_residual_ch(cd: CompactDirac, x_e, x_o, b_e, b_o):
    """((r_e, r_o), |r|/|b|) of the compact full operator in channel
    storage (|r|/|b| a 0-d tensor)."""
    m_e, m_o = cd.m_ch(x_e, x_o)
    r_e, r_o = b_e - m_e, b_o - m_o
    rel = torch.sqrt((norm2(r_e) + norm2(r_o)) / (norm2(b_e) + norm2(b_o)))
    return (r_e, r_o), rel


def compact_true_residual(cd: CompactDirac, x, b):
    """(r, |r|/|b|) of the compact full operator on canonical fields
    [2,4,3,T,Z,W] (r in b's dtype)."""
    (r_e, r_o), rel = compact_true_residual_ch(
        cd, cd._to_ch(x[0]), cd._to_ch(x[1]), cd._to_ch(b[0]),
        cd._to_ch(b[1]))
    r = torch.stack([from_channels(r_e, (4, 3)),
                     from_channels(r_o, (4, 3))]).to(b.dtype)
    return r, rel


def invert_compact_full(cd: CompactDirac, b, tol: float = 1e-7,
                        maxiter: int = 2000):
    """Solve M x = b for a canonical source b [2,4,3,T,Z,W]: b to
    channels, ``invert_compact``, the compact operator's own true
    residual (``compact_true_residual_ch``), x back in b's dtype.
    Returns an ``invert.InvertResult``."""
    from quda_qkxtm_multigrid_tpu_torch.invert import InvertResult
    b_e, b_o = cd._to_ch(b[0]), cd._to_ch(b[1])
    (x_e, x_o), iters, _ = invert_compact(cd, b_e, b_o, tol=tol,
                                          maxiter=maxiter)
    _, rel = compact_true_residual_ch(cd, x_e, x_o, b_e, b_o)
    x = torch.stack([from_channels(x_e, (4, 3)),
                     from_channels(x_o, (4, 3))]).to(b.dtype)
    return InvertResult(x, iters, float(rel))
