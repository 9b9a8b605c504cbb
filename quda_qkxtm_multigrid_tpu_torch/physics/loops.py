"""Disconnected quark loops by the (generalised) one-end trick, with
derivative and conserved-current insertions: the counterpart of the JAX
package's ``physics/loops.py`` (the reference's ``oneEndTrick_w_One_Der``
and ``calcMG_loop_wOneD_TSM_EvenOdd``).

Per stochastic source ξ (Z4 volume noise) with x = M⁻¹ξ:
  tmp3 = γ5 D_W x       (D_W the untwisted operator at the same κ and
                         clover, the "plain partner")
  std loop:  −Ω(x, x)        gen loop:  Ω(x, tmp3)
with Ω(a, b)[s1, s2](site) = Σ_c conj((γ5 a)[s1, c]) b[s2, c].  The
derivative (D) and conserved (C) insertions a direction mu:
  D = Ω(x, ∂⁺t) + Ω(∂⁻x, t) − Ω(∂⁺x, t) − Ω(x, ∂⁻t)
  C = Ω(x, ∂⁺t) + Ω(∂⁻x, t) + Ω(∂⁺x, t) + Ω(x, ∂⁻t)
with t = tmp3 (gen) or x (std) and ∂± the covariant shifts
(``ops.smear.covdev_apply``).  Results are [16 (s1*4+s2), T, Z, Y, X]
position-space fields ([4, 16, ...] with a direction); the workflows
project them by FFT.

The partner shares the solve operator's links: with ``use_kernels`` its
``m`` runs its two hops through K1 (``Dirac.dslash``) on the solve
operator's doubled gauge and gauge channels, with no copy.  It holds the
clover term and no inverse, so only ``m`` / ``dslash`` run on it (the
JAX package hands it the twisted inverse, which its ``m`` never reads).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from quda_qkxtm_multigrid_tpu_torch.dirac import Dirac, DiracParams
from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry
from quda_qkxtm_multigrid_tpu_torch.ops import clover as _cl
from quda_qkxtm_multigrid_tpu_torch.ops.dslash import double_gauge
from quda_qkxtm_multigrid_tpu_torch.ops.gamma import apply_gamma5
from quda_qkxtm_multigrid_tpu_torch.ops.smear import covdev_apply
from quda_qkxtm_multigrid_tpu_torch.parallel.sharded import ShardedDirac
from quda_qkxtm_multigrid_tpu_torch.physics.contract import corr_to_lex
from quda_qkxtm_multigrid_tpu_torch.utils.precision import heinsum
from quda_qkxtm_multigrid_tpu_torch.utils.rng import z4_source


def spin_outer_g5(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Ω(a, b)[s1, s2] = Σ_c conj((γ5 a)[p, s1, c]) b[p, s2, c] a site:
    [2, 4, 3, T, Z, W] × 2 → [4, 4, 2, T, Z, W]."""
    return heinsum("pmctzw,pnctzw->mnptzw", apply_gamma5(a).conj(), b)


class LoopResult(NamedTuple):
    std: torch.Tensor        # [16, T, Z, Y, X]  (vv)
    gen: torch.Tensor        # [16, T, Z, Y, X]  (gv)
    der_std: torch.Tensor    # [4, 16, T, Z, Y, X]  (cnD_vv)
    der_gen: torch.Tensor    # [4, 16, T, Z, Y, X]  (cnD_gv)
    cons_std: torch.Tensor   # [4, 16, T, Z, Y, X]  (cnC_vv)
    cons_gen: torch.Tensor   # [4, 16, T, Z, Y, X]  (cnC_gv)


def _lex16(c: torch.Tensor, geom: Geometry) -> torch.Tensor:
    """[4, 4, 2, T, Z, W] → [16, T, Z, Y, X]."""
    out = corr_to_lex(c, geom)
    return out.reshape((16,) + tuple(out.shape[2:]))


def one_end_trick(x: torch.Tensor, dirac_plain: Dirac,
                  geom: Geometry) -> LoopResult:
    """One noise sample's loop contributions from the solution x = M⁻¹ξ;
    ``dirac_plain`` is the untwisted partner (``plain_wilson_partner``).
    A sharded partner (``parallel.sharded.ShardedDirac``) takes this
    rank's box of x, ``geom`` the box's: its ``m`` hops through the
    halo exchange and the t shifts cross ranks on its mesh; the loops
    are then the box's rows."""
    u = dirac_plain.u
    mesh = getattr(dirac_plain, "mesh", None)
    tmp3 = apply_gamma5(dirac_plain.m(x))
    std = -_lex16(spin_outer_g5(x, x), geom)
    gen = _lex16(spin_outer_g5(x, tmp3), geom)
    der_s, der_g, con_s, con_g = [], [], [], []
    for mu in range(4):
        dp_t3 = covdev_apply(u, tmp3, mu, True, geom, mesh)
        dm_t3 = covdev_apply(u, tmp3, mu, False, geom, mesh)
        dp_x = covdev_apply(u, x, mu, True, geom, mesh)
        dm_x = covdev_apply(u, x, mu, False, geom, mesh)
        t0 = spin_outer_g5(x, dp_t3)
        t3 = spin_outer_g5(dm_x, tmp3)
        t2 = spin_outer_g5(dp_x, tmp3)
        t1 = spin_outer_g5(x, dm_t3)
        der_g.append(_lex16(t0 + t3 - t2 - t1, geom))
        con_g.append(_lex16(t0 + t3 + t2 + t1, geom))
        s0 = spin_outer_g5(x, dp_x)
        s3 = spin_outer_g5(dm_x, x)
        s2 = spin_outer_g5(dp_x, x)
        s1 = spin_outer_g5(x, dm_x)
        der_s.append(_lex16(s0 + s3 - s2 - s1, geom))
        con_s.append(_lex16(s0 + s3 + s2 + s1, geom))
    return LoopResult(std=std, gen=gen,
                      der_std=torch.stack(der_s), der_gen=torch.stack(der_g),
                      cons_std=torch.stack(con_s),
                      cons_gen=torch.stack(con_g))


def _partner_params(params: DiracParams, use_kernels: bool) -> DiracParams:
    return DiracParams(kind="clover" if params.has_clover else "wilson",
                       kappa=params.kappa, mu=0.0, csw=params.csw,
                       use_kernels=use_kernels)


def plain_wilson_partner(dirac: Dirac) -> Dirac:
    """The untwisted companion of ``dirac`` for the one-end trick (Wilson
    for twisted mass, clover for twisted clover): the same links, doubled
    links, clover term and, with ``use_kernels``, the same gauge channels
    (one cache), no clover inverse.  The partner of a ``ShardedDirac`` is
    the same box's, on its mesh."""
    p = _partner_params(dirac.params, dirac.params.use_kernels)
    clover = dirac.clover if p.has_clover else None
    if isinstance(dirac, ShardedDirac):
        out = ShardedDirac(dirac.u, p, dirac.geom, dirac.mesh,
                           dirac.global_geom, clover=clover,
                           u_doubled=dirac.u_doubled,
                           antiperiodic=dirac.antiperiodic)
    else:
        out = Dirac(dirac.u, p, dirac.geom, clover=clover,
                    u_doubled=dirac.u_doubled)
    out._ch_cache = dirac._ch_cache
    out._antiperiodic = dirac._antiperiodic
    return out


def plain_partner_from_gauge(u: torch.Tensor, params: DiracParams,
                             geom: Geometry) -> Dirac:
    """``plain_wilson_partner`` built from the gauge, for a solve
    operator that holds no canonical fields (``compact.CompactDirac``):
    the clover term without its inverse, and on the card the doubled
    links for K1."""
    p = _partner_params(params, u.device.type == "cuda")
    clover = (_cl.make_clover(u, geom, params.csw * params.kappa)
              if p.has_clover else None)
    return Dirac(u, p, geom, clover=clover,
                 u_doubled=double_gauge(u, geom) if p.use_kernels else None)


def add_loops(acc: LoopResult | None, res: LoopResult,
              sign: float = 1.0) -> LoopResult:
    """acc + sign·res, in place where ``acc`` is given."""
    if acc is None:
        return res if sign == 1.0 else LoopResult(*(-f for f in res))
    for a, r in zip(acc, res):
        a.add_(r, alpha=sign)
    return acc


def stochastic_loops(solve: Callable, gen: torch.Generator, dirac: Dirac,
                     geom: Geometry, n_sources: int,
                     dtype=torch.complex64) -> LoopResult:
    """The loops summed over ``n_sources`` Z4 sources drawn from ``gen``
    (normalise by ``n_sources`` downstream); ``solve(ξ) -> x``."""
    plain = plain_wilson_partner(dirac)
    acc = None
    for _ in range(n_sources):
        x = solve(z4_source(gen, geom, dtype))
        acc = add_loops(acc, one_end_trick(x, plain, geom))
    return acc
