"""The 2pt workflow: the counterpart of the JAX package's
``workflows.py`` (``run_twop``, the 2pt part of the reference's
``calcMG_threepTwop_EvenOdd``).  ``run_threep`` and the loops are
ROADMAP queue 1, item 3.

A source gives twelve Gaussian-smeared point sources (APE-smeared
links), one solve each for both twist flavours, the twisted → physical
rotation, and the meson and baryon contractions, projected onto the
momenta or kept in position space.  On the fused operator the twelve
columns of a flavour are one multi-source solve (``invert_msrc``: the
kernel K2 at n = 12 in the four-hop chain); an MG pair
(``mg_params``) solves them column by column with MG-GCR.

Operators (``make_operator``), the port's own rule: a gauge on the card
takes the fused chain (the CUDA kernels) in its own precision; a
complex64 one takes the compact channel operator instead where the
canonical bundle does not fit the card's free memory.  The multi-source
kernel K2 is float32 only, so a complex128 operator solves its columns
one at a time with the mixed CG: the outer loop on K1's float64
instance, the inner one on its float32 instance.  A gauge on the CPU
takes the plain operator.  The JAX package's gate (2.2 M sites) was a
rule for a 16 GB TPU.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from quda_qkxtm_multigrid_tpu_torch import fields
from quda_qkxtm_multigrid_tpu_torch.compact import CompactDirac, make_compact
from quda_qkxtm_multigrid_tpu_torch.dirac import DiracParams, make_dirac
from quda_qkxtm_multigrid_tpu_torch.invert import (
    invert, invert_msrc, true_residual)
from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry
from quda_qkxtm_multigrid_tpu_torch.ops.smear import ape_smear, gaussian_smear
from quda_qkxtm_multigrid_tpu_torch.physics import contract as con
from quda_qkxtm_multigrid_tpu_torch.physics.propagator import (
    assemble_prop, rotate_to_physical)

# Test hooks: None decides from the field (``_use_kernels``,
# ``_use_compact``); True / False forces the route, so the CPU tests
# reach the fused and compact operators through the plain versions.
_FORCE_KERNELS: Optional[bool] = None
_FORCE_COMPACT: Optional[bool] = None

MESH_REFUSAL = ("the meshed workflows are ROADMAP queue 1 item 7 "
                "('Multi-GPU, the rest'); run without mesh")


def _use_kernels(u: torch.Tensor) -> bool:
    """The fused chain for a gauge on the card, in either precision."""
    if _FORCE_KERNELS is not None:
        return _FORCE_KERNELS
    return u.device.type == "cuda"


def bundle_bytes(u: torch.Tensor, geom: Geometry) -> int:
    """Bytes of the canonical operator bundle in ``u``'s precision: the
    gauge, the doubled gauge, the clover and its inverse, 252 complex
    numbers a site (42.8 GB at 48³×96 in complex128)."""
    return 252 * u.element_size() * geom.volume


def _use_compact(u: torch.Tensor, geom: Geometry) -> bool:
    """The compact channel operator (bf16 tier) for a complex64 gauge
    whose canonical bundle does not fit the card's free memory."""
    if _FORCE_COMPACT is not None:
        return _FORCE_COMPACT
    if u.device.type != "cuda" or u.dtype != torch.complex64:
        return False
    free, _ = torch.cuda.mem_get_info(u.device)
    return bundle_bytes(u, geom) > free


def make_operator(u: torch.Tensor, params: DiracParams, geom: Geometry,
                  mesh=None):
    """The production operator on ``u``'s device (module docstring):
    ``compact.make_compact`` (bf16 tier) where a complex64 bundle does
    not fit, else ``make_dirac`` with ``use_kernels`` on the card and
    without on the CPU."""
    if mesh is not None:
        raise ValueError(MESH_REFUSAL)
    if _use_compact(u, geom):
        return make_compact(u, params, geom, dtype=torch.bfloat16)
    return make_dirac(u, dataclasses.replace(
        params, use_kernels=_use_kernels(u)), geom)


def _op_dtype(d) -> torch.dtype:
    """The spinor dtype of an operator, a ``Dirac`` or a
    ``CompactDirac``."""
    return d.field_dtype if isinstance(d, CompactDirac) else d.u.dtype


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def smeared_sources(u_ape: torch.Tensor, geom: Geometry, coords,
                    alpha: float, nsmear: int, dtype) -> torch.Tensor:
    """The twelve Gaussian-smeared point sources of ``coords``
    [12 (spin-major), 2, 4, 3, T, Z, W], smeared as one batch."""
    bs = torch.stack([fields.point_source_dyn(geom, coords, s, c, dtype,
                                              u_ape.device)
                      for s in range(4) for c in range(3)])
    return gaussian_smear(bs, u_ape, geom, alpha, nsmear)


def mg_solve_fn(mg, tol: float = 1e-8, n_krylov: int = 10,
                max_restarts: int = 50, mesh=None):
    """An MG preconditioner as a workflow solver b → (x, true_rel) (the
    reference's per-column GCR-MG solve); each solve appends its outer
    iterations to the returned function's ``iters``."""
    from quda_qkxtm_multigrid_tpu_torch.mg.multigrid import mg_solve
    if mesh is not None:
        raise ValueError(MESH_REFUSAL)

    def solve(b):
        out = mg_solve(mg, b, tol=tol, n_krylov=n_krylov,
                       max_restarts=max_restarts)
        solve.iters.append(out.iters)
        _, rel = true_residual(mg.dirac, out.x, b)
        return out.x, float(rel)
    solve.iters = []
    return solve


def _solve_columns_msrc(dirac, bs: torch.Tensor, tol: float, maxiter: int):
    """The twelve columns as one multi-source solve (``invert_msrc``; on
    the fused path K2 at n = 12): (solutions [12, 2, 4, 3, T, Z, W],
    the worst column's true residual, CG iterations)."""
    out = invert_msrc(dirac, bs, tol=tol, maxiter=maxiter)
    return out.x, out.true_res, out.iters


def forward_prop(dirac, u_ape, geom: Geometry, coords, alpha: float = 4.0,
                 nsmear: int = 50, tol: float = 1e-8, maxiter: int = 1000,
                 verbose: bool = False, solve_fn=None, columns=None,
                 sources: Optional[torch.Tensor] = None,
                 stats: Optional[dict] = None) -> torch.Tensor:
    """Twelve smeared-source solves → the propagator [2,4,4,3,3,T,Z,W].

    ``solve_fn``: b → (x, true_res) in place of the default solve (e.g.
    ``mg_solve_fn``).  The default is one multi-source solve of the
    twelve columns where the operator has the complex64 fused chain,
    else an ``invert`` a column: CG, or on the complex128 fused chain
    the mixed CG (float64 outer loop; K2 is float32 only).  ``columns`` solves only the first N
    columns and leaves the rest zero.  ``sources``: the twelve smeared
    sources when the caller has them (``smeared_sources``; ``run_twop``
    smears once for both flavours).  ``stats``, if given, receives the
    solver's iterations (``iters``), the true residuals (``true_res``:
    the worst column's, or one a column) and the solutions ``x``
    [12, 2, 4, 3, T, Z, W] before assembly."""
    if sources is None:
        sources = smeared_sources(u_ape, geom, coords, alpha, nsmear,
                                  _op_dtype(dirac))
    fused = getattr(dirac, "_has_fused_matpc", False)
    double = _op_dtype(dirac) == torch.complex128
    if columns is None and solve_fn is None and fused and not double:
        xs, res, iters = _solve_columns_msrc(dirac, sources, tol, maxiter)
        if verbose:
            print(f"  12-column msrc solve: {iters} iterations, "
                  f"true_res={res:.2e}")
        if stats is not None:
            stats.update(iters=iters, true_res=res, x=xs)
        return assemble_prop(xs)
    cols, iters, ress = [], [], []
    for i, b in enumerate(sources):
        if columns is not None and i >= columns:
            cols.append(torch.zeros_like(cols[0]))
            continue
        if solve_fn is None:
            out = invert(dirac, b, tol=tol, maxiter=maxiter,
                         solver="cg-mixed" if fused and double else "cg")
            x, res = out.x, out.true_res
            iters.append(out.iters)
        else:
            x, res = solve_fn(b)
        ress.append(float(res))
        if verbose:
            print(f"  column {i // 3}{i % 3}: true_res={float(res):.2e}")
        cols.append(x)
    xs = torch.stack(cols)
    if stats is not None:
        stats.update(iters=iters or list(getattr(solve_fn, "iters", [])),
                     true_res=ress, x=xs)
    return assemble_prop(xs)


def _contract(pu, pd, geom: Geometry, moms, source, space: str,
              t_batch: int = 4):
    """Mesons and baryons of the two propagators, ``t_batch`` timeslices
    at a time (the contraction is site-local; the baryon terms'
    intermediates grow with the batch), then to lexicographic order and,
    in momentum space, projected."""
    mes, bar = [], []
    for t0 in range(0, geom.T, t_batch):
        a = pu[..., t0:t0 + t_batch, :, :]
        b = pd[..., t0:t0 + t_batch, :, :]
        mes.append(con.meson_correlators(a, b))
        bar.append(con.baryon_correlators(a, b))
    mes_lex = con.corr_to_lex(torch.cat(mes, dim=-3), geom)
    bar_lex = con.corr_to_lex(torch.cat(bar, dim=-3), geom)
    if space == "position":
        return mes_lex, bar_lex
    return (con.momentum_project_dyn(mes_lex, geom, moms, source),
            con.momentum_project_dyn(bar_lex, geom, moms, source))


def run_twop(u: torch.Tensor, geom: Geometry, kappa: float, mu: float,
             csw: float, source=(0, 0, 0, 0), q_sq_max: int = 1,
             ape_alpha: float = 0.5, ape_n: int = 20,
             gauss_alpha: float = 4.0, gauss_n: int = 50,
             tol: float = 1e-8, maxiter: int = 1000, verbose: bool = False,
             mg_params=None, mg_gen: Optional[torch.Generator] = None,
             mesh=None, corr_space: str = "momentum", columns=None,
             stats: Optional[dict] = None) -> dict:
    """Point-source 2pt workflow on the gauge ``u`` (its device and
    precision): both twist flavours, mesons and baryons.  Returns a dict
    of ``mesons`` [10, 2, T, nmom] and ``baryons`` [10, 2, 4, 4, T,
    nmom] (``corr_space="position"``: [..., T, Z, Y, X]), ``moms``,
    ``prop_up`` / ``prop_dn`` (physical basis), ``u_ape``, ``mg_pair``
    and ``corr_space``, as the JAX package's ``run_twop``.

    ``mg_params``: an ``mg.multigrid.MGParams``; the pair of
    preconditioners (``setup_mg_pair``, null vectors drawn from
    ``mg_gen``, default a generator on ``u``'s device seeded 0) solves
    all 24 columns.  A compact operator has no MG (raises), nor has
    ``mesh`` a workflow yet (raises).  ``stats``, if given, receives
    the host seconds of each stage (``secs``: ape, operators, smear,
    mg_setup, solve, rotate, contract; the device synchronised around
    each), each flavour's ``forward_prop`` stats under "up" / "dn", the
    smeared ``sources`` and the MG setup split."""
    if mesh is not None:
        raise ValueError(MESH_REFUSAL)
    if corr_space not in ("momentum", "position"):
        raise ValueError(f"corr_space {corr_space!r}: 'momentum' or "
                         "'position'")
    dev = u.device
    secs = {}
    clock = [time.perf_counter()]

    def lap(name):
        _sync(dev)
        now = time.perf_counter()
        secs[name] = secs.get(name, 0.0) + now - clock[0]
        clock[0] = now

    kind = "twisted-clover" if csw != 0.0 else "twisted-mass"
    u_ape = ape_smear(u, geom, ape_alpha, ape_n)
    lap("ape")
    diracs = {name: make_operator(u, DiracParams(
        kind=kind, kappa=kappa, mu=mu, csw=csw, flavor=flavor), geom)
        for name, flavor in (("up", +1), ("dn", -1))}
    lap("operators")
    if mg_params is not None and isinstance(diracs["up"], CompactDirac):
        raise ValueError(
            "MG setup needs the full Dirac bundle; this volume routed to "
            "the compact operator (the card's memory) — run without "
            "mg_params")
    sources = smeared_sources(u_ape, geom, source, gauss_alpha, gauss_n,
                              _op_dtype(diracs["up"]))
    lap("smear")
    solve_fns = {"up": None, "dn": None}
    mg_pair = None
    if mg_params is not None:
        from quda_qkxtm_multigrid_tpu_torch.mg.multigrid import setup_mg_pair
        gen = mg_gen if mg_gen is not None else torch.Generator(
            device=dev).manual_seed(0)
        mg_pair = setup_mg_pair(diracs["up"], diracs["dn"], mg_params, gen)
        solve_fns = {"up": mg_solve_fn(mg_pair[0], tol=tol),
                     "dn": mg_solve_fn(mg_pair[1], tol=tol)}
        lap("mg_setup")
    props, flavour_stats = {}, {}
    for name, flavor in (("up", +1), ("dn", -1)):
        st = {} if stats is not None else None
        p = forward_prop(diracs[name], u_ape, geom, source, gauss_alpha,
                         gauss_n, tol, maxiter, verbose,
                         solve_fn=solve_fns[name], columns=columns,
                         sources=sources, stats=st)
        lap("solve")
        props[name] = rotate_to_physical(p, sign=flavor)
        del p
        lap("rotate")
        flavour_stats[name] = st
    moms = con.momentum_list(q_sq_max)
    mes, bar = _contract(props["up"], props["dn"], geom, moms, source,
                         corr_space)
    lap("contract")
    if stats is not None:
        stats.update(secs=secs, sources=sources, **flavour_stats)
        if mg_pair is not None:
            stats["mg_setup"] = [m.setup_stats for m in mg_pair]
    return {"mesons": mes, "baryons": bar, "moms": moms,
            "prop_up": props["up"], "prop_dn": props["dn"], "u_ape": u_ape,
            "mg_pair": mg_pair, "corr_space": corr_space}
