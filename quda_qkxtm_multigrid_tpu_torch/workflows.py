"""The physics workflows: the counterpart of the JAX package's
``workflows.py``, the reference's drivers:

  run_twop          the 2pt part of ``calcMG_threepTwop_EvenOdd``
  run_threep        its fixed-sink 3pt part
  run_loops         ``calcMG_loop_wOneD_TSM_EvenOdd`` (TSM loops)
  run_loops_wexact  ``calcMG_loop_wOneD_TSM_wExact`` (deflated loops)

A source gives twelve Gaussian-smeared point sources (APE-smeared
links), one solve each for both twist flavours, the twisted → physical
rotation, and the meson and baryon contractions, projected onto the
momenta or kept in position space.  On the fused operator the twelve
columns of a flavour are one multi-source solve (``invert_msrc``: the
kernel K2 at n = 12 in the four-hop chain); an MG pair
(``mg_params``) solves them column by column with MG-GCR.  The 3pt's
twelve sequential columns of a (projector, part) go the same way, with
the opposite flavour.  The loops solve one Z4 source at a time
(``invert``: K1's chain) and contract it with the untwisted partner
(``physics.loops``); the deflated loops run thick-restart Lanczos
(``solvers.eigen``) on the operator's normal form.

Operators (``make_operator``), the port's own rule: a gauge on the card
takes the fused chain (the CUDA kernels) in its own precision; a
complex64 one takes the compact channel operator instead where the
canonical bundle does not fit the card's free memory.  The multi-source
kernel K2 is float32 only, so a complex128 operator solves its columns
one at a time with the mixed CG: the outer loop on K1's float64
instance, the inner one on its float32 instance.  A gauge on the CPU
takes the plain operator.  The JAX package's gate (2.2 M sites) was a
rule for a 16 GB TPU.

With ``mesh`` (a t-ring or a (Gt, Gz, Gw) grid,
``parallel.mesh.LatticeMesh``) every workflow runs sharded: each rank
takes its box of the gauge (the whole gauge given is read once and not
kept; a box is taken as it is), builds its box of the operator from it
(``make_operator(mesh=…)``, through
``parallel.sharded.make_sharded_dirac``), solves each column through
``invert(mesh=…)`` (the sharded chain's CG, its ``cg-mixed`` in
complex128, or the plain sharded CG off the card) or the pair of MG
preconditioners set up on the boxes, and joins the correlators and
loops whole on every rank (the momentum projection with the sites'
global coordinates, summed over the spatial ranks; the loops' FFT over
the spatial ranks of each t row).  No field that a rank keeps has the
whole lattice's extent on a split axis: the propagators and smeared
links come back as boxes, and the one whole field made on a rank is a
source or noise vector drawn from a generator, cut at once (so a grid
draws the unsharded numbers).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

import torch

from quda_qkxtm_multigrid_tpu_torch import fields
from quda_qkxtm_multigrid_tpu_torch.compact import CompactDirac, make_compact
from quda_qkxtm_multigrid_tpu_torch.dirac import DiracParams, make_dirac
from quda_qkxtm_multigrid_tpu_torch.invert import (
    invert, invert_msrc, true_residual)
from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry
from quda_qkxtm_multigrid_tpu_torch.ops.gamma import apply_gamma5
from quda_qkxtm_multigrid_tpu_torch.ops.smear import ape_smear, gaussian_smear
from quda_qkxtm_multigrid_tpu_torch.parallel.mesh import (
    box_slab, local_geometry)
from quda_qkxtm_multigrid_tpu_torch.parallel.sharded import (
    ShardedDirac, make_sharded_dirac)
from quda_qkxtm_multigrid_tpu_torch.physics import contract as con
from quda_qkxtm_multigrid_tpu_torch.physics import loops as lp
from quda_qkxtm_multigrid_tpu_torch.physics import threept as tp
from quda_qkxtm_multigrid_tpu_torch.physics.propagator import (
    assemble_prop, rotate_to_physical, smear_propagator)
from quda_qkxtm_multigrid_tpu_torch.solvers import eigen
from quda_qkxtm_multigrid_tpu_torch.solvers.cg import cg
from quda_qkxtm_multigrid_tpu_torch.solvers.eigen import (
    deflate_guess, lanczos, project_out, spectrum_bounds)
from quda_qkxtm_multigrid_tpu_torch.utils.rng import z4_source

# Test hooks: None decides from the field (``_use_kernels``,
# ``_use_compact``); True / False forces the route, so the CPU tests
# reach the fused and compact operators through the plain versions.
_FORCE_KERNELS: Optional[bool] = None
_FORCE_COMPACT: Optional[bool] = None


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
    without on the CPU.  With ``mesh`` (a process grid), this rank's box of
    that operator, built from this rank's box of ``u`` (``u`` the whole
    gauge or the box; ``parallel.sharded.make_sharded_dirac``)."""
    if mesh is not None:
        return make_sharded_dirac(_slab(u, geom, mesh), dataclasses.replace(
            params, use_kernels=_use_kernels(u)), geom, mesh)
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


def _stage_clock(device, secs: dict):
    """A function ``lap(name)`` that adds the host seconds since the last
    lap (the device synchronised) to ``secs[name]``."""
    clock = [time.perf_counter()]

    def lap(name):
        _sync(device)
        now = time.perf_counter()
        secs[name] = secs.get(name, 0.0) + now - clock[0]
        clock[0] = now
    return lap


def _check_space(corr_space: str):
    if corr_space not in ("momentum", "position"):
        raise ValueError(f"corr_space {corr_space!r}: 'momentum' or "
                         "'position'")


def _solver(dirac) -> str:
    """``invert``'s solver for a column: CG, or the mixed CG on the
    complex128 fused chain, sharded or not (its float64 outer loop
    certifies the tolerance; the plain "cg" runs the chain in
    float32)."""
    fused = (dirac.has_sharded_chain if isinstance(dirac, ShardedDirac)
             else getattr(dirac, "_has_fused_matpc", False))
    return ("cg-mixed" if fused and _op_dtype(dirac) == torch.complex128
            else "cg")


def _slab(f: torch.Tensor, geom: Geometry, mesh) -> torch.Tensor:
    """This rank's box (trailing [T, Z, W]) of ``f``, a field of the whole
    lattice ``geom`` or already this rank's box, on the mesh's device."""
    lat = tuple(f.shape[-3:])
    if lat == geom.lat_shape:
        return box_slab(f, mesh)
    loc = local_geometry(geom, mesh).lat_shape
    if lat != loc:
        raise ValueError(f"a field with the lattice axes {lat} is neither "
                         f"the whole lattice's {geom.lat_shape} nor this "
                         f"rank's box {loc}")
    return f.to(mesh.device)


def _slabs(mesh, geom: Geometry, *fields):
    """(the local geometry, each field's box by ``_slab``) on ``mesh``, or
    (``geom``, the fields) when ``mesh`` is None."""
    if mesh is None:
        return (geom,) + fields
    return (local_geometry(geom, mesh),) + tuple(
        _slab(f, geom, mesh) for f in fields)


def smeared_sources(u_ape: torch.Tensor, geom: Geometry, coords,
                    alpha: float, nsmear: int, dtype,
                    mesh=None) -> torch.Tensor:
    """The twelve Gaussian-smeared point sources of ``coords``
    [12 (spin-major), 2, 4, 3, T, Z, W], smeared as one batch.  With
    ``mesh``: this rank's boxes, the point made on the rank whose box
    holds its global coordinates, at its local ones, and smeared over
    ``u_ape``, the box's smeared links, by every rank of the source's t
    rows (the smearing is spatial: its z and y hops cross ranks); the
    ranks of other t rows hold zeros."""
    dev = u_ape.device
    if mesh is not None:
        x, y, z, t = (int(c) for c in coords)
        firsts = [mesh.box_range(a, n)[0]
                  for a, n in enumerate((geom.T, geom.Z, geom.Y))]
        geom = local_geometry(geom, mesh)
        local = (x, y - firsts[2], z - firsts[1], t - firsts[0])
        if not 0 <= local[3] < geom.T:
            return torch.zeros((12, 2, 4, 3) + geom.lat_shape, dtype=dtype,
                               device=dev)
        # the box's origin is even: its local sites keep their parity
        if 0 <= local[1] < geom.Y and 0 <= local[2] < geom.Z:
            bs = torch.stack([fields.point_source_dyn(geom, local, s, c,
                                                      dtype, dev)
                              for s in range(4) for c in range(3)])
        else:
            bs = torch.zeros((12, 2, 4, 3) + geom.lat_shape, dtype=dtype,
                             device=dev)
        return gaussian_smear(bs, u_ape, geom, alpha, nsmear, mesh=mesh)
    bs = torch.stack([fields.point_source_dyn(geom, coords, s, c, dtype, dev)
                      for s in range(4) for c in range(3)])
    return gaussian_smear(bs, u_ape, geom, alpha, nsmear)


def mg_solve_fn(mg, tol: float = 1e-8, n_krylov: int = 10,
                max_restarts: int = 50, mesh=None):
    """An MG preconditioner as a workflow solver b → (x, true_rel) (the
    reference's per-column GCR-MG solve); each solve appends its outer
    iterations to the returned function's ``iters``.  ``mesh``: ``mg`` is
    a sharded preconditioner on that grid (``setup_mg`` on a
    ``ShardedDirac``, or ``shard_mg``'s) and b this rank's box."""
    from quda_qkxtm_multigrid_tpu_torch.mg.multigrid import mg_solve

    def solve(b):
        out = mg_solve(mg, b, tol=tol, n_krylov=n_krylov,
                       max_restarts=max_restarts, mesh=mesh)
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
    if columns is None and solve_fn is None and _solver(dirac) == "cg" \
            and getattr(dirac, "_has_fused_matpc", False):
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
                         solver=_solver(dirac),
                         mesh=getattr(dirac, "mesh", None))
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
              t_batch: int = 4, mesh=None, whole=None):
    """Mesons and baryons of the two propagators, ``t_batch`` timeslices
    at a time (the contraction is site-local; the baryon terms'
    intermediates grow with the batch), then to lexicographic order and,
    in momentum space, projected.  With ``mesh`` the propagators are this
    rank's boxes (``geom`` the box's, ``whole`` the lattice's; the
    phases take the global coordinates), and the correlators come back
    whole (``physics.contract.t_gather``)."""
    mes, bar = [], []
    for t0 in range(0, geom.T, t_batch):
        a = pu[..., t0:t0 + t_batch, :, :]
        b = pd[..., t0:t0 + t_batch, :, :]
        mes.append(con.meson_correlators(a, b))
        bar.append(con.baryon_correlators(a, b))
    out = []
    for c in (torch.cat(mes, dim=-3), torch.cat(bar, dim=-3)):
        lex = con.corr_to_lex(c, geom)
        if space == "momentum":
            lex = con.momentum_project_dyn(lex, geom, moms, source,
                                           con.box_of(whole, mesh))
        out.append(con.t_gather(lex, mesh, space))
    return tuple(out)


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
    all 24 columns.  A compact operator has no MG (raises).  ``stats``,
    if given, receives the host seconds of each stage (``secs``: ape,
    operators, smear, mg_setup, solve, rotate, contract; the device
    synchronised around each), each flavour's ``forward_prop`` stats
    under "up" / "dn", the smeared ``sources`` and the MG setup split.

    ``mesh`` (a process grid, ``parallel.mesh.TMesh``; ``u`` the whole gauge or
    this rank's box): each rank runs the workflow on its box.  APE
    and the Gaussian smearing are spatial, so box-local; the point
    sources are made on the box; every column solves through
    ``invert(mesh=…)`` on the rank's ``make_operator(mesh=…)``, or with
    ``mg_params`` through ``mg_solve(mesh=…)`` on the pair set up on the
    boxes (``setup_mg_pair`` on the sharded operators).  The contraction
    runs on the box and the correlators come back whole on every rank;
    the propagators, ``u_ape`` and ``stats``' fields are the rank's
    boxes (``run_threep`` and ``run_loops`` take them so)."""
    _check_space(corr_space)
    dev = u.device
    secs = {}
    lap = _stage_clock(dev, secs)
    kind = "twisted-clover" if csw != 0.0 else "twisted-mass"
    geom_l, u_l = _slabs(mesh, geom, u)
    u_ape = ape_smear(u_l, geom_l, ape_alpha, ape_n, mesh=mesh)
    lap("ape")
    diracs = {name: make_operator(u_l, DiracParams(
        kind=kind, kappa=kappa, mu=mu, csw=csw, flavor=flavor), geom,
        mesh=mesh)
        for name, flavor in (("up", +1), ("dn", -1))}
    lap("operators")
    if mg_params is not None and isinstance(diracs["up"], CompactDirac):
        raise ValueError(
            "MG setup needs the full Dirac bundle; this volume routed to "
            "the compact operator (the card's memory) — run without "
            "mg_params")
    sources = smeared_sources(u_ape, geom, source, gauss_alpha, gauss_n,
                              _op_dtype(diracs["up"]), mesh=mesh)
    lap("smear")
    solve_fns = {"up": None, "dn": None}
    mg_pair = None
    if mg_params is not None:
        from quda_qkxtm_multigrid_tpu_torch.mg.multigrid import setup_mg_pair
        gen = mg_gen if mg_gen is not None else torch.Generator(
            device=dev).manual_seed(0)
        mg_pair = setup_mg_pair(diracs["up"], diracs["dn"], mg_params, gen)
        solve_fns = {"up": mg_solve_fn(mg_pair[0], tol=tol, mesh=mesh),
                     "dn": mg_solve_fn(mg_pair[1], tol=tol, mesh=mesh)}
        lap("mg_setup")
    props, flavour_stats = {}, {}
    for name, flavor in (("up", +1), ("dn", -1)):
        st = {} if stats is not None else None
        p = forward_prop(diracs[name], u_ape, geom_l, source, gauss_alpha,
                         gauss_n, tol, maxiter, verbose,
                         solve_fn=solve_fns[name], columns=columns,
                         sources=sources, stats=st)
        lap("solve")
        props[name] = rotate_to_physical(p, sign=flavor)
        del p
        lap("rotate")
        flavour_stats[name] = st
    moms = con.momentum_list(q_sq_max)
    mes, bar = _contract(props["up"], props["dn"], geom_l, moms, source,
                         corr_space, mesh=mesh, whole=geom)
    lap("contract")
    if stats is not None:
        stats.update(secs=secs, sources=sources, **flavour_stats)
        if mg_pair is not None:
            stats["mg_setup"] = [m.setup_stats for m in mg_pair]
    return {"mesons": mes, "baryons": bar, "moms": moms,
            "prop_up": props["up"], "prop_dn": props["dn"], "u_ape": u_ape,
            "mg_pair": mg_pair, "corr_space": corr_space}


def _sink_timeslice(prop, u_ape, geom: Geometry, t: int, alpha: float,
                    n: int, mesh=None):
    """The sink-smeared propagator's timeslice t in lexicographic order
    [4, 4, 3, 3, Z, Y, X], smearing that timeslice alone (the Gaussian
    hop is spatial; ``mesh``: across the ranks of the box's t rows)."""
    p_t = smear_propagator(prop[..., t:t + 1, :, :], u_ape, geom, alpha, n,
                           t0=t, mesh=mesh)
    return tp.timeslice_to_lex(p_t[..., 0, :, :], geom, t)


def _pow2_scale(t: Optional[torch.Tensor], mesh=None) -> float:
    """The power of two that brings ``t``'s largest entry to [1, 2):
    multiplying by it is exact, and every solve and smearing step is
    linear, so scaling a source and unscaling the solution changes no
    bit of the result unless the unscaled one had underflowed.  With
    ``mesh``: the largest entry over every rank (``t`` None where a rank
    holds none of it)."""
    m = 0.0 if t is None else float(t.abs().max())
    if mesh is not None:
        m = float(mesh.allmax(torch.tensor(m, dtype=torch.float64,
                                           device=mesh.device)))
    if m == 0.0 or not math.isfinite(m):
        return 1.0
    return 2.0 ** -math.floor(math.log2(m))


def _seq_sources(seq, u_ape, geom: Geometry, t: int, alpha: float,
                 n: int, mesh=None) -> torch.Tensor:
    """The twelve solves' sources of a sequential source [4(q), 3(s), 4,
    3, Z, Y, X]: γ5, Gaussian smearing of the sink timeslice alone
    (``mesh`` as in ``_sink_timeslice``), and the full fields [12, 2, 4,
    3, T, Z, W], zero off the timeslice."""
    ts = tp.timeslice_sources(seq, geom, t).reshape(
        (12, 2, 4, 3, 1, geom.Z, geom.W))
    ts = gaussian_smear(apply_gamma5(ts), u_ape, geom, alpha, n, t0=t,
                        mesh=mesh)
    full = torch.zeros((12, 2, 4, 3) + geom.lat_shape, dtype=ts.dtype,
                       device=ts.device)
    full[..., t:t + 1, :, :] = ts
    return full


def run_threep(u: torch.Tensor, geom: Geometry, kappa: float, mu: float,
               csw: float, prop_up: torch.Tensor, prop_dn: torch.Tensor,
               u_ape: torch.Tensor, tsink: int, source=(0, 0, 0, 0),
               projectors=("G4",), particle: int = tp.PROTON,
               q_sq_max: int = 1, gauss_alpha: float = 4.0,
               gauss_n: int = 50, tol: float = 1e-8, maxiter: int = 1000,
               mg_pair=None, mesh=None, corr_space: str = "momentum",
               stats: Optional[dict] = None) -> dict:
    """Fixed-sink 3pt workflow for one sink time on ``run_twop``'s
    propagators (physical basis) and APE-smeared links: for each
    projector and flavour part the sequential source, its twelve
    columns solved with the opposite twist (``forward_prop``: on the
    complex64 fused chain one multi-source solve through K2; with
    ``mg_pair``, ``run_twop``'s pair, the opposite flavour's MG-GCR a
    column), and the fixSink contractions against ``prop_up`` (both
    parts, as the JAX package), projected with e^{+ip·x}.  Returns
    {"thrp": {proj: {"part1" | "part2": {"ultra_local" [16, T, nmom],
    "noether" [4, T, nmom], "oneD" [16, 4, T, nmom]}}}, "moms",
    "corr_space"} ([..., T, Z, Y, X] in position space), complex128
    whatever the fields' precision: the sequential source is solved and
    contracted as a power-of-two multiple (``_pow2_scale``), whose scale
    comes off in complex128 (a complex64 3pt at t_sink = 12 on a hot
    32³×64 gauge, ~1e-36, would fall below float32's normal range).

    One operator a flavour serves every projector.  ``stats``, if given,
    receives the host seconds of each stage (``secs``: smear, seq_source,
    operators, solve, fixsink; the device synchronised) and, under
    ``(projector, part)``, the solve's ``forward_prop`` stats with its
    ``sources`` and ``flavor`` (the sources and solutions of the scaled
    sequential source, and its ``scale``).

    ``mesh`` (a process grid; ``u``, ``u_ape`` and the propagators each whole
    or this rank's box, as the meshed ``run_twop`` returns them): each
    rank works on its boxes.  The sink timeslice and
    its sequential sources live on the rank that holds ``tsink`` (the
    other ranks hold zeros there, and the scale is summed over the
    ring); the columns solve through ``invert(mesh=…)`` (or the
    sharded pair's ``mg_solve(mesh=…)``); the t shifts of the
    insertions cross ranks; the results come back whole on every rank."""
    _check_space(corr_space)
    dev = u.device
    secs = {}
    lap = _stage_clock(dev, secs)
    kind = "twisted-clover" if csw != 0.0 else "twisted-mass"
    moms = con.momentum_list(q_sq_max)
    geom_l, u_l, u_ape, prop_up, prop_dn = _slabs(mesh, geom, u, u_ape,
                                                  prop_up, prop_dn)
    t_first, t_loc = (0, geom.T) if mesh is None else mesh.t_range(geom.T)
    owner = t_first <= tsink < t_first + t_loc
    ts = tsink - t_first
    sink = None
    if owner:
        sink = {name: _sink_timeslice(p, u_ape, geom_l, ts, gauss_alpha,
                                      gauss_n, mesh)
                for name, p in (("up", prop_up), ("dn", prop_dn))}
    lap("smear")

    def project(c, scale):
        lex = con.corr_to_lex(c, geom_l)
        if corr_space == "momentum":
            lex = con.momentum_project_dyn(lex, geom_l, -moms, source,
                                           con.box_of(geom, mesh))
        return con.t_gather(lex, mesh, corr_space).to(torch.complex128) \
            / scale

    ops, results = {}, {}
    for proj_name in projectors:
        proj = tp.projector(proj_name, particle)
        results[proj_name] = {}
        for partflag in (1, 2):
            bs, seq = None, None
            if owner:
                seq = (tp.seq_source_part1(sink["up"], sink["dn"], proj)
                       if partflag == 1 else tp.seq_source_part2(sink["up"],
                                                                 proj))
                lap("seq_source")
            # a sequential source is ~|S(t_sink)|², whose |r|² far from
            # the source underflows float32: smear, solve and contract a
            # power-of-two multiple (the reference scales by 1e10) and
            # take the scale off in complex128, where the 3pt (~1e-36 at
            # t_sink = 12 on a hot 32³×64 gauge) keeps its digits; on a
            # mesh the scale of the largest entry of every rank's part
            scale = _pow2_scale(seq, mesh)
            if owner:
                bs = _seq_sources(seq * scale, u_ape, geom_l, ts,
                                  gauss_alpha, gauss_n, mesh)
                del seq
            elif mesh is not None:
                bs = torch.zeros((12, 2, 4, 3) + geom_l.lat_shape,
                                 dtype=prop_up.dtype, device=prop_up.device)
            lap("smear")
            # the opposite twist: part 1 of the proton solves with the
            # minus flavour
            flavor = -particle if partflag == 1 else +particle
            if mg_pair is not None:
                mg = mg_pair[0 if flavor > 0 else 1]
                d, solve_fn = mg.dirac, mg_solve_fn(mg, tol=tol, mesh=mesh)
            else:
                if flavor not in ops:
                    ops[flavor] = make_operator(u_l, DiracParams(
                        kind=kind, kappa=kappa, mu=mu, csw=csw,
                        flavor=flavor), geom, mesh=mesh)
                    lap("operators")
                d, solve_fn = ops[flavor], None
            st = {} if stats is not None else None
            seqprop = forward_prop(d, u_ape, geom_l, source, tol=tol,
                                   maxiter=maxiter, solve_fn=solve_fn,
                                   sources=bs, stats=st)
            lap("solve")
            loc, noe, oned = tp.fixsink_all(seqprop, prop_up, u_l, geom_l,
                                            particle, partflag, mesh=mesh)
            del seqprop
            results[proj_name][f"part{partflag}"] = {
                "ultra_local": project(loc, scale),
                "noether": project(noe, scale), "oneD": project(oned, scale)}
            del loc, noe, oned
            lap("fixsink")
            if stats is not None:
                stats[(proj_name, partflag)] = dict(st, sources=bs,
                                                    flavor=flavor,
                                                    scale=scale)
            del bs
    if stats is not None:
        stats["secs"] = secs
    return {"thrp": results, "moms": moms, "corr_space": corr_space}


# the reference's loop types (qudaQKXTM_Kepler_utils.h) and the
# LoopResult fields that hold them
LOOP_NAMES = {"Scalar": "std", "dOp": "gen", "LpsDw": "der_std",
              "LpsDwCv": "der_gen", "Loops": "cons_std",
              "LoopsCv": "cons_gen"}


def _finalize_loops(first, n_first: float, second, n_second: float,
                    mesh=None) -> dict:
    """{type: fft_project(first / n_first + second / n_second)}, the
    second term left out where ``second`` is None; with ``mesh``, each
    rank's box gathered over its spatial ranks, transformed, and the t
    rows joined whole (``physics.contract.fft_join``)."""
    out = {}
    for name, field in LOOP_NAMES.items():
        a = getattr(first, field) / n_first
        if second is not None:
            a = a + getattr(second, field) / n_second
        out[name] = con.fft_join(a, mesh)
    return out


def _loop_partner(d, u: torch.Tensor, geom: Geometry):
    if isinstance(d, CompactDirac):
        return lp.plain_partner_from_gauge(u, d.params, geom)
    return lp.plain_wilson_partner(d)


def run_loops(u: torch.Tensor, geom: Geometry, kappa: float, mu: float,
              csw: float, n_stoch: int, gen: torch.Generator,
              tol: float = 1e-8, maxiter: int = 1000,
              tol_lp: Optional[float] = None, n_hp: int = 0, mesh=None,
              stats: Optional[dict] = None) -> dict:
    """Stochastic disconnected loops with the truncated solver method:
    ``n_stoch`` solves to ``tol_lp`` (default ``tol``) plus ``n_hp``
    pairs of solves of one source each, to ``tol`` and to ``tol_lp``,
    whose difference corrects the bias.  Z4 sources from ``gen`` (a
    generator on ``u``'s device), one a sample or a pair.  Returns
    {loop type: its FFT over space} of the mean sample (``LOOP_NAMES``).

    The solve operator is ``make_operator``'s (a ``CompactDirac`` takes
    ``plain_partner_from_gauge``); each solve is one ``invert`` (CG, the
    mixed CG on the complex128 fused chain).  ``stats``, if given,
    receives the seconds of each stage (``secs``: operators, solve,
    one_end, finalize) and, under ``hp``, each pair's (source,
    high-precision solution, its true residual, iterations), and the
    ``partner``.

    ``mesh`` (a process grid; ``u`` whole or this rank's box, ``gen`` in the
    same state on every rank): each rank solves and contracts its box.
    The noise is drawn on the whole lattice and cut, so a grid gives
    the unsharded numbers; the partner is the sharded operator's
    (``plain_wilson_partner``), the one-end trick's t shifts cross
    ranks, and the loops come back whole on every rank (``stats``' fields
    are the rank's boxes)."""
    dev = u.device
    secs = {}
    lap = _stage_clock(dev, secs)
    kind = "twisted-clover" if csw != 0.0 else "twisted-mass"
    geom_l, u_l = _slabs(mesh, geom, u)
    d = make_operator(u_l, DiracParams(kind=kind, kappa=kappa, mu=mu,
                                       csw=csw), geom, mesh=mesh)
    plain = _loop_partner(d, u_l, geom_l)
    lap("operators")
    solve_tol = tol_lp if tol_lp is not None else tol

    def noise():
        return _slabs(mesh, geom, z4_source(gen, geom, u.dtype))[1]

    def sample(xi, stol, smax):
        out = invert(d, xi, tol=stol, maxiter=smax, solver=_solver(d),
                     mesh=mesh)
        lap("solve")
        res = lp.one_end_trick(out.x, plain, geom_l)
        lap("one_end")
        return out, res

    acc = None
    for _ in range(n_stoch):
        _, res = sample(noise(), solve_tol, maxiter)
        acc = lp.add_loops(acc, res)
    corr, hp = None, []
    for _ in range(n_hp):
        # TSM bias correction: the same noise, solved twice
        xi = noise()
        hi_out, hi = sample(xi, tol, 4 * maxiter)
        _, lo = sample(xi, solve_tol, maxiter)
        corr = lp.add_loops(corr, lp.add_loops(hi, lo, -1.0))
        if stats is not None:
            hp.append((xi, hi_out.x, hi_out.true_res, hi_out.iters))
        del hi, lo, hi_out
    out = _finalize_loops(acc, n_stoch, corr, max(n_hp, 1), mesh)
    lap("finalize")
    if stats is not None:
        stats.update(secs=secs, hp=hp, partner=plain)
    return out


def run_loops_wexact(u: torch.Tensor, geom: Geometry, kappa: float,
                     mu: float, csw: float, nev: int, n_stoch: int,
                     gen: torch.Generator, tol: float = 1e-8,
                     maxiter: int = 1000, ncv: Optional[int] = None,
                     lanczos_tol: float = 1e-6, full_op: bool = False,
                     cheb_degree: int = 0, mesh=None,
                     stats: Optional[dict] = None):
    """Disconnected loops with exact low-mode deflation (the reference's
    ``calcMG_loop_wOneD_TSM_wExact``): thick-restart Lanczos for the
    ``nev`` lowest modes of the normal operator, each mode's exact
    contribution through the one-end trick, and ``n_stoch`` Z4 samples
    from ``gen`` of the remainder with the sources projected out of the
    deflation space.  ``full_op=False``: the even-odd M_pc†M_pc
    (``matpc_dagm``), the remainder by CG with ``deflate_guess`` as its
    start; ``full_op=True``: the full M†M on full fields.  The CG runs
    on the operator in its own precision (on the complex128 fused chain
    K1's float64 instance).  Returns (loops, ``EigResult``).

    ``cheb_degree`` > 0 runs Lanczos on the Chebyshev filter of that
    degree (the reference's polynomial acceleration; the JAX package
    has none), its interval from ``solvers.eigen.spectrum_bounds``: one
    unfiltered cycle of ``ncv`` steps.  Lanczos (and the bounds' cycle)
    draw their start vectors from ``gen`` first.  ``stats``, if given,
    receives the Lanczos ``stats`` (``eig``, with ``bounds``), the CG
    iterations of each sample (``cg_iters``) and the seconds of each
    stage (``secs``: operators, lanczos, exact, stochastic,
    finalize).

    ``mesh`` (a process grid; ``u`` whole or this rank's box, ``gen`` in the
    same state on every rank): the Lanczos runs on the rank's box of
    the normal operator (``ShardedDirac.matpc_dagm`` or ``mdagm``, its
    hops K4 in the fields' precision), every inner product summed over
    the grid (``solvers.eigen``, ``allreduce=``); its start vectors and
    the noise are drawn whole from ``gen`` and cut, so a grid takes
    the unsharded draws.  The modes' contributions and the stochastic
    remainder (the sharded CG from ``deflate_guess``) go through the
    sharded one-end trick, and the loops come back whole on every rank,
    as ``run_loops(mesh=…)`` returns them; the returned ``EigResult``
    holds the rank's boxes of the modes."""
    dev = u.device
    secs = {}
    lap = _stage_clock(dev, secs)
    kind = "twisted-clover" if csw != 0.0 else "twisted-mass"
    geom_l, u_l = _slabs(mesh, geom, u)
    d = make_operator(u_l, DiracParams(kind=kind, kappa=kappa, mu=mu,
                                       csw=csw), geom, mesh=mesh)
    plain = _loop_partner(d, u_l, geom_l)
    lap("operators")
    red = None if mesh is None else mesh.allreduce
    example = fields.zeros_spinor(geom_l, dtype=u.dtype, device=dev)
    normal_op = d.mdagm if full_op else d.matpc_dagm
    if not full_op:
        example = example[0]

    def start():
        """The start vector on a mesh: drawn whole, this rank's box."""
        if mesh is None:
            return None
        whole = torch.zeros((), dtype=u.dtype, device=dev).expand(
            example.shape[:-3] + geom.lat_shape)
        return _slab(eigen._start_vector(whole, gen), geom, mesh)

    eig_stats, cheb = {}, None
    if cheb_degree > 0:
        bounds = spectrum_bounds(normal_op, example, nev,
                                 steps=ncv or 2 * nev + 8, gen=gen,
                                 allreduce=red, v0=start())
        cheb = bounds + (cheb_degree,)
        eig_stats["bounds"] = bounds
    eig = lanczos(normal_op, example, nev=nev, ncv=ncv, tol=lanczos_tol,
                  gen=gen, stats=eig_stats, chebyshev=cheb, allreduce=red,
                  v0=start())
    lap("lanczos")
    acc = None
    for vec, lam in zip(eig.evecs, eig.evals):
        # M⁻¹ v = M† (M†M)⁻¹ v = M† v / λ for a mode of the normal
        # operator; the even-odd mode embeds through reconstruct
        if full_op:
            x = d.mdag(vec) / lam.to(vec.dtype)
        else:
            x_pc = d.matpc(vec, dagger=True) / lam.to(vec.dtype)
            x = d.reconstruct(x_pc, torch.stack([vec, torch.zeros_like(vec)]))
        acc = lp.add_loops(acc, lp.one_end_trick(x, plain, geom_l))
    lap("exact")
    stoch, iters = None, []
    for _ in range(n_stoch):
        xi = _slabs(mesh, geom, z4_source(gen, geom, u.dtype))[1]
        if full_op:
            sol = cg(d.mdagm, d.mdag(project_out(eig.evecs, xi, red)),
                     tol=tol, maxiter=maxiter, allreduce=red)
            x = sol.x
        else:
            src = project_out(eig.evecs, d.prepare(xi), red)
            rhs = d.matpc(src, dagger=True)
            sol = cg(d.matpc_dagm, rhs,
                     x0=deflate_guess(eig.evecs, eig.evals, rhs, red),
                     tol=tol, maxiter=maxiter, allreduce=red)
            x = d.reconstruct(sol.x, xi)
        iters.append(sol.iters)
        stoch = lp.add_loops(stoch, lp.one_end_trick(x, plain, geom_l))
    lap("stochastic")
    out = _finalize_loops(acc, 1.0, stoch if n_stoch > 0 else None,
                          max(n_stoch, 1), mesh)
    lap("finalize")
    if stats is not None:
        stats.update(eig=eig_stats, cg_iters=iters, secs=secs)
    return out, eig
