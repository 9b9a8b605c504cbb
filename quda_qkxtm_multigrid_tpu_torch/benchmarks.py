"""Solve-level benchmarks of the port: the twisted-clover CG solve, the
MG-GCR-PC solve, and the compact channel operator's paths.

``bench_cg`` times ``invert.invert`` on a random SU(3) gauge field and a
point source: one cold solve, then one timed warm solve, with CG or one
of the other solvers of ``invert`` (the mixed ones with a bf16 or a
complex64 sloppy operator); ``bench_cg_mesh`` the same CG sharded on a
ring or grid of ranks (``bench_mg_mesh``: a sharded MG solve).  ``bench_mg``
times the multigrid setup (two to four levels, float32 or bf16 null
vectors, the canonical or the compact solve operators) and then one cold
and one warm ``mg_solve``, and certifies the warm solution in
complex128.  GFLOP/s counts one ``flops_per_mat`` per
outer iteration, the JAX package's convention (the V-cycle's work is
not counted).  ``bench_light`` and ``bench_light2`` put CG and MG side
by side at a light quark mass, and ``bench_mg_vecs`` times the setup
with null vectors generated and written, then read back.

The compact operator (``compact.py``): ``bench_bf16_spinor`` (the hop
with bf16 spinor storage against float32 storage, the bf16-storage CG
floor and its mixed recovery), ``bench_compact_sloppy`` (the mixed CG of
``bench_cg`` with the compact bf16 tier as its sloppy operator),
``bench_compact`` (the bf16 tier's CG at an HBM-limited volume) and
``bench_cg48_dc`` (that solve certified in complex128 by a
defect-correction outer on the card), ``bench_mg48_dc`` (the MG-GCR-PC
solve at that volume, set up by ``mg.hbm_setup.setup_mg_hbm`` and
certified the same way); ``bench_recon8`` times the recon-8 hop against
recon-12.  Kernel times come from CUDA events on a CUDA
device (``time_ms``); on the CPU the same functions run with the host
clock, for rehearsal only.
"""

from __future__ import annotations

import dataclasses
import functools
import gc
import os
import statistics
import tempfile
import time
import types
from typing import NamedTuple

import torch

from quda_qkxtm_multigrid_tpu_torch import fields
from quda_qkxtm_multigrid_tpu_torch.compact import (
    CompactDirac, compact_true_residual_ch, invert_compact,
    invert_compact_full, make_compact)
from quda_qkxtm_multigrid_tpu_torch.dirac import (
    Dirac, DiracParams, as_sloppy, make_dirac)
from quda_qkxtm_multigrid_tpu_torch.invert import (
    InvertResult, invert, true_residual)
from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry
from quda_qkxtm_multigrid_tpu_torch.mg.multigrid import (
    MGParams, MGPreconditioner, mg_solve, setup_mg)
from quda_qkxtm_multigrid_tpu_torch.ops.blas import norm2
from quda_qkxtm_multigrid_tpu_torch.ops.dslash import (
    WILSON_DSLASH_FLOPS_PER_SITE, double_gauge)
from quda_qkxtm_multigrid_tpu_torch.ops.dslash_kernel import (
    dslash_ch, dslash_ch_msrc, from_channels, gauge_channels, to_channels)
from quda_qkxtm_multigrid_tpu_torch.parallel.mesh import TMesh, shard_spinor
from quda_qkxtm_multigrid_tpu_torch.parallel.sharded import shard_dirac
from quda_qkxtm_multigrid_tpu_torch.solvers.cg import cg, cg_mixed
from quda_qkxtm_multigrid_tpu_torch.solvers.support import defect_correction
from quda_qkxtm_multigrid_tpu_torch.utils import rng


def tmc_params(use_kernels: bool = True, bf16: bool = False) -> DiracParams:
    """The reference twisted-clover point: κ=0.115, μ=0.05, c_sw=1.0
    (``bf16``: the bf16 operand tier; the JAX package's
    ``_tmc_params(use_pallas, bf16)``)."""
    return DiracParams(kind="twisted-clover", kappa=0.115, mu=0.05,
                       csw=1.0, use_kernels=use_kernels, kernel_bf16=bf16)


def make_gauge_source(geom: Geometry, device="cuda", seed: int = 7,
                      dtype=torch.complex128):
    """Random SU(3) gauge made in complex128 on ``device`` from ``seed``
    and cast to ``dtype``, and the point source at (0,0,0,0), spin 0,
    colour 0, in ``dtype``."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    u = rng.random_gauge(gen, geom, dtype=torch.complex128).to(dtype)
    b = fields.point_source(geom, (0, 0, 0, 0), 0, 0, dtype=dtype,
                            device=device)
    return u, b


def make_problem(geom: Geometry, device="cuda", seed: int = 7,
                 use_kernels: bool = True, dtype=torch.complex128,
                 bf16: bool = False) -> tuple[Dirac, torch.Tensor]:
    """The fields of ``make_gauge_source``, with the gauge's
    twisted-clover operator in ``dtype`` (in the bf16 operand tier with
    ``bf16``).  The complex64 problem is the one the JAX package's MG
    benchmark solves."""
    u, b = make_gauge_source(geom, device, seed, dtype)
    return make_dirac(u, tmc_params(use_kernels, bf16), geom), b


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _peak(device: torch.device):
    return (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)


def _cold_warm(solve, d: Dirac, device: torch.device, label: str) -> dict:
    """One cold and one timed warm ``solve()`` (an ``InvertResult``), with
    the peak device memory over both: the record of ``bench_cg``."""
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    cold = solve()
    _sync(device)
    t0 = time.perf_counter()
    out = solve()
    _sync(device)
    secs = time.perf_counter() - t0
    return {"iters": out.iters, "iters_cold": cold.iters, "secs": secs,
            "true_res": out.true_res, "true_res_cold": cold.true_res,
            "gflops": d.flops_per_mat() * max(out.iters, 1) / secs / 1e9,
            "solver": label,
            "restarts": None if out.stats is None else out.stats.restarts,
            "restarts_cold": None if cold.stats is None
            else cold.stats.restarts,
            "diverged": out.stats is not None and out.stats.diverged,
            "peak_mem_bytes": _peak(device)}


def bench_cg(geom: Geometry, tol: float = 1e-7, maxiter: int = 2000,
             problem=None, solver: str = "cg",
             sloppy: str | None = None) -> dict:
    """Warm wall-clock of the twisted-clover solve (``problem`` is a
    ``(dirac, b)`` pair, made on the GPU by ``make_problem`` if not
    given).  ``solver`` is one of ``invert.SOLVERS``; a mixed solver's
    sloppy operator is ``sloppy``: "bf16" (``as_sloppy`` in the bf16
    operand tier) or "c64" (``invert``'s default, one tier down).

    The record holds the warm and cold iterations (mixed: summed inner
    ones) and restarts, seconds, true residuals, GFLOP/s (one
    ``flops_per_mat`` an iteration), ``diverged``, and the peak device
    memory over both solves (None on the CPU)."""
    d, b = problem if problem is not None else make_problem(geom)
    sloppies = ("bf16", "c64")
    if solver.endswith("-mixed") != (sloppy is not None):
        raise ValueError(f"sloppy={sloppy!r} with solver={solver!r}: a "
                         f"mixed solver takes one of {sloppies}, another "
                         "none")
    if sloppy not in (None,) + sloppies:
        raise ValueError(f"sloppy={sloppy!r} not one of {sloppies}")
    kw = dict(tol=tol, maxiter=maxiter, solver=solver)
    if sloppy == "bf16":
        kw["sloppy_dirac"] = as_sloppy(d, kernel_bf16=True)
    fused = "-fused" if d._has_fused_matpc else ""
    return _cold_warm(lambda: invert(d, b, **kw), d, b.device,
                      solver + fused + (f"-{sloppy}" if sloppy else ""))


def bench_cg_mesh(geom: Geometry, mesh: TMesh, overlap: bool = False,
                  tol: float = 1e-7, maxiter: int = 2000,
                  problem=None) -> tuple[dict, torch.Tensor]:
    """``bench_cg`` for the t-sharded solve: the operator and source of
    ``problem`` (made by ``make_problem`` on the mesh's device if not
    given), cut to this rank's box, solved cold and warm with
    ``invert(mesh=mesh, overlap=overlap)``.  Returns the record (GFLOP/s
    over the whole lattice; seconds on this rank's clock) and this
    rank's box of the warm solution."""
    d, b = problem if problem is not None else make_problem(geom,
                                                            mesh.device)
    ds, bs = shard_dirac(d, mesh), shard_spinor(b, mesh)
    last = {}

    def solve():
        last["out"] = invert(ds, bs, tol=tol, maxiter=maxiter, mesh=mesh,
                             overlap=overlap)
        return last["out"]
    label = f"cg-sharded-nt{mesh.nt}" + ("-overlap" if overlap else "")
    return _cold_warm(solve, ds, bs.device, label), last["out"].x


def c128_true_res(d: Dirac, x: torch.Tensor, b: torch.Tensor) -> float:
    """|b − M x| / |b| with M the complex128 operator on ``d``'s gauge and
    parameters (every hop through the double-precision kernel where the
    operator uses the kernels), x and b widened to complex128."""
    return _c128_true_res(d.u, d.params, d.geom, x, b)


def _c128_true_res(u: torch.Tensor, params: DiracParams, geom: Geometry,
                   x: torch.Tensor, b: torch.Tensor) -> float:
    """``c128_true_res`` of the operator of ``u`` and ``params``."""
    d128 = make_dirac(u.to(torch.complex128), params, geom)
    _, rel = true_residual(d128, x.to(torch.complex128),
                           b.to(torch.complex128))
    return float(rel)


def _launch_counts() -> tuple:
    """(K1, K1d, K2) launches so far."""
    return (dslash_ch.launches, dslash_ch.launches_bf16,
            dslash_ch_msrc.launches)


def bench_mg(geom: Geometry, tol: float = 1e-7, nvec: int = 24,
             block=(4, 4, 4, 4), solver: str = "gcr-pc", n_krylov: int = 5,
             problem=None, seed: int = 3, n_level: int = 2,
             vec_dtype: str = "f32", mg_params: MGParams | None = None,
             solve_operator: str = "canonical"
             ) -> tuple[dict, MGPreconditioner]:
    """MG setup, then one cold and one warm ``mg_solve`` (``problem`` is
    a ``(dirac, b)`` pair, the complex64 problem of ``make_problem`` on
    the GPU if not given; ``seed`` seeds the setup sources).  The
    reference MG settings: ``block``, ``nvec``, ``smoother_pc``,
    ``n_level`` levels, the level-1 V stored as ``vec_dtype``, the solve
    operators ``solve_operator`` (the JAX package's ``bench_mg``
    options; "compact" is its north star's tiers); every other field
    from ``mg_params`` (the level-2 and level-3 fields, the deltas) or
    the ``MGParams`` defaults.

    With the compact solve tiers the solves run with
    ``final_resid=False`` (the residual tier has no clover) and the warm
    solution is certified by the complex128 operator of the gauge built
    on the card after the solves (the JAX package certifies on the
    host); the canonical operator is not kept beside the preconditioner
    where the caller does not hold ``problem``.

    Returns the record and the preconditioner.  The record holds the
    setup's host seconds and their split (each coarser level's under
    "level2" / "level3"), the multi-source CG iterations of each
    null-vector batch, each solve's outer iterations and seconds,
    GFLOP/s, the warm solution's true residual in complex128
    (``c128_true_res``) and the solve's own (None without a final
    residual), the K1, K1d and K2 launches of the setup and of the
    solves, and the peak device memory (None on the CPU)."""
    d, b = problem if problem is not None else make_problem(
        geom, dtype=torch.complex64)
    dev = b.device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    params = dataclasses.replace(
        mg_params if mg_params is not None else MGParams(),
        block=tuple(block), nvec=nvec, smoother_pc=True,
        outer_solver=solver, n_level=n_level, vec_dtype=vec_dtype,
        solve_operator=solve_operator)
    gen = torch.Generator(device=dev).manual_seed(seed)
    n0 = _launch_counts()
    t0 = time.perf_counter()
    mg = setup_mg(d, params, gen)
    _sync(dev)
    setup_secs = time.perf_counter() - t0
    u, dparams = d.u, d.params
    del d, problem
    n1 = _launch_counts()
    kw = dict(tol=tol, n_krylov=n_krylov,
              final_resid=solve_operator != "compact")
    t0 = time.perf_counter()
    cold = mg_solve(mg, b, **kw)
    _sync(dev)
    secs_cold = time.perf_counter() - t0
    n2 = _launch_counts()
    t0 = time.perf_counter()
    out = mg_solve(mg, b, **kw)
    _sync(dev)
    secs = time.perf_counter() - t0
    n3 = _launch_counts()
    b2 = float(norm2(b))
    record = {
        "solver": f"mg-{solver}", "nvec": nvec, "block": list(block),
        "n_level": n_level, "vec_dtype": vec_dtype,
        "solve_operator": solve_operator,
        "n_krylov": n_krylov, "setup_secs": setup_secs,
        **{k: v for k, v in mg.setup_stats.items()},
        "iters": out.iters, "iters_cold": cold.iters, "secs": secs,
        "secs_cold": secs_cold,
        "gflops": mg.dirac.flops_per_mat() * max(out.iters, 1) / secs / 1e9,
        "true_res": _c128_true_res(u, dparams, geom, out.x, b),
        "true_res_solve": ((float(out.r2) / b2) ** 0.5
                           if kw["final_resid"] else None)}
    for i, name in enumerate(("k1", "k1d", "k2")):
        record.update({f"{name}_launches_setup": n1[i] - n0[i],
                       f"{name}_launches_cold_solve": n2[i] - n1[i],
                       f"{name}_launches_solve": n3[i] - n2[i]})
    record["peak_mem_bytes"] = _peak(dev)
    return record, mg


def bench_mg_mesh(mesh: TMesh, problem, mg, tol: float = 1e-7,
                  solver: str = "gcr-pc",
                  n_krylov: int = 5) -> tuple[dict, torch.Tensor]:
    """The t-sharded MG solve without its setup: the preconditioner ``mg``
    of ``problem`` (the whole lattice's operator and source, as
    ``make_problem``'s; ``mg`` set up on that operator, as ``bench_mg``
    does), cut by ``shard_mg``, then one cold and one timed warm
    ``mg_solve(mesh=…)``.  Returns the record (the warm solve's outer
    iterations and seconds on this rank's clock, the cold one's
    iterations, the complex128 true residual of the gathered warm
    solution, its V-cycles, the coarse-residual all-gathers and the K4
    launches of the warm solve) and this rank's box of the warm
    solution."""
    from quda_qkxtm_multigrid_tpu_torch.mg.multigrid import shard_mg
    from quda_qkxtm_multigrid_tpu_torch.ops.dslash_kernel import (
        dslash_ch_local)
    d, b = problem
    ms = shard_mg(mg, mesh)
    bs = shard_spinor(b, mesh)
    vcycles = [0]
    vcycle = ms.vcycle

    def counted(r, mesh=None):
        vcycles[0] += 1
        return vcycle(r, mesh)
    ms.vcycle = counted
    dev = bs.device
    cold = mg_solve(ms, bs, tol=tol, n_krylov=n_krylov, solver=solver,
                    mesh=mesh)
    _sync(dev)
    vcycles[0] = 0
    g0, k4 = TMesh.gathers, dslash_ch_local.launches
    t0 = time.perf_counter()
    out = mg_solve(ms, bs, tol=tol, n_krylov=n_krylov, solver=solver,
                   mesh=mesh)
    _sync(dev)
    secs = time.perf_counter() - t0
    gathers, k4 = TMesh.gathers - g0, dslash_ch_local.launches - k4
    record = {
        "solver": f"mg-{solver}-sharded-nt{mesh.nt}", "iters": out.iters,
        "iters_cold": cold.iters, "secs": secs, "vcycles": vcycles[0],
        "allgathers": gathers, "k4_launches": k4,
        "true_res": c128_true_res(d, mesh.allgather_t(out.x), b),
        "true_res_solve": float(
            (out.r2 / mesh.allreduce(norm2(bs))) ** 0.5)}
    return record, out.x


def light_problem(geom: Geometry, kappa: float, mu: float, device,
                   seed: int = 7) -> tuple[Dirac, torch.Tensor]:
    """The complex64 problem of ``make_problem`` with twisted-clover
    (κ, μ, c_sw = 1.0)."""
    u, b = make_gauge_source(geom, device, seed, torch.complex64)
    p = DiracParams(kind="twisted-clover", kappa=kappa, mu=mu, csw=1.0,
                    use_kernels=True)
    return make_dirac(u, p, geom), b


def _cg_record(d: Dirac, b: torch.Tensor, tol: float, maxiter: int) -> dict:
    """A cold, then a timed warm CG solve: its seconds, iterations, its
    own true residual (complex64) and the complex128 one."""
    invert(d, b, tol=tol, maxiter=maxiter)
    _sync(b.device)
    t0 = time.perf_counter()
    out = invert(d, b, tol=tol, maxiter=maxiter)
    _sync(b.device)
    return {"cg_secs": time.perf_counter() - t0, "cg_iters": out.iters,
            "cg_res": out.true_res,
            "cg_true_res": c128_true_res(d, out.x, b)}


def _light_mg_record(d: Dirac, b: torch.Tensor, params: MGParams, tol: float,
                     tag: str, seed: int = 3) -> dict:
    """MG setup and one GCR-PC(10) solve (at most 50 restarts) on ``d``:
    the setup seconds and statistics, the solve's seconds and outer
    iterations, its own full-system residual (complex64) and the
    complex128 one, each key prefixed ``tag``.  The preconditioner is
    freed before returning."""
    dev = b.device
    _sync(dev)
    t0 = time.perf_counter()
    mg = setup_mg(d, params, torch.Generator(device=dev).manual_seed(seed))
    _sync(dev)
    setup_secs = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = mg_solve(mg, b, tol=tol, solver="gcr-pc")
    _sync(dev)
    rec = {f"{tag}setup_secs": setup_secs,
           f"{tag}secs": time.perf_counter() - t0,
           f"{tag}iters": out.iters,
           f"{tag}res": (float(out.r2) / float(norm2(b))) ** 0.5,
           f"{tag}true_res": c128_true_res(d, out.x, b),
           f"{tag}setup_stats": mg.setup_stats}
    del mg, out
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return rec


def _mg_verdict(rec: dict, tags, tol: float) -> dict:
    """``mg_beats_cg``: an MG solve whose complex128 true residual is at
    most 5 × tol, faster than the CG or with the CG not so certified
    (an MG run that stopped at its iteration cap never wins); and the
    solves that pay for its setup (None without a certified win on
    time)."""
    ok = [t for t in tags if rec[f"{t}true_res"] <= 5 * tol]
    cg_ok = rec["cg_true_res"] <= 5 * tol
    if not ok:
        return {"mg_beats_cg": False, "amortise_solves": None}
    best = min(ok, key=lambda t: rec[f"{t}secs"])
    faster = rec[f"{best}secs"] < rec["cg_secs"]
    return {"mg_beats_cg": faster or not cg_ok,
            "amortise_solves": (rec[f"{best}setup_secs"]
                                / (rec["cg_secs"] - rec[f"{best}secs"])
                                if faster and cg_ok else None)}


def bench_light(geom: Geometry, mu: float = 0.003, tol: float = 1e-7,
                probe_geom: Geometry | None = None,
                kappas=(0.125, 0.15, 0.18, 0.21),
                probe_iters_target: int = 350, cg_maxiter: int = 6000,
                device="cuda", block=(4, 4, 4, 4), nvec: int = 24,
                mg_params: MGParams | None = None) -> dict:
    """CG against MG at a light quark mass (the JAX package's
    ``bench_light``): on a random gauge the critical κ is shifted, so
    short CG probes (tol, at most 2000 iterations) at ``probe_geom``
    (16³×32 by default) walk the κ ladder until the iterations reach
    ``probe_iters_target``.  At that κ and ``geom``: the CG (a cold,
    then a timed warm solve, at most ``cg_maxiter`` iterations), then
    MG-GCR-PC, ``block`` × ``nvec``, ``smoother_pc``: plain ("mg_"), with
    ``delta_mu_coarse=8`` and ``setup_tol`` 1e-6 ("mg_dmu_"), and the
    latter on three levels ("mg3_dmu_", which the JAX package's record
    lacks).  ``mg_params`` gives the other MG fields (the level-2 ones).

    Every solve carries its own residual (``*_res``: the CG's and the
    MG's in complex64) and its complex128 true residual (``*_true_res``).
    Unlike the JAX package's rule, ``mg_beats_cg`` is true only for an MG
    solve certified in complex128 to ≤ 5 × tol (``_mg_verdict``)."""
    pg = probe_geom if probe_geom is not None else Geometry(16, 16, 16, 32)
    ladder, kappa_l = [], kappas[0]
    for kappa in kappas:
        d, b = light_problem(pg, kappa, mu, device)
        out = invert(d, b, tol=tol, maxiter=2000)
        ladder.append({"kappa": kappa, "iters": out.iters,
                       "true_res": out.true_res})
        kappa_l = kappa
        del d, b, out
        if ladder[-1]["iters"] >= min(probe_iters_target, 2000):
            break
    d, b = light_problem(geom, kappa_l, mu, device)
    rec = {"geom": list(geom.dims), "kappa": kappa_l, "mu": mu,
           "probe_geom": list(pg.dims), "probe_ladder": ladder,
           **_cg_record(d, b, tol, cg_maxiter)}
    base = dataclasses.replace(
        mg_params if mg_params is not None else MGParams(),
        block=tuple(block), nvec=nvec, smoother_pc=True,
        outer_solver="gcr-pc")
    dmu = dataclasses.replace(base, delta_mu_coarse=8.0, setup_tol=1e-6)
    runs = [("mg_", base), ("mg_dmu_", dmu),
            ("mg3_dmu_", dataclasses.replace(dmu, n_level=3))]
    for tag, p in runs:
        rec.update(_light_mg_record(d, b, p, tol, tag))
    rec.update(_mg_verdict(rec, [t for t, _ in runs], tol))
    rec["solver"] = "cg-fused vs mg-gcr-pc (light mass)"
    return rec


def bench_light2(geom: Geometry, kappa: float = 0.21, mu: float = 0.003,
                 tol: float = 1e-7, cg_maxiter: int = 6000, device="cuda",
                 block=(4, 4, 4, 4), nvec: int = 24) -> dict:
    """The light-mass record at a given κ (the JAX package's
    ``bench_light2``): the CG of ``bench_light`` and its
    ``delta_mu_coarse=8`` MG on the same operator, with the same
    residuals and the same certified ``mg_beats_cg``."""
    d, b = light_problem(geom, kappa, mu, device)
    rec = {"geom": list(geom.dims), "kappa": kappa, "mu": mu,
           **_cg_record(d, b, tol, cg_maxiter)}
    p = MGParams(block=tuple(block), nvec=nvec, smoother_pc=True,
                 outer_solver="gcr-pc", delta_mu_coarse=8.0, setup_tol=1e-6)
    rec.update(_light_mg_record(d, b, p, tol, "mg_dmu_"))
    rec.update(_mg_verdict(rec, ["mg_dmu_"], tol))
    rec["solver"] = "cg-fused vs mg-gcr-pc-dmu (light mass)"
    return rec


def bench_mg_vecs(geom: Geometry, nvec: int = 24, block=(4, 4, 4, 4),
                  path: str | None = None, problem=None) -> dict:
    """The null-vector file (the JAX package's ``bench_mg_vecs``): set
    up with ``vec_outfile`` (generation, the file written), set up again
    with ``vec_infile`` (the file read, generation skipped), then one
    GCR-PC solve on the second, certified in complex128.  ``path`` is the
    file (a temporary directory's if not given, removed after);
    ``problem`` as in ``bench_mg``."""
    d, b = problem if problem is not None else make_problem(
        geom, dtype=torch.complex64)
    dev = b.device
    with tempfile.TemporaryDirectory() as tmp:
        path = path if path is not None else os.path.join(tmp, "vecs.npz")
        kw = dict(block=tuple(block), nvec=nvec, smoother_pc=True,
                  outer_solver="gcr-pc")
        secs = []
        for p, seed in ((MGParams(vec_outfile=path, **kw), 3),
                        (MGParams(vec_infile=path, **kw), 5)):
            _sync(dev)
            t0 = time.perf_counter()
            mg = setup_mg(d, p, torch.Generator(device=dev).manual_seed(seed))
            _sync(dev)
            secs.append(time.perf_counter() - t0)
        size_mb = os.path.getsize(path) / 2**20
    out = mg_solve(mg, b, tol=1e-7)
    return {"geom": list(geom.dims), "nvec": nvec,
            "setup_secs_generate": secs[0], "setup_secs_load": secs[1],
            "speedup": secs[0] / secs[1], "vec_file_mb": size_mb,
            "iters": out.iters, "true_res": c128_true_res(d, out.x, b),
            "solver": "mg-gcr-pc (vec_outfile / vec_infile)"}


# ---- the compact channel operator -----------------------------------------

def time_ms(fn, device, n: int) -> float:
    """Mean ms of ``n`` back-to-back calls of ``fn``: CUDA events on a
    CUDA device, the host clock otherwise."""
    if torch.device(device).type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / n
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) * 1e3 / n


def median_ms(fn, device, n: int = 20, reps: int = 5) -> float:
    """Median over ``reps`` of ``time_ms(fn, device, n)``, after one
    warm-up call."""
    fn()
    _sync(torch.device(device))
    return statistics.median(time_ms(fn, device, n) for _ in range(reps))


def _operand_bytes(cd: CompactDirac) -> int:
    return sum(t.numel() * t.element_size()
               for t in (cd.g_ch, cd.cinv_ch, cd.cl_ch) if t is not None)


def bench_bf16_spinor(geom: Geometry, cg_geom: Geometry | None = None,
                      device="cuda", seed: int = 7) -> dict:
    """The bf16 spinor storage (the JAX package's ``bench_bf16_spinor``):

    1. the bare hop on the bf16 recon-12 gauge of parity 0 with float32
       spinors (K1d) against bf16 spinors in and out (K1e) at ``geom``,
       each the median of 5 runs of 20 launches (CUDA events);
    2. at ``cg_geom`` (16³×32 by default), on the compact bf16 tier of a
       random gauge and a random source: the floor of a CG on
       M_pc†M_pc with bf16-storage intermediates (tol 1e-10, 400
       iterations at most), and the mixed recovery to 1e-8 (``cg_mixed``,
       ``inner_tol`` 1e-3, the bf16-storage chain inside).  The floor and
       the recovery are measured against the same stored operator in
       float64 (``CompactDirac.widened``), which is also the recovery's
       outer: the card has native float64, where the JAX package's outer
       was the float32-storage chain.

    Returns the record: ms and GFLOP/s of both hops (1320 flop a site
    over half the volume), the floor and its CG iterations, the mixed
    solve's true residual, inner iterations, restarts and ``diverged``."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    u = rng.random_gauge(gen, geom)
    g = gauge_channels(double_gauge(u, geom), 0, True, torch.bfloat16)
    p32 = to_channels(rng.random_spinor(gen, geom)[1]).to(torch.float32)
    p16 = p32.to(torch.bfloat16)
    del u
    flops = WILSON_DSLASH_FLOPS_PER_SITE * geom.half_volume
    ms32 = median_ms(lambda: dslash_ch(g, p32, 0, geom, recon12=True),
                     device)
    ms16 = median_ms(lambda: dslash_ch(g, p16, 0, geom, recon12=True,
                                       out_dtype=torch.bfloat16), device)
    out = {"geom": list(geom.dims), "f32_spinor_ms": ms32,
           "bf16_spinor_ms": ms16,
           "f32_spinor_gflops": flops / ms32 / 1e6,
           "bf16_spinor_gflops": flops / ms16 / 1e6}
    del g, p32, p16

    cgg = cg_geom if cg_geom is not None else Geometry(16, 16, 16, 32)
    u2 = rng.random_gauge(gen, cgg)
    cd = make_compact(u2, tmc_params(), cgg, torch.bfloat16)
    exact = cd.widened(torch.float64)
    del u2
    b = rng.random_spinor(gen, cgg)
    rhs = cd.matpc_ch(cd.prepare_ch(cd._to_ch(b[0]), cd._to_ch(b[1])),
                      dagger=True)
    rhs64 = rhs.to(torch.float64)
    b2 = norm2(rhs64)

    def rel(x):
        r = rhs64 - exact.matpc_dagm_ch(x.to(torch.float64))
        return float(torch.sqrt(norm2(r) / b2))

    def sloppy(v):
        return cd.matpc_dagm_ch(v, storage_dtype=torch.bfloat16)

    floor = cg(sloppy, rhs, tol=1e-10, maxiter=400)
    mixed = cg_mixed(exact.matpc_dagm_ch, sloppy, rhs64, tol=1e-8,
                     maxiter=2000, inner_tol=1e-3, lo_dtype=torch.float32)
    out.update({"cg_geom": list(cgg.dims),
                "bf16_storage_cg_floor": rel(floor.x),
                "bf16_storage_cg_iters": floor.iters,
                "mixed_bf16_true_res": rel(mixed.x),
                "mixed_bf16_iters": mixed.iters,
                "mixed_bf16_restarts": mixed.stats.restarts,
                "mixed_bf16_diverged": mixed.stats.diverged})
    return out


def compact_sloppy_solve(d: Dirac, cd: CompactDirac, b: torch.Tensor,
                         tol: float = 1e-10, maxiter: int = 1000,
                         inner_tol: float = 1e-2) -> InvertResult:
    """The mixed CG of ``invert(d, b, solver="cg-mixed")`` with a compact
    tier ``cd`` of the same gauge as its sloppy operator:
    ``solvers.cg.cg_mixed`` with the outer matvec
    ``d._fused_matpc_dagm_ch`` on the float64 channels of a complex128
    fused operator ``d`` and the inner ``cd.matpc_dagm_ch``, whose
    forward half stores its planes in bf16 (K1e) when ``cd`` is the bf16
    tier.  Prepare, reconstruct and the true residual run on ``d``, as
    in ``invert``.  ``maxiter`` caps the summed inner iterations."""
    if not d._has_fused_matpc:
        raise ValueError("the compact sloppy solve needs an outer operator "
                         "with the fused chain (use_kernels, twisted or "
                         "clover)")
    src = d.prepare(b)
    rhs = d.matpc(src, dagger=True)
    storage = torch.bfloat16 if cd.g_ch.dtype == torch.bfloat16 else None
    res = cg_mixed(d._fused_matpc_dagm_ch,
                   functools.partial(cd.matpc_dagm_ch, storage_dtype=storage),
                   to_channels(rhs), tol=tol, maxiter=maxiter,
                   inner_tol=inner_tol, lo_dtype=torch.float32)
    x = d.reconstruct(from_channels(res.x, (4, 3)).to(rhs.dtype), b)
    _, rel = true_residual(d, x, b)
    return InvertResult(x, res.iters, float(rel), res.stats)


def bench_compact_sloppy(geom: Geometry, tol: float = 1e-10,
                         maxiter: int = 2000, problem=None
                         ) -> tuple[dict, CompactDirac]:
    """``bench_cg(solver="cg-mixed")`` with the compact bf16 tier of the
    problem's gauge (bf16 spinor storage in the inner chain) as the
    sloppy operator, through ``compact_sloppy_solve``: the same record.
    Returns the record and the compact operator."""
    d, b = problem if problem is not None else make_problem(geom)
    cd = make_compact(d.u, d.params, geom, torch.bfloat16)
    rec = _cold_warm(lambda: compact_sloppy_solve(d, cd, b, tol, maxiter),
                     d, b.device, "cg-mixed-compact-bf16")
    return rec, cd


def bench_recon8(geom: Geometry, device="cuda", seed: int = 7) -> dict:
    """The recon-8 hop (K3) against the recon-12 hop (K1) in float32, on
    parity 0 of a random gauge and spinor at ``geom``: the median ms of
    5 runs of 20 launches each, GFLOP/s (1320 flop a site), and the
    normwise difference of the two (float32 rounding of the decode)."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    ud = double_gauge(rng.random_gauge(gen, geom), geom)
    g12 = gauge_channels(ud, 0, True, torch.float32)
    g8 = gauge_channels(ud, 0, False, torch.float32, recon8=True)
    del ud
    v = to_channels(rng.random_spinor(gen, geom)[1]).to(torch.float32)
    r12 = lambda: dslash_ch(g12, v, 0, geom, recon12=True)
    r8 = lambda: dslash_ch(g8, v, 0, geom, recon8=True)
    ref = r12()
    flops = WILSON_DSLASH_FLOPS_PER_SITE * geom.half_volume
    ms8, ms12 = median_ms(r8, device), median_ms(r12, device)
    return {"geom": list(geom.dims), "recon8_ms": ms8, "recon12_ms": ms12,
            "recon8_gflops": flops / ms8 / 1e6,
            "recon12_gflops": flops / ms12 / 1e6,
            "recon8_vs_recon12": float((r8() - ref).norm() / ref.norm())}


class CompactProblem(NamedTuple):
    """The 48³×96 problem of ``bench_compact`` and ``bench_cg48_dc``."""
    sloppy: CompactDirac    # bf16 tier (bf16 gauge, float32 A⁻¹)
    exact: CompactDirac     # float64 channels without A⁻¹: m_ch only
    b: torch.Tensor         # point source, complex128
    build_secs: float       # the bf16 tier's build
    exact_build_secs: float


def make_compact_problem(geom: Geometry, device="cuda",
                         seed: int = 7) -> CompactProblem:
    """The gauge and source of ``make_gauge_source`` (complex128), the
    compact bf16 tier of the twisted-clover operator on them and its
    float64 channels for the full operator; the canonical gauge is freed
    before returning."""
    device = torch.device(device)
    u, b = make_gauge_source(geom, device, seed)
    _sync(device)
    t0 = time.perf_counter()
    sloppy = make_compact(u, tmc_params(), geom, torch.bfloat16)
    _sync(device)
    t1 = time.perf_counter()
    exact = make_compact(u, tmc_params(), geom, torch.float64,
                         inverse=False)
    _sync(device)
    t2 = time.perf_counter()
    return CompactProblem(sloppy, exact, b, t1 - t0, t2 - t1)


def bench_compact(geom: Geometry, tol: float = 1e-7, maxiter: int = 2000,
                  problem: CompactProblem | None = None,
                  device="cuda") -> dict:
    """The compact bf16 tier's CG solve (the JAX package's
    ``bench_compact``): one cold and one timed warm
    ``invert_compact_full`` of the point source, float32 spinors.  The
    record holds the build seconds, the operand GiB, the warm and cold
    iterations, seconds, GFLOP/s (two ``flops_per_mat`` and the BLAS an
    iteration, the JAX convention), the compact operator's own true
    residual, the complex128 true residual against the exact operator
    (float64 channels: the bf16 gauge shows there), and the peak device
    memory."""
    pb = problem if problem is not None else make_compact_problem(
        geom, device)
    cd, dev = pb.sloppy, pb.b.device
    cold = invert_compact_full(cd, pb.b, tol=tol, maxiter=maxiter)
    del cold
    _sync(dev)
    t0 = time.perf_counter()
    out = invert_compact_full(cd, pb.b, tol=tol, maxiter=maxiter)
    _sync(dev)
    secs = time.perf_counter() - t0
    ex = pb.exact
    _, rel = compact_true_residual_ch(
        ex, ex._to_ch(out.x[0]), ex._to_ch(out.x[1]), ex._to_ch(pb.b[0]),
        ex._to_ch(pb.b[1]))
    flops = ((2 * cd.flops_per_mat() + 4 * 2 * 24 * geom.half_volume)
             * out.iters)
    return {"geom": list(geom.dims), "iters": out.iters, "secs": secs,
            "gflops": flops / secs / 1e9, "true_res": out.true_res,
            "true_res_exact": float(rel), "build_secs": pb.build_secs,
            "operand_gib": _operand_bytes(cd) / 2**30,
            "exact_operand_gib": _operand_bytes(ex) / 2**30,
            "peak_mem_bytes": _peak(dev), "solver": "cg-compact-bf16"}


def bench_cg48_dc(geom: Geometry, inner_tol: float = 1e-6,
                  tol: float = 1e-9, maxiter: int = 2000,
                  inner_maxiter: int = 600,
                  problem: CompactProblem | None = None,
                  device="cuda") -> dict:
    """The compact solve certified in complex128 on the card: the
    counterpart of the JAX package's ``bench_cg48_hostdc``, whose outer
    ran on the host in complex128 (``solvers/host_dc.py``).  The outer is
    ``solvers.support.defect_correction`` with the residual b − M x of
    the exact operator in float64 channels on the card (complex128
    arithmetic); the inner is ``invert_compact`` on the bf16 tier to
    ``inner_tol`` (at most ``inner_maxiter`` iterations a restart).

    The record holds the true residual, restarts, summed inner
    iterations, ``diverged``, the seconds of the solve and of its outer
    residuals, the build seconds and the peak device memory."""
    pb = problem if problem is not None else make_compact_problem(
        geom, device)
    cd, ex, dev = pb.sloppy, pb.exact, pb.b.device
    b_ch = torch.stack([ex._to_ch(pb.b[0]), ex._to_ch(pb.b[1])])
    resid = {"secs": 0.0}

    def matvec_hi(x):
        _sync(dev)
        t = time.perf_counter()
        out = torch.stack(ex.m_ch(x[0], x[1]))
        _sync(dev)
        resid["secs"] += time.perf_counter() - t
        return out

    def solve_lo(r, cap):
        (x_e, x_o), iters, _ = invert_compact(
            cd, r[0], r[1], tol=inner_tol, maxiter=min(inner_maxiter, cap))
        return types.SimpleNamespace(x=torch.stack([x_e, x_o]), iters=iters)

    _sync(dev)
    t0 = time.perf_counter()
    _, r2, iters, stats = defect_correction(
        matvec_hi, solve_lo, b_ch, torch.float32, tol, maxiter,
        max_restarts=20, max_res_increase=1, max_res_increase_total=10)
    _sync(dev)
    secs = time.perf_counter() - t0
    return {"geom": list(geom.dims),
            "true_res": float(torch.sqrt(r2 / norm2(b_ch))),
            "restarts": stats.restarts, "inner_iters": iters,
            "diverged": stats.diverged, "secs": secs,
            "resid_secs": resid["secs"], "build_secs": pb.build_secs,
            "exact_build_secs": pb.exact_build_secs,
            "peak_mem_bytes": _peak(dev),
            "solver": "cg-compact-bf16 + float64 defect-correction outer"}


def bench_mg48_dc(geom: Geometry, nvec: int = 24, n_krylov: int = 3,
                  inner_tol: float = 5e-3, tol: float = 1e-8,
                  setup_tol: float = 1e-3, setup_maxiter: int = 60,
                  inner_solver: str = "gcr-pc", device="cuda",
                  seed: int = 7, setup_seed: int = 3
                  ) -> tuple[dict, MGPreconditioner]:
    """The 48³×96 MG-GCR-PC solve certified in complex128 on the card:
    the counterpart of the JAX package's ``bench_mg48_hostdc``, with its
    parameters and defaults (block 4⁴, ``smoother_pc``, ``nu_post`` 2,
    bf16 V, at most 4 inner restarts, at most 12 outer ones), at the
    reference's nvec 24 (JAX cut it to 4 for a 16 GB chip).

    The gauge and source of ``make_gauge_source`` (complex128, ``seed``);
    ``mg.hbm_setup.setup_mg_hbm`` on the compact step tier, bf16 with
    A⁻¹ in bf16 (sources from ``setup_seed``); then the float64 exact
    operator (``make_compact(inverse=False)``) and the gauge freed.  The outer is
    ``solvers.support.defect_correction`` with the residual b − M x of
    the exact operator on the card (complex128 arithmetic), the inner
    ``mg.multigrid.inner_mg``: ``mg_solve`` "gcr-pc" (``inner_solver``)
    in complex64 to ``inner_tol``.

    Returns the record and the preconditioner (the exact operator
    freed).  The record holds the setup's seconds and their split, the
    null vectors' CG iterations, the exact operator's build seconds, the
    complex128 ``true_res``, restarts, summed inner iterations (and each
    restart's), ``diverged``, the relative residual before each inner
    solve (``history``), the seconds of the solve and of its outer
    residuals, and the peak device memory."""
    from quda_qkxtm_multigrid_tpu_torch.mg.hbm_setup import setup_mg_hbm
    from quda_qkxtm_multigrid_tpu_torch.mg.multigrid import inner_mg
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    params = tmc_params(bf16=True)
    u, b = make_gauge_source(geom, device, seed)
    mgp = MGParams(block=(4, 4, 4, 4), nvec=nvec, setup_tol=setup_tol,
                   setup_maxiter=setup_maxiter, smoother_pc=True, nu_post=2,
                   vec_dtype="bf16", solve_operator="compact")
    gen = torch.Generator(device=device).manual_seed(setup_seed)
    _sync(device)
    t0 = time.perf_counter()
    mg, timings = setup_mg_hbm(u, params, geom, mgp, gen)
    _sync(device)
    setup_secs = time.perf_counter() - t0
    exact = make_compact(u, params, geom, torch.float64, inverse=False)
    _sync(device)
    exact_build_secs = time.perf_counter() - t0 - setup_secs
    del u
    b2 = float(norm2(b))
    resid = {"secs": 0.0}
    history, inner_iters = [], []

    def matvec_hi(x):
        _sync(device)
        t = time.perf_counter()
        out = exact.m(x)
        _sync(device)
        resid["secs"] += time.perf_counter() - t
        return out

    inner = inner_mg(mg, tol=inner_tol, solver=inner_solver, max_restarts=4,
                     n_krylov=n_krylov)

    def solve_lo(r, cap):
        history.append((float(norm2(r)) / b2) ** 0.5)
        e = inner(r, cap)
        inner_iters.append(e.iters)
        return e

    _sync(device)
    t0 = time.perf_counter()
    _, r2, iters, stats = defect_correction(
        matvec_hi, solve_lo, b, torch.complex64, tol, maxiter=100000,
        max_restarts=12, max_res_increase=1, max_res_increase_total=10)
    _sync(device)
    secs = time.perf_counter() - t0
    del exact
    return {"geom": list(geom.dims), "nvec": nvec, "n_krylov": n_krylov,
            "vec_dtype": "bf16", "setup_secs": setup_secs, **timings,
            "cg_iters": mg.setup_stats["cg_iters"],
            "null_true_res": mg.setup_stats["null_true_res"],
            "exact_build_secs": exact_build_secs,
            "true_res": (float(r2) / b2) ** 0.5,
            "restarts": stats.restarts, "inner_iters": iters,
            "inner_iters_each": inner_iters, "diverged": stats.diverged,
            "history": history, "secs": secs, "resid_secs": resid["secs"],
            "peak_mem_bytes": _peak(device),
            "solver": f"mg-{inner_solver}-compact-bf16 + float64 "
                      "defect-correction outer"}, mg


# ---- host I/O -------------------------------------------------------------

def bench_byte_swap(dims=(32, 32, 32, 64), reps: int = 5,
                    seed: int = 7) -> dict:
    """The ILDG payload's byte swap for a gauge at ``dims`` (X, Y, Z, T;
    4 × 18 reals a site): ``io/_native.decode_be`` / ``encode_be``
    against numpy's ``astype`` at both precisions, the least of ``reps``
    host-clock seconds each.  The results are held equal bit for bit.
    Run: ``python -c "from quda_qkxtm_multigrid_tpu_torch.benchmarks
    import bench_byte_swap; print(bench_byte_swap())"``."""
    import numpy as np

    from quda_qkxtm_multigrid_tpu_torch.io import _native

    if _native.get_lib() is None:
        raise RuntimeError("no g++: the native byte swap cannot be built")
    n = 4 * 18 * int(np.prod(dims))
    vals = np.random.default_rng(seed).standard_normal(n)

    def best(fn):
        secs = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = fn()
            secs.append(time.perf_counter() - t0)
        return min(secs), out

    rec = {"dims": list(dims), "reals": n, "cpus": os.cpu_count()}
    for prec in (64, 32):
        be = ">f8" if prec == 64 else ">f4"
        buf = vals.astype(be).tobytes()
        rows = {
            "decode": (lambda: _native.decode_be(buf, prec),
                       lambda: np.frombuffer(buf, be).astype(np.float64)),
            "encode": (lambda: _native.encode_be(vals, prec),
                       lambda: vals.astype(be).tobytes())}
        for op, (native, plain) in rows.items():
            t_nat, got = best(native)
            t_np, want = best(plain)
            if bytes(got) != bytes(want):
                raise AssertionError(f"{op} f{prec}: native != numpy")
            rec[f"{op}{prec}"] = {"bytes": len(buf), "native_s": t_nat,
                                  "numpy_s": t_np,
                                  "speedup": t_np / t_nat}
    return rec
