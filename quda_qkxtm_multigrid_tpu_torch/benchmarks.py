"""Solve-level benchmarks of the port: the twisted-clover CG solve and
the MG-GCR-PC solve.

``bench_cg`` times ``invert.invert`` on a random SU(3) gauge field and a
point source: one cold solve, then one timed warm solve, with CG or one
of the other solvers of ``invert`` (the mixed ones with a bf16 or a
complex64 sloppy operator).  ``bench_mg``
times the multigrid setup and then one cold and one warm ``mg_solve``,
and certifies the warm solution in complex128.  GFLOP/s counts one
``flops_per_mat`` per outer iteration, the JAX package's convention (the
V-cycle's work is not counted).
"""

from __future__ import annotations

import time

import torch

from quda_qkxtm_multigrid_tpu_torch import fields
from quda_qkxtm_multigrid_tpu_torch.dirac import (
    Dirac, DiracParams, as_sloppy, make_dirac)
from quda_qkxtm_multigrid_tpu_torch.invert import invert, true_residual
from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry
from quda_qkxtm_multigrid_tpu_torch.mg.multigrid import (
    MGParams, MGPreconditioner, mg_solve, setup_mg)
from quda_qkxtm_multigrid_tpu_torch.ops.blas import norm2
from quda_qkxtm_multigrid_tpu_torch.ops.dslash_kernel import (
    dslash_ch, dslash_ch_msrc)
from quda_qkxtm_multigrid_tpu_torch.utils import rng


def tmc_params(use_kernels: bool = True, bf16: bool = False) -> DiracParams:
    """The reference twisted-clover point: κ=0.115, μ=0.05, c_sw=1.0
    (``bf16``: the bf16 operand tier; the JAX package's
    ``_tmc_params(use_pallas, bf16)``)."""
    return DiracParams(kind="twisted-clover", kappa=0.115, mu=0.05,
                       csw=1.0, use_kernels=use_kernels, kernel_bf16=bf16)


def make_problem(geom: Geometry, device="cuda", seed: int = 7,
                 use_kernels: bool = True, dtype=torch.complex128,
                 bf16: bool = False) -> tuple[Dirac, torch.Tensor]:
    """Random SU(3) gauge made in complex128 on ``device`` from ``seed``
    and cast to ``dtype``, its twisted-clover operator in ``dtype`` (in
    the bf16 operand tier with ``bf16``), and the point source at
    (0,0,0,0), spin 0, colour 0.  The complex64 problem is the one the
    JAX package's MG benchmark solves."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    u = rng.random_gauge(gen, geom, dtype=torch.complex128).to(dtype)
    d = make_dirac(u, tmc_params(use_kernels, bf16), geom)
    b = fields.point_source(geom, (0, 0, 0, 0), 0, 0, dtype=dtype,
                            device=device)
    return d, b


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


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
    dev = b.device
    if solver.endswith("-mixed") != (sloppy is not None):
        raise ValueError(f"sloppy={sloppy!r} with solver={solver!r}: a "
                         "mixed solver takes 'bf16' or 'c64', another none")
    if sloppy not in (None, "bf16", "c64"):
        raise ValueError(f"sloppy={sloppy!r} not 'bf16' or 'c64'")
    kw = dict(tol=tol, maxiter=maxiter, solver=solver)
    if sloppy == "bf16":
        kw["sloppy_dirac"] = as_sloppy(d, kernel_bf16=True)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    cold = invert(d, b, **kw)
    _sync(dev)
    t0 = time.perf_counter()
    out = invert(d, b, **kw)
    _sync(dev)
    secs = time.perf_counter() - t0
    fused = "-fused" if d._has_fused_matpc else ""
    return {"iters": out.iters, "iters_cold": cold.iters, "secs": secs,
            "true_res": out.true_res, "true_res_cold": cold.true_res,
            "gflops": d.flops_per_mat() * max(out.iters, 1) / secs / 1e9,
            "solver": solver + fused + (f"-{sloppy}" if sloppy else ""),
            "restarts": None if out.stats is None else out.stats.restarts,
            "restarts_cold": None if cold.stats is None
            else cold.stats.restarts,
            "diverged": out.stats is not None and out.stats.diverged,
            "peak_mem_bytes": (torch.cuda.max_memory_allocated(dev)
                               if dev.type == "cuda" else None)}


def bench_mg(geom: Geometry, tol: float = 1e-7, nvec: int = 24,
             block=(4, 4, 4, 4), solver: str = "gcr-pc", n_krylov: int = 5,
             problem=None, seed: int = 3) -> tuple[dict, MGPreconditioner]:
    """MG setup, then one cold and one warm ``mg_solve`` (``problem`` is
    a ``(dirac, b)`` pair, the complex64 problem of ``make_problem`` on
    the GPU if not given; ``seed`` seeds the setup sources).  The
    reference MG settings: ``block``, ``nvec``, ``smoother_pc``, otherwise
    ``MGParams`` defaults.

    Returns the record and the preconditioner.  The record holds the
    setup's host seconds and their split, the multi-source CG
    iterations of each null-vector batch, each solve's outer iterations
    and seconds, GFLOP/s, the warm solution's true residual in
    complex128 (a complex128 operator on the same gauge, every hop
    through the double-precision kernel where the operator uses the
    kernels), the kernel launches of the setup and of the warm solve,
    and the peak device memory (None on the CPU)."""
    d, b = problem if problem is not None else make_problem(
        geom, dtype=torch.complex64)
    dev = b.device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    params = MGParams(block=tuple(block), nvec=nvec, smoother_pc=True,
                      outer_solver=solver)
    gen = torch.Generator(device=dev).manual_seed(seed)
    k1_0, k2_0 = dslash_ch.launches, dslash_ch_msrc.launches
    t0 = time.perf_counter()
    mg = setup_mg(d, params, gen)
    _sync(dev)
    setup_secs = time.perf_counter() - t0
    k1_1, k2_1 = dslash_ch.launches, dslash_ch_msrc.launches
    t0 = time.perf_counter()
    cold = mg_solve(mg, b, tol=tol, n_krylov=n_krylov)
    _sync(dev)
    secs_cold = time.perf_counter() - t0
    k1_2, k2_2 = dslash_ch.launches, dslash_ch_msrc.launches
    t0 = time.perf_counter()
    out = mg_solve(mg, b, tol=tol, n_krylov=n_krylov)
    _sync(dev)
    secs = time.perf_counter() - t0
    k1_3, k2_3 = dslash_ch.launches, dslash_ch_msrc.launches
    b2 = float(norm2(b))
    d128 = make_dirac(d.u.to(torch.complex128), d.params, geom)
    _, rel = true_residual(d128, out.x.to(torch.complex128),
                           b.to(torch.complex128))
    del d128
    record = {
        "solver": f"mg-{solver}", "nvec": nvec, "block": list(block),
        "n_krylov": n_krylov, "setup_secs": setup_secs,
        **{k: v for k, v in mg.setup_stats.items()},
        "iters": out.iters, "iters_cold": cold.iters, "secs": secs,
        "secs_cold": secs_cold,
        "gflops": d.flops_per_mat() * max(out.iters, 1) / secs / 1e9,
        "true_res": float(rel),
        "true_res_solve": (float(out.r2) / b2) ** 0.5,
        "k1_launches_setup": k1_1 - k1_0, "k2_launches_setup": k2_1 - k2_0,
        "k1_launches_solve": k1_3 - k1_2, "k2_launches_solve": k2_3 - k2_2,
        "k1_launches_cold_solve": k1_2 - k1_1,
        "peak_mem_bytes": (torch.cuda.max_memory_allocated(dev)
                           if dev.type == "cuda" else None)}
    return record, mg
