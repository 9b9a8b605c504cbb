"""Solve-level benchmark of the port: the twisted-clover CG solve.

``bench_cg`` times ``invert.invert`` on a random SU(3) gauge field and a
point source: one cold solve, then one timed warm solve.  GFLOP/s counts
one ``flops_per_mat`` per CG iteration, the JAX package's convention.
"""

from __future__ import annotations

import time

import torch

from quda_qkxtm_multigrid_tpu_torch import fields
from quda_qkxtm_multigrid_tpu_torch.dirac import Dirac, DiracParams, make_dirac
from quda_qkxtm_multigrid_tpu_torch.invert import invert
from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry
from quda_qkxtm_multigrid_tpu_torch.utils import rng


def tmc_params(use_kernels: bool = True) -> DiracParams:
    """The reference twisted-clover point: κ=0.115, μ=0.05, c_sw=1.0."""
    return DiracParams(kind="twisted-clover", kappa=0.115, mu=0.05,
                       csw=1.0, use_kernels=use_kernels)


def make_problem(geom: Geometry, device="cuda", seed: int = 7,
                 use_kernels: bool = True) -> tuple[Dirac, torch.Tensor]:
    """Random complex128 SU(3) gauge made on ``device`` from ``seed``, its
    twisted-clover operator, and the point source at (0,0,0,0), spin 0,
    colour 0."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    u = rng.random_gauge(gen, geom, dtype=torch.complex128)
    d = make_dirac(u, tmc_params(use_kernels), geom)
    b = fields.point_source(geom, (0, 0, 0, 0), 0, 0, device=device)
    return d, b


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench_cg(geom: Geometry, tol: float = 1e-7, maxiter: int = 2000,
             problem=None) -> dict:
    """Warm wall-clock of the twisted-clover CG solve (``problem`` is a
    ``(dirac, b)`` pair, made on the GPU by ``make_problem`` if not
    given)."""
    d, b = problem if problem is not None else make_problem(geom)
    dev = b.device
    cold = invert(d, b, tol=tol, maxiter=maxiter)
    _sync(dev)
    t0 = time.perf_counter()
    out = invert(d, b, tol=tol, maxiter=maxiter)
    _sync(dev)
    secs = time.perf_counter() - t0
    return {"iters": out.iters, "iters_cold": cold.iters, "secs": secs,
            "true_res": out.true_res, "true_res_cold": cold.true_res,
            "gflops": d.flops_per_mat() * max(out.iters, 1) / secs / 1e9,
            "solver": "cg-fused" if d._has_fused_matpc else "cg"}
