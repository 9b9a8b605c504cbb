"""MG setup at a volume whose canonical setup does not fit the card: the
counterpart of the JAX package's ``mg/hbm_setup.py``.

At 48³×96 with nvec 24 the canonical setup (``setup_mg``) would hold the
complex64 operator bundle (~21–30 GB) and the complex64 V (24.5 GB)
beside the multi-source null-vector solves' state (~12 GB a source,
eight sources a batch).  This setup holds the complex64 V, one solve's
state and no canonical bundle:

  1. null vectors: loose solves on the compact bf16 tier
     (``compact.invert_compact_full``, one source at a time), each
     solution written straight into its column of V
     [2, Tc,Zc,Yc,Xc, nvec, bdof] (``generate_null_vectors_device``);
  2. CholQR² in place, one coarse t row of aggregates at a time
     (``mg.transfer.block_orthonormalize``, as ``setup_mg``'s);
  3. the Galerkin coarse operator V†MV against a lean canonical
     complex64 operator (gauge and clover A, no inverse, no doubled
     gauge), built after the null vectors and freed after the build
     (``coarse_from_lean``);
  4. V cast to the bf16 pair (``vec_dtype="bf16"``), the complex V
     freed.

The result is an ``MGPreconditioner`` of ``solve_operator="compact"``
whose step tier ``dirac_sloppy`` is ``setup_mg``'s (bf16, A⁻¹ in bf16:
``mg.multigrid.step_tier``).  Its residual tier ``dirac`` is that same
operator: at 48³×96 with nvec 24 the float32 residual tier (10.2 GB
without clover) would lift the peak of the caller's float64 operator
build, 73.93 GB on an NVIDIA H100 80GB HBM3, past the card's 80 GB.
A certified solve puts the
preconditioner under a float64 defect-correction outer
(``mg.multigrid.inner_mg``, ``benchmarks.bench_mg48_dc``), which takes
the place of the residual tier.

The JAX package runs steps 2 and 3 on the host because a 16 GB chip
holds neither.  Here every step runs on the card: that is this port's
design for the volume, not a fallback, and nothing leaves the card.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from quda_qkxtm_multigrid_tpu_torch.compact import (
    CompactDirac, invert_compact_full)
from quda_qkxtm_multigrid_tpu_torch.dirac import Dirac, DiracParams
from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry
from quda_qkxtm_multigrid_tpu_torch.mg.coarse_op import CoarseOperator
from quda_qkxtm_multigrid_tpu_torch.mg.multigrid import (
    MGParams, MGPreconditioner, _build_level1, _sync, _vec_storage_cast,
    step_tier)
from quda_qkxtm_multigrid_tpu_torch.mg.transfer import (
    BlockGeometry, Transfer, block_orthonormalize, to_blocked_flat)
from quda_qkxtm_multigrid_tpu_torch.ops.clover import make_clover
from quda_qkxtm_multigrid_tpu_torch.utils import rng as _rng
from quda_qkxtm_multigrid_tpu_torch.utils.profiling import span

_DELTAS = ("delta_mu_coarse", "delta_kappa_coarse", "delta_csw_coarse",
           "delta_mu_pr", "delta_kappa_pr", "delta_csw_pr")


def generate_null_vectors_device(cd: CompactDirac, mgp: MGParams,
                                 gen: torch.Generator, bg: BlockGeometry,
                                 stats: dict | None = None) -> torch.Tensor:
    """``mgp.nvec`` loose solves of M v = ξ (ξ Gaussian, complex64, drawn
    from ``gen`` one at a time) on the compact tier ``cd`` to
    ``setup_tol``, each written into column i of the complex64
    accumulator V [2, Tc,Zc,Yc,Xc, nvec, bdof] the moment it is solved,
    so one solve's state at a time is alive beside V.  Returns V, not yet
    orthonormal; ``stats``, if given, receives the CG iterations a
    vector (``cg_iters``) and the worst solve's true residual on ``cd``
    (``null_true_res``)."""
    v = torch.empty((2,) + tuple(bg.coarse_shape) + (bg.nvec, bg.bdof),
                    dtype=torch.complex64, device=cd.g_ch.device)
    iters, worst = [], 0.0
    for i in range(bg.nvec):
        b = _rng.random_spinor(gen, bg.fine, torch.complex64)
        out = invert_compact_full(cd, b, tol=mgp.setup_tol,
                                  maxiter=mgp.setup_maxiter)
        del b
        v[..., i, :] = to_blocked_flat(out.x, bg)
        iters.append(out.iters)
        worst = max(worst, out.true_res)
    if stats is not None:
        stats.update(cg_iters=iters, null_true_res=worst)
    return v


def lean_canonical(u: torch.Tensor, params: DiracParams,
                   geom: Geometry) -> Dirac:
    """The complex64 canonical operator that the level-1 build reads
    (``mg.multigrid._level1_terms``: the clover A and the links' hops):
    ``u`` in complex64 and, for a clover kind, A from its field
    strength; no A⁻¹, no doubled gauge, no kernels."""
    u64 = u.to(torch.complex64)
    p = dataclasses.replace(params, use_kernels=False, kernel_bf16=False)
    clover = (make_clover(u64, geom, p.csw * p.kappa)
              if p.has_clover else None)
    return Dirac(u64, p, geom, clover=clover)


def coarse_from_lean(u: torch.Tensor, params: DiracParams, geom: Geometry,
                     transfer: Transfer) -> CoarseOperator:
    """The Galerkin coarse operator V†MV (complex64) of the lean
    canonical operator (``lean_canonical``), which is freed before
    returning."""
    d = lean_canonical(u, params, geom)
    coarse = _build_level1(transfer, d)
    del d
    return coarse


def setup_mg_hbm(u: torch.Tensor, params: DiracParams, geom: Geometry,
                 mgp: MGParams, gen: torch.Generator) -> tuple:
    """(MGPreconditioner, timings) of a two-level MG at a volume whose
    canonical setup does not fit (module docstring), from the gauge
    ``u`` [4,2,3,3,T,Z,W] on the card (any complex dtype; the caller
    keeps it for the certificate).

    The step tier, built from ``u``, is the operator of the null
    vectors' solves, of the V-cycle and of an ``mg_solve`` on the
    result (A⁻¹ in bf16: its Schur chain floors at ~4e-3, which the
    certifying outer absorbs as restarts).  ``gen`` draws the null
    vectors' sources.  ``mgp`` gives the blocking, nvec, setup_tol /
    setup_maxiter, the smoother and ``vec_dtype``; two levels,
    ``solve_operator="compact"``, no delta rescaling and no null-vector
    files (the JAX package's setup reads none of them: here they raise).

    ``timings``: the seconds of the step tier's build
    (``build_compact_secs``), of the null vectors, of the in-place
    CholQR² (``ortho_secs``), of the coarse build with its lean operator
    (``coarse_secs``) and of the cast of V (``cast_secs``), the card
    synchronised around each; ``mg.setup_stats`` holds them with the
    null vectors' CG iterations and worst true residual."""
    if (mgp.n_level != 2 or mgp.solve_operator != "compact"
            or any(getattr(mgp, f) != 1.0 for f in _DELTAS)
            or mgp.vec_infile or mgp.vec_outfile):
        raise ValueError("setup_mg_hbm sets up two levels on the compact "
                         "tiers: n_level 2, solve_operator 'compact', no "
                         "delta rescaling, no null-vector files")
    timings = {}

    def lap(key, t0, t):
        _sync(t)
        timings[key] = time.perf_counter() - t0

    t0 = time.perf_counter()
    cd = step_tier(u, params, geom)
    lap("build_compact_secs", t0, cd.g_ch)
    bg = BlockGeometry(geom, *mgp.block, nvec=mgp.nvec)
    stats = {}
    t0 = time.perf_counter()
    with span("setup.null_vectors"):
        v = generate_null_vectors_device(cd, mgp, gen, bg, stats)
        lap("null_vectors_secs", t0, v)
    t0 = time.perf_counter()
    with span("setup.ortho"):
        block_orthonormalize(v)
        lap("ortho_secs", t0, v)
    transfer = Transfer(v=v, bg=bg)
    del v
    t0 = time.perf_counter()
    with span("setup.coarse_build"):
        coarse = coarse_from_lean(u, params, geom, transfer)
        lap("coarse_secs", t0, coarse.y)
    t0 = time.perf_counter()
    transfer = _vec_storage_cast(transfer, mgp)
    lap("cast_secs", t0, coarse.y)
    mg = MGPreconditioner(transfer=transfer, coarse=coarse, dirac=cd,
                          dirac_sloppy=cd, params=mgp,
                          setup_stats={**stats, **timings})
    return mg, timings
