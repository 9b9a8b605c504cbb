"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout:

    python3 chip_smoke.py

Phases, in order; any failed check raises, so the script exits non-zero
and does not print its last line:

1. the card (``nvidia-smi``), PyTorch's version, and the build of the
   port's CUDA kernels from ``quda_qkxtm_multigrid_tpu_torch/csrc``;
2. the Wilson-hop kernel against its plain PyTorch version at 16³×32 for
   every epilogue form the solve uses, in float32 and float64;
3. operator identities of twisted-clover in complex128 at 16³×32, every
   hop through the kernel: the fused matpc†matpc chain against the plain
   composition, γ5-hermiticity, matpc adjointness, the Schur identities;
4. the twisted-clover even-odd CG solve at 32³×64 (κ=0.115, μ=0.05,
   c_sw=1.0, point source) through the kernel: iterations, time, the
   complex128 true residual, peak memory and the kernel's launch count;
   then the kernel against its plain version at that size, for a bare
   float32 hop, the float32 matpc†matpc chain and a float64 hop, with
   their times (CUDA events, median of 5);
5. the multi-source hop kernel (K2) against its plain version and
   against n single-source launches (largest difference printed; the
   sum order is K1's, so 0) at 16³×32 for n = 1, 3, 8, 12, every form
   the multigrid setup uses and both second outputs; then timed at
   32³×64 with n = 8 and 12 against its plain version and n
   single-source launches, with the second output, beside its byte
   bound and the parent's time (K2_PARENT_MS);
6. the MG-GCR-PC solve at 32³×64 on the complex64 operator (block 4⁴,
   nvec 24, even-odd smoother, GCR(5) outer, tol 1e-7): setup split
   into null vectors (through the multi-source kernel), orthonormalisation
   and coarse build; cold and warm solves; the complex128 true residual;
   the kernels' launch counts; restrict and prolong against complex128;
   a second null-vector generation split into its parts, which must run
   no stand-alone batched A⁻¹† (C6 on n sources); the V-cycle's share of
   a solve;
7. the bf16 operand tier (K1d, K2d) and the mixed-precision solve: K1d
   against its plain version at 16³×32 for every form of the bf16 chain
   and the bf16-ψ hop, and against the float32 kernel (the difference
   must show the bf16 rounding); K2d as K2 in phase 5 against n K1d
   launches; the mixed-precision CG at 32³×64 (complex128
   outer through K1's double instance, bf16 sloppy inner through K1d,
   tol 1e-10): restarts, inner iterations, time, the complex128 true
   residual, peak memory, launch counts; the same solve with the
   complex64 sloppy operator and with mixed BiCGstab; the split of a
   bf16 solve into inner and outer matvecs and complex128 stages; K1d
   timed at 32³×64 against its plain version and the float32 kernel,
   K2d as K2 in phase 5 (and in the bare form beside K2); the
   multi-source normal operator's four-hop chain against two matpc
   halves in both tiers, and its dagger half in and out of the chain;
   then a bf16-tier CG and a multi-source solve on the bf16 tier at
   16³×32;
8. the compact channel operator, the bf16 spinor storage (K1e) and the
   recon-8 gauge (K3): (a) at 16³×32 every K1e form against its plain
   version and against its float32-storage kernel (the difference must
   show the bf16 rounding), the K1d form with a float32 A⁻¹, and K3
   against its plain version and against K1 recon-12; (b)
   ``benchmarks.bench_bf16_spinor`` at 32³×64 (hop A/B, the bf16-storage
   CG floor and its mixed recovery at 16³×32) and ``bench_recon8``, then
   the K1e and K3 bare hops timed against their plain versions and
   against K1d / K1 f32 recon-12; (c) the complex128 mixed CG of phase
   7b with the compact bf16-spinor chain as its sloppy operator, beside
   the bf16 operand tier's, at 32³×64; (d) at 48³×96, the compact bf16
   tier's CG (``bench_compact``, tol 1e-6) and the same solve certified
   to 1e-9 in complex128 by a float64 defect-correction outer
   (``bench_cg48_dc``), with the peak device memory;
9. the t-sharded solve and its kernels K4 (the t-local hop) and K5 (its
   interior / edge split): (a) at 16³×32 and 32³×64, on the slab of rank
   1 of a four-way t split, its faces cut from the slabs of ranks 0
   and 2 of one global field: every K4 form of the sharded
   chain and of the sharded full operator against its plain version and
   against K1 on the global field restricted to the slab, K5 with 24-
   and 12-channel faces against K4 and its plain version; (b) at 32³×64
   ``invert(mesh=…)`` on a ring of one rank over NCCL, with K4 and with
   K5, against the unsharded CG (iterations, complex128 true residual,
   solution, warm seconds, launch counts, K4's second output's); (c) K4
   and K5 against their plain versions on (b)'s operands at T_loc = 64
   (the chain's float32 forms, the float64 hop), the sharded
   matpc†matpc on K4 with its second output against the unsharded K1
   chain in float32 and complex128 (four K4 launches, no plain A⁻¹†),
   then K4 (bare and with the second output), K5, K1, the sharded and
   unsharded chains and the plain versions timed in one call at
   32³×64, with the bounds;
10. the JAX package's stand-alone Pallas hops V1–V4 as instances of K1
    (recon-18 and recon-12 float) and K1d (bf16-ψ ``g16s16``): against
    their plain versions at 16³×32, timed at 32³×64 with their bounds;
11. the 2pt workflow (``workflows.run_twop``) at 32³×64 on the complex64
    gauge of seed 7 with the antiperiodic t boundary: the plaquette; the
    CG path, each flavour's twelve smeared columns as one multi-source
    solve through K2 (n = 12), with the iterations, each column's true
    residual certified by the plain complex128 operator, the seconds of
    each stage (APE, smearing, solve, rotation, contraction), the
    launches and the peak memory; the antiperiodic instances of K1
    float32 and K2 (n = 12) that the path launches, each hop of its
    four-hop chain on the path's operands and smeared sources, against
    their plain versions; the same 24 columns as single ``invert``
    solves through K1; the MG path with the pair of preconditioners
    (setup split, outer iterations, certified residuals, the pion
    against the CG path); the pion's sanity; ``cli.main(["twop", …])``
    at 8³×16 into a temporary directory, in single precision and in
    double (the complex128 route through K1's float64 instance).

12. the 3pt and the loops at 32³×64 on phase 11's gauge, propagators,
    smeared links and MG pair: (a) ``run_threep`` at t_sink = 12
    (G4, proton, both parts) on the CG path, each part's twelve
    sequential columns one multi-source solve through K2 (n = 12),
    every column certified by the plain complex128 operator of the
    opposite flavour, K1 / K2 against plain on the path's operands;
    (b) the same with the MG pair, its columns certified and against
    (a)'s, each insertion type against (a) at the insertion times where
    the sequential propagator is resolved;
    (c) ``run_loops`` (12 noise vectors at tol 1e-2, 2 HP/LP pairs at
    1e-7; K1), the HP solves certified in complex128, the partner's
    ``m`` through K1 against plain; (d) ``run_loops_wexact`` in
    complex128 through K1's float64 instance (Chebyshev-filtered
    Lanczos, 16 modes), the Ritz residuals, the deflated CG against the
    undeflated; (e) ``cli threep`` and ``cli loops`` at 8³×16.  Each
    stage's seconds, launches and peak memory.

13. the production MG (``phase_mg_levels``): three and four levels and
    bf16 null vectors at 32³×64, two levels at 24³×48, the light-mass
    point (``bench_light``), ``cli twop --mg --mg-levels 3``.

14. the rest of the Krylov solvers and the non-degenerate doublet
    (``phase_krylov``): (a) at 32³×64 on the complex64 reference
    operator through the K1 chain (tol 1e-7): ``pcg`` plain and with an
    MR(4, ω 0.9) preconditioner, ``pipelined_cg`` on the complex128
    chain, ``pipelined_cg_reliable`` (complex128 outer, complex64
    inner), ``mpcg`` (s = 4, its block through K2 at n = 4) as the inner
    solve of complex128 defect correction, ``simple_bicgstab`` and
    ``bicgstab_l`` (L = 2) on matpc, ``gmresdr(20, 8)`` (capped),
    ``multishift_cg_refined`` (12 shifts 1e-4…1), the chronological
    guess from 8 nearby solutions (through K2 at n = 8), ``sd`` and
    ``xsd`` (50 steps); every converged solve certified in complex128,
    the batched applies against single K1 chains; (b) the heavy doublet
    of cB211.072.64 (no clover) at 32³×64: CG through K2 at n = 2
    certified by the plain complex128 doublet, K2's n = 2 bare hop
    against plain, the 16³×32 complex128 identities (τ1γ5-hermiticity,
    Schur, ε → 0); (c) the light-mass point at 24³×48 in complex128 (K1
    f64): ``IncEigCG(8, 48)`` over a point source's first 4 columns with
    each harvest's restarts and matvecs, every column certified, then the
    acceleration on the JAX test's isolated spectrum at that size, and
    ``gmresdr`` (capped) against ``gcr``.  Each solve's seconds and K1 /
    K2 launches.

15. the gauge utilities, domain-wall / Möbius and staggered fermions
    (``phase_dw_staggered``) at 32³×64 on a random complex128 gauge of
    seed ``P15_SEED`` with the antiperiodic t boundary: (a) the
    topological charge before and after a random gauge transformation,
    ``gauge_fix_ovr`` (Coulomb, 40 iterations) and ``gauge_fix_fft``
    (Landau and Coulomb, 60): θ before and after, the plaquette
    unchanged, the seconds; (b) Shamir DWF at Ls = 8 (M5 1.5, mferm
    0.1): CG on the normal equations of ``dw4d_mat`` in complex64 on
    channels, every hop one K2 launch at n = Ls, certified by the plain
    complex128 operator, refined by complex128 defect correction (the
    outer on K1 f64 a slice) where complex64 alone does not certify;
    (c) the same for Möbius (M5 −1.5, b5 1.5, c5 0.5) and zMöbius
    (per-s b5, c5) on M_pc†M_pc; (d) asqtad links from the thin links
    with the η phases, CG on ``staggered_matpc`` at mass 0.1 (plain
    PyTorch), certified likewise; (e) K2 at n = Ls against its plain
    version, both directions, on antiperiodic and periodic links, K1
    f64 on a slice, and K2 at n = Ls timed with its byte bound.  Each
    solve's iterations, seconds and K1 / K2 launches.

16. the rest of the multi-GPU path (``phase_mesh_rest``, after phase 12,
    on its own ring of one over NCCL): (a) at 32³×64 phase 6's problem
    and setup cut by ``shard_mg``, ``mg_solve(mesh=…, solver="gcr-pc")``
    through ``benchmarks.bench_mg_mesh`` against the unsharded solve
    (outer iterations equal, the solution within 1e-5, the complex128
    certificate, K4 launched, one all-gather a V-cycle), the V-cycle's
    ms sharded and unsharded; "gcr" and "mr-richardson" the same at
    16³×32 in complex128; (b) at 16³×32, complex128, on an antiperiodic
    gauge, GCR(10) on the sharded operator plain and with the additive
    and the multiplicative Schwarz preconditioners (K1 f64 on the
    block), each certified and the preconditioned in fewer iterations,
    then the block's K1 and the sharded K4 float64 hops against plain;
    (c) ``run_twop``, ``run_threep`` and ``run_loops`` with ``mesh`` on
    phases 11–12's gauge and settings, every operator built on the slab
    (``make_sharded_dirac``): every column certified in complex128, the
    correlators and loops against phases 11–12 (the 3pt on phase 12's
    propagators, handed over whole; the 2pt's returned propagators and
    smeared links are slabs), no K1 or K2 launch, K4 and K5 against
    plain on the path's sharded operator, each run's peak memory; (d)
    ``run_loops_wexact(mesh=…)`` at 32³×64 in complex128 with phase
    12d's settings and generator seed, its Lanczos on the slab's
    M_pc†M_pc through the fused chain of K4 float64 hops (the seconds
    beside PR 13's, with the unfused operator): eigenvalues within 1e-8
    of phase 12d's, the worst Ritz residual, the loops against phase
    12d's, no K1 launch, its K4 float64 launches and stage seconds, then
    the K4
    float64 hop on the path's operands against plain and timed with its
    byte bound; (e) (run right after (a), on its whole-lattice setup)
    ``setup_mg`` on the slab's operator at 32³×64 in complex64 with
    phase 6's parameters and generator seed: its seconds against the
    whole lattice's, V and the coarse operator within 1e-5 of the whole
    lattice's setup, the warm ``mg_solve(mesh=…)`` in the same outer
    iterations, certified in complex128.  Each part's seconds and
    launches.

17. the z / w splits (``phase_box_kernels``, ``phase_box_timing``,
    ``phase_box_ranks``): (a) at 16³×32 and 32³×64, the box of one rank
    of the grids (1, 2, 1), (1, 1, 2), (2, 2, 1) and (2, 2, 2) cut from
    one global field with the t, z and y faces its exchange would
    receive: K4 on the box (``csrc/dslash_ch_box.cu``) in every form of
    the sharded chain, float32, bf16 tier and float64, with and without
    the second output, and the float64 bare hop, against its plain
    version and bit for bit against K1 on the global field restricted to
    the box; then at 32³×64 the boxes of (1, 2, 1), (1, 1, 2) and
    (1, 2, 2) timed beside K4's t-local hop, call by call and on the
    card alone (CUDA graphs), with their plain versions and bounds, and
    the box instances' registers; (b) four processes on the card as a
    (1, 2, 2) grid over gloo (``chip_smoke.py --box-rank R DIR``, each
    message staged through the host), after unsharded references made
    here: at 32³×64 ``invert(mesh=…)`` "cg" on the float32 chain and
    "cg-mixed" in complex128 on the float32 and the bf16-tier chain
    (iterations, complex128 true residual, the solution against the
    unsharded, seconds, launches), ``mg_solve(mesh=…)`` on phase 6's
    preconditioner set up again from its seed and cut by ``shard_mg``
    (the unsharded outer iterations, certified in complex128), K4 on the
    box against plain on the path's operands, the staged exchange
    timed; at 16³×32 Schwarz GCR (phase 16b's) and ``run_twop(mesh=…)``
    on the CG path against the unsharded run.  Each rank's K4 box
    launches (those with the second output too); the seconds beside PR
    14's.

18. the compact MG solve tiers and the HBM-gated setup
    (``phase_mg_compact``, ``phase_mg48``): (a) the JAX package's
    north-star configuration at 32³×64 on phase 6's problem
    (``NORTH_STAR``: nvec 24, 4⁴ blocks, bf16 V,
    ``solve_operator="compact"`` with the step tier's A⁻¹ in bf16 and
    the residual tier without its clover, GCR(5), tol 1e-7) through
    ``bench_mg``: the setup split, the iterations beside JAX's 15 and
    phase 6's, the complex128 true residual, the peak, the K1 / K1d / K2
    launches, the step tier's four hops (K1d ``f32_g16``) against plain;
    (b) ``bench_mg48_dc`` at 48³×96, nvec 24: ``setup_mg_hbm`` (null
    vectors on the compact bf16 tier, CholQR² in place, the coarse build
    against a lean complex64 operator, bf16 V), MG-GCR-PC inner solves
    under a float64 defect-correction outer certified in complex128; the
    setup split, restarts, inner iterations, ``diverged``, the peak in
    GiB and GB (under 80 GB), the K1 f64 / K1d launches, the bf16 tier's
    four hops against plain at that size and its clover fwd + xpay hop
    timed with its bound.

19. the chiral 6×6 clover kernel (C6, ``ops.dslash_kernel.clover_ch``,
    ``csrc/clover_ch.cu``; ``phase_clover6``, run after phase 2 so that
    its checks print before the long phases): at 32³×64 and 48³×96 on
    one parity, every form of the main path against the plain version
    (``dirac._ch_clover_plain``) on the same random operands, forward
    and dagger, with and without the twisted term, one source and, at
    32³×64, three: the bf16 operand with float32 and with bf16 spinors
    (the bf16 tier's A, its A⁻¹ with ``cinv_bf16``), float32 with
    float32 and bf16 spinors (the bf16 tier's A⁻¹, the float32 tier),
    float64 (the float64 tier); then at 48³×96 the bf16-operand,
    float32 and float64 forms timed against the plain version with
    their byte bounds.  Its launches are counted phase by phase over
    the main-path phases that run the operator.

20. the Möbius fifth-dimension kernel (M5, ``ops.domain_wall.mobius5_ch``,
    ``csrc/mobius5_ch.cu``; ``phase_mobius5``, run after phase 19): at
    the box of the benchmark's ``mdwf48i`` configuration (48³×24, one
    card's share of RBC/UKQCD 48I's four-card t split, Ls 24) every
    matrix of ``mobius5_matrices`` (forward and dagger) through the
    kernel, without x and with x at two coefficients, against the plain
    ``mobius5_plain`` on the same float32 operands; then Ls 8, 12, 16, 20
    and 32 at a smaller box, and the one-value-a-thread instance (a field
    off the 16-byte grid, and an odd Z·W); M5 without and with x timed
    at the box against the plain version and its byte bound
    (``portbench.m5bytes``), held to 0.6 of it.  Then the main path:
    ``invert(MobiusDirac, b, solver="cg")`` at 24³×24 with 48I's action
    (Ls 24, b5 1.5, c5 0.5, m5 −1.8, m_f 0.00078) on a hot complex64
    gauge and the benchmark unit's wall source, its M5 launches counted
    from zero (6 a CG iteration and 11 more), the answer certified in
    complex128 by the same operator off the kernel route; its CG runs
    the fused steps of phase 21 (5 launches an iteration and 2 more).

21. the fused CG steps (``ops.blas.cg_pap``, ``cg_r_update_norm``,
    ``cg_xp_update``, ``csrc/blas_cg.cu``; ``phase_cg_fused``, run after
    phase 20): on vectors of the ``mdwf48i`` cell (a half-parity 5D
    field at 48³×24, Ls 24: 764 M reals) in float32 and float64, each
    step against its plain version, then a slice off the 16-byte grid
    with a scalar tail; one fused float32 iteration timed against its
    10-pass byte bound (held to 0.8 of it), the plain steps and the
    separate eager calls they replaced.  Their launches are counted
    phase by phase, with C6's, from phase 20 on.

Phase 2b, after phase 3: a random gauge with the antiperiodic t boundary
at 16³×32 through every recon-12 form of K1 (float32, float64; V2),
K1d (V2 bf16), K1e, K2 and K2d (n = 1, 3, 12), K4 and K5 (the slabs of
a two-way split), each against its plain version and against the
recon-18 form on the same links; then the fused matpc†matpc on that
gauge against the plain complex128 composition.

Without a CUDA device, or without the port's package beside it, it exits
non-zero before printing any result.  The last line of its output is
one JSON object, {"ok": true, "device": {...}}; the line before it holds
the table of the kernels as JSON, each with its bound: the larger of
its bytes over 3.35 TB/s and its float32 operations over 67 TFLOP/s
(an H100 SXM's published peaks).
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"
T_START = time.perf_counter()

F32_LIMIT = 1e-5      # normwise relative error, float32 kernel vs plain
F64_LIMIT = 1e-12     # the same in float64, and the complex128 identities
CHECK_GEOM = (16, 16, 16, 32)
SLICE_GEOM = (32, 32, 32, 64)
SLICE_TOL, SLICE_MAXITER = 1e-7, 2000
TRUE_RES_LIMIT = 5e-7
JAX_RECORD_ITERS = 15   # the JAX package's cg32 record at this operator
MSRC_NS = (1, 3, 8, 12)  # batch widths of the multi-source kernel check
MSRC_VS_K1_LIMIT = 1e-6  # multi-source kernel vs n single-source launches
MSRC_TIME_N = 8         # the null-vector setup's batch width
MSRC_TIME_NS = (8, 12)  # timed: the setup's batch, a source's 12 columns
# K2 / K2d at 32³×64, n = 8, clover fwd + xpay, before the shared-memory
# design (time_kernels.py on that tree, in turns with this one, NVIDIA
# H100 80GB HBM3 at 700 W; PERF.md §6)
K2_PARENT_MS, K2D_PARENT_MS = 2.8115, 2.8308
PARENT_CALL = "the tree before the shared-memory design, time_kernels.py"
MG_TOL, MG_BLOCK, MG_NVEC, MG_NKRYLOV = 1e-7, (4, 4, 4, 4), 24, 5
MG_JAX_RECORD_ITERS = 15  # the JAX package's 32³×64 MG-GCR-PC record
MG_ITERS_BAND = (10, 30)
MG_TRANSFER_LIMIT = 1e-6  # complex64 restrict / prolong vs complex128

MIXED_TOL = 1e-10
MIXED_TRUE_RES_LIMIT = 5e-10
BF16_BAND = (1e-5, 2e-2)  # bf16 kernel vs float32 kernel: bf16 is read
BF16_PATH_TOL = 1e-3      # the bf16-tier CG and multi-source solves
BF16_PATH_TRUE_RES = 1e-2

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
F32_FLOPS_PER_S = 67e12    # float32 outside the tensor cores, published
F64_FLOPS_PER_S = 34e12    # float64 outside the tensor cores, published
HOP_FLOPS, CLOVER_FLOPS, XPAY_FLOPS = 1320, 504, 48   # per site

KERNEL_SOURCE = "quda_qkxtm_multigrid_tpu_torch/csrc/dslash_ch.cu"
KERNEL_REPLACES = "quda_qkxtm_multigrid_tpu/ops/dslash_pallas5.py:30"
MSRC_KERNEL_SOURCE = "quda_qkxtm_multigrid_tpu_torch/csrc/dslash_ch_msrc.cu"
MSRC_KERNEL_REPLACES = "quda_qkxtm_multigrid_tpu/ops/dslash_pallas5.py:960"
BF16_KERNEL_SOURCE = "quda_qkxtm_multigrid_tpu_torch/csrc/dslash_ch_bf16.cu"
BF16_KERNEL_REPLACES = ("quda_qkxtm_multigrid_tpu/ops/dslash_pallas5.py:512 "
                        "(bf16=True)")
BF16_MSRC_KERNEL_REPLACES = ("quda_qkxtm_multigrid_tpu/ops/"
                             "dslash_pallas5.py:960 (bf16=True)")
BF16S_KERNEL_SOURCE = "quda_qkxtm_multigrid_tpu_torch/csrc/dslash_ch_bf16s.cu"
BF16S_KERNEL_REPLACES = ("quda_qkxtm_multigrid_tpu/ops/dslash_pallas5.py:512 "
                         "(out_dtype=bf16)")
R8_KERNEL_SOURCE = "quda_qkxtm_multigrid_tpu_torch/csrc/dslash_ch_r8.cu"
R8_KERNEL_REPLACES = "quda_qkxtm_multigrid_tpu/ops/dslash_pallas5.py:91"
LOCAL_KERNEL_SOURCE = "quda_qkxtm_multigrid_tpu_torch/csrc/dslash_ch_local.cu"
LOCAL_KERNEL_REPLACES = "quda_qkxtm_multigrid_tpu/ops/dslash_pallas5.py:768"
OVERLAP_KERNEL_REPLACES = ("quda_qkxtm_multigrid_tpu/ops/dslash_pallas5.py:"
                           "842, :902")
# the stand-alone Pallas hops, each an instance of K1 / K1d (phase 10)
V1_REPLACES = ("V1 quda_qkxtm_multigrid_tpu/ops/dslash_pallas.py:233, :247 "
               "(recon-18)")
V2_REPLACES = ("V2 quda_qkxtm_multigrid_tpu/ops/dslash_pallas2.py:264 "
               "(recon-12), V3 attic/dslash_pallas3.py:247, V4 "
               "attic/dslash_pallas4.py:303")
V2_BF16_REPLACES = ("V2, V3, V4 with bf16=True: quda_qkxtm_multigrid_tpu/"
                    "ops/dslash_pallas2.py:264, attic/dslash_pallas3.py:247, "
                    "attic/dslash_pallas4.py:303")

BIG_GEOM = (48, 48, 48, 96)
CLOVER6_LIMIT = {"float32": 1e-6, "float64": 1e-13}   # C6 vs plain, normwise
CLOVER6_TWIST = 0.023            # the twisted term's a in phase 19
CLOVER6_FLOPS = 576              # 72 complex multiply-adds a site
CLOVER_KERNEL_SOURCE = "quda_qkxtm_multigrid_tpu_torch/csrc/clover_ch.cu"
CLOVER_KERNEL_REPLACES = ("no pl.pallas_call: quda_qkxtm_multigrid_tpu/"
                          "dirac.py:49 (_ch_clover_apply, an XLA pass)")
# phase 20: M5 and invert's Möbius route at RBC/UKQCD 48I's action
# (Blum et al., PRD 93 074505, Table I; m5 in QUDA's sign)
MOBIUS5_LIMIT = 1e-6             # M5 vs plain, normwise: Ls float32 products
MOBIUS5_SHARE = 0.6              # M5's least share of its byte bound
MDWF48I = dict(m5=-1.8, mferm=0.00078, b5=1.5, c5=0.5)
MDWF_LS = 24
MDWF_BOX = (48, 48, 48, 24)      # one card's box of 48I's four-card t split
MDWF_SOLVE_GEOM = (24, 24, 24, 24)
MDWF_TOL, MDWF_MAXITER = 1e-7, 2000
MDWF_TRUE_RES = 1e-5             # the mdwf48i cell's limit (PERF.md §2)
MOBIUS5_KERNEL_SOURCE = "quda_qkxtm_multigrid_tpu_torch/csrc/mobius5_ch.cu"
MOBIUS5_KERNEL_REPLACES = ("no pl.pallas_call: quda_qkxtm_multigrid_tpu/"
                           "ops/domain_wall.py:116, :158 (mdw_dslash4_pre, "
                           "mdw_dslash5_inv, XLA einsums)")
# phase 21: the fused CG steps (csrc/blas_cg.cu) at the mdwf48i vector size
CG_LIMIT = {"float32": 1e-6, "float64": 1e-13}   # normwise, vs plain
CG_SHARE = 0.8                   # a fused iteration's least share of its bound
CG_PASSES = 10                   # 2 (Re<p, Ap>) + 3 (r, |r|^2) + 5 (x, p)
CG_KERNEL_SOURCE = "quda_qkxtm_multigrid_tpu_torch/csrc/blas_cg.cu"
CG_KERNEL_REPLACES = ("no pl.pallas_call: quda_qkxtm_multigrid_tpu/"
                      "solvers/cg.py (CG's updates and reductions, XLA ops)")
COMPACT_TOL, COMPACT_MAXITER = 1e-6, 600
COMPACT_ITERS_BAND = (8, 30)     # the JAX package's compact48 record: 13
COMPACT_TRUE_RES = 1e-5
DC_TOL, DC_INNER_TOL = 1e-9, 1e-6
BF16_FLOOR_BAND = (1e-4, 1e-2)   # the JAX bf16 session record: 1.69e-3
BF16_RECOVERY_TOL, BF16_RECOVERY_LIMIT = 1e-8, 1e-7
BF16_OUT_LIMIT = 1e-4            # normwise, a bf16 output vs its plain version
F32_SUM_BOUND = 2.0 ** -20       # float32 summation order, of the largest value
DECODE_FLOPS = 480               # recon-8: ~60 flop a link, 8 links a site
CARD_BYTES = 80e9

SPLIT_NT, SPLIT_RANK = 4, 1      # 9a: the slab of rank 1 of a four-way split
LOCAL_VS_K1 = {"float32": 1e-7, "float64": 1e-14}   # K4 vs K1, normwise
OVERLAP_VS_K4 = 1e-7             # K5 vs K4, normwise, float32
MESH_X_LIMIT = 1e-5              # sharded vs unsharded solution, normwise
P16_SEED = 5                     # phase 16's Schwarz gauge and source
# phase 17, the z / w splits
BOX_KERNEL_SOURCE = "quda_qkxtm_multigrid_tpu_torch/csrc/dslash_ch_box.cu"
BOX_CHECK = ((1, 2, 1), (1, 1, 2), (2, 2, 1), (2, 2, 2))   # 17a's grids
BOX_TIME = ((1, 2, 1), (1, 1, 2), (1, 2, 2))               # 17a, timed
BOX_GRID = (1, 2, 2)             # 17b: four processes on the one card
BOX_NRANKS = 4
BOX_RANK_TIMEOUT = 600           # seconds for 17b's ranks, start-up included
K4_T_LOCAL_MS = 0.2241           # K4's bare f32 hop, T_loc 64 (PERF.md, PR 13)
# the sharded matpc†matpc before K4 had a second output (PERF.md: f32 PR 5
# call 10, complex128 PR 13), ring of one at 32³×64
CHAIN_PARENT_MS = {"f32": 3.8554, "c128": 17.3}
# phase 16 and 17b before the sharded chain (PERF.md): 16a's sharded
# V-cycle and 16d's seconds in PR 13 call 1, 17b's in PR 14's final call
MESH_PARENT = {"vcycle_ms": 40.37, "wexact_s": 100.3, "box_ranks_s": 68.2}
# K4 on a box as one launch (PR 14's final call, PERF.md), 32³×64
BOX_PARENT_MS = {"box (1, 2, 1) f32": 0.1212, "box (1, 1, 2) f32": 0.1378,
                 "box (1, 2, 2) f32": 0.0723, "box (1, 2, 2) f64": 0.1148,
                 "box (1, 2, 2) bf16": 0.0673}
SCHWARZ = dict(kind="twisted-mass", kappa=0.12, mu=0.04)   # test_parallel
SCHWARZ_TOL = 1e-8               # GCR(10) with Schwarz (test_parallel.py:93)
WEXACT_EVALS_LIMIT = 1e-8        # 16d: eigenvalues vs phase 12d, relative
SETUP_VS_WHOLE = 1e-5            # 16e: V, coarse X / Y vs the whole setup
TWOP_PEAK_GIB = 43.73            # phase 11's recorded peak memory (PERF.md)

# phase 2b, the antiperiodic t boundary: a kernel against its plain
# version, and against the recon-18 form on the same links (bf16 links:
# recon-12 rebuilds row 2 from rounded rows, recon-18 stores it rounded)
TBC_LIMIT = {"float32": 1e-7, "float64": 1e-13}
TBC_VS_R18 = {"float32": 1e-6, "float64": 1e-13, "bfloat16": 2e-2}
TBC_MSRC_NS = (1, 3, 12)

# phase 11, the 2pt workflow (the CLI's APE and Gauss defaults)
TWOP_TOL, TWOP_SOURCE = 1e-7, (0, 0, 0, 0)
TWOP_VS_SINGLES = 1e-5   # a column: multi-source vs single solve, normwise
TWOP_MG_PION = 1e-4      # the pion: MG pair vs CG, normwise
TWOP_PION_IMAG = 1e-5    # max |Im C(t)| / max |Re C(t)|, zero-momentum pion
CLI_GEOM = (8, 8, 8, 16)

# phase 12, the 3pt and the loops on phase 11's gauge and propagators
THREEP_TSINK, THREEP_PROJ = 12, "G4"      # the CLI's default projector
THREEP_MG_VS_CG = 1e-4   # each insertion type, MG vs CG (JAX test_threep_mg)
# ... on the insertion times whose sequential propagator keeps at least
# this share of its largest timeslice norm: there the solves' error, ~tol
# of the largest, stays a tenth of the limit.  Towards the source the 3pt
# of a hot gauge is set by that error (phase 12b prints it at every t).
THREEP_RESOLVED = 10 * TWOP_TOL / THREEP_MG_VS_CG
LOOPS_NSTOCH, LOOPS_TOL_LP, LOOPS_NHP = 12, 1e-2, 2
PARTNER_M_LIMIT = 1e-6   # the partner's m through K1 against plain c128
WEXACT = dict(nev=16, ncv=40, lanczos_tol=1e-8, n_stoch=4, tol=1e-9,
              cheb_degree=20)
RITZ_LIMIT = 1e-7

# phase 13, the production multigrid
GALERKIN_LIMIT = 1e-5        # D_c w vs R D P w, complex64, normwise
BF16_TRANSFER_LIMIT = 1e-5   # bf16 V restrict / prolong vs complex128
MG24_JAX_ITERS = 20          # the JAX mg24 record, GCR(10)
LIGHT_GEOM, LIGHT_PROBE_GEOM = (24, 24, 24, 48), (16, 16, 16, 32)
LIGHT_MU = 0.003
FALSE_CONVERGENCE_RATIO = 10.0   # MG: complex128 / its own residual
# the JAX light-mass records (BENCH_SESSION.jsonl:12, 14): iterations and
# residuals only
LIGHT_JAX = {"ladder": "κ 0.125: 18, 0.15: 29, 0.18: 72, 0.21: 1477",
             "cg": "1740 iterations, 1.05e-5",
             "mg_": "500 iterations (its cap), 8.60e-7",
             "mg_dmu_": "500 iterations (its cap), 8.45e-7"}

# phase 14, the Krylov tail and the non-degenerate doublet
KRYLOV_TOL = 1e-7
MPCG_S, CHRONO_DEPTH = 4, 8      # K2 at n = s and at n = the history's depth
DC_INNER = 1e-3                  # mpcg's inner tol under defect correction
# GMRES-DR's restart residual drifts in complex64 and the solve stalls
# near 4e-7 (the JAX function's too): its cycles are capped
GMRESDR_RESTARTS = 10
# the heavy doublet of ETMC's cB211.072.64 (Alexandrou et al., PRD 98
# (2018) 054518): κ, μσ, μδ; no clover term (the doublet has none)
NDEG = dict(kappa=0.1394265, mu=0.1246864, epsilon=0.1315052)
LIGHT_KAPPA = 0.21               # bench_light's κ, with LIGHT_MU
# 14c's IncEigCG sequence: 4 of a point source's 12 columns since the
# z / w splits' phase 17 joined the script (12 before, 73.8 s)
LIGHT_INC_COLUMNS = 4
# the normal equations to 1e-8: at 1e-7 the full operator's residual is
# 9.6e-7 here (κ 0.21 on a hot 24³×48 gauge), above TRUE_RES_LIMIT
LIGHT_TOL, LIGHT_MAXITER, LIGHT_GMRESDR_CAP = 1e-8, 4000, 40

# phase 15, the gauge utilities, domain-wall / Möbius and staggered
P15_SEED = 15
# phase 18: the compact MG solve tiers (18a, the JAX package's north-star
# configuration, BENCH_SESSION.jsonl:9: 15 iterations, true residual
# 1.43e-7) and the 48³×96 MG through the HBM-gated setup (18b, the JAX
# package's bench_mg48_hostdc at the reference's nvec 24)
NORTH_STAR = dict(nvec=24, block=(4, 4, 4, 4), vec_dtype="bf16",
                  solve_operator="compact")
NORTH_STAR_NKRYLOV = 5
NORTH_STAR_JAX = {"iters": 15, "true_res": 1.43e-7}
MG48 = dict(nvec=24, n_krylov=3, inner_tol=5e-3, tol=1e-8, setup_tol=1e-3,
            setup_maxiter=60)
MG48_TRUE_RES = 1e-8
CHARGE_LIMIT, PLAQ_LIMIT = 1e-10, 1e-12
# the JAX tests' iteration counts and θ gates (tests/test_io.py:195-220)
OVR_ITERS, OVR_DROP = 40, 0.5
FFT_ITERS, FFT_DROP = 60, 0.05
DW_LS = 8
SHAMIR = dict(m5=1.5, mferm=0.1)          # tests/test_staggered_dw.py:132-147
MOBIUS = dict(m5=-1.5, mferm=0.1, b5=1.5, c5=0.5)  # tests/test_mobius.py:17-21
ZMOBIUS_B5 = (1.2, 1.8)                   # per-s linspace over Ls (the
ZMOBIUS_C5 = (0.2, 0.8)                   # JAX zMöbius test)
STAG_MASS = 0.1                           # tests/test_staggered_dw.py:79-87
DW_TOL, DW_MAXITER = 1e-7, 6000
DC_INNER_DW = 1e-4        # the K2 inner solve's tol under defect correction


def _import_port():
    sys.path.insert(0, str(ROOT))
    import quda_qkxtm_multigrid_tpu_torch as pkg
    where = Path(pkg.__file__).resolve().parent.parent
    if where != ROOT:
        raise RuntimeError(f"the port was imported from {where}, not from "
                           f"this checkout ({ROOT})")


def _rel(a, b) -> float:
    return float((a - b).norm() / b.norm())


def _rel64(a, b) -> float:
    """``_rel`` in double precision: a float32 norm squares entries that
    underflow there (the 3pt at t_sink = 12 is ~1e-36)."""
    import torch
    dt = torch.complex128 if a.is_complex() else torch.float64
    return _rel(a.to(dt), b.to(dt))


def _check(label: str, value: float, limit: float):
    ok = value <= limit
    print(f"  {label:<44s} {value:.3e}  (limit {limit:.0e})  "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{label}: {value:.3e} > {limit:.0e}")


def _time_ms(fn, n: int) -> float:
    """Mean ms per call over ``n`` back-to-back calls (CUDA events: the
    port's ``benchmarks.time_ms``)."""
    from quda_qkxtm_multigrid_tpu_torch.benchmarks import time_ms
    return time_ms(fn, DEVICE, n)


def _compare_timed(kernel, plain, n_kernel=20, n_plain=3, reps=5):
    """Median ms of ``kernel`` and of ``plain``, measured in turns."""
    med = _turns({"plain": plain, "kernel": kernel},
                 {"plain": n_plain, "kernel": n_kernel}, reps)
    return med["kernel"], med["plain"]


def _turns(fns: dict, n_runs: dict, reps: int = 5) -> dict:
    """Median ms of each callable of ``fns`` over ``reps`` rounds, each
    round timing every one in turn over ``n_runs[name]`` calls, after one
    warm-up call of each."""
    import torch
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times = {k: [] for k in fns}
    for _ in range(reps):
        for k, fn in fns.items():
            times[k].append(_time_ms(fn, n_runs[k]))
    return {k: statistics.median(t) for k, t in times.items()}


def _bound(nbytes: int, flops: int, f64: bool = False):
    """(least ms, "bytes" or "operations") of a kernel that moves
    ``nbytes`` (each input read once, each output written once) and does
    ``flops`` float32 (``f64``: float64) operations."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / (F64_FLOPS_PER_S if f64 else F32_FLOPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def _compare(got, ref, label: str, limit: float) -> float:
    """Check kernel output(s) against the plain version's; returns the
    largest absolute error."""
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    _check(label, max(_rel(g, r) for g, r in zip(got, ref)), limit)
    return max(float((g - r).abs().max()) for g, r in zip(got, ref))


def phase_card():
    import torch
    from quda_qkxtm_multigrid_tpu_torch import _build
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: no GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__}  cuda {torch.version.cuda}  "
          f"python {sys.version.split()[0]}  "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    libs = _build.build()
    _build.load_library()
    print(f"kernel build {time.perf_counter() - t0:.1f} s (one nvcc per "
          f"source, in parallel) -> {libs[0].parent.relative_to(ROOT)}")
    for so in libs:
        kernel = "?"
        for line in so.with_suffix(".log").read_text().splitlines():
            entry = re.search(r"entry function '_ZN3qkx\d+(\w+?)I(\w*?)EEvNS",
                              line)
            if entry:   # the kernel and its mangled template arguments
                kernel = f"{entry.group(1)}<{entry.group(2)}>"
            elif "registers" in line or "spill" in line:
                print(f"  ptxas {so.stem} {kernel}:", line.strip())
    return smi


def _hop_cases(twist_a: float, twist_b: float, xc: float):
    cases = [(f"hop parity {p} dagger {int(dg)} recon-{12 if r12 else 18}",
              dict(parity=p, dagger=dg, recon12=r12))
             for p in (0, 1) for dg in (False, True) for r12 in (True, False)]
    tw = (-twist_a, twist_b)
    cases += [
        ("twist + xpay", dict(parity=0, recon12=True, twist=tw, xpay=xc)),
        ("twist + xpay + post twist",
         dict(parity=0, recon12=True, twist=tw, xpay=xc,
              post_op=("twist", twist_a, twist_b))),
        ("dagger twist", dict(parity=1, dagger=True, recon12=True,
                              twist=(twist_a, twist_b))),
        ("clover fwd", dict(parity=1, recon12=True, clover="fwd")),
        ("clover fwd + xpay + post clover",
         dict(parity=0, recon12=True, clover="fwd", xpay=xc,
              post_op=("clover",))),
        ("dagger clover dag", dict(parity=1, dagger=True, recon12=True,
                                   clover="dag")),
        ("dagger xpay", dict(parity=0, dagger=True, recon12=True, xpay=xc)),
    ]
    return cases


def phase_kernel_vs_plain(geom_dims):
    import torch
    from quda_qkxtm_multigrid_tpu_torch.benchmarks import tmc_params
    from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry
    from quda_qkxtm_multigrid_tpu_torch.ops.clover import make_clover_pair
    from quda_qkxtm_multigrid_tpu_torch.ops.dslash import double_gauge
    from quda_qkxtm_multigrid_tpu_torch.ops.dslash_kernel import (
        clover_channels, dslash_ch, dslash_ch_reference, gauge_channels,
        to_channels)
    from quda_qkxtm_multigrid_tpu_torch.utils import rng

    geom = Geometry(*geom_dims)
    print(f"phase 2: kernel vs plain at {geom_dims}", flush=True)
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    u = rng.random_gauge(gen, geom)
    ud = double_gauge(u, geom)
    psi = rng.random_spinor(gen, geom)
    x = rng.random_spinor(gen, geom)
    _, cinv = make_clover_pair(u, geom, tmc_params())
    kappa = 0.115
    a = 2 * kappa * 0.05
    cases = _hop_cases(a, 1 / (1 + a * a), -kappa * kappa)
    max_abs = 0.0
    for dtype, limit in ((torch.float32, F32_LIMIT),
                         (torch.float64, F64_LIMIT)):
        for label, c in cases:
            p = c["parity"]
            kw = dict(dagger=c.get("dagger", False), recon12=c["recon12"],
                      twist=c.get("twist"), post_op=c.get("post_op"))
            if "xpay" in c:
                kw.update(xpay_coef=c["xpay"],
                          x_ch=to_channels(x[p]).to(dtype))
            if "clover" in c:
                kw.update(clover=c["clover"],
                          cinv_ch=clover_channels(cinv, p, dtype))
            g_ch = gauge_channels(ud, p, c["recon12"], dtype)
            psi_ch = to_channels(psi[1 - p]).to(dtype)
            got = dslash_ch(g_ch, psi_ch, p, geom, **kw)
            torch.cuda.synchronize()
            ref = dslash_ch_reference(g_ch, psi_ch, p, geom, **kw)
            max_abs = max(max_abs, _compare(got, ref,
                                            f"{str(dtype)[6:]} {label}",
                                            limit))
    return max_abs


def phase_identities(geom_dims):
    import torch
    from quda_qkxtm_multigrid_tpu_torch.benchmarks import tmc_params
    from quda_qkxtm_multigrid_tpu_torch.dirac import make_dirac
    from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry
    from quda_qkxtm_multigrid_tpu_torch.ops.dslash_kernel import (
        dslash_ch, from_channels, to_channels)
    from quda_qkxtm_multigrid_tpu_torch.ops.gamma import apply_gamma5
    from quda_qkxtm_multigrid_tpu_torch.utils import rng

    geom = Geometry(*geom_dims)
    print(f"phase 3: twisted-clover identities, complex128, at {geom_dims}",
          flush=True)
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    u = rng.random_gauge(gen, geom)
    psi = rng.random_spinor(gen, geom)
    y = rng.random_spinor(gen, geom)
    d = make_dirac(u, tmc_params(use_kernels=True), geom)
    plain = make_dirac(u, tmc_params(use_kernels=False), geom,
                       clover=d.clover, clover_inv=d.clover_inv)
    n0 = dslash_ch.launches
    v = psi[0]
    fused = from_channels(d._fused_matpc_dagm_ch(to_channels(v)), (4, 3))
    _check("fused matpc†matpc vs plain composition",
           _rel(fused, plain.matpc(plain.matpc(v), dagger=True)), F64_LIMIT)
    for dagger in (False, True):
        _check(f"fused matpc (dagger {int(dagger)}) vs plain",
               _rel(d.matpc(v, dagger), plain.matpc(v, dagger)), F64_LIMIT)
    # γ5 M(μ) γ5 = M(−μ)†: the twist flips sign under γ5-conjugation
    flip = make_dirac(u, dataclasses.replace(d.params, flavor=-1), geom)
    _check("γ5-hermiticity γ5 M(μ) γ5 = M(−μ)†",
           _rel(apply_gamma5(d.m(apply_gamma5(psi))), flip.m(psi, True)),
           F64_LIMIT)
    lhs = torch.vdot(y[0].flatten(), d.matpc(v).flatten())
    rhs = torch.vdot(d.matpc(y[0], dagger=True).flatten(), v.flatten())
    _check("matpc adjoint <y, M x> = <M† y, x>",
           float(abs(lhs - rhs) / abs(rhs)), F64_LIMIT)
    b = d.m(psi)
    _check("Schur: matpc(x_p) = prepare(M x)",
           _rel(d.matpc(psi[0]), d.prepare(b)), F64_LIMIT)
    _check("Schur: reconstruct(x_p, M x) = x",
           _rel(d.reconstruct(psi[0], b), psi), F64_LIMIT)
    if dslash_ch.launches == n0:
        raise AssertionError("phase 3 did not launch the kernel")


def _tbc_k1(ud, cinv, psi, x, geom, err):
    """Phase 2b's K1 (float32, float64) and K1d (and V2, V2 bf16) forms:
    each recon-12 form with the boundary's sign against its plain version
    and against the recon-18 form of its tier on the same links."""
    import torch
    from quda_qkxtm_multigrid_tpu_torch.ops.dslash_kernel import (
        clover_channels, dslash_ch, dslash_ch_reference, gauge_channels,
        to_channels)
    f32, f64, b16 = torch.float32, torch.float64, torch.bfloat16
    kappa = 0.115
    a = 2 * kappa * 0.05
    cases = [(lbl, c) for lbl, c in _hop_cases(a, 1 / (1 + a * a),
                                               -kappa * kappa) if c["recon12"]]
    v2 = [(f"bf16-psi hop parity {p} dagger {int(dg)} (V2 bf16)",
           dict(parity=p, dagger=dg, psi16=True))
          for p in (0, 1) for dg in (False, True)]
    for op, name in ((f32, "k1"), (f64, "k1"), (b16, "k1d")):
        sp = f64 if op == f64 else f32
        g12 = [gauge_channels(ud, p, True, op) for p in (0, 1)]
        g18 = [gauge_channels(ud, p, False, op) for p in (0, 1)]
        ops = {"ci": [clover_channels(cinv, p, op) for p in (0, 1)]}
        tier = {f32: "K1 f32", f64: "K1 f64", b16: "K1d"}[op]
        for label, c in cases + (v2 if op == b16 else []):
            p = c["parity"]
            v = to_channels(psi[1 - p]).to(sp)
            v = v.to(b16) if c.get("psi16") else v
            kw = _bf16_kwargs(c, ops, to_channels(x[p]).to(sp), p)
            got = dslash_ch(g12[p], v, p, geom, antiperiodic=True, **kw)
            torch.cuda.synchronize()
            ref = dslash_ch_reference(g12[p], v, p, geom, antiperiodic=True,
                                      **kw)
            err[name] = max(err[name], _compare(
                got, ref, f"{tier} {label}", TBC_LIMIT[str(sp)[6:]]))
            r18 = dslash_ch(g18[p], v, p, geom, **dict(kw, recon12=False))
            _compare(got, r18, "  vs recon-18 on the same links",
                     TBC_VS_R18[str(op)[6:]])


def _tbc_k1e(ud, cinv, psi, x, geom, err):
    """Phase 2b's K1e forms (and K1d's float32-A⁻¹ form) with the sign:
    against the plain version (a bf16 output through
    ``_bf16_ulp_check``) and against K1's recon-18 form on the widened
    operands."""
    import torch
    from quda_qkxtm_multigrid_tpu_torch.ops.dslash_kernel import (
        clover_channels, dslash_ch, dslash_ch_reference, gauge_channels,
        to_channels)
    f32, b16 = torch.float32, torch.bfloat16
    kappa = 0.115
    a = 2 * kappa * 0.05
    g16 = [gauge_channels(ud, p, True, b16) for p in (0, 1)]
    g18 = [gauge_channels(ud, p, False, b16).to(f32) for p in (0, 1)]
    ci = [clover_channels(cinv, p, f32) for p in (0, 1)]
    for label, c, kern in _k1e_cases(a, 1 / (1 + a * a), -kappa * kappa):
        p = c["parity"]
        v = to_channels(psi[1 - p]).to(f32)
        xv = to_channels(x[p]).to(f32)
        kw = dict(dagger=c.get("dagger", False), recon12=True,
                  twist=c.get("twist"),
                  out_dtype=b16 if c.get("out16") else None)
        if "xpay" in c:
            kw.update(xpay_coef=c["xpay"],
                      x_ch=xv.to(b16) if c.get("x16") else xv)
        if "clover" in c:
            kw.update(clover=c["clover"], cinv_ch=ci[p])
        v_in = v.to(b16) if c.get("psi16") else v
        got = dslash_ch(g16[p], v_in, p, geom, antiperiodic=True, **kw)
        torch.cuda.synchronize()
        ref = dslash_ch_reference(g16[p], v_in, p, geom, antiperiodic=True,
                                  **kw)
        tag = f"{'K1e' if kern == 'k1e' else 'K1d'} {label}"
        if got.dtype == b16:
            err[kern] = max(err[kern], _bf16_ulp_check(tag, got, ref))
        else:
            err[kern] = max(err[kern], _compare(got, ref, tag,
                                                TBC_LIMIT["float32"]))
        wide = dict(kw, recon12=False, out_dtype=None)
        if "xpay" in c:
            wide["x_ch"] = kw["x_ch"].to(f32)
        r18 = dslash_ch(g18[p], v_in.to(f32), p, geom, **wide)
        _compare(got.to(f32), r18, "  vs K1 recon-18 on the same links",
                 TBC_VS_R18["bfloat16"])


def _tbc_k2(ud, cinv, gen, geom, err):
    """Phase 2b's K2 and K2d: every form, both second outputs, n in
    TBC_MSRC_NS, with the sign, against the plain version and n K1 (K1d)
    launches; at the largest n, clover fwd + xpay + post clover against
    the recon-18 form of the same tier."""
    import torch
    from quda_qkxtm_multigrid_tpu_torch.ops.dslash_kernel import (
        clover_channels, dslash_ch_msrc, gauge_channels, to_channels)
    from quda_qkxtm_multigrid_tpu_torch.utils import rng
    f32, b16 = torch.float32, torch.bfloat16
    kappa = 0.115
    a = 2 * kappa * 0.05
    tw = (a, 1 / (1 + a * a), -kappa * kappa)
    cases = _msrc_cases(*tw) + _msrc_post_cases(*tw)
    n = max(TBC_MSRC_NS)
    src = torch.stack([to_channels(rng.random_spinor(gen, geom)[0])
                       for _ in range(n)]).to(f32)
    xs = torch.stack([to_channels(rng.random_spinor(gen, geom)[0])
                      for _ in range(n)]).to(f32)
    for tier, op, single in (("K2", f32, "K1"), ("K2d", b16, "K1d")):
        g = [gauge_channels(ud, p, True, op) for p in (0, 1)]
        ci = [clover_channels(cinv, p, op) for p in (0, 1)]
        for k in TBC_MSRC_NS:
            e, d = _msrc_vs_singles(tier, g, ci, src[:k].contiguous(),
                                    xs[:k].contiguous(), geom, cases,
                                    single, antiperiodic=True,
                                    plain_limit=TBC_LIMIT["float32"])
            err[tier.lower()] = max(err[tier.lower()], e)
        kw = dict(clover="fwd", cinv_ch=ci[0], xpay_coef=tw[2], x_ch=xs,
                  post_op=("clover",))
        got = dslash_ch_msrc(g[0], src, 0, geom, recon12=True,
                             antiperiodic=True, **kw)
        r18 = dslash_ch_msrc(gauge_channels(ud, 0, False, op), src, 0, geom,
                             **kw)
        _compare(got, r18, f"{tier} n={n} clover fwd + xpay + post clover "
                 "vs recon-18", TBC_VS_R18[str(op)[6:]])


def _tbc_local(ud, cinv, psi, x, geom, err):
    """Phase 2b's K4 and K5: on the slabs of both ranks of a two-way t
    split (rank 0 holds global row 0, rank 1 row T−1), every form of the
    sharded path with the slab's boundary rows, against the plain
    version and against K1 with the sign on the slab's rows; K5 with 24-
    and 12-channel faces against its plain version and against K4."""
    import torch
    from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry
    from quda_qkxtm_multigrid_tpu_torch.ops.dslash_kernel import (
        clover_channels, dslash_ch, dslash_ch_local,
        dslash_ch_local_reference, dslash_ch_overlap, gauge_channels,
        to_channels)
    from quda_qkxtm_multigrid_tpu_torch.parallel.halo import project_face
    f32, f64, b16 = torch.float32, torch.float64, torch.bfloat16
    tiers = {"f32": (f32, f32), "bf16": (b16, f32), "f64": (f64, f64)}
    kappa = 0.115
    a = 2 * kappa * 0.05
    tl = geom.T // 2
    gl = Geometry(geom.X, geom.Y, geom.Z, tl)
    ops = {}
    for label, c, tier in _local_cases(a, 1 / (1 + a * a), -kappa * kappa):
        op, sp = tiers[tier]
        p, dagger, xc = c["parity"], c.get("dagger", False), c.get("xpay")
        if (op, p) not in ops:
            ops[(op, p)] = (gauge_channels(ud, p, True, op),
                            clover_channels(cinv, p, op))
        g, ci = ops[(op, p)]
        v = to_channels(psi[1 - p]).to(sp)
        xv = to_channels(x[p]).to(sp)
        kw = dict(dagger=dagger, recon12=True, twist=c.get("twist"),
                  clover=c.get("clover"), xpay_coef=xc)
        k1 = dslash_ch(g, v, p, geom, antiperiodic=True, **dict(
            kw, cinv_ch=ci if "clover" in c else None,
            x_ch=xv if xc is not None else None))
        for rank in (0, 1):
            lo, hi = rank * tl, (rank + 1) * tl
            rows = (-lo, geom.T - 1 - lo)
            kw.update(cinv_ch=ci[lo:hi].contiguous() if "clover" in c
                      else None,
                      x_ch=xv[lo:hi].contiguous() if xc is not None else None)
            gs, vs = g[lo:hi].contiguous(), v[lo:hi].contiguous()
            f24 = (v[(lo - 1) % geom.T][None].contiguous(),
                   v[hi % geom.T][None].contiguous())
            got = dslash_ch_local(gs, vs, *f24, p, gl, t_boundary=rows, **kw)
            torch.cuda.synchronize()
            ref = dslash_ch_local_reference(gs, vs, *f24, p, gl,
                                            t_boundary=rows, **kw)
            err["k4"] = max(err["k4"], _compare(
                got, ref, f"K4 rank {rank} of 2 {label}",
                TBC_LIMIT[str(sp)[6:]]))
            same = ("bit for bit" if torch.equal(got, k1[lo:hi])
                    else "not bit equal")
            _check(f"  vs K1 on the slab's rows ({same})",
                   _rel(got, k1[lo:hi]), LOCAL_VS_K1[str(sp)[6:]])
            if tier == "f64":
                continue
            for proj in (False, True):
                fm, fp = f24
                if proj:
                    fm = project_face(fm, plus=not dagger)
                    fp = project_face(fp, plus=dagger)
                got5 = dslash_ch_overlap(gs, vs, fm, fp, p, gl,
                                         faces_projected=proj,
                                         t_boundary=rows, **kw)
                torch.cuda.synchronize()
                ref5 = dslash_ch_local_reference(
                    gs, vs, fm, fp, p, gl, faces_projected=proj,
                    t_boundary=rows, **kw)
                err["k5"] = max(err["k5"], _compare(
                    got5, ref5, f"K5 rank {rank} {label}, "
                    f"{12 if proj else 24}-channel faces",
                    TBC_LIMIT[str(sp)[6:]]))
                _check("  vs K4", _rel(got5, got), OVERLAP_VS_K4)


def phase_tbc(geom_dims):
    """Phase 2b: the antiperiodic t boundary (``apply_t_boundary``) on a
    random gauge at ``geom_dims``, read back by ``antiperiodic_t``,
    through every recon-12 form of K1 (float32, float64, and V2), K1d
    (and V2 bf16), K1e, K2 and K2d (n = 1, 3, 12), K4 and K5: each
    against its plain version and against the recon-18 form on the same
    links, which carries the sign itself.  Then the fused matpc†matpc on
    that gauge against the plain complex128 composition.  Returns the
    largest absolute error of each kernel against its plain version and
    the launches the phase made."""
    import torch
    from quda_qkxtm_multigrid_tpu_torch.benchmarks import tmc_params
    from quda_qkxtm_multigrid_tpu_torch.dirac import make_dirac
    from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry
    from quda_qkxtm_multigrid_tpu_torch.ops.clover import make_clover_pair
    from quda_qkxtm_multigrid_tpu_torch.ops.dslash import double_gauge
    from quda_qkxtm_multigrid_tpu_torch.ops.dslash_kernel import (
        antiperiodic_t, from_channels, to_channels)
    from quda_qkxtm_multigrid_tpu_torch.ops.gauge import apply_t_boundary
    from quda_qkxtm_multigrid_tpu_torch.utils import rng

    geom = Geometry(*geom_dims)
    print(f"phase 2b: the antiperiodic t boundary through every recon-12 "
          f"form at {geom_dims}", flush=True)
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    u = apply_t_boundary(rng.random_gauge(gen, geom), geom)
    ud = double_gauge(u, geom)
    if not antiperiodic_t(ud):
        raise AssertionError("antiperiodic_t did not read the boundary")
    _, cinv = make_clover_pair(u, geom, tmc_params())
    psi = rng.random_spinor(gen, geom)
    x = rng.random_spinor(gen, geom)
    err = dict.fromkeys(("k1", "k1d", "k1e", "k2", "k2d", "k4", "k5"), 0.0)
    _tbc_k1(ud, cinv, psi, x, geom, err)
    _tbc_k1e(ud, cinv, psi, x, geom, err)
    _tbc_k2(ud, cinv, gen, geom, err)
    _tbc_local(ud, cinv, psi, x, geom, err)
    del ud, cinv
    d = make_dirac(u, tmc_params(use_kernels=True), geom)
    plain = make_dirac(u, tmc_params(use_kernels=False), geom,
                       clover=d.clover, clover_inv=d.clover_inv)
    v = psi[0]
    fused = from_channels(d._fused_matpc_dagm_ch(to_channels(v)), (4, 3))
    _check("fused matpc†matpc vs plain composition (complex128)",
           _rel(fused, plain.matpc(plain.matpc(v), dagger=True)), F64_LIMIT)
    return err


def phase_slice(geom_dims):
    import torch
    from quda_qkxtm_multigrid_tpu_torch.benchmarks import (
        bench_cg, make_problem)
    from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry
    from quda_qkxtm_multigrid_tpu_torch.ops.dslash import (
        WILSON_DSLASH_FLOPS_PER_SITE)
    from quda_qkxtm_multigrid_tpu_torch.ops.dslash_kernel import (
        dslash_ch, dslash_ch_reference, to_channels)
    from quda_qkxtm_multigrid_tpu_torch.utils import rng

    geom = Geometry(*geom_dims)
    print(f"phase 4: twisted-clover CG at {geom_dims}, tol {SLICE_TOL}",
          flush=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    d, b = make_problem(geom, DEVICE, seed=7)
    torch.cuda.synchronize()
    print(f"  setup (gauge, clover, inverse) {time.perf_counter() - t0:.2f} s")

    dslash_ch.launches = 0
    res = bench_cg(geom, tol=SLICE_TOL, maxiter=SLICE_MAXITER,
                   problem=(d, b))
    launches = dslash_ch.launches
    peak = torch.cuda.max_memory_allocated()

    print(f"  iters {res['iters']} (cold solve {res['iters_cold']}; JAX "
          f"record {JAX_RECORD_ITERS})  secs {res['secs']:.4f}  "
          f"true_res {res['true_res']:.3e}  GFLOP/s {res['gflops']:.1f}")
    print(f"  peak memory {peak / 2**30:.2f} GiB  kernel launches {launches}")
    if not res["iters"] < SLICE_MAXITER:
        raise AssertionError(f"CG did not converge in {SLICE_MAXITER}")
    _check("true residual (complex128, full operator)", res["true_res"],
           TRUE_RES_LIMIT)
    # per solve: 4 per CG iteration; prepare 1, rhs matpc† 2,
    # reconstruct 1, true residual 2
    expected = 4 * (res["iters"] + res["iters_cold"]) + 2 * 6
    if launches != expected:
        raise AssertionError(f"kernel launches {launches} != {expected}")

    print(f"  kernel vs plain at {geom_dims}", flush=True)
    pr = d.params.matpc_parity
    gen = torch.Generator(device=DEVICE).manual_seed(11)
    v = rng.random_spinor(gen, geom)[0]
    timings, max_abs = {}, 0.0
    for dtype, limit in ((torch.float32, F32_LIMIT),
                         (torch.float64, F64_LIMIT)):
        g = d._operands(dtype)["g"][pr]
        v_ch = to_channels(v).to(dtype)
        hop_k = lambda: dslash_ch(g, v_ch, pr, geom, recon12=True)
        hop_p = lambda: dslash_ch_reference(g, v_ch, pr, geom, recon12=True)
        name = str(dtype)[6:]
        max_abs = max(max_abs, _compare(hop_k(), hop_p(), f"{name} hop",
                                        limit))
        timings[f"{name} hop"] = _compare_timed(hop_k, hop_p)
        if dtype == torch.float32:
            chain_k = lambda: d._fused_matpc_dagm_ch(v_ch)
            chain_p = lambda: d._fused_matpc_dagm_ch(
                v_ch, hop=dslash_ch_reference)
            max_abs = max(max_abs, _compare(chain_k(), chain_p(),
                                            f"{name} matpc†matpc", limit))
            timings[f"{name} matpc†matpc"] = _compare_timed(
                chain_k, chain_p, n_kernel=10, n_plain=2)
    sites = geom.half_volume
    for label, (tk, tp) in timings.items():
        line = f"  {label:<18s} kernel {tk:.4f} ms  plain {tp:.4f} ms"
        if label.endswith("hop"):
            word = 4 if label.startswith("float32") else 8
            nbytes = (8 * 12 + 24 + 24) * word * sites
            line += (f"  kernel {WILSON_DSLASH_FLOPS_PER_SITE * sites / tk / 1e6:.1f}"
                     f" GFLOP/s, {nbytes / tk / 1e6:.1f} GB/s (min bytes)")
        print(line, flush=True)
    tk, tp = timings["float32 hop"]
    v32 = to_channels(v).to(torch.float32)
    bound = _bound(_nbytes(d._operands(torch.float32)["g"][pr], v32, v32),
                   HOP_FLOPS * sites)
    return {"launches": launches, "ms": tk, "plain_ms": tp,
            "max_abs_err": max_abs, "bound": bound, "secs": res["secs"]}


def _msrc_cases(twist_a: float, twist_b: float, xc: float):
    """The multi-source hop's forms on the path: the clover matpc halves
    and the twisted-mass ones."""
    tw = (-twist_a, twist_b)
    return [
        ("clover fwd", dict(parity=1, clover="fwd")),
        ("clover fwd + xpay", dict(parity=0, clover="fwd", xpay=xc)),
        ("dagger clover dag", dict(parity=1, dagger=True, clover="dag")),
        ("dagger xpay", dict(parity=0, dagger=True, xpay=xc)),
        ("twist", dict(parity=1, twist=tw)),
        ("twist + xpay", dict(parity=0, twist=tw, xpay=xc)),
        ("dagger twist", dict(parity=1, dagger=True,
                              twist=(twist_a, twist_b))),
    ]


def _msrc_post_cases(twist_a: float, twist_b: float, xc: float):
    """The multi-source hop's forms with a second output: the last hop of
    the forward matpc in the normal operator's four-hop chain."""
    return [
        ("clover fwd + xpay + post clover",
         dict(parity=0, clover="fwd", xpay=xc, post_op=("clover",))),
        ("twist + xpay + post twist",
         dict(parity=0, twist=(-twist_a, twist_b), xpay=xc,
              post_op=("twist", twist_a, twist_b))),
    ]


def _msrc_kwargs(c, x_b, ci, antiperiodic: bool = False):
    """Keyword arguments of ``dslash_ch_msrc`` for case ``c``, ``ci`` the
    clover-inverse channels of the case's parity."""
    kw = dict(dagger=c.get("dagger", False), recon12=True,
              twist=c.get("twist"), post_op=c.get("post_op"),
              antiperiodic=antiperiodic)
    if "xpay" in c:
        kw.update(xpay_coef=c["xpay"], x_ch=x_b)
    if "clover" in c:
        kw.update(clover=c["clover"], cinv_ch=ci)
    return kw


def _msrc_vs_singles(tier: str, g, ci, psi_b, x_b, geom, cases,
                     single_label: str, antiperiodic: bool = False,
                     plain_limit: float = F32_LIMIT) -> tuple[float, float]:
    """Each multi-source case launched once at batch width n =
    len(psi_b), counted on its tier's counter (``launches`` for K2,
    ``launches_bf16`` for K2d), held against its plain version
    (``plain_limit``) and against n single-source launches of the same
    form (MSRC_VS_K1_LIMIT; the largest absolute difference is printed,
    0 when the sum order is K1's).  ``g`` and ``ci`` are per parity;
    ``antiperiodic``: the gauge carries the antiperiodic t boundary.
    Returns the largest absolute error against plain and against the
    single launches."""
    import torch
    from quda_qkxtm_multigrid_tpu_torch.ops.dslash_kernel import (
        dslash_ch, dslash_ch_msrc, dslash_ch_msrc_reference)
    counter = "launches" if tier == "K2" else "launches_bf16"
    n = psi_b.shape[0]
    err, diff = 0.0, 0.0
    for label, c in cases:
        p = c["parity"]
        kw = _msrc_kwargs(c, x_b, ci[p], antiperiodic)
        before = getattr(dslash_ch_msrc, counter)
        got = dslash_ch_msrc(g[p], psi_b, p, geom, **kw)
        torch.cuda.synchronize()
        if getattr(dslash_ch_msrc, counter) != before + 1:
            raise AssertionError(f"dslash_ch_msrc did not count its {tier} "
                                 "launch")
        ref = dslash_ch_msrc_reference(g[p], psi_b, p, geom, **kw)
        err = max(err, _compare(got, ref, f"{tier} n={n} {label}",
                                plain_limit))
        kw1 = {k: v for k, v in kw.items() if k != "x_ch"}
        singles = [dslash_ch(g[p], psi_b[i], p, geom,
                             x_ch=None if x_b is None or "xpay" not in c
                             else x_b[i], **kw1) for i in range(n)]
        got = got if isinstance(got, tuple) else (got,)
        singles = [s if isinstance(s, tuple) else (s,) for s in singles]
        for j, out in enumerate(got):
            one = torch.stack([s[j] for s in singles])
            d = float((out - one).abs().max())
            diff = max(diff, d)
            _check(f"  out{j + 1} vs {n} {single_label} launches (largest "
                   f"|difference| {d:.1e})", _rel(out, one),
                   MSRC_VS_K1_LIMIT)
    return err, diff


def _msrc_fields(dims, n: int, seed: int, dtype):
    """Gauge and clover-inverse channels of both parities in ``dtype``
    (float32, or bfloat16 for K2d) and n float32 sources and x fields."""
    import torch
    from quda_qkxtm_multigrid_tpu_torch.benchmarks import tmc_params
    from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry
    from quda_qkxtm_multigrid_tpu_torch.ops.clover import make_clover_pair
    from quda_qkxtm_multigrid_tpu_torch.ops.dslash import double_gauge
    from quda_qkxtm_multigrid_tpu_torch.ops.dslash_kernel import (
        clover_channels, gauge_channels, to_channels)
    from quda_qkxtm_multigrid_tpu_torch.utils import rng
    geom = Geometry(*dims)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    u = rng.random_gauge(gen, geom)
    _, cinv = make_clover_pair(u, geom, tmc_params())
    ud = double_gauge(u, geom)
    g = [gauge_channels(ud, p, True, dtype) for p in (0, 1)]
    ci = [clover_channels(cinv, p, dtype) for p in (0, 1)]
    del u, ud, cinv
    psi = torch.stack([to_channels(rng.random_spinor(gen, geom)[0])
                       for _ in range(n)]).to(torch.float32)
    x = torch.stack([to_channels(rng.random_spinor(gen, geom)[0])
                     for _ in range(n)]).to(torch.float32)
    return geom, g, ci, psi, x


def _msrc_timing(tier: str, geom, g, ci, psi_all, x_all, n_list,
                 parent_ms: float) -> dict:
    """The clover fwd + xpay form of ``tier`` at each n of ``n_list``,
    timed in turns against its plain version and n single-source
    launches, and with the second output (post clover); the byte bound
    and the fraction of it.  Returns {n: {"ms", "post_ms", "plain_ms",
    "singles_ms", "bound", "err"}}."""
    from quda_qkxtm_multigrid_tpu_torch.ops.dslash_kernel import (
        dslash_ch, dslash_ch_msrc, dslash_ch_msrc_reference)
    out = {}
    for n in n_list:
        psi_b, x_b = psi_all[:n].contiguous(), x_all[:n].contiguous()
        kw = dict(recon12=True, clover="fwd", cinv_ch=ci[0],
                  xpay_coef=-0.115 ** 2, x_ch=x_b)
        kw1 = {k: v for k, v in kw.items() if k != "x_ch"}
        kern = lambda: dslash_ch_msrc(g[0], psi_b, 0, geom, **kw)
        post = lambda: dslash_ch_msrc(g[0], psi_b, 0, geom,
                                      post_op=("clover",), **kw)
        plain = lambda: dslash_ch_msrc_reference(g[0], psi_b, 0, geom, **kw)
        singles = lambda: [dslash_ch(g[0], psi_b[i], 0, geom, x_ch=x_b[i],
                                     **kw1) for i in range(n)]
        err = _compare(kern(), plain(), f"{tier} n={n} at {geom.dims}",
                       F32_LIMIT)
        med = _turns({"kernel": kern, "post": post, "singles": singles,
                      "plain": plain},
                     {"kernel": 10, "post": 10, "singles": 10, "plain": 1})
        tk, t2, t1, tp = (med[k] for k in ("kernel", "post", "singles",
                                           "plain"))
        sites = geom.half_volume
        bound = _bound(_nbytes(g[0], ci[0], psi_b, x_b, psi_b),
                       n * (HOP_FLOPS + CLOVER_FLOPS + XPAY_FLOPS) * sites)
        bound_post = _bound(_nbytes(g[0], ci[0], psi_b, x_b, psi_b, psi_b),
                            n * (HOP_FLOPS + 2 * CLOVER_FLOPS + XPAY_FLOPS)
                            * sites)
        print(f"  {tier} n={n} clover fwd + xpay {tk:.4f} ms ({tk / n:.4f} "
              f"ms a source; bound {bound[0]:.4f} ms, {bound[1]}; at "
              f"{bound[0] / tk:.2f} of it)  with post clover {t2:.4f} ms "
              f"(bound {bound_post[0]:.4f}, at {bound_post[0] / t2:.2f})  "
              f"{n} single-source launches {t1:.4f} ms  plain {tp:.4f} ms",
              flush=True)
        if n == MSRC_TIME_N and parent_ms:
            print(f"  {tier} n={n} clover fwd + xpay: {tk:.4f} ms against "
                  f"the parent's {parent_ms:.4f} ms ({PARENT_CALL}; "
                  f"{tk / parent_ms:.3f}x)", flush=True)
        out[n] = {"ms": tk, "post_ms": t2, "plain_ms": tp, "singles_ms": t1,
                  "bound": bound, "err": err}
    return out


def phase_msrc(check_dims, time_dims):
    """K2 against its plain version and against n K1 launches for every
    form, both second outputs and n in MSRC_NS at ``check_dims``; then
    timed at ``time_dims`` for n in MSRC_TIME_NS.  Returns the largest
    absolute error and the timing record of n = MSRC_TIME_N."""
    import torch
    kappa = 0.115
    a = 2 * kappa * 0.05
    tw = (a, 1 / (1 + a * a), -kappa * kappa)
    cases = _msrc_cases(*tw) + _msrc_post_cases(*tw)
    print(f"phase 5: multi-source kernel (K2) vs plain and vs n K1 "
          f"launches at {check_dims}", flush=True)
    geom, g, ci, psi_all, x_all = _msrc_fields(check_dims, max(MSRC_NS), 5,
                                               torch.float32)
    max_abs, diff = 0.0, 0.0
    for n in MSRC_NS:
        e, d = _msrc_vs_singles("K2", g, ci, psi_all[:n].contiguous(),
                                x_all[:n].contiguous(), geom, cases, "K1")
        max_abs, diff = max(max_abs, e), max(diff, d)
    print(f"  K2 vs K1: largest |difference| over every form and n "
          f"{diff:.1e}", flush=True)
    del g, ci, psi_all, x_all
    print(f"  timed at {time_dims} (clover fwd + xpay, the second hop of "
          "the forward matpc; median of 5, in turns)", flush=True)
    geom, g, ci, psi_all, x_all = _msrc_fields(time_dims, max(MSRC_TIME_NS),
                                               6, torch.float32)
    rec = _msrc_timing("K2", geom, g, ci, psi_all, x_all, MSRC_TIME_NS,
                       K2_PARENT_MS)
    k2 = dict(rec[MSRC_TIME_N])
    k2["max_abs_err"] = max(max_abs, max(r["err"] for r in rec.values()))
    return k2


def phase_mg(geom_dims):
    """MG-GCR-PC on the complex64 twisted-clover problem through
    ``benchmarks.bench_mg``: setup (null vectors through the
    multi-source kernel), a cold and a warm solve, the complex128
    certificate; then restrict and prolong against complex128 and the
    V-cycle's share of a third solve.  Returns the kernel launch counts
    of the run and the benchmark's record."""
    import torch
    from quda_qkxtm_multigrid_tpu_torch import dirac as dirac_module
    from quda_qkxtm_multigrid_tpu_torch.benchmarks import (
        bench_mg, make_problem)
    from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry
    from quda_qkxtm_multigrid_tpu_torch.mg import multigrid as multigrid_module
    from quda_qkxtm_multigrid_tpu_torch.mg.multigrid import (
        generate_null_vectors, mg_solve)
    from quda_qkxtm_multigrid_tpu_torch.mg.transfer import Transfer
    from quda_qkxtm_multigrid_tpu_torch.ops.dslash_kernel import (
        dslash_ch, dslash_ch_msrc)
    from quda_qkxtm_multigrid_tpu_torch.utils import rng

    geom = Geometry(*geom_dims)
    print(f"phase 6: twisted-clover MG-GCR-PC at {geom_dims}, complex64, "
          f"block {MG_BLOCK}, nvec {MG_NVEC}, n_krylov {MG_NKRYLOV}, "
          f"tol {MG_TOL}", flush=True)
    t0 = time.perf_counter()
    d, b = make_problem(geom, DEVICE, seed=7, dtype=torch.complex64)
    torch.cuda.synchronize()
    print(f"  operator (gauge, clover, inverse) "
          f"{time.perf_counter() - t0:.2f} s")
    dslash_ch.launches = dslash_ch_msrc.launches = 0
    rec, mg = bench_mg(geom, tol=MG_TOL, nvec=MG_NVEC, block=MG_BLOCK,
                       n_krylov=MG_NKRYLOV, problem=(d, b))
    launches = {"dslash_ch": dslash_ch.launches,
                "dslash_ch_msrc": dslash_ch_msrc.launches}
    print(f"  setup {rec['setup_secs']:.3f} s: null vectors "
          f"{rec['null_vector_secs']:.3f} s (multi-source CG iterations "
          f"per batch {rec['msrc_iters']}, worst true_res "
          f"{rec['null_true_res']:.3e}), orthonormalisation "
          f"{rec['ortho_secs']:.3f} s, coarse build "
          f"{rec['coarse_build_secs']:.3f} s")
    print(f"  outer iterations {rec['iters']} (cold solve "
          f"{rec['iters_cold']}; JAX record {MG_JAX_RECORD_ITERS})  warm "
          f"secs {rec['secs']:.4f} (cold {rec['secs_cold']:.4f})  true_res "
          f"{rec['true_res']:.3e} (complex128; complex64 solve "
          f"{rec['true_res_solve']:.3e})  GFLOP/s {rec['gflops']:.1f}")
    print(f"  peak memory {rec['peak_mem_bytes'] / 2**30:.2f} GiB  "
          f"launches {launches} (setup: dslash_ch "
          f"{rec['k1_launches_setup']}, dslash_ch_msrc "
          f"{rec['k2_launches_setup']}; warm solve: dslash_ch "
          f"{rec['k1_launches_solve']}, dslash_ch_msrc "
          f"{rec['k2_launches_solve']})", flush=True)
    _check("true residual (complex128, full operator)", rec["true_res"],
           TRUE_RES_LIMIT)
    if not MG_ITERS_BAND[0] <= rec["iters"] <= MG_ITERS_BAND[1]:
        raise AssertionError(f"outer iterations {rec['iters']} outside "
                             f"{MG_ITERS_BAND}")
    expected = 4 * sum(rec["msrc_iters"])
    if launches["dslash_ch_msrc"] != expected:
        raise AssertionError(f"dslash_ch_msrc launches "
                             f"{launches['dslash_ch_msrc']} != 4 × "
                             f"{sum(rec['msrc_iters'])}")
    if rec["k1_launches_solve"] == 0:
        raise AssertionError("the solve launched no dslash_ch")

    # restrict and prolong in complex64 against the same V and fields in
    # complex128: float32 products, not TF32 (~1e-3)
    gen = torch.Generator(device=DEVICE).manual_seed(13)
    tr = mg.transfer
    t128 = Transfer(v=tr.v.to(torch.complex128), bg=tr.bg)
    f = rng.random_spinor(gen, geom, torch.complex64)
    _check("restrict complex64 vs complex128",
           _rel(tr.restrict(f).to(torch.complex128),
                t128.restrict(f.to(torch.complex128))), MG_TRANSFER_LIMIT)
    vc = tr.restrict(f)
    _check("prolong complex64 vs complex128",
           _rel(tr.prolong(vc).to(torch.complex128),
                t128.prolong(vc.to(torch.complex128))), MG_TRANSFER_LIMIT)
    del t128, f, vc

    # where the null-vector phase's time goes: a second generation on
    # the same operator and settings, split; its multi-source matvecs
    # are the four-hop chain, so the batched A⁻¹† (a C6 launch on n
    # sources) of a stand-alone multi-source dagger half may not run
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    nv_stats, batched = {}, []
    c6 = dirac_module.clover_ch

    def spy(cinv_ch, v_ch, *args, **kwargs):
        launches = c6.launches
        out = c6(cinv_ch, v_ch, *args, **kwargs)
        if v_ch.dim() == 5:     # a batch of sources [n, T, 24, Z, W]
            batched.append(c6.launches - launches)
        return out
    dirac_module.clover_ch = spy
    dslash_ch_msrc.launches = 0
    try:
        split = _split(
            "a second null-vector generation",
            [(d, "_fused_matpc_dagm_ch", "msrc matvecs (K2, four hops)"),
             (multigrid_module, "block_orthonormalize",
              "orthonormalisation")] + [
                (d, name, "complex64 stages (prepare, rhs, reconstruct, "
                 "true residual)") for name in ("prepare", "matpc",
                                                "reconstruct", "m")],
            lambda: generate_null_vectors(d, tr.bg, gen, mg.params,
                                          stats=nv_stats))
    finally:
        dirac_module.clover_ch = c6
    msrc_second = dslash_ch_msrc.launches
    print(f"  its multi-source CG iterations per batch "
          f"{nv_stats['msrc_iters']}, K2 launches {msrc_second}, batched "
          f"A⁻¹† launches (C6) {sum(batched)}", flush=True)
    if batched:
        raise AssertionError(f"the multi-source path ran {sum(batched)} "
                             f"stand-alone batched A⁻¹† launches")
    if msrc_second != 4 * sum(nv_stats["msrc_iters"]):
        raise AssertionError(f"K2 launches {msrc_second} != 4 × "
                             f"{sum(nv_stats['msrc_iters'])}")
    rec["null_vector_split"] = split

    # the V-cycle's share of a warm solve (synchronised around each call)
    parts = {"vcycle": 0.0, "coarse_solve": 0.0}

    def timed(name, fn):
        def run(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            parts[name] += time.perf_counter() - t
            return out
        return run

    mg.coarse_solve = timed("coarse_solve", mg.coarse_solve)
    mg.vcycle = timed("vcycle", mg.vcycle)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = mg_solve(mg, b, tol=MG_TOL, n_krylov=MG_NKRYLOV)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    print(f"  split of a third solve ({out.iters} iterations, "
          f"{total:.4f} s): V-cycles {parts['vcycle']:.4f} s, of which "
          f"coarse GCR {parts['coarse_solve']:.4f} s; outer GCR and "
          f"residuals {total - parts['vcycle']:.4f} s", flush=True)
    rec["split"] = {"total": total, "iters": out.iters, **parts}
    return launches, rec


def _bf16_fields(dims, seed):
    """Random gauge, clover inverse and spinors on the card; the channel
    operands of both parities in float32 and in bf16."""
    import torch
    from quda_qkxtm_multigrid_tpu_torch.benchmarks import tmc_params
    from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry
    from quda_qkxtm_multigrid_tpu_torch.ops.clover import make_clover_pair
    from quda_qkxtm_multigrid_tpu_torch.ops.dslash import double_gauge
    from quda_qkxtm_multigrid_tpu_torch.ops.dslash_kernel import (
        clover_channels, gauge_channels)
    from quda_qkxtm_multigrid_tpu_torch.utils import rng
    geom = Geometry(*dims)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    u = rng.random_gauge(gen, geom)
    _, cinv = make_clover_pair(u, geom, tmc_params())
    ud = double_gauge(u, geom)
    ops = {dt: {"g": [gauge_channels(ud, p, True, dt) for p in (0, 1)],
                "ci": [clover_channels(cinv, p, dt) for p in (0, 1)]}
           for dt in (torch.float32, torch.bfloat16)}
    del u, ud, cinv
    return geom, gen, ops


def _bf16_kwargs(c, ops, x_ch, p):
    kw = dict(dagger=c.get("dagger", False), recon12=True,
              twist=c.get("twist"), post_op=c.get("post_op"))
    if "xpay" in c:
        kw.update(xpay_coef=c["xpay"], x_ch=x_ch)
    if "clover" in c:
        kw.update(clover=c["clover"], cinv_ch=ops["ci"][p])
    return kw


def phase_bf16_kernels(check_dims):
    """K1d against its plain version for every recon-12 form of the
    chains and for the bf16-ψ hop, and against the float32 kernel on the
    float32 operands of the same fields; K2d against its plain version
    and against n K1d launches.  Returns the largest absolute error of
    each kernel against its plain version, {"k1d": .., "k2d": ..}."""
    import torch
    from quda_qkxtm_multigrid_tpu_torch.ops.dslash_kernel import (
        dslash_ch, dslash_ch_reference, to_channels)
    from quda_qkxtm_multigrid_tpu_torch.utils import rng

    print(f"phase 7a: bf16 operand kernels vs plain and vs the float32 "
          f"kernel at {check_dims}", flush=True)
    geom, gen, ops = _bf16_fields(check_dims, 21)
    f32, b16 = torch.float32, torch.bfloat16
    psi = rng.random_spinor(gen, geom)
    x = rng.random_spinor(gen, geom)
    kappa = 0.115
    a = 2 * kappa * 0.05
    cases = [(lbl, c) for lbl, c in _hop_cases(a, 1 / (1 + a * a),
                                               -kappa * kappa)
             if c["recon12"]]
    max_abs = {"k1d": 0.0, "k2d": 0.0}
    for label, c in cases + [(f"bf16-psi hop parity {p} dagger {int(dg)}",
                              dict(parity=p, dagger=dg, psi16=True))
                             for p in (0, 1) for dg in (False, True)]:
        p = c["parity"]
        v = to_channels(psi[1 - p]).to(f32)
        xc = to_channels(x[p]).to(f32)
        kw16 = _bf16_kwargs(c, ops[b16], xc, p)
        kw32 = _bf16_kwargs(c, ops[f32], xc, p)
        v16 = v.to(b16) if c.get("psi16") else v
        before = dslash_ch.launches_bf16
        got = dslash_ch(ops[b16]["g"][p], v16, p, geom, **kw16)
        torch.cuda.synchronize()
        if dslash_ch.launches_bf16 != before + 1:
            raise AssertionError("dslash_ch did not count its bf16 launch")
        ref = dslash_ch_reference(ops[b16]["g"][p], v16, p, geom, **kw16)
        max_abs["k1d"] = max(max_abs["k1d"], _compare(
            got, ref, f"bf16 {label}", F32_LIMIT))
        k32 = dslash_ch(ops[f32]["g"][p], v16.to(f32), p, geom, **kw32)
        got = got if isinstance(got, tuple) else (got,)
        k32 = k32 if isinstance(k32, tuple) else (k32,)
        diff = max(_rel(g16, g32) for g16, g32 in zip(got, k32))
        ok = BF16_BAND[0] <= diff <= BF16_BAND[1]
        print(f"    vs float32 kernel {diff:.3e}  (band {BF16_BAND[0]:.0e}"
              f"..{BF16_BAND[1]:.0e})  {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"bf16 {label}: {diff:.3e} against the "
                                 f"float32 kernel outside {BF16_BAND}")

    tw = (a, 1 / (1 + a * a), -kappa * kappa)
    msrc = _msrc_cases(*tw) + _msrc_post_cases(*tw)
    n_max = max(MSRC_NS)
    src = torch.stack([to_channels(rng.random_spinor(gen, geom)[0])
                       for _ in range(n_max)]).to(f32)
    xs = torch.stack([to_channels(rng.random_spinor(gen, geom)[0])
                      for _ in range(n_max)]).to(f32)
    diff = 0.0
    for n in MSRC_NS:
        e, d = _msrc_vs_singles("K2d", ops[b16]["g"], ops[b16]["ci"],
                                src[:n].contiguous(), xs[:n].contiguous(),
                                geom, msrc, "K1d")
        max_abs["k2d"], diff = max(max_abs["k2d"], e), max(diff, d)
    print(f"  K2d vs K1d: largest |difference| over every form and n "
          f"{diff:.1e}", flush=True)
    return max_abs


def phase_mixed(geom_dims):
    """The slice: mixed-precision CG at ``geom_dims`` on the complex128
    operator with the bf16 sloppy operator (counts read around it), then
    the complex64 sloppy operator and mixed BiCGstab for comparison, and
    the split of a third bf16 solve.  Returns the slice's record with
    its launch counts and the split."""
    import torch
    from quda_qkxtm_multigrid_tpu_torch.benchmarks import (
        bench_cg, make_problem)
    from quda_qkxtm_multigrid_tpu_torch.dirac import as_sloppy
    from quda_qkxtm_multigrid_tpu_torch.invert import invert
    from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry
    from quda_qkxtm_multigrid_tpu_torch.ops.dslash_kernel import dslash_ch

    geom = Geometry(*geom_dims)
    print(f"phase 7b: mixed-precision twisted-clover solve at {geom_dims}, "
          f"complex128 outer, tol {MIXED_TOL}", flush=True)
    # free what earlier phases left in reference cycles (phase 6's timed
    # MG methods), so the peak memory below is this solve's own
    gc.collect()
    torch.cuda.empty_cache()
    d, b = make_problem(geom, DEVICE, seed=7)
    torch.cuda.synchronize()
    runs = {}
    for solver, sloppy in (("cg-mixed", "bf16"), ("cg-mixed", "c64"),
                           ("bicgstab-mixed", "bf16")):
        dslash_ch.launches = dslash_ch.launches_bf16 = 0
        rec = bench_cg(geom, tol=MIXED_TOL, problem=(d, b), solver=solver,
                       sloppy=sloppy)
        rec["k1"], rec["k1d"] = dslash_ch.launches, dslash_ch.launches_bf16
        runs[(solver, sloppy)] = rec
        print(f"  {rec['solver']}: restarts {rec['restarts']} (cold "
              f"{rec['restarts_cold']}), inner iterations {rec['iters']} "
              f"(cold {rec['iters_cold']}), warm secs {rec['secs']:.4f}, "
              f"diverged {rec['diverged']}, true_res {rec['true_res']:.3e} "
              f"(complex128; cold {rec['true_res_cold']:.3e}), peak memory "
              f"{rec['peak_mem_bytes'] / 2**30:.2f} GiB, launches K1 "
              f"{rec['k1']} K1d {rec['k1d']}", flush=True)
        if rec["diverged"]:
            raise AssertionError(f"{rec['solver']} diverged")
        _check(f"{rec['solver']} true residual (complex128)",
               max(rec["true_res"], rec["true_res_cold"]),
               MIXED_TRUE_RES_LIMIT)
    rec = runs[("cg-mixed", "bf16")]
    # per solve: K1 (double) prepare 1, rhs matpc† 2, 4 a restart,
    # reconstruct 1, true residual 2; K1d 4 an inner CG iteration
    want_k1 = 2 * 6 + 4 * (rec["restarts"] + rec["restarts_cold"])
    want_k1d = 4 * (rec["iters"] + rec["iters_cold"])
    if (rec["k1"], rec["k1d"]) != (want_k1, want_k1d):
        raise AssertionError(f"slice launches K1 {rec['k1']} K1d "
                             f"{rec['k1d']} != {want_k1}, {want_k1d}")

    # where a warm bf16 solve's time goes (synchronised around each call)
    sloppy = as_sloppy(d, kernel_bf16=True)
    invert(d, b, tol=MIXED_TOL, solver="cg-mixed", sloppy_dirac=sloppy)
    wrapped = [(sloppy, "_fused_matpc_dagm_ch", "inner matvec"),
               (d, "_fused_matpc_dagm_ch", "outer matvec")] + [
        (d, name, "complex128 stages")
        for name in ("prepare", "matpc", "reconstruct", "m")]
    rec["split"] = _split(
        "a third bf16 solve", wrapped,
        lambda: invert(d, b, tol=MIXED_TOL, solver="cg-mixed",
                       sloppy_dirac=sloppy))
    return rec


def _split(label: str, wrapped, run) -> dict:
    """Run ``run()`` once with a synchronised host timer around each
    wrapped callable, ``wrapped`` a list of (object, attribute, part);
    print and return the seconds of each part and of the rest (BLAS,
    conversions and host syncs)."""
    import torch
    parts = {name: 0.0 for _, _, name in wrapped}

    def timed(name, fn):
        def timed_call(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            parts[name] += time.perf_counter() - t
            return out
        return timed_call

    saved = [(obj, attr, vars(obj).get(attr)) for obj, attr, _ in wrapped]
    for obj, attr, name in wrapped:
        setattr(obj, attr, timed(name, getattr(obj, attr)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    for obj, attr, own in saved:
        if own is None:
            delattr(obj, attr)
        else:
            setattr(obj, attr, own)
    print(f"  split of {label} ({total:.4f} s): " + ", ".join(
        f"{k} {v:.4f} s" for k, v in parts.items()) + f"; BLAS, "
        f"conversions and host syncs {total - sum(parts.values()):.4f} s",
        flush=True)
    return {"total": total, **parts}


def phase_bf16_timing(geom_dims, n_time: int):
    """K1d (bare hop, matpc†matpc chain) timed in turns against its plain
    version and the float32 kernel; K2d (clover fwd + xpay) at each n of
    MSRC_TIME_NS against its plain version, n K1d launches and with the
    second output (``_msrc_timing``); the multi-source normal operator's
    four-hop chain against two matpc halves in both tiers, and the dagger
    half within the chain against the half alone.  Returns the K1d
    medians and bounds, each kernel's largest absolute error against its
    plain version here ({"k1d": .., "k2d": .., "chain bf16": ..,
    "chain f32": ..}) and K2d's record at n_time."""
    import torch
    from quda_qkxtm_multigrid_tpu_torch.benchmarks import make_problem
    from quda_qkxtm_multigrid_tpu_torch.dirac import as_sloppy
    from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry
    from quda_qkxtm_multigrid_tpu_torch.ops.dslash_kernel import (
        dslash_ch, dslash_ch_msrc, dslash_ch_reference, to_channels)
    from quda_qkxtm_multigrid_tpu_torch.utils import rng

    geom = Geometry(*geom_dims)
    print(f"phase 7c: bf16 kernels timed at {geom_dims} (median of 5, in "
          f"turns)", flush=True)
    d, _ = make_problem(geom, DEVICE, seed=7, dtype=torch.complex64)
    s = as_sloppy(d, kernel_bf16=True)
    f32 = torch.float32
    o16, o32 = s._operands(f32), d._operands(f32)
    pr = d.params.matpc_parity
    gen = torch.Generator(device=DEVICE).manual_seed(17)
    v = to_channels(rng.random_spinor(gen, geom, torch.complex64)[0])
    out = {}

    def turns(name, fns, n_runs):
        med = _turns(fns, n_runs)
        print(f"  {name:<30s} " + "  ".join(f"{k} {t:.4f} ms"
                                            for k, t in med.items()),
              flush=True)
        out[name] = med

    hop = dict(recon12=True)
    err = {}
    err["k1d"] = _compare(dslash_ch(o16["g"][pr], v, pr, geom, **hop),
                   dslash_ch_reference(o16["g"][pr], v, pr, geom, **hop),
                   f"K1d bare hop at {geom_dims}", F32_LIMIT)
    turns("K1d bare hop", {
        "bf16": lambda: dslash_ch(o16["g"][pr], v, pr, geom, **hop),
        "plain": lambda: dslash_ch_reference(o16["g"][pr], v, pr, geom,
                                             **hop),
        "f32": lambda: dslash_ch(o32["g"][pr], v, pr, geom, **hop)},
        {"bf16": 20, "plain": 3, "f32": 20})
    err["k1d"] = max(err["k1d"], _compare(
        s._fused_matpc_dagm_ch(v),
        s._fused_matpc_dagm_ch(v, hop=dslash_ch_reference),
        f"K1d matpc†matpc at {geom_dims}", F32_LIMIT))
    turns("K1d matpc†matpc", {
        "bf16": lambda: s._fused_matpc_dagm_ch(v),
        "plain": lambda: s._fused_matpc_dagm_ch(v, hop=dslash_ch_reference),
        "f32": lambda: d._fused_matpc_dagm_ch(v)},
        {"bf16": 10, "plain": 2, "f32": 10})
    sites = geom.half_volume
    # four hops: gauge of each parity twice, A⁻¹ three times (the post_op
    # reuses its load), spinors 2 + 4 + 2 + 3 times
    chain_bytes = (2 * _nbytes(*o16["g"], o16["ci"][1 - pr])
                   + _nbytes(o16["ci"][pr]) + 11 * _nbytes(v))
    bounds = {
        "K1d bare hop": _bound(_nbytes(o16["g"][pr], v, v),
                               HOP_FLOPS * sites),
        "K1d matpc†matpc": _bound(
            chain_bytes, (4 * HOP_FLOPS + 4 * CLOVER_FLOPS + 2 * XPAY_FLOPS)
            * sites)}
    for name, (ms, by) in bounds.items():
        print(f"  {name} bound {ms:.4f} ms ({by}); kernel at "
              f"{ms / out[name]['bf16']:.2f} of it", flush=True)

    # K2d at each timed width (and K2 on the same operator's float32
    # channels beside it), then the multi-source normal operator
    n_max = max(MSRC_TIME_NS)
    psi_all = torch.stack([to_channels(rng.random_spinor(
        gen, geom, torch.complex64)[0]) for _ in range(n_max)])
    x_all = torch.stack([to_channels(rng.random_spinor(
        gen, geom, torch.complex64)[0]) for _ in range(n_max)])
    k2d = _msrc_timing("K2d", geom, o16["g"], o16["ci"], psi_all, x_all,
                       MSRC_TIME_NS, K2D_PARENT_MS)
    psi_b = psi_all[:n_time].contiguous()
    turns(f"K2d n={n_time} bare hop", {
        "bf16": lambda: dslash_ch_msrc(o16["g"][0], psi_b, 0, geom,
                                       recon12=True),
        "f32": lambda: dslash_ch_msrc(o32["g"][0], psi_b, 0, geom,
                                      recon12=True)},
        {"bf16": 10, "f32": 10})
    # M_pc† M_pc on the batch: the path's four hops (the dagger half's
    # A⁻¹† the second output of the forward half) against two matpc
    # halves (the dagger half led by a C6 A⁻¹† on n sources); then each
    # dagger half alone: the chain's two hops on the forward half's
    # outputs, and the stand-alone half with its leading A⁻¹†
    def half(op, v, dagger):
        return op._fused_matpc_ch(v, dagger, hop=dslash_ch_msrc)

    for tier, op in (("bf16", s), ("f32", d)):
        err[f"chain {tier}"] = _compare(
            op._fused_matpc_dagm_ch(psi_b, hop=dslash_ch_msrc),
            half(op, half(op, psi_b, False), True),
            f"msrc four-hop chain vs two halves ({tier}, n={n_time})",
            F32_LIMIT)
    g16, c16, k = o16["g"], o16["ci"], d.params.kappa
    fwd = lambda: half(s, psi_b, False)
    m, m_pre = dslash_ch_msrc(g16[pr], dslash_ch_msrc(
        g16[1 - pr], psi_b, 1 - pr, geom, recon12=True, clover="fwd",
        cinv_ch=c16[1 - pr]), pr, geom, recon12=True, clover="fwd",
        cinv_ch=c16[pr], xpay_coef=-k * k, x_ch=psi_b, post_op=("clover",))
    chain_half = lambda: dslash_ch_msrc(g16[pr], dslash_ch_msrc(
        g16[1 - pr], m_pre, 1 - pr, geom, dagger=True, recon12=True,
        clover="dag", cinv_ch=c16[1 - pr]), pr, geom, dagger=True,
        recon12=True, xpay_coef=-k * k, x_ch=m)
    turns(f"msrc matpc†matpc n={n_time}", {
        "bf16 four hops": lambda: s._fused_matpc_dagm_ch(
            psi_b, hop=dslash_ch_msrc),
        "bf16 two halves": lambda: half(s, fwd(), True),
        "f32 four hops": lambda: d._fused_matpc_dagm_ch(
            psi_b, hop=dslash_ch_msrc),
        "f32 two halves": lambda: half(d, half(d, psi_b, False), True)},
        {k_: 5 for k_ in ("bf16 four hops", "bf16 two halves",
                          "f32 four hops", "f32 two halves")})
    turns(f"msrc matpc† half n={n_time} (bf16)", {
        "in the chain": chain_half,
        "alone": lambda: half(s, m, True)},
        {"in the chain": 5, "alone": 5})
    err["k2d"] = max(r["err"] for r in k2d.values())
    return out, bounds, err, k2d[n_time]


def phase_bf16_paths(check_dims):
    """The other paths of the bf16 tier at ``check_dims``: CG on a
    bf16-tier operator (prepare and reconstruct through the bf16-ψ hop)
    and the multi-source solve on it (K2d), each with its launch counts
    read around it.  Returns the K1d and K2d counts."""
    import torch
    from quda_qkxtm_multigrid_tpu_torch.benchmarks import make_problem
    from quda_qkxtm_multigrid_tpu_torch.invert import invert, invert_msrc
    from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry
    from quda_qkxtm_multigrid_tpu_torch.ops.dslash_kernel import (
        dslash_ch, dslash_ch_msrc)

    geom = Geometry(*check_dims)
    print(f"phase 7d: bf16-tier CG and multi-source solve at {check_dims}, "
          f"tol {BF16_PATH_TOL}", flush=True)
    d, b = make_problem(geom, DEVICE, seed=9, bf16=True)
    dslash_ch.launches = dslash_ch.launches_bf16 = 0
    res = invert(d, b, tol=BF16_PATH_TOL)
    k1d, k1 = dslash_ch.launches_bf16, dslash_ch.launches
    print(f"  CG: {res.iters} iterations, true_res {res.true_res:.3e}, "
          f"launches K1d {k1d} K1 {k1}", flush=True)
    _check("bf16-tier CG true residual", res.true_res, BF16_PATH_TRUE_RES)
    if (k1d, k1) != (4 * res.iters + 6, 0):
        raise AssertionError(f"bf16-tier CG launches K1d {k1d} K1 {k1} != "
                             f"{4 * res.iters + 6}, 0")
    bs = torch.stack([b, torch.roll(b, 1, dims=-1), 1j * b])
    dslash_ch.launches_bf16 = dslash_ch_msrc.launches_bf16 = 0
    dslash_ch_msrc.launches = 0
    res = invert_msrc(d, bs, tol=BF16_PATH_TOL)
    k2d, k2 = dslash_ch_msrc.launches_bf16, dslash_ch_msrc.launches
    print(f"  multi-source CG, n=3: {res.iters} iterations, worst true_res "
          f"{res.true_res:.3e}, launches K2d {k2d} K2 {k2} K1d "
          f"{dslash_ch.launches_bf16}", flush=True)
    _check("bf16-tier multi-source worst true residual", res.true_res,
           BF16_PATH_TRUE_RES)
    if (k2d, k2) != (4 * res.iters, 0):
        raise AssertionError(f"multi-source launches K2d {k2d} K2 {k2} != "
                             f"{4 * res.iters}, 0")
    return k1d + dslash_ch.launches_bf16, k2d


def _bf16_ulp_check(label: str, got, ref) -> float:
    """A bf16 output against its plain version.  Both round a float32
    result once; the two float32 results differ by the summation order
    (the kernel fuses multiply-adds), which is ~1e-7 of the terms.  So
    every element must lie within one bf16 ulp of the plain one, except
    where that order's difference is itself larger than an ulp: where the
    sum cancels to a small value, at most F32_SUM_BOUND of the output's
    largest value.  The normwise difference must stay within
    BF16_OUT_LIMIT.  Returns the largest absolute error."""
    import torch
    g, r = got.float(), ref.float()
    d = (g - r).abs()
    _, e = torch.frexp(torch.maximum(g.abs(), r.abs()))
    ulp = torch.ldexp(torch.ones_like(g), e - 8)
    beyond = d > ulp
    bound = F32_SUM_BOUND * float(r.abs().max())
    n_beyond, n_bad = int(beyond.sum()), int((beyond & (d > bound)).sum())
    worst = float((d / ulp).max())
    print(f"    largest difference {worst:.2f} bf16 ulp; {n_beyond} of "
          f"{d.numel()} elements beyond one ulp, {n_bad} of them above "
          f"the float32 summation bound {bound:.2e}", flush=True)
    if n_bad:
        raise AssertionError(f"{label}: {n_bad} elements more than one "
                             "bf16 ulp apart beyond float32 summation")
    _check(label, _rel(g, r), BF16_OUT_LIMIT)
    return float(d.max())


def _k1e_cases(twist_a: float, twist_b: float, xc: float):
    """The forms of the compact chains, each with ψ, x and out dtypes:
    (label, case, counter).  The float32-A⁻¹ K1d form is the dagger hop
    after the plain A⁻¹† of the bf16-storage clover chain."""
    tw = (-twist_a, twist_b)
    return [
        ("o16 clover fwd", dict(parity=1, clover="fwd", out16=True), "k1e"),
        ("o16 twist", dict(parity=1, twist=tw, out16=True), "k1e"),
        ("s16o16 clover fwd + xpay",
         dict(parity=0, clover="fwd", xpay=xc, psi16=True, out16=True), "k1e"),
        ("s16o16 twist + xpay",
         dict(parity=0, twist=tw, xpay=xc, psi16=True, out16=True), "k1e"),
        ("s16o16 bare", dict(parity=1, psi16=True, out16=True), "k1e"),
        ("s16o16 bare dagger",
         dict(parity=0, dagger=True, psi16=True, out16=True), "k1e"),
        ("x16 dagger xpay", dict(parity=0, dagger=True, xpay=xc, x16=True),
         "k1e"),
        ("s16 dagger twist", dict(parity=1, dagger=True,
                                  twist=(twist_a, twist_b), psi16=True),
         "k1e"),
        ("g16c32 dagger clover dag",
         dict(parity=1, dagger=True, clover="dag"), "k1d"),
    ]


def phase_k1e_k3_kernels(check_dims):
    """Phase 8a: every K1e form (and the float32-A⁻¹ K1d form) against
    its plain version and against the float32-storage kernel of the same
    operation; K3 against its plain version and against K1 recon-12, in
    every epilogue form.  Returns the largest absolute error of each
    kernel against its plain version, {"k1e": .., "k1d": .., "k3": ..}."""
    import torch
    from quda_qkxtm_multigrid_tpu_torch.benchmarks import tmc_params
    from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry
    from quda_qkxtm_multigrid_tpu_torch.ops.clover import make_clover_pair
    from quda_qkxtm_multigrid_tpu_torch.ops.dslash import double_gauge
    from quda_qkxtm_multigrid_tpu_torch.ops.dslash_kernel import (
        clover_channels, dslash_ch, dslash_ch_reference, gauge_channels,
        to_channels)
    from quda_qkxtm_multigrid_tpu_torch.utils import rng

    print(f"phase 8a: bf16 spinor storage (K1e) and recon-8 (K3) kernels vs "
          f"plain at {check_dims}", flush=True)
    geom = Geometry(*check_dims)
    gen = torch.Generator(device=DEVICE).manual_seed(31)
    u = rng.random_gauge(gen, geom)
    _, cinv = make_clover_pair(u, geom, tmc_params())
    ud = double_gauge(u, geom)
    f32, b16 = torch.float32, torch.bfloat16
    g16 = [gauge_channels(ud, p, True, b16) for p in (0, 1)]
    g32 = [gauge_channels(ud, p, True, f32) for p in (0, 1)]
    g8 = [gauge_channels(ud, p, False, f32, recon8=True) for p in (0, 1)]
    ci = [clover_channels(cinv, p, f32) for p in (0, 1)]
    del u, ud, cinv
    psi = rng.random_spinor(gen, geom)
    x = rng.random_spinor(gen, geom)
    kappa = 0.115
    a = 2 * kappa * 0.05
    b = 1 / (1 + a * a)
    counters = {"k1e": "launches_bf16s", "k1d": "launches_bf16"}
    err = {"k1e": 0.0, "k1d": 0.0, "k3": 0.0}
    for label, c, kern in _k1e_cases(a, b, -kappa * kappa):
        p = c["parity"]
        v = to_channels(psi[1 - p]).to(f32)
        xv = to_channels(x[p]).to(f32)
        kw = dict(dagger=c.get("dagger", False), recon12=True,
                  twist=c.get("twist"),
                  out_dtype=b16 if c.get("out16") else None)
        kw32 = dict(kw, out_dtype=None)
        if "xpay" in c:
            kw.update(xpay_coef=c["xpay"],
                      x_ch=xv.to(b16) if c.get("x16") else xv)
            kw32.update(xpay_coef=c["xpay"], x_ch=xv)
        if "clover" in c:
            kw.update(clover=c["clover"], cinv_ch=ci[p])
            kw32.update(clover=c["clover"], cinv_ch=ci[p])
        v_in = v.to(b16) if c.get("psi16") else v
        name = counters[kern]
        before = getattr(dslash_ch, name)
        got = dslash_ch(g16[p], v_in, p, geom, **kw)
        torch.cuda.synchronize()
        if getattr(dslash_ch, name) != before + 1:
            raise AssertionError(f"{label}: dslash_ch.{name} did not count "
                                 "the launch")
        ref = dslash_ch_reference(g16[p], v_in, p, geom, **kw)
        if got.dtype == b16:
            err[kern] = max(err[kern], _bf16_ulp_check(f"K1e {label}", got,
                                                       ref))
        else:
            err[kern] = max(err[kern], _compare(
                got, ref, f"{'K1e' if kern == 'k1e' else 'K1d'} {label}",
                F32_LIMIT))
        k32 = dslash_ch(g16[p], v, p, geom, **kw32)
        if kern == "k1e":
            diff = _rel(got.float(), k32)
            ok = BF16_BAND[0] <= diff <= BF16_BAND[1]
            print(f"    vs float32-storage kernel {diff:.3e}  (band "
                  f"{BF16_BAND[0]:.0e}..{BF16_BAND[1]:.0e})  "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                raise AssertionError(f"K1e {label}: {diff:.3e} against the "
                                     f"float32-storage kernel outside "
                                     f"{BF16_BAND}")

    for label, c in _hop_cases(a, b, -kappa * kappa):
        if not c["recon12"]:
            continue
        p = c["parity"]
        kw = dict(dagger=c.get("dagger", False), twist=c.get("twist"),
                  post_op=c.get("post_op"))
        if "xpay" in c:
            kw.update(xpay_coef=c["xpay"], x_ch=to_channels(x[p]).to(f32))
        if "clover" in c:
            kw.update(clover=c["clover"], cinv_ch=ci[p])
        v = to_channels(psi[1 - p]).to(f32)
        before = dslash_ch.launches_r8
        got = dslash_ch(g8[p], v, p, geom, recon8=True, **kw)
        torch.cuda.synchronize()
        if dslash_ch.launches_r8 != before + 1:
            raise AssertionError("dslash_ch did not count its recon-8 launch")
        ref = dslash_ch_reference(g8[p], v, p, geom, recon8=True, **kw)
        err["k3"] = max(err["k3"], _compare(got, ref, f"K3 {label}",
                                            F32_LIMIT))
        r12 = dslash_ch(g32[p], v, p, geom, recon12=True, **kw)
        _compare(got, r12, f"K3 {label} vs K1 recon-12", F32_LIMIT)
    return err


def phase_bf16_spinor(time_dims, check_dims):
    """Phase 8b: ``bench_bf16_spinor`` and ``bench_recon8`` at
    ``time_dims`` (the paths of K1e and K3, counted around each; their
    records hold the kernels' times: K1e against K1d, K3 against K1 f32
    recon-12), then the K1e and K3 bare hops against their plain
    versions, checked and the plain versions timed.  Returns the
    launches, the times, the bounds and the largest errors."""
    import torch
    from quda_qkxtm_multigrid_tpu_torch.benchmarks import (
        bench_bf16_spinor, bench_recon8, median_ms)
    from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry
    from quda_qkxtm_multigrid_tpu_torch.ops.dslash import double_gauge
    from quda_qkxtm_multigrid_tpu_torch.ops.dslash_kernel import (
        dslash_ch, dslash_ch_reference, gauge_channels, to_channels)
    from quda_qkxtm_multigrid_tpu_torch.utils import rng

    geom = Geometry(*time_dims)
    print(f"phase 8b: bench_bf16_spinor at {time_dims} (CG at "
          f"{check_dims}) and bench_recon8", flush=True)
    dslash_ch.launches_bf16s = 0
    rec = bench_bf16_spinor(geom, Geometry(*check_dims), DEVICE)
    k1e = dslash_ch.launches_bf16s
    print(f"  hop: float32 spinors {rec['f32_spinor_ms']:.4f} ms "
          f"({rec['f32_spinor_gflops']:.1f} GFLOP/s), bf16 spinors "
          f"{rec['bf16_spinor_ms']:.4f} ms ({rec['bf16_spinor_gflops']:.1f}"
          f" GFLOP/s)", flush=True)
    print(f"  bf16-storage CG floor {rec['bf16_storage_cg_floor']:.3e} after "
          f"{rec['bf16_storage_cg_iters']} iterations (JAX record 1.69e-3 "
          f"after 22); mixed recovery to {BF16_RECOVERY_TOL:.0e}: true_res "
          f"{rec['mixed_bf16_true_res']:.3e} (JAX 7.42e-8), inner "
          f"iterations {rec['mixed_bf16_iters']} (JAX 63), restarts "
          f"{rec['mixed_bf16_restarts']}, diverged "
          f"{rec['mixed_bf16_diverged']}; K1e launches {k1e}", flush=True)
    lo, hi = BF16_FLOOR_BAND
    if not lo <= rec["bf16_storage_cg_floor"] <= hi:
        raise AssertionError(f"bf16-storage floor "
                             f"{rec['bf16_storage_cg_floor']:.3e} outside "
                             f"{BF16_FLOOR_BAND}")
    if rec["mixed_bf16_diverged"]:
        raise AssertionError("the mixed recovery diverged")
    _check("mixed recovery true residual", rec["mixed_bf16_true_res"],
           BF16_RECOVERY_LIMIT)
    if k1e == 0:
        raise AssertionError("bench_bf16_spinor launched no K1e")
    dslash_ch.launches_r8 = 0
    r8 = bench_recon8(geom, DEVICE)
    k3 = dslash_ch.launches_r8
    print(f"  recon-8 hop {r8['recon8_ms']:.4f} ms "
          f"({r8['recon8_gflops']:.1f} GFLOP/s), recon-12 "
          f"{r8['recon12_ms']:.4f} ms; K3 launches {k3}", flush=True)
    _check("K3 vs K1 recon-12 (bench_recon8)", r8["recon8_vs_recon12"],
           F32_LIMIT)
    if k3 == 0:
        raise AssertionError("bench_recon8 launched no K3")

    print(f"  K1e and K3 bare hops at {time_dims} against their plain "
          f"versions (plain timed, median of 5)", flush=True)
    gen = torch.Generator(device=DEVICE).manual_seed(41)
    ud = double_gauge(rng.random_gauge(gen, geom), geom)
    f32, b16 = torch.float32, torch.bfloat16
    g16 = gauge_channels(ud, 0, True, b16)
    g8 = gauge_channels(ud, 0, False, f32, recon8=True)
    del ud
    v = to_channels(rng.random_spinor(gen, geom)[1]).to(f32)
    v16 = v.to(b16)
    k1e_plain = lambda: dslash_ch_reference(g16, v16, 0, geom, recon12=True,
                                            out_dtype=b16)
    k3_plain = lambda: dslash_ch_reference(g8, v, 0, geom, recon8=True)
    err = {"k1e": _bf16_ulp_check(
               f"K1e bare hop at {time_dims}",
               dslash_ch(g16, v16, 0, geom, recon12=True, out_dtype=b16),
               k1e_plain()),
           "k3": _compare(dslash_ch(g8, v, 0, geom, recon8=True), k3_plain(),
                          f"K3 bare hop at {time_dims}", F32_LIMIT)}
    med = {"K1e": rec["bf16_spinor_ms"], "K1d": rec["f32_spinor_ms"],
           "K3": r8["recon8_ms"], "K1 f32": r8["recon12_ms"],
           "K1e plain": median_ms(k1e_plain, DEVICE, n=3),
           "K3 plain": median_ms(k3_plain, DEVICE, n=3)}
    print("  " + "  ".join(f"{k} {t:.4f} ms" for k, t in med.items()),
          flush=True)
    sites = geom.half_volume
    bounds = {"k1e": _bound(_nbytes(g16, v16, v16), HOP_FLOPS * sites),
              "k3": _bound(_nbytes(g8, v, v),
                           (HOP_FLOPS + DECODE_FLOPS) * sites)}
    for k, key in (("k1e", "K1e"), ("k3", "K3")):
        ms, by = bounds[k]
        print(f"  {key} bound {ms:.4f} ms ({by}); kernel at "
              f"{ms / med[key]:.2f} of it", flush=True)
    return {"k1e": k1e, "k3": k3, "times": med, "bounds": bounds,
            "err": err, "record": rec, "recon8": r8}


def _compact_chain_forms(cd, v, x, storage):
    """The four hops of the clover Schur chain ``cd.matpc_dagm_ch(v,
    storage)`` on channel spinors ``v`` and ``x`` of ``cd``'s spinor
    dtype, with ψ, x and the output in the dtypes that chain gives them:
    (label, kernel, parity, ψ, keyword arguments of ``cd._hop``)."""
    pr, k = cd.params.matpc_parity, cd.params.kappa
    ci = cd.cinv_ch
    if storage is None:
        fwd, last, s, xs, o = "K1d", "K1d", v, x, {}
    else:
        fwd, last, s, xs, o = ("K1e", "K1e", v.to(storage), x.to(storage),
                               dict(out_dtype=storage))
    return [
        ("clover fwd", fwd, 1 - pr, v,
         dict(clover="fwd", cinv_ch=ci[1 - pr], **o)),
        ("clover fwd + xpay", fwd, pr, s,
         dict(clover="fwd", cinv_ch=ci[pr], xpay_coef=-k * k, x_ch=x, **o)),
        ("dagger clover dag", "K1d", 1 - pr, v,
         dict(dagger=True, clover="dag", cinv_ch=ci[1 - pr])),
        ("dagger xpay", last, pr, v,
         dict(dagger=True, xpay_coef=-k * k, x_ch=xs)),
    ]


def _compact_forms_check(cd, forms, where: str) -> dict:
    """Each of ``forms`` (``_compact_chain_forms``' tuples) launched once
    through ``cd._hop`` on ``cd``'s own channels and held against its
    plain version: float32 outputs within F32_LIMIT, float64 within
    F64_LIMIT, bf16 outputs by ``_bf16_ulp_check``.  Returns the largest
    absolute error of each kernel, keyed by its name."""
    import torch
    from quda_qkxtm_multigrid_tpu_torch.ops.dslash_kernel import (
        dslash_ch_reference)
    err = {}
    for label, kern, p, psi, kw in forms:
        got = cd._hop(p, psi, **kw)
        torch.cuda.synchronize()
        ref = dslash_ch_reference(cd.g_ch[p], psi, p, cd.geom, recon12=True,
                                  **kw)
        name = f"{kern} {label} {where}"
        if got.dtype == torch.bfloat16:
            e = _bf16_ulp_check(name, got, ref)
        else:
            e = _compare(got, ref, name, F64_LIMIT
                         if got.dtype == torch.float64 else F32_LIMIT)
        del got, ref
        err[kern] = max(err.get(kern, 0.0), e)
    return err


def phase_compact_mixed(geom_dims):
    """Phase 8c: the complex128 mixed CG of phase 7b (same operator,
    source and tol) with the compact bf16-spinor chain as the sloppy
    operator (``bench_compact_sloppy``: K1e), beside the bf16 operand
    tier's (``bench_cg``: K1d), each with its launch counts read around
    it; then the split of a third compact-sloppy solve, and each hop of
    the compact chain against its plain version at this size on the
    compact operator's own channels.  Returns the compact run's record,
    with those errors under "err"."""
    import torch
    from quda_qkxtm_multigrid_tpu_torch import compact, dirac
    from quda_qkxtm_multigrid_tpu_torch.benchmarks import (
        bench_cg, bench_compact_sloppy, compact_sloppy_solve, make_problem)
    from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry
    from quda_qkxtm_multigrid_tpu_torch.ops.dslash_kernel import (
        dslash_ch, to_channels)
    from quda_qkxtm_multigrid_tpu_torch.utils import rng

    geom = Geometry(*geom_dims)
    print(f"phase 8c: mixed-precision solve at {geom_dims} with the compact "
          f"bf16-spinor sloppy chain, complex128 outer, tol {MIXED_TOL}",
          flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    d, b = make_problem(geom, DEVICE, seed=7)
    runs = {}
    for sloppy in ("bf16", "compact-bf16"):
        dslash_ch.launches = dslash_ch.launches_bf16 = 0
        dslash_ch.launches_bf16s = 0
        if sloppy == "bf16":
            rec = bench_cg(geom, tol=MIXED_TOL, problem=(d, b),
                           solver="cg-mixed", sloppy="bf16")
        else:
            rec, cd = bench_compact_sloppy(geom, tol=MIXED_TOL,
                                           problem=(d, b))
        rec.update(k1=dslash_ch.launches, k1d=dslash_ch.launches_bf16,
                   k1e=dslash_ch.launches_bf16s)
        runs[sloppy] = rec
        print(f"  {rec['solver']}: restarts {rec['restarts']} (cold "
              f"{rec['restarts_cold']}), inner iterations {rec['iters']} "
              f"(cold {rec['iters_cold']}), warm secs {rec['secs']:.4f}, "
              f"diverged {rec['diverged']}, true_res {rec['true_res']:.3e} "
              f"(complex128; cold {rec['true_res_cold']:.3e}), peak memory "
              f"{rec['peak_mem_bytes'] / 2**30:.2f} GiB, launches K1 "
              f"{rec['k1']} K1d {rec['k1d']} K1e {rec['k1e']}", flush=True)
        if rec["diverged"]:
            raise AssertionError(f"{rec['solver']} diverged")
        _check(f"{rec['solver']} true residual (complex128)",
               max(rec["true_res"], rec["true_res_cold"]),
               MIXED_TRUE_RES_LIMIT)
    rec = runs["compact-bf16"]
    # per solve: K1 (double) 2·6 + 4 a restart; an inner iteration: three
    # K1e hops and the K1d hop after the plain A⁻¹†
    inner = rec["iters"] + rec["iters_cold"]
    want = (2 * 6 + 4 * (rec["restarts"] + rec["restarts_cold"]), inner,
            3 * inner)
    if (rec["k1"], rec["k1d"], rec["k1e"]) != want or rec["k1e"] == 0:
        raise AssertionError(f"compact sloppy launches K1 {rec['k1']} K1d "
                             f"{rec['k1d']} K1e {rec['k1e']} != {want}")
    # where a warm compact-sloppy solve's time goes
    rec["split"] = _split(
        "a third compact-sloppy solve",
        [(cd, "_hop", "inner hops (K1e, K1d)"),
         (dirac, "_ch_clover_apply", "inner 6×6 A⁻¹† on bf16 (clover_ch)"),
         (d, "_fused_matpc_dagm_ch", "outer matvec")] + [
            (d, name, "complex128 stages")
            for name in ("prepare", "matpc", "reconstruct", "m")],
        lambda: compact_sloppy_solve(d, cd, b, tol=MIXED_TOL))
    psi = rng.random_spinor(torch.Generator(device=DEVICE).manual_seed(47),
                            geom)
    v, x = (to_channels(psi[p]).to(torch.float32) for p in (0, 1))
    rec["err"] = _compact_forms_check(
        cd, _compact_chain_forms(cd, v, x, torch.bfloat16),
        f"at {geom_dims}")
    rec["k1d_sloppy_run"] = runs["bf16"]
    return rec


def phase_compact48(geom_dims):
    """Phase 8d: the compact bf16 tier at ``geom_dims`` (48³×96):
    ``bench_compact`` (tol 1e-6) and ``bench_cg48_dc`` (tol 1e-9 in
    complex128) on one build, with the launch counts and the peak device
    memory; then each kernel form of that path against its plain version
    at this size.  Returns the K1 and K1d launches, both records, the
    peak and the kernels' largest errors."""
    import torch
    from quda_qkxtm_multigrid_tpu_torch.benchmarks import (
        bench_cg48_dc, bench_compact, make_compact_problem)
    from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry
    from quda_qkxtm_multigrid_tpu_torch.ops.dslash_kernel import (
        dslash_ch, to_channels)
    from quda_qkxtm_multigrid_tpu_torch.utils import rng

    geom = Geometry(*geom_dims)
    print(f"phase 8d: compact bf16 tier at {geom_dims}", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pb = make_compact_problem(geom, DEVICE, seed=7)
    print(f"  gauge and source {time.perf_counter() - t0 - pb.build_secs - pb.exact_build_secs:.2f} s, "
          f"bf16 tier build {pb.build_secs:.2f} s, float64 channels "
          f"{pb.exact_build_secs:.2f} s; peak so far "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    dslash_ch.launches = dslash_ch.launches_bf16 = 0
    rec = bench_compact(geom, tol=COMPACT_TOL, maxiter=COMPACT_MAXITER,
                        problem=pb)
    print(f"  bench_compact: iters {rec['iters']} (JAX record 13), secs "
          f"{rec['secs']:.4f}, GFLOP/s {rec['gflops']:.1f}, true_res "
          f"{rec['true_res']:.3e} (compact operator), "
          f"{rec['true_res_exact']:.3e} (complex128 against the exact "
          f"operator), operands {rec['operand_gib']:.2f} GiB (+ "
          f"{rec['exact_operand_gib']:.2f} GiB float64 channels)",
          flush=True)
    lo, hi = COMPACT_ITERS_BAND
    if not lo <= rec["iters"] <= hi:
        raise AssertionError(f"compact CG iterations {rec['iters']} outside "
                             f"{COMPACT_ITERS_BAND}")
    _check("compact true residual (its own operator)", rec["true_res"],
           COMPACT_TRUE_RES)
    from quda_qkxtm_multigrid_tpu_torch import compact, dirac
    rec["split"] = _split(
        "a third compact solve",
        [(pb.sloppy, "_hop", "hops (K1d)")] + [
            (mod, "_ch_clover_apply", "6×6 A, A⁻¹ and A⁻¹† (clover_ch)")
            for mod in (compact, dirac)] + [
            (mod, "_ch_twist", "plain twists") for mod in (compact, dirac)],
        lambda: compact.invert_compact_full(pb.sloppy, pb.b, tol=COMPACT_TOL,
                                            maxiter=COMPACT_MAXITER))
    dc = bench_cg48_dc(geom, inner_tol=DC_INNER_TOL, tol=DC_TOL, problem=pb)
    launches = {"k1": dslash_ch.launches, "k1d": dslash_ch.launches_bf16}
    peak = torch.cuda.max_memory_allocated()
    print(f"  bench_cg48_dc: restarts {dc['restarts']}, inner iterations "
          f"{dc['inner_iters']}, secs {dc['secs']:.4f} (outer residuals "
          f"{dc['resid_secs']:.4f}), diverged {dc['diverged']}, true_res "
          f"{dc['true_res']:.3e} (complex128, exact operator)", flush=True)
    print(f"  launches K1 {launches['k1']} K1d {launches['k1d']}; peak "
          f"memory {peak / 2**30:.2f} GiB ({peak / 1e9:.2f} GB)", flush=True)
    if dc["diverged"]:
        raise AssertionError("bench_cg48_dc diverged")
    _check("bench_cg48_dc true residual (complex128)", dc["true_res"], DC_TOL)
    if peak >= CARD_BYTES:
        raise AssertionError(f"peak memory {peak / 1e9:.2f} GB >= 80 GB")
    if launches["k1d"] == 0 or launches["k1"] == 0:
        raise AssertionError(f"48³×96 launches {launches}")
    # the kernels of this path against their plain versions at this size
    # (Xh = 24, no power of two), on the operators' own channels: the
    # float32-storage chain's hops and the exact operator's m_ch hops
    psi = rng.random_spinor(torch.Generator(device=DEVICE).manual_seed(43),
                            geom)
    v, x = (to_channels(psi[p]) for p in (0, 1))
    del psi
    where = f"at {geom_dims}"
    err = _compact_forms_check(
        pb.sloppy, _compact_chain_forms(pb.sloppy, v.to(torch.float32),
                                        x.to(torch.float32), None), where)
    k = pb.exact.params.kappa
    err.update(_compact_forms_check(
        pb.exact, [(f"m_ch xpay parity {p}", "K1", p, v,
                    dict(xpay_coef=-k, x_ch=x)) for p in (0, 1)], where))
    del pb, v, x
    return launches, rec, dc, peak, err


def _local_cases(twist_a: float, twist_b: float, xc: float):
    """The forms of the t-local hop on the sharded path: (label, case,
    tier): the sharded chain's hops in float32 and in the bf16 operand
    tier (the forms of ``_msrc_cases``: the chain is the multi-source
    one's, two hops a half), and the float64 bare hop of the sharded full
    operator (prepare, reconstruct, the true residual)."""
    chain = _msrc_cases(twist_a, twist_b, xc)
    return ([(f"f32 {label}", c, "f32") for label, c in chain]
            + [(f"bf16 {label}", c, "bf16") for label, c in chain]
            + [(f"f64 hop parity {p} dagger {int(dg)}",
                dict(parity=p, dagger=dg), "f64")
               for p in (0, 1) for dg in (False, True)])


def phase_local_kernels(dims_list):
    """Phase 9a: at each size, on the slab of rank SPLIT_RANK of a
    SPLIT_NT-way t split of one global field (its faces the neighbouring
    slabs' edge planes, as that rank receives them): K4 in
    every form against its plain version and against K1 (K1d) on the
    global field restricted to the slab's rows; K5 with 24- and
    12-channel faces against its plain version and against K4.  Returns
    the largest absolute error of each kernel against its plain version,
    {"k4": .., "k5": ..}."""
    import torch
    from quda_qkxtm_multigrid_tpu_torch.benchmarks import tmc_params
    from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry
    from quda_qkxtm_multigrid_tpu_torch.ops.clover import make_clover_pair
    from quda_qkxtm_multigrid_tpu_torch.ops.dslash import double_gauge
    from quda_qkxtm_multigrid_tpu_torch.ops.dslash_kernel import (
        clover_channels, dslash_ch, dslash_ch_local,
        dslash_ch_local_reference, dslash_ch_overlap, gauge_channels,
        to_channels)
    from quda_qkxtm_multigrid_tpu_torch.parallel.halo import project_face
    from quda_qkxtm_multigrid_tpu_torch.utils import rng

    f32, f64, b16 = torch.float32, torch.float64, torch.bfloat16
    tiers = {"f32": (f32, f32), "bf16": (b16, f32), "f64": (f64, f64)}
    counters = {"f32": "launches", "f64": "launches",
                "bf16": "launches_bf16"}
    kappa = 0.115
    a = 2 * kappa * 0.05
    cases = _local_cases(a, 1 / (1 + a * a), -kappa * kappa)
    err = {"k4": 0.0, "k5": 0.0}
    for dims in dims_list:
        geom = Geometry(*dims)
        tl = geom.T // SPLIT_NT
        lo, hi = SPLIT_RANK * tl, (SPLIT_RANK + 1) * tl
        gl = Geometry(geom.X, geom.Y, geom.Z, tl)
        print(f"phase 9a: t-local hop K4 and its split K5 vs plain and vs "
              f"K1 at {dims}, slab of rank {SPLIT_RANK} of {SPLIT_NT} "
              f"(T_loc {tl})", flush=True)
        gen = torch.Generator(device=DEVICE).manual_seed(51)
        u = rng.random_gauge(gen, geom)
        _, cinv = make_clover_pair(u, geom, tmc_params())
        ud = double_gauge(u, geom)
        del u
        psi = rng.random_spinor(gen, geom)
        x = rng.random_spinor(gen, geom)
        ops = {}
        for label, c, tier in cases:
            op, sp = tiers[tier]
            p, dagger, xc = c["parity"], c.get("dagger", False), c.get("xpay")
            if (op, p) not in ops:
                ops[(op, p)] = (gauge_channels(ud, p, True, op),
                                clover_channels(cinv, p, op))
            g, ci = ops[(op, p)]
            v = to_channels(psi[1 - p]).to(sp)
            xv = to_channels(x[p]).to(sp)
            kw = dict(dagger=dagger, recon12=True, twist=c.get("twist"),
                      clover=c.get("clover"), xpay_coef=xc)
            gs = g[lo:hi].contiguous()
            cs = ci[lo:hi].contiguous() if "clover" in c else None
            vs = v[lo:hi].contiguous()
            f24 = (v[lo - 1:lo].contiguous(), v[hi:hi + 1].contiguous())
            xs = xv[lo:hi].contiguous() if xc is not None else None
            kw.update(cinv_ch=cs, x_ch=xs)
            name = counters[tier]
            before = getattr(dslash_ch_local, name)
            got = dslash_ch_local(gs, vs, *f24, p, gl, **kw)
            torch.cuda.synchronize()
            if getattr(dslash_ch_local, name) != before + 1:
                raise AssertionError(f"K4 {label}: dslash_ch_local.{name} "
                                     "did not count the launch")
            ref = dslash_ch_local_reference(gs, vs, *f24, p, gl, **kw)
            err["k4"] = max(err["k4"], _compare(
                got, ref, f"K4 {label}",
                F64_LIMIT if sp == f64 else F32_LIMIT))
            k1 = dslash_ch(g, v, p, geom, **dict(
                kw, cinv_ch=ci if "clover" in c else None,
                x_ch=xv if xc is not None else None))[lo:hi]
            same = "bit for bit" if torch.equal(got, k1) else "not bit equal"
            _check(f"  vs K1 on the slab's rows ({same})", _rel(got, k1),
                   LOCAL_VS_K1[str(sp)[6:]])
            if tier == "f64":
                continue
            for proj in (False, True):
                fm, fp = f24
                if proj:
                    fm = project_face(fm, plus=not dagger)
                    fp = project_face(fp, plus=dagger)
                before = getattr(dslash_ch_overlap, name)
                got5 = dslash_ch_overlap(gs, vs, fm, fp, p, gl,
                                         faces_projected=proj, **kw)
                torch.cuda.synchronize()
                if getattr(dslash_ch_overlap, name) != before + 2:
                    raise AssertionError(f"K5 {label}: dslash_ch_overlap."
                                         f"{name} did not count its two "
                                         "launches")
                ref5 = dslash_ch_local_reference(gs, vs, fm, fp, p, gl,
                                                 faces_projected=proj, **kw)
                faces = f"{12 if proj else 24}-channel faces"
                err["k5"] = max(err["k5"], _compare(
                    got5, ref5, f"K5 {label}, {faces}", F32_LIMIT))
                same = ("bit for bit" if torch.equal(got5, got)
                        else "not bit equal")
                _check(f"  vs K4 ({same})", _rel(got5, got), OVERLAP_VS_K4)
        del ops, ud, cinv, psi, x
    return err


def phase_mesh_solve(geom_dims, unsharded_secs: float):
    """Phase 9b: the unsharded CG at ``geom_dims`` for reference, then
    ``benchmarks.bench_cg_mesh`` (a cold and a warm ``invert(mesh=…)``)
    on a ring of one rank over NCCL, with K4 and with K5, each with the
    launch counts read around it; then phase 9c on the same operator and
    ring.  Returns the two runs' records, keyed by ``overlap``, and 9c's
    times and bounds."""
    import os
    import socket

    import torch
    import torch.distributed as dist
    from quda_qkxtm_multigrid_tpu_torch.benchmarks import (
        bench_cg_mesh, make_problem)
    from quda_qkxtm_multigrid_tpu_torch.invert import invert
    from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry
    from quda_qkxtm_multigrid_tpu_torch.ops.dslash_kernel import (
        dslash_ch, dslash_ch_local, dslash_ch_overlap)
    from quda_qkxtm_multigrid_tpu_torch.parallel.mesh import init_ring

    geom = Geometry(*geom_dims)
    print(f"phase 9b: t-sharded twisted-clover CG at {geom_dims} on a ring "
          f"of one rank over NCCL, tol {SLICE_TOL}", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    d, b = make_problem(geom, DEVICE, seed=7)
    ref = invert(d, b, tol=SLICE_TOL, maxiter=SLICE_MAXITER)
    print(f"  unsharded CG: {ref.iters} iterations, true_res "
          f"{ref.true_res:.3e}; phase 4's warm solve {unsharded_secs:.4f} s",
          flush=True)
    # one host: NCCL's bootstrap over the loopback interface
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    mesh = init_ring(1, 0, f"tcp://localhost:{port}", device=DEVICE)
    runs = {}
    try:
        for overlap in (False, True):
            _counts_zero()
            rec, x = bench_cg_mesh(geom, mesh, overlap, tol=SLICE_TOL,
                                   maxiter=SLICE_MAXITER, problem=(d, b))
            rec.update(k4=dslash_ch_local.launches,
                       k5=dslash_ch_overlap.launches, k1=dslash_ch.launches,
                       k4_post=dslash_ch_local.launches_post,
                       x_rel=_rel(x, ref.x))
            runs[overlap] = rec
            del x
            print(f"  {rec['solver']} ({'K5' if overlap else 'K4'}): iters "
                  f"{rec['iters']} (cold {rec['iters_cold']}), warm secs "
                  f"{rec['secs']:.4f} (unsharded, phase 4: "
                  f"{unsharded_secs:.4f}), true_res {rec['true_res']:.3e} "
                  f"(complex128; cold {rec['true_res_cold']:.3e}), solution "
                  f"vs unsharded {rec['x_rel']:.3e}, peak memory "
                  f"{rec['peak_mem_bytes'] / 2**30:.2f} GiB, launches K4 "
                  f"{rec['k4']} ({rec['k4_post']} with the second "
                  f"output) K5 {rec['k5']} K1 "
                  f"{rec['k1']}", flush=True)
            for key in ("iters", "iters_cold"):
                if abs(rec[key] - ref.iters) > 1:
                    raise AssertionError(f"sharded {key} {rec[key]} not "
                                         f"within 1 of {ref.iters}")
            _check("sharded true residual (complex128)",
                   max(rec["true_res"], rec["true_res_cold"]),
                   TRUE_RES_LIMIT)
            _check("sharded solution vs unsharded", rec["x_rel"],
                   MESH_X_LIMIT)
            # per solve: 4 chain hops an iteration (K4: one launch each,
            # the second with its second output, or K5: two, interior and
            # edges) and 6 float64 K4 hops: prepare 1, rhs matpc† 2 (the
            # float64 chain's), reconstruct 1, true residual 2
            n = rec["iters"] + rec["iters_cold"]
            want = ((12, 8 * n) if overlap else (4 * n + 12, 0)) + (0,)
            post = 0 if overlap else n
            if ((rec["k4"], rec["k5"], rec["k1"]) != want
                    or rec["k4_post"] != post):
                raise AssertionError(f"sharded launches K4 {rec['k4']} K5 "
                                     f"{rec['k5']} K1 {rec['k1']} != {want}, "
                                     f"K4 with the second output "
                                     f"{rec['k4_post']} != {post}")
        timing = phase_local_timing(geom, d, mesh)
    finally:
        dist.destroy_process_group()
    return runs, timing


def _main_path_local_checks(ds, mesh, gen):
    """K4 and K5 against their plain versions at the shapes and on the
    operands of the sharded path of 9b (``ds`` on ``mesh``, T_loc =
    geom.T): the four float32 chain hops of the clover matpc halves (K5
    with the projected faces it takes there), and the float64 bare K4 hop
    of the complex128 stages, both parities, with and without dagger, in
    the instance of the operator's t boundary.  Returns the largest
    absolute errors {"k4": .., "k5": ..}."""
    import torch
    from quda_qkxtm_multigrid_tpu_torch.ops.dslash_kernel import (
        dslash_ch_local, dslash_ch_local_reference, dslash_ch_overlap,
        to_channels)
    from quda_qkxtm_multigrid_tpu_torch.parallel.halo import t_faces
    from quda_qkxtm_multigrid_tpu_torch.utils import rng

    geom, k = ds.geom, ds.params.kappa
    tb = ds._hop_kw()["t_boundary"]     # the rows of an antiperiodic gauge
    print(f"  K4 / K5 vs plain on the sharded path's operands, T_loc "
          f"{geom.T}", flush=True)
    f32, f64 = torch.float32, torch.float64
    ops = ds._operands(f32)
    psi, x = rng.random_spinor(gen, geom), rng.random_spinor(gen, geom)
    err = {"k4": 0.0, "k5": 0.0}
    for label, c in _msrc_cases(0.0, 1.0, -k * k)[:4]:
        p, dagger = c["parity"], c.get("dagger", False)
        v = to_channels(psi[1 - p]).to(f32)
        kw = dict(dagger=dagger, recon12=True, t_boundary=tb,
                  clover=c.get("clover"),
                  cinv_ch=ops["ci"][p] if "clover" in c else None,
                  xpay_coef=c.get("xpay"),
                  x_ch=to_channels(x[p]).to(f32) if "xpay" in c else None)
        f24 = t_faces(v, mesh)
        f12 = t_faces(v, mesh, project=True, dagger=dagger)
        g = ops["g"][p]
        err["k4"] = max(err["k4"], _compare(
            dslash_ch_local(g, v, *f24, p, geom, **kw),
            dslash_ch_local_reference(g, v, *f24, p, geom, **kw),
            f"K4 f32 {label}", F32_LIMIT))
        err["k5"] = max(err["k5"], _compare(
            dslash_ch_overlap(g, v, *f12, p, geom, faces_projected=True,
                              **kw),
            dslash_ch_local_reference(g, v, *f12, p, geom,
                                      faces_projected=True, **kw),
            f"K5 f32 {label}, 12-channel faces", F32_LIMIT))
    g64 = ds._operands(f64, exact=True)["g"]
    for p in (0, 1):
        v = to_channels(psi[1 - p])
        f24 = t_faces(v, mesh)
        for dagger in (False, True):
            err["k4"] = max(err["k4"], _compare(
                dslash_ch_local(g64[p], v, *f24, p, geom, dagger,
                                recon12=True, t_boundary=tb),
                dslash_ch_local_reference(g64[p], v, *f24, p, geom, dagger,
                                          recon12=True, t_boundary=tb),
                f"K4 f64 hop parity {p} dagger {int(dagger)}", F64_LIMIT))
    torch.cuda.synchronize()
    return err


def _sharded_chain_checks(ds, d, v, psi128):
    """9c: the sharded matpc†matpc on K4 with its second output against
    the unsharded K1 chain, on a ring of one: the float32 chain on
    channels ``v`` (``matpc_dagm_ch``) within ``F32_SUM_BOUND`` of the
    largest value, the complex128 one (``matpc_dagm``, K4's float64
    forms) within 1e-14 normwise; each four K4 launches, no K1 and no
    plain A⁻¹† or twist (the chain's helpers in ``dirac`` counted)."""
    import torch
    from quda_qkxtm_multigrid_tpu_torch import dirac as dmod
    from quda_qkxtm_multigrid_tpu_torch.ops.dslash_kernel import (
        dslash_ch, dslash_ch_local)

    plain = ("_ch_clover_apply", "_ch_twist")
    saved = {n: getattr(dmod, n) for n in plain}
    calls = []

    def counted(fn):
        dslash_ch.launches = dslash_ch_local.launches = 0
        dslash_ch_local.launches_post = 0
        calls.clear()
        for n, f in saved.items():
            setattr(dmod, n, lambda *a, f=f, n=n, **k: calls.append(n)
                    or f(*a, **k))
        try:
            out = fn()
            torch.cuda.synchronize()
        finally:
            for n, f in saved.items():
                setattr(dmod, n, f)
        return out, (dslash_ch_local.launches,
                     dslash_ch_local.launches_post), dslash_ch.launches

    rec = {}
    for label, fn, ref_fn in (
            ("f32", lambda: ds.matpc_dagm_ch(v),
             lambda: d._fused_matpc_dagm_ch(v)),
            ("c128", lambda: ds.matpc_dagm(psi128),
             lambda: d.matpc_dagm(psi128))):
        # four K4 launches, the second with the second output
        got, k4, k1 = counted(fn)
        ref = ref_fn()
        if k4 != (4, 1) or k1 or calls:
            raise AssertionError(f"9c sharded matpc†matpc {label}: K4 "
                                 f"launches (all, with the second output) "
                                 f"{k4} (want (4, 1)), K1 {k1}, plain "
                                 f"applies {calls}")
        if label == "f32":
            _check("9c sharded matpc†matpc f32, K4 + post, vs K1 chain "
                   "(of max)", float((got - ref).abs().max())
                   / float(ref.abs().max()), F32_SUM_BOUND)
        else:
            _check("9c sharded matpc†matpc c128, K4 f64 + post, vs K1 f64 "
                   "chain", _rel(got, ref), 1e-14)
        rec[label] = {"bit_equal": bool(torch.equal(got, ref)),
                      "launches": k4}
        print(f"  sharded matpc†matpc {label}: K4 launches {k4[0]} ("
              f"{k4[1]} with the second output), no "
              f"plain A⁻¹†, bit for bit the unsharded chain: "
              f"{rec[label]['bit_equal']}", flush=True)
    return rec


def phase_local_timing(geom, d, mesh):
    """Phase 9c: K4 and K5 against their plain versions on the sharded
    path's operands (``_main_path_local_checks``); the sharded
    matpc†matpc on K4 with its second output against the unsharded K1
    chain, float32 and complex128, with its launches
    (``_sharded_chain_checks``); then the bare float32 K4 hop, K4 with
    the second output (clover fwd + xpay + post), K5 (interior and
    edges, projected faces), K1 and the plain versions, timed in turns
    in one call (median of 5) at the size of 9b, ring of one, with each
    kernel's output held against its plain version's; then each hop
    with its exchange as the chain runs it, one sharded matpc†matpc
    with each (K4 + post, K4 with its leading A⁻¹† through C6, K5)
    against the unsharded four-hop chain and against the sharded chain's
    own form run unsharded (two matpc halves through K1), and the
    complex128 sharded and unsharded matpc†matpc.  Returns the medians,
    the bounds of K4 (bare and with the second output) and K5, the chain
    checks and the largest absolute errors against the plain versions."""
    import torch
    from quda_qkxtm_multigrid_tpu_torch.ops.dslash_kernel import (
        dslash_ch, dslash_ch_local, dslash_ch_local_reference,
        dslash_ch_overlap, to_channels)
    from quda_qkxtm_multigrid_tpu_torch.parallel.halo import t_faces
    from quda_qkxtm_multigrid_tpu_torch.parallel.sharded import (
        halo_hop, shard_dirac)
    from quda_qkxtm_multigrid_tpu_torch.utils import rng

    print(f"phase 9c: K4, K5, K1 and plain timed at {geom.dims}, ring of one "
          f"(median of 5, in turns)", flush=True)
    f32 = torch.float32
    ds = shard_dirac(d, mesh)
    gen = torch.Generator(device=DEVICE).manual_seed(53)
    err = _main_path_local_checks(ds, mesh, gen)
    pr = ds.params.matpc_parity
    g, ci = ds._operands(f32)["g"][pr], ds._operands(f32)["ci"][pr]
    psi = rng.random_spinor(gen, geom)
    v, x = (to_channels(psi[i]).to(f32) for i in (0, 1))
    psi128 = psi[0].to(torch.complex128)
    del psi
    chain = _sharded_chain_checks(ds, d, v, psi128)
    f24 = t_faces(v, mesh)
    fm, fp = t_faces(v, mesh, project=True)
    hop = dict(recon12=True)
    post = dict(hop, clover="fwd", cinv_ch=ci, xpay_coef=-ds.params.kappa
                ** 2, x_ch=x, post_op=("clover",))
    fns = {
        "K4": lambda: dslash_ch_local(g, v, *f24, pr, geom, **hop),
        "K5": lambda: dslash_ch_overlap(g, v, fm, fp, pr, geom,
                                        faces_projected=True, **hop),
        "K1": lambda: dslash_ch(g, v, pr, geom, **hop),
        "K4 plain": lambda: dslash_ch_local_reference(g, v, *f24, pr, geom,
                                                      **hop),
        "K4 + post": lambda: dslash_ch_local(g, v, *f24, pr, geom, **post),
        "K4 + post plain": lambda: dslash_ch_local_reference(
            g, v, *f24, pr, geom, **post),
        "K5 plain": lambda: dslash_ch_local_reference(
            g, v, fm, fp, pr, geom, faces_projected=True, **hop),
        "K4 hop with its exchange": lambda: halo_hop(mesh, False, g, v, pr,
                                                     geom, **hop),
        "K5 hop with its exchange": lambda: halo_hop(mesh, True, g, v, pr,
                                                     geom, **hop),
        "sharded matpc†matpc, K4 + post": lambda: ds.matpc_dagm_ch(v),
        "sharded matpc†matpc, K4": lambda: ds.matpc_ch(
            ds.matpc_ch(v, False, False), True, False),
        "sharded matpc†matpc, K5": lambda: ds.matpc_ch(
            ds.matpc_ch(v, False, True), True, True),
        "unsharded matpc†matpc, K1": lambda: d._fused_matpc_dagm_ch(v),
        "unsharded, the sharded chain": lambda: d._fused_matpc_ch(
            d._fused_matpc_ch(v, False), True),
        "sharded matpc†matpc c128, K4 f64 + post": lambda: ds.matpc_dagm(
            psi128),
        "unsharded matpc†matpc c128, K1 f64": lambda: d.matpc_dagm(psi128)}
    n_runs = {k: (3 if "plain" in k else 10 if "matpc" in k else 20)
              for k in fns}
    out = {k: fns[k]() for k in ("K4", "K5", "K4 + post", "K4 plain",
                                 "K5 plain", "K4 + post plain")}
    torch.cuda.synchronize()
    err["k4_post"] = 0.0
    for k, key in (("K4", "k4"), ("K5", "k5"), ("K4 + post", "k4_post")):
        err[key] = max(err[key], _compare(
            out[k], out[f"{k} plain"], f"{k} hop (timed inputs)",
            F32_LIMIT))
    del out
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times = {k: [] for k in fns}
    for _ in range(5):
        for k, fn in fns.items():
            times[k].append(_time_ms(fn, n_runs[k]))
    med = {k: statistics.median(t) for k, t in times.items()}
    for k, t in med.items():
        print(f"  {k:<40s} {t:.4f} ms", flush=True)
    sites = geom.half_volume
    bounds = {"K4": _bound(_nbytes(g, v, *f24, v), HOP_FLOPS * sites),
              "K4 + post": _bound(_nbytes(g, ci, v, *f24, x, v, v),
                                  (HOP_FLOPS + 2 * CLOVER_FLOPS
                                   + XPAY_FLOPS) * sites),
              "K5": _bound(_nbytes(g, v, fm, fp, v), HOP_FLOPS * sites)}
    for k, (ms, by) in bounds.items():
        print(f"  {k} bound {ms:.4f} ms ({by}); kernel at "
              f"{ms / med[k]:.2f} of it", flush=True)
    # the chain: K1's four-hop bound (the faces of a ring of one are two
    # planes a hop, 2 / T of psi's bytes)
    k1, f32c, c128 = (med["unsharded matpc†matpc, K1"],
                      med["sharded matpc†matpc, K4 + post"],
                      med["sharded matpc†matpc c128, K4 f64 + post"])
    k1_64 = med["unsharded matpc†matpc c128, K1 f64"]
    print(f"  sharded matpc†matpc f32, K4 + post: {f32c:.4f} ms, "
          f"{f32c / k1:.3f}× the unsharded K1 chain ({k1:.4f} ms); "
          f"complex128 {c128:.4f} ms, {c128 / k1_64:.3f}× the unsharded "
          f"fused f64 chain ({k1_64:.4f} ms); before the second output, PR 5 "
          f"call 10: K4 {CHAIN_PARENT_MS['f32']} ms, PR 13 complex128 "
          f"{CHAIN_PARENT_MS['c128']} ms", flush=True)
    return {"times": med, "bounds": bounds, "err": err, "chain": chain}


def phase_v_kernels(check_dims, time_dims):
    """Phase 10: the JAX package's stand-alone Pallas hops V1
    (``dslash_parity_pallas``, 18-real links) and V2
    (``dslash_parity_pallas2``: recon-12, and ``bf16=True``; V3 and V4
    compute V2's hop) are K1's recon-18 and recon-12 float instances and
    K1d's bf16-ψ instance ``g16s16``.  At ``check_dims``, both parities
    and daggers: V1 and V2 through ``dslash_parity_kernel`` (complex64
    in, complex64 out) and the bf16 forms through ``dslash_ch`` against
    their plain versions, each launch counted; at ``time_dims`` the
    bare hops timed in turns with their plain versions, beside their
    byte bounds.  Returns {"v1": .., "v2": .., "v2 bf16": ..} of
    (ms, plain ms, bound, largest absolute error), and the launches."""
    import torch
    from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry
    from quda_qkxtm_multigrid_tpu_torch.ops.dslash import double_gauge
    from quda_qkxtm_multigrid_tpu_torch.ops.dslash_kernel import (
        dslash_ch, dslash_ch_reference, dslash_parity_kernel, from_channels,
        gauge_channels, to_channels)
    from quda_qkxtm_multigrid_tpu_torch.utils import rng
    f32, b16, c64 = torch.float32, torch.bfloat16, torch.complex64

    def fields(dims, seed):
        geom = Geometry(*dims)
        gen = torch.Generator(device=DEVICE).manual_seed(seed)
        ud = double_gauge(rng.random_gauge(gen, geom, dtype=c64), geom)
        return geom, ud, rng.random_spinor(gen, geom, c64)

    print(f"phase 10: V1 / V2 (and V3, V4) as K1 recon-18 / recon-12 and "
          f"K1d g16s16, vs plain at {check_dims}", flush=True)
    geom, ud, psi = fields(check_dims, 71)
    err = {"v1": 0.0, "v2": 0.0, "v2 bf16": 0.0}
    k1_0, k1d_0 = dslash_ch.launches, dslash_ch.launches_bf16
    for p in (0, 1):
        for dagger in (False, True):
            for name, r12 in (("v1", False), ("v2", True)):
                got = dslash_parity_kernel(ud, psi[1 - p], p, geom, dagger,
                                           recon12=r12)
                torch.cuda.synchronize()
                ref = from_channels(dslash_ch_reference(
                    gauge_channels(ud, p, r12, f32), to_channels(psi[1 - p]),
                    p, geom, dagger, recon12=r12), (4, 3))
                err[name] = max(err[name], _compare(
                    got, ref, f"{name.upper()} (K1 recon-{12 if r12 else 18}"
                    f") parity {p} dagger {int(dagger)}", F32_LIMIT))
                g16 = gauge_channels(ud, p, r12, b16)
                v16 = to_channels(psi[1 - p]).to(b16)
                err["v2 bf16"] = max(err["v2 bf16"], _compare(
                    dslash_ch(g16, v16, p, geom, dagger, recon12=r12),
                    dslash_ch_reference(g16, v16, p, geom, dagger,
                                        recon12=r12),
                    f"V2 bf16 (K1d g16s16 recon-{12 if r12 else 18}) parity "
                    f"{p} dagger {int(dagger)}", F32_LIMIT))
    launches = (dslash_ch.launches - k1_0, dslash_ch.launches_bf16 - k1d_0)
    if launches != (8, 8):
        raise AssertionError(f"phase 10 launches K1 {launches[0]} K1d "
                             f"{launches[1]} != 8, 8")
    del ud, psi
    print(f"  timed at {time_dims} (median of 5, in turns)", flush=True)
    geom, ud, psi = fields(time_dims, 72)
    v = to_channels(psi[1])
    del psi
    ops = {"v1": (gauge_channels(ud, 0, False, f32), v, False),
           "v2": (gauge_channels(ud, 0, True, f32), v, True),
           "v2 bf16": (gauge_channels(ud, 0, True, b16), v.to(b16), True),
           "v2 bf16 recon-18": (gauge_channels(ud, 0, False, b16), v.to(b16),
                                False)}
    del ud
    fns, n_runs = {}, {}
    for name, (g, s, r12) in ops.items():
        fns[name] = lambda g=g, s=s, r12=r12: dslash_ch(g, s, 0, geom,
                                                         recon12=r12)
        fns[f"{name} plain"] = (lambda g=g, s=s, r12=r12: dslash_ch_reference(
            g, s, 0, geom, recon12=r12))
        n_runs[name], n_runs[f"{name} plain"] = 20, 3
        got, ref = fns[name](), fns[f"{name} plain"]()
        err[name] = max(err.get(name, 0.0), _compare(
            got, ref, f"{name} at {time_dims}", F32_LIMIT))
    med = _turns(fns, n_runs)
    out = {}
    for name, (g, s, _) in ops.items():
        bound = _bound(_nbytes(g, s) + s.numel() * 4,
                       HOP_FLOPS * geom.half_volume)
        print(f"  {name:<17s} {med[name]:.4f} ms (bound {bound[0]:.4f} ms, "
              f"{bound[1]}; at {bound[0] / med[name]:.2f} of it; "
              f"{med[name] / med['v2']:.3f}x the recon-12 hop)  plain "
              f"{med[name + ' plain']:.4f} ms", flush=True)
        out[name] = (med[name], med[f"{name} plain"], bound, err[name])
    return out, launches


def _certify(u, flavor: int, geom, sources, xs) -> list:
    """Each column's |b − M x| / |b| of the plain complex128 operator of
    the same links and flavour (full links, no recon-12 and no boundary
    sign of the kernels): the solution the workflow kept, certified
    independently of the hops that solved it."""
    import torch
    from quda_qkxtm_multigrid_tpu_torch.benchmarks import tmc_params
    from quda_qkxtm_multigrid_tpu_torch.dirac import make_dirac
    from quda_qkxtm_multigrid_tpu_torch.invert import true_residual
    c128 = torch.complex128
    d = make_dirac(u.to(c128), dataclasses.replace(
        tmc_params(use_kernels=False), flavor=flavor), geom)
    res = [float(true_residual(d, x.to(c128), b.to(c128))[1])
           for b, x in zip(sources, xs)]
    del d
    return res


def _twop_kernel_checks(u, geom, sources, flavor: int = +1,
                        label: str = "") -> dict:
    """Phase 11's (and 12's) kernel instances at the path's own shapes
    and inputs: the antiperiodic instances of K1 float32 recon-12 and of
    K2 at n = 12 that the workflow's solves launch, on the channel
    operands of the operator of ``flavor``, with the twelve smeared
    sources as the spinors (``_chain_kernel_checks``).  Returns the
    largest absolute error of each kernel."""
    from quda_qkxtm_multigrid_tpu_torch import workflows as wf
    from quda_qkxtm_multigrid_tpu_torch.benchmarks import tmc_params
    d = wf.make_operator(u, dataclasses.replace(tmc_params(), flavor=flavor),
                         geom)
    if not (d._has_fused_matpc and d._hop_kw()["antiperiodic"]):
        raise AssertionError("the workflow's operator is not the fused "
                             "chain on the antiperiodic gauge")
    return _chain_kernel_checks(d, geom, sources, label)


def _chain_kernel_checks(d, geom, sources, label: str = "") -> dict:
    """K1 float32 recon-12 and K2 at n = len(sources) on the channel
    operands of the fused operator ``d`` (in its boundary's instance),
    with ``sources`` [n, 2,4,3,T,Z,W] as the spinors: each hop of the
    four-hop chain (K1 also the bare hop of prepare, reconstruct and the
    true residual) against its plain version, normwise to
    ``TBC_LIMIT["float32"]``.  Returns the largest absolute error of each
    kernel."""
    import torch
    from quda_qkxtm_multigrid_tpu_torch.ops.dslash_kernel import (
        dslash_ch, dslash_ch_msrc, dslash_ch_msrc_reference,
        dslash_ch_reference, to_channels)
    f32 = torch.float32
    kw = d._hop_kw()
    bc = " antiperiodic" if kw["antiperiodic"] else ""
    ops = d._operands(f32)
    g, ci = ops["g"], ops["ci"]
    pr, xc = d.params.matpc_parity, -d.params.kappa ** 2
    psi = torch.stack([to_channels(b[0]) for b in sources]).to(f32)
    xs = torch.stack([to_channels(b[1]) for b in sources]).to(f32)
    # (label, parity, keywords, with x): the chain's hops in its order
    forms = [("clover fwd", 1 - pr, dict(clover="fwd", cinv_ch=ci[1 - pr]),
              False),
             ("clover fwd + xpay + post clover", pr,
              dict(clover="fwd", cinv_ch=ci[pr], xpay_coef=xc,
                   post_op=("clover",)), True),
             ("dagger clover dag", 1 - pr,
              dict(dagger=True, clover="dag", cinv_ch=ci[1 - pr]), False),
             ("dagger xpay", pr, dict(dagger=True, xpay_coef=xc), True)]
    err = {"k1": 0.0, "k2": 0.0}
    for form_label, p, form, with_x in forms + [
            (f"bare hop parity {p}", p, {}, False) for p in (0, 1)]:
        kernels = [("K1", dslash_ch, dslash_ch_reference, psi[0], xs[0])]
        if not form_label.startswith("bare"):
            kernels.append(("K2", dslash_ch_msrc, dslash_ch_msrc_reference,
                            psi, xs))
        for name, hop, plain, v, x in kernels:
            args = dict(form, **kw)
            if with_x:
                args["x_ch"] = x
            got = hop(g[p], v, p, geom, **args)
            torch.cuda.synchronize()
            ref = plain(g[p], v, p, geom, **args)
            n = f" n={v.shape[0]}" if name == "K2" else ""
            err[name.lower()] = max(err[name.lower()], _compare(
                got, ref, f"{label}{name}{bc}{n} {form_label}",
                TBC_LIMIT["float32"]))
            del got, ref
    del ops, g, ci, psi, xs
    return err


def _pion(out, moms_zero: int):
    """The pion (pseudoscalar) of both flavour orderings at zero momentum
    [2, T]."""
    return out["mesons"][0, :, :, moms_zero]


def phase_twop(geom_dims, cli_dims):
    """Phase 11: the 2pt workflow (``workflows.run_twop``) at
    ``geom_dims`` on the complex64 gauge of seed 7 with the antiperiodic
    boundary (``apply_t_boundary``), APE 20 × 0.5 and Gauss 50 × 4.0.
    The CG path: the twelve columns of each flavour as one multi-source
    solve through K2 (n = 12), each column certified in complex128; the
    same 24 columns as single ``invert`` solves through K1; the MG path
    with the pair of preconditioners (one set of null vectors, a coarse
    build a flavour); the pion's sanity; the CLI at ``cli_dims`` in
    process, in single and in double precision.  Returns the K1 and K2
    launches of the path and the kernels' largest absolute errors
    against their plain versions at the path's shapes."""
    import tempfile
    import torch
    from quda_qkxtm_multigrid_tpu_torch import cli
    from quda_qkxtm_multigrid_tpu_torch import workflows as wf
    from quda_qkxtm_multigrid_tpu_torch.benchmarks import (
        make_gauge_source, tmc_params)
    from quda_qkxtm_multigrid_tpu_torch.invert import invert
    from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry
    from quda_qkxtm_multigrid_tpu_torch.mg.multigrid import MGParams
    from quda_qkxtm_multigrid_tpu_torch.ops.dslash_kernel import (
        dslash_ch, dslash_ch_msrc)
    from quda_qkxtm_multigrid_tpu_torch.ops.gauge import (
        apply_t_boundary, plaquette)

    t_phase = time.perf_counter()
    geom = Geometry(*geom_dims)
    print(f"phase 11: the 2pt workflow at {geom_dims}, twisted-clover "
          f"complex64, antiperiodic in t, tol {TWOP_TOL}", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    u, _ = make_gauge_source(geom, DEVICE, seed=7, dtype=torch.complex64)
    u = apply_t_boundary(u, geom)
    tot, sp, tm = plaquette(u, geom)
    print(f"  plaquette: total={float(tot):.8f} spatial={float(sp):.8f} "
          f"temporal={float(tm):.8f}", flush=True)
    p = tmc_params()
    args = dict(kappa=p.kappa, mu=p.mu, csw=p.csw, source=TWOP_SOURCE,
                tol=TWOP_TOL, maxiter=SLICE_MAXITER)

    # the CG path: one multi-source solve a flavour through K2
    torch.cuda.reset_peak_memory_stats()
    dslash_ch.launches = dslash_ch_msrc.launches = 0
    st = {}
    t0 = time.perf_counter()
    out = wf.run_twop(u, geom, stats=st, **args)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    k1, k2 = dslash_ch.launches, dslash_ch_msrc.launches
    peak = torch.cuda.max_memory_allocated()
    iters = {f: st[f]["iters"] for f in ("up", "dn")}
    solve_secs = st["secs"]["solve"]
    print(f"  run_twop {secs:.3f} s; stages (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in st["secs"].items()), flush=True)
    print(f"  msrc CG iterations up {iters['up']} dn {iters['dn']}; "
          f"K2 launches {k2} (4 an iteration), K1 launches {k1}; peak "
          f"memory {peak / 2**30:.2f} GiB", flush=True)
    if k2 != 4 * (iters["up"] + iters["dn"]) or k1 == 0:
        raise AssertionError(f"K2 launches {k2} != 4 × the iterations, or "
                             f"K1 launches {k1}")
    worst = 0.0
    for flavor, name in ((+1, "up"), (-1, "dn")):
        res = _certify(u, flavor, geom, st["sources"], st[name]["x"])
        worst = max(worst, max(res))
        print(f"  {name}: solver's worst true_res (complex64) "
              f"{st[name]['true_res']:.3e}; complex128 per column "
              + " ".join(f"{r:.2e}" for r in res), flush=True)
    _check("worst column's true residual (complex128)", worst,
           TRUE_RES_LIMIT)
    zero = [i for i, m in enumerate(out["moms"]) if not any(m)][0]
    pion = _pion(out, zero)
    re, im = pion.real, pion.imag
    print("  pion C(t), zero momentum, up, t = 0..8: " + " ".join(
        f"{float(c):.4e}" for c in re[0, :9]), flush=True)
    # far from the source the float32 correlator falls below the
    # smallest normal float (C(T/2) ~ 1e-42 at this mass): non-negative
    # there, positive near the source
    if not (bool((re >= 0).all()) and bool((re[:, 1] > 0).all())
            and bool((re[:, 1] < re[:, 0]).all())
            and float(im.abs().max() / re.abs().max()) < TWOP_PION_IMAG):
        raise AssertionError("the pion at zero momentum is not real and "
                             "positive with C(1) < C(0)")
    mes_cg = out["mesons"].clone()
    bar_cg = out["baryons"].clone()
    # phase 12 starts from the CG path's propagators and smeared links
    threep_in = {k: out[k] for k in ("prop_up", "prop_dn", "u_ape")}

    # the kernels' antiperiodic instances at the path's shapes, then the
    # same 24 columns as single solves through K1
    sources = st["sources"]
    msrc_x = {f: st[f]["x"] for f in ("up", "dn")}
    del out, st
    gc.collect()
    torch.cuda.empty_cache()
    err = _twop_kernel_checks(u, geom, sources)
    gc.collect()
    torch.cuda.empty_cache()
    worst_diff, t_single = 0.0, 0.0
    dslash_ch.launches = dslash_ch_msrc.launches = 0
    for flavor, name in ((+1, "up"), (-1, "dn")):
        d = wf.make_operator(u, dataclasses.replace(p, flavor=flavor), geom)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        xs = [invert(d, b, tol=TWOP_TOL, maxiter=SLICE_MAXITER).x
              for b in sources]
        torch.cuda.synchronize()
        t_single += time.perf_counter() - t0
        worst_diff = max(worst_diff, max(
            _rel(a, b) for a, b in zip(xs, msrc_x[name])))
        del d, xs
    k1_single = dslash_ch.launches
    print(f"  24 single invert solves through K1 {t_single:.3f} s "
          f"({k1_single} K1 launches) against the two multi-source solves' "
          f"{solve_secs:.3f} s", flush=True)
    _check("columns, multi-source vs single solves", worst_diff,
           TWOP_VS_SINGLES)
    del sources, msrc_x
    gc.collect()
    torch.cuda.empty_cache()

    # the MG path: the pair of preconditioners
    mgp = MGParams(block=MG_BLOCK, nvec=MG_NVEC, smoother_pc=True,
                   outer_solver="gcr-pc")
    st = {}
    dslash_ch.launches = dslash_ch_msrc.launches = 0
    t0 = time.perf_counter()
    out = wf.run_twop(u, geom, mg_params=mgp, stats=st, **args)
    torch.cuda.synchronize()
    mg_secs = time.perf_counter() - t0
    mg_k1, mg_k2 = dslash_ch.launches, dslash_ch_msrc.launches
    print(f"  MG path: K1 launches {mg_k1}, K2 launches {mg_k2} (null "
          f"vectors)", flush=True)
    if not (mg_k1 and mg_k2):
        raise AssertionError("the MG path launched no K1 or no K2")
    setup = st["mg_setup"]
    print(f"  MG run_twop {mg_secs:.3f} s; stages (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in st["secs"].items()), flush=True)
    print(f"  setup_mg_pair: null vectors {setup[0]['null_vector_secs']:.3f}"
          f" s (msrc iterations {setup[0]['msrc_iters']}), orthonormalisation"
          f" {setup[0]['ortho_secs']:.3f} s, coarse builds "
          f"{setup[0]['coarse_build_secs']:.3f} + "
          f"{setup[1]['coarse_build_secs']:.3f} s", flush=True)
    mg_worst = max(max(st[f]["true_res"]) for f in ("up", "dn"))
    print(f"  24 MG-GCR-PC solves: {st['secs']['solve']:.3f} s, outer "
          f"iterations up {st['up']['iters']} dn {st['dn']['iters']}; worst "
          f"true_res (complex64) {mg_worst:.3e}", flush=True)
    cert = max(max(_certify(u, fl, geom, st["sources"], st[f]["x"]))
               for fl, f in ((+1, "up"), (-1, "dn")))
    _check("MG worst column's true residual (complex128)", cert,
           TRUE_RES_LIMIT)
    _check("pion, MG vs CG (relative)",
           _rel(_pion(out, zero), _pion({"mesons": mes_cg}, zero)),
           TWOP_MG_PION)
    threep_in["mg_pair"] = out["mg_pair"]
    del out, st
    gc.collect()
    torch.cuda.empty_cache()

    # the CLI, in process: single precision (K2, K1 float32), and double
    # (K1's float64 and float32 instances, a mixed CG a column)
    cli_k1 = 0
    for precision, tol in (("single", TWOP_TOL), ("double", 1e-10)):
        dslash_ch.launches = 0
        with tempfile.TemporaryDirectory() as tmp:
            stem = str(Path(tmp) / "twop")
            cli.main(["twop", "--xdim", str(cli_dims[0]), "--ydim",
                      str(cli_dims[1]), "--zdim", str(cli_dims[2]),
                      "--tdim", str(cli_dims[3]), "--kappa", str(p.kappa),
                      "--mu", str(p.mu), "--csw", str(p.csw), "--tol",
                      str(tol), "--seed", "7", "--device", DEVICE,
                      "--precision", precision, "--output", stem])
            written = sorted(f.name for f in Path(tmp).iterdir())
        cli_k1 += dslash_ch.launches
        print(f"  cli twop --precision {precision} at {cli_dims} wrote "
              f"{written}; K1 launches {dslash_ch.launches}", flush=True)
        if not (dslash_ch.launches
                and any(w.startswith("twop_mesons") for w in written)):
            raise AssertionError(f"the CLI ({precision}) launched no K1 or "
                                 "wrote no meson file")
    print(f"  phase 11 {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"k1": k1 + k1_single + mg_k1 + cli_k1, "k2": k2 + mg_k2,
            "err": err, "u": u, "threep_in": threep_in,
            "refs": {"mesons": mes_cg, "baryons": bar_cg}}


def _loops_finite(loops: dict, label: str):
    import torch
    bad = [k for k, v in loops.items() if not bool(torch.isfinite(v).all())]
    if bad:
        raise AssertionError(f"{label}: non-finite loop types {bad}")


def phase_threep_loops(twop, geom_dims, cli_dims):
    """Phase 12: the 3pt and the loops at ``geom_dims`` on phase 11's
    gauge, propagators, smeared links and MG pair.  (a) ``run_threep``
    at t_sink = 12, G4, proton, both parts, on the CG path (each part's
    12 sequential columns one multi-source solve through K2), each
    column certified by the plain complex128 operator of the opposite
    flavour, and K1 / K2 at the path's operands against plain; (b) the
    same with the MG pair: its columns certified and against (a)'s, each
    insertion type against (a) at the insertion times where the
    sequential propagator is resolved (``THREEP_RESOLVED``); (c)
    ``run_loops`` (12 noise
    vectors at tol 1e-2, 2 HP/LP pairs at 1e-7; the solves through K1),
    each HP solve certified in complex128, the partner's ``m`` through K1
    against the plain complex128 one; (d) ``run_loops_wexact`` in
    complex128 through K1's float64 instance (Chebyshev-filtered
    Lanczos, nev 16, ncv 40), the Ritz residuals and the deflated CG
    against the undeflated one; (e) ``cli threep`` and ``cli loops`` at
    ``cli_dims``.  Returns the K1 and K2 launches of (a)–(e) and the
    kernels' largest absolute errors at the 3pt's operands."""
    import tempfile
    import torch
    from quda_qkxtm_multigrid_tpu_torch import cli
    from quda_qkxtm_multigrid_tpu_torch import workflows as wf
    from quda_qkxtm_multigrid_tpu_torch.benchmarks import tmc_params
    from quda_qkxtm_multigrid_tpu_torch.dirac import DiracParams, make_dirac
    from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry
    from quda_qkxtm_multigrid_tpu_torch.ops.dslash_kernel import (
        dslash_ch, dslash_ch_msrc)
    from quda_qkxtm_multigrid_tpu_torch.solvers.cg import cg
    from quda_qkxtm_multigrid_tpu_torch.solvers.eigen import deflate_guess
    from quda_qkxtm_multigrid_tpu_torch.utils.rng import z4_source

    t_phase = time.perf_counter()
    geom = Geometry(*geom_dims)
    u, inp = twop["u"], twop["threep_in"]
    p = tmc_params()
    phys = dict(kappa=p.kappa, mu=p.mu, csw=p.csw)
    c128 = torch.complex128
    print(f"phase 12: the 3pt and the loops at {geom_dims} on phase 11's "
          f"gauge and propagators", flush=True)
    launches = {"k1": 0, "k2": 0}

    def run(label, fn):
        """``fn()`` with the K1 / K2 counts set to 0 before it and read
        after it, its seconds and its peak memory printed."""
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        dslash_ch.launches = dslash_ch_msrc.launches = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        k1, k2 = dslash_ch.launches, dslash_ch_msrc.launches
        launches["k1"] += k1
        launches["k2"] += k2
        print(f"  {label}: {secs:.3f} s, K1 launches {k1}, K2 launches "
              f"{k2}, peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
              flush=True)
        return out, k1, k2

    # (a) the 3pt on the CG path
    kw = dict(prop_up=inp["prop_up"], prop_dn=inp["prop_dn"],
              u_ape=inp["u_ape"], tsink=THREEP_TSINK, source=TWOP_SOURCE,
              projectors=(THREEP_PROJ,), tol=TWOP_TOL,
              maxiter=SLICE_MAXITER, **phys)
    st = {}
    cg_out, _, k2 = run("run_threep (CG path)",
                        lambda: wf.run_threep(u, geom, stats=st, **kw))
    print("  stages (s): " + ", ".join(f"{k} {v:.3f}"
                                       for k, v in st["secs"].items()),
          flush=True)
    parts = [st[(THREEP_PROJ, part)] for part in (1, 2)]
    iters = [pt["iters"] for pt in parts]
    print(f"  msrc CG iterations part1 {iters[0]} part2 {iters[1]}; "
          f"K2 launches {k2} (4 an iteration)", flush=True)
    if k2 != 4 * sum(iters):
        raise AssertionError(f"K2 launches {k2} != 4 × {sum(iters)}")
    worst = 0.0
    for part, pt in zip((1, 2), parts):
        res = _certify(u, pt["flavor"], geom, pt["sources"], pt["x"])
        worst = max(worst, max(res))
        print(f"  part{part} (flavour {pt['flavor']:+d}): solver's worst "
              f"true_res (complex64) {pt['true_res']:.3e}; complex128 per "
              "column " + " ".join(f"{r:.2e}" for r in res), flush=True)
    _check("3pt: worst sequential column (complex128)", worst,
           TRUE_RES_LIMIT)
    err = _twop_kernel_checks(u, geom, parts[0]["sources"],
                              flavor=parts[0]["flavor"], label="3pt ")
    thrp_cg = cg_out["thrp"][THREEP_PROJ]
    for part, types in thrp_cg.items():
        for t, v in types.items():
            if not bool(torch.isfinite(v).all()):
                raise AssertionError(f"3pt {part} {t} is not finite")
    ul = thrp_cg["part1"]["ultra_local"]
    print("  part1 ultra-local (complex128), op 0, zero momentum, t = "
          "0..12: " + " ".join(f"{float(c.real):.4e}" for c in ul[0, :13, 3]),
          flush=True)
    x_cg = {part: pt["x"] for part, pt in zip((1, 2), parts)}
    del st, parts, cg_out

    # (b) the 3pt with the MG pair
    st = {}
    mg_out, _, _ = run("run_threep (MG pair)", lambda: wf.run_threep(
        u, geom, mg_pair=inp["mg_pair"], stats=st, **kw))
    resolved = {}
    for part in (1, 2):
        pt = st[(THREEP_PROJ, part)]
        res = _certify(u, pt["flavor"], geom, pt["sources"], pt["x"])
        print(f"  MG part{part}: outer iterations {pt['iters']}", flush=True)
        _check(f"3pt MG part{part}: worst column (complex128)", max(res),
               TRUE_RES_LIMIT)
        _check(f"3pt MG part{part}: columns vs CG",
               max(_rel(a, b) for a, b in zip(pt["x"], x_cg[part])),
               TWOP_VS_SINGLES)
        norm_t = torch.linalg.vector_norm(
            x_cg[part].movedim(-3, 0).reshape(geom.T, -1), dim=1)
        resolved[f"part{part}"] = [
            i for i in range(geom.T)
            if float(norm_t[i]) >= THREEP_RESOLVED * float(norm_t.max())]
        print(f"  part{part}: sequential propagator's timeslice norm / its "
              "largest, t = 0..t_sink: " + " ".join(
                  f"{float(n / norm_t.max()):.1e}"
                  for n in norm_t[:THREEP_TSINK + 1])
              + f"; resolved t {resolved[f'part{part}']}", flush=True)
    for part, types in mg_out["thrp"][THREEP_PROJ].items():
        ts = resolved[part]
        for t, v in types.items():
            ref = thrp_cg[part][t]
            print(f"  3pt {part} {t}, MG vs CG at every t {_rel64(v, ref):.3e}"
                  "; t = 0..t_sink " + " ".join(
                      f"{_rel64(v[..., i, :], ref[..., i, :]):.1e}"
                      for i in range(THREEP_TSINK + 1)), flush=True)
            _check(f"3pt {part} {t}, MG vs CG (resolved t)",
                   _rel64(v[..., ts, :], ref[..., ts, :]), THREEP_MG_VS_CG)
    # phase 16's references: the 3pt of the CG path and its inputs
    twop["refs"].update(thrp=thrp_cg, threep_in={
        k: inp[k].cpu() for k in ("prop_up", "prop_dn", "u_ape")})
    del st, mg_out, thrp_cg, kw, inp, twop["threep_in"], x_cg

    # (c) the loops, complex64, through K1
    st = {}
    loops, _, _ = run("run_loops", lambda: wf.run_loops(
        u, geom, n_stoch=LOOPS_NSTOCH,
        gen=torch.Generator(DEVICE).manual_seed(7), tol=TWOP_TOL,
        tol_lp=LOOPS_TOL_LP, n_hp=LOOPS_NHP, maxiter=SLICE_MAXITER,
        stats=st, **phys))
    print("  stages (s): " + ", ".join(f"{k} {v:.3f}"
                                       for k, v in st["secs"].items()),
          flush=True)
    _loops_finite(loops, "run_loops")
    res = _certify(u, +1, geom, [h[0] for h in st["hp"]],
                   [h[1] for h in st["hp"]])
    print(f"  HP solves: iterations {[h[3] for h in st['hp']]}, complex128 "
          + " ".join(f"{r:.2e}" for r in res), flush=True)
    _check("loops: worst HP solve (complex128)", max(res), TRUE_RES_LIMIT)
    x = st["hp"][0][1]
    got = st["partner"].m(x)
    plain = make_dirac(u.to(c128), DiracParams(kind="clover", kappa=p.kappa,
                                               csw=p.csw), geom)
    _check("loops: partner m through K1 vs plain c128",
           _rel64(got, plain.m(x.to(c128))), PARTNER_M_LIMIT)
    twop["refs"]["loops"] = {k: v.cpu() for k, v in loops.items()}
    del st, loops, x, got, plain

    # (d) the deflated loops, complex128, through K1's float64 instance
    u128 = u.to(c128)
    st = {}
    (wex, eig), _, _ = run("run_loops_wexact (complex128)",
                           lambda: wf.run_loops_wexact(
                               u128, geom, gen=torch.Generator(
                                   DEVICE).manual_seed(8),
                               maxiter=SLICE_MAXITER, stats=st, **WEXACT,
                               **phys))
    es = st["eig"]
    print(f"  Lanczos: Chebyshev degree {WEXACT['cheb_degree']} on "
          f"[{es['bounds'][0]:.6f}, {es['bounds'][1]:.6f}], "
          f"{es['restarts']} restarts, {es['matvecs']} matvecs, "
          f"{es['secs']:.3f} s; stages (s): " + ", ".join(
              f"{k} {v:.3f}" for k, v in st["secs"].items()), flush=True)
    print("  eigenvalues " + " ".join(f"{float(v):.8f}" for v in eig.evals)
          + f"; deflated CG iterations {st['cg_iters']}", flush=True)
    _check("Lanczos: worst Ritz residual (complex128)",
           float(eig.resid.max()), RITZ_LIMIT)
    if not bool((eig.evals > 0).all()):
        raise AssertionError("an eigenvalue of M_pc†M_pc is not positive")
    _loops_finite(wex, "run_loops_wexact")
    # phase 16d's references
    twop["refs"]["wexact"] = {
        "evals": eig.evals.cpu(), "loops": {k: v.cpu() for k, v in
                                            wex.items()}}
    d = wf.make_operator(u128, tmc_params(), geom)
    xi = z4_source(torch.Generator(DEVICE).manual_seed(9), geom, c128)
    b = d.matpc(d.prepare(xi), dagger=True)
    tol = WEXACT["tol"]
    plain_cg = cg(d.matpc_dagm, b, tol=tol, maxiter=SLICE_MAXITER)
    defl = cg(d.matpc_dagm, b, x0=deflate_guess(eig.evecs, eig.evals, b),
              tol=tol, maxiter=SLICE_MAXITER)
    print(f"  CG at tol {tol} on one source: undeflated {plain_cg.iters}, "
          f"deflated {defl.iters} iterations", flush=True)
    if defl.iters > plain_cg.iters:
        raise AssertionError("the deflated CG took more iterations")
    del st, wex, eig, d, xi, b, plain_cg, defl, u128

    # (e) the CLI in process, single precision
    def cli_run():
        written = []
        args = ["--xdim", str(cli_dims[0]), "--ydim", str(cli_dims[1]),
                "--zdim", str(cli_dims[2]), "--tdim", str(cli_dims[3]),
                "--kappa", str(p.kappa), "--mu", str(p.mu), "--csw",
                str(p.csw), "--tol", str(TWOP_TOL), "--seed", "7",
                "--device", DEVICE]
        with tempfile.TemporaryDirectory() as tmp:
            cli.main(["threep", *args, "--tsink", str(cli_dims[3] // 4),
                      "--output", str(Path(tmp) / "thrp")])
            cli.main(["loops", *args, "--tol-LP", str(LOOPS_TOL_LP),
                      "--nHP", "1", "--output", str(Path(tmp) / "loops")])
            written = sorted(f.name for f in Path(tmp).iterdir())
        return written
    written, k1, k2 = run(f"cli threep and loops at {cli_dims}", cli_run)
    print(f"  wrote {written}", flush=True)
    if not (k1 and k2 and any("thrp" in w for w in written)
            and any(w.startswith("loops") for w in written)):
        raise AssertionError("the CLI launched no K1 or K2, or wrote no 3pt "
                             "or loop file")
    print(f"  phase 12 {time.perf_counter() - t_phase:.1f} s; K1 launches "
          f"{launches['k1']}, K2 launches {launches['k2']}", flush=True)
    if not (launches["k1"] and launches["k2"]):
        raise AssertionError("phase 12 launched no K1 or no K2")
    return {**launches, "err": err}

def _galerkin(transfer, fine_apply, coarse_apply, gen, label: str):
    """D_c w against R (D P w) on a random complex64 coarse field w,
    normwise to ``GALERKIN_LIMIT``."""
    import torch
    from quda_qkxtm_multigrid_tpu_torch.utils.rng import normal_complex
    bg = transfer.bg
    w = normal_complex(gen, (bg.fine_ns, bg.nvec) + tuple(bg.coarse_shape),
                       torch.complex64)
    _check(label, _rel(coarse_apply(w),
                       transfer.restrict(fine_apply(transfer.prolong(w)))),
           GALERKIN_LIMIT)


def _vcycle_ms(vcycle, b, reps: int = 3) -> float:
    """ms of one call of ``vcycle`` (a preconditioner's V-cycle) on the
    field ``b`` (host clock, the device synchronised; the median of
    ``reps``)."""
    import torch
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vcycle(b)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _levels_line(rec) -> str:
    """The setup split of a ``bench_mg`` record, level by level."""
    line = (f"setup {rec['setup_secs']:.3f} s: level 1 null vectors "
            f"{rec['null_vector_secs']:.3f} s (msrc iterations "
            f"{rec['msrc_iters']}), orthonormalisation "
            f"{rec['ortho_secs']:.3f} s, coarse build "
            f"{rec['coarse_build_secs']:.3f} s")
    for lv in ("level2", "level3"):
        if lv in rec:
            st = rec[lv]
            line += (f"; {lv} null vectors {st['null_vector_secs']:.3f} s "
                     f"(BiCGstab iterations {sum(st['bicgstab_iters'])} in "
                     f"all, at most {max(st['bicgstab_iters'])}), build "
                     f"{st['build_secs']:.3f} s")
    return line


def phase_mg_levels(geom_dims, light_dims, probe_dims, cli_dims, mg6: dict):
    """Phase 13: the production multigrid.  (a) three-level MG-GCR-PC at
    ``geom_dims`` on phase 6's complex64 problem (4⁴ × 24, then the
    level-2 defaults 2⁴ × 24, GCR(8), setup2 tol 1e-4), the level-2
    Galerkin identity, the complex128 true residual; (b) the same on
    four levels (level 3: 2⁴ × 16); (c) two levels with the null vectors
    stored in bf16: V's bytes against the complex64 V's, restrict and
    prolong against complex128 on the bf16-rounded V and field, the
    true residual; (d) two levels at ``light_dims`` with GCR-PC(10);
    (e) ``bench_light`` at ``light_dims`` (the κ ladder at
    ``probe_dims``, μ 0.003) with a three-level ``delta_mu_coarse=8``
    MG beside the two-level ones, every residual finite, no MG solve
    falsely converged, K1 / K2 on its operator against plain; (f) ``cli
    twop --mg --mg-levels 3 --mg-solver gcr-pc`` at ``cli_dims`` against
    the CG route's pion.  Each part's seconds, peak memory and K1 / K2 launches.
    Returns the launches and the kernels' largest absolute errors."""
    import tempfile
    import torch
    from quda_qkxtm_multigrid_tpu_torch import cli
    from quda_qkxtm_multigrid_tpu_torch.benchmarks import (
        bench_light, bench_mg, make_problem, tmc_params)
    from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry
    from quda_qkxtm_multigrid_tpu_torch.mg.transfer import Transfer
    from quda_qkxtm_multigrid_tpu_torch.ops.dslash_kernel import (
        dslash_ch, dslash_ch_msrc)
    from quda_qkxtm_multigrid_tpu_torch.utils import rng

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 13: three- and four-level MG, bf16 null vectors, the "
          f"light-mass point; memory in use at its start "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    geom = Geometry(*geom_dims)
    launches = {"k1": 0, "k2": 0}
    gen = torch.Generator(device=DEVICE).manual_seed(17)

    def run(label, fn):
        """``fn()`` with the K1 / K2 counts set to 0 before it and read
        after it, its seconds and its peak memory printed."""
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        dslash_ch.launches = dslash_ch_msrc.launches = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        k1, k2 = dslash_ch.launches, dslash_ch_msrc.launches
        launches["k1"] += k1
        launches["k2"] += k2
        print(f"  ({label[0]}) {label[2:]}: {secs:.3f} s, K1 launches {k1}, "
              f"K2 launches {k2}, peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
              flush=True)
        if not (k1 and k2):
            raise AssertionError(f"({label[0]}) launched no K1 or no K2")
        return out

    d, b = make_problem(geom, DEVICE, seed=7, dtype=torch.complex64)
    two_ms = 1e3 * mg6["split"]["vcycle"] / mg6["split"]["iters"]
    mg_kw = dict(tol=MG_TOL, nvec=MG_NVEC, block=MG_BLOCK,
                 n_krylov=MG_NKRYLOV, problem=(d, b))
    records = {}

    # (a), (b): three and four levels
    for tag, n_level in (("a", 3), ("b", 4)):
        rec, mg = run(f"{tag} {n_level}-level MG-GCR-PC at {geom_dims}",
                      lambda: bench_mg(geom, n_level=n_level, **mg_kw))
        records[tag] = rec
        vc_ms = _vcycle_ms(mg.vcycle, b)
        print(f"  {_levels_line(rec)}", flush=True)
        print(f"  outer iterations {rec['iters']} (cold {rec['iters_cold']};"
              f" two levels, phase 6: {mg6['iters']}; JAX record "
              f"{MG_JAX_RECORD_ITERS})  warm secs {rec['secs']:.4f}  V-cycle"
              f" {vc_ms:.2f} ms (two levels, phase 6: {two_ms:.2f} ms)  "
              f"true_res {rec['true_res']:.3e} (complex128; complex64 solve "
              f"{rec['true_res_solve']:.3e})  GFLOP/s {rec['gflops']:.1f}",
              flush=True)
        _galerkin(mg.transfer2, mg.coarse.apply, mg.coarse2.apply, gen,
                  "level-2 Galerkin D2 = R2 D1 P2 (complex64)")
        if n_level == 4:
            _galerkin(mg.transfer3, mg.coarse2.apply, mg.coarse3.apply, gen,
                      "level-3 Galerkin D3 = R3 D2 P3 (complex64)")
        _check(f"{n_level}-level true residual (complex128)",
               rec["true_res"], TRUE_RES_LIMIT)
        del mg

    # (c) bf16 null vectors
    rec, mg = run(f"c bf16 null vectors, two levels, at {geom_dims}",
                  lambda: bench_mg(geom, vec_dtype="bf16", **mg_kw))
    records["c"] = rec
    tr = mg.transfer
    c64_bytes = tr.vr.numel() * 8
    print(f"  V {tr.nbytes / 2**30:.4f} GiB in bf16 against "
          f"{c64_bytes / 2**30:.4f} GiB complex64; outer iterations "
          f"{rec['iters']} (float32 V, phase 6: {mg6['iters']}; JAX record "
          f"{MG_JAX_RECORD_ITERS} with bf16 V and GCR(5)); true_res "
          f"{rec['true_res']:.3e} (complex128)", flush=True)
    if 2 * tr.nbytes != c64_bytes or tr.vr.dtype != torch.bfloat16:
        raise AssertionError(f"bf16 V holds {tr.nbytes} bytes, not half of "
                             f"{c64_bytes}")
    t128 = Transfer(v=torch.complex(tr.vr.double(), tr.vi.double()),
                    bg=tr.bg)

    def rounded(f):
        return torch.complex(f.real.to(torch.bfloat16).double(),
                             f.imag.to(torch.bfloat16).double())
    f = rng.random_spinor(gen, geom, torch.complex64)
    vc = tr.restrict(f)
    _check("bf16 restrict vs complex128 (same bf16 V, field)",
           _rel(vc.to(torch.complex128), t128.restrict(rounded(f))),
           BF16_TRANSFER_LIMIT)
    _check("bf16 prolong vs complex128 (same bf16 V, field)",
           _rel(tr.prolong(vc).to(torch.complex128),
                t128.prolong(rounded(vc))), BF16_TRANSFER_LIMIT)
    _check("bf16-V true residual (complex128)", rec["true_res"],
           TRUE_RES_LIMIT)
    del mg, tr, t128, f, vc, d, b

    # (d) two levels at the 24³×48 record's settings, GCR-PC(10)
    lg = Geometry(*light_dims)
    rec, _ = run(f"d two-level MG-GCR-PC(10) at {light_dims}",
                 lambda: bench_mg(lg, tol=MG_TOL, nvec=MG_NVEC,
                                  block=MG_BLOCK, n_krylov=10,
                                  problem=make_problem(
                                      lg, DEVICE, seed=7,
                                      dtype=torch.complex64)))
    records["d"] = rec
    print(f"  {_levels_line(rec)}", flush=True)
    print(f"  outer iterations {rec['iters']} (JAX mg24 record "
          f"{MG24_JAX_ITERS}, GCR(10)); warm secs {rec['secs']:.4f}; "
          f"true_res {rec['true_res']:.3e} (complex128)", flush=True)
    _check("24³×48 true residual (complex128)", rec["true_res"],
           TRUE_RES_LIMIT)

    # (e) the light-mass point
    light = run(f"e bench_light at {light_dims}, ladder at {probe_dims}",
                lambda: bench_light(lg, mu=LIGHT_MU,
                                    probe_geom=Geometry(*probe_dims),
                                    device=DEVICE))
    records["e"] = light
    print("  ladder " + ", ".join(
        f"κ {r['kappa']}: {r['iters']} iterations {r['true_res']:.2e}"
        for r in light["probe_ladder"]) + f" (JAX {LIGHT_JAX['ladder']})",
        flush=True)
    print(f"  κ {light['kappa']}: CG {light['cg_iters']} iterations, "
          f"{light['cg_secs']:.3f} s, its residual {light['cg_res']:.3e}, "
          f"complex128 {light['cg_true_res']:.3e} (JAX: "
          f"{LIGHT_JAX['cg']})", flush=True)
    tags = ("mg_", "mg_dmu_", "mg3_dmu_")
    for tag in tags:
        print(f"  {tag[:-1]}: setup {light[tag + 'setup_secs']:.3f} s, "
              f"{light[tag + 'iters']} outer iterations, "
              f"{light[tag + 'secs']:.3f} s, its residual "
              f"{light[tag + 'res']:.3e}, complex128 "
              f"{light[tag + 'true_res']:.3e} (JAX: "
              f"{LIGHT_JAX.get(tag, 'no record')})", flush=True)
    print(f"  mg_beats_cg {light['mg_beats_cg']} (an MG solve certified to "
          f"5 × tol), amortise_solves {light['amortise_solves']}",
          flush=True)
    nums = [light["cg_res"], light["cg_true_res"]] + [
        light[t + k] for t in tags for k in ("res", "true_res")] + [
        r["true_res"] for r in light["probe_ladder"]]
    if not all(v == v and abs(v) != float("inf") for v in nums):
        raise AssertionError(f"a light-mass residual is not finite: {nums}")
    for tag in tags:
        _check(f"{tag[:-1]}: complex128 / own residual",
               light[tag + "true_res"] / light[tag + "res"],
               FALSE_CONVERGENCE_RATIO)
    dl, _ = _light_operator(lg, light["kappa"])
    err = _chain_kernel_checks(
        dl, lg, rng.random_spinor(gen, lg, torch.complex64,
                                  batch_shape=(MSRC_TIME_N,)),
        label=f"κ {light['kappa']}: ")
    del dl

    # (f) the CLI on three levels against its CG route
    def cli_pair():
        p = tmc_params()
        args = ["twop", "--xdim", str(cli_dims[0]), "--ydim",
                str(cli_dims[1]), "--zdim", str(cli_dims[2]), "--tdim",
                str(cli_dims[3]), "--kappa", str(p.kappa), "--mu",
                str(p.mu), "--csw", str(p.csw), "--tol", str(TWOP_TOL),
                "--seed", "7", "--device", DEVICE]
        outs = []
        with tempfile.TemporaryDirectory() as tmp:
            for extra in ([], ["--mg", "--mg-levels", "3", "--mg-solver",
                               "gcr-pc"]):
                outs.append(cli.main(args + extra + [
                    "--output", str(Path(tmp) / f"twop{len(outs)}")]))
        return outs
    cg_out, mg_out = run(f"f cli twop --mg --mg-levels 3 at {cli_dims}",
                         cli_pair)
    pair = mg_out["mg_pair"]
    if not all(m.coarse2 is not None for m in pair):
        raise AssertionError("the CLI's MG pair has no level 2")
    zero = [i for i, m in enumerate(cg_out["moms"]) if not any(m)][0]
    _check("cli: pion, 3-level MG vs CG (relative)",
           _rel(_pion(mg_out, zero), _pion(cg_out, zero)), TWOP_MG_PION)
    del cg_out, mg_out, pair
    print(f"  phase 13 {time.perf_counter() - t_phase:.1f} s; K1 launches "
          f"{launches['k1']}, K2 launches {launches['k2']}", flush=True)
    return {**launches, "err": err, "records": records}


# ---- phase 14: the Krylov tail and the non-degenerate doublet ------------

def _stamp(label: str, run_out: dict, extra: str = ""):
    print(f"  {label}: {run_out['secs']:.3f} s, K1 launches {run_out['k1']}, "
          f"K2 launches {run_out['k2']}{extra}", flush=True)


def _counted(fn, launches: dict) -> dict:
    """``fn()`` with the K1 / K2 counts set to 0 before it and read after
    it (added to ``launches``), timed on the host with the device
    synchronised."""
    import torch
    from quda_qkxtm_multigrid_tpu_torch.ops.dslash_kernel import (
        dslash_ch, dslash_ch_msrc)
    torch.cuda.synchronize()
    dslash_ch.launches = dslash_ch_msrc.launches = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    k1, k2 = dslash_ch.launches, dslash_ch_msrc.launches
    launches["k1"] += k1
    launches["k2"] += k2
    return {"out": out, "secs": secs, "k1": k1, "k2": k2}


def _batched_vs_singles(d, v, label: str) -> float:
    """``matpc_dagm_batched`` on the block ``v`` (one K2 chain) against n
    single K1 chains: the largest absolute difference, printed (the K2
    sum order is K1's: expected 0)."""
    import torch
    got = d.matpc_dagm_batched(v)
    want = torch.stack([d.matpc_dagm(a) for a in v])
    diff = float((got - want).abs().max())
    print(f"  {label}: K2 n = {v.shape[0]} chain vs {v.shape[0]} K1 chains, "
          f"largest difference {diff:.3e}", flush=True)
    _check(f"{label}: K2 chain vs K1 chains (normwise)", _rel(got, want),
           MSRC_VS_K1_LIMIT)
    return diff


def _full_res(d128, x_p, b128) -> float:
    """The complex128 full operator's |b − M x| / |b| after reconstruct."""
    import torch
    from quda_qkxtm_multigrid_tpu_torch.invert import true_residual
    x = d128.reconstruct(x_p.to(torch.complex128), b128)
    return float(true_residual(d128, x, b128)[1])


def _krylov_reference(geom_dims, launches: dict, gen) -> dict:
    """Phase 14 (a): the solvers at ``geom_dims`` on the reference
    twisted-clover operator (complex64, the K1 chain, tol ``KRYLOV_TOL``;
    module docstring), each with its iterations, seconds and launches,
    every converged solve certified in complex128; the batched applies
    against single chains; K1 / K2 on the chain's operands against
    plain.  Returns the kernels' largest absolute errors."""
    import numpy as np
    import torch
    from quda_qkxtm_multigrid_tpu_torch.benchmarks import make_problem
    from quda_qkxtm_multigrid_tpu_torch.dirac import make_dirac
    from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry
    from quda_qkxtm_multigrid_tpu_torch.solvers import (
        ChronoHistory, gmresdr, multishift_cg_refined, pipelined_cg,
        pipelined_cg_reliable, sd)
    from quda_qkxtm_multigrid_tpu_torch.solvers.ca import bicgstab_l, mpcg
    from quda_qkxtm_multigrid_tpu_torch.solvers.cg import CGResult, cg
    from quda_qkxtm_multigrid_tpu_torch.solvers.mr import mr
    from quda_qkxtm_multigrid_tpu_torch.solvers.pcg import (
        pcg, simple_bicgstab, xsd)
    from quda_qkxtm_multigrid_tpu_torch.solvers.support import (
        defect_correction)
    from quda_qkxtm_multigrid_tpu_torch.utils import rng

    c128, tol, mx = torch.complex128, KRYLOV_TOL, SLICE_MAXITER
    geom = Geometry(*geom_dims)
    d, b = make_problem(geom, DEVICE, seed=7, dtype=torch.complex64)
    d128 = make_dirac(d.u.to(c128), d.params, geom)
    b128 = b.to(c128)
    src = d.prepare(b)
    rhs = d.matpc(src, dagger=True)
    rhs128 = d128.matpc(d128.prepare(b128), dagger=True)

    def solve(label, fn, converged=lambda o: True):
        r = _counted(fn, launches)
        o = r["out"]
        cert = _full_res(d128, o.x, b128) if converged(o) else None
        _stamp(f"(a) {label}", r, f", iterations {o.iters}" + (
            f", c128 true_res {cert:.3e}" if cert is not None
            else ", not converged"))
        if not r["k1"]:
            raise AssertionError(f"{label} launched no K1")
        if cert is not None:
            _check(f"{label}: true residual (complex128)", cert,
                   TRUE_RES_LIMIT)
        return o, r

    solve("pcg", lambda: pcg(d.matpc_dagm, rhs, tol=tol, maxiter=mx))
    solve("pcg, MR(4, ω 0.9) preconditioner",
          lambda: pcg(d.matpc_dagm, rhs, tol=tol, maxiter=mx,
                      precond=lambda r: mr(d.matpc_dagm, r, niter=4,
                                           omega=0.9)))
    # the pipelined recurrences floor near 1e-6 in complex64 (the JAX
    # function's too): the plain one runs on the complex128 chain
    solve("pipelined_cg (c128, K1 f64)",
          lambda: pipelined_cg(d128.matpc_dagm, rhs128, tol=tol, maxiter=mx))
    o, _ = solve("pipelined_cg_reliable (c128 outer K1 f64, c64 inner)",
                 lambda: pipelined_cg_reliable(
                     d128.matpc_dagm, d.matpc_dagm, rhs128, tol=tol,
                     maxiter=mx))
    print(f"    restarts {o.stats.restarts}", flush=True)

    # s-step CG in complex64 floors near 7e-7 at s = 4 (the monomial
    # basis): it runs as the inner solve of complex128 defect correction
    def mpcg_dc():
        x, r2, its, st = defect_correction(
            d128.matpc_dagm,
            lambda r, cap: mpcg(d.matpc_dagm, r, s=MPCG_S, tol=DC_INNER,
                                max_blocks=max(1, cap // MPCG_S),
                                matvec_batched=d.matpc_dagm_batched),
            rhs128, torch.complex64, tol, mx, 20, 20, 20)
        return CGResult(x, its, r2, st)
    o, r = solve(f"mpcg s = {MPCG_S} (block through K2) in c128 defect "
                 "correction", mpcg_dc)
    print(f"    restarts {o.stats.restarts}", flush=True)
    if not r["k2"]:
        raise AssertionError("mpcg launched no K2")
    _batched_vs_singles(d, rng.random_spinor(
        gen, geom, torch.complex64, batch_shape=(MPCG_S,))[:, 0],
        f"mpcg block, s = {MPCG_S}")
    del rhs128, o
    solve("simple_bicgstab on matpc",
          lambda: simple_bicgstab(d.matpc, src, tol=tol, maxiter=mx))
    solve("bicgstab_l L = 2 on matpc",
          lambda: bicgstab_l(d.matpc, src, L=2, tol=tol, maxiter=mx))
    solve(f"gmresdr(20, 8) on matpc, at most {GMRESDR_RESTARTS} cycles",
          lambda: gmresdr(d.matpc, src, tol=tol, n_krylov=20, n_defl=8,
                          max_restarts=GMRESDR_RESTARTS),
          converged=lambda o: float(o.r2) <= tol * tol * float(
              (src.abs() ** 2).sum()))

    # multi-shift: each shift certified on its own system in complex128
    shifts = [float(s) for s in np.geomspace(1e-4, 1.0, 12)]
    r = _counted(lambda: multishift_cg_refined(d.matpc_dagm, rhs, shifts,
                                               tol=tol, maxiter=mx), launches)
    o = r["out"]
    rhs_c = rhs.to(c128)
    certs = [float((rhs_c - d128.matpc_dagm(x.to(c128)) - s * x.to(c128)
                    ).norm() / rhs_c.norm()) for s, x in zip(shifts, o.x)]
    _stamp("(a) multishift_cg_refined, 12 shifts 1e-4…1", r,
           f", shifted pass {o.iters} iterations, refinements "
           f"{o.refine_iters}, c128 (A + σ) residuals "
           f"{min(certs):.2e}…{max(certs):.2e}")
    _check("multishift: worst shift residual (complex128)", max(certs),
           TRUE_RES_LIMIT)
    del o, rhs_c

    # the chronological guess over 8 nearby sources
    chrono = ChronoHistory(depth=CHRONO_DEPTH)
    for _ in range(CHRONO_DEPTH):
        eta = rng.random_spinor(gen, geom, torch.complex64)
        bj = b + (0.01 * b.norm() / eta.norm()) * eta   # 1 % of |b|
        chrono.push(cg(d.matpc_dagm, d.matpc(d.prepare(bj), dagger=True),
                       tol=tol, maxiter=mx).x)
    r0 = _counted(lambda: cg(d.matpc_dagm, rhs, tol=tol, maxiter=mx),
                  launches)
    rg = _counted(lambda: chrono.guess(d.matpc_dagm, rhs,
                                       matvec_batched=d.matpc_dagm_batched),
                  launches)
    if not rg["k2"]:
        raise AssertionError("the history's applies launched no K2")
    rc = _counted(lambda: cg(d.matpc_dagm, rhs, x0=rg["out"], tol=tol,
                             maxiter=mx), launches)
    cert = _full_res(d128, rc["out"].x, b128)
    _stamp(f"(a) min_res_ext guess, history of {CHRONO_DEPTH}", rg)
    _stamp("(a) CG from the guess", rc,
           f", iterations {rc['out'].iters} against {r0['out'].iters} from "
           f"zero, c128 true_res {cert:.3e}")
    _check("chrono CG: true residual (complex128)", cert, TRUE_RES_LIMIT)
    _batched_vs_singles(d, torch.stack(chrono._xs),
                        f"history, depth {CHRONO_DEPTH}")
    del chrono, r0, rg, rc

    # sd and xsd: smoothers, 50 fixed steps
    for label, fn in (("sd", sd), ("xsd", xsd)):
        r = _counted(lambda: fn(d.matpc_dagm, rhs, tol=0.0, maxiter=50),
                     launches)
        o = r["out"]
        red = float((rhs - d.matpc_dagm(o.x)).norm() / rhs.norm())
        _stamp(f"(a) {label}, 50 steps", r, f", |r|/|b| {red:.3e}")
        if not (o.iters == 50 and red < 1.0):   # finite and reduced
            raise AssertionError(f"{label} did not reduce the residual")
    return _chain_kernel_checks(d, geom, rng.random_spinor(
        gen, geom, torch.complex64, batch_shape=(MPCG_S,)),
        label="(a) tmc: ")


def _krylov_doublet(geom_dims, check_dims, launches: dict, gen) -> float:
    """Phase 14 (b): the doublet (``NDEG``) at ``geom_dims``, CG on
    matpc†matpc through K2 at n = 2 certified by the plain complex128
    ``m``, K2's n = 2 bare hop against plain on the solve's source; at
    ``check_dims`` in complex128 (K1 f64) τ1γ5-hermiticity, the Schur
    identities and the ε → 0 limit.  Returns K2's largest absolute
    error."""
    import torch
    from quda_qkxtm_multigrid_tpu_torch.benchmarks import make_gauge_source
    from quda_qkxtm_multigrid_tpu_torch.dirac import (
        DiracNdeg, DiracParams, make_dirac, make_dirac_ndeg)
    from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry
    from quda_qkxtm_multigrid_tpu_torch.ops.dslash_kernel import (
        dslash_ch_msrc, dslash_ch_msrc_reference)
    from quda_qkxtm_multigrid_tpu_torch.solvers.cg import cg
    from quda_qkxtm_multigrid_tpu_torch.utils import rng

    c128, tol = torch.complex128, KRYLOV_TOL
    geom = Geometry(*geom_dims)
    u, bp = make_gauge_source(geom, DEVICE, 7, torch.complex64)
    ndp = DiracParams(kind="twisted-mass", **NDEG, use_kernels=True)
    dn = make_dirac_ndeg(u, ndp, geom)
    bd = torch.zeros((2,) + tuple(bp.shape), dtype=bp.dtype, device=DEVICE)
    bd[0] = bp                     # the point source in the first flavour
    del bp

    def doublet_solve():
        s = dn.prepare(bd)
        return cg(dn.matpc_dagm, dn.matpc(s, dagger=True), tol=tol,
                  maxiter=SLICE_MAXITER), s
    r = _counted(doublet_solve, launches)
    o, dsrc = r["out"]
    if not r["k2"]:
        raise AssertionError("the doublet launched no K2")
    dplain = make_dirac_ndeg(u.to(c128), dataclasses.replace(
        ndp, use_kernels=False), geom)
    bd128 = bd.to(c128)
    x = dplain.reconstruct(o.x.to(c128), bd128)
    cert = float((bd128 - dplain.m(x)).norm() / bd128.norm())
    _stamp("(b) doublet CG on matpc†matpc (K2 n = 2)", r,
           f", iterations {o.iters}, c128 true_res (plain m) {cert:.3e}")
    _check("doublet: true residual (complex128, plain m)", cert,
           TRUE_RES_LIMIT)
    del dplain, bd128, x, o
    psi = DiracNdeg.to_ch(dsrc).to(torch.float32)
    kw = dict(recon12=True, antiperiodic=dn.antiperiodic)
    err = 0.0
    for p in (0, 1):
        for dag in (False, True):
            g = dn._gauge_ch(torch.float32, p)
            got = dslash_ch_msrc(g, psi, p, geom, dag, **kw)
            torch.cuda.synchronize()
            ref = dslash_ch_msrc_reference(g, psi, p, geom, dag, **kw)
            err = max(err, _compare(
                got, ref, f"(b) K2 n=2 bare hop parity {p} dagger {dag}",
                F32_LIMIT))
            del got, ref
    del psi, dn, dsrc, bd, u
    gc.collect()
    torch.cuda.empty_cache()

    cg_ = Geometry(*check_dims)
    u16 = rng.random_gauge(torch.Generator(device=DEVICE).manual_seed(7),
                           cg_, dtype=c128)
    dn16 = make_dirac_ndeg(u16, ndp, cg_)
    psi = torch.stack([rng.random_spinor(gen, cg_, c128) for _ in (0, 1)])
    g5 = torch.tensor([1, 1, -1, -1], dtype=c128,
                      device=DEVICE).reshape(4, 1, 1, 1, 1)
    t1g5 = lambda v: (g5 * v).flip(0)                    # noqa: E731
    _check("(b) 16³×32 τ1γ5-hermiticity (c128, K1 f64)",
           _rel(t1g5(dn16.m(t1g5(psi))), dn16.mdag(psi)), F64_LIMIT)
    bb = dn16.m(psi)
    _check("(b) 16³×32 Schur: matpc x_p = prepare(M x)",
           _rel(dn16.matpc(psi[:, 0]), dn16.prepare(bb)), F64_LIMIT)
    _check("(b) 16³×32 Schur: reconstruct", _rel(
        dn16.reconstruct(psi[:, 0], bb), psi), F64_LIMIT)
    got = make_dirac_ndeg(u16, dataclasses.replace(ndp, epsilon=1e-30),
                          cg_).m(psi)
    for fl, sign in ((0, +1), (1, -1)):
        ds = make_dirac(u16, DiracParams(kind="twisted-mass",
                                         kappa=ndp.kappa, mu=ndp.mu,
                                         flavor=sign, use_kernels=True), cg_)
        _check(f"(b) 16³×32 ε → 0: flavour {sign:+d} vs Dirac",
               _rel(got[fl], ds.m(psi[fl])), F64_LIMIT)
    return err


def _inc_eigcg_isolated(n: int):
    """IncEigCG on the card where deflation can work: the JAX test's
    spectrum (``test_sequence_accelerates``: eight isolated low modes
    1e-3 · 2^k over a bulk in [0.5, 1]) as a diagonal operator of ``n``
    complex128 entries, four Gaussian right-hand sides at tol 1e-8; each
    solve certified, the space holds the eight modes, and the last solve
    takes under half the first's iterations, as in the JAX test."""
    import torch
    from quda_qkxtm_multigrid_tpu_torch.solvers import IncEigCG
    lows = 1e-3 * 2.0 ** torch.arange(8, dtype=torch.float64, device=DEVICE)
    w = torch.cat([lows, torch.linspace(0.5, 1.0, n - 8, dtype=torch.float64,
                                        device=DEVICE)])
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    inc = IncEigCG(lambda v: w * v, nev_per_solve=8, max_nev=24,
                   lanczos_tol=1e-4)
    iters, worst = [], 0.0
    t0 = time.perf_counter()
    for _ in range(4):
        b = torch.randn(n, generator=gen, dtype=torch.float64,
                        device=DEVICE).to(torch.complex128)
        res = inc.solve(b, tol=1e-8, maxiter=3000)
        worst = max(worst, float((b - w * res.x).norm() / b.norm()))
        iters.append(res.iters)
    torch.cuda.synchronize()
    print(f"  (c) IncEigCG on the JAX test's isolated spectrum, n = {n}: "
          f"{time.perf_counter() - t0:.3f} s, iterations {iters}, "
          f"n_deflated {inc.n_deflated}, harvests "
          + ", ".join(f"{h['restarts']} restarts / {h['matvecs']} matvecs "
                      f"kept {h['kept']}" for h in inc.harvests), flush=True)
    _check("(c) isolated spectrum: worst relative residual", worst, 1e-7)
    if not (inc.n_deflated >= 8 and iters[-1] < 0.5 * iters[0]):
        raise AssertionError(f"IncEigCG did not accelerate on isolated low "
                             f"modes: {iters}, n_deflated {inc.n_deflated}")


def _krylov_light(light_dims, launches: dict) -> float:
    """Phase 14 (c): the light-mass point (κ ``LIGHT_KAPPA``, μ
    ``LIGHT_MU``, c_sw 1.0) at ``light_dims`` in complex128 through K1
    f64: ``IncEigCG(8, 48)`` over the first ``LIGHT_INC_COLUMNS`` columns
    of a point source, each column's iterations, harvests and certificate
    (the plain Lanczos resolves none of this dense low spectrum, so the
    sequence does not speed up: ``_inc_eigcg_isolated`` checks the
    acceleration on the JAX test's spectrum instead); ``gmresdr`` on matpc with ``LIGHT_GMRESDR_CAP`` cycles
    against ``gcr`` at about the same matvecs; K1 f64 against plain on
    the operator's operands.  Returns K1's largest absolute error."""
    import torch
    from quda_qkxtm_multigrid_tpu_torch import fields
    from quda_qkxtm_multigrid_tpu_torch.benchmarks import make_gauge_source
    from quda_qkxtm_multigrid_tpu_torch.dirac import DiracParams, make_dirac
    from quda_qkxtm_multigrid_tpu_torch.invert import true_residual
    from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry
    from quda_qkxtm_multigrid_tpu_torch.ops.dslash_kernel import (
        dslash_ch, dslash_ch_reference, to_channels)
    from quda_qkxtm_multigrid_tpu_torch.solvers import IncEigCG, gcr, gmresdr

    c128, tol = torch.complex128, LIGHT_TOL
    lg = Geometry(*light_dims)
    ul, _ = make_gauge_source(lg, DEVICE, 7, c128)
    dl = make_dirac(ul, DiracParams(kind="twisted-clover", kappa=LIGHT_KAPPA,
                                    mu=LIGHT_MU, csw=1.0, use_kernels=True),
                    lg)
    del ul

    def column(col):
        s_, c_ = divmod(col, 3)
        return fields.point_source(lg, (0, 0, 0, 0), s_, c_, dtype=c128,
                                   device=DEVICE)
    inc = IncEigCG(dl.matpc_dagm, nev_per_solve=8, max_nev=48)
    iters = []
    t0 = time.perf_counter()
    for col in range(LIGHT_INC_COLUMNS):
        bc = column(col)
        rc = dl.matpc(dl.prepare(bc), dagger=True)
        n_h = len(inc.harvests)
        rr = _counted(lambda: inc.solve(rc, tol=tol, maxiter=LIGHT_MAXITER),
                      launches)
        cert = float(true_residual(dl, dl.reconstruct(rr["out"].x, bc),
                                   bc)[1])
        iters.append(rr["out"].iters)
        harv = "; ".join(f"harvest: {h['restarts']} restarts, "
                         f"{h['matvecs']} matvecs, {h['secs']:.2f} s, kept "
                         f"{h['kept']} of {h['found']}"
                         for h in inc.harvests[n_h:])
        _stamp(f"(c) IncEigCG column {col}", rr,
               f", iterations {rr['out'].iters}, c128 true_res {cert:.3e}, "
               f"n_deflated {inc.n_deflated}" + (f"; {harv}" if harv else ""))
        _check(f"(c) column {col}: true residual (complex128)", cert,
               TRUE_RES_LIMIT)
    kept = sum(h["kept"] for h in inc.harvests)
    print(f"  (c) IncEigCG {LIGHT_INC_COLUMNS} columns "
          f"{time.perf_counter() - t0:.3f} s, "
          f"iterations {iters} (last / first {iters[-1] / iters[0]:.3f}), "
          f"{len(inc.harvests)} harvests kept {kept} pairs, n_deflated "
          f"{inc.n_deflated}", flush=True)
    del inc
    gc.collect()
    _inc_eigcg_isolated(lg.half_volume * 12)

    bc = column(0)
    sl = dl.prepare(bc)
    rg = _counted(lambda: gmresdr(dl.matpc, sl, tol=tol, n_krylov=20,
                                  n_defl=8, max_restarts=LIGHT_GMRESDR_CAP),
                  launches)
    gm = rg["out"]
    gm_conv = float(gm.r2) <= tol * tol * float((sl.abs() ** 2).sum())
    gm_res = float(true_residual(dl, dl.reconstruct(gm.x, bc), bc)[1])
    n_gcr = -(-gm.iters // 20)
    rgc = _counted(lambda: gcr(dl.matpc, sl, tol=tol, n_krylov=20,
                               max_restarts=n_gcr), launches)
    gcr_res = float(true_residual(dl, dl.reconstruct(rgc["out"].x, bc),
                                  bc)[1])
    _stamp(f"(c) gmresdr(20, 8), at most {LIGHT_GMRESDR_CAP} cycles", rg,
           f", iterations {gm.iters}, converged {gm_conv}, c128 true_res "
           f"{gm_res:.3e}")
    _stamp(f"(c) gcr(20), {n_gcr} cycles", rgc,
           f", iterations {rgc['out'].iters}, c128 true_res {gcr_res:.3e}")
    if gm_conv:
        _check("(c) gmresdr: true residual (complex128)", gm_res,
               TRUE_RES_LIMIT)
    ops = dl._operands(torch.float64)
    v = to_channels(sl)
    err = 0.0
    for p in (0, 1):
        got = dslash_ch(ops["g"][p], v, p, lg, **dl._hop_kw())
        torch.cuda.synchronize()
        ref = dslash_ch_reference(ops["g"][p], v, p, lg, **dl._hop_kw())
        err = max(err, _compare(got, ref, f"(c) K1 f64 bare hop parity {p}",
                                F64_LIMIT))
    return err


def phase_krylov(geom_dims, check_dims, light_dims):
    """Phase 14: the rest of the Krylov solvers and the non-degenerate
    doublet, (a) ``_krylov_reference``, (b) ``_krylov_doublet``, (c)
    ``_krylov_light`` (module docstring).  Returns the K1 / K2 launches
    and the kernels' largest absolute errors."""
    import torch
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 14: the Krylov tail and the non-degenerate doublet; memory "
          f"in use at its start {torch.cuda.memory_allocated() / 2**30:.2f} "
          f"GiB", flush=True)
    launches = {"k1": 0, "k2": 0}
    gen = torch.Generator(device=DEVICE).manual_seed(14)
    err = dict(_krylov_reference(geom_dims, launches, gen))
    for part in (lambda: {"k2": _krylov_doublet(geom_dims, check_dims,
                                                launches, gen)},
                 lambda: {"k1": _krylov_light(light_dims, launches)}):
        gc.collect()
        torch.cuda.empty_cache()
        for k, v in part().items():
            err[k] = max(err[k], v)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  phase 14 {time.perf_counter() - t_phase:.1f} s; K1 launches "
          f"{launches['k1']}, K2 launches {launches['k2']}", flush=True)
    return {**launches, "err": err}


def _gauge_utilities(u, geom, gen) -> dict:
    """Phase 15 (a): the topological charge before and after a random
    gauge transformation; ``gauge_fix_ovr`` (Coulomb) and
    ``gauge_fix_fft`` (Landau and Coulomb): θ before and after, the
    plaquette unchanged, the seconds of each."""
    import torch
    from quda_qkxtm_multigrid_tpu_torch.ops import gauge as G
    from quda_qkxtm_multigrid_tpu_torch.utils import rng
    secs = {}
    t0 = time.perf_counter()
    q0 = float(G.topological_charge(u, geom))
    g = rng.random_su3(gen, (2,) + geom.lat_shape, u.dtype).movedim(
        (0, 1), (1, 2))
    q1 = float(G.topological_charge(G.gauge_transform(u, g, geom), geom))
    del g
    secs["charge"] = time.perf_counter() - t0
    print(f"  (a) topological charge {q0:.12e}, after a random gauge "
          f"transformation {q1:.12e} ({secs['charge']:.3f} s for both)",
          flush=True)
    _check("(a) charge: gauge invariance (relative)",
           abs(q1 - q0) / max(abs(q0), 1.0), CHARGE_LIMIT)
    p0 = float(G.plaquette(u, geom)[0])
    for label, fix, n, drop in (
            ("ovr, gauge_dir 3", lambda n: G.gauge_fix_ovr(
                u, geom, gauge_dir=3, n_iter=n), OVR_ITERS, OVR_DROP),
            ("fft, gauge_dir 4", lambda n: G.gauge_fix_fft(
                u, geom, gauge_dir=4, n_iter=n), FFT_ITERS, FFT_DROP),
            ("fft, gauge_dir 3", lambda n: G.gauge_fix_fft(
                u, geom, gauge_dir=3, n_iter=n), FFT_ITERS, FFT_DROP)):
        th0 = float(fix(0)[1])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        uf, th1 = fix(n)
        th1 = float(th1)
        secs[label] = time.perf_counter() - t0
        p1 = float(G.plaquette(uf, geom)[0])
        del uf
        print(f"  (a) gauge_fix_{label}: θ {th0:.6e} -> {th1:.6e} after {n} "
              f"iterations ({th1 / th0:.4f}), {secs[label]:.3f} s; "
              f"plaquette {p0:.15f} -> {p1:.15f}", flush=True)
        _check(f"(a) {label}: θ after / before", th1 / th0, drop)
        _check(f"(a) {label}: plaquette unchanged (relative)",
               abs(p1 - p0) / abs(p0), PLAQ_LIMIT)
    return secs


def _certified_solve(label: str, solve64, matvec_hi, inner, plain, b128,
                     launches: dict, inner_name: str = "K2") -> dict:
    """A phase-15 solve: ``solve64()`` (the complex64 CG to ``DW_TOL``
    through the kernels; returns (x, iterations)), certified by the plain
    complex128 operator ``plain``: |b − A x| / |b|.  Where that exceeds
    ``TRUE_RES_LIMIT`` the complex64 solution is refined by
    ``support.defect_correction`` (``matvec_hi`` the complex128 operator,
    ``inner(r, cap)`` the complex64 inner solve) and certified again."""
    import torch
    from quda_qkxtm_multigrid_tpu_torch.solvers.support import (
        defect_correction)
    r = _counted(solve64, launches)
    x, iters = r["out"]
    x = x.to(torch.complex128)
    bn = float(b128.norm())
    cert = float((b128 - plain(x)).norm()) / bn
    _stamp(f"{label}: complex64 CG (tol {DW_TOL:.0e})", r,
           f", iterations {iters} ({r['secs'] * 1e3 / max(iters, 1):.2f} "
           f"ms an iteration), c128 true_res (plain) {cert:.3e}")
    out = {"iters": iters, "secs": r["secs"], "k1": r["k1"], "k2": r["k2"],
           "true_res": cert, "route": "complex64 alone"}
    if cert > TRUE_RES_LIMIT:
        rhs = b128 - matvec_hi(x)
        tol = DW_TOL * bn / float(rhs.norm())
        rd = _counted(lambda: defect_correction(
            matvec_hi, inner, rhs, torch.complex64, tol, DW_MAXITER, 20, 1,
            10), launches)
        dx, _, it_dc, st = rd["out"]
        x = x + dx
        cert = float((b128 - plain(x)).norm()) / bn
        _stamp(f"{label}: + complex128 defect correction", rd,
               f", {st.restarts} restarts, inner iterations {it_dc} "
               f"({rd['secs'] * 1e3 / max(it_dc, 1):.2f} ms an inner "
               f"iteration with the outer's share), "
               f"diverged {st.diverged}, c128 true_res (plain) {cert:.3e}")
        out.update(iters=iters + it_dc, secs=out["secs"] + rd["secs"],
                   k1=out["k1"] + rd["k1"], k2=out["k2"] + rd["k2"],
                   true_res=cert, route="complex64, then complex128 "
                   f"defect correction around the {inner_name} inner solve")
    _check(f"{label}: true residual (complex128, plain)", cert,
           TRUE_RES_LIMIT)
    return out


def _dw_solves(u, geom, gen, launches: dict) -> dict:
    """Phase 15 (b), (c): the Shamir CG on dw4d_mat†dw4d_mat and the
    Möbius / zMöbius CGs on M_pc†M_pc, each in complex64 on channels
    through K2 at n = Ls, certified by the plain complex128 operators
    (``_certified_solve``).  Returns each solve's record and the
    complex64 source's channels for (e)."""
    import collections
    import numpy as np
    import torch
    from quda_qkxtm_multigrid_tpu_torch.ops import domain_wall as dw
    from quda_qkxtm_multigrid_tpu_torch.solvers.cg import cg
    from quda_qkxtm_multigrid_tpu_torch.utils import rng
    c64, c128 = torch.complex64, torch.complex128
    Res = collections.namedtuple("Res", "x iters")
    h32 = dw.Hop4D(u.to(c64), geom)
    h64 = dw.Hop4D(u, geom)                      # K1 f64 a slice
    hp = dw.Hop4D(u, geom, use_kernels=False)    # the plain certificate
    if not h32.hop_kw["recon12"] or not h32.hop_kw["antiperiodic"]:
        raise AssertionError(f"phase 15's gauge reads {h32.hop_kw}")
    ls = DW_LS
    rec = {}

    def to_ch_full(v):
        return torch.stack([dw.to_channels5(v[:, p]) for p in (0, 1)])

    def from_ch_full(v):
        return torch.stack([dw.from_channels5(o) for o in v], dim=1)

    # (b) Shamir, the full operator's normal equations
    k, mf = dw.kappa5(SHAMIR["m5"]), SHAMIR["mferm"]
    b = rng.normal_complex(gen, (ls, 2, 4, 3) + geom.lat_shape, c128)
    mat = lambda h, v, dg=False: dw.dw4d_mat(h, v, k, mf, geom, dg)  # noqa
    normal = lambda v: mat(h32, mat(h32, v), True)                   # noqa

    def inner(r, cap):
        rc = to_ch_full(r)
        o = cg(normal, mat(h32, rc, True), tol=DC_INNER_DW, maxiter=cap)
        return Res(from_ch_full(o.x), o.iters)

    def solve64():
        bc = to_ch_full(b.to(c64))
        o = cg(normal, mat(h32, bc, True), tol=DW_TOL, maxiter=DW_MAXITER)
        return from_ch_full(o.x), o.iters
    rec["shamir"] = _certified_solve(
        f"(b) Shamir Ls {ls}, M5 {SHAMIR['m5']}, mferm {mf}", solve64,
        lambda v: mat(h64, v), inner, lambda v: mat(hp, v), b, launches)
    src = dw.to_channels5(b[:, 1].to(c64))
    del b

    # (c) Möbius and zMöbius, M_pc on parity 0
    m5, mf = MOBIUS["m5"], MOBIUS["mferm"]
    for name, b5, c5 in (
            ("Möbius", MOBIUS["b5"], MOBIUS["c5"]),
            ("zMöbius", np.linspace(*ZMOBIUS_B5, ls),
             np.linspace(*ZMOBIUS_C5, ls))):
        bp = rng.normal_complex(gen, (ls, 4, 3) + geom.lat_shape, c128)
        mpc = lambda h, v, dg=False: dw.mdw_matpc(  # noqa: E731
            h, v, m5, mf, b5, c5, geom, 0, dg)
        normal_m = lambda v: mpc(h32, mpc(h32, v), True)  # noqa: E731

        def inner_m(r, cap):
            o = cg(normal_m, mpc(h32, dw.to_channels5(r), True),
                   tol=DC_INNER_DW, maxiter=cap)
            return Res(dw.from_channels5(o.x), o.iters)

        def solve64_m():
            bc = dw.to_channels5(bp.to(c64))
            o = cg(normal_m, mpc(h32, bc, True), tol=DW_TOL,
                   maxiter=DW_MAXITER)
            return dw.from_channels5(o.x), o.iters
        rec[name] = _certified_solve(
            f"(c) {name} Ls {ls}, M5 {m5}, mferm {mf}", solve64_m,
            lambda v: mpc(h64, v), inner_m, lambda v: mpc(hp, v), bp,
            launches)
        del bp
    return rec, src, h32, h64


def _staggered_solve(u0, geom, gen, launches: dict) -> dict:
    """Phase 15 (d): asqtad links from the thin periodic links, the η
    phases (antiperiodic in t) folded in, then CG on ``staggered_matpc``
    at ``STAG_MASS`` in complex64, certified in complex128."""
    import collections
    import torch
    from quda_qkxtm_multigrid_tpu_torch.ops import staggered as st
    from quda_qkxtm_multigrid_tpu_torch.solvers.cg import cg
    from quda_qkxtm_multigrid_tpu_torch.utils import rng
    c64, c128 = torch.complex64, torch.complex128
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fat, lng = st.asqtad_links(u0, geom)
    fat = st.apply_staggered_phases(fat, geom)
    lng = st.apply_staggered_phases(lng, geom)
    torch.cuda.synchronize()
    t_links = time.perf_counter() - t0
    print(f"  (d) asqtad fat + Naik links (complex128): {t_links:.3f} s",
          flush=True)
    f32, l32 = fat.to(c64), lng.to(c64)
    b = rng.normal_complex(gen, (3,) + geom.lat_shape, c128)
    mv = lambda f, ll, v: st.staggered_matpc(f, v, STAG_MASS, geom,  # noqa
                                             ll)
    Res = collections.namedtuple("Res", "x iters")

    def solve64():
        o = cg(lambda v: mv(f32, l32, v), b.to(c64), tol=DW_TOL,
               maxiter=DW_MAXITER)
        return o.x, o.iters

    def inner(r, cap):
        o = cg(lambda v: mv(f32, l32, v), r, tol=DC_INNER_DW, maxiter=cap)
        return Res(o.x, o.iters)
    out = _certified_solve(f"(d) asqtad staggered matpc, mass {STAG_MASS}",
                           solve64, lambda v: mv(fat, lng, v), inner,
                           lambda v: mv(fat, lng, v), b, launches,
                           "plain complex64")
    out["link_secs"] = t_links
    return out


def _k2_ls_checks(h32, h_periodic, h64, src, geom) -> dict:
    """Phase 15 (e): K2 at n = Ls on the source's channels against its
    plain version, both directions, on the antiperiodic and the periodic
    links; K1 f64 (the complex128 outer's hop) against plain on one
    slice; K2 at n = Ls timed against plain with its byte bound."""
    import torch
    from quda_qkxtm_multigrid_tpu_torch.ops.dslash_kernel import (
        dslash_ch, dslash_ch_msrc, dslash_ch_msrc_reference,
        dslash_ch_reference)
    err = {"k1": 0.0, "k2": 0.0}
    for name, h in (("antiperiodic", h32), ("periodic", h_periodic)):
        kw = h.hop_kw
        for p, dag in ((0, False), (1, True)):
            g = h.gauge_ch(torch.float32, p)
            got = dslash_ch_msrc(g, src, p, geom, dag, **kw)
            torch.cuda.synchronize()
            ref = dslash_ch_msrc_reference(g, src, p, geom, dag, **kw)
            err["k2"] = max(err["k2"], _compare(
                got, ref, f"(e) K2 n={src.shape[0]} {name} parity {p} "
                f"dagger {dag}", F32_LIMIT))
            del got, ref
    v = src[0].to(torch.float64)
    for p, dag in ((0, False), (1, True)):
        g = h64.gauge_ch(torch.float64, p)
        got = dslash_ch(g, v, p, geom, dag, **h64.hop_kw)
        torch.cuda.synchronize()
        ref = dslash_ch_reference(g, v, p, geom, dag, **h64.hop_kw)
        err["k1"] = max(err["k1"], _compare(
            got, ref, f"(e) K1 f64 antiperiodic parity {p} dagger {dag}",
            F64_LIMIT))
    g = h32.gauge_ch(torch.float32, 0)
    kw = h32.hop_kw
    med = _turns({"kernel": lambda: dslash_ch_msrc(g, src, 0, geom, **kw),
                  "plain": lambda: dslash_ch_msrc_reference(g, src, 0, geom,
                                                            **kw)},
                 {"kernel": 10, "plain": 1})
    n = src.shape[0]
    bound = _bound(_nbytes(g, src, src), n * HOP_FLOPS * geom.half_volume)
    print(f"  (e) K2 n={n} bare hop, antiperiodic: {med['kernel']:.4f} ms "
          f"({med['kernel'] / n:.4f} ms a slice; bound {bound[0]:.4f} ms, "
          f"{bound[1]}; at {bound[0] / med['kernel']:.2f} of it), plain "
          f"{med['plain']:.4f} ms", flush=True)
    return {"err": err, "ms": med["kernel"], "plain_ms": med["plain"],
            "bound": bound}


def phase_dw_staggered(geom_dims):
    """Phase 15: the gauge utilities, the domain-wall / Möbius and the
    staggered solves at ``geom_dims`` on a random gauge of seed
    ``P15_SEED`` with the antiperiodic t boundary (module docstring).
    Returns the K1 / K2 launches and the kernels' largest errors."""
    import torch
    from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry
    from quda_qkxtm_multigrid_tpu_torch.ops import domain_wall as dw
    from quda_qkxtm_multigrid_tpu_torch.ops.gauge import apply_t_boundary
    from quda_qkxtm_multigrid_tpu_torch.utils import rng
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    geom = Geometry(*geom_dims)
    print(f"phase 15: gauge utilities, domain-wall / Möbius and staggered "
          f"at {geom.dims}; memory in use at its start "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    gen = torch.Generator(device=DEVICE).manual_seed(P15_SEED)
    u0 = rng.random_gauge(gen, geom, torch.complex128)
    u = apply_t_boundary(u0, geom)
    launches = {"k1": 0, "k2": 0}
    secs = _gauge_utilities(u, geom, gen)
    torch.cuda.reset_peak_memory_stats()
    rec, src, h32, h64 = _dw_solves(u, geom, gen, launches)
    rec["staggered"] = _staggered_solve(u0, geom, gen, launches)
    del u
    gc.collect()
    h_periodic = dw.Hop4D(u0.to(torch.complex64), geom)
    k2 = _k2_ls_checks(h32, h_periodic, h64, src, geom)
    del h_periodic, h32, h64, src
    print(f"  solves: " + "; ".join(
        f"{k} {v['iters']} iterations, {v['secs']:.3f} s, K1 {v['k1']}, K2 "
        f"{v['k2']}, {v['true_res']:.3e} ({v['route']})"
        for k, v in rec.items()) + f"; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    print(f"  phase 15 {time.perf_counter() - t_phase:.1f} s; K1 launches "
          f"{launches['k1']}, K2 launches {launches['k2']}", flush=True)
    del u0
    gc.collect()
    torch.cuda.empty_cache()
    return {**launches, "err": k2["err"], "k2_time": k2, "secs": secs,
            "solves": rec}


def _counts_zero():
    """Set the K1, K2, K4 and K5 launch counts to 0 (K4's with the second
    output too)."""
    from quda_qkxtm_multigrid_tpu_torch.ops.dslash_kernel import (
        dslash_ch, dslash_ch_local, dslash_ch_msrc, dslash_ch_overlap)
    for fn in (dslash_ch, dslash_ch_msrc, dslash_ch_local,
               dslash_ch_overlap):
        fn.launches = 0
    dslash_ch_local.launches_post = 0


def _counts() -> dict:
    """The K1, K2, K4 and K5 launch counts; "k4_post": K4's launches with
    the second output (counted in "k4" too)."""
    from quda_qkxtm_multigrid_tpu_torch.ops.dslash_kernel import (
        dslash_ch, dslash_ch_local, dslash_ch_msrc, dslash_ch_overlap)
    return {"k1": dslash_ch.launches, "k2": dslash_ch_msrc.launches,
            "k4": dslash_ch_local.launches, "k5": dslash_ch_overlap.launches,
            "k4_post": dslash_ch_local.launches_post}


def _mesh_mg(mesh, geom, dtype, solvers, tol, launches: dict,
             setup: bool = False) -> dict:
    """16a at ``geom``: ``bench_mg``'s setup (on the whole lattice) and
    its unsharded solve with each of ``solvers``, then ``shard_mg`` and
    ``bench_mg_mesh`` on ``mesh``: the outer iterations equal, the
    solution within ``MESH_X_LIMIT`` of the unsharded, the complex128
    certificate, K4 launched, one all-gather a V-cycle.  Returns the
    sharded records by solver, with the V-cycle ms sharded and unsharded
    of the first solver; with ``setup``, also 16e on this setup
    (``_mesh_setup``) under "setup"."""
    import functools

    import torch
    from quda_qkxtm_multigrid_tpu_torch.benchmarks import (
        bench_mg, bench_mg_mesh, make_problem)
    from quda_qkxtm_multigrid_tpu_torch.mg.multigrid import (
        mg_solve, shard_mg)
    from quda_qkxtm_multigrid_tpu_torch.parallel.mesh import shard_spinor

    gc.collect()
    torch.cuda.empty_cache()
    d, b = make_problem(geom, DEVICE, seed=7, dtype=dtype)
    rec, mg = bench_mg(geom, tol=tol, nvec=MG_NVEC, block=MG_BLOCK,
                       n_krylov=MG_NKRYLOV, problem=(d, b),
                       solver=solvers[0])
    print(f"  {geom.dims} {str(dtype)[6:]}: setup {rec['setup_secs']:.3f} s "
          f"(whole lattice), unsharded warm solve {rec['secs']:.4f} s",
          flush=True)
    out = {}
    for solver in solvers:
        ref = mg_solve(mg, b, tol=tol, n_krylov=MG_NKRYLOV, solver=solver)
        _counts_zero()
        r, x = bench_mg_mesh(mesh, (d, b), mg, tol=tol, solver=solver,
                             n_krylov=MG_NKRYLOV)
        c = _counts()
        for k in ("k1", "k4", "k5", "k4_post"):
            launches[k] += c[k]
        r["x_rel"] = _rel(x, shard_spinor(ref.x, mesh))
        print(f"  {solver}: sharded iterations {r['iters']} (cold "
              f"{r['iters_cold']}; unsharded {ref.iters}), warm "
              f"{r['secs']:.4f} s, true_res {r['true_res']:.3e} "
              f"(complex128), solution vs unsharded {r['x_rel']:.3e}, "
              f"V-cycles {r['vcycles']}, all-gathers {r['allgathers']}, "
              f"warm K4 {r['k4_launches']}; launches {c}", flush=True)
        if r["iters"] != ref.iters or r["iters_cold"] != ref.iters:
            raise AssertionError(f"sharded {solver} iterations "
                                 f"{r['iters']} != unsharded {ref.iters}")
        _check(f"sharded MG {solver}: solution vs unsharded", r["x_rel"],
               MESH_X_LIMIT)
        _check(f"sharded MG {solver}: true residual (c128)", r["true_res"],
               TRUE_RES_LIMIT)
        if not r["k4_launches"] or r["allgathers"] != r["vcycles"]:
            raise AssertionError(f"sharded MG {solver}: K4 launches "
                                 f"{r['k4_launches']}, all-gathers "
                                 f"{r['allgathers']} vs V-cycles "
                                 f"{r['vcycles']}")
        out[solver] = r
        del x, ref
    ms = shard_mg(mg, mesh)
    bs = shard_spinor(b, mesh)
    vms = {"unsharded": _vcycle_ms(mg.vcycle, b),
           "sharded": _vcycle_ms(
               functools.partial(ms.vcycle, mesh=mesh), bs)}
    print(f"  V-cycle {vms['sharded']:.2f} ms sharded (the K4 fused chain "
          f"smoother, one all-gather) against {vms['unsharded']:.2f} ms "
          f"unsharded (K1 fused chain); PR 13 call 1: "
          f"{MESH_PARENT['vcycle_ms']} ms sharded with the unfused "
          f"smoother (PR 14 recorded none)", flush=True)
    out[solvers[0]]["vcycle_ms"] = vms
    del ms, bs
    if setup:
        out["setup"] = _mesh_setup(mesh, geom, d, b, mg, rec, launches)
    del mg, d, b
    return out


def _mesh_setup(mesh, geom, d, b, mg, rec: dict, launches: dict) -> dict:
    """16e: ``setup_mg`` on this rank's operator built from its slab of
    ``d``'s gauge (``make_sharded_dirac``), with the parameters and the
    generator seed of ``bench_mg``'s setup ``mg`` (phase 6's): its
    seconds and split against the whole lattice's (``rec``), V and the
    coarse X / Y within ``SETUP_VS_WHOLE`` of ``mg``'s, then a cold and
    a warm ``mg_solve(mesh=…)`` in ``rec``'s outer iterations, the warm
    one certified in complex128; no K1 or K2 launch.  Returns the
    record."""
    import torch
    from quda_qkxtm_multigrid_tpu_torch.benchmarks import c128_true_res
    from quda_qkxtm_multigrid_tpu_torch.mg.multigrid import (
        mg_solve, setup_mg)
    from quda_qkxtm_multigrid_tpu_torch.parallel.mesh import (
        shard_spinor, t_slab)
    from quda_qkxtm_multigrid_tpu_torch.parallel.sharded import (
        make_sharded_dirac)

    print("  (e) MG set up on the slab (make_sharded_dirac, setup_mg on a "
          "ShardedDirac)", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    _counts_zero()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ds = make_sharded_dirac(t_slab(d.u, mesh), d.params, geom, mesh)
    torch.cuda.synchronize()
    t_op = time.perf_counter() - t0
    gen = torch.Generator(device=DEVICE).manual_seed(3)    # bench_mg's
    t0 = time.perf_counter()
    ms = setup_mg(ds, mg.params, gen)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    st = ms.setup_stats
    print(f"  operator on the slab {t_op:.3f} s; setup {secs:.3f} s against "
          f"{rec['setup_secs']:.3f} s on the whole lattice (phase 6's "
          f"record: 3.93 s): null vectors {st['null_vector_secs']:.3f} s "
          f"(against {rec['null_vector_secs']:.3f}; a sharded CG a column, "
          f"iterations {st['cg_iters']}, worst true_res "
          f"{st['null_true_res']:.3e}; whole lattice: multi-source batches "
          f"{rec['msrc_iters']}), orthonormalisation {st['ortho_secs']:.3f} "
          f"s ({rec['ortho_secs']:.3f}), coarse build "
          f"{st['coarse_build_secs']:.3f} s ({rec['coarse_build_secs']:.3f})",
          flush=True)
    err = {"v": _rel(ms.transfer.v, mg.transfer.t_slab(mesh).v),
           "x": _rel(ms.coarse.x, mg.coarse.x),
           "y": _rel(ms.coarse.y, mg.coarse.y)}
    for k, e in err.items():
        _check(f"sharded setup {k.upper()} vs the whole lattice's", e,
               SETUP_VS_WHOLE)
    bs = shard_spinor(b, mesh)
    cold = mg_solve(ms, bs, tol=MG_TOL, n_krylov=MG_NKRYLOV, mesh=mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm = mg_solve(ms, bs, tol=MG_TOL, n_krylov=MG_NKRYLOV, mesh=mesh)
    torch.cuda.synchronize()
    t_solve = time.perf_counter() - t0
    c = _counts()
    for k in ("k1", "k4", "k5", "k4_post"):
        launches[k] += c[k]
    tr = c128_true_res(d, mesh.allgather_t(warm.x), b)
    print(f"  mg_solve(mesh=…) on it: {warm.iters} outer iterations (cold "
          f"{cold.iters}; whole-lattice setup {rec['iters']}), warm "
          f"{t_solve:.4f} s, true_res {tr:.3e} (complex128); launches {c}",
          flush=True)
    if warm.iters != rec["iters"] or cold.iters != rec["iters"]:
        raise AssertionError(f"sharded setup: {warm.iters} / {cold.iters} "
                             f"outer iterations, whole lattice "
                             f"{rec['iters']}")
    _check("sharded setup's solve: true residual (c128)", tr,
           TRUE_RES_LIMIT)
    if not c["k4"] or c["k1"] or c["k2"]:
        raise AssertionError(f"sharded setup: launches {c}")
    out = {"secs": secs, "whole_secs": rec["setup_secs"], "err": err,
           "iters": warm.iters, "solve_secs": t_solve, "true_res": tr,
           "split": {k: st[k] for k in ("null_vector_secs", "ortho_secs",
                                        "coarse_build_secs")}, **c}
    del ms, ds, bs, cold, warm
    return out


def _mesh_schwarz(mesh, geom, launches: dict) -> dict:
    """16b: GCR(10) on the sharded twisted-mass operator (κ 0.12, μ
    0.04, complex128, the antiperiodic gauge of seed ``P16_SEED``) to
    tol 1e-8: plain, with additive and with multiplicative Schwarz (4 MR
    steps of the block, K1 f64 on the local geometry); each certified by
    the plain complex128 operator, each preconditioned one in fewer
    iterations than plain GCR; then the block's K1 and the sharded
    operator's K4 float64 hops against plain on the same links."""
    import torch
    from quda_qkxtm_multigrid_tpu_torch.benchmarks import make_gauge_source
    from quda_qkxtm_multigrid_tpu_torch.dirac import DiracParams, make_dirac
    from quda_qkxtm_multigrid_tpu_torch.invert import true_residual
    from quda_qkxtm_multigrid_tpu_torch.ops.gauge import apply_t_boundary
    from quda_qkxtm_multigrid_tpu_torch.parallel.mesh import (
        shard_spinor)
    from quda_qkxtm_multigrid_tpu_torch.parallel.schwarz import (
        schwarz_precond, schwarz_precond_multiplicative)
    from quda_qkxtm_multigrid_tpu_torch.parallel.sharded import (
        local_block, shard_dirac)
    from quda_qkxtm_multigrid_tpu_torch.solvers.gcr import gcr
    from quda_qkxtm_multigrid_tpu_torch.utils import rng

    c128 = torch.complex128
    u, _ = make_gauge_source(geom, DEVICE, seed=P16_SEED, dtype=c128)
    u = apply_t_boundary(u, geom)
    gen = torch.Generator(device=DEVICE).manual_seed(P16_SEED)
    b = rng.random_spinor(gen, geom, c128)
    params = DiracParams(**SCHWARZ, use_kernels=True)
    ds = shard_dirac(make_dirac(u, params, geom), mesh)
    plain = make_dirac(u, dataclasses.replace(params, use_kernels=False),
                       geom)
    bs = shard_spinor(b, mesh)
    pcs = {"plain": None, "additive": schwarz_precond(ds, mesh, niter=4),
           "multiplicative": schwarz_precond_multiplicative(ds, mesh,
                                                            niter=4)}
    out = {}
    for name, pc in pcs.items():
        _counts_zero()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = gcr(ds.m, bs, tol=SCHWARZ_TOL, n_krylov=10, max_restarts=40,
                  precond=pc, allreduce=mesh.allreduce)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        c = _counts()
        for k in ("k1", "k4"):
            launches[k] += c[k]
        tr = float(true_residual(plain, mesh.allgather_t(res.x), b)[1])
        out[name] = {"iters": res.iters, "secs": secs, "true_res": tr, **c}
        print(f"  GCR(10) {name}: {res.iters} iterations, {secs:.3f} s, "
              f"true_res {tr:.3e} (plain complex128), launches K1 "
              f"{c['k1']} K4 {c['k4']}", flush=True)
        _check(f"Schwarz {name}: true residual (c128)", tr, TRUE_RES_LIMIT)
        if pc is not None and not (res.iters < out["plain"]["iters"]
                                   and c["k1"] > 0):
            raise AssertionError(f"Schwarz {name}: {res.iters} iterations "
                                 f"(plain {out['plain']['iters']}), K1 "
                                 f"launches {c['k1']}")
    block = local_block(ds)
    plain_block = make_dirac(ds.u, dataclasses.replace(
        params, use_kernels=False), ds.geom)
    psi = rng.random_spinor(gen, ds.geom, c128)
    err = {"k1": 0.0, "k4": 0.0}
    for p in (0, 1):
        for dagger in (False, True):
            ref = plain_block.dslash(psi[1 - p], p, dagger)
            err["k1"] = max(err["k1"], _compare(
                block.dslash(psi[1 - p], p, dagger), ref,
                f"block K1 f64 hop p{p} d{int(dagger)} vs plain",
                F64_LIMIT))
            ref = plain.dslash(b[1 - p], p, dagger)
            err["k4"] = max(err["k4"], _compare(
                ds.dslash(bs[1 - p], p, dagger), shard_spinor(ref, mesh),
                f"sharded K4 f64 hop p{p} d{int(dagger)} vs plain",
                F64_LIMIT))
    out["err"] = err
    return out


def _mesh_workflows(mesh, u, geom, refs: dict, launches: dict) -> dict:
    """16c: ``run_twop``, ``run_threep`` and ``run_loops`` with ``mesh``
    on phases 11–12's gauge and settings: each column certified by the
    plain complex128 operator, the results against phases 11–12's
    (``refs``), each run's launches and stage seconds; K4 / K5 against
    plain on the path's sharded operator.  Returns the errors and the
    seconds."""
    import torch
    from quda_qkxtm_multigrid_tpu_torch import workflows as wf
    from quda_qkxtm_multigrid_tpu_torch.benchmarks import tmc_params

    p = tmc_params()
    phys = dict(kappa=p.kappa, mu=p.mu, csw=p.csw)
    out = {"secs": {}, "peak_gib": {}}

    def run(label, fn):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated() / 2**30
        _counts_zero()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        c = _counts()
        for k in ("k1", "k4", "k5", "k4_post"):
            launches[k] += c[k]
        out["secs"][label] = secs
        peak = torch.cuda.max_memory_allocated() / 2**30
        out["peak_gib"][label] = peak
        print(f"  {label} (mesh): {secs:.3f} s, launches {c}, peak memory "
              f"{peak:.2f} GiB, {start:.2f} GiB of it in use at its start "
              f"(phase 11's 2pt: {TWOP_PEAK_GIB} GiB)", flush=True)
        if not c["k4"] or c["k1"] or c["k2"]:
            raise AssertionError(f"{label} on the mesh: launches {c}")
        return res

    def certify(label, flavor, st):
        xs = mesh.allgather_t(st["x"])
        bs = mesh.allgather_t(st["sources"])
        res = _certify(u, flavor, geom, bs, xs)
        _check(f"{label}: worst column (complex128)", max(res),
               TRUE_RES_LIMIT)

    st = {}
    twop = run("run_twop", lambda: wf.run_twop(
        u, geom, source=TWOP_SOURCE, tol=TWOP_TOL, maxiter=SLICE_MAXITER,
        mesh=mesh, stats=st, **phys))
    print("  stages (s): " + ", ".join(f"{k} {v:.3f}"
                                       for k, v in st["secs"].items()),
          flush=True)
    for flavor, name in ((+1, "up"), (-1, "dn")):
        certify(f"2pt {name}", flavor, dict(st[name], sources=st["sources"]))
    for key in ("mesons", "baryons"):
        _check(f"2pt {key} vs phase 11", _rel64(twop[key], refs[key]),
               MESH_X_LIMIT)
    del st, twop
    # the 3pt on phase 12's inputs (phase 11's propagators): a propagator
    # far from its source is resolved only to tol relative to its
    # largest entries, so the 2pt's propagators above would move it more
    inp = {k: v.to(DEVICE) for k, v in refs["threep_in"].items()}
    st = {}
    thrp = run("run_threep", lambda: wf.run_threep(
        u, geom, tsink=THREEP_TSINK, source=TWOP_SOURCE,
        projectors=(THREEP_PROJ,), tol=TWOP_TOL, maxiter=SLICE_MAXITER,
        mesh=mesh, stats=st, **inp, **phys))
    print("  stages (s): " + ", ".join(f"{k} {v:.3f}"
                                       for k, v in st["secs"].items()),
          flush=True)
    for part in (1, 2):
        pt = st[(THREEP_PROJ, part)]
        certify(f"3pt part{part}", pt["flavor"], pt)
    for part, types_ in thrp["thrp"][THREEP_PROJ].items():
        for t, v in types_.items():
            _check(f"3pt {part} {t} vs phase 12",
                   _rel64(v, refs["thrp"][part][t]), MESH_X_LIMIT)
    del st, thrp, inp
    ds = wf.make_operator(u, tmc_params(), geom, mesh=mesh)
    out["err"] = _main_path_local_checks(
        ds, mesh, torch.Generator(device=DEVICE).manual_seed(16))
    del ds
    st = {}
    loops = run("run_loops", lambda: wf.run_loops(
        u, geom, n_stoch=LOOPS_NSTOCH,
        gen=torch.Generator(DEVICE).manual_seed(7), tol=TWOP_TOL,
        tol_lp=LOOPS_TOL_LP, n_hp=LOOPS_NHP, maxiter=SLICE_MAXITER,
        mesh=mesh, stats=st, **phys))
    print("  stages (s): " + ", ".join(f"{k} {v:.3f}"
                                       for k, v in st["secs"].items()),
          flush=True)
    res = _certify(u, +1, geom, [mesh.allgather_t(h[0]) for h in st["hp"]],
                   [mesh.allgather_t(h[1]) for h in st["hp"]])
    _check("loops: worst HP solve (complex128)", max(res), TRUE_RES_LIMIT)
    for k, v in loops.items():
        _check(f"loops {k} vs phase 12", _rel64(v.cpu(), refs["loops"][k]),
               MESH_X_LIMIT)
    return out


def _mesh_wexact(mesh, u, geom, refs: dict, launches: dict) -> dict:
    """16d: ``run_loops_wexact(mesh=…)`` in complex128 with phase 12d's
    ``WEXACT`` settings and generator seed on phase 11's gauge: the
    eigenvalues within ``WEXACT_EVALS_LIMIT`` of phase 12d's, the worst
    Ritz residual within ``RITZ_LIMIT``, every loop type within
    ``MESH_X_LIMIT`` of phase 12d's, K4 (float64) launched and no K1 or
    K2; then the K4 float64 hop on the path's operands (the slab's
    float64 gauge channels and a mode) against its plain version, both
    parities and daggers, and timed against it in turns with its byte
    bound.  Returns the record."""
    import torch
    from quda_qkxtm_multigrid_tpu_torch import workflows as wf
    from quda_qkxtm_multigrid_tpu_torch.benchmarks import tmc_params
    from quda_qkxtm_multigrid_tpu_torch.ops.dslash_kernel import (
        dslash_ch_local, dslash_ch_local_reference, to_channels)
    from quda_qkxtm_multigrid_tpu_torch.parallel.halo import t_faces

    p = tmc_params()
    phys = dict(kappa=p.kappa, mu=p.mu, csw=p.csw)
    u128 = u.to(torch.complex128)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated() / 2**30
    _counts_zero()
    st = {}
    t0 = time.perf_counter()
    wex, eig = wf.run_loops_wexact(
        u128, geom, gen=torch.Generator(DEVICE).manual_seed(8),
        maxiter=SLICE_MAXITER, mesh=mesh, stats=st, **WEXACT, **phys)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    c = _counts()
    for k in ("k1", "k4", "k5", "k4_post"):
        launches[k] += c[k]
    peak = torch.cuda.max_memory_allocated() / 2**30
    es = st["eig"]
    print(f"  run_loops_wexact (mesh, complex128): {secs:.3f} s (PR 13 "
          f"call 1: {MESH_PARENT['wexact_s']} s with the unfused complex128 "
          f"operator; PR 14 recorded none), launches "
          f"{c} (every K4 a float64 hop), peak memory {peak:.2f} GiB "
          f"({start:.2f} GiB in use at its start); "
          f"Lanczos: Chebyshev degree {WEXACT['cheb_degree']} on "
          f"[{es['bounds'][0]:.6f}, {es['bounds'][1]:.6f}], "
          f"{es['restarts']} restarts, {es['matvecs']} matvecs, "
          f"{es['secs']:.3f} s; stages (s): " + ", ".join(
              f"{k} {v:.3f}" for k, v in st["secs"].items()), flush=True)
    print("  eigenvalues " + " ".join(f"{float(v):.8f}" for v in eig.evals)
          + f"; deflated CG iterations {st['cg_iters']}", flush=True)
    if not c["k4"] or c["k1"] or c["k2"]:
        raise AssertionError(f"run_loops_wexact on the mesh: launches {c}")
    ref = refs["wexact"]
    got = eig.evals.cpu()
    _check("16d eigenvalues vs phase 12d (relative, worst)",
           float(((got - ref["evals"]).abs() / ref["evals"].abs()).max()),
           WEXACT_EVALS_LIMIT)
    _check("16d Lanczos: worst Ritz residual (complex128)",
           float(eig.resid.max()), RITZ_LIMIT)
    for k, v in wex.items():
        _check(f"16d loops {k} vs phase 12d", _rel64(v.cpu(), ref["loops"][k]),
               MESH_X_LIMIT)
    # the K4 float64 hop on the path's operands
    ds = wf.make_operator(u128, tmc_params(), geom, mesh=mesh)
    tb = ds._hop_kw()["t_boundary"]
    g64 = ds._operands(torch.float64, exact=True)["g"]
    v = to_channels(eig.evecs[0])
    f24 = t_faces(v, mesh)
    err = 0.0
    for par in (0, 1):
        for dagger in (False, True):
            err = max(err, _compare(
                dslash_ch_local(g64[par], v, *f24, par, ds.geom, dagger,
                                recon12=True, t_boundary=tb),
                dslash_ch_local_reference(g64[par], v, *f24, par, ds.geom,
                                          dagger, recon12=True,
                                          t_boundary=tb),
                f"16d K4 f64 hop parity {par} dagger {int(dagger)}",
                F64_LIMIT))
    pr = ds.params.matpc_parity
    kw = dict(recon12=True, t_boundary=tb)
    ms, plain_ms = _compare_timed(
        lambda: dslash_ch_local(g64[pr], v, *f24, pr, ds.geom, **kw),
        lambda: dslash_ch_local_reference(g64[pr], v, *f24, pr, ds.geom,
                                          **kw))
    bound = _bound(_nbytes(g64[pr], v, *f24, v),
                   HOP_FLOPS * ds.geom.half_volume)
    print(f"  K4 f64 bare hop at T_loc {ds.geom.T}: {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}; float64 "
          f"operations over the float32 peak, which bytes exceed), kernel "
          f"at {bound[0] / ms:.2f} of it; launches in the run {c['k4']}",
          flush=True)
    del wex, eig, ds, g64, v, f24, u128
    return {"secs": secs, "stages": st["secs"], "peak_gib": peak,
            "k4_f64": {"ms": ms, "plain_ms": plain_ms, "bound": bound,
                       "launches": c["k4"]}, "err": {"k4": err}, **c}


def phase_mesh_rest(twop_refs: dict, u, geom_dims, check_dims):
    """Phase 16: the rest of the multi-GPU path on a ring of one rank
    over NCCL (its own process group, destroyed at the end): (a) the
    sharded MG-GCR-PC at ``geom_dims`` on phase 6's problem and setup,
    then (e) the MG set up on the slab against it, "gcr" and
    "mr-richardson" at ``check_dims`` in complex128; (b) the
    Schwarz-preconditioned GCR at ``check_dims``; (c) the meshed 2pt, 3pt
    and loops at ``geom_dims`` against phases 11–12; (d) the meshed
    deflated loops against phase 12d.  Returns the records, the K1 / K4
    / K5 launches of the phase and the kernels' largest errors against
    their plain versions."""
    import os
    import socket

    import torch
    import torch.distributed as dist
    from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry
    from quda_qkxtm_multigrid_tpu_torch.parallel.mesh import init_ring

    t_phase = time.perf_counter()
    geom, check = Geometry(*geom_dims), Geometry(*check_dims)
    print(f"phase 16: sharded MG, Schwarz and the meshed workflows on a "
          f"ring of one rank over NCCL", flush=True)
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    mesh = init_ring(1, 0, f"tcp://localhost:{port}", device=DEVICE)
    launches = {"k1": 0, "k4": 0, "k5": 0, "k4_post": 0}
    try:
        print("  (a) sharded MG", flush=True)
        mg = _mesh_mg(mesh, geom, torch.complex64, ("gcr-pc",), MG_TOL,
                      launches, setup=True)
        mg.update(_mesh_mg(mesh, check, torch.complex128,
                           ("gcr", "mr-richardson"), MG_TOL, launches))
        print("  (b) Schwarz-preconditioned GCR", flush=True)
        sz = _mesh_schwarz(mesh, check, launches)
        print("  (c) the meshed workflows", flush=True)
        wfs = _mesh_workflows(mesh, u, geom, twop_refs, launches)
        print("  (d) the meshed deflated loops", flush=True)
        wx = _mesh_wexact(mesh, u, geom, twop_refs, launches)
    finally:
        dist.destroy_process_group()
    secs = time.perf_counter() - t_phase
    print(f"  phase 16 {secs:.1f} s; launches {launches}", flush=True)
    err = {"k1": sz["err"]["k1"],
           "k4": max(sz["err"]["k4"], wfs["err"]["k4"], wx["err"]["k4"]),
           "k5": wfs["err"]["k5"]}
    return {"mg": mg, "schwarz": sz, "workflows": wfs, "wexact": wx,
            "secs": secs, "err": err, **launches}


# ---- phase 17: the z / w splits ------------------------------------------

def _box_of(grid):
    """The coordinates of the rank whose box 17a checks: 1 on every split
    axis (its neighbours on both sides are other ranks)."""
    return tuple(1 if n > 1 else 0 for n in grid)


def _box_cases(twist_a: float, twist_b: float, xc: float):
    """17a's forms of K4 on a box: those of the t-local hop
    (``_local_cases``), the second output in float32, the bf16 operand
    tier and float64, and the sharded chain's forms in float64 (the
    complex128 operator's)."""
    posts = _msrc_post_cases(twist_a, twist_b, xc)
    return (_local_cases(twist_a, twist_b, xc)
            + [(f"{tier} {label}", c, tier) for tier in ("f32", "bf16", "f64")
               for label, c in posts]
            + [(f"f64 {label}", c, "f64")
               for label, c in _msrc_cases(twist_a, twist_b, xc)])


def phase_box_kernels(dims_list):
    """Phase 17a: at each size and on each grid of ``BOX_CHECK``, the box
    of one rank cut from one global field, with the t, z and y faces its
    exchange would receive (``utils.kernel_bench.virtual_box``): K4 on
    the box (``csrc/dslash_ch_box.cu``, one launch) in every form of
    ``_box_cases`` (the sharded
    chain in float32, the bf16 operand tier and float64, with and
    without the second output, and the float64 bare hop), against its
    plain version and bit for bit against K1 on the global field
    restricted to the box; each launch counted.  Returns the largest
    absolute errors against the plain versions {"f32": .., "bf16": ..,
    "post": .. (the second-output forms, float32 and bf16 tier)}."""
    import torch
    from quda_qkxtm_multigrid_tpu_torch.benchmarks import tmc_params
    from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry
    from quda_qkxtm_multigrid_tpu_torch.ops.clover import make_clover_pair
    from quda_qkxtm_multigrid_tpu_torch.ops.dslash import double_gauge
    from quda_qkxtm_multigrid_tpu_torch.ops.dslash_kernel import (
        clover_channels, dslash_ch, dslash_ch_box,
        dslash_ch_local, dslash_ch_local_reference, gauge_channels,
        to_channels)
    from quda_qkxtm_multigrid_tpu_torch.utils import rng
    from quda_qkxtm_multigrid_tpu_torch.utils.kernel_bench import (
        virtual_box)

    f32, f64, b16 = torch.float32, torch.float64, torch.bfloat16
    tiers = {"f32": (f32, f32), "bf16": (b16, f32), "f64": (f64, f64)}
    counters = {"f32": "launches", "f64": "launches",
                "bf16": "launches_bf16"}
    kappa = 0.115
    a = 2 * kappa * 0.05
    cases = _box_cases(a, 1 / (1 + a * a), -kappa * kappa)
    err = {"f32": 0.0, "bf16": 0.0, "post": 0.0}
    for dims in dims_list:
        geom = Geometry(*dims)
        print(f"phase 17a: K4 on a box (z / y faces) vs plain and vs K1 "
              f"at {dims}, grids {BOX_CHECK}", flush=True)
        gen = torch.Generator(device=DEVICE).manual_seed(171)
        u = rng.random_gauge(gen, geom)
        _, cinv = make_clover_pair(u, geom, tmc_params())
        ud = double_gauge(u, geom)
        del u
        psi = rng.random_spinor(gen, geom)
        x = rng.random_spinor(gen, geom)
        ops = {}
        for grid in BOX_CHECK:
            coords = _box_of(grid)
            gl = Geometry(geom.X, geom.Y // grid[2], geom.Z // grid[1],
                          geom.T // grid[0])
            worst = {}
            for label, c, tier in cases:
                op, sp = tiers[tier]
                p, dagger, xc = (c["parity"], c.get("dagger", False),
                                 c.get("xpay"))
                if (op, p) not in ops:
                    ops[(op, p)] = (gauge_channels(ud, p, True, op),
                                    clover_channels(cinv, p, op))
                g, ci = ops[(op, p)]
                v = to_channels(psi[1 - p]).to(sp)
                xv = to_channels(x[p]).to(sp)
                kw = dict(dagger=dagger, recon12=True, twist=c.get("twist"),
                          clover=c.get("clover"), xpay_coef=xc,
                          post_op=c.get("post_op"))
                vb, fm, fp, zw = virtual_box(v, grid, coords, geom.Xh)
                kwb = dict(
                    kw, cinv_ch=virtual_box(ci, grid, coords, geom.Xh)[0]
                    if "clover" in c else None,
                    x_ch=virtual_box(xv, grid, coords, geom.Xh)[0]
                    if xc is not None else None)
                gb = virtual_box(g, grid, coords, geom.Xh)[0]
                name = counters[tier]
                before = getattr(dslash_ch_box, name)
                got = dslash_ch_local(gb, vb, fm, fp, p, gl, zw_faces=zw,
                                      **kwb)
                torch.cuda.synchronize()
                if getattr(dslash_ch_box, name) != before + 1:
                    raise AssertionError(f"K4 box {grid} {label}: "
                                         f"dslash_ch_box.{name} did not "
                                         "count the launch")
                ref = dslash_ch_local_reference(gb, vb, fm, fp, p, gl,
                                                zw_faces=zw, **kwb)
                k1 = dslash_ch(g, v, p, geom, **dict(
                    kw, cinv_ch=ci if "clover" in c else None,
                    x_ch=xv if xc is not None else None))
                got, ref, k1 = (t if isinstance(t, tuple) else (t,)
                                for t in (got, ref, k1))
                k1 = tuple(virtual_box(o, grid, coords, geom.Xh)[0]
                           for o in k1)
                e = max(_rel(o, r) for o, r in zip(got, ref))
                lim = F64_LIMIT if sp == f64 else F32_LIMIT
                if e > lim:
                    raise AssertionError(f"K4 box {grid} {label} vs plain: "
                                         f"{e:.3e} > {lim:.0e}")
                if tier != "f64":
                    ea = max(float((o - r).abs().max())
                             for o, r in zip(got, ref))
                    key = "post" if "post_op" in c else tier
                    err[key] = max(err[key], ea)
                e1 = max(_rel(o, r) for o, r in zip(got, k1))
                if e1 > LOCAL_VS_K1[str(sp)[6:]]:
                    raise AssertionError(f"K4 box {grid} {label} vs K1: "
                                         f"{e1:.3e}")
                if not all(torch.equal(o, r) for o, r in zip(got, k1)):
                    raise AssertionError(f"K4 box {grid} {label}: not bit "
                                         f"for bit K1 restricted to the box "
                                         f"({e1:.3e})")
                key = f"{tier} vs plain"
                worst[key] = max(worst.get(key, 0.0), e)
                worst[f"{tier} vs K1"] = max(worst.get(f"{tier} vs K1", 0.0),
                                             e1)
            print(f"  grid {grid}, box {coords} ({gl.dims}): {len(cases)} "
                  f"forms, every one bit for bit K1's; worst " + ", ".join(
                      f"{k} {v:.2e}" for k, v in worst.items()), flush=True)
        del ops, ud, cinv, psi, x
    return err


def _box_registers() -> dict:
    """K4 on a box's kernel instances (``csrc/dslash_ch_box.cu``) →
    "registers" or "registers, spill stores", from the build's ptxas
    log."""
    from quda_qkxtm_multigrid_tpu_torch import _build
    regs, spills, kernel = {}, {}, "?"
    log = _build.library_dir() / "dslash_ch_box.log"
    for line in log.read_text().splitlines():
        m = re.search(r"entry function '_ZN3qkx\d+(\w+?)I(\w*?)EEvNS", line)
        if m:
            kernel = f"{m.group(1)}<{m.group(2)}>"
        m = re.search(r"Used (\d+) registers", line)
        if m:
            regs[kernel] = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and int(m.group(1)):
            spills[kernel] = m.group(1)
    return {k: r + (f", {spills[k]} B spilled" if k in spills else "")
            for k, r in regs.items()}


def phase_box_timing(geom_dims):
    """Phase 17a's timing at ``geom_dims``: K4's t-local bare float32 hop
    (T_loc = T, faces of a ring of one) and K4 on the boxes of
    ``BOX_TIME`` (the rank of ``_box_of``):
    the float32 bare hop, its float64 and bf16-tier forms on the last
    grid and there the chain's hop with the second output (clover fwd +
    xpay + post) in each, and their plain versions, in turns in one call
    (CUDA events, median of 5, call by call as every kernel of the
    ``kernels`` line), each with its bound, beside PR 14's times
    (``BOX_PARENT_MS``); the kernels again on the card alone, printed
    beside (``graph_turns``: the wrapper's host time a call is about the
    box hop's own); then the instances' ptxas registers.  Returns
    {label: (ms a call, plain ms, bound)}."""
    import torch
    from quda_qkxtm_multigrid_tpu_torch.benchmarks import tmc_params
    from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry
    from quda_qkxtm_multigrid_tpu_torch.ops.clover import make_clover_pair
    from quda_qkxtm_multigrid_tpu_torch.ops.dslash import double_gauge
    from quda_qkxtm_multigrid_tpu_torch.ops.dslash_kernel import (
        clover_channels, dslash_ch_local, dslash_ch_local_reference,
        gauge_channels, to_channels)
    from quda_qkxtm_multigrid_tpu_torch.utils import rng
    from quda_qkxtm_multigrid_tpu_torch.utils.kernel_bench import (
        graph_turns, virtual_box)

    geom = Geometry(*geom_dims)
    print(f"phase 17a: K4 on boxes timed at {geom_dims} beside K4's t-local "
          f"hop (median of 5, in turns)", flush=True)
    gen = torch.Generator(device=DEVICE).manual_seed(172)
    u = rng.random_gauge(gen, geom)
    _, cinv = make_clover_pair(u, geom, tmc_params())
    ud = double_gauge(u, geom)
    del u
    spinors = rng.random_spinor(gen, geom)
    psi, x = to_channels(spinors[1]), to_channels(spinors[0])
    del spinors
    hop = dict(recon12=True)
    fns, plain, bounds = {}, {}, {}
    sites = geom.half_volume
    g = gauge_channels(ud, 0, True, torch.float32)
    v = psi.to(torch.float32)
    f24 = (v[-1:].contiguous(), v[:1].contiguous())
    fns["K4 t-local"] = lambda: dslash_ch_local(g, v, *f24, 0, geom, **hop)
    plain["K4 t-local"] = lambda: dslash_ch_local_reference(
        g, v, *f24, 0, geom, **hop)
    bounds["K4 t-local"] = _bound(_nbytes(g, v, *f24, v), HOP_FLOPS * sites)
    tiers = {"f32": (torch.float32, torch.float32),
             "f64": (torch.float64, torch.float64),
             "bf16": (torch.bfloat16, torch.float32)}
    for grid in BOX_TIME:
        last = grid == BOX_TIME[-1]
        for tier in (("f32", "f64", "bf16") if last else ("f32",)):
            op, sp = tiers[tier]
            gt = gauge_channels(ud, 0, True, op)
            coords = _box_of(grid)
            gl = Geometry(geom.X, geom.Y // grid[2], geom.Z // grid[1],
                          geom.T // grid[0])
            gb = virtual_box(gt, grid, coords, geom.Xh)[0]
            vb, fm, fp, zw = virtual_box(psi.to(sp), grid, coords,
                                         geom.Xh)
            cib = virtual_box(clover_channels(cinv, 0, op), grid, coords,
                              geom.Xh)[0]
            xb = virtual_box(x.to(sp), grid, coords, geom.Xh)[0]
            chain = dict(hop, clover="fwd", cinv_ch=cib, xpay_coef=-0.115
                         ** 2, x_ch=xb, post_op=("clover",))
            sites, f64 = gl.half_volume, sp == torch.float64
            forms = {f"box {grid} {tier}": (
                hop, _bound(_nbytes(gb, vb, fm, fp, *zw, vb),
                            HOP_FLOPS * sites, f64))}
            if last:
                forms[f"box {grid} {tier} post"] = (chain, _bound(
                    _nbytes(gb, cib, vb, fm, fp, *zw, xb, vb, vb),
                    (HOP_FLOPS + 2 * CLOVER_FLOPS + XPAY_FLOPS) * sites, f64))
            for label, (kw, bound) in forms.items():
                fns[label] = (lambda gb=gb, vb=vb, fm=fm, fp=fp, zw=zw,
                              gl=gl, kw=kw: dslash_ch_local(
                                  gb, vb, fm, fp, 0, gl, zw_faces=zw, **kw))
                plain[label] = (lambda gb=gb, vb=vb, fm=fm, fp=fp, zw=zw,
                                gl=gl, kw=kw: dslash_ch_local_reference(
                                    gb, vb, fm, fp, 0, gl, zw_faces=zw,
                                    **kw))
                bounds[label] = bound
                got, ref = fns[label](), plain[label]()
                _compare(got, ref, f"17a {label} vs plain (timed inputs)",
                         F64_LIMIT if f64 else F32_LIMIT)
    del ud, cinv
    runs = {**{k: fn for k, fn in fns.items()},
            **{f"{k} plain": fn for k, fn in plain.items()}}
    n_runs = {k: 3 if k.endswith("plain") else 20 for k in runs}
    med = _turns(runs, n_runs)
    card = graph_turns(fns)
    out = {}
    for k in fns:
        ms, pms, (bms, by) = med[k], med[f"{k} plain"], bounds[k]
        out[k] = (ms, pms, (bms, by))
        parent = BOX_PARENT_MS.get(k)
        print(f"  {k:<28s} {ms:.4f} ms a call, plain {pms:.4f} ms, bound "
              f"{bms:.4f} ms ({by}); kernel at {bms / ms:.2f} of it (on the "
              f"card alone {card[k]:.4f} ms, {bms / card[k]:.2f})"
              + ("" if parent is None else f"; PR 14's {parent} ms"),
              flush=True)
    for kernel, regs in _box_registers().items():
        print(f"  ptxas dslash_ch_box {kernel}: {regs} registers",
              flush=True)
    print(f"  K4 t-local hop a call {med['K4 t-local']:.4f} ms against "
          f"PERF.md's {K4_T_LOCAL_MS} ms (PR 13, another machine): "
          f"{med['K4 t-local'] / K4_T_LOCAL_MS:.3f}×", flush=True)
    return out


def _box_rank_refs(work: Path, geom_dims, check_dims) -> dict:
    """17b's references, made on the parent before the ranks start: at
    ``geom_dims`` phase 4's operator (complex128) solved with "cg" and
    "cg-mixed", phase 6's complex64 MG set up again from its seed
    (``bench_mg``), cut by ``shard_mg`` for every rank's box and saved
    to ``work`` (V, the coarse X / Y), with the solutions; at
    ``check_dims`` the unsharded ``run_twop`` (CG path) on a complex64
    gauge of seed 7 with the antiperiodic t boundary.  Returns the
    unsharded records."""
    import torch
    from quda_qkxtm_multigrid_tpu_torch import workflows as wf
    from quda_qkxtm_multigrid_tpu_torch.benchmarks import (
        bench_mg, make_gauge_source, make_problem, tmc_params)
    from quda_qkxtm_multigrid_tpu_torch.invert import invert
    from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry
    from quda_qkxtm_multigrid_tpu_torch.mg.multigrid import (
        mg_solve, shard_mg)
    from quda_qkxtm_multigrid_tpu_torch.ops.gauge import apply_t_boundary
    from quda_qkxtm_multigrid_tpu_torch.parallel.mesh import LatticeMesh

    geom, check = Geometry(*geom_dims), Geometry(*check_dims)
    refs = {}
    d, b = make_problem(geom, DEVICE, seed=7)
    sols = {}
    for solver, tol in (("cg", SLICE_TOL), ("cg-mixed", MIXED_TOL)):
        invert(d, b, tol=tol, maxiter=SLICE_MAXITER, solver=solver)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = invert(d, b, tol=tol, maxiter=SLICE_MAXITER, solver=solver)
        torch.cuda.synchronize()
        refs[solver] = {"iters": res.iters, "true_res": res.true_res,
                        "secs": time.perf_counter() - t0}
        sols[solver] = res.x.cpu()
    del d, b
    d, b = make_problem(geom, DEVICE, seed=7, dtype=torch.complex64)
    rec, mg = bench_mg(geom, tol=MG_TOL, nvec=MG_NVEC, block=MG_BLOCK,
                       n_krylov=MG_NKRYLOV, problem=(d, b))
    if mg.dirac_pr is not None or mg.params.n_level != 2:
        raise AssertionError("17b hands over a two-level MG without a "
                             "δ-scaled smoother operator")
    refs["mg"] = {"iters": rec["iters"], "true_res": rec["true_res"],
                  "secs": rec["secs"], "setup_secs": rec["setup_secs"]}
    sols["mg"] = mg_solve(mg, b, tol=MG_TOL, n_krylov=MG_NKRYLOV).x.cpu()
    torch.save(sols, work / "solutions.pt")
    del sols
    for r in range(BOX_NRANKS):
        box = LatticeMesh(nt=BOX_GRID[0], rank=r, device=torch.device(DEVICE),
                          nz=BOX_GRID[1], nw=BOX_GRID[2])
        ms = shard_mg(mg, box)
        torch.save({"v": ms.transfer.v.cpu(), "bg": ms.transfer.bg},
                   work / f"mg_v_{r}.pt")
        del ms
    torch.save({"x": mg.coarse.x.cpu(), "y": mg.coarse.y.cpu(),
                "bg": mg.coarse.bg, "params": mg.params}, work / "mg_c.pt")
    del d, b, mg
    gc.collect()
    torch.cuda.empty_cache()
    u, _ = make_gauge_source(check, DEVICE, seed=7, dtype=torch.complex64)
    u = apply_t_boundary(u, check)
    p = tmc_params()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    twop = wf.run_twop(u, check, p.kappa, p.mu, p.csw, source=TWOP_SOURCE,
                       tol=TWOP_TOL, maxiter=SLICE_MAXITER)
    torch.cuda.synchronize()
    refs["twop_secs"] = time.perf_counter() - t0
    torch.save({k: twop[k].cpu() for k in ("mesons", "baryons")},
               work / "twop.pt")
    del u, twop
    gc.collect()
    torch.cuda.empty_cache()
    return refs


def phase_box_ranks(geom_dims, check_dims):
    """Phase 17b: a (1, 2, 2) grid of ``BOX_NRANKS`` processes on the one
    card over gloo (NCCL refuses two ranks on one card; the caller asks
    for gloo, and the mesh stages every message through the host), each
    running ``_box_rank`` (``chip_smoke.py --box-rank R DIR``) on its
    box, after the parent made the references (``_box_rank_refs``):
    ``invert(mesh=…)`` "cg" on the float32 chain, "cg-mixed" in
    complex128 on the float32 and on the bf16-tier chain, and
    ``mg_solve(mesh=…)`` at ``geom_dims``; Schwarz GCR and
    ``run_twop(mesh=…)`` at ``check_dims``; the staged exchange timed.
    The kernels are built (phase 1) before the ranks start.  Any rank
    that fails fails the phase.  Returns the records and the K4 box
    launches summed over the ranks."""
    import shutil

    t_phase = time.perf_counter()
    work = ROOT / "build" / "phase17"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    print(f"phase 17b: a {BOX_GRID} grid of {BOX_NRANKS} processes on one "
          f"card over gloo", flush=True)
    t0 = time.perf_counter()
    refs = _box_rank_refs(work, geom_dims, check_dims)
    print(f"  references (unsharded, this process) "
          f"{time.perf_counter() - t0:.1f} s: cg {refs['cg']}, cg-mixed "
          f"{refs['cg-mixed']}, MG {refs['mg']}, 2pt at {check_dims} "
          f"{refs['twop_secs']:.3f} s", flush=True)
    (work / "spec.json").write_text(json.dumps(
        {"geom": list(geom_dims), "check": list(check_dims)}))
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--box-rank", str(r),
         str(work)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(BOX_NRANKS)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=BOX_RANK_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for r, (p, log) in enumerate(zip(procs, logs)):
        tail = "\n".join(log.splitlines()[-40:])
        print(f"  --- rank {r} (exit {p.returncode}) ---\n{tail}", flush=True)
    if any(p.returncode != 0 for p in procs):
        raise AssertionError(f"phase 17b: rank exit codes "
                             f"{[p.returncode for p in procs]}")
    outs = [json.loads((work / f"out_{r}.json").read_text())
            for r in range(BOX_NRANKS)]
    rec = _box_rank_checks(outs, refs)
    rec["ranks_wall_secs"] = wall
    rec["secs"] = time.perf_counter() - t_phase
    shutil.rmtree(work, ignore_errors=True)
    print(f"  phase 17b {rec['secs']:.1f} s (the ranks {wall:.1f} s; PR 14's "
          f"final call {MESH_PARENT['box_ranks_s']} s); K4 box launches by "
          f"rank {rec['launches_by_rank']}", flush=True)
    return rec


def _box_rank_checks(outs: list, refs: dict) -> dict:
    """17b's checks on the ranks' records against the parent's
    references."""
    r0 = outs[0]
    for o in outs[1:]:
        for k in ("cg", "cg-mixed", "cg-mixed-bf16", "mg"):
            if o[k]["iters"] != r0[k]["iters"]:
                raise AssertionError(f"17b {k}: ranks disagree on the "
                                     "iterations")
        for k, v in o["schwarz"].items():
            if v["iters"] != r0["schwarz"][k]["iters"]:
                raise AssertionError(f"17b Schwarz {k}: ranks disagree on "
                                     "the iterations")
    for solver, tol_limit in (("cg", TRUE_RES_LIMIT),
                              ("cg-mixed", MIXED_TRUE_RES_LIMIT),
                              ("cg-mixed-bf16", MIXED_TRUE_RES_LIMIT)):
        o = r0[solver]
        ref = refs[solver.replace("-bf16", "")]
        x_rel = math.sqrt(sum(r[solver]["diff2"] for r in outs)
                          / sum(r[solver]["ref2"] for r in outs))
        print(f"  {solver}: iterations {o['iters']} (unsharded "
              f"{ref['iters']}), warm {o['secs']:.4f} s (unsharded "
              f"{ref['secs']:.4f} s), true_res {o['true_res']:.3e} "
              f"(complex128), solution vs unsharded {x_rel:.3e}", flush=True)
        _check(f"17b {solver}: true residual (c128)", o["true_res"],
               tol_limit)
        _check(f"17b {solver}: solution vs unsharded", x_rel, MESH_X_LIMIT)
        if solver == "cg" and o["iters"] != ref["iters"]:
            raise AssertionError(f"17b cg: {o['iters']} iterations, "
                                 f"unsharded {ref['iters']}")
    o = r0["mg"]
    x_rel = math.sqrt(sum(r["mg"]["diff2"] for r in outs)
                      / sum(r["mg"]["ref2"] for r in outs))
    print(f"  MG-GCR-PC (phase 6's, cut by shard_mg): iterations "
          f"{o['iters']} (cold {o['iters_cold']}; unsharded "
          f"{refs['mg']['iters']}), warm {o['secs']:.4f} s (unsharded "
          f"{refs['mg']['secs']:.4f} s), true_res {o['true_res']:.3e} "
          f"(complex128), all-gathers {o['gathers']}, solution vs "
          f"unsharded {x_rel:.3e}", flush=True)
    # complex64 ends near tol = 1e-7, so whether a GCR(5) cycle more is
    # needed turns on the last bits of the residual's sum, whose order
    # four ranks change: the count may differ by one cycle
    if abs(o["iters"] - refs["mg"]["iters"]) > MG_NKRYLOV \
            or o["iters_cold"] != o["iters"]:
        raise AssertionError(f"17b MG: {o['iters']} iterations, unsharded "
                             f"{refs['mg']['iters']}")
    _check("17b MG: true residual (c128)", o["true_res"], TRUE_RES_LIMIT)
    _check("17b MG: solution vs unsharded", x_rel, MESH_X_LIMIT)
    sz = r0["schwarz"]
    print(f"  Schwarz GCR(10) at {CHECK_GEOM}: plain {sz['plain']['iters']}"
          f", additive {sz['additive']['iters']}, multiplicative "
          f"{sz['multiplicative']['iters']} iterations; seconds "
          + ", ".join(f"{k} {v['secs']:.3f}" for k, v in sz.items()),
          flush=True)
    for k, v in sz.items():
        _check(f"17b Schwarz {k}: true residual (c128)", v["true_res"],
               TRUE_RES_LIMIT)
        if k != "plain" and not v["iters"] < sz["plain"]["iters"]:
            raise AssertionError(f"17b Schwarz {k}: {v['iters']} "
                                 "iterations, not fewer than plain")
    tw = r0["twop"]
    print(f"  run_twop (mesh) at {CHECK_GEOM}: {tw['secs']:.3f} s "
          f"(unsharded {refs['twop_secs']:.3f} s); stages " + ", ".join(
              f"{k} {v:.3f}" for k, v in tw["stages"].items()), flush=True)
    for key in ("mesons", "baryons"):
        _check(f"17b 2pt {key} vs unsharded", tw[key], MESH_X_LIMIT)
    ex = r0["exchange"]
    print(f"  the staged exchange at {SLICE_GEOM}, box "
          f"{ex['box']}: faces {ex['faces_ms']:.4f} ms, the box hop alone "
          f"{ex['hop_ms']:.4f} ms, the hop with its exchange "
          f"{ex['halo_hop_ms']:.4f} ms (mean of 3 calls, median of 5 "
          f"rounds, rank 0's clock)", flush=True)
    by_rank = [{k: o["launches"][k] for k in ("zw", "zw_bf16", "zw_post")}
               for o in outs]
    zw, zw16, zwp = (sum(c[k] for c in by_rank)
                     for k in ("zw", "zw_bf16", "zw_post"))
    if not zw or not zw16 or not zwp:
        raise AssertionError(f"17b: K4 box launches {by_rank}")
    return {"ranks": outs, "launches_by_rank": by_rank, "zw": zw,
            "zw_bf16": zw16, "zw_post": zwp,
            "err": max(o["err"] for o in outs)}


def _box_rank(rank: int, work: Path):
    """One rank of phase 17b (``chip_smoke.py --box-rank RANK DIR``): joins
    the gloo grid through the file store ``DIR/store``, runs its box of
    every 17b solve, checks K4 on the box against its plain version on
    the path's operands, and writes its record to ``DIR/out_RANK.json``.
    The launch counts are set to 0 before the solves and read after."""
    import torch
    import torch.distributed as dist
    from quda_qkxtm_multigrid_tpu_torch import workflows as wf
    from quda_qkxtm_multigrid_tpu_torch.benchmarks import (
        make_gauge_source, tmc_params)
    from quda_qkxtm_multigrid_tpu_torch.dirac import DiracParams
    from quda_qkxtm_multigrid_tpu_torch.invert import invert, true_residual
    from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry
    from quda_qkxtm_multigrid_tpu_torch.mg.coarse_op import CoarseOperator
    from quda_qkxtm_multigrid_tpu_torch.mg.multigrid import (
        MGPreconditioner, mg_solve)
    from quda_qkxtm_multigrid_tpu_torch.mg.transfer import Transfer
    from quda_qkxtm_multigrid_tpu_torch.ops.dslash_kernel import (
        dslash_ch_box, dslash_ch_local, dslash_ch_local_reference,
        to_channels)
    from quda_qkxtm_multigrid_tpu_torch.ops.gauge import apply_t_boundary
    from quda_qkxtm_multigrid_tpu_torch.parallel.halo import box_faces
    from quda_qkxtm_multigrid_tpu_torch.parallel.mesh import (
        LatticeMesh, box_slab, init_ring)
    from quda_qkxtm_multigrid_tpu_torch.parallel.schwarz import (
        schwarz_precond, schwarz_precond_multiplicative)
    from quda_qkxtm_multigrid_tpu_torch.parallel.sharded import (
        halo_hop, make_sharded_dirac)
    from quda_qkxtm_multigrid_tpu_torch.solvers.gcr import gcr
    from quda_qkxtm_multigrid_tpu_torch.utils import rng

    spec = json.loads((work / "spec.json").read_text())
    geom, check = Geometry(*spec["geom"]), Geometry(*spec["check"])
    mesh = init_ring(BOX_GRID, rank, f"file://{work / 'store'}",
                     device=f"{DEVICE}:0" if DEVICE == "cuda" else DEVICE,
                     backend="gloo")
    c128 = torch.complex128
    out = {"rank": rank, "coords": list(mesh.coords)}

    def zero():
        for fn in (dslash_ch_local, dslash_ch_box):
            fn.launches = fn.launches_bf16 = fn.launches_post = 0

    def count() -> dict:
        """The box launches since ``zero``: every one, the bf16 tier's, and
        those with the second output."""
        return {"zw": dslash_ch_box.launches,
                "zw_bf16": dslash_ch_box.launches_bf16,
                "zw_post": dslash_ch_box.launches_post}

    def add():
        for k, n in count().items():
            totals[k] += n

    def timed(fn):
        mesh.allreduce(torch.zeros(1, device=mesh.device))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    def versus(x, ref):
        """(Σ|x − ref|², Σ|ref|²) over this rank's box."""
        ref = box_slab(ref, mesh).to(x.dtype)
        return (float((x - ref).abs().pow(2).sum()),
                float(ref.abs().pow(2).sum()))

    zero()
    totals = {"zw": 0, "zw_bf16": 0, "zw_post": 0}
    # the solves at geom, complex128, on the box's own build
    u, b = make_gauge_source(geom, mesh.device, seed=7)
    u_box, b_box = box_slab(u, mesh), box_slab(b, mesh)
    del u, b
    sols = torch.load(work / "solutions.pt", mmap=True)
    ops = {bf16: make_sharded_dirac(u_box, tmc_params(bf16=bf16), geom, mesh)
           for bf16 in (False, True)}
    # a cold "cg" builds the channel operands of the float32 chain; the
    # bf16 tier's first solve builds its own, timed with it
    invert(ops[False], b_box, tol=SLICE_TOL, maxiter=SLICE_MAXITER,
           mesh=mesh)
    for solver, tol, bf16 in (("cg", SLICE_TOL, False),
                              ("cg-mixed", MIXED_TOL, False),
                              ("cg-mixed-bf16", MIXED_TOL, True)):
        ds = ops[bf16]
        kind = solver.replace("-bf16", "")
        zero()
        res, secs = timed(lambda: invert(
            ds, b_box, tol=tol, maxiter=SLICE_MAXITER, solver=kind,
            mesh=mesh))
        launches = dict(count(), t_local=dslash_ch_local.launches
                        + dslash_ch_local.launches_bf16)
        add()
        d2, r2 = versus(res.x, sols[kind])
        out[solver] = {"iters": res.iters, "true_res": res.true_res,
                       "secs": secs, "diff2": d2, "ref2": r2,
                       "launches": launches,
                       "restarts": getattr(res.stats, "restarts", None)}
        print(f"rank {rank} {solver}: {res.iters} iterations, {secs:.3f} s, "
              f"true_res {res.true_res:.3e}, launches {launches}",
              flush=True)
        if launches["t_local"]:
            raise AssertionError(f"{solver}: t-local K4 launched on a box")
    del sols, ops, ds
    # K4 on the box against its plain version on the path's operands
    ds = make_sharded_dirac(u_box, tmc_params(), geom, mesh)
    gen = torch.Generator(device=mesh.device).manual_seed(173)
    psi = box_slab(rng.random_spinor(gen, geom), mesh)
    err = 0.0
    kw = ds._hop_kw()
    for dtype in (torch.float32, torch.float64):
        g = ds._operands(dtype, exact=True)["g"]
        for p in (0, 1):
            v = to_channels(psi[1 - p]).to(dtype)
            fm, fp, zw = box_faces(v, mesh, ds.geom.Xh)
            for dagger in (False, True):
                got = dslash_ch_local(g[p], v, fm, fp, p, ds.geom, dagger,
                                      zw_faces=zw, **kw)
                ref = dslash_ch_local_reference(g[p], v, fm, fp, p, ds.geom,
                                                dagger, zw_faces=zw, **kw)
                e = _rel(got, ref)
                lim = F64_LIMIT if dtype == torch.float64 else F32_LIMIT
                if e > lim:
                    raise AssertionError(f"K4 box {dtype} p{p} d{dagger} vs "
                                         f"plain on the path: {e:.3e}")
                err = max(err, float((got - ref).abs().max()))
    out["err"] = err
    # the staged exchange, f32, at geom
    g = ds._operands(torch.float32)["g"][0]
    v = to_channels(psi[1]).to(torch.float32)
    faces = box_faces(v, mesh, ds.geom.Xh)
    fns = {"faces_ms": lambda: box_faces(v, mesh, ds.geom.Xh),
           "hop_ms": lambda: dslash_ch_local(g, v, faces[0], faces[1], 0,
                                             ds.geom, zw_faces=faces[2],
                                             **kw),
           "halo_hop_ms": lambda: halo_hop(mesh, False, g, v, 0, ds.geom,
                                           **kw)}
    ex = {k: [] for k in fns}
    for _ in range(5):
        for k, fn in fns.items():
            mesh.allreduce(torch.zeros(1, device=mesh.device))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            ex[k].append((time.perf_counter() - t0) * 1e3 / 3)
    out["exchange"] = {k: statistics.median(t) for k, t in ex.items()}
    out["exchange"]["box"] = list(ds.geom.dims)
    del ds, g, v, faces, psi
    # MG-GCR-PC, complex64: phase 6's preconditioner cut by shard_mg
    ds64 = make_sharded_dirac(u_box.to(torch.complex64), tmc_params(), geom,
                              mesh)
    ds128 = make_sharded_dirac(u_box, tmc_params(), geom, mesh)
    vb = torch.load(work / f"mg_v_{rank}.pt", weights_only=False)
    co = torch.load(work / "mg_c.pt", weights_only=False)
    ms = MGPreconditioner(
        transfer=Transfer(v=vb["v"].to(mesh.device), bg=vb["bg"]),
        coarse=CoarseOperator(x=co["x"].to(mesh.device),
                              y=co["y"].to(mesh.device), bg=co["bg"]),
        dirac=ds64, params=co["params"])
    del vb, co
    b64 = b_box.to(torch.complex64)
    cold = mg_solve(ms, b64, tol=MG_TOL, n_krylov=MG_NKRYLOV, mesh=mesh)
    zero()
    g0 = LatticeMesh.gathers
    res, secs = timed(lambda: mg_solve(ms, b64, tol=MG_TOL,
                                       n_krylov=MG_NKRYLOV, mesh=mesh))
    add()
    _, rel = true_residual(ds128, res.x.to(c128), b_box)
    d2, r2 = versus(res.x, torch.load(work / "solutions.pt",
                                      mmap=True)["mg"])
    out["mg"] = {"iters": res.iters, "iters_cold": cold.iters,
                 "secs": secs, "true_res": float(rel),
                 "gathers": LatticeMesh.gathers - g0,
                 "launches": dslash_ch_box.launches, "diff2": d2,
                 "ref2": r2}
    print(f"rank {rank} MG: {res.iters} iterations, {secs:.3f} s, true_res "
          f"{float(rel):.3e}", flush=True)
    del ms, ds64, ds128, b64, u_box, b_box, res, cold
    gc.collect()
    torch.cuda.empty_cache()
    # Schwarz GCR at check, complex128, antiperiodic (phase 16b's)
    u, _ = make_gauge_source(check, mesh.device, seed=P16_SEED, dtype=c128)
    u = apply_t_boundary(u, check)
    gen = torch.Generator(device=mesh.device).manual_seed(P16_SEED)
    b = rng.random_spinor(gen, check, c128)
    ds = make_sharded_dirac(box_slab(u, mesh), DiracParams(
        **SCHWARZ, use_kernels=True), check, mesh)
    bs = box_slab(b, mesh)
    del u, b
    pcs = {"plain": None, "additive": schwarz_precond(ds, mesh, niter=4),
           "multiplicative": schwarz_precond_multiplicative(ds, mesh,
                                                            niter=4)}
    out["schwarz"] = {}
    for name, pc in pcs.items():
        zero()
        res, secs = timed(lambda: gcr(ds.m, bs, tol=SCHWARZ_TOL, n_krylov=10,
                                      max_restarts=40, precond=pc,
                                      allreduce=mesh.allreduce))
        add()
        _, rel = true_residual(ds, res.x, bs)
        out["schwarz"][name] = {"iters": res.iters, "secs": secs,
                                "true_res": float(rel)}
    del ds, bs, pcs
    # run_twop on the box's CG path at check
    u, _ = make_gauge_source(check, mesh.device, seed=7,
                             dtype=torch.complex64)
    u = apply_t_boundary(u, check)
    p = tmc_params()
    st = {}
    zero()
    twop, secs = timed(lambda: wf.run_twop(
        box_slab(u, mesh), check, p.kappa, p.mu, p.csw, source=TWOP_SOURCE,
        tol=TWOP_TOL, maxiter=SLICE_MAXITER, mesh=mesh, stats=st))
    add()
    ref = torch.load(work / "twop.pt")
    out["twop"] = {"secs": secs, "stages": st["secs"], **{
        k: _rel64(twop[k].cpu(), ref[k]) for k in ("mesons", "baryons")}}
    out["launches"] = totals
    (work / f"out_{rank}.json").write_text(json.dumps(out))
    dist.destroy_process_group()


def phase_mg_compact(geom_dims, mg6: dict):
    """Phase 18a: the JAX package's north-star configuration at
    ``geom_dims`` (``NORTH_STAR``: nvec 24, 4⁴ blocks, bf16 V, the
    compact solve tiers with the step tier's A⁻¹ in bf16 and the
    residual tier without its clover, GCR(5), tol 1e-7) on phase 6's
    complex64 problem through ``benchmarks.bench_mg``: setup (the solve
    tiers built after the coarse build and the cast of V), a cold and a
    warm ``mg_solve(final_resid=False)``, the warm solution certified in
    complex128 on the card; then the step tier's four chain hops (K1d
    ``f32_g16``) on its own channels against their plain version.
    Returns the record, the launches and the kernels' largest errors."""
    import torch
    from quda_qkxtm_multigrid_tpu_torch.benchmarks import bench_mg
    from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry
    from quda_qkxtm_multigrid_tpu_torch.ops.dslash_kernel import (
        dslash_ch, dslash_ch_msrc, to_channels)
    from quda_qkxtm_multigrid_tpu_torch.utils import rng

    geom = Geometry(*geom_dims)
    print(f"phase 18a: the north star at {geom_dims}: {NORTH_STAR}, "
          f"GCR({NORTH_STAR_NKRYLOV}), tol {MG_TOL}", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    dslash_ch.launches = dslash_ch.launches_bf16 = 0
    dslash_ch_msrc.launches = 0
    rec, mg = bench_mg(geom, tol=MG_TOL, n_krylov=NORTH_STAR_NKRYLOV,
                       **NORTH_STAR)
    launches = {"k1": dslash_ch.launches, "k1d": dslash_ch.launches_bf16,
                "k2": dslash_ch_msrc.launches}
    print(f"  setup {rec['setup_secs']:.3f} s: null vectors "
          f"{rec['null_vector_secs']:.3f} s (multi-source CG iterations "
          f"{rec['msrc_iters']}), "
          f"orthonormalisation {rec['ortho_secs']:.3f} s, coarse build "
          f"{rec['coarse_build_secs']:.3f} s, solve tiers "
          f"{rec['solve_tiers_secs']:.3f} s", flush=True)
    print(f"  outer iterations {rec['iters']} (cold {rec['iters_cold']}; "
          f"JAX north star {NORTH_STAR_JAX['iters']}, true_res "
          f"{NORTH_STAR_JAX['true_res']:.2e}; phase 6, canonical, "
          f"{mg6['iters']})  warm secs {rec['secs']:.4f} (cold "
          f"{rec['secs_cold']:.4f}; phase 6 {mg6['secs']:.4f})  true_res "
          f"{rec['true_res']:.3e} (complex128)", flush=True)
    print(f"  peak memory {rec['peak_mem_bytes'] / 2**30:.2f} GiB  "
          f"launches {launches} (warm solve: K1 {rec['k1_launches_solve']}, "
          f"K1d {rec['k1d_launches_solve']})", flush=True)
    _check("north star true residual (complex128)", rec["true_res"],
           TRUE_RES_LIMIT)
    if rec["k1d_launches_solve"] == 0 or rec["k1_launches_solve"] == 0:
        raise AssertionError("the compact tiers' solve launched no K1d or "
                             f"no K1: {launches}")
    if launches["k2"] != 4 * sum(rec["msrc_iters"]):
        raise AssertionError(f"K2 launches {launches['k2']} != 4 × "
                             f"{sum(rec['msrc_iters'])}")
    cd = mg.dirac_sloppy
    psi = rng.random_spinor(torch.Generator(device=DEVICE).manual_seed(41),
                            geom, torch.complex64)
    v, x = (to_channels(psi[p]) for p in (0, 1))
    err = _compact_forms_check(cd, _compact_chain_forms(cd, v, x, None),
                               f"at {geom_dims} (18a)")
    del mg, cd, psi, v, x
    return rec, launches, err


def phase_mg48(geom_dims):
    """Phase 18b: ``benchmarks.bench_mg48_dc`` at ``geom_dims`` (48³×96,
    ``MG48``: nvec 24): ``mg.hbm_setup.setup_mg_hbm`` on the compact bf16
    tier with A⁻¹ in bf16 (null vectors one at a time, CholQR² in place,
    the coarse build against a lean complex64 operator, V cast to bf16),
    then MG-GCR-PC inner solves under a float64 defect-correction outer,
    certified in complex128; the setup split, restarts, inner
    iterations, the peak memory and the launches; then the bf16 tier's
    four chain hops (K1d ``f32_g16``) on its own channels against their
    plain version at this size, and its clover fwd + xpay hop timed
    against its plain version with its bound.  Returns the record, the
    launches, the peak, the kernels' largest errors and that timing."""
    import torch
    from quda_qkxtm_multigrid_tpu_torch.benchmarks import bench_mg48_dc
    from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry
    from quda_qkxtm_multigrid_tpu_torch.ops.dslash_kernel import (
        _kernel_form, dslash_ch, dslash_ch_reference, to_channels)
    from quda_qkxtm_multigrid_tpu_torch.utils import rng

    geom = Geometry(*geom_dims)
    print(f"phase 18b: MG-GCR-PC at {geom_dims} through the HBM-gated "
          f"setup, {MG48}", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dslash_ch.launches = dslash_ch.launches_bf16 = 0
    rec, mg = bench_mg48_dc(geom, device=DEVICE, **MG48)
    launches = {"k1 f64": dslash_ch.launches, "k1d": dslash_ch.launches_bf16}
    peak = torch.cuda.max_memory_allocated()
    print(f"  setup {rec['setup_secs']:.2f} s: bf16 tier "
          f"{rec['build_compact_secs']:.2f} s, null vectors "
          f"{rec['null_vectors_secs']:.2f} s (CG iterations "
          f"{rec['cg_iters']}, worst true_res {rec['null_true_res']:.2e}), "
          f"CholQR² in place {rec['ortho_secs']:.2f} s, coarse build "
          f"{rec['coarse_secs']:.2f} s, bf16 V {rec['cast_secs']:.2f} s; "
          f"float64 operator {rec['exact_build_secs']:.2f} s", flush=True)
    print(f"  restarts {rec['restarts']}, inner iterations "
          f"{rec['inner_iters']} ({rec['inner_iters_each']}), history "
          f"{[f'{h:.2e}' for h in rec['history']]}, diverged "
          f"{rec['diverged']}, true_res {rec['true_res']:.3e} (complex128, "
          f"exact operator); solve {rec['secs']:.2f} s (outer residuals "
          f"{rec['resid_secs']:.2f} s)", flush=True)
    print(f"  peak memory {peak / 2**30:.2f} GiB ({peak / 1e9:.2f} GB); "
          f"launches {launches}", flush=True)
    if rec["diverged"]:
        raise AssertionError("bench_mg48_dc diverged")
    _check("48³×96 MG true residual (complex128)", rec["true_res"],
           MG48_TRUE_RES)
    if peak >= CARD_BYTES:
        raise AssertionError(f"peak memory {peak / 1e9:.2f} GB >= 80 GB")
    if launches["k1d"] == 0 or launches["k1 f64"] == 0:
        raise AssertionError(f"48³×96 MG launches {launches}")
    cd = mg.dirac_sloppy
    psi = rng.random_spinor(torch.Generator(device=DEVICE).manual_seed(47),
                            geom, torch.complex64)
    v, x = (to_channels(psi[p]) for p in (0, 1))
    del psi
    err = _compact_forms_check(cd, _compact_chain_forms(cd, v, x, None),
                               f"at {geom_dims} (18b)")
    pr, k = cd.params.matpc_parity, cd.params.kappa
    kw = dict(clover="fwd", cinv_ch=cd.cinv_ch[pr], xpay_coef=-k * k,
              x_ch=x)
    form = _kernel_form(cd.g_ch[pr], v, cd.cinv_ch[pr], x, bare=False)
    if form != "f32_g16":
        raise AssertionError(f"the bf16 tier's hop is {form}, not f32_g16")
    ms, plain_ms = _compare_timed(
        lambda: cd._hop(pr, v, **kw),
        lambda: dslash_ch_reference(cd.g_ch[pr], v, pr, geom, recon12=True,
                                    **kw))
    bound = _bound(_nbytes(cd.g_ch[pr], cd.cinv_ch[pr], v, x, v),
                   (HOP_FLOPS + CLOVER_FLOPS + XPAY_FLOPS)
                   * geom.half_volume)
    print(f"  K1d f32_g16 clover fwd + xpay at {geom_dims}: {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}; "
          f"the kernel at {bound[0] / ms:.2f} of it)", flush=True)
    del mg, cd, v, x
    return rec, launches, peak, err, (ms, plain_ms, bound)


def phase_clover6(dims_list):
    """Phase 19: C6 (``clover_ch``) against ``dirac._ch_clover_plain`` on
    the card at each of ``dims_list`` (one parity, random operands; the
    last size timed).  Returns the largest absolute error and the bf16
    form's (ms, plain ms, bound)."""
    import torch
    from quda_qkxtm_multigrid_tpu_torch.dirac import _ch_clover_plain
    from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry
    from quda_qkxtm_multigrid_tpu_torch.ops.dslash_kernel import clover_ch

    f32, f64, b16 = torch.float32, torch.float64, torch.bfloat16
    forms = {"bf16 A, f32 psi": (b16, f32), "bf16 A, bf16 psi": (b16, b16),
             "f32": (f32, f32), "f32 A, bf16 psi": (f32, b16),
             "f64": (f64, f64)}
    err, timed = 0.0, {}
    for dims in dims_list:
        t, z, w = Geometry(*dims).lat_shape
        print(f"phase 19: the 6×6 clover kernel (C6) vs plain at {dims}",
              flush=True)
        gen = torch.Generator(device=DEVICE).manual_seed(67)
        c = torch.randn((t, 144, z, w), generator=gen, device=DEVICE,
                        dtype=f64)
        n = 3 if dims != dims_list[-1] else 1
        v = torch.randn((n, t, 24, z, w), generator=gen, device=DEVICE,
                        dtype=f64)
        for label, (cdt, vdt) in forms.items():
            cc, vv = c.to(cdt), v.to(vdt)
            worst, launches = 0.0, clover_ch.launches
            for dag in (False, True):
                for tw in (0.0, CLOVER6_TWIST):
                    for src in ((vv[0], vv) if n > 1 else (vv[0],)):
                        got = clover_ch(cc, src, dag, tw)
                        want = _ch_clover_plain(src, cc, dag, tw)
                        if got.dtype != want.dtype:
                            raise AssertionError(f"C6 {label}: {got.dtype}"
                                                 f" against {want.dtype}")
                        worst = max(worst, _rel(got.double(),
                                                want.double()))
                        err = max(err, float((got - want).abs().max()))
                        del got, want
            made = clover_ch.launches - launches
            if made != 4 * (2 if n > 1 else 1):
                raise AssertionError(f"C6 {label}: {made} launches")
            _check(f"C6 {label} vs plain (fwd, dag, twist, n)", worst,
                   CLOVER6_LIMIT["float64" if cdt == f64 else "float32"])
            if dims == dims_list[-1] and label in ("bf16 A, f32 psi", "f32",
                                                  "f64"):
                src = vv[0]
                out = clover_ch(cc, src)
                ms, plain_ms = _compare_timed(
                    lambda: clover_ch(cc, src),
                    lambda: _ch_clover_plain(src, cc))
                bound = _bound(_nbytes(cc, src, out),
                               CLOVER6_FLOPS * t * z * w, cdt == f64)
                timed[label] = (ms, plain_ms, bound)
                print(f"  C6 {label} at {dims}: {ms:.4f} ms, plain "
                      f"{plain_ms:.4f} ms, bound {bound[0]:.4f} ms "
                      f"({bound[1]}; the kernel at {bound[0] / ms:.2f} of "
                      f"it)", flush=True)
                del out
            del cc, vv
        del c, v
        gc.collect()
        torch.cuda.empty_cache()
    return err, timed["bf16 A, f32 psi"]


def _mobius5_forms(mats, v, x) -> float:
    """The worst normwise error of M5 against ``mobius5_plain`` over every
    matrix of ``mats``, without x and with x at a = 1 and −0.37, each
    pass one launch."""
    from quda_qkxtm_multigrid_tpu_torch.ops.domain_wall import (
        mobius5_ch, mobius5_plain)
    worst = 0.0
    for name, mat in mats.items():
        for xx, a in ((None, 0.0), (x, 1.0), (x, -0.37)):
            launches = mobius5_ch.launches
            got = mobius5_ch(mat, v, xx, a)
            if mobius5_ch.launches != launches + 1:
                raise AssertionError(f"M5 {name}: no launch")
            worst = max(worst, _rel64(got, mobius5_plain(mat, v, xx, a)))
            del got
    return worst


def phase_mobius5(box_dims, solve_dims):
    """Phase 20: M5 (``mobius5_ch``) against ``mobius5_plain`` on the card,
    timed at ``box_dims`` with its byte bound, then ``invert``'s Möbius
    route at ``solve_dims`` certified in complex128.  Returns the largest
    absolute error, (ms, plain ms, bound) of the form without x, and the
    solve's record with the M5 launches it made."""
    import torch
    from portbench.gauge import make_gauge
    from portbench.m5bytes import m5_bytes
    from portbench.units.dw_solve import wall_source
    from quda_qkxtm_multigrid_tpu_torch.invert import invert
    from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry
    from quda_qkxtm_multigrid_tpu_torch.ops.domain_wall import (
        MobiusDirac, mobius5_ch, mobius5_matrices, mobius5_plain)

    def mats(ls):
        return {k: torch.tensor(m, dtype=torch.float32, device=DEVICE)
                for k, m in mobius5_matrices(ls, **MDWF48I).items()}

    def fields(shape, seed, offset=0):
        gen = torch.Generator(device=DEVICE).manual_seed(seed)
        n = math.prod(shape)
        buf = torch.randn(2 * n + offset, generator=gen, device=DEVICE)
        return (buf[offset:offset + n].view(shape),
                buf[offset + n:].view(shape))

    t, z, w = Geometry(*box_dims).lat_shape
    shape = (MDWF_LS, t, 24, z, w)
    print(f"phase 20: the Möbius fifth-dimension kernel (M5) vs plain at "
          f"{box_dims}, Ls {MDWF_LS}, and invert's Möbius route at "
          f"{solve_dims}", flush=True)
    v, x = fields(shape, 71)
    _check("M5 vs plain at the box (every form)",
           _mobius5_forms(mats(MDWF_LS), v, x), MOBIUS5_LIMIT)
    m = mats(MDWF_LS)["pre_inv"]
    err = float((mobius5_ch(m, v, x, 1.0)
                 - mobius5_plain(m, v, x, 1.0)).abs().max())
    timed = {}
    for label, xx in (("M5", None), ("M5 + x", x)):
        out = mobius5_ch(m, v, xx, 1.0)
        ms, plain_ms = _compare_timed(lambda: mobius5_ch(m, v, xx, 1.0),
                                      lambda: mobius5_plain(m, v, xx, 1.0))
        bound = _bound(m5_bytes(math.prod(shape) // 24, 1, xx is not None),
                       2 * MDWF_LS * out.numel())
        timed[label] = (ms, plain_ms, bound)
        print(f"  {label} at {box_dims}, Ls {MDWF_LS}: {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}; "
              f"the kernel at {bound[0] / ms:.2f} of it)", flush=True)
        if bound[0] / ms < MOBIUS5_SHARE:
            raise AssertionError(f"{label}: {bound[0] / ms:.2f} of its "
                                 f"bound < {MOBIUS5_SHARE}")
        del out
    del v, x
    gc.collect()
    torch.cuda.empty_cache()
    small = (4, 24, 8, 32)
    worst = {ls: _mobius5_forms(mats(ls), *fields((ls,) + small, ls))
             for ls in (8, 12, 16, 20, 32)}
    worst["one value a thread"] = _mobius5_forms(
        mats(MDWF_LS), *fields((MDWF_LS,) + small, 3, offset=1))
    worst["odd Z·W"] = _mobius5_forms(mats(12), *fields((12, 4, 24, 3, 5),
                                                        5))
    print(f"  M5 vs plain by Ls and instance: "
          f"{ {k: f'{e:.2e}' for k, e in worst.items()} }", flush=True)
    _check("M5 vs plain (Ls 8-32, one value a thread)",
           max(worst.values()), MOBIUS5_LIMIT)

    geom = Geometry(*solve_dims)
    u = make_gauge(solve_dims, 2**31 + 77, DEVICE, "antiperiodic")
    op = MobiusDirac(u.to(torch.complex64), geom, MDWF_LS, **MDWF48I)
    b = wall_source(solve_dims, MDWF_LS, (1, 2, 3, 4), 0, 1,
                    torch.complex64, DEVICE)
    mobius5_ch.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = invert(op, b, tol=MDWF_TOL, maxiter=MDWF_MAXITER, solver="cg")
    torch.cuda.synchronize()
    rec = {"secs": time.perf_counter() - t0, "iters": res.iters,
           "launches": mobius5_ch.launches, "true_res_own": res.true_res}
    del op
    op128 = MobiusDirac(u.to(torch.complex128), geom, MDWF_LS, **MDWF48I,
                        use_kernels=False)
    b128 = b.to(torch.complex128)
    rec["true_res"] = _rel(op128.m(res.x.to(torch.complex128)), b128)
    print(f"  invert(MobiusDirac, 'cg') at {solve_dims}, Ls {MDWF_LS}: "
          f"{rec['iters']} iterations in {rec['secs']:.2f} s, M5 launches "
          f"{rec['launches']}, its own true_res {rec['true_res_own']:.3e}, "
          f"complex128 {rec['true_res']:.3e}", flush=True)
    if rec["launches"] != 6 * res.iters + 11:
        raise AssertionError(f"M5 launches {rec['launches']} on the "
                             f"Möbius route, not 6 x {res.iters} + 11")
    _check("Möbius route true residual (complex128)", rec["true_res"],
           MDWF_TRUE_RES)
    del op128, b128, b, u, res
    gc.collect()
    torch.cuda.empty_cache()
    return err, timed["M5"], rec


def _cg_launches() -> int:
    """The fused CG steps' kernel launches so far (``ops.blas``)."""
    from quda_qkxtm_multigrid_tpu_torch.ops import blas
    return (blas.cg_pap.launches + blas.cg_r_update_norm.launches
            + blas.cg_xp_update.launches)


def _cg_launches_zero():
    from quda_qkxtm_multigrid_tpu_torch.ops import blas
    blas.cg_pap.launches = 0
    blas.cg_r_update_norm.launches = 0
    blas.cg_xp_update.launches = 0


def phase_cg_fused(box_dims):
    """Phase 21: the fused CG steps (``ops.blas.cg_pap``,
    ``cg_r_update_norm``, ``cg_xp_update``) against their plain versions
    on the card, in float32 and float64, on vectors of the ``mdwf48i``
    cell (a half-parity 5D field at ``box_dims``, Ls ``MDWF_LS``: 764 M
    reals), then a slice off the 16-byte grid with a scalar tail; then one
    fused float32 iteration timed against its 10-pass byte bound, the
    plain steps and the separate eager calls it replaced.  Returns the
    largest normwise error and (ms, plain ms, bound)."""
    import torch
    from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry
    from quda_qkxtm_multigrid_tpu_torch.ops import blas

    t, z, w = Geometry(*box_dims).lat_shape
    shape = (MDWF_LS, t, 24, z, w)
    print(f"phase 21: the fused CG steps vs plain at {box_dims}, Ls "
          f"{MDWF_LS} ({math.prod(shape)} reals a vector), and a fused "
          f"iteration timed", flush=True)

    def rel0(a, b) -> float:
        return abs(float(a) - float(b)) / abs(float(b))

    def check(dt, shape, seed, offset=0):
        """The three steps, one at a time (at most six vectors live):
        the largest normwise error of each output against plain."""
        gen = torch.Generator(device=DEVICE).manual_seed(seed)
        n = math.prod(shape)

        def vec():
            buf = torch.randn(n + offset, generator=gen, device=DEVICE,
                              dtype=dt)
            return buf[offset:].view(shape)
        p, ap, x, r = vec(), vec(), vec(), vec()
        alpha = torch.tensor(0.37, dtype=torch.float64, device=DEVICE)
        beta = torch.tensor(0.81, dtype=torch.float64, device=DEVICE)
        errs = {"pap": rel0(blas.cg_pap(p, ap), blas.cg_pap_plain(p, ap))}
        rk = r.clone()
        r2k = blas.cg_r_update_norm(rk, ap, alpha)
        r2p = blas.cg_r_update_norm_plain(r, ap, alpha)
        errs["r2"] = rel0(r2k, r2p)
        errs["r"] = _rel(rk, r)
        del rk, ap
        xk, pk = x.clone(), p.clone()
        blas.cg_xp_update(xk, pk, r, alpha, beta)
        blas.cg_xp_update_plain(x, p, r, alpha, beta)
        errs["x"], errs["p"] = _rel(xk, x), _rel(pk, p)
        torch.cuda.synchronize()
        return errs

    worst = 0.0
    for dt in (torch.float32, torch.float64):
        name = str(dt).split(".")[-1]
        for label, shp, off in (("mdwf48i", shape, 0),
                                ("off the grid, tail", (1_000_003,), 1)):
            errs = check(dt, shp, 91, off)
            print(f"  {name} {label}: "
                  f"{ {k: f'{e:.2e}' for k, e in errs.items()} }",
                  flush=True)
            _check(f"CG steps {name} vs plain ({label})", max(errs.values()),
                   CG_LIMIT[name])
            worst = max(worst, max(errs.values()))
            gc.collect()
            torch.cuda.empty_cache()

    gen = torch.Generator(device=DEVICE).manual_seed(92)
    p, ap, x, r = (torch.randn(shape, generator=gen, device=DEVICE)
                   for _ in range(4))
    r2 = blas.cg_pap(r, r)

    def fused():
        alpha = r2 / blas.cg_pap(p, ap)
        r2n = blas.cg_r_update_norm(r, ap, alpha)
        blas.cg_xp_update(x, p, r, alpha, r2n / r2)

    def plain():
        alpha = r2 / blas.cg_pap_plain(p, ap)
        r2n = blas.cg_r_update_norm_plain(r, ap, alpha)
        blas.cg_xp_update_plain(x, p, r, alpha, r2n / r2)

    def eager():
        """The separate calls the steps replaced (``cg``'s old loop body)."""
        alpha = r2.float() / blas.reDotProduct(p, ap)
        blas.axpy(alpha, p, x)
        blas.axpy(-alpha, ap, r)
        blas.xpay(r, blas.norm2(r) / r2.float(), p)

    # the values run off to inf within a few dozen iterations; the card's
    # float pipes take them at the same rate
    med = _turns({"plain": plain, "eager": eager, "kernel": fused},
                 {"plain": 2, "eager": 10, "kernel": 20})
    bound = _bound(CG_PASSES * p.numel() * p.element_size(),
                   10 * p.numel())
    print(f"  one fused iteration: {med['kernel']:.4f} ms, bound "
          f"{bound[0]:.4f} ms ({bound[1]}; {bound[0] / med['kernel']:.2f} of "
          f"it), plain {med['plain']:.4f} ms, the separate eager calls "
          f"{med['eager']:.4f} ms ({med['eager'] / med['kernel']:.2f}x)",
          flush=True)
    print(f"  launches: cg_pap {blas.cg_pap.launches}, cg_r_update_norm "
          f"{blas.cg_r_update_norm.launches}, cg_xp_update "
          f"{blas.cg_xp_update.launches}", flush=True)
    share = bound[0] / med["kernel"]
    if share < CG_SHARE:
        raise AssertionError(f"a fused CG iteration: {share:.2f} of its "
                             f"bound < {CG_SHARE}")
    del p, ap, x, r, r2
    gc.collect()
    torch.cuda.empty_cache()
    return worst, (med["kernel"], med["plain"], bound)


def _light_operator(geom, kappa: float):
    """The complex64 twisted-clover operator of ``bench_light`` at κ."""
    from quda_qkxtm_multigrid_tpu_torch.benchmarks import light_problem
    return light_problem(geom, kappa, LIGHT_MU, DEVICE)


def main():
    _import_port()
    import torch
    card = phase_card()
    max_abs = phase_kernel_vs_plain(CHECK_GEOM)
    err_c6, t_c6 = phase_clover6((SLICE_GEOM, BIG_GEOM))
    from quda_qkxtm_multigrid_tpu_torch.ops.dslash_kernel import clover_ch
    c6 = {}   # phase: launches of the 6×6 clover kernel (C6) in it
    cgk = {}  # phase: launches of the fused CG steps in it

    def c6_counted(label, fn, *args):
        clover_ch.launches = 0
        _cg_launches_zero()
        out = fn(*args)
        c6[label] = clover_ch.launches
        cgk[label] = _cg_launches()
        return out

    err_m5, t_m5, dw20 = c6_counted("20", phase_mobius5, MDWF_BOX,
                                    MDWF_SOLVE_GEOM)
    if cgk["20"] != 5 * dw20["iters"] + 2:
        raise AssertionError(f"fused CG launches {cgk['20']} on the Möbius "
                             f"route, not 5 x {dw20['iters']} + 2")
    err_cg, t_cg = phase_cg_fused(MDWF_BOX)

    phase_identities(CHECK_GEOM)
    tbc = phase_tbc(CHECK_GEOM)
    k = c6_counted("4", phase_slice, SLICE_GEOM)
    k2 = phase_msrc(CHECK_GEOM, SLICE_GEOM)
    launches, mg6 = c6_counted("6", phase_mg, SLICE_GEOM)
    err_16 = phase_bf16_kernels(CHECK_GEOM)
    mixed = c6_counted("7 mixed", phase_mixed, SLICE_GEOM)
    times, bounds, err_time, k2d = phase_bf16_timing(SLICE_GEOM,
                                                     MSRC_TIME_N)
    k1d_paths, k2d_paths = c6_counted("7 bf16 paths", phase_bf16_paths,
                                      CHECK_GEOM)
    err_8a = phase_k1e_k3_kernels(CHECK_GEOM)
    spin = c6_counted("8b", phase_bf16_spinor, SLICE_GEOM, CHECK_GEOM)
    cmix = c6_counted("8c", phase_compact_mixed, SLICE_GEOM)
    big, _, _, _, err_48 = c6_counted("8d", phase_compact48, BIG_GEOM)
    err_9a = phase_local_kernels((CHECK_GEOM, SLICE_GEOM))
    mesh_runs, t9 = c6_counted("9", phase_mesh_solve, SLICE_GEOM,
                               k["secs"])
    vk, _ = phase_v_kernels(CHECK_GEOM, SLICE_GEOM)
    twop = c6_counted("11", phase_twop, SLICE_GEOM, CLI_GEOM)
    thrp = c6_counted("12", phase_threep_loops, twop, SLICE_GEOM, CLI_GEOM)
    m16 = c6_counted("16", phase_mesh_rest, twop.pop("refs"), twop["u"],
                     SLICE_GEOM, CHECK_GEOM)
    del twop["u"]
    lv = c6_counted("13", phase_mg_levels, SLICE_GEOM, LIGHT_GEOM,
                    LIGHT_PROBE_GEOM, CLI_GEOM, mg6)
    kr = c6_counted("14", phase_krylov, SLICE_GEOM, CHECK_GEOM, LIGHT_GEOM)
    dws = c6_counted("15", phase_dw_staggered, SLICE_GEOM)
    err_17 = phase_box_kernels((CHECK_GEOM, SLICE_GEOM))
    t17 = phase_box_timing(SLICE_GEOM)
    box = phase_box_ranks(SLICE_GEOM, CHECK_GEOM)
    t18 = time.perf_counter()
    ns, ns_launches, err_18a = c6_counted("18a", phase_mg_compact,
                                          SLICE_GEOM, mg6)
    mg48, mg48_launches, _, err_18b, t18b = c6_counted("18b", phase_mg48,
                                                       BIG_GEOM)
    print(f"phase 18 {time.perf_counter() - t18:.1f} s", flush=True)
    k4 = mesh_runs[False]["k4"] + mesh_runs[True]["k4"] + m16["k4"]
    k4_post = (mesh_runs[False]["k4_post"] + mesh_runs[True]["k4_post"]
               + m16["k4_post"])
    if not k4_post:
        raise AssertionError("K4 with the second output: no launch on the "
                             "sharded paths")
    k5 = mesh_runs[True]["k5"] + m16["k5"]
    k1_8 = cmix["k1"] + cmix["k1d_sloppy_run"]["k1"] + big["k1"]
    k1d_8 = cmix["k1d"] + cmix["k1d_sloppy_run"]["k1d"] + big["k1d"]
    print(f"dslash_ch launches: CG path {k['launches']}, MG path "
          f"{launches['dslash_ch']}, mixed path (double) {mixed['k1']}, "
          f"phase 8 {k1_8}; bf16 (K1d): mixed path {mixed['k1d']}, "
          f"bf16-tier paths {k1d_paths}, phase 8 {k1d_8}; K2d: {k2d_paths}; "
          f"K1e: bench_bf16_spinor {spin['k1e']}, compact sloppy "
          f"{cmix['k1e']}; K3: bench_recon8 {spin['k3']}; K4: sharded "
          f"path {k4}; K5: sharded path {k5}; 2pt path: K1 {twop['k1']}, "
          f"K2 {twop['k2']}; 3pt and loops: K1 {thrp['k1']}, K2 "
          f"{thrp['k2']}; production MG (phase 13): K1 {lv['k1']}, K2 "
          f"{lv['k2']}; K4 with the second output (of K4's): {k4_post}; "
          f"Krylov tail and doublet (phase 14): K1 {kr['k1']}, "
          f"K2 {kr['k2']}; gauge utilities, domain wall and staggered (phase "
          f"15): K1 {dws['k1']}, K2 {dws['k2']}; sharded MG, Schwarz and "
          f"meshed workflows (phase 16): K1 {m16['k1']}, K4 {m16['k4']}, "
          f"K5 {m16['k5']}; K4 on boxes (phase 17b, four ranks): "
          f"{box['zw']}, bf16 tier {box['zw_bf16']}, with the second "
          f"output {box['zw_post']}; the compact MG tiers (phase 18a): "
          f"K1 {ns_launches['k1']}, K1d {ns_launches['k1d']}, K2 "
          f"{ns_launches['k2']}; MG at 48³×96 (phase 18b): K1 f64 "
          f"{mg48_launches['k1 f64']}, K1d f32_g16 {mg48_launches['k1d']}; "
          f"C6 (6×6 clover) by phase {c6}; M5 on invert's Möbius route "
          f"(phase 20): {dw20['launches']}; the fused CG steps by phase "
          f"{cgk}")
    if not (c6["8d"] and c6["18a"] and c6["18b"]):
        raise AssertionError(f"C6: no launch on a compact path: {c6}")
    print(card)
    print(f"whole script {time.perf_counter() - T_START:.1f} s", flush=True)
    hop16 = times["K1d bare hop"]

    def entry(name, source, replaces, launches, err, ms, plain_ms, bound):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound[0], "bound_by": bound[1],
                "library_ms": None}
    print(json.dumps({"kernels": [
        entry("dslash_ch", KERNEL_SOURCE,
              f"{KERNEL_REPLACES}; {V1_REPLACES}; {V2_REPLACES}",
              k["launches"] + launches["dslash_ch"] + mixed["k1"] + k1_8
              + twop["k1"] + thrp["k1"] + lv["k1"] + kr["k1"] + dws["k1"]
              + m16["k1"] + ns_launches["k1"] + mg48_launches["k1 f64"],
              max(max_abs, k["max_abs_err"], err_48["K1"], vk["v1"][3],
                  vk["v2"][3], tbc["k1"], twop["err"]["k1"],
                  thrp["err"]["k1"], lv["err"]["k1"], kr["err"]["k1"],
                  dws["err"]["k1"], m16["err"]["k1"]),
              k["ms"],
              k["plain_ms"],
              k["bound"]),
        entry("dslash_ch_msrc", MSRC_KERNEL_SOURCE, MSRC_KERNEL_REPLACES,
              launches["dslash_ch_msrc"] + twop["k2"] + thrp["k2"]
              + lv["k2"] + kr["k2"] + dws["k2"] + ns_launches["k2"],
              max(k2["max_abs_err"], err_time["chain f32"], tbc["k2"],
                  twop["err"]["k2"], thrp["err"]["k2"], lv["err"]["k2"],
                  kr["err"]["k2"], dws["err"]["k2"]),
              k2["ms"], k2["plain_ms"], k2["bound"]),
        entry("dslash_ch_bf16", BF16_KERNEL_SOURCE,
              f"{BF16_KERNEL_REPLACES}; {V2_BF16_REPLACES}",
              mixed["k1d"] + k1d_paths + k1d_8 + ns_launches["k1d"],
              max(err_16["k1d"], err_time["k1d"], err_8a["k1d"],
                  cmix["err"]["K1d"], err_48["K1d"], vk["v2 bf16"][3],
                  tbc["k1d"], err_18a["K1d"]),
              hop16["bf16"], hop16["plain"], bounds["K1d bare hop"]),
        entry("dslash_ch_bf16 f32_g16 clover fwd + xpay at 48³×96",
              BF16_KERNEL_SOURCE, BF16_KERNEL_REPLACES,
              mg48_launches["k1d"], err_18b["K1d"], *t18b),
        entry("dslash_ch_msrc_bf16", BF16_KERNEL_SOURCE,
              BF16_MSRC_KERNEL_REPLACES, k2d_paths,
              max(err_16["k2d"], err_time["k2d"], err_time["chain bf16"],
                  tbc["k2d"]),
              k2d["ms"], k2d["plain_ms"], k2d["bound"]),
        entry("dslash_ch_bf16s", BF16S_KERNEL_SOURCE, BF16S_KERNEL_REPLACES,
              spin["k1e"] + cmix["k1e"],
              max(err_8a["k1e"], spin["err"]["k1e"], cmix["err"]["K1e"],
                  tbc["k1e"]),
              spin["times"]["K1e"],
              spin["times"]["K1e plain"], spin["bounds"]["k1e"]),
        entry("dslash_ch_r8", R8_KERNEL_SOURCE, R8_KERNEL_REPLACES,
              spin["k3"], max(err_8a["k3"], spin["err"]["k3"]),
              spin["times"]["K3"], spin["times"]["K3 plain"],
              spin["bounds"]["k3"]),
        entry("dslash_ch_local", LOCAL_KERNEL_SOURCE, LOCAL_KERNEL_REPLACES,
              k4, max(err_9a["k4"], t9["err"]["k4"], tbc["k4"],
                      m16["err"]["k4"]),
              t9["times"]["K4"],
              t9["times"]["K4 plain"], t9["bounds"]["K4"]),
        entry("dslash_ch_overlap", LOCAL_KERNEL_SOURCE,
              OVERLAP_KERNEL_REPLACES, k5,
              max(err_9a["k5"], t9["err"]["k5"], tbc["k5"],
                  m16["err"]["k5"]),
              t9["times"]["K5"], t9["times"]["K5 plain"],
              t9["bounds"]["K5"]),
        entry("dslash_ch_local_post", LOCAL_KERNEL_SOURCE,
              LOCAL_KERNEL_REPLACES, k4_post, t9["err"]["k4_post"],
              t9["times"]["K4 + post"], t9["times"]["K4 + post plain"],
              t9["bounds"]["K4 + post"]),
        entry("dslash_ch_box", BOX_KERNEL_SOURCE, LOCAL_KERNEL_REPLACES,
              box["zw"], max(err_17["f32"], box["err"]),
              *t17[f"box {BOX_TIME[-1]} f32"]),
        entry("dslash_ch_box_post", BOX_KERNEL_SOURCE, LOCAL_KERNEL_REPLACES,
              box["zw_post"], err_17["post"],
              *t17[f"box {BOX_TIME[-1]} f32 post"]),
        entry("dslash_ch_box_bf16", BOX_KERNEL_SOURCE, LOCAL_KERNEL_REPLACES,
              box["zw_bf16"], err_17["bf16"],
              *t17[f"box {BOX_TIME[-1]} bf16"]),
        entry("clover_ch bf16 A, f32 psi at 48³×96", CLOVER_KERNEL_SOURCE,
              CLOVER_KERNEL_REPLACES, sum(c6.values()), err_c6, *t_c6),
        entry("mobius5_ch at 48³×24, Ls 24", MOBIUS5_KERNEL_SOURCE,
              MOBIUS5_KERNEL_REPLACES, dw20["launches"], err_m5, *t_m5),
        entry("blas_cg, one fused float32 iteration at 48³×24, Ls 24",
              CG_KERNEL_SOURCE, CG_KERNEL_REPLACES, sum(cgk.values()),
              err_cg, *t_cg)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--box-rank":
        _import_port()
        _box_rank(int(sys.argv[2]), Path(sys.argv[3]))
    else:
        main()
