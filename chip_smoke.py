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
5. the multi-source hop kernel against its plain version and against n
   single-source launches at 16³×32 for n = 1, 3, 8 and every form the
   multigrid setup uses; then timed at 32³×64 with n = 8 against its
   plain version and 8 single-source launches;
6. the MG-GCR-PC solve at 32³×64 on the complex64 operator (block 4⁴,
   nvec 24, even-odd smoother, GCR(5) outer, tol 1e-7): setup split
   into null vectors (through the multi-source kernel), orthonormalisation
   and coarse build; cold and warm solves; the complex128 true residual;
   the kernels' launch counts; restrict and prolong against complex128;
   the V-cycle's share of a solve;
7. the bf16 operand tier (K1d, K2d) and the mixed-precision solve: K1d
   against its plain version at 16³×32 for every form of the bf16 chain
   and the bf16-ψ hop, and against the float32 kernel (the difference
   must show the bf16 rounding); K2d against its plain version and n K1d
   launches, n = 1, 3, 8; the mixed-precision CG at 32³×64 (complex128
   outer through K1's double instance, bf16 sloppy inner through K1d,
   tol 1e-10): restarts, inner iterations, time, the complex128 true
   residual, peak memory, launch counts; the same solve with the
   complex64 sloppy operator and with mixed BiCGstab; the split of a
   bf16 solve into inner and outer matvecs and complex128 stages; K1d
   and K2d timed at 32³×64 against their plain versions and the float32
   kernels (K2d also in the bare form); then a bf16-tier CG and a
   multi-source solve on the bf16 tier at 16³×32;
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
   solution, warm seconds, launch counts); (c) K4 and K5 against their
   plain versions on (b)'s operands at T_loc = 64 (the chain's float32
   forms, the float64 hop), then K4, K5, K1 and the plain versions timed
   in one call at 32³×64, with the byte bounds.

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
MSRC_NS = (1, 3, 8)     # batch widths of the multi-source kernel check
MSRC_VS_K1_LIMIT = 1e-6  # multi-source kernel vs n single-source launches
MSRC_TIME_N = 8         # the null-vector setup's batch width
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

BIG_GEOM = (48, 48, 48, 96)
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


def _import_port():
    sys.path.insert(0, str(ROOT))
    import quda_qkxtm_multigrid_tpu_torch as pkg
    where = Path(pkg.__file__).resolve().parent.parent
    if where != ROOT:
        raise RuntimeError(f"the port was imported from {where}, not from "
                           f"this checkout ({ROOT})")


def _rel(a, b) -> float:
    return float((a - b).norm() / b.norm())


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
    import torch
    kernel(), plain()
    torch.cuda.synchronize()
    tk, tp = [], []
    for _ in range(reps):
        tp.append(_time_ms(plain, n_plain))
        tk.append(_time_ms(kernel, n_kernel))
    return statistics.median(tk), statistics.median(tp)


def _bound(nbytes: int, flops: int):
    """(least ms, "bytes" or "operations") of a kernel that moves
    ``nbytes`` (each input read once, each output written once) and does
    ``flops`` float32 operations."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
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


def _msrc_kwargs(c, x_b, cinv, p):
    import torch
    from quda_qkxtm_multigrid_tpu_torch.ops.dslash_kernel import (
        clover_channels)
    kw = dict(dagger=c.get("dagger", False), recon12=True,
              twist=c.get("twist"))
    if "xpay" in c:
        kw.update(xpay_coef=c["xpay"], x_ch=x_b)
    if "clover" in c:
        kw.update(clover=c["clover"],
                  cinv_ch=clover_channels(cinv, p, torch.float32))
    return kw


def phase_msrc(check_dims, time_dims, n_time: int):
    """K2 against its plain version and against n K1 launches for every
    form and n in MSRC_NS at ``check_dims``; then timed at ``time_dims``
    with ``n_time`` sources.  Returns the largest absolute error and the
    times."""
    import torch
    from quda_qkxtm_multigrid_tpu_torch.benchmarks import tmc_params
    from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry
    from quda_qkxtm_multigrid_tpu_torch.ops.clover import make_clover_pair
    from quda_qkxtm_multigrid_tpu_torch.ops.dslash import double_gauge
    from quda_qkxtm_multigrid_tpu_torch.ops.dslash_kernel import (
        dslash_ch, dslash_ch_msrc, dslash_ch_msrc_reference, gauge_channels,
        to_channels)
    from quda_qkxtm_multigrid_tpu_torch.utils import rng

    kappa = 0.115
    a = 2 * kappa * 0.05
    cases = _msrc_cases(a, 1 / (1 + a * a), -kappa * kappa)

    def fields(dims, n, seed):
        geom = Geometry(*dims)
        gen = torch.Generator(device=DEVICE).manual_seed(seed)
        u = rng.random_gauge(gen, geom)
        _, cinv = make_clover_pair(u, geom, tmc_params())
        ud = double_gauge(u, geom)
        g = [gauge_channels(ud, p, True, torch.float32) for p in (0, 1)]
        del u, ud
        psi = torch.stack([to_channels(rng.random_spinor(gen, geom)[0])
                           for _ in range(n)]).to(torch.float32)
        x = torch.stack([to_channels(rng.random_spinor(gen, geom)[0])
                         for _ in range(n)]).to(torch.float32)
        return geom, g, cinv, psi, x

    print(f"phase 5: multi-source kernel vs plain and vs n single-source "
          f"launches at {check_dims}", flush=True)
    max_abs = 0.0
    geom, g, cinv, psi_all, x_all = fields(check_dims, max(MSRC_NS), 5)
    for n in MSRC_NS:
        psi_b, x_b = psi_all[:n].contiguous(), x_all[:n].contiguous()
        for label, c in cases:
            p = c["parity"]
            kw = _msrc_kwargs(c, x_b, cinv, p)
            before = dslash_ch_msrc.launches
            got = dslash_ch_msrc(g[p], psi_b, p, geom, **kw)
            torch.cuda.synchronize()
            if dslash_ch_msrc.launches != before + 1:
                raise AssertionError("dslash_ch_msrc did not count its launch")
            ref = dslash_ch_msrc_reference(g[p], psi_b, p, geom, **kw)
            max_abs = max(max_abs, _compare(got, ref, f"n={n} {label}",
                                            F32_LIMIT))
            kw1 = {k: v for k, v in kw.items() if k != "x_ch"}
            singles = torch.stack([
                dslash_ch(g[p], psi_b[i], p, geom,
                          x_ch=None if "x_ch" not in kw else x_b[i], **kw1)
                for i in range(n)])
            _check(f"n={n} {label} vs {n} single-source launches",
                   _rel(got, singles), MSRC_VS_K1_LIMIT)
    del g, cinv, psi_all, x_all

    print(f"  timed at {time_dims} with n={n_time} (clover fwd + xpay, the "
          "second hop of the forward matpc)", flush=True)
    geom, g, cinv, psi_b, x_b = fields(time_dims, n_time, 6)
    c = dict(cases)["clover fwd + xpay"]
    kw = _msrc_kwargs(c, x_b, cinv, 0)
    kw1 = {k: v for k, v in kw.items() if k != "x_ch"}
    k2 = lambda: dslash_ch_msrc(g[0], psi_b, 0, geom, **kw)
    plain = lambda: dslash_ch_msrc_reference(g[0], psi_b, 0, geom, **kw)
    k1s = lambda: [dslash_ch(g[0], psi_b[i], 0, geom, x_ch=x_b[i], **kw1)
                   for i in range(n_time)]
    max_abs = max(max_abs, _compare(k2(), plain(), f"n={n_time} at "
                                    f"{time_dims}", F32_LIMIT))
    tk, tp = _compare_timed(k2, plain, n_kernel=10, n_plain=1)
    t1, _ = _compare_timed(k1s, plain, n_kernel=10, n_plain=1)
    print(f"  multi-source kernel {tk:.4f} ms ({tk / n_time:.4f} ms a "
          f"source)  {n_time} single-source launches {t1:.4f} ms  plain "
          f"{tp:.4f} ms", flush=True)
    bound = _bound(_nbytes(g[0], kw["cinv_ch"], psi_b, x_b, psi_b),
                   n_time * (HOP_FLOPS + CLOVER_FLOPS + XPAY_FLOPS)
                   * geom.half_volume)
    return {"max_abs_err": max_abs, "ms": tk, "plain_ms": tp, "k1_ms": t1,
            "bound": bound}


def phase_mg(geom_dims):
    """MG-GCR-PC on the complex64 twisted-clover problem through
    ``benchmarks.bench_mg``: setup (null vectors through the
    multi-source kernel), a cold and a warm solve, the complex128
    certificate; then restrict and prolong against complex128 and the
    V-cycle's share of a third solve.  Returns the kernel launch counts
    of the run and the benchmark's record."""
    import torch
    from quda_qkxtm_multigrid_tpu_torch.benchmarks import (
        bench_mg, make_problem)
    from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry
    from quda_qkxtm_multigrid_tpu_torch.mg.multigrid import mg_solve
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
    rec["split"] = {"total": total, **parts}
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
        dslash_ch, dslash_ch_msrc, dslash_ch_msrc_reference,
        dslash_ch_reference, to_channels)
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

    msrc = _msrc_cases(a, 1 / (1 + a * a), -kappa * kappa)
    n_max = max(MSRC_NS)
    src = torch.stack([to_channels(rng.random_spinor(gen, geom)[0])
                       for _ in range(n_max)]).to(f32)
    xs = torch.stack([to_channels(rng.random_spinor(gen, geom)[0])
                      for _ in range(n_max)]).to(f32)
    for n in MSRC_NS:
        psi_b, x_b = src[:n].contiguous(), xs[:n].contiguous()
        for label, c in msrc:
            p = c["parity"]
            kw = _bf16_kwargs(c, ops[b16], x_b, p)
            kw.pop("post_op")
            before = dslash_ch_msrc.launches_bf16
            got = dslash_ch_msrc(ops[b16]["g"][p], psi_b, p, geom, **kw)
            torch.cuda.synchronize()
            if dslash_ch_msrc.launches_bf16 != before + 1:
                raise AssertionError("dslash_ch_msrc did not count its "
                                     "bf16 launch")
            ref = dslash_ch_msrc_reference(ops[b16]["g"][p], psi_b, p, geom,
                                           **kw)
            max_abs["k2d"] = max(max_abs["k2d"], _compare(
                got, ref, f"bf16 n={n} {label}", F32_LIMIT))
            kw1 = {k: v for k, v in kw.items() if k != "x_ch"}
            singles = torch.stack([
                dslash_ch(ops[b16]["g"][p], psi_b[i], p, geom,
                          x_ch=None if "x_ch" not in kw else x_b[i], **kw1)
                for i in range(n)])
            _check(f"bf16 n={n} {label} vs {n} K1d launches",
                   _rel(got, singles), MSRC_VS_K1_LIMIT)
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
    """K1d (bare hop, matpc†matpc chain) and K2d (n sources, clover fwd
    + xpay) at ``geom_dims``, each timed in turns against its plain
    version and against the float32 kernel of the same form, and the
    multi-source matpc† half of both tiers.  Returns the medians, the
    bounds and each kernel's largest absolute error against its plain
    version here, {"k1d": .., "k2d": ..}."""
    import torch
    from quda_qkxtm_multigrid_tpu_torch.benchmarks import make_problem
    from quda_qkxtm_multigrid_tpu_torch.dirac import (
        _ch_clover_apply, _ch_matrix_apply, as_sloppy)
    from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry
    from quda_qkxtm_multigrid_tpu_torch.ops.dslash_kernel import (
        dslash_ch, dslash_ch_msrc, dslash_ch_msrc_reference,
        dslash_ch_reference, to_channels)
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

    def turns(name, fns, n_runs, reps=5):
        for fn in fns.values():
            fn()
        torch.cuda.synchronize()
        times = {k: [] for k in fns}
        for _ in range(reps):
            for k, fn in fns.items():
                times[k].append(_time_ms(fn, n_runs[k]))
        med = {k: statistics.median(t) for k, t in times.items()}
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
    psi_b = torch.stack([to_channels(rng.random_spinor(
        gen, geom, torch.complex64)[0]) for _ in range(n_time)])
    x_b = torch.stack([to_channels(rng.random_spinor(
        gen, geom, torch.complex64)[0]) for _ in range(n_time)])
    kw = dict(recon12=True, clover="fwd", xpay_coef=-0.115 ** 2, x_ch=x_b)
    err["k2d"] = _compare(
        dslash_ch_msrc(o16["g"][0], psi_b, 0, geom, cinv_ch=o16["ci"][0],
                       **kw),
        dslash_ch_msrc_reference(o16["g"][0], psi_b, 0, geom,
                                 cinv_ch=o16["ci"][0], **kw),
        f"K2d n={n_time} at {geom_dims}", F32_LIMIT)
    turns(f"K2d n={n_time} clover fwd + xpay", {
        "bf16": lambda: dslash_ch_msrc(o16["g"][0], psi_b, 0, geom,
                                       cinv_ch=o16["ci"][0], **kw),
        "plain": lambda: dslash_ch_msrc_reference(
            o16["g"][0], psi_b, 0, geom, cinv_ch=o16["ci"][0], **kw),
        "f32": lambda: dslash_ch_msrc(o32["g"][0], psi_b, 0, geom,
                                      cinv_ch=o32["ci"][0], **kw)},
        {"bf16": 10, "plain": 1, "f32": 10})
    # the bare form of the same batch: what the epilogue's loads cost
    turns(f"K2d n={n_time} bare hop", {
        "bf16": lambda: dslash_ch_msrc(o16["g"][0], psi_b, 0, geom,
                                       recon12=True),
        "f32": lambda: dslash_ch_msrc(o32["g"][0], psi_b, 0, geom,
                                      recon12=True)},
        {"bf16": 10, "f32": 10})
    # the multi-source matpc† half of the solve: a plain A⁻¹† on the
    # batch (its matrices kept on the operator), then two K2d launches
    turns(f"msrc matpc† half n={n_time}", {
        "bf16": lambda: s._fused_matpc_ch_msrc(psi_b, True),
        "f32": lambda: d._fused_matpc_ch_msrc(psi_b, True)},
        {"bf16": 5, "f32": 5})
    # its leading A⁻¹† alone (bf16 tier): with the kept matrices, and with
    # the matrices widened and rebuilt from the bf16 operand on each call
    kept = s._clover_matrix(f32, pr)
    turns(f"msrc leading A⁻¹† n={n_time}", {
        "kept": lambda: _ch_matrix_apply(psi_b, kept, dag=True),
        "rebuilt": lambda: _ch_clover_apply(psi_b, o16["ci"][pr], dag=True)},
        {"kept": 5, "rebuilt": 5})
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
            * sites),
        f"K2d n={n_time} clover fwd + xpay": _bound(
            _nbytes(o16["g"][0], o16["ci"][0], psi_b, x_b, psi_b),
            n_time * (HOP_FLOPS + CLOVER_FLOPS + XPAY_FLOPS) * sites),
        f"K2d n={n_time} bare hop": _bound(
            _nbytes(o16["g"][0], psi_b, psi_b), n_time * HOP_FLOPS * sites)}
    for name, (ms, by) in bounds.items():
        print(f"  {name} bound {ms:.4f} ms ({by}); kernel at "
              f"{ms / out[name]['bf16']:.2f} of it", flush=True)
    return out, bounds, err


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
    from quda_qkxtm_multigrid_tpu_torch import compact
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
         (compact, "_ch_clover_apply", "inner plain A⁻¹† on bf16"),
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
    from quda_qkxtm_multigrid_tpu_torch import compact
    rec["split"] = _split(
        "a third compact solve",
        [(pb.sloppy, "_hop", "hops (K1d)"),
         (compact, "_ch_clover_apply", "plain A, A⁻¹ and A⁻¹† applies"),
         (compact, "_ch_twist", "plain twists")],
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
            dslash_ch.launches = 0
            dslash_ch_local.launches = dslash_ch_overlap.launches = 0
            rec, x = bench_cg_mesh(geom, mesh, overlap, tol=SLICE_TOL,
                                   maxiter=SLICE_MAXITER, problem=(d, b))
            rec.update(k4=dslash_ch_local.launches,
                       k5=dslash_ch_overlap.launches, k1=dslash_ch.launches,
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
                  f"{rec['k4']} K5 {rec['k5']} K1 {rec['k1']}", flush=True)
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
            # or K5: two, interior and edges) and 6 float64 K4 hops:
            # prepare 1, rhs matpc† 2, reconstruct 1, true residual 2
            n = rec["iters"] + rec["iters_cold"]
            want = ((12, 8 * n) if overlap else (4 * n + 12, 0)) + (0,)
            if (rec["k4"], rec["k5"], rec["k1"]) != want:
                raise AssertionError(f"sharded launches K4 {rec['k4']} K5 "
                                     f"{rec['k5']} K1 {rec['k1']} != {want}")
        timing = phase_local_timing(geom, d, mesh)
    finally:
        dist.destroy_process_group()
    return runs, timing


def _main_path_local_checks(ds, mesh, gen):
    """K4 and K5 against their plain versions at the shapes and on the
    operands of the sharded path of 9b (``ds`` on ``mesh``, T_loc =
    geom.T): the four float32 chain hops of the clover matpc halves (K5
    with the projected faces it takes there), and the float64 bare K4 hop
    of the complex128 stages, both parities, with and without dagger.
    Returns the largest absolute errors {"k4": .., "k5": ..}."""
    import torch
    from quda_qkxtm_multigrid_tpu_torch.ops.dslash_kernel import (
        dslash_ch_local, dslash_ch_local_reference, dslash_ch_overlap,
        to_channels)
    from quda_qkxtm_multigrid_tpu_torch.parallel.halo import t_faces
    from quda_qkxtm_multigrid_tpu_torch.utils import rng

    geom, k = ds.geom, ds.params.kappa
    print(f"  K4 / K5 vs plain on the sharded path's operands, T_loc "
          f"{geom.T}", flush=True)
    f32, f64 = torch.float32, torch.float64
    ops = ds._operands(f32)
    psi, x = rng.random_spinor(gen, geom), rng.random_spinor(gen, geom)
    err = {"k4": 0.0, "k5": 0.0}
    for label, c in _msrc_cases(0.0, 1.0, -k * k)[:4]:
        p, dagger = c["parity"], c.get("dagger", False)
        v = to_channels(psi[1 - p]).to(f32)
        kw = dict(dagger=dagger, recon12=True, clover=c.get("clover"),
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
                                recon12=True),
                dslash_ch_local_reference(g64[p], v, *f24, p, geom, dagger,
                                          recon12=True),
                f"K4 f64 hop parity {p} dagger {int(dagger)}", F64_LIMIT))
    torch.cuda.synchronize()
    return err


def phase_local_timing(geom, d, mesh):
    """Phase 9c: K4 and K5 against their plain versions on the sharded
    path's operands (``_main_path_local_checks``); then the bare float32
    K4 hop, K5 (interior and edges, projected faces), K1 and the two
    plain versions, timed in turns in one call (median of 5) at the size
    of 9b, ring of one, with each kernel's output held against its plain
    version's; then each hop with its exchange as the chain runs it, one
    sharded matpc†matpc with each against the unsharded four-hop chain
    and against the sharded chain's own form run unsharded (two matpc
    halves through K1), and that chain's plain leading A⁻¹†.  Returns
    the medians, the byte bounds of K4 and K5 and the largest absolute
    errors against the plain versions."""
    import torch
    from quda_qkxtm_multigrid_tpu_torch.dirac import _ch_matrix_apply
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
    g = ds._operands(f32)["g"][pr]
    v = to_channels(rng.random_spinor(gen, geom)[0]).to(f32)
    f24 = t_faces(v, mesh)
    fm, fp = t_faces(v, mesh, project=True)
    hop = dict(recon12=True)
    fns = {
        "K4": lambda: dslash_ch_local(g, v, *f24, pr, geom, **hop),
        "K5": lambda: dslash_ch_overlap(g, v, fm, fp, pr, geom,
                                        faces_projected=True, **hop),
        "K1": lambda: dslash_ch(g, v, pr, geom, **hop),
        "K4 plain": lambda: dslash_ch_local_reference(g, v, *f24, pr, geom,
                                                      **hop),
        "K5 plain": lambda: dslash_ch_local_reference(
            g, v, fm, fp, pr, geom, faces_projected=True, **hop),
        "K4 hop with its exchange": lambda: halo_hop(mesh, False, g, v, pr,
                                                     geom, **hop),
        "K5 hop with its exchange": lambda: halo_hop(mesh, True, g, v, pr,
                                                     geom, **hop),
        "sharded matpc†matpc, K4": lambda: ds.matpc_ch(
            ds.matpc_ch(v, False, False), True, False),
        "sharded matpc†matpc, K5": lambda: ds.matpc_ch(
            ds.matpc_ch(v, False, True), True, True),
        "unsharded matpc†matpc, K1": lambda: d._fused_matpc_dagm_ch(v),
        "unsharded, the sharded chain": lambda: d._fused_matpc_ch(
            d._fused_matpc_ch(v, False), True),
        "its plain A⁻¹† (kept matrices)": lambda: _ch_matrix_apply(
            v, ds._clover_matrix(f32, pr), dag=True)}
    n_runs = {k: (3 if "plain" in k else 10 if "matpc" in k else 20)
              for k in fns}
    out = {k: fns[k]() for k in ("K4", "K5", "K4 plain", "K5 plain")}
    torch.cuda.synchronize()
    for k in ("K4", "K5"):
        err[k.lower()] = max(err[k.lower()], _compare(
            out[k], out[f"{k} plain"], f"{k} bare hop (timed inputs)",
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
        print(f"  {k:<28s} {t:.4f} ms", flush=True)
    sites = geom.half_volume
    bounds = {"K4": _bound(_nbytes(g, v, *f24, v), HOP_FLOPS * sites),
              "K5": _bound(_nbytes(g, v, fm, fp, v), HOP_FLOPS * sites)}
    for k, (ms, by) in bounds.items():
        print(f"  {k} bound {ms:.4f} ms ({by}); kernel at "
              f"{ms / med[k]:.2f} of it", flush=True)
    return {"times": med, "bounds": bounds, "err": err}


def main():
    _import_port()
    import torch
    phase_card()
    max_abs = phase_kernel_vs_plain(CHECK_GEOM)
    phase_identities(CHECK_GEOM)
    k = phase_slice(SLICE_GEOM)
    k2 = phase_msrc(CHECK_GEOM, SLICE_GEOM, MSRC_TIME_N)
    launches, _ = phase_mg(SLICE_GEOM)
    err_16 = phase_bf16_kernels(CHECK_GEOM)
    mixed = phase_mixed(SLICE_GEOM)
    times, bounds, err_time = phase_bf16_timing(SLICE_GEOM, MSRC_TIME_N)
    k1d_paths, k2d_paths = phase_bf16_paths(CHECK_GEOM)
    err_8a = phase_k1e_k3_kernels(CHECK_GEOM)
    spin = phase_bf16_spinor(SLICE_GEOM, CHECK_GEOM)
    cmix = phase_compact_mixed(SLICE_GEOM)
    big, _, _, _, err_48 = phase_compact48(BIG_GEOM)
    err_9a = phase_local_kernels((CHECK_GEOM, SLICE_GEOM))
    mesh_runs, t9 = phase_mesh_solve(SLICE_GEOM, k["secs"])
    k4 = mesh_runs[False]["k4"] + mesh_runs[True]["k4"]
    k5 = mesh_runs[True]["k5"]
    k1_8 = cmix["k1"] + cmix["k1d_sloppy_run"]["k1"] + big["k1"]
    k1d_8 = cmix["k1d"] + cmix["k1d_sloppy_run"]["k1d"] + big["k1d"]
    print(f"dslash_ch launches: CG path {k['launches']}, MG path "
          f"{launches['dslash_ch']}, mixed path (double) {mixed['k1']}, "
          f"phase 8 {k1_8}; bf16 (K1d): mixed path {mixed['k1d']}, "
          f"bf16-tier paths {k1d_paths}, phase 8 {k1d_8}; K2d: {k2d_paths}; "
          f"K1e: bench_bf16_spinor {spin['k1e']}, compact sloppy "
          f"{cmix['k1e']}; K3: bench_recon8 {spin['k3']}; K4: sharded "
          f"path {k4}; K5: sharded path {k5}")
    print(f"whole script {time.perf_counter() - T_START:.1f} s", flush=True)
    hop16 = times["K1d bare hop"]
    msrc16 = times[f"K2d n={MSRC_TIME_N} clover fwd + xpay"]

    def entry(name, source, replaces, launches, err, ms, plain_ms, bound):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound[0], "bound_by": bound[1],
                "library_ms": None}
    print(json.dumps({"kernels": [
        entry("dslash_ch", KERNEL_SOURCE, KERNEL_REPLACES,
              k["launches"] + launches["dslash_ch"] + mixed["k1"] + k1_8,
              max(max_abs, k["max_abs_err"], err_48["K1"]), k["ms"],
              k["plain_ms"], k["bound"]),
        entry("dslash_ch_msrc", MSRC_KERNEL_SOURCE, MSRC_KERNEL_REPLACES,
              launches["dslash_ch_msrc"], k2["max_abs_err"], k2["ms"],
              k2["plain_ms"], k2["bound"]),
        entry("dslash_ch_bf16", BF16_KERNEL_SOURCE, BF16_KERNEL_REPLACES,
              mixed["k1d"] + k1d_paths + k1d_8,
              max(err_16["k1d"], err_time["k1d"], err_8a["k1d"],
                  cmix["err"]["K1d"], err_48["K1d"]),
              hop16["bf16"], hop16["plain"], bounds["K1d bare hop"]),
        entry("dslash_ch_msrc_bf16", BF16_KERNEL_SOURCE,
              BF16_MSRC_KERNEL_REPLACES, k2d_paths,
              max(err_16["k2d"], err_time["k2d"]),
              msrc16["bf16"], msrc16["plain"],
              bounds[f"K2d n={MSRC_TIME_N} clover fwd + xpay"]),
        entry("dslash_ch_bf16s", BF16S_KERNEL_SOURCE, BF16S_KERNEL_REPLACES,
              spin["k1e"] + cmix["k1e"],
              max(err_8a["k1e"], spin["err"]["k1e"], cmix["err"]["K1e"]),
              spin["times"]["K1e"],
              spin["times"]["K1e plain"], spin["bounds"]["k1e"]),
        entry("dslash_ch_r8", R8_KERNEL_SOURCE, R8_KERNEL_REPLACES,
              spin["k3"], max(err_8a["k3"], spin["err"]["k3"]),
              spin["times"]["K3"], spin["times"]["K3 plain"],
              spin["bounds"]["k3"]),
        entry("dslash_ch_local", LOCAL_KERNEL_SOURCE, LOCAL_KERNEL_REPLACES,
              k4, max(err_9a["k4"], t9["err"]["k4"]), t9["times"]["K4"],
              t9["times"]["K4 plain"], t9["bounds"]["K4"]),
        entry("dslash_ch_overlap", LOCAL_KERNEL_SOURCE,
              OVERLAP_KERNEL_REPLACES, k5, max(err_9a["k5"], t9["err"]["k5"]),
              t9["times"]["K5"], t9["times"]["K5 plain"],
              t9["bounds"]["K5"])]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
