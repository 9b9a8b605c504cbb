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
   the V-cycle's share of a solve.

Without a CUDA device, or without the port's package beside it, it exits
non-zero before printing any result.  The last line of its output is
one JSON object, {"ok": true, "device": {...}}; the line before it holds
the table of both kernels as JSON.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"

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

KERNEL_SOURCE = "quda_qkxtm_multigrid_tpu_torch/csrc/dslash_ch.cu"
KERNEL_REPLACES = "quda_qkxtm_multigrid_tpu/ops/dslash_pallas5.py:30"
MSRC_KERNEL_SOURCE = "quda_qkxtm_multigrid_tpu_torch/csrc/dslash_ch_msrc.cu"
MSRC_KERNEL_REPLACES = "quda_qkxtm_multigrid_tpu/ops/dslash_pallas5.py:960"


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
    """Mean ms per call over ``n`` back-to-back calls (CUDA events)."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / n


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
        for line in so.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {so.stem}:", line.strip())
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
    return {"launches": launches, "ms": tk, "plain_ms": tp,
            "max_abs_err": max_abs}


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
    return {"max_abs_err": max_abs, "ms": tk, "plain_ms": tp, "k1_ms": t1}


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


def main():
    _import_port()
    import torch
    phase_card()
    max_abs = phase_kernel_vs_plain(CHECK_GEOM)
    phase_identities(CHECK_GEOM)
    k = phase_slice(SLICE_GEOM)
    k2 = phase_msrc(CHECK_GEOM, SLICE_GEOM, MSRC_TIME_N)
    launches, _ = phase_mg(SLICE_GEOM)
    print(f"dslash_ch launches: CG path {k['launches']}, MG path "
          f"{launches['dslash_ch']}")
    print(json.dumps({"kernels": [
        {"name": "dslash_ch", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": KERNEL_REPLACES,
         "launches": k["launches"] + launches["dslash_ch"],
         "max_abs_err": max(max_abs, k["max_abs_err"]), "ms": k["ms"],
         "plain_ms": k["plain_ms"]},
        {"name": "dslash_ch_msrc", "route": "cuda",
         "source": MSRC_KERNEL_SOURCE, "replaces": MSRC_KERNEL_REPLACES,
         "launches": launches["dslash_ch_msrc"],
         "max_abs_err": k2["max_abs_err"], "ms": k2["ms"],
         "plain_ms": k2["plain_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
