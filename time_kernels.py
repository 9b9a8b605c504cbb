"""Time every hop-kernel form of one or more checkouts of the port in
turns on one NVIDIA GPU, with each kernel's registers and spills.

    python3 time_kernels.py ROOT [ROOT ...] [--dims X Y Z T] [--mg]
                            [--json PATH]

Each ROOT is the root of a checkout (``.`` for this one).  The roots are
run in the order given, each in a process of its own (the checkouts'
packages share a name), so ``old new new old`` times two versions in
turns on the same card.  Every process builds its checkout's kernels
(``_build.build``), makes the same fields from the same seed at
``--dims`` (default 32³×64) and times each form with CUDA events: the
median of 5 runs of 20 launches (10 for the multi-source forms).  The
forms use only the wrappers every version of the port has had since
the t-sharded slice; a form a checkout lacks (the multi-source
``post_op``, the antiperiodic t boundary's sign) is left out of its
column.  The summary gives each form's
mean time per root, the ratio of each root to the first, and the
``ptxas`` registers and spill stores of every kernel instance.  With
``--mg`` each process then runs ``benchmarks.bench_mg`` with the
settings of ``chip_smoke.py`` phase 6 on the same card (setup and its
parts, the warm MG-GCR-PC solve) and times restrict, prolong and the
coarse operator's apply on its transfer.  Without a CUDA device it exits
non-zero.
"""

from __future__ import annotations

import argparse
import inspect
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

N_TIME = (1, 3, 8, 12)   # the multi-source batch widths timed


def _forms(torch, dims) -> dict:
    """{name: callable} of every form at ``dims``, from the checkout
    imported."""
    from quda_qkxtm_multigrid_tpu_torch.benchmarks import tmc_params
    from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry
    from quda_qkxtm_multigrid_tpu_torch.ops import dslash_kernel as dk
    from quda_qkxtm_multigrid_tpu_torch.ops.clover import make_clover_pair
    from quda_qkxtm_multigrid_tpu_torch.ops.dslash import double_gauge
    from quda_qkxtm_multigrid_tpu_torch.parallel.halo import project_face
    from quda_qkxtm_multigrid_tpu_torch.utils import rng

    dev = "cuda"
    geom = Geometry(*dims)
    gen = torch.Generator(device=dev).manual_seed(61)
    u = rng.random_gauge(gen, geom)
    _, cinv = make_clover_pair(u, geom, tmc_params())
    ud = double_gauge(u, geom)
    del u
    f32, f64, b16 = torch.float32, torch.float64, torch.bfloat16
    g = {(dt, r): dk.gauge_channels(ud, 0, r == 12, dt)
         for dt in (f32, f64, b16) for r in (12, 18)}
    g8 = dk.gauge_channels(ud, 0, False, f32, recon8=True)
    ci = {dt: dk.clover_channels(cinv, 0, dt) for dt in (f32, b16)}
    del ud, cinv
    psi = rng.random_spinor(gen, geom)
    v64 = dk.to_channels(psi[1])
    x64 = dk.to_channels(psi[0])
    del psi
    v, x = v64.to(f32), x64.to(f32)
    v16 = v.to(b16)
    nmax = max(N_TIME)
    vb = torch.stack([v * (1 + 0.01 * i) for i in range(nmax)])
    xb = torch.stack([x * (1 - 0.01 * i) for i in range(nmax)])
    xc = -0.115 ** 2
    fm, fp = project_face(v[-1:], True), project_face(v[:1], False)
    hop = dict(recon12=True)
    clov = lambda dt: dict(recon12=True, clover="fwd", cinv_ch=ci[dt],
                           xpay_coef=xc, x_ch=x)
    post = "post_op" in inspect.signature(dk.dslash_ch_msrc).parameters
    forms = {
        "K1 f32 hop": lambda: dk.dslash_ch(g[f32, 12], v, 0, geom, **hop),
        "K1 f32 hop dagger": lambda: dk.dslash_ch(g[f32, 12], v, 0, geom,
                                                  dagger=True, **hop),
        "K1 f32 recon-18 hop (V1)": lambda: dk.dslash_ch(g[f32, 18], v, 0,
                                                         geom),
        "K1 f32 clover fwd + xpay + post": lambda: dk.dslash_ch(
            g[f32, 12], v, 0, geom, post_op=("clover",), **clov(f32)),
        "K1 f64 hop": lambda: dk.dslash_ch(g[f64, 12], v64, 0, geom, **hop),
        "K1d hop": lambda: dk.dslash_ch(g[b16, 12], v, 0, geom, **hop),
        "K1d clover fwd + xpay + post": lambda: dk.dslash_ch(
            g[b16, 12], v, 0, geom, post_op=("clover",), **clov(b16)),
        "K1d g16s16 recon-12 hop (V2 bf16)": lambda: dk.dslash_ch(
            g[b16, 12], v16, 0, geom, **hop),
        "K1d g16s16 recon-18 hop (V2 bf16)": lambda: dk.dslash_ch(
            g[b16, 18], v16, 0, geom),
        "K1e s16o16 hop": lambda: dk.dslash_ch(g[b16, 12], v16, 0, geom,
                                               out_dtype=b16, **hop),
        "K3 hop": lambda: dk.dslash_ch(g8, v, 0, geom, recon8=True),
        "K4 hop": lambda: dk.dslash_ch_local(g[f32, 12], v, v[-1:], v[:1], 0,
                                             geom, **hop),
        "K5 hop": lambda: dk.dslash_ch_overlap(g[f32, 12], v, fm, fp, 0,
                                               geom, faces_projected=True,
                                               **hop)}
    for n in N_TIME:
        psi_b, x_b = vb[:n].contiguous(), xb[:n].contiguous()
        for tier, dt in (("K2", f32), ("K2d", b16)):
            kw = dict(clov(dt), x_ch=x_b)
            forms[f"{tier} n={n} clover fwd + xpay"] = (
                lambda g_=g[dt, 12], p=psi_b, k=kw:
                dk.dslash_ch_msrc(g_, p, 0, geom, **k))
            if post:
                forms[f"{tier} n={n} clover fwd + xpay + post"] = (
                    lambda g_=g[dt, 12], p=psi_b, k=kw:
                    dk.dslash_ch_msrc(g_, p, 0, geom, post_op=("clover",),
                                      **k))
        forms[f"K2 n={n} bare hop"] = (
            lambda p=psi_b: dk.dslash_ch_msrc(g[f32, 12], p, 0, geom, **hop))
    if "antiperiodic" in inspect.signature(dk.dslash_ch).parameters:
        forms.update(_antiperiodic_forms(dk, geom, g, ci, v, v64, v16, vb,
                                         xb, fm, fp, clov))
    return forms


def _antiperiodic_forms(dk, geom, g, ci, v, v64, v16, vb, xb, fm, fp,
                        clov) -> dict:
    """The recon-12 forms again with the antiperiodic t boundary's sign
    (the kernels' work does not depend on the links' values, so the
    periodic fields serve), for a checkout that has it."""
    import torch
    f32, f64, b16 = torch.float32, torch.float64, torch.bfloat16
    ap = dict(recon12=True, antiperiodic=True)
    rows = (0, geom.T - 1)
    n = max(N_TIME)
    forms = {
        "K1 f32 hop, antiperiodic": lambda: dk.dslash_ch(
            g[f32, 12], v, 0, geom, **ap),
        "K1 f32 clover fwd + xpay + post, antiperiodic": lambda: dk.dslash_ch(
            g[f32, 12], v, 0, geom, post_op=("clover",),
            **dict(clov(f32), antiperiodic=True)),
        "K1 f64 hop, antiperiodic": lambda: dk.dslash_ch(
            g[f64, 12], v64, 0, geom, **ap),
        "K1d clover fwd + xpay + post, antiperiodic": lambda: dk.dslash_ch(
            g[b16, 12], v, 0, geom, post_op=("clover",),
            **dict(clov(b16), antiperiodic=True)),
        "K1e s16o16 hop, antiperiodic": lambda: dk.dslash_ch(
            g[b16, 12], v16, 0, geom, out_dtype=b16, **ap),
        "K4 hop, antiperiodic": lambda: dk.dslash_ch_local(
            g[f32, 12], v, v[-1:], v[:1], 0, geom, recon12=True,
            t_boundary=rows),
        "K5 hop, antiperiodic": lambda: dk.dslash_ch_overlap(
            g[f32, 12], v, fm, fp, 0, geom, faces_projected=True,
            recon12=True, t_boundary=rows)}
    for tier, dt in (("K2", f32), ("K2d", b16)):
        kw = dict(clov(dt), x_ch=xb[:n].contiguous(), antiperiodic=True)
        forms[f"{tier} n={n} clover fwd + xpay + post, antiperiodic"] = (
            lambda g_=g[dt, 12], p=vb[:n].contiguous(), k=kw:
            dk.dslash_ch_msrc(g_, p, 0, geom, post_op=("clover",), **k))
    return forms


def _periodic_name(args: str) -> str:
    """A kernel instance's mangled template arguments, with the trailing
    boundary flag of the hops (``APBC``, after the gauge form and the t
    mode) folded in: the periodic instance keeps the name it had before
    the flag, so two trees compare row by row; the antiperiodic one is
    marked."""
    m = re.fullmatch(r"(.*Li(?:8|12|18)E(?:Li\dE)?)Lb([01])E", args)
    if not m:
        return args
    return m.group(1) + (", antiperiodic" if m.group(2) == "1" else "")


def _registers(lib_dir: Path) -> dict:
    """kernel instance → "registers/spill stores", from the ptxas logs."""
    out, kernel = {}, "?"
    for log in sorted(lib_dir.glob("*.log")):
        for line in log.read_text().splitlines():
            m = re.search(r"entry function '_ZN3qkx\d+(\w+?)I(\w*?)EEvNS", line)
            if m:
                args = _periodic_name(m.group(2))
                kernel = f"{log.stem}:{m.group(1)}<{args}>"
            m = re.search(r"Used (\d+) registers", line)
            if m:
                out[kernel] = int(m.group(1))
            m = re.search(r"(\d+) bytes spill stores", line)
            if m and int(m.group(1)):
                out[kernel + " spill stores"] = int(m.group(1))
    return out


def _mg(torch, dims) -> dict:
    """``bench_mg`` at ``dims`` (complex64, block 4⁴, nvec 24, GCR(5),
    tol 1e-7): its seconds and iterations, and the median ms of
    restrict, prolong and the coarse apply."""
    from quda_qkxtm_multigrid_tpu_torch.benchmarks import (
        bench_mg, make_problem, median_ms)
    from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry
    from quda_qkxtm_multigrid_tpu_torch.utils import rng
    geom = Geometry(*dims)
    d, b = make_problem(geom, "cuda", seed=7, dtype=torch.complex64)
    rec, mg = bench_mg(geom, tol=1e-7, nvec=24, block=(4, 4, 4, 4),
                       n_krylov=5, problem=(d, b))
    gen = torch.Generator(device="cuda").manual_seed(13)
    f = rng.random_spinor(gen, geom, torch.complex64)
    tr, vc = mg.transfer, mg.transfer.restrict(f)
    out = {k: rec[k] for k in ("setup_secs", "null_vector_secs",
                               "ortho_secs", "coarse_build_secs",
                               "secs_cold", "secs", "iters", "true_res")}
    out.update({"restrict ms": median_ms(lambda: tr.restrict(f), "cuda"),
                "prolong ms": median_ms(lambda: tr.prolong(vc), "cuda"),
                "coarse apply ms": median_ms(lambda: mg.coarse.apply(vc),
                                             "cuda")})
    return out


def worker(root: Path, dims, mg: bool) -> dict:
    sys.path.insert(0, str(root))
    import torch
    import quda_qkxtm_multigrid_tpu_torch as pkg
    if Path(pkg.__file__).resolve().parent.parent != root:
        raise RuntimeError(f"imported {pkg.__file__}, not from {root}")
    from quda_qkxtm_multigrid_tpu_torch import _build
    from quda_qkxtm_multigrid_tpu_torch.benchmarks import time_ms
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    _build.build()
    forms = _forms(torch, dims)
    for fn in forms.values():
        fn()
    torch.cuda.synchronize()
    times = {k: [] for k in forms}
    for _ in range(5):
        for k, fn in forms.items():
            times[k].append(time_ms(fn, "cuda",
                                    10 if k.startswith("K2") else 20))
    out = {"root": str(root), "device": torch.cuda.get_device_name(0),
           "ms": {k: statistics.median(t) for k, t in times.items()},
           "registers": _registers(_build.library_dir())}
    if mg:
        del forms, fn
        torch.cuda.empty_cache()
        out["mg"] = _mg(torch, dims)
    return out


def _table(runs, key: str, order, fmt: str):
    """Each entry of ``run[key]``: its mean over the runs of each root
    and the ratio to the first root."""
    mean = {root: {} for root in order}
    for root in order:
        mine = [r[key] for r in runs if r["root"] == root]
        for k in mine[0]:
            mean[root][k] = statistics.mean(m[k] for m in mine)
    for k in mean[order[-1]]:
        cells = []
        for root in order:
            t = mean[root].get(k)
            base = mean[order[0]].get(k)
            cells.append("-" if t is None else
                         format(t, fmt) + ("" if root == order[0] or not base
                                           else f" ({t / base:.3f})"))
        print(f"  {k:<40s} " + "  ".join(cells))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--dims", nargs=4, type=int, default=(32, 32, 32, 64))
    ap.add_argument("--mg", action="store_true")
    ap.add_argument("--json", default=None)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    roots = [Path(r).resolve() for r in args.roots]
    if args.worker:
        print(json.dumps(worker(roots[0], tuple(args.dims), args.mg)))
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    runs = []
    for root in roots:
        proc = subprocess.run(
            [sys.executable, __file__, str(root), "--worker", "--dims",
             *map(str, args.dims)] + (["--mg"] if args.mg else []),
            capture_output=True, text=True)
        if proc.returncode != 0:
            sys.stderr.write(proc.stdout + proc.stderr)
            raise SystemExit(f"worker for {root} failed")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(f"timed {root}", flush=True)
    order = list(dict.fromkeys(r["root"] for r in runs))
    print(f"ms at {tuple(args.dims)}, mean over the runs of each root; "
          f"ratio to {order[0]}")
    _table(runs, "ms", order, ".4f")
    if args.mg:
        print("bench_mg (seconds unless marked), mean over the runs of "
              "each root")
        _table(runs, "mg", order, ".4g")
    print("registers (ptxas), per root:")
    regs = {r["root"]: r["registers"] for r in runs}
    for k in sorted(set().union(*regs.values())):
        print(f"  {k:<90s} " + "  ".join(str(regs[root].get(k, "-"))
                                          for root in order))
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(
            {"card": smi, "dims": list(args.dims), "runs": runs}, indent=1))


if __name__ == "__main__":
    main()
