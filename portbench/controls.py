"""The controls of the comparison (``check``): what each compared number
reads when the plain reference, or the program's own lower-precision
path, takes the program's place one precision below what the
configuration states.  A control has to fail its limit; its reading is
the upper end a limit is set below.

  tmc32 (complex64, TF32 off in the program's products): the reference
      in TF32 — the inputs of every product rounded to a 10-bit
      mantissa, float32 sums.  true_res: its CG on the normal equations,
      run to the configuration's tolerance; galerkin: its V†MV on the
      set-up's V; v_ortho: its CholQR² of Gaussian vectors of V's shape.
      null_hop: the program's set-up with its null-vector solves cut,
      Gaussian vectors in their place (``setup_mg(null_vectors=)``),
      judged through ``check.compare`` as a window's set-up is.
  tmc48 (a float64 outer): the program's own route with the exact
      operator of the outer in float32 (``exact_dtype``).

    python3 -m portbench.controls --workload <cell> --seeds a,b,c \
        [--solves n]

prints one JSON line a seed with each number.  It runs on the card; the
tests run it on a tiny lattice on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from portbench import mix
from portbench.check import reference_operator
from portbench.gauge import config_gauge, derive_seed
from portbench.layout import point_source, spinor_to_canonical, spinor_to_lex
from portbench.reference.solver import cgnr


def tf32(t: torch.Tensor) -> torch.Tensor:
    """Round float32 (or the parts of complex64) to TF32's 10-bit
    mantissa, to nearest, ties to even."""
    z = t.to(torch.complex64) if t.is_complex() else t.to(torch.float32)
    z = z.resolve_conj().contiguous()
    r = torch.view_as_real(z) if z.is_complex() else z
    i = r.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & -0x2000
    out = i.view(torch.float32)
    return torch.view_as_complex(out) if z.is_complex() else out


def solve_reading(cfg: dict, u: torch.Tensor, item: dict, maxiter: int
                  ) -> dict:
    """The reference in TF32 solves the item's first column; its answer
    is judged as the program's is."""
    ref = reference_operator(cfg, u)
    low = reference_operator(cfg, u, dtype=torch.complex64, round_fn=tf32,
                             keep_clover=True)
    spin, colour = item["columns"][0]
    b = point_source(cfg["lattice"], item["coords"], spin, colour,
                     torch.complex128, u.device)
    x, iters = cgnr(low, spinor_to_lex(b, cfg["lattice"][0]),
                    cfg["solve"]["tol"], maxiter)
    return {"true_res": ref.residual(spinor_to_canonical(x), b),
            "cg_iters": iters}


def ortho_reading(shape, seed: int, device) -> float:
    """CholQR² in TF32 of Gaussian vectors [..., nvec, bdof], judged in
    complex128."""
    from portbench.reference.galerkin import orthonormality_gap
    gen = torch.Generator(device="cpu").manual_seed(derive_seed(seed, 30))
    v = torch.complex(torch.randn(shape, generator=gen),
                      torch.randn(shape, generator=gen)).to(device)
    for _ in range(2):
        g = torch.matmul(tf32(v), tf32(v).mH)
        low = torch.linalg.cholesky(g)
        v = torch.linalg.solve_triangular(tf32(low), tf32(v), upper=False)
    return orthonormality_gap(v)


def galerkin_reading(cfg: dict, u: torch.Tensor, outputs, seed: int
                     ) -> float:
    """``check.galerkin_gap`` of the reference's own V†MV in TF32 on the
    set-up's V: its coarse matrices computed column by column would
    take the program's place; probing them equals applying the TF32
    product to the same random fields."""
    from portbench.reference.galerkin import prolong, restrict
    v, _, _, nvec, block = outputs
    ref = reference_operator(cfg, u)
    low = reference_operator(cfg, u, dtype=torch.complex64, round_fn=tf32)
    gen = torch.Generator(device="cpu").manual_seed(derive_seed(seed, 20))
    shape = (2, nvec) + tuple(v.shape[1:5])
    worst = 0.0
    for _ in range(2):
        e = torch.complex(torch.randn(shape, generator=gen,
                                      dtype=torch.float64),
                          torch.randn(shape, generator=gen,
                                      dtype=torch.float64)).to(v.device)
        want = restrict(v, ref.apply_lex(prolong(v, e, block)), block)
        vl = tf32(v)
        got = restrict(vl, low.apply_lex(tf32(prolong(vl, tf32(e), block))),
                       block)
        worst = max(worst, float(torch.linalg.vector_norm(
            got.to(torch.complex128) - want)
            / torch.linalg.vector_norm(want)))
    return worst


def run_controls(cfg: dict, traffic: dict, seed: int, solves: int, device,
                 use_kernels: bool = True, maxiter: int = 500) -> dict:
    """Every control reading of one seed for a cell of ``cfg`` and
    ``traffic``, on the window's first ``solves`` items (none: the
    set-up's readings alone).  A cell of set-ups also gives the
    program's own set-up numbers (``sound``), judged through
    ``check.compare``, beside its controls."""
    import importlib
    import time
    from portbench.check import compare
    out = {"seed": seed}
    items = mix.items(traffic, cfg["lattice"], seed, mix.WINDOW)
    route = importlib.import_module(f"portbench.routes.{cfg['route']}")
    picked = [next(items) for _ in range(max(solves, 1))]
    if cfg["route"] == "mg_dc":
        # the program's own path one precision down: a float32 outer
        low = dict(cfg, solve=dict(cfg["solve"], exact_dtype="float32"))
        u = config_gauge(cfg, mix.run_gauge_seed(traffic, seed), device)
        gen = torch.Generator(device=device).manual_seed(
            derive_seed(mix.run_gauge_seed(traffic, seed), 1))
        state = route.build(low, u, gen, use_kernels)
        del u
        xs = []
        for item in picked:
            spin, colour = item["columns"][0]
            b = point_source(cfg["lattice"], item["coords"], spin, colour,
                             torch.complex128, device)
            xs.append(route.solve(state, b))
        route.release(state)
        del state
        u = config_gauge(cfg, mix.run_gauge_seed(traffic, seed), device)
        ref = reference_operator(cfg, u)
        out["true_res"] = []
        for item, (x, info) in zip(picked, xs):
            spin, colour = item["columns"][0]
            b = point_source(cfg["lattice"], item["coords"], spin, colour,
                             torch.complex128, device)
            out["true_res"].append(ref.residual(x, b))
            out.setdefault("restarts", []).append(info.get("restarts"))
        return out
    per_unit = traffic["unit"] == "configuration"
    for item in picked[:solves]:
        gs = (item["gauge_seed"] if per_unit
              else mix.run_gauge_seed(traffic, seed))
        u = config_gauge(cfg, gs, device)
        r = solve_reading(cfg, u, item, maxiter)
        out.setdefault("true_res", []).append(r["true_res"])
        out.setdefault("cg_iters", []).append(r["cg_iters"])
    if per_unit:
        item = picked[0]
        u = config_gauge(cfg, item["gauge_seed"], device)
        gen = torch.Generator(device=device).manual_seed(
            derive_seed(item["gauge_seed"], 1))
        state = route.build(cfg, u, gen, use_kernels)
        outputs = route.setup_outputs(state)
        route.release(state)
        del state
        t0 = time.perf_counter()
        payload = {"gauge_seed": item["gauge_seed"], "outputs": outputs}
        out["sound"] = {n: v for n, v, _, _ in compare(
            cfg, {"setup": [(item, payload)]}, seed, device)}
        out["sound_check_s"] = time.perf_counter() - t0
        del payload
        out["galerkin"] = galerkin_reading(cfg, u, outputs, seed)
        out["v_ortho"] = ortho_reading(tuple(outputs[0].shape), seed,
                                       device)
        del outputs
        out.update(null_reading(cfg, u, item, seed, device, use_kernels))
    return out


def gaussian_null_vectors(cfg: dict, nvec: int, seed: int, device) -> list:
    """``nvec`` Gaussian fields [2, 4, 3, T, Z, W] in complex64."""
    xx, yy, zz, tt = cfg["lattice"]
    gen = torch.Generator(device=device).manual_seed(derive_seed(seed, 31))
    shape = (2, 4, 3, tt, zz, yy * xx // 2)
    return [torch.complex(torch.randn(shape, generator=gen, device=device),
                          torch.randn(shape, generator=gen, device=device))
            for _ in range(nvec)]


def null_reading(cfg: dict, u: torch.Tensor, item: dict, seed: int, device,
                 use_kernels: bool = True) -> dict:
    """The program's set-up with its null-vector solves cut (Gaussian
    vectors in their place), judged through ``check.compare``: its
    ``null_hop`` and whether every set-up number kept its limit."""
    import importlib
    from portbench.check import compare
    route = importlib.import_module(f"portbench.routes.{cfg['route']}")
    gen = torch.Generator(device=device).manual_seed(
        derive_seed(item["gauge_seed"], 1))
    state = route.build(cfg, u, gen, use_kernels,
                        null_vectors=gaussian_null_vectors(
                            cfg, cfg["mg"]["nvec"], seed, device))
    payload = {"gauge_seed": item["gauge_seed"],
               "outputs": route.setup_outputs(state)}
    route.release(state)
    del state
    numbers = compare(cfg, {"setup": [(item, payload)]}, seed, device)
    return {"null_hop": [v for n, v, _, _ in numbers if n == "null_hop"][0],
            "setup_correct": all(v <= lim for _, v, lim, _ in numbers)}


def main(argv=None) -> int:
    from portbench.run import HERE, ROOT, find_cell, load_json
    p = argparse.ArgumentParser(description="the comparison's controls")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--solves", type=int, default=2)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("the controls run on the card", file=sys.stderr)
        return 2
    cell = find_cell(load_json(ROOT / "BENCHMARK.json"), args.workload)
    cfg = load_json(HERE / "configs" / f"{cell['config']}.json")
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    for s in args.seeds.split(","):
        out = run_controls(cfg, traffic, int(s), args.solves,
                           torch.device("cuda", 0))
        out["memory_peak_bytes"] = torch.cuda.max_memory_allocated()
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
