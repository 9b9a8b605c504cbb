"""The control of ``true_res`` in a Möbius cell (``routes/mobius_cg``):
the program's own route one precision down, its M5 matrices rounded to
bfloat16 (8-bit mantissa) in place of float32, solving the window's
first items' first columns; each answer judged by the reference as a
window's is (``check.compare``).  It has to fail the limit; its reading
is the upper end the limit is set below.

    python3 -m portbench.dw_controls --workload <cell> --seeds a,b,c \
        [--solves n]

prints one JSON line a seed.  It runs on the card; the tests run it on a
tiny lattice on the CPU.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys

import torch

from portbench import mix
from portbench.check import compare
from portbench.gauge import config_gauge, derive_seed
from portbench.units.dw_solve import wall_source


def bf16_matrices(op) -> None:
    """Round the operator's M5 matrices to bfloat16, in place."""
    for name, m in op.mats.items():
        op.mats[name] = m.to(torch.bfloat16).to(m.dtype)


def run_control(cfg: dict, traffic: dict, seed: int, solves: int, device,
                use_kernels: bool = True) -> dict:
    """``true_res`` and CG iterations of the control on the first
    ``solves`` items of ``seed``'s window."""
    route = importlib.import_module(f"portbench.routes.{cfg['route']}")
    gs = mix.run_gauge_seed(traffic, seed)
    u = config_gauge(cfg, gs, device)
    gen = torch.Generator(device=device).manual_seed(derive_seed(gs, 1))
    state = route.build(cfg, u, gen, use_kernels)
    del u
    bf16_matrices(state.op)
    items = mix.items(traffic, cfg["lattice"], seed, mix.WINDOW)
    kept, iters = [], []
    for _ in range(solves):
        item = next(items)
        spin, colour = item["columns"][0]
        b = wall_source(cfg["lattice"], cfg["action"]["ls"], item["coords"],
                        spin, colour, torch.complex64, device)
        x, info = route.solve(state, b)
        del b
        iters.append(info["cg_iters"])
        kept.append((item, {"gauge_seed": gs, "coords": item["coords"],
                            "answers": [(spin, colour, x.cpu())]}))
        del x
    route.release(state)
    del state
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = compare(cfg, {"dw_solution": kept}, seed, device)
    return {"seed": seed, "true_res": [v for _, v, _, _ in numbers],
            "cg_iters": iters}


def main(argv=None) -> int:
    from portbench.run import HERE, ROOT, find_cell, load_json
    p = argparse.ArgumentParser(description="the Möbius cell's control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--solves", type=int, default=1)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    cell = find_cell(load_json(ROOT / "BENCHMARK.json"), args.workload)
    cfg = load_json(HERE / "configs" / f"{cell['config']}.json")
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    device = torch.device("cuda", 0)
    torch.zeros(1, device=device)        # the context, then its stats
    for s in args.seeds.split(","):
        torch.cuda.reset_peak_memory_stats(device)
        out = run_control(cfg, traffic, int(s), args.solves, device)
        out["limit"] = cfg["certify"]["true_res"]
        out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
