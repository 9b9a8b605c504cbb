"""Möbius domain-wall solves of wall sources on the run's one gauge and
operator, made in set-up: each unit solves its item's columns one after
another.  A column's 5D source is the wall source of a point: P_L η on
s = 0 and P_R η on s = Ls − 1, η the unit point source of
``layout.point_source``, P_L = (1 + γ5)/2 and P_R = (1 − γ5)/2 with γ5 =
diag(1, 1, −1, −1) (spins 0-1 on the first wall, 2-3 on the last), made
in complex64 on the device.  Each answer stays on the device for the
comparison (``checks/dw_solution.py``), which the window's sample keeps
one of (6.1 GB at 48³×24, Ls 24): a copy to host memory took ~3.4 s of
each ~14-s unit on an H100 (PERF.md section 6) and is no work of the
program's."""

from __future__ import annotations

import torch

from portbench.layout import point_source


def prepare(bench):
    return bench.build(bench.run_gauge_seed)


def wall_source(dims, ls: int, coords, spin: int, colour: int, dtype,
                device) -> torch.Tensor:
    """The canonical 5D source [Ls, 2, 4, 3, T, Z, W] of column (spin,
    colour) at ``coords``."""
    eta = point_source(dims, coords, spin, colour, dtype, device)
    b = torch.zeros((ls,) + tuple(eta.shape), dtype=dtype, device=device)
    b[0, :, :2] = eta[:, :2]
    b[ls - 1, :, 2:] = eta[:, 2:]
    return b


def work(bench, state, item):
    xx, yy, zz, tt = bench.dims
    ls = bench.cfg["action"]["ls"]
    info = {"solves": 0, "half_sites5": ls * tt * zz * yy * xx // 2}
    answers = []
    for spin, colour in item["columns"]:
        b = wall_source(bench.dims, ls, item["coords"], spin, colour,
                        torch.complex64, bench.device)
        x, got = bench.route.solve(state, b)
        del b
        info["cg_iters"] = info.get("cg_iters", 0) + got["cg_iters"]
        info["solves"] += 1
        answers.append((spin, colour, x))
    return info, {"dw_solution": {"gauge_seed": bench.run_gauge_seed,
                                  "coords": item["coords"],
                                  "answers": answers}}
