"""Point-source solves on the run's one gauge and MG set-up, made in
set-up: each unit solves its item's columns one after another."""

from __future__ import annotations

import torch

from portbench.layout import point_source


def prepare(bench):
    return bench.build(bench.run_gauge_seed)


def solve_columns(bench, state, item, gauge_seed: int) -> tuple:
    """(info, the ``solution`` payload) of the item's columns solved on
    ``state``: info sums what each solve reports."""
    info, answers = {"solves": 0}, []
    for spin, colour in item["columns"]:
        b = point_source(bench.dims, item["coords"], spin, colour,
                         torch.complex128, bench.device)
        x, got = bench.route.solve(state, b)
        for k, v in got.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                info[k] = info.get(k, 0) + v
        info["solves"] += 1
        answers.append((spin, colour, x))
    return info, {"gauge_seed": gauge_seed, "coords": item["coords"],
                  "answers": answers}


def work(bench, state, item):
    info, solution = solve_columns(bench, state, item, bench.run_gauge_seed)
    return info, {"solution": solution}
