"""A gauge configuration a unit: the item's own gauge made from its
seed, the route's operator and MG set-up on it, then that set-up's
solves of the item's columns.  The set-up's outputs are judged too."""

from __future__ import annotations

from portbench.units.solve import solve_columns


def prepare(bench):
    return None


def work(bench, state, item):
    state = bench.build(item["gauge_seed"])
    info, solution = solve_columns(bench, state, item, item["gauge_seed"])
    info["setup_stats"] = state.stats
    setup = {"gauge_seed": item["gauge_seed"],
             "outputs": bench.route.setup_outputs(state)}
    bench.route.release(state)
    return info, {"solution": solution, "setup": setup}
