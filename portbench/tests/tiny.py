"""A cell's configuration cut to a tiny lattice, for the CPU tests: the
same route, action, solver and traffic, at 4×4×4×8 with 2⁴ blocks and
four null vectors."""

import copy

from portbench.run import HERE, ROOT, find_cell, load_json

SPEC = load_json(ROOT / "BENCHMARK.json")


def tiny(cell_name: str):
    """(spec, cell, tiny cfg, traffic) of a cell of BENCHMARK.json."""
    cell = find_cell(SPEC, cell_name)
    cfg = copy.deepcopy(load_json(HERE / "configs" /
                                  f"{cell['config']}.json"))
    cfg["lattice"] = [4, 4, 4, 8]
    cfg["mg"]["block"] = [2, 2, 2, 2]
    cfg["mg"]["nvec"] = 4
    cfg["check_sample"]["solution"] = 2
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    return SPEC, cell, cfg, traffic

