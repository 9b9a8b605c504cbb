"""The Möbius cell ``mdwf48i.wall_solves`` end to end on a tiny lattice on
the CPU (4×4×4×8 at Ls 8, the plain hops and M5 passes): it runs its
route through ``invert``, reports its metrics and passes its comparison;
its control (the M5 matrices in bfloat16) fails the limit; the reference
judges a wrong answer wrong."""

import copy
import time

import pytest
import torch

from portbench import dw_controls
from portbench.run import HERE, ROOT, find_cell, load_json, run_cell

SPEC = load_json(ROOT / "BENCHMARK.json")
CELL = "mdwf48i.wall_solves"


def tiny():
    cell = find_cell(SPEC, CELL)
    cfg = copy.deepcopy(load_json(HERE / "configs" /
                                  f"{cell['config']}.json"))
    cfg["lattice"] = [4, 4, 4, 8]
    cfg["action"]["ls"] = 8
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    return cell, cfg, traffic


@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_and_is_correct(trace):
    cell, cfg, traffic = tiny()
    out = run_cell(SPEC, cell, 2**33 + 5, 0.5, bool(trace),
                   torch.device("cpu"), cfg=cfg, traffic=traffic,
                   use_kernels=False, t_start=time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    kind = "per_layer" if trace else "end_to_end"
    names = {m["name"] for m in SPEC[kind]
             if CELL in m.get("workloads", [CELL])}
    assert set(out["metrics"]) <= names
    if trace:
        # the counters and the solver's count read on the CPU; the device
        # readers have nothing to read
        assert out["metrics"]["dw.cg_iters"]["value"] > 10
        # M_pc† M_pc twice a CG iteration, a host read a CG test
        assert out["metrics"]["operator.applies.dw"]["value"] > 20
        assert out["metrics"]["host_reads.dw"]["value"] > 10
        assert "krylov.self_device_s.dw" not in out["metrics"]
    else:
        assert {"setup_s", "solve_s"} <= set(out["metrics"])
    assert all(c["value"] <= c["limit"] for c in out["checks"].values())


def test_control_fails_the_limit():
    _, cfg, traffic = tiny()
    out = dw_controls.run_control(cfg, traffic, 2**33 + 5, 1,
                                  torch.device("cpu"), use_kernels=False)
    limit = cfg["certify"]["true_res"]
    assert all(v > limit for v in out["true_res"]), out


def test_wrong_answer_is_judged_wrong():
    from portbench.check import compare
    from portbench.units.dw_solve import wall_source
    _, cfg, traffic = tiny()
    b = wall_source(cfg["lattice"], 8, (1, 2, 3, 4), 2, 1, torch.complex64,
                    "cpu")
    item = {"index": 0}
    payload = {"gauge_seed": 11, "coords": (1, 2, 3, 4),
               "answers": [(2, 1, b)]}
    (name, value, limit, _), = compare(cfg, {"dw_solution": [(item,
                                                               payload)]},
                                       3, torch.device("cpu"))
    assert name == "true_res" and value > 0.1 > limit
