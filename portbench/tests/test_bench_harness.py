"""The harness end to end on a tiny lattice on the CPU, with the port's
plain hops (``use_kernels=False``): every cell runs its route, reports
its metrics and passes its comparison; a machine without a card gets no
result from the command."""

import itertools
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from portbench.run import HERE, ROOT, load_json, run_cell
from portbench.tests.tiny import tiny

CELLS = ["tmc32.mg_solves", "tmc32.configs", "tmc48.dc_solves"]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_and_is_correct(name, trace):
    spec, cell, cfg, traffic = tiny(name)
    out = run_cell(spec, cell, 2**31 + 99, 0.5, bool(trace),
                   torch.device("cpu"), cfg=cfg, traffic=traffic,
                   use_kernels=False, t_start=time.perf_counter())
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    kind = "per_layer" if trace else "end_to_end"
    names = {m["name"] for m in spec[kind]
             if name in m.get("workloads", [name])}
    # the device readers have nothing to read on the CPU
    assert set(out["metrics"]) <= names
    if not trace:
        assert "setup_s" in out["metrics"]
        assert len(out["metrics"]) >= 2
    else:
        assert "breakdown" in out and "busy_s" in out["device"]
    json.dumps(out)


@pytest.mark.parametrize("traffic", ["point_solves", "configs",
                                     "source_cycle", "batched"])
def test_same_seed_same_items(traffic):
    from portbench import mix
    if traffic == "batched":
        # a position's twelve columns handed to one unit
        traffic = {"unit": "solve", "columns_per_position": 12,
                   "columns_per_item": 12}
        first = list(itertools.islice(mix.items(traffic, [4, 4, 4, 8], 1), 2))
        assert [len(i["columns"]) for i in first] == [12, 12]
        assert first[0]["columns"] == [divmod(c, 3) for c in range(12)]
        return
    traffic = load_json(HERE / "traffic" / f"{traffic}.json")
    dims = [4, 4, 4, 8]
    a = mix.items(traffic, dims, 2**40 + 3)
    b = mix.items(traffic, dims, 2**40 + 3)
    first = [next(a) for _ in range(30)]
    assert first == [next(b) for _ in range(30)]
    if traffic["columns_per_position"] == 12 and "cycle" not in traffic:
        # a propagator's twelve columns at one position, in turn
        assert [i["columns"][0] for i in first[:12]] == [
            divmod(c, 3) for c in range(12)]
        assert len({i["coords"] for i in first[:12]}) == 1
    if "cycle" in traffic:
        # every seed the same items, each pass in its own order
        other = mix.items(traffic, dims, 2**40 + 4)
        second = [next(other) for _ in range(30)]
        n = traffic["cycle"]
        key = [(i["coords"], i["columns"][0]) for i in first[:n]]
        assert sorted(key) == sorted((i["coords"], i["columns"][0])
                                     for i in second[:n])
        assert key != [(i["coords"], i["columns"][0]) for i in second[:n]]
        assert len(set(key)) == n
    elif traffic["columns_per_position"] == 1:
        # every solve at a position of its own
        assert len({i["coords"] for i in first}) >= 25


def test_no_card_no_result():
    """Without a card the command exits non-zero and prints nothing on
    its standard output."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        "tmc32.mg_solves", "--seed", "5", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
