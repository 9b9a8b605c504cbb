"""``BENCHMARK.json`` keeps to the benchmark's contract as far as a file
can show: its keys, names, units and lengths, and every file that a name
points to."""

import json
import re

import pytest

from portbench.run import HERE, ROOT, reader_path

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def line_ok(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level():
    assert set(SPEC) == KEYS
    assert len(json.dumps(SPEC)) <= 64 * 1024
    assert 1 <= SPEC["run_seconds"] <= 51
    assert SPEC["paths"] == ["portbench"]
    assert all(line_ok(w) and not w.startswith("/") and ".." not in w
               for w in SPEC["command"])


def test_names_and_units():
    names = []
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in SPEC[section]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((section, entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [n for s, n in names if s == section]
        assert len(got) == len(set(got))
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert line_ok(c["why"]) and line_ok(c["source"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("portbench/")
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert line_ok(w["why"]) and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"])
        traffic = json.loads((HERE / "traffic" /
                              f"{w['traffic']}.json").read_text())
        assert (HERE / "units" / f"{traffic['unit']}.py").is_file()
        assert w["config"] in {c["name"] for c in SPEC["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_metrics():
    cells = {w["name"] for w in SPEC["workloads"]}
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert line_ok(m["layer"]) and m["moves"] in e2e
        for cell in m.get("workloads", []):
            assert cell in cells
            moved = e2e[m["moves"]]
            assert cell in moved.get("workloads", cells)
        if "roofline" in m["name"]:
            assert m["unit"] == "%"
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert reader_path(m["name"]).is_file(), m["name"]
        assert set(m.get("workloads", cells)) <= cells
    for cell in cells:
        mine = [m for m in SPEC["end_to_end"]
                if cell in m.get("workloads", cells)]
        assert len(mine) >= 2
        assert any(cell in m.get("workloads", cells)
                   for m in SPEC["per_layer"])


@pytest.mark.parametrize("c", SPEC["configs"], ids=lambda c: c["name"])
def test_config_files(c):
    cfg = json.loads((ROOT / c["file"]).read_text())
    assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
    assert (HERE / "routes" / f"{cfg['route']}.py").is_file()
    for key in c["reduced"]:
        assert key in cfg["assumed"]
    assert set(cfg["certify"]) <= {"true_res", "v_ortho", "galerkin",
                                   "null_hop"}


def test_run_seconds_fit_a_full_check():
    """2 + 14 runs a cell of run_seconds + 60, 180 s a cell to compile and
    1200 spare, for 24 cells, within 43200 s."""
    rs = SPEC["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200
