"""The cells on the card at a small lattice, through the CUDA kernels:
what the CPU tests cannot reach.  Marked ``cuda``; each test skips
itself where no card is present.  Run on a machine with a card:
``python -m pytest portbench/tests -m cuda``."""

import time

import pytest
import torch

from portbench.run import run_cell
from portbench.tests.tiny import tiny


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", ["tmc32.mg_solves", "tmc32.configs",
                                  "tmc48.dc_solves"])
def test_cell_on_card(name, trace):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    spec, cell, cfg, traffic = tiny(name)
    cfg["lattice"] = [8, 8, 8, 16]
    cfg["mg"]["block"] = [4, 4, 4, 4]
    cfg["mg"]["nvec"] = 8
    out = run_cell(spec, cell, 2**31 + 41, 1.0, bool(trace),
                   torch.device("cuda", 0), cfg=cfg, traffic=traffic,
                   t_start=time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
    if trace:
        assert out["device"]["busy_s"] > 0
        assert any(m.startswith("hop_roofline.") for m in out["metrics"])
