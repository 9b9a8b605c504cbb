"""The controls at a tiny lattice on the CPU: the reference in TF32 (the
32³×64 configuration) and the program's float32-outer path (the 48³×96
one) fail the limits that the program passes.  On the card, at each
cell's own size, ``python3 -m portbench.controls`` gives the readings
that ``PERF.md`` sets the limits from."""

import pytest
import torch

from portbench.controls import run_controls, tf32
from portbench.tests.tiny import tiny


def test_tf32_rounds_to_ten_bits():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10 + 2.0 ** -12,
                      3.0], dtype=torch.float32)
    got = tf32(x)
    assert got.tolist() == [1.0, 1.0 + 2.0 ** -10, 3.0]
    z = torch.randn(1000, dtype=torch.complex64)
    assert float((tf32(z) - z).abs().max() / z.abs().max()) < 2 ** -10


@pytest.mark.parametrize("name", ["tmc32.mg_solves", "tmc32.configs",
                                  "tmc48.dc_solves"])
def test_control_fails_its_limits(name):
    _, cell, cfg, traffic = tiny(name)
    out = run_controls(cfg, traffic, 2**31 + 7, 2, torch.device("cpu"),
                       use_kernels=False)
    lim = cfg["certify"]
    assert min(out["true_res"]) > 3 * lim["true_res"]
    if "galerkin" in out:
        assert out["galerkin"] > 3 * lim["galerkin"]
        assert out["v_ortho"] > 3 * lim["v_ortho"]
        # the set-up without its null-vector solves fails through the
        # comparison itself; the program's own set-up passes it
        assert out["null_hop"] > 3 * lim["null_hop"]
        assert out["setup_correct"] is False
        assert all(v <= lim[n] for n, v in out["sound"].items())
