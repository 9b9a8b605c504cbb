"""The meshed disconnected loops on a (2, 2, 1) gloo grid on the CPU
(``tests/_torch_mesh_worker.py`` through ``tests/_torch_ring.py``, one
spawn for the module), at the JAX package's
``test_parallel.test_run_loops_sharded`` grid:

  * ``run_loops(mesh=…)`` on the Z4 noise of the JAX package's key
    (drawn whole, cut by box): the one-end trick's covariant shifts
    across the z faces, and each loop's FFT over the rank's t rows
    gathered from its spatial ranks only, then joined in t; every loop
    type against the JAX package's unsharded ``run_loops``, atol 1e-9
    (``tests/test_torch_mesh_workflows.py``'s inputs and reference);
  * ``run_loops_wexact(mesh=…)`` (M_pc†M_pc, the CG from
    ``deflate_guess``) from the JAX package's Lanczos start vector and
    noise (``tests/test_torch_mesh_wexact.py``'s): the eigenvalues and
    every loop type against the JAX package's unsharded
    ``run_loops_wexact``, 1e-10 normwise relative.

~40 s serial.
"""

import numpy as np
import pytest
import torch

from quda_qkxtm_multigrid_tpu_torch import workflows as wf

from _torch_ring import spawn
from test_torch_mesh_wexact import (
    WEXACT, _inputs as _wexact_inputs, _jax_wexact, rel)
from test_torch_mesh_workflows import (
    DIMS, LOOPS, _inputs as _wf_inputs, _jax_loops)

torch.set_num_threads(1)

GRID = (2, 2, 1)


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    inputs = dict(_wf_inputs())
    w = _wexact_inputs()
    inputs.update(u_w=w["u"], v0=w["v0"], noise_w=w["noise"])
    jobs = [dict(type="loops", group="A", name="loops", u="u_loops",
                 noise="noise", kw=LOOPS),
            dict(type="wexact", group="A", name="wexact", u="u_w", v0="v0",
                 noise="noise_w", kw=dict(WEXACT, full_op=False))]
    return spawn(GRID, tmp_path_factory.mktemp("boxloops"), {"A": DIMS},
                 jobs, inputs)


@pytest.mark.parametrize("name", sorted(wf.LOOP_NAMES))
def test_box_run_loops_matches_jax(grid, name):
    got = grid[f"loops/{name}"]
    ref = _jax_loops()[name]
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-9)


def test_box_run_loops_wexact_matches_jax(grid):
    loops, evals = _jax_wexact(False)
    assert rel(grid["wexact/evals"], evals) <= 1e-10
    assert float(grid["wexact/resid"].max()) < 1e-11
    assert len(grid["wexact/cg_iters"]) == WEXACT["n_stoch"]
    for k, ref in loops.items():
        assert rel(grid[f"wexact/{k}"], ref) <= 1e-10, k
