"""The meshed 2pt and 3pt on a (2, 2, 1) gloo grid on the CPU
(``tests/_torch_mesh_worker.py`` through ``tests/_torch_ring.py``, one
spawn for the module), at the JAX package's
``test_parallel.test_run_{twop,threep}_sharded`` grid and parameters
(the inputs and the JAX package's unsharded results of
``tests/test_torch_mesh_workflows.py``):

  * ``run_twop(mesh=…)``: the point source made on the box that holds
    it, the Gaussian smearing's z hops across the boxes, each column
    through ``invert(mesh=…)``, and the correlators' momentum
    projection with the sites' global coordinates summed over the
    spatial ranks and joined in t; mesons and baryons against the JAX
    package's unsharded ``run_twop``, atol 1e-9 in complex128; the
    propagators and APE links the ranks' boxes, joined, against the
    same run's;
  * ``run_threep(mesh=…)``: the sink timeslice (t_sink = 4, on the two
    boxes of the second t row) smeared across them, the sequential
    sources' scale the largest over every rank; every insertion of both
    parts against the JAX package's unsharded ``run_threep``, atol 1e-8.

~45 s serial.
"""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from quda_qkxtm_multigrid_tpu.workflows import run_twop as j_run_twop

from _torch_ring import spawn
from test_torch_mesh_workflows import (
    DIMS, GJ, THREEP, TWOP, _inputs, _jax_threep)

torch.set_num_threads(1)

GRID = (2, 2, 1)


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    jobs = [dict(type="twop", group="A", name="twop", u="u_twop", kw=TWOP),
            dict(type="threep", group="A", name="threep", u="u_threep",
                 kw=THREEP)]
    return spawn(GRID, tmp_path_factory.mktemp("boxwf"), {"A": DIMS}, jobs,
                 _inputs())


@functools.lru_cache(maxsize=None)
def _jax_twop():
    out = j_run_twop(jnp.asarray(_inputs()["u_twop"]), GJ, **TWOP)
    return {k: np.asarray(out[k])
            for k in ("mesons", "baryons", "prop_up", "u_ape")}


@pytest.mark.parametrize("key", ["mesons", "baryons", "prop_up", "u_ape"])
def test_box_run_twop_matches_jax(grid, key):
    got = grid[f"twop/{key}"]
    ref = _jax_twop()[key]
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-9)


@pytest.mark.parametrize("part", ["part1", "part2"])
@pytest.mark.parametrize("kind", ["ultra_local", "noether", "oneD"])
def test_box_run_threep_matches_jax(grid, part, kind):
    got = grid[f"threep/{part}/{kind}"]
    ref = _jax_threep()[(part, kind)]
    assert got.shape == ref.shape
    assert np.abs(ref).max() > 0
    np.testing.assert_allclose(got, ref, atol=1e-8)
