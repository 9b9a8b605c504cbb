"""The sharded multigrid on boxes: a (2, 2, 1) gloo grid on the CPU
(``tests/_torch_mesh_worker.py`` through ``tests/_torch_ring.py``, one
spawn for the module) at 4³×8 with 2⁴ blocks (each box one coarse t row
and one coarse z row), mirroring the JAX package's
``test_parallel.test_sharded_mg_solve_matches`` at its grid (2, 2, 1):

  * ``mg_solve(mesh=…)`` with "gcr" and "gcr-pc" after ``shard_mg`` of
    the JAX package's setup (its V and coarse X, Y carried across; V cut
    to each box's aggregates) against the JAX package's unsharded
    ``mg_solve``: iterations equal, x to atol 1e-7;
  * one ``vcycle(mesh=…)``: the coarse residual gathered by grid
    coordinates, every rank's coarse solve bit-identical, the result the
    unsharded V-cycle's (1e-12);
  * the MG set up on the boxes (``setup_mg`` on the grid's
    ``make_operator(mesh=…)``, its level-1 hops reading across the z
    faces): on the same null vectors against the JAX package's
    unsharded ``setup_mg`` (coarse X and Y to 1e-12, the JAX solve's
    iterations, x to 1e-7); generated from a seeded generator against
    the port's unsharded setup from the same seed (V joined by box, X, Y
    to 1e-10, the same iterations).

~35 s serial.
"""

import functools

import numpy as np
import jax
import pytest
import torch

from quda_qkxtm_multigrid_tpu.dirac import (DiracParams as JParams,
                                            make_dirac as j_make_dirac)
from quda_qkxtm_multigrid_tpu.lattice import Geometry as JGeom
from quda_qkxtm_multigrid_tpu.mg import multigrid as jmg
from quda_qkxtm_multigrid_tpu.utils import rng as jrng

from quda_qkxtm_multigrid_tpu_torch import convert
from quda_qkxtm_multigrid_tpu_torch import lattice as tlat
from quda_qkxtm_multigrid_tpu_torch.dirac import DiracParams, make_dirac
from quda_qkxtm_multigrid_tpu_torch.mg import multigrid as tmg
from quda_qkxtm_multigrid_tpu_torch.mg.transfer import BlockGeometry
from quda_qkxtm_multigrid_tpu_torch.parallel.mesh import LatticeMesh

from _torch_ring import spawn

torch.set_num_threads(1)

DIMS = (4, 4, 4, 8)
GRID = (2, 2, 1)
GJ, GT = JGeom(*DIMS), tlat.Geometry(*DIMS)
TM_MG = dict(kind="twisted-mass", kappa=0.122, mu=0.03)
MG = dict(block=(2, 2, 2, 2), nvec=6, setup_tol=1e-4, setup_maxiter=200,
          nu_post=4)
MG_SOLVE = dict(tol=1e-8, max_restarts=30)
SETUP_SOLVE = dict(tol=1e-8, max_restarts=30, solver="gcr-pc")
SEED = 7


def rel(got, ref) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.linalg.norm((got - ref).ravel())
                 / np.linalg.norm(ref.ravel()))


def _jfields(seed):
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    return jrng.random_gauge(k1, GJ), jrng.random_spinor(k2, GJ)


@functools.lru_cache(maxsize=None)
def _jax_mg():
    """The JAX package's MG of ``test_sharded_mg_solve_matches``."""
    u, b = _jfields(3)
    d = j_make_dirac(u, JParams(**TM_MG), GJ)
    return jmg.setup_mg(d, jmg.MGParams(**MG), jax.random.PRNGKey(7)), b


@functools.lru_cache(maxsize=None)
def _inputs():
    mg, b = _jax_mg()
    r = np.random.default_rng(11)
    shape = (MG["nvec"], 2, 4, 3) + GJ.lat_shape
    return {"u": np.asarray(_jfields(3)[0]), "b": np.asarray(b),
            "mg_v": np.asarray(mg.transfer.v[0]) + 1j * np.asarray(
                mg.transfer.v[1]),
            "mg_x": np.asarray(mg.coarse.x), "mg_y": np.asarray(mg.coarse.y),
            "nv": r.standard_normal(shape) + 1j * r.standard_normal(shape)}


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    jobs = [dict(type="mg", group="A", name=f"mg/{s}", params=TM_MG, mg=MG,
                 solver=s, **MG_SOLVE) for s in ("gcr", "gcr-pc")]
    jobs.append(dict(type="mg_vcycle", group="A", name="vcycle",
                     params=TM_MG, mg=MG))
    jobs.append(dict(type="setup", group="A", name="tm", u="u", b="b",
                     nv="nv", params=TM_MG, mg=MG, solve=SETUP_SOLVE,
                     seed=SEED))
    return spawn(GRID, tmp_path_factory.mktemp("boxmg"), {"A": DIMS}, jobs,
                 _inputs())


@functools.lru_cache(maxsize=None)
def _jax_mg_solve(solver):
    mg, b = _jax_mg()
    out = jmg.mg_solve(mg, b, solver=solver, **MG_SOLVE)
    return np.asarray(out.x), int(out.iters)


@pytest.mark.parametrize("solver", ["gcr", "gcr-pc"])
def test_box_mg_solve_matches_jax(grid, solver):
    x_ref, iters_ref = _jax_mg_solve(solver)
    assert grid[f"mg/{solver}/iters"] == iters_ref
    np.testing.assert_allclose(grid[f"mg/{solver}/x"], x_ref, atol=1e-7)
    b = _inputs()["b"]
    assert np.sqrt(grid[f"mg/{solver}/r2"]) / np.linalg.norm(b) < 1e-7


def test_box_vcycle_replicates_the_coarse_solve(grid):
    coarse = grid["vcycle/coarse"]
    assert len(coarse) == int(np.prod(GRID))
    for c in coarse[1:]:
        assert np.array_equal(c, coarse[0])
    inp = _inputs()
    params = tmg.MGParams(**MG)
    bg = BlockGeometry(GT, *params.block, nvec=params.nvec)
    d = convert.dirac_from_numpy(inp["u"], DiracParams(**TM_MG), GT,
                                 device="cpu")
    mg = tmg.MGPreconditioner(
        transfer=convert.transfer_from_numpy(inp["mg_v"], bg, device="cpu"),
        coarse=convert.coarse_op_from_numpy(inp["mg_x"], inp["mg_y"], bg,
                                            device="cpu"),
        dirac=d, params=params)
    np.testing.assert_allclose(grid["vcycle/x"],
                               mg.vcycle(torch.tensor(inp["b"])).numpy(),
                               atol=1e-12)


@functools.lru_cache(maxsize=None)
def _jax_given():
    inp = _inputs()
    d = j_make_dirac(inp["u"], JParams(**TM_MG), GJ)
    mg = jmg.setup_mg(d, jmg.MGParams(**MG), jax.random.PRNGKey(0),
                      null_vectors=list(inp["nv"]))
    out = jmg.mg_solve(mg, inp["b"], **SETUP_SOLVE)
    return (np.moveaxis(np.asarray(mg.coarse.x), -1, 0),
            np.moveaxis(np.asarray(mg.coarse.y), -1, 1), int(out.iters),
            np.asarray(out.x))


def test_box_setup_on_given_null_vectors_matches_jax(grid):
    x, y, iters, sol = _jax_given()
    assert rel(grid["tm/given/x"], x) <= 1e-12
    assert rel(grid["tm/given/y"], y) <= 1e-12
    assert int(grid["tm/given/iters"]) == iters
    np.testing.assert_allclose(grid["tm/given/x_sol"], sol, atol=1e-7)


def _join_v(parts):
    """The ranks' V [2, Tc, Zc, Yc, Xc, nvec, bdof] joined by their grid
    coordinates (coarse t, then z)."""
    rows = [np.concatenate(parts[it * GRID[1]:(it + 1) * GRID[1]], axis=2)
            for it in range(GRID[0])]
    return np.concatenate(rows, axis=1)


def test_box_setup_is_the_unsharded_setup(grid):
    inp = _inputs()
    d = make_dirac(torch.tensor(inp["u"]), DiracParams(**TM_MG), GT)
    mg = tmg.setup_mg(d, tmg.MGParams(**MG),
                      torch.Generator().manual_seed(SEED))
    out = tmg.mg_solve(mg, torch.tensor(inp["b"]), **SETUP_SOLVE)
    assert rel(_join_v(grid["tm/generated/v"]), mg.transfer.v.numpy()) \
        <= 1e-10
    assert rel(grid["tm/generated/x"], mg.coarse.x.numpy()) <= 1e-10
    assert rel(grid["tm/generated/y"], mg.coarse.y.numpy()) <= 1e-10
    assert int(grid["tm/generated/iters"]) == out.iters


def test_box_mg_refuses_a_block_that_straddles_boxes():
    """A block whose z extent does not divide Z_loc raises before
    anything is sent."""
    inp = _inputs()
    d = make_dirac(torch.tensor(inp["u"]), DiracParams(**TM_MG), GT)
    bg = BlockGeometry(GT, 2, 2, 4, 2, nvec=MG["nvec"])
    tr = convert.transfer_from_numpy(inp["nv"], bg, device="cpu")
    mg = tmg.MGPreconditioner(transfer=tr, coarse=None, dirac=d,
                              params=tmg.MGParams(**MG))
    mesh = LatticeMesh(nt=2, rank=0, device=torch.device("cpu"), nz=2)
    with pytest.raises(ValueError, match="z extent 4 does not divide"):
        tmg.shard_mg(mg, mesh)
