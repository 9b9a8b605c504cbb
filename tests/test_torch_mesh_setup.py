"""The multigrid set up on the slabs (``setup_mg`` on a ``ShardedDirac``)
on gloo rings of 1, 2 and 4 ranks on the CPU
(``tests/_torch_mesh_worker.py`` through ``tests/_torch_ring.py``; each
ring spawned once for the module), at 4³×8 with 2⁴ blocks (the ring of
4: T_loc = 2, one coarse t row a rank), mirroring the JAX package's
``test_parallel.test_sharded_mg_solve_matches`` on a t grid:

  * on the same null vectors (numpy, each rank its slabs) against the
    JAX package's unsharded ``setup_mg``: the coarse X and Y, whole on
    every rank, to 1e-12 in complex128, and ``mg_solve(mesh=…)``
    ("gcr-pc") in the JAX solve's iterations, x to atol 1e-7;
  * generated from a seeded generator (BiCGstab null vectors with the
    ring's sums, sources drawn whole and sliced) against the port's
    unsharded ``setup_mg`` from the same seed: V (the ranks' rows
    joined) and X, Y to 1e-10, and the same ``mg_solve`` iterations;
  * on the ring of 2, the fused route (a sharded CG a column, float32
    chain through the plain versions) against the port's unsharded fused
    setup (``invert_msrc`` batches) from the same seed: V, X and Y to
    1e-5, the same iterations.

~30 s serial.
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

from quda_qkxtm_multigrid_tpu_torch import lattice as tlat
from quda_qkxtm_multigrid_tpu_torch.dirac import DiracParams, make_dirac
from quda_qkxtm_multigrid_tpu_torch.mg import multigrid as tmg

from _torch_ring import spawn

torch.set_num_threads(1)

DIMS = (4, 4, 4, 8)
GJ, GT = JGeom(*DIMS), tlat.Geometry(*DIMS)
TM = dict(kind="twisted-mass", kappa=0.122, mu=0.03)
TMC = dict(kind="twisted-clover", kappa=0.115, mu=0.05, csw=1.0)
MG = dict(block=(2, 2, 2, 2), nvec=6, setup_tol=1e-4, setup_maxiter=200,
          nu_post=4)
SOLVE = dict(tol=1e-8, max_restarts=30, solver="gcr-pc")
SEED = 7


def rel(got, ref) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.linalg.norm((got - ref).ravel())
                 / np.linalg.norm(ref.ravel()))


@functools.lru_cache(maxsize=None)
def _inputs():
    k1, k2 = jax.random.split(jax.random.PRNGKey(3))
    r = np.random.default_rng(11)
    shape = (MG["nvec"], 2, 4, 3) + GJ.lat_shape
    return {"u": np.asarray(jrng.random_gauge(k1, GJ)),
            "b": np.asarray(jrng.random_spinor(k2, GJ)),
            "nv": r.standard_normal(shape) + 1j * r.standard_normal(shape)}


def _jobs(nt):
    jobs = [dict(type="setup", group="A", name="tm", u="u", b="b", nv="nv",
                 params=TM, mg=MG, solve=SOLVE, seed=SEED)]
    if nt == 2:
        jobs.append(dict(type="setup", group="A", name="chain", u="u",
                         b="b", params=TMC, mg=MG, solve=SOLVE, seed=SEED,
                         chain=True))
    return jobs


@pytest.fixture(scope="module")
def rings(tmp_path_factory):
    done = {}

    def get(nt):
        if nt not in done:
            done[nt] = spawn(nt, tmp_path_factory.mktemp(f"setupring{nt}"),
                             {"A": DIMS}, _jobs(nt), _inputs())
        return done[nt]
    return get


@functools.lru_cache(maxsize=None)
def _jax_given():
    """The JAX package's setup on the inputs' null vectors and its
    solve."""
    inp = _inputs()
    d = j_make_dirac(inp["u"], JParams(**TM), GJ)
    mg = jmg.setup_mg(d, jmg.MGParams(**MG), jax.random.PRNGKey(0),
                      null_vectors=list(inp["nv"]))
    out = jmg.mg_solve(mg, inp["b"], **SOLVE)
    return (np.moveaxis(np.asarray(mg.coarse.x), -1, 0),
            np.moveaxis(np.asarray(mg.coarse.y), -1, 1), int(out.iters),
            np.asarray(out.x))


@functools.lru_cache(maxsize=None)
def _port_generated(kind: str):
    """The port's unsharded setup from the same seed, and its solve."""
    inp = _inputs()
    chain = kind == "chain"
    d = make_dirac(torch.tensor(inp["u"]),
                   DiracParams(**(TMC if chain else TM), use_kernels=chain),
                   GT)
    mg = tmg.setup_mg(d, tmg.MGParams(**MG),
                      torch.Generator().manual_seed(SEED))
    out = tmg.mg_solve(mg, torch.tensor(inp["b"]), **SOLVE)
    return (mg.transfer.v.numpy(), mg.coarse.x.numpy(), mg.coarse.y.numpy(),
            out.iters)


@pytest.mark.parametrize("nt", [1, 2, 4])
def test_sharded_setup_on_given_null_vectors_matches_jax(rings, nt):
    got = rings(nt)
    x, y, iters, sol = _jax_given()
    assert rel(got["tm/given/x"], x) <= 1e-12
    assert rel(got["tm/given/y"], y) <= 1e-12
    assert int(got["tm/given/iters"]) == iters
    np.testing.assert_allclose(got["tm/given/x_sol"], sol, atol=1e-7)


@pytest.mark.parametrize("nt", [1, 2, 4])
def test_sharded_setup_is_the_unsharded_slab(rings, nt):
    got = rings(nt)
    v, x, y, iters = _port_generated("tm")
    assert rel(np.concatenate(got["tm/generated/v"], axis=1), v) <= 1e-10
    assert rel(got["tm/generated/x"], x) <= 1e-10
    assert rel(got["tm/generated/y"], y) <= 1e-10
    assert int(got["tm/generated/iters"]) == iters


def test_sharded_fused_setup_is_the_unsharded(rings):
    got = rings(2)
    v, x, y, iters = _port_generated("chain")
    assert rel(np.concatenate(got["chain/generated/v"], axis=1), v) <= 1e-5
    assert rel(got["chain/generated/x"], x) <= 1e-5
    assert rel(got["chain/generated/y"], y) <= 1e-5
    assert int(got["chain/generated/iters"]) == iters


def test_sharded_setup_refusals():
    """A block whose t extent does not divide T_loc, and the null-vector
    files (which hold the whole lattice's V), raise before anything is
    sent."""
    from quda_qkxtm_multigrid_tpu_torch.parallel.mesh import TMesh
    from quda_qkxtm_multigrid_tpu_torch.parallel.sharded import ShardedDirac
    inp = _inputs()
    u = torch.tensor(inp["u"])[..., :4, :, :]
    ring2 = TMesh(nt=2, rank=0, device=torch.device("cpu"))
    ds = ShardedDirac(u, DiracParams(**TM), tlat.Geometry(4, 4, 4, 4), ring2,
                      GT)
    with pytest.raises(ValueError, match="does not divide"):
        tmg.setup_mg(ds, tmg.MGParams(**dict(MG, block=(2, 2, 2, 8))), None)
    with pytest.raises(ValueError, match="vec_infile"):
        tmg.setup_mg(ds, tmg.MGParams(**MG, vec_infile="v.npy"), None)
