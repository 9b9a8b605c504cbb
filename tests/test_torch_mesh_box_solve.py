"""The complex128 sharded solve and the Schwarz preconditioners on boxes:
gloo grids on the CPU (``tests/_torch_mesh_worker.py`` through
``tests/_torch_ring.py``, one spawn a grid) at 4³×8, at the JAX
package's grids:

  * ``invert(mesh=…)`` on (2, 2, 2) (``test_parallel.
    test_sharded_invert_matches``: twisted clover, a point source, tol
    1e-10): the CG without the chain against the JAX package's unsharded
    ``invert``, x to atol 1e-9; ``cg-mixed`` on the fused chain (K4's
    plain version with the z and y faces) certifying to 1e-9;
  * GCR with ``schwarz_precond`` and ``schwarz_precond_multiplicative``
    on (2, 2, 1) (``test_schwarz_preconditioned_gcr`` /
    ``test_multiplicative_schwarz``: each block the box's operator with
    every wrap inside the box, the multiplicative sweep coloured by the
    parity of the grid coordinates' sum) against the JAX package's on
    its virtual (2, 2, 1) mesh: iterations equal, x to atol 1e-9, fewer
    iterations than plain GCR.

~45 s serial.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from quda_qkxtm_multigrid_tpu import fields as jfields
from quda_qkxtm_multigrid_tpu.dirac import (DiracParams as JParams,
                                            make_dirac as j_make_dirac)
from quda_qkxtm_multigrid_tpu.invert import invert as j_invert
from quda_qkxtm_multigrid_tpu.lattice import Geometry as JGeom
from quda_qkxtm_multigrid_tpu.parallel import (make_lattice_mesh,
                                               shard_spinor as j_shard)
from quda_qkxtm_multigrid_tpu.parallel.mesh import shard_dirac as j_shard_d
from quda_qkxtm_multigrid_tpu.parallel.schwarz import (
    schwarz_precond as j_schwarz, schwarz_precond_multiplicative as j_mult)
from quda_qkxtm_multigrid_tpu.solvers.gcr import gcr as j_gcr
from quda_qkxtm_multigrid_tpu.utils import rng as jrng

from _torch_ring import spawn

torch.set_num_threads(1)

DIMS = (4, 4, 4, 8)
GJ = JGeom(*DIMS)
TMC = dict(kind="twisted-clover", kappa=0.115, mu=0.08, csw=1.0)
TM_SZ = dict(kind="twisted-mass", kappa=0.12, mu=0.04)
SOLVE = dict(tol=1e-10, maxiter=500)
SOLVE_GRID, SCHWARZ_GRID = (2, 2, 2), (2, 2, 1)


def _jfields(seed):
    """``test_parallel._fields(seed)``: a random gauge and spinor."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    return jrng.random_gauge(k1, GJ), jrng.random_spinor(k2, GJ)


@functools.lru_cache(maxsize=None)
def _inputs():
    u5, b5 = (np.asarray(a) for a in _jfields(5))
    return {"u1": np.asarray(_jfields(1)[0]), "u5": u5, "b5": b5,
            "pt": np.asarray(jfields.point_source(GJ, (0, 0, 0, 0), 0, 0))}


@pytest.fixture(scope="module")
def grids(tmp_path_factory):
    done = {}
    jobs = {SOLVE_GRID: [dict(type="solve", group="A", name=f"solve/{s}",
                              u="u1", b="pt", solver=s,
                              params=dict(TMC, use_kernels=k), **SOLVE)
                         for s, k in (("cg", False), ("cg-mixed", True))],
            SCHWARZ_GRID: [dict(type="schwarz", group="A", name="schwarz",
                                u="u5", b="b5", params=TM_SZ)]}

    def get(grid):
        if grid not in done:
            done[grid] = spawn(grid, tmp_path_factory.mktemp(
                "boxsolve" + "".join(map(str, grid))), {"A": DIMS},
                jobs[grid], _inputs())
        return done[grid]
    return get


@functools.lru_cache(maxsize=None)
def _jax_invert():
    inp = _inputs()
    d = j_make_dirac(jnp.asarray(inp["u1"]), JParams(**TMC), GJ)
    return np.asarray(j_invert(d, jnp.asarray(inp["pt"]), **SOLVE).x)


def test_box_cg_without_the_chain_matches_jax(grids):
    res = grids(SOLVE_GRID)
    assert res["solve/cg/true_res"] < 1e-9
    np.testing.assert_allclose(res["solve/cg/x"], _jax_invert(), atol=1e-9)


def test_box_cg_mixed_certifies(grids):
    res = grids(SOLVE_GRID)
    assert res["solve/cg-mixed/true_res"] <= 1e-9
    np.testing.assert_allclose(res["solve/cg-mixed/x"], _jax_invert(),
                               atol=1e-8)


@functools.lru_cache(maxsize=None)
def _jax_schwarz():
    u, b = _jfields(5)
    d = j_make_dirac(u, JParams(**TM_SZ), GJ)
    mesh = make_lattice_mesh(SCHWARZ_GRID)
    d_s, b_s = j_shard_d(d, mesh), j_shard(b, mesh)
    out = {}
    with jax.set_mesh(mesh):
        for kind, mk in (("plain", None), ("additive", j_schwarz),
                         ("multiplicative", j_mult)):
            def solve(d, b, mk=mk):
                pc = None if mk is None else mk(d, mesh, niter=4)
                return j_gcr(d.m, b, tol=1e-8, n_krylov=10, max_restarts=40,
                             precond=pc)
            r = jax.jit(solve)(d_s, b_s)
            out[kind] = (np.asarray(r.x), int(r.iters))
    return out


@pytest.mark.parametrize("kind", ["additive", "multiplicative"])
def test_box_schwarz_gcr_matches_jax(grids, kind):
    res = grids(SCHWARZ_GRID)
    ref = _jax_schwarz()
    assert res[f"schwarz/{kind}/iters"] == ref[kind][1]
    np.testing.assert_allclose(res[f"schwarz/{kind}/x"], ref[kind][0],
                               atol=1e-9)
    assert res[f"schwarz/{kind}/true_res"] < 1e-6
    assert res[f"schwarz/{kind}/iters"] < res["schwarz/plain/iters"]
    assert res["schwarz/plain/iters"] == ref["plain"][1]


def test_box_multiplicative_needs_no_more_iterations(grids):
    res = grids(SCHWARZ_GRID)
    assert (res["schwarz/multiplicative/iters"]
            <= res["schwarz/additive/iters"])
