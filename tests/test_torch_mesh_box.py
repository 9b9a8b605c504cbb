"""The hop of a box on the process grids of the JAX package's
``test_parallel.test_sharded_dslash_matches`` (and (1, 2, 1)), on gloo
grids on the CPU (``tests/_torch_mesh_worker.py`` through
``tests/_torch_ring.py``, one spawn a grid):

  * ``ShardedDirac.dslash`` on each rank's box (the face exchange of
    ``parallel.halo.box_faces`` with the t, z and y faces, then K4's
    plain version with the z / y faces), the boxes joined by grid
    coordinates, against the JAX package's ``dslash_parity`` on the whole
    lattice, atol 1e-13, at 4³×8 on (1, 2, 1), (1, 1, 2), (2, 1, 2) and
    (2, 2, 2);
  * what ``make_lattice_mesh`` refuses on each grid's group (a grid of
    another size, another backend); the grid's geometry without a spawn:
    ``local_geometry`` and ``box_slab`` of a box, and an odd or
    indivisible local extent refused.

~40 s serial, most of it the four grids' start-up.
"""

import functools

import numpy as np
import jax
import pytest
import torch

from quda_qkxtm_multigrid_tpu.lattice import Geometry as JGeom
from quda_qkxtm_multigrid_tpu.ops import dslash as jdsl
from quda_qkxtm_multigrid_tpu.utils import rng as jrng

from quda_qkxtm_multigrid_tpu_torch import lattice as tlat
from quda_qkxtm_multigrid_tpu_torch.parallel.mesh import (
    LatticeMesh, box_slab, local_geometry)

from _torch_ring import spawn

torch.set_num_threads(1)

DIMS = (4, 4, 4, 8)
GJ = JGeom(*DIMS)
GRIDS = [(1, 2, 1), (1, 1, 2), (2, 1, 2), (2, 2, 2)]
WILSON = dict(kind="wilson", kappa=0.12, use_kernels=True)


@functools.lru_cache(maxsize=None)
def _inputs():
    """``test_parallel._fields(0)``: the gauge and spinor of PRNGKey(0)."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    return {"u": np.asarray(jrng.random_gauge(k1, GJ)),
            "psi": np.asarray(jrng.random_spinor(k2, GJ))}


@functools.lru_cache(maxsize=None)
def _jax_hop():
    inp = _inputs()
    return np.asarray(jdsl.dslash_parity(inp["u"], inp["psi"][1], 0, GJ))


@pytest.fixture(scope="module")
def grids(tmp_path_factory):
    done = {}

    def get(grid):
        if grid not in done:
            jobs = [dict(type="hop", group="A", name="hop", psi="psi",
                         params=WILSON),
                    dict(type="refusals", group="A", name="refusals")]
            done[grid] = spawn(grid, tmp_path_factory.mktemp(
                "box" + "".join(map(str, grid))), {"A": DIMS}, jobs,
                _inputs())
        return done[grid]
    return get


@pytest.mark.parametrize("grid", GRIDS)
def test_box_hop_matches_jax(grids, grid):
    got = grids(grid)["hop"]
    ref = _jax_hop()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-13)


@pytest.mark.parametrize("grid", GRIDS)
def test_make_lattice_mesh_refusals(grids, grid):
    got = grids(grid)
    assert "ranks, the group has" in str(got["refusals/size"])
    assert "backend" in str(got["refusals/backend"])


@pytest.mark.parametrize("grid,rank", [((2, 2, 2), 5), ((1, 2, 2), 3),
                                       ((2, 1, 2), 2)])
def test_box_geometry_and_cut(grid, rank):
    """Rank r sits at np.arange(n).reshape(grid)'s coordinates; its box is
    the whole field's [T/Gt, Z/Gz, (Y/Gw)·X/2] block there."""
    mesh = LatticeMesh(nt=grid[0], rank=rank, device=torch.device("cpu"),
                       nz=grid[1], nw=grid[2])
    coords = tuple(int(c) for c in np.argwhere(
        np.arange(np.prod(grid)).reshape(grid) == rank)[0])
    assert mesh.coords == coords
    geom = tlat.Geometry(*DIMS)
    gl = local_geometry(geom, mesh)
    assert gl.dims == (4, 4 // grid[2], 4 // grid[1], 8 // grid[0])
    f = torch.arange(2 * geom.T * geom.Z * geom.W).reshape(
        (2,) + geom.lat_shape)
    box = box_slab(f, mesh)
    it, iz, iw = coords
    ref = f[:, it * gl.T:(it + 1) * gl.T, iz * gl.Z:(iz + 1) * gl.Z,
            iw * gl.W:(iw + 1) * gl.W]
    assert torch.equal(box, ref)
    prev, nxt = mesh.neighbours(1)
    assert mesh.rank_of(it, iz - 1, iw) == prev
    assert mesh.rank_of(it, iz + 1, iw) == nxt


def test_box_extents_must_be_even_and_divide():
    """A local extent that is odd or does not divide raises."""
    geom = tlat.Geometry(4, 4, 4, 8)
    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match="even"):
        local_geometry(geom, LatticeMesh(nt=1, rank=0, device=cpu, nz=4))
    with pytest.raises(ValueError, match="divisible"):
        local_geometry(geom, LatticeMesh(nt=1, rank=0, device=cpu, nw=3))
    with pytest.raises(ValueError, match="even"):
        local_geometry(tlat.Geometry(4, 6, 4, 8),
                       LatticeMesh(nt=1, rank=0, device=cpu, nw=2))
