"""The box pieces and the box-local operator build on a (2, 2, 1) gloo
grid on the CPU (``tests/_torch_mesh_worker.py`` through
``tests/_torch_ring.py``, one spawn for the module), at 4³×8:

  * the hop of every box with every halo message on one tag
    (``parallel.halo._TAGS``): only the order in which each rank issues
    its sends and receives (t, then z, then w, minus before plus) pairs
    them, as NCCL pairs them; against the JAX package's
    ``dslash_parity`` on the whole lattice, atol 1e-13;
  * ``lattice.gather_neighbor(mesh=…)`` for mu = 0..3 both ways and
    ``covdev_apply`` in every direction, against the whole lattice's
    (gathers bit for bit, shifts 1e-13); a transfer's box cut
    (``Transfer.t_slab``): its restrict against the whole restrict's
    rows, its prolong of the box's coarse rows against the whole
    prolong, 1e-13;
  * ``parallel.sharded.make_sharded_dirac`` from each rank's gauge box
    (twisted clover) against the port's ``make_dirac`` on the whole
    lattice, field by field: the doubled gauge, the clover term (whose
    leaves reach the diagonal neighbours, two single-axis exchanges) and
    its twisted inverse, to 1e-14; the boundary flag, on a periodic and
    an antiperiodic gauge; ``ape_smear(mesh=…)`` spatial and
    four-dimensional, 1e-14.

~25 s serial.
"""

import functools

import numpy as np
import jax
import pytest
import torch

from quda_qkxtm_multigrid_tpu.lattice import Geometry as JGeom
from quda_qkxtm_multigrid_tpu.ops import dslash as jdsl
from quda_qkxtm_multigrid_tpu.ops.gauge import apply_t_boundary
from quda_qkxtm_multigrid_tpu.utils import rng as jrng

from quda_qkxtm_multigrid_tpu_torch import convert
from quda_qkxtm_multigrid_tpu_torch import lattice as tlat
from quda_qkxtm_multigrid_tpu_torch.dirac import DiracParams, make_dirac
from quda_qkxtm_multigrid_tpu_torch.mg.transfer import BlockGeometry
from quda_qkxtm_multigrid_tpu_torch.ops.smear import ape_smear, covdev_apply

from _torch_ring import spawn

torch.set_num_threads(1)

DIMS = (4, 4, 4, 8)
GRID = (2, 2, 1)
GJ, GT = JGeom(*DIMS), tlat.Geometry(*DIMS)
TMC = dict(kind="twisted-clover", kappa=0.115, mu=0.05, csw=1.0)
WILSON = dict(kind="wilson", kappa=0.12, use_kernels=True)
BLOCK, NVEC = (2, 2, 2, 2), 4


@functools.lru_cache(maxsize=None)
def _inputs():
    u = jrng.random_gauge(jax.random.PRNGKey(21), GJ)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    r = np.random.default_rng(24)
    nv = (NVEC, 2, 4, 3) + GJ.lat_shape
    bg = BlockGeometry(GT, *BLOCK, nvec=NVEC)
    cshape = (2, NVEC) + tuple(bg.coarse_shape)
    return {"u": np.asarray(u),
            "u_ap": np.asarray(apply_t_boundary(u, GJ)),
            "u0": np.asarray(jrng.random_gauge(k1, GJ)),
            "psi": np.asarray(jrng.random_spinor(k2, GJ)),
            "mg_v": r.standard_normal(nv) + 1j * r.standard_normal(nv),
            "coarse_vec": r.standard_normal(cshape)
            + 1j * r.standard_normal(cshape)}


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    jobs = [dict(type="hop", group="A", name="hop", u="u0", psi="psi",
                 params=WILSON, equal_tags=True),
            dict(type="box_pieces", group="A", name="pieces", block=BLOCK,
                 nvec=NVEC),
            dict(type="build", group="A", name="build", params=TMC)]
    return spawn(GRID, tmp_path_factory.mktemp("boxbuild"), {"A": DIMS},
                 jobs, _inputs())


def test_box_hop_with_equal_tags_matches_jax(grid):
    inp = _inputs()
    ref = np.asarray(jdsl.dslash_parity(inp["u0"], inp["psi"][1], 0, GJ))
    np.testing.assert_allclose(grid["hop"], ref, atol=1e-13)


@pytest.mark.parametrize("mu", range(4))
@pytest.mark.parametrize("fwd", [True, False])
def test_box_gathers_and_shifts_are_the_whole_lattice_ones(grid, mu, fwd):
    inp = _inputs()
    u, psi = torch.tensor(inp["u"]), torch.tensor(inp["psi"])
    ref = tlat.gather_neighbor(psi[0], mu, fwd, 1, GT)
    assert np.array_equal(grid[f"gather/{mu}/{fwd}"], ref.numpy())
    ref = covdev_apply(u, psi, mu, fwd, GT)
    np.testing.assert_allclose(grid[f"covdev/{mu}/{fwd}"], ref.numpy(),
                               atol=1e-13)


def test_box_transfer_is_the_whole_transfer(grid):
    inp = _inputs()
    bg = BlockGeometry(GT, *BLOCK, nvec=NVEC)
    tr = convert.transfer_from_numpy(inp["mg_v"], bg, device="cpu")
    whole = tr.restrict(torch.tensor(inp["psi"])).numpy()
    tc, zc = whole.shape[2] // GRID[0], whole.shape[3] // GRID[1]
    for rank, part in enumerate(grid["restrict"]):
        it, iz = divmod(rank, GRID[1])
        np.testing.assert_allclose(
            part, whole[:, :, it * tc:(it + 1) * tc, iz * zc:(iz + 1) * zc],
            atol=1e-13)
    np.testing.assert_allclose(
        grid["prolong"], tr.prolong(torch.tensor(inp["coarse_vec"])).numpy(),
        atol=1e-13)


@functools.lru_cache(maxsize=None)
def _whole(key):
    """The port's whole-lattice build of ``_inputs()[key]``."""
    u = torch.tensor(_inputs()[key])
    d = make_dirac(u, DiracParams(**TMC, use_kernels=True), GT)
    ape = {spatial: ape_smear(u, GT, 0.5, 2, spatial_only=spatial)
           for spatial in (True, False)}
    return d, ape


@pytest.mark.parametrize("key", ["u", "u_ap"])
def test_box_build_is_the_whole_build(grid, key):
    d, ape = _whole(key)
    for f in ("u_doubled", "clover", "clover_inv"):
        ref = getattr(d, f).numpy()
        np.testing.assert_allclose(grid[f"build/{key}/{f}"], ref, rtol=0,
                                   atol=1e-14 * np.abs(ref).max())
    assert bool(grid[f"build/{key}/antiperiodic"]) == (key == "u_ap")
    for spatial, ref in ape.items():
        np.testing.assert_allclose(grid[f"ape/{key}/{spatial}"],
                                   ref.numpy(), rtol=0, atol=1e-14)
