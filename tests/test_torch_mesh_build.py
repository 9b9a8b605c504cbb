"""The slab-local operator build and what a rank keeps, on gloo rings of
1, 2 and 4 ranks on the CPU (``tests/_torch_mesh_worker.py`` through
``tests/_torch_ring.py``; each ring spawned once for the module):

  * ``parallel.sharded.make_sharded_dirac`` from each rank's gauge slab
    (twisted clover, 4³×8; the ring of 4: T_loc = 2) against the port's
    ``make_dirac`` on the whole lattice, field by field: the doubled
    gauge with its rows read across the slab faces, the clover term and
    its twisted inverse, to 1e-14; the boundary flag, on a periodic and
    an antiperiodic gauge; ``ape_smear(mesh=…)`` spatial (no exchange)
    and four-dimensional (the staples' t faces exchanged) against the
    whole smear, 1e-14;
  * on rings of 2 and 4 at 4³×16 (T = 16 is no other extent of any
    field there), the tensors that a rank keeps, walked for an axis of
    the whole lattice's t extent: the sharded operator after its fused
    chain ran, the MG pair set up on the slabs and used by
    ``run_twop(mesh=…)``, its returned propagators and smeared links and
    its stats, and the stats and modes of ``run_threep``, ``run_loops``
    and ``run_loops_wexact`` with ``mesh`` (complex64, the fused route
    through its plain versions).  None may have it.

~60 s serial, most of it the memory walk's workflows on the rings of 2 and 4.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from quda_qkxtm_multigrid_tpu.lattice import Geometry as JGeom
from quda_qkxtm_multigrid_tpu.ops.gauge import apply_t_boundary
from quda_qkxtm_multigrid_tpu.utils import rng as jrng

from quda_qkxtm_multigrid_tpu_torch import lattice as tlat
from quda_qkxtm_multigrid_tpu_torch.dirac import DiracParams, make_dirac
from quda_qkxtm_multigrid_tpu_torch.ops.smear import ape_smear

from _torch_ring import spawn

torch.set_num_threads(1)

GROUPS = {"A": (4, 4, 4, 8), "B": (4, 4, 4, 16)}
TMC = dict(kind="twisted-clover", kappa=0.115, mu=0.05, csw=1.0)
MEMORY = dict(
    params=TMC, tsink=5,
    mg=dict(block=(2, 2, 2, 2), nvec=4, setup_tol=1e-3, setup_maxiter=100,
            smoother_pc=True),
    twop=dict(ape_n=1, columns=2),
    kw=dict(kappa=0.115, mu=0.05, csw=1.0, gauss_n=1, tol=1e-5,
            maxiter=300, q_sq_max=0))


@functools.lru_cache(maxsize=None)
def _inputs():
    ga, gb = JGeom(*GROUPS["A"]), JGeom(*GROUPS["B"])
    u = jrng.random_gauge(jax.random.PRNGKey(21), ga)
    ub = jrng.random_gauge(jax.random.PRNGKey(22), gb, dtype=jnp.complex64)
    return {"u": np.asarray(u),
            "u_ap": np.asarray(apply_t_boundary(u, ga)),
            "u_b": np.asarray(ub),
            "b_b": np.asarray(jrng.random_spinor(jax.random.PRNGKey(23), gb,
                                                 dtype=jnp.complex64))}


def _jobs(nt):
    jobs = [dict(type="build", group="A", name="build", params=TMC)]
    if nt > 1:
        jobs.append(dict(type="memory", group="B", name="memory", u="u_b",
                         b="b_b", **MEMORY))
    return jobs


@pytest.fixture(scope="module")
def rings(tmp_path_factory):
    done = {}

    def get(nt):
        if nt not in done:
            done[nt] = spawn(nt, tmp_path_factory.mktemp(f"buildring{nt}"),
                             GROUPS, _jobs(nt), _inputs())
        return done[nt]
    return get


@functools.lru_cache(maxsize=None)
def _whole(key):
    """The port's whole-lattice build of ``_inputs()[key]``."""
    geom = tlat.Geometry(*GROUPS["A"])
    u = torch.tensor(_inputs()[key])
    d = make_dirac(u, DiracParams(**TMC, use_kernels=True), geom)
    ape = {spatial: ape_smear(u, geom, 0.5, 2, spatial_only=spatial)
           for spatial in (True, False)}
    return d, ape


@pytest.mark.parametrize("nt", [1, 2, 4])
@pytest.mark.parametrize("key", ["u", "u_ap"])
def test_slab_build_is_the_whole_build(rings, nt, key):
    got = rings(nt)
    d, ape = _whole(key)
    for f in ("u_doubled", "clover", "clover_inv"):
        ref = getattr(d, f).numpy()
        np.testing.assert_allclose(got[f"build/{key}/{f}"], ref, rtol=0,
                                   atol=1e-14 * np.abs(ref).max())
    assert bool(got[f"build/{key}/antiperiodic"]) == (key == "u_ap")
    assert d.antiperiodic == (key == "u_ap")
    for spatial, ref in ape.items():
        np.testing.assert_allclose(got[f"ape/{key}/{spatial}"], ref.numpy(),
                                   rtol=0, atol=1e-14)


@pytest.mark.parametrize("nt", [2, 4])
def test_meshed_paths_keep_no_whole_lattice_field(rings, nt):
    got = rings(nt)
    for rank, found in enumerate(got["memory/whole"]):
        assert len(found) == 0, (rank, list(found))
    assert all(int(c) > 50 for c in got["memory/tensors"])
    assert all(len(i) == MEMORY["twop"]["columns"]
               for i in got["memory/iters"])
