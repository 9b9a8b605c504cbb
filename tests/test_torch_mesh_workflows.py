"""The meshed workflows on gloo rings on the CPU
(``tests/_torch_mesh_worker.py`` through ``tests/_torch_ring.py``; each
ring spawned once for the module), with the parameters of the JAX
package's ``test_parallel.test_run_{twop,threep,loops}_sharded``:

  * ``run_loops(mesh=…)`` on rings of 2 and 4 against the JAX package's
    unsharded ``run_loops`` on the same Z4 noise (made by JAX from its
    key and handed to the workers), atol 1e-9;
  * ``run_twop(mesh=…)`` (atol 1e-9) and ``run_threep(mesh=…)`` (atol
    1e-8) on a ring of 2 against the JAX package's unsharded
    ``run_twop`` / ``run_threep`` on the same gauges and propagators,
    and against the port's unsharded workflows at the same tolerances;
  * the whole-lattice results on every rank are the same bytes
    (``_torch_ring.spawn``), the propagators and APE links of the 2pt
    come back as the ranks' slabs (joined in t to compare), and the
    3pt's sink lives on rank 1 (t_sink = 4, T_loc = 4).

~80 s serial.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from quda_qkxtm_multigrid_tpu.lattice import Geometry as JGeom
from quda_qkxtm_multigrid_tpu.utils import rng as jrng
from quda_qkxtm_multigrid_tpu.ops.smear import ape_smear as j_ape_smear
from quda_qkxtm_multigrid_tpu.workflows import (
    run_loops as j_run_loops, run_threep as j_run_threep,
    run_twop as j_run_twop)

from quda_qkxtm_multigrid_tpu_torch import lattice as tlat
from quda_qkxtm_multigrid_tpu_torch import workflows as wf
from quda_qkxtm_multigrid_tpu_torch.ops.smear import ape_smear
from quda_qkxtm_multigrid_tpu_torch.parallel.mesh import TMesh

from _torch_ring import spawn

torch.set_num_threads(1)

DIMS = (4, 4, 4, 8)
GJ, GT = JGeom(*DIMS), tlat.Geometry(*DIMS)
TWOP = dict(kappa=0.115, mu=0.05, csw=0.0, q_sq_max=0, ape_n=2, gauss_n=2,
            tol=1e-9, maxiter=300)
THREEP = dict(kappa=0.115, mu=0.05, csw=0.0, tsink=4, projectors=["G4"],
              gauss_n=2, tol=1e-7, maxiter=300)
LOOPS = dict(kappa=0.115, mu=0.05, csw=0.0, n_stoch=1, tol=1e-8,
             maxiter=300)


@functools.lru_cache(maxsize=None)
def _inputs():
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(13), 3)
    shape = (2, 4, 4, 3, 3) + GJ.lat_shape
    pu = (jax.random.normal(k2, shape) + 1j * jax.random.normal(k3, shape))
    _, sub = jax.random.split(jax.random.PRNGKey(12))
    return {
        "u_twop": np.asarray(jrng.random_gauge(jax.random.PRNGKey(9), GJ,
                                               dtype=jnp.complex128)),
        "u_threep": np.asarray(jrng.random_gauge(k1, GJ,
                                                 dtype=jnp.complex128)),
        "pu": np.asarray(pu) * 0.1,
        "u_loops": np.asarray(jrng.random_gauge(jax.random.PRNGKey(11), GJ,
                                                dtype=jnp.complex128)),
        # the Z4 source of the JAX run_loops' first (only) sample
        "noise": np.asarray(jrng.z4_source(sub, GJ, jnp.complex128))[None]}


def _jobs(nt):
    jobs = [dict(type="loops", group="A", name="loops", u="u_loops",
                 noise="noise", kw=LOOPS)]
    if nt == 2:
        jobs += [dict(type="twop", group="A", name="twop", u="u_twop",
                      kw=TWOP),
                 dict(type="threep", group="A", name="threep", u="u_threep",
                      kw=THREEP)]
    return jobs


@pytest.fixture(scope="module")
def rings(tmp_path_factory):
    done = {}

    def get(nt):
        if nt not in done:
            done[nt] = spawn(nt, tmp_path_factory.mktemp(f"wfring{nt}"),
                             {"A": DIMS}, _jobs(nt), _inputs())
        return done[nt]
    return get


@functools.lru_cache(maxsize=None)
def _jax_loops():
    u = jnp.asarray(_inputs()["u_loops"])
    out = j_run_loops(u, GJ, key=jax.random.PRNGKey(12), **LOOPS)
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("nt", [2, 4])
@pytest.mark.parametrize("name", sorted(wf.LOOP_NAMES))
def test_run_loops_on_a_ring_matches_jax(rings, nt, name):
    got = rings(nt)[f"loops/{name}"]
    ref = _jax_loops()[name]
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-9)


@functools.lru_cache(maxsize=None)
def _jax_twop():
    out = j_run_twop(jnp.asarray(_inputs()["u_twop"]), GJ, **TWOP)
    return {k: np.asarray(out[k]) for k in ("mesons", "baryons")}


@pytest.mark.parametrize("key", ["mesons", "baryons"])
def test_run_twop_on_a_ring_matches_jax(rings, key):
    got = rings(2)[f"twop/{key}"]
    ref = _jax_twop()[key]
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-9)


@functools.lru_cache(maxsize=None)
def _port_twop():
    return wf.run_twop(torch.tensor(_inputs()["u_twop"]), GT, **TWOP)


@pytest.mark.parametrize("key", ["mesons", "baryons", "prop_up", "u_ape"])
def test_run_twop_on_a_ring_is_the_unsharded(rings, key):
    got = rings(2)[f"twop/{key}"]
    ref = _port_twop()[key].numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-9)


@functools.lru_cache(maxsize=None)
def _jax_threep():
    inp = _inputs()
    u, pu = jnp.asarray(inp["u_threep"]), jnp.asarray(inp["pu"])
    out = j_run_threep(u, GJ, prop_up=pu, prop_dn=jnp.conj(pu),
                       u_ape=j_ape_smear(u, GJ, 0.5, 2), **THREEP)["thrp"]
    return {(part, kind): np.asarray(v)
            for part, ins in out["G4"].items() for kind, v in ins.items()}


@pytest.mark.parametrize("part", ["part1", "part2"])
@pytest.mark.parametrize("kind", ["ultra_local", "noether", "oneD"])
def test_run_threep_on_a_ring_matches_jax(rings, part, kind):
    got = rings(2)[f"threep/{part}/{kind}"]
    ref = _jax_threep()[(part, kind)]
    assert got.shape == ref.shape
    assert np.abs(ref).max() > 0
    np.testing.assert_allclose(got, ref, atol=1e-8)


@functools.lru_cache(maxsize=None)
def _port_threep():
    inp = _inputs()
    u = torch.tensor(inp["u_threep"])
    pu = torch.tensor(inp["pu"])
    return wf.run_threep(u, GT, prop_up=pu, prop_dn=pu.conj(),
                         u_ape=ape_smear(u, GT, 0.5, 2), **THREEP)["thrp"]


@pytest.mark.parametrize("part", ["part1", "part2"])
@pytest.mark.parametrize("kind", ["ultra_local", "noether", "oneD"])
def test_run_threep_on_a_ring_is_the_unsharded(rings, part, kind):
    got = rings(2)[f"threep/{part}/{kind}"]
    ref = _port_threep()["G4"][part][kind].numpy()
    assert got.shape == ref.shape
    assert np.abs(ref).max() > 0
    np.testing.assert_allclose(got, ref, atol=1e-8)


def test_meshed_workflows_refuse_what_they_cannot_split():
    """A ring that does not divide T raises before anything is sent, in
    the loops and in the deflated loops alike."""
    u = torch.tensor(_inputs()["u_loops"])
    ring3 = TMesh(nt=3, rank=0, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="divisible"):
        wf.run_loops(u, GT, gen=torch.Generator(), mesh=ring3, **LOOPS)
    with pytest.raises(ValueError, match="divisible"):
        wf.run_loops_wexact(u, GT, kappa=0.115, mu=0.05, csw=0.0, nev=2,
                            n_stoch=1, gen=torch.Generator(), mesh=ring3)
