"""``run_loops_wexact(mesh=…)`` on gloo rings of 2 and 4 ranks on the
CPU (``tests/_torch_mesh_worker.py`` through ``tests/_torch_ring.py``),
in complex128 at 4³×8 (the ring of 4: T_loc = 2), against the JAX
package's unsharded ``run_loops_wexact`` from the same Lanczos start
vector and Z4 noise (made by JAX and handed to the workers whole, which
the workflow slices): the Lanczos and the CG run to 1e-12, and every
loop type agrees to 1e-10 and the eigenvalues to 1e-10, normwise
relative.  ``full_op=True`` (M†M on full fields) runs on the ring of 2,
``full_op=False`` (M_pc†M_pc, the CG from ``deflate_guess``) on the
ring of 4.

~60 s serial: the JAX package's two ``run_loops_wexact`` (~30 s,
mostly compilation) and the rings (the full operator's Lanczos takes
~800 matvecs).
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from quda_qkxtm_multigrid_tpu import lattice as jlat
from quda_qkxtm_multigrid_tpu import workflows as jwf
from quda_qkxtm_multigrid_tpu.utils import rng as jrng

from quda_qkxtm_multigrid_tpu_torch import workflows as wf

from _torch_ring import spawn

torch.set_num_threads(1)

DIMS = (4, 4, 4, 8)
GJ = jlat.Geometry(*DIMS)
WEXACT = dict(kappa=0.115, mu=0.05, csw=0.0, nev=2, n_stoch=2, tol=1e-12,
              maxiter=800, ncv=32, lanczos_tol=1e-12)
KEY = 8
FULL_OP = {2: True, 4: False}     # the mode each ring runs


def rel(got, ref) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.linalg.norm((got - ref).ravel())
                 / np.linalg.norm(ref.ravel()))


def _jax_start(key, shape):
    """The JAX ``lanczos`` start vector of ``key``."""
    kr, ki = jax.random.split(key)
    v0 = (jax.random.normal(kr, shape, jnp.float64)
          + 1j * jax.random.normal(ki, shape, jnp.float64))
    return np.asarray(v0 / jnp.sqrt(jnp.real(jnp.vdot(v0, v0))))


def _jax_noise(key, n):
    """The Z4 sources of the JAX workflow's key sequence."""
    out = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jrng.z4_source(sub, GJ, jnp.complex128)))
    return np.stack(out)


@functools.lru_cache(maxsize=None)
def _inputs():
    key = jax.random.PRNGKey(KEY)
    half = (4, 3) + GJ.lat_shape
    return {"u": np.asarray(jrng.random_gauge(jax.random.PRNGKey(2), GJ)),
            "v0": _jax_start(key, half),
            "v0_full": _jax_start(key, (2,) + half),
            "noise": _jax_noise(key, WEXACT["n_stoch"])}


@pytest.fixture(scope="module")
def rings(tmp_path_factory):
    done = {}

    def get(nt):
        if nt not in done:
            full = FULL_OP[nt]
            job = dict(type="wexact", group="A", name="wexact", u="u",
                       v0="v0_full" if full else "v0", noise="noise",
                       kw=dict(WEXACT, full_op=full))
            done[nt] = spawn(nt, tmp_path_factory.mktemp(f"wexring{nt}"),
                             {"A": DIMS}, [job], _inputs())
        return done[nt]
    return get


@functools.lru_cache(maxsize=None)
def _jax_wexact(full_op: bool):
    loops, eig = jwf.run_loops_wexact(_inputs()["u"], GJ,
                                      key=jax.random.PRNGKey(KEY),
                                      full_op=full_op, **WEXACT)
    return {k: np.asarray(v) for k, v in loops.items()}, np.asarray(
        eig.evals)


@pytest.mark.parametrize("nt", sorted(FULL_OP))
def test_run_loops_wexact_on_a_ring_matches_jax(rings, nt):
    got = rings(nt)
    loops, evals = _jax_wexact(FULL_OP[nt])
    assert rel(got["wexact/evals"], evals) <= 1e-10
    assert float(got["wexact/resid"].max()) < 1e-11
    assert len(got["wexact/cg_iters"]) == WEXACT["n_stoch"]
    assert set(loops) == set(wf.LOOP_NAMES)
    for k, ref in loops.items():
        assert rel(got[f"wexact/{k}"], ref) <= 1e-10, k
