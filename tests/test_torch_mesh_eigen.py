"""The eigensolver on gloo rings of 1, 2 and 4 ranks on the CPU
(``tests/_torch_mesh_worker.py`` through ``tests/_torch_ring.py``; each
ring spawned once for the module), in complex128 at 4³×8 (the ring of
4: T_loc = 2):

  * ``lanczos``, ``spectrum_bounds``, ``project_out`` and
    ``deflate_guess`` with ``allreduce=mesh.allreduce`` on the rank's
    slab of M_pc†M_pc (``make_operator(mesh=…)``) against the port's
    unsharded functions from the same start vector: eigenvalues and
    bounds to 1e-12 relative, each Ritz vector the unsharded one up to
    its phase (|<v, v_ring>| = 1 to 1e-10), the projections to 1e-12;
    the eigenvalues against the JAX package's ``lanczos`` on the same
    operator and start vector to 1e-10;
  * on one process, on a dense hermitian matrix, every summed form with
    an ``allreduce`` that sums over one rank against the unsharded form
    (1e-13; ``bicgstab`` the same iterations), and ``allreduce=None``
    bit-identical to the default.

``tests/test_torch_mesh_wexact.py`` runs the deflated loops on the
rings.  ~40 s serial, most of it the three rings' start-up.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from quda_qkxtm_multigrid_tpu import lattice as jlat
from quda_qkxtm_multigrid_tpu.dirac import DiracParams as JParams
from quda_qkxtm_multigrid_tpu.dirac import make_dirac as jmake_dirac
from quda_qkxtm_multigrid_tpu.solvers import eigen as jeig
from quda_qkxtm_multigrid_tpu.utils import rng as jrng

from quda_qkxtm_multigrid_tpu_torch.dirac import DiracParams, make_dirac
from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry
from quda_qkxtm_multigrid_tpu_torch.solvers import eigen
from quda_qkxtm_multigrid_tpu_torch.solvers.bicgstab import bicgstab

from _torch_ring import spawn

torch.set_num_threads(1)

DIMS = (4, 4, 4, 8)
GJ, GT = jlat.Geometry(*DIMS), Geometry(*DIMS)
TM = dict(kind="twisted-mass", kappa=0.115, mu=0.05)
LANCZOS = dict(nev=2, ncv=16, tol=1e-10)
STEPS = 12
KEY = 8


def rel(got, ref) -> float:
    got, ref = (np.asarray(v.numpy() if torch.is_tensor(v) else v)
                for v in (got, ref))
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.linalg.norm((got - ref).ravel())
                 / np.linalg.norm(ref.ravel()))


def _jax_start(key, shape):
    """The JAX ``lanczos`` start vector of ``key``."""
    kr, ki = jax.random.split(key)
    v0 = (jax.random.normal(kr, shape, jnp.float64)
          + 1j * jax.random.normal(ki, shape, jnp.float64))
    return np.asarray(v0 / jnp.sqrt(jnp.real(jnp.vdot(v0, v0))))


@functools.lru_cache(maxsize=None)
def _inputs():
    key = jax.random.PRNGKey(KEY)
    half = (4, 3) + GJ.lat_shape
    r = np.random.default_rng(6)
    return {"u": np.asarray(jrng.random_gauge(jax.random.PRNGKey(2), GJ)),
            "v0": _jax_start(key, half),
            "b_pc": r.standard_normal(half) + 1j * r.standard_normal(half)}


JOBS = [dict(type="eigen", group="A", name="eigen", u="u", params=TM,
             lanczos=LANCZOS, steps=STEPS)]


@pytest.fixture(scope="module")
def rings(tmp_path_factory):
    done = {}

    def get(nt):
        if nt not in done:
            done[nt] = spawn(nt, tmp_path_factory.mktemp(f"eigring{nt}"),
                             {"A": DIMS}, JOBS, _inputs())
        return done[nt]
    return get


@functools.lru_cache(maxsize=None)
def _port():
    """The port's unsharded operator and its Lanczos, bounds and
    projections from the same start vector."""
    inp = _inputs()
    d = make_dirac(torch.tensor(inp["u"]), DiracParams(**TM), GT)
    v0 = torch.tensor(inp["v0"])
    ex = torch.zeros_like(v0)
    res = eigen.lanczos(d.matpc_dagm, ex, v0=v0, **LANCZOS)
    bounds = eigen.spectrum_bounds(d.matpc_dagm, ex, LANCZOS["nev"],
                                   steps=STEPS, v0=v0)
    return d, res, bounds


@pytest.mark.parametrize("nt", [1, 2, 4])
def test_lanczos_on_a_ring_is_the_unsharded(rings, nt):
    got = rings(nt)
    _, ref, bounds = _port()
    assert rel(got["eigen/evals"], ref.evals.numpy()) <= 1e-12
    assert float(got["eigen/resid"].max()) < LANCZOS["tol"]
    for v, w in zip(ref.evecs.numpy(), got["eigen/evecs"]):
        assert abs(abs(np.vdot(v, w)) - 1.0) <= 1e-10
    assert rel(got["eigen/bounds"], np.asarray(bounds)) <= 1e-12
    evecs = torch.tensor(got["eigen/evecs"])
    evals = torch.tensor(got["eigen/evals"])
    b = torch.tensor(_inputs()["b_pc"])
    assert rel(got["eigen/project"],
               eigen.project_out(evecs, b).numpy()) <= 1e-12
    assert rel(got["eigen/deflate"],
               eigen.deflate_guess(evecs, evals, b).numpy()) <= 1e-12


@functools.lru_cache(maxsize=None)
def _jax_lanczos():
    d = jmake_dirac(_inputs()["u"], JParams(**TM), GJ)
    ex = jnp.zeros((4, 3) + GJ.lat_shape, jnp.complex128)
    return jeig.lanczos(d.matpc_dagm, ex, key=jax.random.PRNGKey(KEY),
                        **LANCZOS)


@pytest.mark.parametrize("nt", [1, 2, 4])
def test_lanczos_on_a_ring_matches_jax(rings, nt):
    assert rel(rings(nt)["eigen/evals"], _jax_lanczos().evals) <= 1e-10


def test_summed_forms_on_one_rank_are_the_unsharded():
    """The ``allreduce`` branches with a sum over one rank give the
    unsharded numbers; ``allreduce=None`` is the default path, bit for
    bit.  On a 60×60 dense hermitian matrix."""
    r = np.random.default_rng(0)
    a = r.standard_normal((60, 60)) + 1j * r.standard_normal((60, 60))
    h = torch.tensor((a + a.conj().T) / 2 + 8 * np.eye(60))

    def mv(v):
        return h @ v
    one = lambda v: v.clone()       # noqa: E731
    ex = torch.zeros(60, dtype=h.dtype)
    v0 = eigen._start_vector(ex, torch.Generator().manual_seed(1))
    kw = dict(nev=3, ncv=24, tol=1e-9, max_restarts=60, v0=v0)
    ref = eigen.lanczos(mv, ex, **kw)
    same = eigen.lanczos(mv, ex, allreduce=None, **kw)
    assert torch.equal(same.evals, ref.evals)
    assert torch.equal(same.evecs, ref.evecs)
    assert rel(eigen.lanczos(mv, ex, allreduce=one, **kw).evals,
               ref.evals) <= 1e-13
    bounds = eigen.spectrum_bounds(mv, ex, 3, steps=20, v0=v0)
    assert rel(eigen.spectrum_bounds(mv, ex, 3, steps=20, v0=v0,
                                     allreduce=one), bounds) <= 1e-13
    cheb = dict(kw, chebyshev=bounds + (6,))
    assert rel(eigen.lanczos(mv, ex, allreduce=one, **cheb).evals,
               eigen.lanczos(mv, ex, **cheb).evals) <= 1e-13
    b = torch.tensor(r.standard_normal(60) + 1j * r.standard_normal(60))
    for fn in (lambda red: eigen.project_out(ref.evecs, b, red),
               lambda red: eigen.deflate_guess(ref.evecs, ref.evals, b,
                                               red)):
        assert rel(fn(one), fn(None)) <= 1e-13
    x = bicgstab(mv, b, tol=1e-12, maxiter=200)
    y = bicgstab(mv, b, tol=1e-12, maxiter=200, allreduce=one)
    assert x.iters == y.iters and x.iters > 0
    assert rel(y.x, x.x) <= 1e-12
