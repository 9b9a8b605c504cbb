"""The eigensolver and the deflated loops of the port against the JAX
package, on the CPU in complex128.

* ``lanczos`` on a 60×60 dense hermitian matrix against
  ``numpy.linalg.eigvalsh`` (atol 1e-7), and on ``matpc_dagm`` at 4⁴
  against the JAX ``lanczos`` from the same start vector, inside
  ``run_loops_wexact(full_op=False)`` (eigenvalues ≤ 1e-10 relative);
  the Chebyshev-filtered form (``spectrum_bounds``) finds the same
  eigenvalues;
* ``chebyshev_op``, ``deflate_guess`` and ``project_out`` against JAX
  (≤ 1e-13, normwise relative); the deflated guess needs no more CG
  iterations than none;
* ``run_loops_wexact`` in both ``full_op`` modes against the JAX
  function with the same Z4 noise and start vector (≤ 1e-6 a loop type);
* the eigenpair checkpoint: a JAX-written ``.npz`` loads in the port,
  and ``convert.eigenpairs_from_numpy``.

The JAX package draws its start vector and noise from threefry keys,
which the port cannot reproduce: the tests make them with JAX and hand
them to the port through ``solvers.eigen._start_vector`` and
``workflows.z4_source``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from quda_qkxtm_multigrid_tpu import lattice as jlat
from quda_qkxtm_multigrid_tpu import workflows as jwf
from quda_qkxtm_multigrid_tpu.dirac import DiracParams as JParams
from quda_qkxtm_multigrid_tpu.dirac import make_dirac as jmake_dirac
from quda_qkxtm_multigrid_tpu.solvers import eigen as jeig
from quda_qkxtm_multigrid_tpu.utils import checkpoint as jck
from quda_qkxtm_multigrid_tpu.utils import rng as jrng

from quda_qkxtm_multigrid_tpu_torch import convert
from quda_qkxtm_multigrid_tpu_torch import workflows as wf
from quda_qkxtm_multigrid_tpu_torch.dirac import DiracParams, make_dirac
from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry
from quda_qkxtm_multigrid_tpu_torch.solvers import eigen
from quda_qkxtm_multigrid_tpu_torch.solvers.cg import cg
from quda_qkxtm_multigrid_tpu_torch.utils import checkpoint

torch.set_num_threads(1)

GJ = jlat.Geometry(4, 4, 4, 4)
GT = Geometry(4, 4, 4, 4)
TM = dict(kappa=0.115, mu=0.05)


def rel(got, ref) -> float:
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
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
    """The Z4 sources of the JAX workflows' key sequence."""
    out = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jrng.z4_source(sub, GJ, jnp.complex128)))
    return out


@pytest.fixture(scope="module")
def gauge():
    return np.asarray(jrng.random_gauge(jax.random.PRNGKey(2), GJ))


@pytest.fixture(scope="module")
def ops(gauge):
    """The twisted-mass operator of both packages on the same gauge."""
    return (jmake_dirac(gauge, JParams(kind="twisted-mass", **TM), GJ),
            make_dirac(torch.tensor(gauge),
                       DiracParams(kind="twisted-mass", **TM), GT))


def test_lanczos_dense_matrix():
    r = np.random.default_rng(0)
    a = r.standard_normal((60, 60)) + 1j * r.standard_normal((60, 60))
    h = torch.tensor((a + a.conj().T) / 2)
    res = eigen.lanczos(lambda v: h @ v, torch.zeros(60, dtype=h.dtype),
                        nev=5, ncv=30, tol=1e-9, max_restarts=60)
    exact = np.linalg.eigvalsh(h.numpy())[:5]
    np.testing.assert_allclose(res.evals.numpy(), exact, atol=1e-7)
    assert float(res.resid.max()) < 1e-6


WEXACT = dict(kappa=0.115, mu=0.05, csw=0.0, nev=2, n_stoch=2, tol=1e-10,
              maxiter=500, ncv=16, lanczos_tol=1e-9)


def _wexact(gauge, full_op: bool):
    """``run_loops_wexact`` of both packages with the JAX start vector
    and noise of key 8: (port loops, port EigResult, port stats, JAX
    loops, JAX EigResult, unused noise)."""
    key = jax.random.PRNGKey(8)
    shape = ((2,) if full_op else ()) + (4, 3) + GJ.lat_shape
    v0 = _jax_start(key, shape)
    noise = [torch.tensor(a) for a in _jax_noise(key, 2)]
    st = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(eigen, "_start_vector", lambda ex, gen: torch.tensor(v0))
        mp.setattr(wf, "z4_source",
                   lambda gen, geom, dtype: noise.pop(0).to(dtype))
        ours, eig = wf.run_loops_wexact(torch.tensor(gauge), GT,
                                        gen=torch.Generator(), stats=st,
                                        full_op=full_op, **WEXACT)
    theirs, jeig_res = jwf.run_loops_wexact(gauge, GJ, key=key,
                                            full_op=full_op, **WEXACT)
    return ours, eig, st, theirs, jeig_res, noise


@pytest.fixture(scope="module")
def wexact_pc(gauge):
    return _wexact(gauge, False)


@pytest.fixture(scope="module")
def lanczos_pair(wexact_pc):
    """Both packages' ``lanczos`` on ``matpc_dagm`` from the same start
    vector (inside ``run_loops_wexact(full_op=False)``)."""
    _, ours, st, _, theirs, _ = wexact_pc
    return ours, theirs, st["eig"]


def test_lanczos_matches_jax(ops, lanczos_pair):
    ours, theirs, st = lanczos_pair
    assert rel(ours.evals, theirs.evals) <= 1e-10
    assert float(ours.resid.max()) < 1e-8
    assert bool((ours.evals > 0).all())
    assert st["matvecs"] >= 16 and st["restarts"] >= 1
    _, d = ops
    for v, lam in zip(ours.evecs, ours.evals):
        assert float((d.matpc_dagm(v) - lam * v).norm()) < 1e-8


def test_chebyshev_lanczos_finds_the_same_modes(ops, lanczos_pair):
    _, d = ops
    ex = torch.zeros((4, 3) + GT.lat_shape, dtype=torch.complex128)
    gen = torch.Generator().manual_seed(5)
    amin, amax = eigen.spectrum_bounds(d.matpc_dagm, ex, 2, steps=16,
                                       gen=gen)
    assert amin < amax
    res = eigen.lanczos(d.matpc_dagm, ex, nev=2, ncv=16, tol=1e-9, gen=gen,
                        chebyshev=(amin, amax, 8))
    assert float(res.resid.max()) < 1e-9
    assert rel(res.evals, lanczos_pair[0].evals) <= 1e-10


def test_deflation_helpers_match_jax(ops, lanczos_pair):
    jd, d = ops
    ours, _, _ = lanczos_pair
    r = np.random.default_rng(4)
    b = r.standard_normal(ours.evecs.shape[1:]) + 1j * r.standard_normal(
        ours.evecs.shape[1:])
    v, lam = ours.evecs.numpy(), ours.evals.numpy()
    bt = torch.tensor(b)
    assert rel(eigen.deflate_guess(ours.evecs, ours.evals, bt),
               jeig.deflate_guess(v, lam, b)) <= 1e-13
    assert rel(eigen.project_out(ours.evecs, bt),
               jeig.project_out(v, b)) <= 1e-13
    cheb = eigen.chebyshev_op(d.matpc_dagm, 0.3, 3.0, 6)
    jcheb = jeig.chebyshev_op(jd.matpc_dagm, 0.3, 3.0, 6)
    assert rel(cheb(bt), jcheb(jnp.asarray(b))) <= 1e-13
    p = eigen.project_out(ours.evecs, bt).reshape(-1)
    assert float(torch.mv(ours.evecs.reshape(2, -1).conj(), p).abs().max()) \
        < 1e-12
    plain = cg(d.matpc_dagm, bt, tol=1e-10, maxiter=500)
    defl = cg(d.matpc_dagm, bt, x0=eigen.deflate_guess(ours.evecs,
                                                        ours.evals, bt),
              tol=1e-10, maxiter=500)
    assert defl.iters <= plain.iters


@pytest.mark.parametrize("full_op", [False, True])
def test_run_loops_wexact_matches_jax(gauge, wexact_pc, full_op):
    ours, eig, st, theirs, jeig_res, noise = (
        _wexact(gauge, True) if full_op else wexact_pc)
    assert not noise                            # one source a sample
    assert rel(eig.evals, jeig_res.evals) <= 1e-10
    assert len(st["cg_iters"]) == 2
    assert set(st["secs"]) == {"operators", "lanczos", "exact",
                               "stochastic", "finalize"}
    for name, v in ours.items():
        assert rel(v, theirs[name]) <= 1e-6, name


def test_eigenpair_checkpoints(tmp_path, lanczos_pair):
    ours, theirs, _ = lanczos_pair
    jpath = str(tmp_path / "jax_eig.npz")
    jck.save_eigenpairs(jpath, theirs.evals, theirs.evecs, theirs.resid)
    vals, vecs = checkpoint.load_eigenpairs(jpath)
    got = convert.eigenpairs_from_numpy(vals, vecs, device="cpu")
    assert np.array_equal(got.evecs.numpy(), np.asarray(theirs.evecs))
    path = str(tmp_path / "port_eig.npz")
    checkpoint.save_eigenpairs(path, ours.evals, ours.evecs, ours.resid)
    j_vals, j_vecs = jck.load_eigenpairs(path)
    assert np.array_equal(j_vals, ours.evals.numpy())
    assert np.array_equal(j_vecs, ours.evecs.numpy())
    with pytest.raises(ValueError, match="eigenvalues"):
        convert.eigenpairs_from_numpy(vals[:1], vecs, device="cpu")
