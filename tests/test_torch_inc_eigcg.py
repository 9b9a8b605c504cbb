"""The port's incremental eigCG (``solvers/inc_eigcg``) against the JAX
package's, on the CPU in complex128.

The JAX tests' settings (``test_inc_eigcg.py``): an ill-conditioned
diagonal operator (eight isolated low modes over a bulk, n = 512) and
twisted-mass κ 0.122, μ 0.03 at 4³×8 (``matpc_dagm``).  Unlike the
JAX file, these are not marked ``slow``: the port's side takes a few
seconds, the JAX references most of the file's ~60 s.  The port's
Lanczos draws its start vector from a ``torch.Generator``; here it is
given the JAX key's vector (through ``solvers.eigen._start_vector``), so
the two harvests start alike and differ only in the reorthogonalisation
order.  Each solve's iterations may then differ from JAX's by at most 2,
every solution is certified at the solve's tolerance, and the space
matches JAX's in size.
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
from quda_qkxtm_multigrid_tpu.solvers.inc_eigcg import IncEigCG as JIncEigCG
from quda_qkxtm_multigrid_tpu.utils import rng as jrng

from quda_qkxtm_multigrid_tpu_torch import convert
from quda_qkxtm_multigrid_tpu_torch.dirac import DiracParams, make_dirac
from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry
from quda_qkxtm_multigrid_tpu_torch.solvers import eigen
from quda_qkxtm_multigrid_tpu_torch.solvers.inc_eigcg import IncEigCG

torch.set_num_threads(1)

GJ = jlat.Geometry(4, 4, 4, 8)
GT = Geometry(4, 4, 4, 8)
T = functools.partial(convert.spinor_from_numpy, device="cpu")


def relres(matvec, x, b) -> float:
    return float((b - matvec(x)).norm() / b.norm())


def _jax_start(key, shape):
    """The JAX ``lanczos`` start vector of ``key`` (complex128)."""
    kr, ki = jax.random.split(key)
    v0 = (jax.random.normal(kr, shape, jnp.float64)
          + 1j * jax.random.normal(ki, shape, jnp.float64))
    return np.asarray(v0 / jnp.sqrt(jnp.real(jnp.vdot(v0, v0))))


@pytest.fixture
def jax_start(monkeypatch):
    """The port's Lanczos starts from the JAX key n_deflated + 1, the
    seed of IncEigCG's default generator."""
    def start(example, gen):
        return T(_jax_start(jax.random.PRNGKey(gen.initial_seed()),
                            tuple(example.shape))).to(example.dtype)
    monkeypatch.setattr(eigen, "_start_vector", start)


def _run(inc_cls, matvec, bs, tol, maxiter, to_field):
    inc, iters, xs = inc_cls(matvec), [], []
    for b in bs:
        res = inc.solve(to_field(b), tol=tol, maxiter=maxiter)
        iters.append(int(res.iters))
        xs.append(res.x)
    return inc, iters, xs


def test_sequence_accelerates(jax_start):
    """Four right-hand sides on cond 1e3: the harvested low modes cut the
    last solve's iterations below half the first's, as in JAX."""
    n = 512
    lows = 1e-3 * (2.0 ** np.arange(8))
    w = np.concatenate([lows, np.linspace(0.5, 1.0, n - 8)])
    key, bs = jax.random.PRNGKey(3), []
    for _ in range(4):
        key, sub = jax.random.split(key)
        bs.append(jax.random.normal(sub, (n,), jnp.float64).astype(
            jnp.complex128))
    jw, tw = jnp.asarray(w), torch.tensor(w)
    kw = dict(nev_per_solve=8, max_nev=24, lanczos_tol=1e-4)
    jinc, jit, _ = _run(lambda mv: JIncEigCG(mv, **kw),
                        lambda v: (jw * v).astype(v.dtype), bs, 1e-8, 3000,
                        jnp.asarray)
    tinc, tit, txs = _run(lambda mv: IncEigCG(mv, **kw), lambda v: tw * v,
                          bs, 1e-8, 3000, lambda b: T(np.asarray(b)))
    assert all(abs(a - b) <= 2 for a, b in zip(jit, tit)), (jit, tit)
    for b, x in zip(bs, txs):
        assert relres(lambda v: tw * v, x, T(np.asarray(b))) < 1e-7
    assert tinc.n_deflated == jinc.n_deflated >= 8
    assert tit[-1] < 0.5 * tit[0], tit
    assert len(tinc.harvests) == 3            # max_nev reached: no fourth
    assert all(h["restarts"] >= 1 and h["matvecs"] > 0
               for h in tinc.harvests)


def test_dirac_sequence(jax_start):
    """The packaged flow on the operator (JAX ``test_dirac_sequence_
    converges``): every solve certified, the space at max_nev, the
    iterations within 2 of JAX's; then the space is orthonormal and its
    Ritz pairs satisfy A v ≈ λ v (``test_space_is_orthonormal_
    eigenbasis``)."""
    u = jrng.random_gauge(jax.random.PRNGKey(0), GJ)
    p = dict(kind="twisted-mass", kappa=0.122, mu=0.03)
    jd = jmake_dirac(u, JParams(**p), GJ)
    td = make_dirac(T(np.asarray(u)), DiracParams(**p), GT)
    # two of the JAX test's three right-hand sides: the second solve is
    # deflated and fills the space to max_nev
    bs = [jd.matpc(jrng.random_spinor(jax.random.PRNGKey(10 + i), GJ)[0],
                   dagger=True) for i in range(2)]
    kw = dict(nev_per_solve=6, max_nev=12, lanczos_tol=1e-2)
    jinc, jit, _ = _run(lambda mv: JIncEigCG(mv, **kw), jd.matpc_dagm, bs,
                        1e-8, 500, lambda b: b)
    tinc, tit, txs = _run(lambda mv: IncEigCG(mv, **kw), td.matpc_dagm, bs,
                          1e-8, 500, lambda b: T(np.asarray(b)))
    assert all(abs(a - b) <= 2 for a, b in zip(jit, tit)), (jit, tit)
    for b, x in zip(bs, txs):
        assert relres(td.matpc_dagm, x, T(np.asarray(b))) < 1e-7
    assert tinc.n_deflated == jinc.n_deflated == 12
    v = tinc.evecs.reshape(12, -1)
    np.testing.assert_allclose((v.conj() @ v.T).numpy(), np.eye(12),
                               atol=1e-12)
    # Ritz values of a dense cluster, each accurate to the Lanczos tol
    scale = float(tinc.evals.abs().max())
    np.testing.assert_allclose(tinc.evals.numpy(), np.asarray(jinc.evals),
                               atol=kw["lanczos_tol"] * scale)
    for i in range(3):
        r = td.matpc_dagm(tinc.evecs[i]) - tinc.evals[i] * tinc.evecs[i]
        assert float(r.norm()) < 5e-2 * max(1.0, abs(float(tinc.evals[i])))
