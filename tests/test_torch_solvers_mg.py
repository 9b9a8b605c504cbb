"""The multigrid's Krylov pieces against the JAX package's, in complex128
on the same inputs: ``mr`` (the smoother), ``gcr_cycle`` (the coarse
solver and the outer cycle, with and without a preconditioner and a
start vector), restarted ``gcr`` and ``bicgstab`` (the null-vector
solver), on a dense non-hermitian matrix and on the twisted-clover
operator at Geometry(4,4,4,8).  Solutions agree to 1e-10 (normwise
relative), iteration counts exactly.
"""

import functools
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from quda_qkxtm_multigrid_tpu import dirac as jd
from quda_qkxtm_multigrid_tpu import lattice as jlat
from quda_qkxtm_multigrid_tpu.solvers.bicgstab import bicgstab as j_bicgstab
from quda_qkxtm_multigrid_tpu.solvers.gcr import (
    gcr as j_gcr, gcr_cycle as j_gcr_cycle)
from quda_qkxtm_multigrid_tpu.solvers.mr import mr as j_mr
from quda_qkxtm_multigrid_tpu.utils import rng as jrng

from quda_qkxtm_multigrid_tpu_torch import lattice as tlat
from quda_qkxtm_multigrid_tpu_torch import convert
from quda_qkxtm_multigrid_tpu_torch.convert import spinor_to_numpy as N
from quda_qkxtm_multigrid_tpu_torch.dirac import DiracParams
from quda_qkxtm_multigrid_tpu_torch.solvers.bicgstab import bicgstab
from quda_qkxtm_multigrid_tpu_torch.solvers.gcr import gcr, gcr_cycle
from quda_qkxtm_multigrid_tpu_torch.solvers.mr import mr

# the tests run on the CPU; the converters default to the card
dirac_from_numpy = functools.partial(convert.dirac_from_numpy, device="cpu")
T = functools.partial(convert.spinor_from_numpy, device="cpu")

torch.set_num_threads(1)

TOL = 1e-10
GJ = jlat.Geometry(4, 4, 4, 8)
GT = tlat.Geometry(4, 4, 4, 8)
TMC = dict(kind="twisted-clover", kappa=0.122, mu=0.03, csw=1.0)


def rel(got, ref) -> float:
    got = N(got) if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.linalg.norm((got - ref).ravel())
                 / np.linalg.norm(ref.ravel()))


@pytest.fixture(scope="module")
def dense():
    """A non-hermitian, well-conditioned 40×40 system, a start vector and
    a fixed linear preconditioner (the inverse diagonal)."""
    r = np.random.default_rng(11)
    n = 40
    a = np.eye(n) + 0.35 * (r.standard_normal((n, n))
                            + 1j * r.standard_normal((n, n))) / np.sqrt(n)
    a += np.diag(1.0 + r.random(n))
    b = r.standard_normal(n) + 1j * r.standard_normal(n)
    x0 = 0.1 * (r.standard_normal(n) + 1j * r.standard_normal(n))
    dinv = 1.0 / np.diag(a)
    at, dt = torch.tensor(a), torch.tensor(dinv)
    return dict(
        b=b, x0=x0,
        jax=(lambda v: jnp.asarray(a) @ v, lambda v: jnp.asarray(dinv) * v),
        port=(lambda v: at @ v, lambda v: dt * v))


@pytest.mark.parametrize("start", [False, True])
def test_mr_matches_jax(dense, start):
    x0 = dense["x0"] if start else None
    ref = j_mr(dense["jax"][0], dense["b"], x0=x0, niter=4, omega=0.85)
    got = mr(dense["port"][0], torch.tensor(dense["b"]),
             x0=None if x0 is None else torch.tensor(x0), niter=4,
             omega=0.85)
    assert rel(got, ref) <= TOL


@pytest.mark.parametrize("precond,start", [(False, False), (True, False),
                                           (True, True)])
def test_gcr_cycle_matches_jax(dense, precond, start):
    x0 = dense["x0"] if start else None
    ref = j_gcr_cycle(dense["jax"][0], dense["b"], n_krylov=6,
                      precond=dense["jax"][1] if precond else None, x0=x0)
    got = gcr_cycle(dense["port"][0], torch.tensor(dense["b"]), n_krylov=6,
                    precond=dense["port"][1] if precond else None,
                    x0=None if x0 is None else torch.tensor(x0))
    assert rel(got, ref) <= TOL


@pytest.mark.parametrize("precond", [False, True])
def test_gcr_matches_jax(dense, precond):
    kw = dict(tol=1e-11, n_krylov=5, max_restarts=40)
    ref = j_gcr(dense["jax"][0], dense["b"],
                precond=dense["jax"][1] if precond else None, **kw)
    got = gcr(dense["port"][0], torch.tensor(dense["b"]),
              precond=dense["port"][1] if precond else None, **kw)
    assert got.iters == int(ref.iters) > 5
    assert rel(got.x, ref.x) <= TOL
    assert float(got.r2) <= 1e-22 * float(np.vdot(dense["b"], dense["b"]).real)


def test_bicgstab_matches_jax_dense(dense):
    ref = j_bicgstab(dense["jax"][0], dense["b"], tol=1e-11, maxiter=200)
    got = bicgstab(dense["port"][0], torch.tensor(dense["b"]), tol=1e-11,
                   maxiter=200)
    assert got.iters == int(ref.iters) > 3
    assert rel(got.x, ref.x) <= TOL


def test_bicgstab_matches_jax_on_the_operator():
    """The null-vector solve of the MG setup without the fused chain:
    BiCGstab on the full twisted-clover M to a loose tolerance."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(81))
    u = np.asarray(jrng.random_gauge(k1, GJ))
    b = np.asarray(jrng.random_spinor(k2, GJ))
    dj = jd.make_dirac(u, jd.DiracParams(**TMC), GJ)
    dt = dirac_from_numpy(u, DiracParams(**TMC), GT)
    ref = j_bicgstab(dj.m, b, tol=1e-6, maxiter=100)
    got = bicgstab(dt.m, T(b), tol=1e-6, maxiter=100)
    assert got.iters == int(ref.iters) > 3
    assert rel(got.x, ref.x) <= TOL
