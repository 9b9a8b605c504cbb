"""The multi-source path of the port against the JAX package's: the plain
version of the multi-source hop (K2) and the multi-source fused matpc
against the Pallas kernel in interpret mode (float32, 3 sources, 1e-5,
at the JAX tests' Geometry(8,4,4,4)); the wrapper against n single-source
hops; ``msrc_cg`` and ``invert_msrc`` against the JAX package in
complex128 (1e-10); the fused float32 ``invert_msrc``; and the wrapper's
operand checks.  Tolerances are normwise relative.
"""

import functools
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from quda_qkxtm_multigrid_tpu import dirac as jd
from quda_qkxtm_multigrid_tpu import lattice as jlat
from quda_qkxtm_multigrid_tpu.invert import invert_msrc as j_invert_msrc
from quda_qkxtm_multigrid_tpu.ops import clover as jcl
from quda_qkxtm_multigrid_tpu.ops import dslash as jdsl
from quda_qkxtm_multigrid_tpu.ops.dslash_pallas import (
    _to_channels as j_to_channels)
from quda_qkxtm_multigrid_tpu.ops.dslash_pallas5 import (
    clover_channels as j_clover_channels, dslash_ch_pallas5_msrc,
    gauge_channels as j_gauge_channels)
from quda_qkxtm_multigrid_tpu.solvers.msrc import msrc_cg as j_msrc_cg
from quda_qkxtm_multigrid_tpu.utils import rng as jrng

from quda_qkxtm_multigrid_tpu_torch import lattice as tlat
from quda_qkxtm_multigrid_tpu_torch import convert
from quda_qkxtm_multigrid_tpu_torch.convert import spinor_to_numpy as N
from quda_qkxtm_multigrid_tpu_torch.dirac import DiracParams
from quda_qkxtm_multigrid_tpu_torch.invert import invert_msrc
from quda_qkxtm_multigrid_tpu_torch.ops import dslash_kernel as dk
from quda_qkxtm_multigrid_tpu_torch.solvers.msrc import msrc_cg

# the tests run on the CPU; the converters default to the card
dirac_from_numpy = functools.partial(convert.dirac_from_numpy, device="cpu")
T = functools.partial(convert.spinor_from_numpy, device="cpu")

torch.set_num_threads(1)

GJ_P = jlat.Geometry(8, 4, 4, 4)     # the JAX Pallas tests' geometry
GT_P = tlat.Geometry(8, 4, 4, 4)
GJ = jlat.Geometry(4, 4, 4, 8)
GT = tlat.Geometry(4, 4, 4, 8)
TMC = dict(kind="twisted-clover", kappa=0.115, mu=0.05, csw=1.0)
TM = dict(kind="twisted-mass", kappa=0.12, mu=0.07, flavor=-1)
N_SRC = 3
F32 = 1e-5       # float32 port vs the Pallas kernel in interpret mode
C128 = 1e-10     # complex128 solvers, port vs JAX


def rel(got, ref) -> float:
    got = N(got) if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.linalg.norm((got - ref).ravel())
                 / np.linalg.norm(ref.ravel()))


@pytest.fixture(scope="module")
def pallas_fields():
    """complex64 gauge and N_SRC float32 channel sources at GJ_P."""
    k = jax.random.split(jax.random.PRNGKey(71), 1 + 2 * N_SRC)
    u = np.asarray(jrng.random_gauge(k[0], GJ_P, dtype=jnp.complex64))
    cols = [np.asarray(j_to_channels(jrng.random_spinor(
        kk, GJ_P, dtype=jnp.complex64)[0])).astype(np.float32)
        for kk in k[1:]]
    return u, np.stack(cols[:N_SRC]), np.stack(cols[N_SRC:])


def test_msrc_reference_matches_pallas(pallas_fields):
    """The plain multi-source hop against ``dslash_ch_pallas5_msrc`` in
    interpret mode, in the clover-forward + xpay form (the second hop of
    the forward matpc)."""
    u, psi, x = pallas_fields
    ud = jdsl.double_gauge(u, GJ_P)
    _, cinv = jcl.make_clover_pair(u, GJ_P, jd.DiracParams(**TMC))
    xc = -TMC["kappa"] ** 2
    ref = dslash_ch_pallas5_msrc(
        j_gauge_channels(ud, 0, True, False), psi, 0, GJ_P, interpret=True,
        recon12=True, clover="fwd",
        cinv_ch=j_clover_channels(cinv, 0, False), xpay_coef=xc, x_ch_b=x)
    got = dk.dslash_ch_msrc_reference(
        dk.gauge_channels(T(np.asarray(ud)), 0, True), T(psi), 0, GT_P,
        recon12=True, clover="fwd",
        cinv_ch=dk.clover_channels(T(np.asarray(cinv)), 0), xpay_coef=xc,
        x_ch=T(x))
    assert rel(got, ref) <= F32


@pytest.mark.parametrize("dagger", [False, True])
def test_fused_matpc_msrc_matches_pallas(pallas_fields, dagger):
    u, psi, _ = pallas_fields
    dj = jd.make_dirac(u, jd.DiracParams(use_pallas=True, **TMC), GJ_P)
    ref = dj._fused_matpc_ch_msrc(jnp.asarray(psi), dagger, interpret=True)
    dt = dirac_from_numpy(u, DiracParams(use_kernels=True, **TMC), GT_P)
    got = dt._fused_matpc_ch(T(psi), dagger, hop=dk.dslash_ch_msrc)
    assert rel(got, ref) <= F32


# ---- the wrapper and the matpc against single-source forms --------------

@pytest.fixture(scope="module")
def dirac_pair():
    k = jax.random.split(jax.random.PRNGKey(72), 1 + N_SRC)
    u = np.asarray(jrng.random_gauge(k[0], GJ))
    cols = torch.stack([dk.to_channels(T(np.asarray(
        jrng.random_spinor(kk, GJ)[0]))) for kk in k[1:]]).to(torch.float32)
    return u, cols


@pytest.mark.parametrize("kind", ["twisted-clover", "twisted-mass"])
@pytest.mark.parametrize("dagger", [False, True])
def test_fused_matpc_msrc_equals_single_source(dirac_pair, kind, dagger):
    """Source by source the multi-source matpc is the single-source one:
    the same hop on the same operands (bit-exact on the CPU)."""
    u, cols = dirac_pair
    d = dirac_from_numpy(u, DiracParams(use_kernels=True,
                                        **(TMC if kind == TMC["kind"]
                                           else TM)), GT)
    got = d._fused_matpc_ch(cols, dagger, hop=dk.dslash_ch_msrc)
    ref = torch.stack([d._fused_matpc_ch(c, dagger) for c in cols])
    assert rel(got, N(ref)) == 0.0


def test_msrc_wrapper_dispatch_and_checks(dirac_pair):
    u, cols = dirac_pair
    d = dirac_from_numpy(u, DiracParams(use_kernels=True, **TMC), GT)
    g = d._operands(torch.float32)["g"][0]
    before = dk.dslash_ch_msrc.launches
    out = dk.dslash_ch_msrc(g, cols, 0, GT, recon12=True)
    assert dk.dslash_ch_msrc.launches == before      # CPU: plain version
    assert rel(out, N(dk.dslash_ch_msrc_reference(g, cols, 0, GT,
                                                  recon12=True))) == 0.0
    with pytest.raises(TypeError, match="float32 only"):
        dk.dslash_ch_msrc(g.double(), cols.double(), 0, GT, recon12=True)
    with pytest.raises(ValueError, match="x_ch shape"):
        dk.dslash_ch_msrc(g, cols, 0, GT, recon12=True, xpay_coef=1.0,
                          x_ch=cols[:2])
    with pytest.raises(ValueError, match="not contiguous"):
        dk.dslash_ch_msrc(g, cols.transpose(3, 4), 0, GT, recon12=True)
    with pytest.raises(ValueError, match=r"\[n, T, 24, Z, W\]"):
        dk.dslash_ch_msrc(g, cols[0], 0, GT, recon12=True)
    with pytest.raises(ValueError, match="post_op"):   # no clover epilogue
        dk.dslash_ch_msrc(g, cols, 0, GT, recon12=True, post_op=("clover",))


# ---- msrc_cg and invert_msrc -------------------------------------------

def _hpd_batch(n=24, n_src=3, seed=5):
    r = np.random.default_rng(seed)
    a = r.standard_normal((n, n)) + 1j * r.standard_normal((n, n))
    a = a.conj().T @ a / n + 0.3 * np.eye(n)
    b = r.standard_normal((n_src, n)) + 1j * r.standard_normal((n_src, n))
    b[0] = np.linalg.eigh(a)[1][:, 0]   # converges in one step, then frozen
    return a, b


def test_msrc_cg_matches_jax():
    a, b = _hpd_batch()
    ref = j_msrc_cg(lambda v: jnp.einsum("ij,nj->ni", a, v), b, tol=1e-8,
                    maxiter=200)
    at = torch.tensor(a)
    got = msrc_cg(lambda v: torch.einsum("ij,nj->ni", at, v), torch.tensor(b),
                  tol=1e-8, maxiter=200)
    assert got.iters == int(ref.iters) > 1
    assert rel(got.x, ref.x) <= C128
    # the recursed |r|² at the last step is round-off, so it is held to
    # the stopping test, not to JAX's value
    b2 = np.sum(np.abs(b) ** 2, axis=1)
    assert np.all(N(got.r2) <= 1e-16 * b2)
    # the source solved at the first step stays frozen at its solution
    np.testing.assert_allclose(N(got.x[0]), np.linalg.solve(a, b[0]),
                               rtol=0, atol=1e-12)


@pytest.fixture(scope="module")
def msrc_problem():
    k = jax.random.split(jax.random.PRNGKey(73), 3)
    u = np.asarray(jrng.random_gauge(k[0], GJ))
    bs = np.stack([np.asarray(jrng.random_spinor(kk, GJ)) for kk in k[1:]])
    return u, bs


def test_invert_msrc_matches_jax(msrc_problem):
    u, bs = msrc_problem
    ref = j_invert_msrc(jd.make_dirac(u, jd.DiracParams(**TM), GJ), bs,
                        tol=1e-9, maxiter=500)
    got = invert_msrc(dirac_from_numpy(u, DiracParams(**TM), GT), T(bs),
                      tol=1e-9, maxiter=500)
    assert got.iters == int(ref.iters)
    assert rel(got.x, ref.x) <= C128
    assert abs(got.true_res - float(ref.true_res)) <= 1e-3 * got.true_res


def test_invert_msrc_fused_float32(msrc_problem):
    """The fused path (float32 channel CG, multi-source matpc) against
    the complex128 plain path of the port on the same operator."""
    u, bs = msrc_problem
    d = dirac_from_numpy(u, DiracParams(use_kernels=True, **TMC), GT)
    got = invert_msrc(d, T(bs), tol=1e-6, maxiter=500)
    ref = invert_msrc(dirac_from_numpy(u, DiracParams(**TMC), GT), T(bs),
                      tol=1e-9, maxiter=500)
    assert got.true_res <= 5e-6
    assert rel(got.x, N(ref.x)) <= 1e-5
