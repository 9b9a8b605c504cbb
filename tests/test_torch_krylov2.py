"""The port's Krylov tail against the JAX package, on the CPU (part 2):
``solvers/ca`` (``mpcg``, ``bicgstab_l``), ``solvers/multishift``,
``solvers/mre`` and ``solvers/gmresdr``, with the batched normal
operator ``Dirac.matpc_dagm_batched`` that ``mpcg`` and the history
take on the card.

The JAX tests' settings: twisted-mass κ 0.115, μ 0.05 at 4³×8 in
complex128, a JAX gauge and source carried across through numpy.  The
iterations must be equal and the solutions agree to 1e-10 (normwise
relative); GMRES-DR, whose small problems run in numpy on the host, may
differ by 2 iterations with the solutions at the solve's tolerance.  The
multi-shift solve in complex64 on a diagonal operator shows why the
port freezes a converged shift: there the JAX ζ underflows to NaN.
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
from quda_qkxtm_multigrid_tpu.solvers import ca as jca
from quda_qkxtm_multigrid_tpu.solvers.gmresdr import _harmonic_ritz as jharm
from quda_qkxtm_multigrid_tpu.solvers.gmresdr import gmresdr as jgmresdr
from quda_qkxtm_multigrid_tpu.solvers import mre as jmre
from quda_qkxtm_multigrid_tpu.solvers import multishift as jms
from quda_qkxtm_multigrid_tpu.solvers.cg import cg as jcg
from quda_qkxtm_multigrid_tpu.utils import rng as jrng

from quda_qkxtm_multigrid_tpu_torch import convert
from quda_qkxtm_multigrid_tpu_torch.dirac import DiracParams, make_dirac
from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry
from quda_qkxtm_multigrid_tpu_torch.solvers import ca, mre, multishift
from quda_qkxtm_multigrid_tpu_torch.solvers.gmresdr import (
    _harmonic_ritz, gmresdr)
from quda_qkxtm_multigrid_tpu_torch.solvers.cg import cg

torch.set_num_threads(1)

GJ = jlat.Geometry(4, 4, 4, 8)
GT = Geometry(4, 4, 4, 8)
TM = dict(kind="twisted-mass", kappa=0.115, mu=0.05)
SOL_LIMIT = 1e-10
R2_LIMIT = 1e-6
SHIFTS = (0.0, 0.05, 0.2, 1.0)
T = functools.partial(convert.spinor_from_numpy, device="cpu")


def rel(got, ref) -> float:
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.linalg.norm((got - ref).ravel())
                 / np.linalg.norm(ref.ravel()))


def relres(matvec, x, b) -> float:
    return float((b - matvec(x)).norm() / b.norm())


@pytest.fixture(scope="module")
def op():
    """(JAX operator, port operator, JAX b, port b), one parity."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    u = jrng.random_gauge(k1, GJ, dtype=jnp.complex128)
    jd = jmake_dirac(u, JParams(**TM), GJ)
    b = jrng.random_spinor(k2, GJ, dtype=jnp.complex128)[0]
    td = make_dirac(T(np.asarray(u)), DiracParams(**TM), GT)
    return jd, td, b, T(np.asarray(b))


def _same(jres, tres, label: str):
    """Equal iterations, solutions within SOL_LIMIT, and the final
    recursed |r|² within R2_LIMIT: two converged solutions agree whatever
    the Krylov path, the last residual records the path."""
    assert int(jres.iters) == int(tres.iters), (label, int(jres.iters),
                                                 int(tres.iters))
    err = rel(tres.x, jres.x)
    assert err < SOL_LIMIT, (label, err)
    r2, jr2 = float(tres.r2), float(jres.r2)
    assert abs(r2 - jr2) <= R2_LIMIT * jr2, (label, r2, jr2)


# ---- s-step CG and BiCGstab(L) ------------------------------------------

@pytest.mark.parametrize("batched", [False, True])
def test_mpcg(op, batched):
    jd, td, b, tb = op
    jres = jca.mpcg(jd.matpc_dagm, b, s=4, tol=1e-10, max_blocks=500)
    tres = ca.mpcg(td.matpc_dagm, tb, s=4, tol=1e-10, max_blocks=500,
                   matvec_batched=td.matpc_dagm_batched if batched else None)
    _same(jres, tres, "mpcg")


def test_bicgstab_l(op):
    jd, td, b, tb = op
    jres = jca.bicgstab_l(jd.matpc, b, L=2, tol=1e-10, maxiter=800)
    tres = ca.bicgstab_l(td.matpc, tb, L=2, tol=1e-10, maxiter=800)
    _same(jres, tres, "bicgstab_l")
    assert relres(td.matpc, tres.x, tb) < 1e-9


def test_matpc_dagm_batched_is_n_chains():
    """On the fused chain in float32 the batch runs the multi-source hop
    (its plain version here): the same numbers as n single chains."""
    gen = torch.Generator().manual_seed(5)
    from quda_qkxtm_multigrid_tpu_torch.utils import rng
    u = rng.random_gauge(gen, GT, dtype=torch.complex128).to(torch.complex64)
    d = make_dirac(u, DiracParams(kind="twisted-clover", kappa=0.115,
                                  mu=0.05, csw=1.0, use_kernels=True), GT)
    v = rng.random_spinor(gen, GT, torch.complex64, batch_shape=(3,))[:, 0]
    got = d.matpc_dagm_batched(v)
    want = torch.stack([d.matpc_dagm(a) for a in v])
    assert torch.equal(got, want)


# ---- multi-shift CG ---------------------------------------------------------

def test_multishift_cg(op):
    """Tol 1e-12: a shift frozen at its target (the reference's rule,
    which the JAX function lacks) is then within 1e-10 of JAX's."""
    jd, td, b, tb = op
    jres = jms.multishift_cg(jd.matpc_dagm, b, SHIFTS, tol=1e-12,
                             maxiter=600)
    tres = multishift.multishift_cg(td.matpc_dagm, tb, SHIFTS, tol=1e-12,
                                    maxiter=600)
    _same(jres, tres, "multishift_cg")
    for i, s in enumerate(SHIFTS):
        assert relres(lambda v: td.matpc_dagm(v) + s * v, tres.x[i],
                      tb) < 1e-11, s


def test_multishift_cg_refined(op):
    """The JAX test's loose pass (tol 1e-4) and 1e-10 refinement.  The
    pass's iterations are JAX's; a shift the port froze at the pass's
    target starts its refinement from a guess at that target, where the
    JAX shift kept improving with the base system, so its refinement may
    take more iterations than JAX's, never fewer, and ends at the same
    solution."""
    jd, td, b, tb = op
    kw = dict(tol=1e-4, maxiter=200, refine_tol=1e-10, refine_maxiter=300)
    jres = jms.multishift_cg_refined(jd.matpc_dagm, b, SHIFTS, **kw)
    tres = multishift.multishift_cg_refined(td.matpc_dagm, tb, SHIFTS, **kw)
    assert int(jres.iters) == tres.iters
    jit = [int(i) for i in jres.refine_iters]
    assert tres.refine_iters[0] == jit[0]       # σ = 0 is the base system
    assert all(t >= j for t, j in zip(tres.refine_iters, jit)), (
        tres.refine_iters, jit)
    assert rel(tres.x, jres.x) < SOL_LIMIT
    for i, s in enumerate(SHIFTS):
        assert relres(lambda v: td.matpc_dagm(v) + s * v, tres.x[i],
                      tb) < 1e-9, s


def test_multishift_complex64_underflow():
    """A long complex64 solve on a diagonal operator: the ζ of the large
    shifts underflows and the JAX solution turns NaN; the port's frozen
    shifts stay finite and solved."""
    n = 512
    w = np.concatenate([np.linspace(1e-3, 1e-2, 8), np.linspace(0.5, 1, n - 8)])
    b = np.random.default_rng(1).standard_normal(n).astype(np.complex64)
    shifts = (0.0, 1.0, 10.0, 100.0)
    jres = jms.multishift_cg(lambda v: (jnp.asarray(w) * v).astype(v.dtype),
                             jnp.asarray(b), shifts, tol=1e-6, maxiter=2000)
    tw = torch.tensor(w, dtype=torch.float32)
    tres = multishift.multishift_cg(lambda v: tw * v, torch.tensor(b), shifts,
                                    tol=1e-6, maxiter=2000)
    assert int(jres.iters) == tres.iters
    jx = np.asarray(jres.x)
    assert not np.isfinite(jx).all()            # the JAX ζ underflowed
    assert torch.isfinite(tres.x).all()
    for i, s in enumerate(shifts):
        res = relres(lambda v: tw * v + s * v, tres.x[i], torch.tensor(b))
        assert res < 2e-6, (s, res)
        if np.isfinite(jx[i]).all():            # the same as JAX's there
            assert rel(tres.x[i], jx[i]) < 1e-5, s


# ---- minimum-residual extrapolation -----------------------------------------

def test_min_res_ext_in_span(op):
    """b = A x for x in the history span: the guess is (nearly) exact and
    equals JAX's."""
    jd, td, _, _ = op
    ks = jax.random.split(jax.random.PRNGKey(8), 3)
    hist = jnp.stack([jrng.random_spinor(k, GJ)[0] for k in ks])
    coeff = jnp.asarray([0.3 + 0.1j, -0.5, 1.2j], hist.dtype)
    b = jd.matpc(jnp.einsum("j,j...->...", coeff, hist))
    want = jmre.min_res_ext(jd.matpc, b, hist)
    got = mre.min_res_ext(td.matpc, T(np.asarray(b)), T(np.asarray(hist)))
    assert rel(got, want) < SOL_LIMIT
    assert relres(td.matpc, got, T(np.asarray(b))) < 1e-5


def test_chrono_history(op):
    """Three nearby solves (JAX ``test_chrono_accelerates_cg``, cut to
    three): each guess and each CG from it as JAX's, through the batched
    operator; the last solve needs fewer iterations than the first."""
    jd, td, b0, _ = op
    jh, th = jmre.ChronoHistory(depth=4), mre.ChronoHistory(depth=4)
    assert float(th.guess(td.matpc_dagm, T(np.asarray(b0))).abs().sum()) == 0
    iters = []
    for i in range(3):
        b = b0 + 0.05 * jrng.random_spinor(jax.random.PRNGKey(30 + i), GJ)[0]
        rhs = jd.matpc(b, dagger=True)
        jx0 = jh.guess(jd.matpc_dagm, rhs)
        tx0 = th.guess(td.matpc_dagm, T(np.asarray(rhs)),
                       matvec_batched=td.matpc_dagm_batched)
        if i:                                   # the empty history gives 0
            assert rel(tx0, jx0) < SOL_LIMIT
        jres = jcg(jd.matpc_dagm, rhs, x0=jx0, tol=1e-8, maxiter=500)
        tres = cg(td.matpc_dagm, T(np.asarray(rhs)), x0=tx0, tol=1e-8,
                  maxiter=500)
        _same(jres, tres, f"chrono cg {i}")
        jh.push(jres.x)
        th.push(tres.x)
        iters.append(tres.iters)
    assert iters[-1] < iters[0], iters


# ---- GMRES-DR ---------------------------------------------------------------

def test_gmresdr(op):
    """JAX ``TestGMResDR.test_solves_matpc``'s settings."""
    jd, td, b, tb = op
    kw = dict(tol=1e-9, n_krylov=16, n_defl=6, max_restarts=60)
    jres = jgmresdr(jd.matpc, b, **kw)
    tres = gmresdr(td.matpc, tb, **kw)
    assert abs(int(jres.iters) - tres.iters) <= 2, (int(jres.iters),
                                                    tres.iters)
    assert relres(td.matpc, tres.x, tb) < 1e-9
    assert rel(tres.x, jres.x) < 1e-7


def test_harmonic_ritz():
    """The host eigenproblem of the deflated restart, on a random
    Hessenberg matrix: the same vectors as JAX's copy."""
    rng = np.random.default_rng(2)
    h = np.triu(rng.standard_normal((11, 10))
                + 1j * rng.standard_normal((11, 10)), -1)
    np.testing.assert_allclose(_harmonic_ritz(h, 10, 4), jharm(h, 10, 4),
                               atol=1e-13)


@pytest.mark.cuda
def test_matpc_dagm_batched_on_the_card():
    """On the card the batch is one four-hop K2 chain (four launches),
    equal to n single K1 chains to float32 rounding (the sum order is
    K1's), and to the CPU kernel route's plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the chain runs CUDA kernels")
    from quda_qkxtm_multigrid_tpu_torch.ops import dslash_kernel as dk
    from quda_qkxtm_multigrid_tpu_torch.utils import rng
    gen = torch.Generator().manual_seed(5)
    u = rng.random_gauge(gen, GT, dtype=torch.complex128).to(torch.complex64)
    v = rng.random_spinor(gen, GT, torch.complex64, batch_shape=(3,))[:, 0]
    params = DiracParams(kind="twisted-clover", kappa=0.115, mu=0.05,
                         csw=1.0, use_kernels=True)
    d = make_dirac(u.cuda(), params, GT)
    before = dk.dslash_ch_msrc.launches
    got = d.matpc_dagm_batched(v.cuda())
    assert dk.dslash_ch_msrc.launches == before + 4
    singles = torch.stack([d.matpc_dagm(a) for a in v.cuda()])
    assert rel(got.cpu(), singles.cpu().numpy()) < 1e-6
    want = make_dirac(u, params, GT).matpc_dagm_batched(v)
    assert rel(got.cpu(), want.numpy()) < 1e-6
