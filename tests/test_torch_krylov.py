"""The port's Krylov tail against the JAX package, on the CPU in
complex128 (part 1): ``solvers/support`` (the residual bitmask, the
heavy-quark residual, the mass-rescale table, ``cg(tol_hq=)``),
``solvers/sd``, ``solvers/pcg`` (``pcg``, ``simple_bicgstab``, ``xsd``)
and ``solvers/pipelined``.

The JAX test's settings (``test_solvers3.py``): twisted-mass κ 0.115,
μ 0.05 at 4³×8, a JAX random gauge and source carried across through
numpy.  Each solver runs in both packages on the same operator and
right-hand side: the iterations must be equal and the solutions agree
to 1e-10, normwise relative.
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
from quda_qkxtm_multigrid_tpu.solvers import pcg as jpcg
from quda_qkxtm_multigrid_tpu.solvers import pipelined as jpipe
from quda_qkxtm_multigrid_tpu.solvers import support as jsup
from quda_qkxtm_multigrid_tpu.solvers.cg import cg as jcg
from quda_qkxtm_multigrid_tpu.solvers.mr import mr as jmr
from quda_qkxtm_multigrid_tpu.solvers.sd import sd as jsd
from quda_qkxtm_multigrid_tpu.utils import rng as jrng

from quda_qkxtm_multigrid_tpu_torch import convert
from quda_qkxtm_multigrid_tpu_torch.dirac import DiracParams, make_dirac
from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry
from quda_qkxtm_multigrid_tpu_torch.solvers import pcg, pipelined, support
from quda_qkxtm_multigrid_tpu_torch.solvers.sd import sd
from quda_qkxtm_multigrid_tpu_torch.solvers.cg import cg
from quda_qkxtm_multigrid_tpu_torch.solvers.mr import mr

torch.set_num_threads(1)

GJ = jlat.Geometry(4, 4, 4, 8)
GT = Geometry(4, 4, 4, 8)
TM = dict(kind="twisted-mass", kappa=0.115, mu=0.05)
SOL_LIMIT = 1e-10
R2_LIMIT = 1e-6
T = functools.partial(convert.spinor_from_numpy, device="cpu")


def rel(got, ref) -> float:
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.linalg.norm((got - ref).ravel())
                 / np.linalg.norm(ref.ravel()))


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


# ---- support --------------------------------------------------------------

def test_mass_rescale_table():
    MN, JMN = support.MassNormalization, jsup.MassNormalization
    k, m5 = 0.12, -1.8
    for st in ("mat", "matdag-mat", "matpc", "matpcdag-matpc"):
        for n, jn in zip(MN, JMN):
            assert (support.mass_rescale_factor(st, n, k)
                    == jsup.mass_rescale_factor(st, jn, k)), (st, n)
        assert (support.mass_rescale_factor(st, MN.MASS, k, m5=m5,
                                            domain_wall=True)
                == jsup.mass_rescale_factor(st, JMN.MASS, k, m5=m5,
                                            domain_wall=True))
    assert support.mass_rescale_factor("matpcdag-matpc", MN.MASS,
                                       k) == 16 * k ** 4
    b = np.ones((3,), np.complex128)
    bs, sh = support.mass_rescale(T(b), shifts=(0.1, 0.2),
                                  solution_type="matpc",
                                  normalization=MN.MASS, kappa=k)
    jbs, jsh = jsup.mass_rescale(jnp.asarray(b), shifts=(0.1, 0.2),
                                 solution_type="matpc",
                                 normalization=JMN.MASS, kappa=k)
    np.testing.assert_allclose(bs.numpy(), np.asarray(jbs), rtol=1e-15)
    np.testing.assert_allclose(sh, jsh, rtol=1e-15)
    with pytest.raises(ValueError, match="unsupported"):
        support.mass_rescale_factor("bogus", MN.MASS, k)


@pytest.mark.parametrize("rt", ["L2_RELATIVE", "L2_ABSOLUTE",
                                "L2_RELATIVE|L2_ABSOLUTE", "HEAVY_QUARK"])
def test_l2_stop_target(rt):
    def flag(enum_cls):
        out = None
        for name in rt.split("|"):
            out = enum_cls[name] if out is None else out | enum_cls[name]
        return out
    for b2 in (2.5, 1e-30):
        got = support.l2_stop_target(torch.tensor(b2, dtype=torch.float64),
                                     1e-3, 1e-9, flag(support.ResidualType))
        want = jsup.l2_stop_target(jnp.asarray(b2), 1e-3, 1e-9,
                                   flag(jsup.ResidualType))
        # the JAX target is float32 (its result_type with jnp.float32)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-7)


def test_heavy_quark_residual(op):
    jd, td, b, tb = op
    rng = np.random.default_rng(3)
    x = rng.standard_normal(b.shape) + 1j * rng.standard_normal(b.shape)
    x[..., 0, 0, 0] = 0.0          # a site with |x|² = 0 contributes 1
    r = np.asarray(jd.matpc_dagm(jnp.asarray(x))) - np.asarray(b)
    got = float(support.heavy_quark_residual_sq(T(x), T(r)))
    want = float(jsup.heavy_quark_residual_sq(jnp.asarray(x),
                                              jnp.asarray(r)))
    assert abs(got - want) <= 1e-14 * want, (got, want)


def test_cg_heavy_quark_stop(op):
    """Both stopping conditions: the hq-gated CG runs at least as long
    as the L2-only one, as in JAX, and ends below both targets."""
    jd, td, b, tb = op
    jres = jcg(jd.matpc_dagm, b, tol=1e-6, maxiter=2000, tol_hq=1e-6)
    tres = cg(td.matpc_dagm, tb, tol=1e-6, maxiter=2000, tol_hq=1e-6)
    _same(jres, tres, "cg(tol_hq)")
    r = tb - td.matpc_dagm(tres.x)
    assert float(torch.sqrt(support.heavy_quark_residual_sq(tres.x, r))) < 1e-6
    l2 = cg(td.matpc_dagm, tb, tol=1e-6, maxiter=2000)
    assert tres.iters >= l2.iters


# ---- sd, pcg, simple_bicgstab, xsd ---------------------------------------

def test_sd_fixed_steps(op):
    """50 steps of SD (JAX ``TestSD``): the same iterate."""
    jd, td, b, tb = op
    jres = jsd(jd.matpc_dagm, b, tol=1e-10, maxiter=50)
    tres = sd(td.matpc_dagm, tb, tol=1e-10, maxiter=50)
    _same(jres, tres, "sd")
    r = tb - td.matpc_dagm(tres.x)
    assert float(r.norm() / tb.norm()) < 0.5


@pytest.mark.parametrize("precond", [False, True])
def test_pcg(op, precond):
    """Plain and with the JAX test's MR(4, ω 0.9) preconditioner."""
    jd, td, b, tb = op
    jpre = ((lambda r: jmr(jd.matpc_dagm, r, niter=4, omega=0.9))
            if precond else None)
    tpre = ((lambda r: mr(td.matpc_dagm, r, niter=4, omega=0.9))
            if precond else None)
    jres = jpcg.pcg(jd.matpc_dagm, b, precond=jpre, tol=1e-10, maxiter=500)
    tres = pcg.pcg(td.matpc_dagm, tb, precond=tpre, tol=1e-10, maxiter=500)
    _same(jres, tres, "pcg")
    if precond:
        assert tres.iters < cg(td.matpc_dagm, tb, tol=1e-10,
                               maxiter=2000).iters


def test_simple_bicgstab(op):
    jd, td, b, tb = op
    jres = jpcg.simple_bicgstab(jd.matpc, b, tol=1e-10, maxiter=800)
    tres = pcg.simple_bicgstab(td.matpc, tb, tol=1e-10, maxiter=800)
    _same(jres, tres, "simple_bicgstab")
    r = tb - td.matpc(tres.x)
    assert float(r.norm() / tb.norm()) < 1e-9


def test_xsd(op):
    jd, td, b, tb = op
    jres = jpcg.xsd(jd.matpc_dagm, b, tol=1e-4, maxiter=2000)
    tres = pcg.xsd(td.matpc_dagm, tb, tol=1e-4, maxiter=2000)
    _same(jres, tres, "xsd")


# ---- pipelined CG ---------------------------------------------------------

def test_pipelined_cg(op):
    jd, td, b, tb = op
    jres = jpipe.pipelined_cg(jd.matpc_dagm, b, tol=1e-10, maxiter=600)
    tres = pipelined.pipelined_cg(td.matpc_dagm, tb, tol=1e-10, maxiter=600)
    _same(jres, tres, "pipelined_cg")
    assert abs(tres.iters - cg(td.matpc_dagm, tb, tol=1e-10).iters) <= 5


def test_pipelined_one_read(op, monkeypatch):
    """γ and δ reach the host in one read an iteration."""
    _, td, _, tb = op
    reads = []
    real = torch.Tensor.tolist

    def counted(t):
        reads.append(t.shape)
        return real(t)
    monkeypatch.setattr(torch.Tensor, "tolist", counted)
    res = pipelined.pipelined_cg(td.matpc_dagm, tb, tol=1e-6, maxiter=100)
    assert len(reads) == res.iters + 1 and all(s == (2,) for s in reads)


def test_pipelined_cg_reliable(op):
    """c128 outer, c64 inner (the JAX test's pair of operators)."""
    jd, td, b, tb = op
    jlo = jax.tree.map(
        lambda a: a.astype(jnp.complex64)
        if hasattr(a, "dtype") and jnp.issubdtype(a.dtype,
                                                  jnp.complexfloating)
        else a, jd)
    tlo = make_dirac(td.u.to(torch.complex64), td.params, GT)
    jres = jpipe.pipelined_cg_reliable(jd.matpc_dagm, jlo.matpc_dagm, b,
                                       tol=1e-9, inner_tol=1e-4)
    tres = pipelined.pipelined_cg_reliable(td.matpc_dagm, tlo.matpc_dagm, tb,
                                           tol=1e-9, inner_tol=1e-4)
    # the inner solves run in complex64: the sums differ in float32
    # rounding, the iterations and the certified result do not
    assert int(jres.iters) == tres.iters
    assert rel(tres.x, jres.x) < 1e-8
    r = tb - td.matpc_dagm(tres.x)
    assert float(r.norm() / tb.norm()) < 1e-8
