"""The non-degenerate twisted-mass doublet of the port (``DiracNdeg``,
``make_dirac_ndeg``, ``ops.twist.ndeg_twist_apply``) against the JAX
package's, on the CPU.

The JAX test's settings (``test_ndeg.py``): 4³×8, twisted-mass κ 0.115,
μ 0.05, ε 0.02, a JAX random gauge and doublet carried across through
numpy (``spinor_from_numpy`` takes a doublet [2f, 2p, 4, 3, T, Z, W] as
it is).  ``m``, ``mdag``, ``matpc`` (both daggers), ``prepare``,
``reconstruct`` and the twist agree to 1e-12 in complex128, on the
plain operator and on the kernel route (``use_kernels``: channel
doublets, here the hops' plain versions); the complex64 kernel route
runs the multi-source hop at n = 2 and agrees to float32 rounding.  An
antiperiodic gauge goes through the recon-12 route, which must restore
the boundary's sign.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from quda_qkxtm_multigrid_tpu import lattice as jlat
from quda_qkxtm_multigrid_tpu.dirac import DiracParams as JParams
from quda_qkxtm_multigrid_tpu.dirac import make_dirac_ndeg as jmake_ndeg
from quda_qkxtm_multigrid_tpu.ops import gauge as jgauge
from quda_qkxtm_multigrid_tpu.ops import twist as jtwist
from quda_qkxtm_multigrid_tpu.solvers.cg import cg as jcg
from quda_qkxtm_multigrid_tpu.utils import rng as jrng

from quda_qkxtm_multigrid_tpu_torch import convert
from quda_qkxtm_multigrid_tpu_torch.dirac import (
    DiracNdeg, DiracParams, make_dirac, make_dirac_ndeg)
from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry
from quda_qkxtm_multigrid_tpu_torch.ops import dslash_kernel as dk
from quda_qkxtm_multigrid_tpu_torch.ops import twist
from quda_qkxtm_multigrid_tpu_torch.solvers.cg import cg

torch.set_num_threads(1)

GJ = jlat.Geometry(4, 4, 4, 8)
GT = Geometry(4, 4, 4, 8)
KAPPA, MU, EPS = 0.115, 0.05, 0.02
ND = dict(kind="twisted-mass", kappa=KAPPA, mu=MU, epsilon=EPS)
LIMIT = {torch.complex128: 1e-12, torch.complex64: 2e-6}
T = functools.partial(convert.spinor_from_numpy, device="cpu")


def rel(got, ref) -> float:
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.linalg.norm((got - ref).ravel())
                 / np.linalg.norm(ref.ravel()))


@pytest.fixture(scope="module")
def fields():
    """JAX gauge, periodic and antiperiodic, and a doublet
    [2f, 2p, 4, 3, T, Z, W] (the JAX test's fixture)."""
    u = jrng.random_gauge(jax.random.PRNGKey(0), GJ)
    k1, k2 = jax.random.split(jax.random.PRNGKey(1))
    psi = jnp.stack([jrng.random_spinor(k1, GJ),
                     jrng.random_spinor(k2, GJ)])
    return {"periodic": u, "antiperiodic": jgauge.apply_t_boundary(u, GJ),
            "psi": psi}


def _pair(u, dtype, use_kernels):
    jd = jmake_ndeg(u, JParams(**ND), GJ)
    td = make_dirac_ndeg(T(np.asarray(u)).to(dtype),
                         DiracParams(**ND, use_kernels=use_kernels), GT)
    return jd, td


ROUTES = [("periodic", torch.complex128, False),
          ("periodic", torch.complex128, True),
          ("periodic", torch.complex64, True),
          ("antiperiodic", torch.complex128, True)]


@pytest.mark.parametrize("gauge,dtype,kernels", ROUTES)
def test_doublet_operator(fields, gauge, dtype, kernels):
    jd, td = _pair(fields[gauge], dtype, kernels)
    if kernels:
        assert td.antiperiodic == (gauge == "antiperiodic")
    psi = fields["psi"]
    tpsi = T(np.asarray(psi)).to(dtype)
    lim = LIMIT[dtype]
    for label, got, want in (
            ("m", td.m(tpsi), jd.m(psi)),
            ("mdag", td.mdag(tpsi), jd.mdag(psi)),
            ("matpc", td.matpc(tpsi[:, 0]), jd.matpc(psi[:, 0])),
            ("matpc dag", td.matpc(tpsi[:, 0], dagger=True),
             jd.matpc(psi[:, 0], dagger=True)),
            ("matpc_dagm", td.matpc_dagm(tpsi[:, 1]),
             jd.matpc_dagm(psi[:, 1])),
            ("prepare", td.prepare(tpsi), jd.prepare(psi)),
            ("reconstruct", td.reconstruct(tpsi[:, 0], tpsi),
             jd.reconstruct(psi[:, 0], psi))):
        assert got.dtype == dtype, label
        err = rel(got.to(torch.complex128), want)
        assert err < lim, (label, err)


def test_k2_route_launches_both_flavours(fields, monkeypatch):
    """The complex64 kernel route hops both flavours in one multi-source
    call (n = 2), bare; the complex128 one calls the single-source hop
    once a flavour."""
    calls = []
    real_msrc, real_k1 = dk.dslash_ch_msrc, dk.dslash_ch
    import quda_qkxtm_multigrid_tpu_torch.dirac as tdirac

    def msrc(g, psi, *a, **kw):
        calls.append(("k2", psi.shape[0], kw.get("twist"), kw.get("clover")))
        return real_msrc(g, psi, *a, **kw)

    def k1(g, psi, *a, **kw):
        calls.append(("k1", psi.dtype))
        return real_k1(g, psi, *a, **kw)
    monkeypatch.setattr(tdirac, "dslash_ch_msrc", msrc)
    monkeypatch.setattr(tdirac, "dslash_ch", k1)
    psi = T(np.asarray(fields["psi"]))
    _, d64 = _pair(fields["periodic"], torch.complex64, True)
    d64.matpc_dagm(psi[:, 0].to(torch.complex64))
    assert calls == [("k2", 2, None, None)] * 4
    calls.clear()
    _, d128 = _pair(fields["periodic"], torch.complex128, True)
    d128.matpc(psi[:, 0])
    assert calls == [("k1", torch.float64)] * 4


@pytest.mark.parametrize("dagger", [False, True])
@pytest.mark.parametrize("inverse", [False, True])
def test_ndeg_twist_apply(fields, dagger, inverse):
    psi = fields["psi"][:, 0]
    want = jtwist.ndeg_twist_apply(psi, KAPPA, MU, EPS, dagger, inverse)
    tpsi = T(np.asarray(psi))
    assert rel(twist.ndeg_twist_apply(tpsi, KAPPA, MU, EPS, dagger, inverse),
               want) < 1e-14
    ch = DiracNdeg.to_ch(tpsi)
    got = DiracNdeg.from_ch(twist.ndeg_twist_apply_ch(ch, KAPPA, MU, EPS,
                                                      dagger, inverse))
    assert rel(got, want) < 1e-14


def test_tau1_gamma5_hermiticity_and_schur(fields):
    """M† = τ1 γ5 M γ5 τ1, and the Schur identities (JAX ``TestDoublet``),
    on the kernel route."""
    _, td = _pair(fields["periodic"], torch.complex128, True)
    psi = T(np.asarray(fields["psi"]))
    g5 = torch.tensor([1, 1, -1, -1], dtype=psi.dtype).reshape(4, 1, 1, 1, 1)

    def t1g5(v):
        return (g5 * v).flip(0)
    assert rel(t1g5(td.m(t1g5(psi))), td.mdag(psi).numpy()) < 1e-13
    b = td.m(psi)
    assert rel(td.matpc(psi[:, 0]), td.prepare(b).numpy()) < 1e-12
    assert rel(td.reconstruct(psi[:, 0], b), psi.numpy()) < 1e-12


def test_degenerate_limit(fields):
    """ε → 0: two single-flavour twisted-mass operators, flavour ±1."""
    u = T(np.asarray(fields["periodic"]))
    psi = T(np.asarray(fields["psi"]))
    d = make_dirac_ndeg(u, DiracParams(**dict(ND, epsilon=1e-30)), GT)
    got = d.m(psi)
    for fl, sign in ((0, +1), (1, -1)):
        ds = make_dirac(u, DiracParams(kind="twisted-mass", kappa=KAPPA,
                                       mu=MU, flavor=sign), GT)
        assert rel(got[fl], ds.m(psi[fl]).numpy()) < 1e-14


def test_cg_solve(fields):
    """JAX ``test_cg_solve``: CG on matpc†matpc, the same iterations and
    solution, and the full doublet system solved."""
    jd, td = _pair(fields["periodic"], torch.complex128, True)
    b = fields["psi"]
    tb = T(np.asarray(b))
    jres = jcg(jd.matpc_dagm, jd.matpc(jd.prepare(b), dagger=True),
               tol=1e-10, maxiter=800)
    tres = cg(td.matpc_dagm, td.matpc(td.prepare(tb), dagger=True),
              tol=1e-10, maxiter=800)
    assert int(jres.iters) == tres.iters
    assert rel(tres.x, jres.x) < 1e-10
    x = td.reconstruct(tres.x, tb)
    assert float((tb - td.m(x)).norm() / tb.norm()) < 1e-8


def test_refusals_and_params(fields):
    u = T(np.asarray(fields["periodic"]))
    for kw in (dict(mu=0.0), dict(epsilon=0.0)):
        with pytest.raises(ValueError, match="requires mu"):
            make_dirac_ndeg(u, DiracParams(**dict(ND, kind="wilson", **kw)),
                            GT)
    with pytest.raises(ValueError, match="bf16"):
        make_dirac_ndeg(u, DiracParams(**ND, use_kernels=True,
                                       kernel_bf16=True), GT)
    with pytest.raises(ValueError, match="make_dirac_ndeg"):
        make_dirac(u, DiracParams(**ND), GT)
    p = convert.params_from_jax(JParams(**ND))
    assert (p.epsilon, p.mu, p.kappa) == (EPS, MU, KAPPA)
    d = make_dirac_ndeg(u, p, GT)
    assert d.flops_per_mat() == jmake_ndeg(fields["periodic"], JParams(**ND),
                                           GJ).flops_per_mat()
    psi = np.asarray(fields["psi"])
    assert np.array_equal(convert.spinor_to_numpy(T(psi)), psi)


@pytest.mark.cuda
@pytest.mark.parametrize("gauge", ["periodic", "antiperiodic"])
def test_k2_doublet_hop_on_the_card(fields, gauge):
    """On the card the complex64 doublet's hop is one K2 launch at n = 2
    (bare), equal to the plain hop of each flavour, and its matpc equals
    the CPU kernel route's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the hop is a CUDA kernel")
    u = T(np.asarray(fields[gauge])).to(torch.complex64)
    psi = T(np.asarray(fields["psi"])).to(torch.complex64)
    ndp = DiracParams(**ND, use_kernels=True)
    dc = make_dirac_ndeg(u.cuda(), ndp, GT)
    dp = make_dirac_ndeg(u, ndp, GT)
    for parity in (0, 1):
        for dagger in (False, True):
            before = dk.dslash_ch_msrc.launches
            got = dc.dslash(psi[:, 1 - parity].cuda(), parity, dagger)
            assert dk.dslash_ch_msrc.launches == before + 1
            want = torch.stack([dp.wilson.dslash(v, parity, dagger)
                                for v in psi[:, 1 - parity]])
            assert rel(got.cpu(), want.numpy()) < 1e-6
    assert rel(dc.matpc(psi[:, 0].cuda()).cpu(),
               dp.matpc(psi[:, 0]).numpy()) < 1e-6
