"""The port's domain-wall operators (``ops/domain_wall.py``: Shamir
4D-PC and Möbius / zMöbius) against the JAX package's, on the CPU at
4³×8.

Inputs from numpy seeds: an SU(3) gauge (periodic, and with the JAX
``apply_t_boundary``) and 5D fields [Ls, 2, 4, 3, T, Z, W].  Three
routes of the port: the plain complex operator (``dslash_parity`` a
slice), the kernel route in complex128 (channels [Ls, T, 24, Z, W], the
single-source hop's plain version a slice, as K1 f64 runs on the card)
and in complex64 (the multi-source hop's plain version at n = Ls, as K2
runs).  Operator applications agree with JAX to 1e-12 relative in
complex128 (complex64: 2e-6); solves take the JAX iteration count and
agree to 1e-10.  The JAX tests' properties are mirrored
(``tests/test_staggered_dw.py:98-147``, ``tests/test_mobius.py``: the
dslash5 structure, the decoupled slices, the adjoints, D̃5⁻¹'s
exactness, zMöbius per-s coefficients, the Shamir limit), unmarked at
Ls ≤ 8.  On the card (``cuda``-marked): the hop of all Ls slices, through
``dslash4`` or the ``Hop4D`` called directly, is one K2 launch and equals
the plain ``dslash_parity`` of each slice.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from quda_qkxtm_multigrid_tpu import lattice as jlat
from quda_qkxtm_multigrid_tpu.ops import domain_wall as jdw
from quda_qkxtm_multigrid_tpu.ops import gauge as jgauge
from quda_qkxtm_multigrid_tpu.solvers.cg import cg as jcg

from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry
from quda_qkxtm_multigrid_tpu_torch.ops import domain_wall as dw
from quda_qkxtm_multigrid_tpu_torch.ops import dslash_kernel as dk
from quda_qkxtm_multigrid_tpu_torch.ops.dslash import dslash_parity
from quda_qkxtm_multigrid_tpu_torch.solvers.cg import cg

torch.set_num_threads(1)

GJ = jlat.Geometry(4, 4, 4, 8)
GT = Geometry(4, 4, 4, 8)
LS = 6                                   # the JAX Shamir tests' Ls
LS_M = 8                                 # the JAX Möbius tests' Ls
MFERM, M5_SHAMIR = 0.1, 1.5
M5, B5, C5 = -1.5, 1.5, 0.5              # tests/test_mobius.py:17-21
B5_S, C5_S = np.linspace(1.2, 1.8, LS_M), np.linspace(0.2, 0.8, LS_M)
LIMIT = {torch.complex128: 1e-12, torch.complex64: 2e-6}
ROUTES = [("periodic", torch.complex128, False),
          ("periodic", torch.complex128, True),
          ("periodic", torch.complex64, True),
          ("antiperiodic", torch.complex128, True)]


def rel(got, ref) -> float:
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.linalg.norm((got - ref).ravel())
                 / np.linalg.norm(ref.ravel()))


def su3_gauge(seed: int) -> np.ndarray:
    """SU(3) links [4, 2, 3, 3, T, Z, W]: Gaussian matrices, Gram-Schmidt
    on rows 0 and 1, row 2 = conj(r0 × r1)."""
    rng = np.random.default_rng(seed)
    shape = (3, 3, 4, 2) + GJ.lat_shape
    a = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    r0 = a[0] / np.sqrt((np.abs(a[0]) ** 2).sum(0))
    r1 = a[1] - (r0.conj() * a[1]).sum(0) * r0
    r1 = r1 / np.sqrt((np.abs(r1) ** 2).sum(0))
    m = np.stack([r0, r1, np.cross(r0, r1, axis=0).conj()])
    return np.ascontiguousarray(np.moveaxis(m, (0, 1), (2, 3)))


def field5(seed: int, ls: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    shape = (ls, 2, 4, 3) + GJ.lat_shape
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


@pytest.fixture(scope="module")
def flds():
    u = su3_gauge(201)
    return {"periodic": u,
            "antiperiodic": np.asarray(jgauge.apply_t_boundary(jnp.asarray(u),
                                                          GJ)),
            "psi": field5(202, LS), "psi_m": field5(203, LS_M),
            "chi_m": field5(204, LS_M)}


def _hop(flds, gauge, dtype, kernels):
    return dw.Hop4D(torch.tensor(flds[gauge]).to(dtype), GT,
                    use_kernels=kernels)


def _t(a, dtype):
    return torch.tensor(np.asarray(a)).to(dtype)


_JAX = {}


def jax_out(key, fn):
    """The JAX package's output for ``key``, computed once a module (the
    routes compare against the same JAX value)."""
    if key not in _JAX:
        _JAX[key] = np.asarray(fn())
    return _JAX[key]


@pytest.mark.parametrize("gauge,dtype,kernels", ROUTES)
def test_shamir_operators_match_jax(flds, gauge, dtype, kernels):
    h = _hop(flds, gauge, dtype, kernels)
    assert h.hop_kw == dict(recon12=True,
                            antiperiodic=gauge == "antiperiodic")
    u, psi = flds[gauge], flds["psi"]
    tp = _t(psi, dtype)
    k = dw.kappa5(M5_SHAMIR)
    cases = []
    for dg in (False, True):
        cases += [
            (f"dslash4 dagger {dg}", dw.dslash4(h, tp[:, 1], 0, GT, dg),
             lambda dg=dg: jdw.dslash4(u, psi[:, 1], 0, GJ, dg)),
            (f"dslash4 parity 1 dagger {dg}",
             dw.dslash4(h, tp[:, 0], 1, GT, dg),
             lambda dg=dg: jdw.dslash4(u, psi[:, 0], 1, GJ, dg)),
            (f"dslash5 dagger {dg}", dw.dslash5(tp[:, 0], MFERM, dg),
             lambda dg=dg: jdw.dslash5(psi[:, 0], MFERM, dg)),
            (f"dw4d_mat dagger {dg}",
             dw.dw4d_mat(h, tp, k, MFERM, GT, dg),
             lambda dg=dg: jdw.dw4d_mat(u, psi, k, MFERM, GJ, dg)),
            (f"dw4d_matpc dagger {dg}",
             dw.dw4d_matpc(h, tp[:, 1], k, MFERM, GT, 1, dg),
             lambda dg=dg: jdw.dw4d_matpc(u, psi[:, 1], k, MFERM, GJ, 1, dg))]
    for label, got, want in cases:
        assert got.dtype == dtype, label
        want = jax_out((gauge, label), want)
        assert rel(got.to(torch.complex128), want) < LIMIT[dtype], label


@pytest.mark.parametrize("gauge,dtype,kernels", ROUTES)
@pytest.mark.parametrize("per_s", [False, True])
def test_mobius_operators_match_jax(flds, gauge, dtype, kernels, per_s):
    h = _hop(flds, gauge, dtype, kernels)
    u, psi = flds[gauge], flds["psi_m"]
    tp = _t(psi, dtype)
    b5, c5 = (B5_S, C5_S) if per_s else (B5, C5)
    kb, kc, k5 = dw.mdw_kappas(b5, c5, M5, LS_M)
    for a, b in zip((kb, kc, k5), jdw.mdw_kappas(b5, c5, M5, LS_M)):
        assert np.array_equal(a, b)
    cases = []
    for dg in (False, True):
        cases += [
            (f"dslash4_pre {dg}", dw.mdw_dslash4_pre(tp[:, 0], b5, c5,
                                                     MFERM, dg),
             lambda dg=dg: jdw.mdw_dslash4_pre(psi[:, 0], b5, c5, MFERM, dg)),
            (f"dslash5 {dg}", dw.mdw_dslash5(tp[:, 1], k5, MFERM, dg),
             lambda dg=dg: jdw.mdw_dslash5(psi[:, 1], k5, MFERM, dg)),
            (f"dslash5_inv {dg}", dw.mdw_dslash5_inv(tp[:, 1], k5, MFERM,
                                                     dg),
             lambda dg=dg: jdw.mdw_dslash5_inv(psi[:, 1], k5, MFERM, dg)),
            (f"mdw_mat {dg}", dw.mdw_mat(h, tp, M5, MFERM, b5, c5, GT, dg),
             lambda dg=dg: jdw.mdw_mat(u, psi, M5, MFERM, b5, c5, GJ, dg)),
            (f"mdw_matpc {dg}",
             dw.mdw_matpc(h, tp[:, 0], M5, MFERM, b5, c5, GT, 0, dg),
             lambda dg=dg: jdw.mdw_matpc(u, psi[:, 0], M5, MFERM, b5, c5,
                                         GJ, 0, dg))]
    for label, got, want in cases:
        assert got.dtype == dtype, label
        want = jax_out((gauge, per_s, label), want)
        assert rel(got.to(torch.complex128), want) < LIMIT[dtype], label


def test_site_local_functions_take_both_layouts(flds):
    """dslash5, D4pre, D̃5 and D̃5⁻¹ on channels equal the complex ones."""
    v = _t(flds["psi_m"][:, 0], torch.complex128)
    _, _, k5 = dw.mdw_kappas(B5_S, C5_S, M5, LS_M)
    fns = [lambda x, d: dw.dslash5(x, MFERM, d),
           lambda x, d: dw.mdw_dslash4_pre(x, B5_S, C5_S, MFERM, d),
           lambda x, d: dw.mdw_dslash5(x, k5, MFERM, d),
           lambda x, d: dw.mdw_dslash5_inv(x, k5, MFERM, d)]
    ch = dw.to_channels5(v)
    assert torch.equal(dw.from_channels5(ch), v)
    for fn in fns:
        for dg in (False, True):
            got = dw.from_channels5(fn(ch, dg))
            assert rel(got, fn(v, dg).numpy()) < 1e-15


def test_d5_inverse_is_built_once_in_float64():
    """``_d5_matrices`` equals JAX's; the inverse is cached per
    (Ls, κ5, mferm) and exact."""
    _, _, k5 = dw.mdw_kappas(B5_S, C5_S, M5, LS_M)
    mats = dw._d5_matrices(LS_M, k5, MFERM)
    assert np.array_equal(mats, jdw._d5_matrices(LS_M, k5, MFERM))
    key = (LS_M, tuple(float(k) for k in k5), MFERM, False)
    inv = dw._d5_inverse(*key)
    assert inv.dtype == np.complex128 and dw._d5_inverse(*key) is inv
    eye = np.broadcast_to(np.eye(LS_M), mats.shape)
    assert np.abs(np.einsum("tsr,trq->tsq", inv, mats) - eye).max() < 1e-13


def test_dslash5_structure(flds):
    """Upper spins from the PL (s−1) hop, lower from PR (s+1), −mferm on
    the wrap (JAX ``test_dslash5_structure``)."""
    psi = flds["psi"][:, 0]
    out = dw.dslash5(torch.tensor(psi), mferm=0.3).numpy()
    bwd = np.roll(psi, 1, axis=0)
    bwd[0] *= -0.3
    fwd = np.roll(psi, -1, axis=0)
    fwd[-1] *= -0.3
    assert np.abs(out[:, :2] - 2 * bwd[:, :2]).max() < 1e-12
    assert np.abs(out[:, 2:] - 2 * fwd[:, 2:]).max() < 1e-12


@pytest.mark.parametrize("kernels", [False, True])
def test_dslash4_decouples_into_wilson_slices(flds, kernels):
    """The 4D part is the Wilson hop of each slice (JAX
    ``test_mat_reduces_to_wilson_per_slice_when_decoupled``)."""
    ut = torch.tensor(flds["periodic"])
    psi = torch.tensor(flds["psi"])
    d4 = dw.dslash4(dw.Hop4D(ut, GT, kernels), psi[:, 1], 0, GT)
    for s in range(LS):
        ref = dslash_parity(ut, psi[s, 1], 0, GT)
        assert float((d4[s] - ref).abs().max()) < 1e-12


def _vdot(a, b) -> complex:
    return complex(torch.vdot(a.reshape(-1), b.reshape(-1)))


@pytest.mark.parametrize("kernels", [False, True])
def test_dagger_is_the_adjoint(flds, kernels):
    """Shamir ``dw4d_mat``, Möbius ``mdw_mat`` (scalar and per-s b5 / c5)
    and ``mdw_matpc``: <y, M x> = <M† y, x>."""
    h = dw.Hop4D(torch.tensor(flds["antiperiodic"]), GT, kernels)
    x, y = torch.tensor(flds["psi"]), torch.tensor(field5(205, LS))
    k = dw.kappa5(M5_SHAMIR)
    lhs = _vdot(y, dw.dw4d_mat(h, x, k, MFERM, GT))
    rhs = _vdot(dw.dw4d_mat(h, y, k, MFERM, GT, dagger=True), x)
    assert abs(lhs - rhs) <= 1e-11 * abs(lhs)
    x, y = torch.tensor(flds["psi_m"]), torch.tensor(flds["chi_m"])
    for b5, c5 in ((B5, C5), (B5_S, C5_S)):
        mx = dw.mdw_mat(h, x, M5, MFERM, b5, c5, GT)
        mdy = dw.mdw_mat(h, y, M5, MFERM, b5, c5, GT, dagger=True)
        assert abs(_vdot(y, mx) - _vdot(mdy, x)) < 1e-8
        mx = dw.mdw_matpc(h, x[:, 0], M5, MFERM, b5, c5, GT)
        mdy = dw.mdw_matpc(h, y[:, 0], M5, MFERM, b5, c5, GT, dagger=True)
        assert abs(_vdot(y[:, 0], mx) - _vdot(mdy, x[:, 0])) < 1e-8


@pytest.mark.parametrize("dagger", [False, True])
def test_dslash5_inverse_is_exact(flds, dagger):
    """D̃5⁻¹ D̃5 = 1, scalar and per-s (zMöbius) coefficients."""
    v = torch.tensor(flds["psi_m"][:, 0])
    for b5, c5 in ((B5, C5), (B5_S, C5_S)):
        _, _, k5 = dw.mdw_kappas(b5, c5, M5, LS_M)
        w = dw.mdw_dslash5(v, k5, MFERM, dagger)
        back = dw.mdw_dslash5_inv(w, k5, MFERM, dagger)
        assert float((back - v).abs().max()) < 1e-10


def test_mobius_shamir_limit(flds):
    """b5 = 1, c5 = 0 gives the Shamir operator at κ = 1/(2(5 + m5))."""
    ut, psi = torch.tensor(flds["periodic"]), torch.tensor(flds["psi_m"])
    m5 = -1.8
    got = dw.mdw_mat(ut, psi, m5, MFERM, 1.0, 0.0, GT)
    want = dw.dw4d_mat(ut, psi, 1.0 / (2.0 * (5.0 + m5)), MFERM, GT)
    assert float((got - want).abs().max()) < 1e-10


def test_shamir_cg_matches_jax(flds):
    """CG on the normal equations of ``dw4d_mat`` (JAX
    ``test_cg_on_normal_equations``) on the plain route: the JAX
    iteration count and solution."""
    u, b = flds["periodic"], flds["psi"]
    k = dw.kappa5(M5_SHAMIR)
    h = dw.Hop4D(torch.tensor(u), GT, use_kernels=False)
    tb = torch.tensor(b)
    mat = lambda v: dw.dw4d_mat(h, v, k, MFERM, GT)              # noqa
    matd = lambda v: dw.dw4d_mat(h, v, k, MFERM, GT, dagger=True)  # noqa
    res = cg(lambda v: matd(mat(v)), matd(tb), tol=1e-10, maxiter=800)
    jmat = lambda v: jdw.dw4d_mat(u, v, k, MFERM, GJ)            # noqa
    jmatd = lambda v: jdw.dw4d_mat(u, v, k, MFERM, GJ, dagger=True)  # noqa
    jres = jcg(lambda v: jmatd(jmat(v)), jmatd(jnp.asarray(b)), tol=1e-10,
               maxiter=800)
    assert res.iters == int(jres.iters) < 800
    assert rel(res.x, jres.x) < 1e-10
    assert float((tb - mat(res.x)).norm() / tb.norm()) < 1e-7


def test_mobius_matpc_cg_matches_jax(flds):
    """CG on M_pc† M_pc (JAX ``test_normal_equation_solve``), on the
    antiperiodic gauge through the kernel route: the JAX count and
    solution, |b − M_pc x| / |b| < 1e-8."""
    u, b = flds["antiperiodic"], flds["psi_m"][:, 0]
    h = dw.Hop4D(torch.tensor(u), GT, use_kernels=True)
    tb = torch.tensor(b)
    mat = lambda v: dw.mdw_matpc(h, v, M5, MFERM, B5, C5, GT)     # noqa
    matd = lambda v: dw.mdw_matpc(h, v, M5, MFERM, B5, C5, GT,    # noqa
                                  dagger=True)
    res = cg(lambda v: matd(mat(v)), matd(tb), tol=1e-10, maxiter=800)
    jmat = lambda v: jdw.mdw_matpc(u, v, M5, MFERM, B5, C5, GJ)   # noqa
    jmatd = lambda v: jdw.mdw_matpc(u, v, M5, MFERM, B5, C5, GJ,  # noqa
                                    dagger=True)
    jres = jcg(lambda v: jmatd(jmat(v)), jmatd(jnp.asarray(b)), tol=1e-10,
               maxiter=800)
    assert res.iters == int(jres.iters) < 800
    assert rel(res.x, jres.x) < 1e-10
    assert float((tb - mat(res.x)).norm() / tb.norm()) < 1e-8


@pytest.mark.parametrize("dtype,hop,n", [(torch.complex64, "k2", 1),
                                         (torch.complex128, "k1", LS)])
def test_kernel_route_hops(flds, monkeypatch, dtype, hop, n):
    """One hop of all Ls slices is one multi-source call at n = Ls in
    complex64 (K2 on the card) and Ls single-source calls in complex128
    (K1 f64), each bare with the gauge's recon-12 keywords; an operator
    crosses to channels once."""
    calls = []
    real_msrc, real_k1 = dk.dslash_ch_msrc, dk.dslash_ch

    def msrc(g, psi, *a, **kw):
        calls.append(("k2", psi.shape[0], sorted(kw)))
        return real_msrc(g, psi, *a, **kw)

    def k1(g, psi, *a, **kw):
        calls.append(("k1", 1, sorted(kw)))
        return real_k1(g, psi, *a, **kw)
    monkeypatch.setattr(dw, "dslash_ch_msrc", msrc)
    monkeypatch.setattr(dw, "dslash_ch", k1)
    h = _hop(flds, "antiperiodic", dtype, True)
    tp = _t(flds["psi"], dtype)
    dw.dw4d_matpc(h, tp[:, 0], dw.kappa5(M5_SHAMIR), MFERM, GT)
    assert len(calls) == 2 * n
    width = LS if hop == "k2" else 1
    assert calls[0] == (hop, width, ["antiperiodic", "recon12"])


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("dtype,hop,n", [(torch.complex64, "k2", 1),
                                         (torch.complex128, "k1", LS)])
def test_hop_called_on_a_complex_field(flds, monkeypatch, dtype, hop, n,
                                       kernels):
    """``Hop4D`` called directly on a complex field: on the kernel route
    it goes through the kernels' channels (one multi-source call, or Ls
    single-source calls), off it through the plain slices; both equal
    the plain ``dslash_parity`` of each slice."""
    calls = []
    real_msrc, real_k1 = dk.dslash_ch_msrc, dk.dslash_ch

    def msrc(*a, **kw):
        calls.append("k2")
        return real_msrc(*a, **kw)

    def k1(*a, **kw):
        calls.append("k1")
        return real_k1(*a, **kw)
    monkeypatch.setattr(dw, "dslash_ch_msrc", msrc)
    monkeypatch.setattr(dw, "dslash_ch", k1)
    h = _hop(flds, "antiperiodic", dtype, kernels)
    psi = _t(flds["psi"], dtype)[:, 1]
    got = h(psi, 0, True)
    assert calls == ([hop] * n if kernels else [])
    want = torch.stack([dslash_parity(h.u, v, 0, GT, True) for v in psi])
    assert got.dtype == dtype
    assert rel(got, want.numpy()) < LIMIT[dtype]


def test_links_off_su3_take_recon18(flds):
    """A gauge that is not SU(3) up to the t boundary's sign (here the
    unit links scaled by 0.9) hops with all 18 reals, and still equals
    JAX."""
    u = 0.9 * np.broadcast_to(np.eye(3).reshape(1, 1, 3, 3, 1, 1, 1),
                              (4, 2, 3, 3) + GJ.lat_shape).astype(complex)
    u = u * np.exp(0.3j)
    h = dw.Hop4D(torch.tensor(u), GT, use_kernels=True)
    assert h.hop_kw == dict(recon12=False)
    psi = flds["psi"]
    got = dw.dslash4(h, torch.tensor(psi[:, 1]), 0, GT)
    assert rel(got, jdw.dslash4(u, psi[:, 1], 0, GJ)) < 1e-12


@pytest.mark.cuda
@pytest.mark.parametrize("gauge", ["periodic", "antiperiodic"])
def test_k2_hop_of_the_slices_on_the_card(flds, gauge):
    """On the card the hop of all Ls slices is one K2 launch at n = Ls,
    equal to the plain ``dslash_parity`` of each slice."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the hop is a CUDA kernel")
    u = torch.tensor(flds[gauge]).to(torch.complex64)
    h = dw.Hop4D(u.cuda(), GT)
    psi = torch.tensor(flds["psi"]).to(torch.complex64)
    for parity in (0, 1):
        for dagger in (False, True):
            before = dk.dslash_ch_msrc.launches
            got = dw.dslash4(h, psi[:, 1 - parity].cuda(), parity, GT,
                             dagger)
            assert dk.dslash_ch_msrc.launches == before + 1
            want = torch.stack([dslash_parity(u, v, parity, GT, dagger)
                                for v in psi[:, 1 - parity]])
            assert rel(got.cpu(), want.numpy()) < 1e-6
            got = h(psi[:, 1 - parity].cuda(), parity, dagger)
            assert dk.dslash_ch_msrc.launches == before + 2
            assert rel(got.cpu(), want.numpy()) < 1e-6
