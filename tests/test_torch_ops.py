"""The port's lattice, small-matrix, Wilson-hop, twist and clover modules
against the JAX package on the same complex128 fields (CPU).

Fields come from the JAX package's generator, cross to the port as numpy
arrays through ``convert.py``, and both results are compared in numpy.
Tolerance: 1e-12 normwise relative (both sides sum in the same order;
only the last bits may differ).
"""

import functools
import numpy as np
import jax
import pytest
import torch

from quda_qkxtm_multigrid_tpu import fields as jfields
from quda_qkxtm_multigrid_tpu import lattice as jlat
from quda_qkxtm_multigrid_tpu.dirac import DiracParams as JParams
from quda_qkxtm_multigrid_tpu.ops import clover as jcl
from quda_qkxtm_multigrid_tpu.ops import dslash as jdsl
from quda_qkxtm_multigrid_tpu.ops import gamma as jgamma
from quda_qkxtm_multigrid_tpu.ops import smallmat as jsm
from quda_qkxtm_multigrid_tpu.ops import twist as jtw
from quda_qkxtm_multigrid_tpu.utils import rng as jrng

from quda_qkxtm_multigrid_tpu_torch import fields as tfields
from quda_qkxtm_multigrid_tpu_torch import lattice as tlat
from quda_qkxtm_multigrid_tpu_torch import convert
from quda_qkxtm_multigrid_tpu_torch.convert import spinor_to_numpy
from quda_qkxtm_multigrid_tpu_torch.dirac import DiracParams as TParams
from quda_qkxtm_multigrid_tpu_torch.ops import clover as tcl
from quda_qkxtm_multigrid_tpu_torch.ops import dslash as tdsl
from quda_qkxtm_multigrid_tpu_torch.ops import gamma as tgamma
from quda_qkxtm_multigrid_tpu_torch.ops import smallmat as tsm
from quda_qkxtm_multigrid_tpu_torch.ops import twist as ttw
from quda_qkxtm_multigrid_tpu_torch.utils import rng as trng

# the tests run on the CPU; the converters default to the card
T = functools.partial(convert.spinor_from_numpy, device="cpu")

torch.set_num_threads(1)

GJ = jlat.Geometry(4, 4, 4, 8)
GT = tlat.Geometry(4, 4, 4, 8)
RTOL = 1e-12


def rel(got, ref) -> float:
    got = spinor_to_numpy(got) if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.linalg.norm((got - ref).ravel())
                 / np.linalg.norm(ref.ravel()))


@pytest.fixture(scope="module")
def flds():
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(21), 3)
    u = np.asarray(jrng.random_gauge(k1, GJ))
    psi = np.asarray(jrng.random_spinor(k2, GJ))
    chi = np.asarray(jrng.random_spinor(k3, GJ))
    return u, psi, chi


@pytest.fixture(scope="module")
def clov(flds):
    u = flds[0]
    return np.asarray(jcl.make_clover(u, GJ, 0.115))


# ---- lattice ---------------------------------------------------------

def test_geometry_matches():
    for name in ("dims", "volume", "half_volume", "Xh", "W", "lat_shape",
                 "cb4_shape"):
        assert getattr(GT, name) == getattr(GJ, name), name
    for parity in (0, 1):
        for a, b in zip(GT._x_masks(parity), GJ._x_masks(parity)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dims", [(3, 4, 4, 4), (4, 4, 4, 0), (4, 2, 5, 4)])
def test_geometry_rejects_odd_or_small(dims):
    with pytest.raises(ValueError):
        tlat.Geometry(*dims)


@pytest.mark.parametrize("mu", [0, 1, 2, 3])
def test_gather_neighbor(flds, mu):
    """All directions and both parities: a pure data movement, so equal."""
    psi = flds[1]
    for parity in (0, 1):
        for forward in (True, False):
            ref = np.asarray(jlat.gather_neighbor(psi[1 - parity], mu,
                                                  forward, parity, GJ))
            got = tlat.gather_neighbor(T(psi[1 - parity]), mu, forward,
                                       parity, GT)
            np.testing.assert_array_equal(spinor_to_numpy(got), ref)


def test_lex_converters(flds):
    psi = flds[1]
    lex = tlat.spinor_to_lex(T(psi), GT)
    np.testing.assert_array_equal(spinor_to_numpy(lex),
                                  np.asarray(jlat.spinor_to_lex(psi, GJ)))
    np.testing.assert_array_equal(
        spinor_to_numpy(tlat.spinor_from_lex(lex, GT)), psi)


@pytest.mark.parametrize("coords", [(0, 0, 0, 0), (1, 2, 3, 5), (3, 3, 1, 7)])
def test_site_index_and_point_source(coords):
    assert tlat.site_index(GT, coords) == tuple(
        int(v) for v in jlat.site_index(GJ, coords))
    ref = np.asarray(jfields.point_source(GJ, coords, 2, 1))
    got = tfields.point_source(GT, coords, 2, 1, device="cpu")
    np.testing.assert_array_equal(spinor_to_numpy(got), ref)


def test_zeros_spinor():
    z = tfields.zeros_spinor(GT, dtype=torch.complex64, device="cpu")
    assert z.shape == (2, 4, 3) + GT.lat_shape
    assert z.dtype == torch.complex64 and not z.any()


# ---- gamma and small matrices ------------------------------------------

def test_gamma_tables(flds):
    for name in ("GAMMA", "GAMMA5", "PROJ", "IDENTITY"):
        np.testing.assert_array_equal(getattr(tgamma, name),
                                      getattr(jgamma, name))
    psi = flds[1]
    np.testing.assert_array_equal(
        spinor_to_numpy(tgamma.apply_gamma5(T(psi))),
        np.asarray(jgamma.apply_gamma5(psi)))


def _mats(u):
    a = u[0, 0]                      # [3,3,T,Z,W]
    b = u[1, 1]
    six = np.concatenate([np.concatenate([a, b], 1),
                          np.concatenate([u[2, 0], a + 3 * np.eye(3)[
                              :, :, None, None, None]], 1)], 0)
    return a, b, six


SMALLMAT = {
    "su3_mul": lambda m, u, psi, six, chi: m.su3_mul(u[0, 0], psi[0]),
    "su3_dag_mul": lambda m, u, psi, six, chi: m.su3_dag_mul(u[2, 1],
                                                             psi[1]),
    "mat_mul": lambda m, u, psi, six, chi: m.mat_mul(u[0, 0], u[3, 1]),
    "mat_dag": lambda m, u, psi, six, chi: m.mat_dag(u[1, 0]),
    "spinmat_mul": lambda m, u, psi, six, chi: m.spinmat_mul(
        jgamma.PROJ[2, 1], psi[0]),
    "chiral_mat_mul": lambda m, u, psi, six, chi: m.chiral_mat_mul(
        chi, psi[0].reshape((2, 6) + psi.shape[-3:])),
    "chiral_mat_mul_dag": lambda m, u, psi, six, chi: m.chiral_mat_mul(
        chi, psi[0].reshape((2, 6) + psi.shape[-3:]), dagger=True),
    "mat3_inv": lambda m, u, psi, six, chi: m.mat3_inv(u[0, 1]),
    "mat6_inv_blocks": lambda m, u, psi, six, chi: m.mat6_inv_blocks(six),
}


@pytest.mark.parametrize("name", list(SMALLMAT))
def test_smallmat(flds, clov, name):
    u, psi, _ = flds
    six = _mats(u)[2]
    chi = clov[0]                     # [2,6,6,T,Z,W]
    ref = SMALLMAT[name](jsm, u, psi, six, chi)
    got = SMALLMAT[name](tsm, T(u), T(psi), T(six), T(chi))
    assert rel(got, ref) <= RTOL


# ---- Wilson hop ---------------------------------------------------------

def test_double_gauge(flds):
    u = flds[0]
    np.testing.assert_array_equal(
        spinor_to_numpy(tdsl.double_gauge(T(u), GT)),
        np.asarray(jdsl.double_gauge(u, GJ)))


@pytest.mark.parametrize("parity,dagger", [(0, False), (0, True),
                                           (1, False), (1, True)])
def test_dslash_parity(flds, parity, dagger):
    u, psi, _ = flds
    ref = jdsl.dslash_parity(u, psi[1 - parity], parity, GJ, dagger)
    got = tdsl.dslash_parity(T(u), T(psi[1 - parity]), parity, GT, dagger)
    assert rel(got, ref) <= RTOL


@pytest.mark.parametrize("dagger", [False, True])
def test_dslash_parity_doubled(flds, dagger):
    u, psi, _ = flds
    ud = jdsl.double_gauge(u, GJ)
    ref = jdsl.dslash_parity_doubled(ud, psi[0], 1, GJ, dagger)
    got = tdsl.dslash_parity_doubled(T(np.asarray(ud)), T(psi[0]), 1, GT,
                                     dagger)
    assert rel(got, ref) <= RTOL


@pytest.mark.parametrize("dagger", [False, True])
def test_wilson_mat(flds, dagger):
    u, psi, _ = flds
    ref = jdsl.wilson_mat(u, psi, 0.13, GJ, dagger)
    got = tdsl.wilson_mat(T(u), T(psi), 0.13, GT, dagger)
    assert rel(got, ref) <= RTOL


def test_dslash_flops_constant():
    assert tdsl.WILSON_DSLASH_FLOPS_PER_SITE == \
        jdsl.WILSON_DSLASH_FLOPS_PER_SITE == 1320


# ---- twist and clover ---------------------------------------------------

@pytest.mark.parametrize("dagger,inverse", [(False, False), (True, False),
                                            (False, True), (True, True)])
def test_twist_apply(flds, dagger, inverse):
    psi = flds[1]
    ref = jtw.twist_apply(psi[0], 0.115, 0.05, -1, dagger, inverse)
    got = ttw.twist_apply(T(psi[0]), 0.115, 0.05, -1, dagger, inverse)
    assert rel(got, ref) <= RTOL


def test_field_strength(flds):
    u = flds[0]
    assert rel(tcl.field_strength(T(u), GT), jcl.field_strength(u, GJ)) \
        <= RTOL


def test_make_clover(flds, clov):
    assert rel(tcl.make_clover(T(flds[0]), GT, 0.115), clov) <= RTOL


def test_clover_with_twist(clov):
    ref = jcl.clover_with_twist(clov, 0.115, 0.05, 1)
    assert rel(tcl.clover_with_twist(T(clov), 0.115, 0.05, 1), ref) <= RTOL


def test_invert_clover(clov):
    got = tcl.invert_clover(T(clov))
    assert rel(got, jcl.invert_clover(clov)) <= RTOL
    # and it is the inverse: A·A⁻¹ψ = ψ on every block
    psi = T(np.ones((4, 3) + GT.lat_shape, dtype=np.complex128))
    back = tcl.clover_apply(T(clov)[0], tcl.clover_apply(got[0], psi))
    assert rel(back, spinor_to_numpy(psi)) <= RTOL


@pytest.mark.parametrize("dagger", [False, True])
def test_clover_apply(flds, clov, dagger):
    psi = flds[1]
    ref = jcl.clover_apply(clov[1], psi[1], dagger)
    assert rel(tcl.clover_apply(T(clov[1]), T(psi[1]), dagger), ref) <= RTOL


@pytest.mark.parametrize("kind,mu", [("clover", 0.0),
                                     ("twisted-clover", 0.05)])
def test_make_clover_pair(flds, kind, mu):
    u = flds[0]
    kw = dict(kind=kind, kappa=0.115, mu=mu, csw=1.0)
    ref = jcl.make_clover_pair(u, GJ, JParams(**kw))
    got = tcl.make_clover_pair(T(u), GT, TParams(**kw))
    for g, r in zip(got, ref):
        assert rel(g, r) <= RTOL


def test_clover_flops_constant():
    assert tcl.CLOVER_APPLY_FLOPS_PER_SITE == \
        jcl.CLOVER_APPLY_FLOPS_PER_SITE == 504


# ---- the port's own generator -------------------------------------------

def test_random_su3_is_special_unitary():
    gen = torch.Generator().manual_seed(3)
    m = trng.random_su3(gen, (50,))                     # [3,3,50]
    mm = m.permute(2, 0, 1)
    eye = torch.eye(3, dtype=m.dtype).expand(50, 3, 3)
    assert float((mm @ mm.conj().transpose(1, 2) - eye).abs().max()) < 1e-13
    assert float((torch.linalg.det(mm) - 1).abs().max()) < 1e-13


def test_random_fields_seeded():
    g1 = torch.Generator().manual_seed(5)
    g2 = torch.Generator().manual_seed(5)
    u1, u2 = trng.random_gauge(g1, GT), trng.random_gauge(g2, GT)
    assert u1.shape == (4, 2, 3, 3) + GT.lat_shape
    assert torch.equal(u1, u2)
    s = trng.random_spinor(torch.Generator().manual_seed(6), GT)
    assert s.shape == (2, 4, 3) + GT.lat_shape
    # Gaussian real and imaginary parts of unit variance, as in JAX
    for part in (s.real, s.imag):
        assert abs(float(part.mean())) < 0.05
        assert abs(float(part.var()) - 1.0) < 0.05
