"""The port's staggered operators (``ops/staggered.py``) against the JAX
package's, on the CPU in complex128 at 4³×8.

Inputs from numpy seeds (SU(3) links, colour fields [2, 3, T, Z, W]).
The phases, the Naik and asqtad links, ``shift3``, the dslash (thin and
improved, both parities and daggers), ``staggered_mat`` and
``staggered_matpc`` agree with JAX to 1e-12 relative; the matpc CG
takes the JAX iteration count and agrees to 1e-10.  The JAX tests'
properties are mirrored (``tests/test_staggered_dw.py:39-97,
149-197``): anti-hermiticity, the free-field oracle, the asqtad
unit-gauge coefficients and gauge covariance (unmarked here: the JAX
one is ``slow``).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from quda_qkxtm_multigrid_tpu import lattice as jlat
from quda_qkxtm_multigrid_tpu.ops import staggered as jst
from quda_qkxtm_multigrid_tpu.solvers.cg import cg as jcg

from quda_qkxtm_multigrid_tpu_torch import lattice
from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry
from quda_qkxtm_multigrid_tpu_torch.ops import staggered as st
from quda_qkxtm_multigrid_tpu_torch.ops.gauge import gauge_transform
from quda_qkxtm_multigrid_tpu_torch.ops.smallmat import mat_dag, mat_mul
from quda_qkxtm_multigrid_tpu_torch.solvers.cg import cg
from quda_qkxtm_multigrid_tpu_torch.utils import rng as trng

torch.set_num_threads(1)

GJ = jlat.Geometry(4, 4, 4, 8)
GT = Geometry(4, 4, 4, 8)
OP = 1e-12


def rel(got, ref) -> float:
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.linalg.norm((got - ref).ravel())
                 / np.linalg.norm(ref.ravel()))


def su3(rng, batch) -> np.ndarray:
    """SU(3) matrices [3, 3, *batch]: Gaussian entries, Gram-Schmidt on
    rows 0 and 1, row 2 = conj(r0 × r1)."""
    a = (rng.standard_normal((3, 3) + batch)
         + 1j * rng.standard_normal((3, 3) + batch))
    r0 = a[0] / np.sqrt((np.abs(a[0]) ** 2).sum(0))
    r1 = a[1] - (r0.conj() * a[1]).sum(0) * r0
    r1 = r1 / np.sqrt((np.abs(r1) ** 2).sum(0))
    return np.stack([r0, r1, np.cross(r0, r1, axis=0).conj()])


def gauge_field(seed: int) -> np.ndarray:
    m = su3(np.random.default_rng(seed), (4, 2) + GJ.lat_shape)
    return np.ascontiguousarray(np.moveaxis(m, (0, 1), (2, 3)))


def colour_field(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    shape = (2, 3) + GJ.lat_shape
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


@pytest.fixture(scope="module")
def flds():
    u = gauge_field(301)
    fat, lng = jst.asqtad_links(jnp.asarray(u), GJ)
    return {"u": u, "fat": np.asarray(jst.apply_staggered_phases(fat, GJ)),
            "long": np.asarray(jst.apply_staggered_phases(lng, GJ)),
            "x": colour_field(302), "y": colour_field(303)}


@pytest.mark.parametrize("antiperiodic", [True, False])
def test_phases_match_jax(flds, antiperiodic):
    ph = st.staggered_phases(GT, antiperiodic)
    assert np.array_equal(ph, jst.staggered_phases(GJ, antiperiodic))
    got = st.apply_staggered_phases(torch.tensor(flds["u"]), GT,
                                    antiperiodic)
    want = jst.apply_staggered_phases(jnp.asarray(flds["u"]), GJ,
                                      antiperiodic)
    assert rel(got, want) < OP


def test_naik_and_asqtad_links_match_jax(flds):
    """The links before the phases: fat and long against JAX's."""
    u = flds["u"]
    fat, lng = st.asqtad_links(torch.tensor(u), GT)
    jfat, jlng = jst.asqtad_links(jnp.asarray(u), GJ)
    assert rel(fat, jfat) < OP and rel(lng, jlng) < OP
    assert rel(st.naik_links(torch.tensor(u), GT, 0.5),
               jst.naik_links(jnp.asarray(u), GJ, 0.5)) < OP
    assert rel(st.gen_staple(torch.tensor(u), torch.tensor(u[1]), 1, 3, GT),
               jst.gen_staple(jnp.asarray(u), jnp.asarray(u[1]), 1, 3,
                              GJ)) < OP


@pytest.mark.parametrize("mu,forward,parity", [(0, True, 0), (1, False, 1),
                                               (3, True, 1)])
def test_shift3_matches_jax(flds, mu, forward, parity):
    f = flds["x"][1 - parity][None]
    assert rel(st.shift3(torch.tensor(f), mu, forward, parity, GT),
               jst.shift3(jnp.asarray(f), mu, forward, parity, GJ)) < OP


@pytest.mark.parametrize("improved", [False, True])
@pytest.mark.parametrize("parity,dagger", [(0, False), (1, True)])
def test_dslash_and_mat_match_jax(flds, improved, parity, dagger):
    fat, x = flds["fat"], flds["x"]
    lng = flds["long"] if improved else None
    tl = None if lng is None else torch.tensor(lng)
    got = st.staggered_dslash(torch.tensor(fat), torch.tensor(x[1 - parity]),
                              parity, GT, tl, dagger)
    want = jst.staggered_dslash(jnp.asarray(fat), jnp.asarray(x[1 - parity]),
                                parity, GJ, lng, dagger)
    assert rel(got, want) < OP
    got = st.staggered_mat(torch.tensor(fat), torch.tensor(x), 0.1, GT, tl,
                           dagger)
    assert rel(got, jst.staggered_mat(jnp.asarray(fat), jnp.asarray(x), 0.1,
                                      GJ, lng, dagger)) < OP
    got = st.staggered_matpc(torch.tensor(fat), torch.tensor(x[parity]), 0.1,
                             GT, tl, parity)
    assert rel(got, jst.staggered_matpc(jnp.asarray(fat),
                                        jnp.asarray(x[parity]), 0.1, GJ, lng,
                                        parity)) < OP


@pytest.mark.parametrize("improved", [False, True])
def test_dslash_is_antihermitian(flds, improved):
    """<y, D x> = −<D y, x> (JAX ``test_antihermitian``,
    ``test_improved_operator_antihermitian``)."""
    fat = torch.tensor(flds["fat"])
    lng = torch.tensor(flds["long"]) if improved else None
    x, y = torch.tensor(flds["x"]), torch.tensor(flds["y"])
    dx = st.staggered_mat(fat, x, 0.0, GT, lng)
    dy = st.staggered_mat(fat, y, 0.0, GT, lng)
    lhs = complex(torch.vdot(y.reshape(-1), dx.reshape(-1)))
    rhs = complex(torch.vdot(dy.reshape(-1), x.reshape(-1)))
    assert abs(lhs + rhs) <= 1e-11 * abs(lhs)


def _to_lex(v: torch.Tensor) -> np.ndarray:
    """[2, 3, T, Z, W] → [T, Z, Y, X, 3] through the spinor converter."""
    v4 = torch.stack([v] * 4, dim=1)
    return lattice.spinor_to_lex(v4, GT)[..., 0, :].numpy()


def test_free_field_oracle(flds):
    """Unit links with the phases: D ψ = Σ η_μ (ψ(x+μ) − ψ(x−μ)) (JAX
    ``test_oracle_free_field``)."""
    u = st.apply_staggered_phases(trng.unit_gauge(GT, device="cpu"), GT,
                                  antiperiodic_t=False)
    x = torch.tensor(flds["x"])
    got = _to_lex(st.staggered_mat(u, x, 0.0, GT))
    lex = _to_lex(x)
    xs = np.arange(GT.X).reshape(1, 1, 1, -1, 1)
    ys = np.arange(GT.Y).reshape(1, 1, -1, 1, 1)
    zs = np.arange(GT.Z).reshape(1, -1, 1, 1, 1)
    one = np.ones((GT.T, GT.Z, GT.Y, GT.X, 1))
    eta = [one, (-1.0) ** xs * one, (-1.0) ** (xs + ys) * one,
           (-1.0) ** (xs + ys + zs) * one]
    axes = {0: 3, 1: 2, 2: 1, 3: 0}
    ref = sum(eta[mu] * (np.roll(lex, -1, axis=axes[mu])
                         - np.roll(lex, 1, axis=axes[mu])) for mu in range(4))
    assert np.abs(got - ref).max() < 1e-11


def test_asqtad_unit_gauge_coefficients():
    """On unit links fat = (c1 + 6 c3 + 12 c_lep + 24 c5 + 48 c7) I =
    −I/4 and long = c_naik I."""
    fat, lng = st.asqtad_links(trng.unit_gauge(GT, device="cpu"), GT)
    c = st.ASQTAD_COEFFS
    expect = (c["one_link"] + 6 * c["three_staple"] + 12 * c["lepage"]
              + 24 * c["five_staple"] + 48 * c["seven_staple"])
    assert abs(expect + 0.25) < 1e-14
    eye = torch.eye(3, dtype=fat.dtype).reshape(1, 1, 3, 3, 1, 1, 1)
    assert float((fat - expect * eye).abs().max()) < 1e-12
    assert float((lng - c["naik"] * eye).abs().max()) < 1e-12


def test_asqtad_gauge_covariance(flds):
    """fat(U^g)_mu(x) = g(x) fat_mu(x) g†(x+mu), long with g†(x+3mu) (JAX
    ``test_gauge_covariance``)."""
    u = torch.tensor(flds["u"])
    g = torch.tensor(np.ascontiguousarray(np.moveaxis(
        su3(np.random.default_rng(304), (2,) + GJ.lat_shape), (0, 1),
        (1, 2))))
    fat_g, lng_g = st.asqtad_links(gauge_transform(u, g, GT), GT)
    fat, lng = st.asqtad_links(u, GT)
    for mu in range(4):
        for p in (0, 1):
            g_f = lattice.gather_neighbor(g[1 - p], mu, True, p, GT)
            want = mat_mul(mat_mul(g[p], fat[mu, p]), mat_dag(g_f))
            assert float((fat_g[mu, p] - want).abs().max()) < 1e-11
            g3 = st.shift3(g[1 - p], mu, True, p, GT)
            want = mat_mul(mat_mul(g[p], lng[mu, p]), mat_dag(g3))
            assert float((lng_g[mu, p] - want).abs().max()) < 1e-11


def test_matpc_cg_matches_jax(flds):
    """CG on the asqtad ``staggered_matpc`` at mass 0.1 (JAX
    ``test_matpc_cg_solve``): the JAX count and solution,
    |b − A x| / |b| < 1e-8."""
    fat, lng, b = flds["fat"], flds["long"], flds["x"][0]
    tf, tl, tb = (torch.tensor(a) for a in (fat, lng, b))
    res = cg(lambda v: st.staggered_matpc(tf, v, 0.1, GT, tl), tb,
             tol=1e-10, maxiter=1000)
    jres = jcg(lambda v: jst.staggered_matpc(fat, v, 0.1, GJ, lng),
               jnp.asarray(b), tol=1e-10, maxiter=1000)
    assert res.iters == int(jres.iters) < 1000
    assert rel(res.x, jres.x) < 1e-10
    r = tb - st.staggered_matpc(tf, res.x, 0.1, GT, tl)
    assert float(r.norm() / tb.norm()) < 1e-8
