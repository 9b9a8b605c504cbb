"""Smearing, sources, propagator algebra and the gauge reader of the port
against the JAX package, in complex128 at 4³×8 (≤ 1e-12, normwise
relative, unless equal bit for bit):

* ``ape_smear`` (spatial staples), ``gaussian_smear`` (one source and
  a batch of sources);
* ``fields.point_source_dyn`` and ``forward_propagator``;
* ``rotate_to_physical`` (both flavours), ``smear_propagator`` and
  ``propagator_gamma5_dag``;
* ``fields.gauge_from_full`` against ``gauge_from_lex``, and the ILDG
  writer and reader of ``io/lime.py`` round trip (64- and 32-bit).
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from quda_qkxtm_multigrid_tpu import fields as jfields
from quda_qkxtm_multigrid_tpu import lattice as jlat
from quda_qkxtm_multigrid_tpu.ops import smear as jsmear
from quda_qkxtm_multigrid_tpu.physics import propagator as jprop
from quda_qkxtm_multigrid_tpu.utils import rng as jrng

from quda_qkxtm_multigrid_tpu_torch import convert, fields
from quda_qkxtm_multigrid_tpu_torch.io import lime
from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry
from quda_qkxtm_multigrid_tpu_torch.ops import smear
from quda_qkxtm_multigrid_tpu_torch.physics import propagator as prop

T = functools.partial(convert.spinor_from_numpy, device="cpu")
torch.set_num_threads(1)

GJ = jlat.Geometry(4, 4, 4, 8)
GT = Geometry(4, 4, 4, 8)
F64 = 1e-12


def rel(got, ref) -> float:
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.linalg.norm((got - ref).ravel())
                 / np.linalg.norm(ref.ravel()))


@pytest.fixture(scope="module")
def flds():
    """A complex128 gauge (JAX ``random_gauge``), three spinors and a
    propagator from numpy seed 41."""
    u = np.asarray(jrng.random_gauge(jax.random.PRNGKey(21), GJ))
    rng = np.random.default_rng(41)
    psi = (rng.standard_normal((3, 2, 4, 3) + GJ.lat_shape)
           + 1j * rng.standard_normal((3, 2, 4, 3) + GJ.lat_shape))
    shape = (2, 4, 4, 3, 3) + GJ.lat_shape
    s = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return u, psi, s


def test_ape_smear_matches_jax(flds):
    """Spatial staples, the t links untouched (the 2pt's smeared gauge)."""
    u = flds[0]
    got = smear.ape_smear(T(u), GT, 0.5, 2)
    ref = jsmear.ape_smear(jnp.asarray(u), GJ, 0.5, 2)
    assert rel(got, ref) <= F64
    assert torch.equal(got[3], T(u)[3])


@pytest.mark.parametrize("batch", [False, True])
def test_gaussian_smear_matches_jax(flds, batch):
    u, psi, _ = flds
    v = psi if batch else psi[0]
    got = smear.gaussian_smear(T(v), T(u), GT, 4.0, 3)
    ref = jsmear.gaussian_smear(jnp.asarray(v), jnp.asarray(u), GJ, 4.0, 3)
    assert rel(got, ref) <= F64


@pytest.mark.parametrize("coords", [(0, 0, 0, 0), (3, 1, 2, 7), (2, 3, 1, 4)])
def test_point_source_dyn_matches_jax(coords):
    for spin, color in ((0, 0), (3, 2)):
        got = fields.point_source_dyn(GT, torch.tensor(coords), spin, color,
                                      device="cpu")
        ref = jfields.point_source_dyn(GJ, jnp.asarray(coords, jnp.int32),
                                       spin, color)
        assert np.array_equal(got.numpy(), np.asarray(ref))


def test_forward_propagator_matches_jax(flds):
    """The column assembly, with a linear 'solve' (the smeared source
    times a fixed field) in place of a solver."""
    u, psi, _ = flds
    w = psi[1]

    def solve_t(b):
        return b * T(w)

    def solve_j(b):
        return b * jnp.asarray(w)
    got = prop.forward_propagator(
        solve_t, GT, (1, 2, 3, 4), torch.complex128,
        smear=lambda b: smear.gaussian_smear(b, T(u), GT, 2.0, 1),
        device="cpu")
    ref = jprop.forward_propagator(
        solve_j, GJ, (1, 2, 3, 4), jnp.complex128,
        smear=lambda b: jsmear.gaussian_smear(b, jnp.asarray(u), GJ, 2.0, 1))
    assert rel(got, ref) <= F64


@pytest.mark.parametrize("sign", [+1, -1])
def test_rotate_to_physical_matches_jax(flds, sign):
    s = flds[2]
    got = prop.rotate_to_physical(T(s), sign)
    assert rel(got, jprop.rotate_to_physical(jnp.asarray(s), sign)) <= F64


def test_propagator_gamma5_dag_matches_jax(flds):
    s = flds[2]
    got = prop.propagator_gamma5_dag(T(s))
    assert rel(got, jprop.propagator_gamma5_dag(jnp.asarray(s))) <= F64


def test_smear_propagator_matches_jax(flds):
    u, _, s = flds
    got = prop.smear_propagator(T(s), T(u), GT, 4.0, 2)
    ref = jprop.smear_propagator(jnp.asarray(s), jnp.asarray(u), GJ, 4.0, 2)
    assert rel(got, ref) <= F64


def test_gauge_from_full_matches_jax(flds):
    u = flds[0]
    full = np.asarray(jlat.gauge_to_lex(jnp.asarray(u), GJ))
    got = fields.gauge_from_full(T(full), GT)
    assert np.array_equal(got.numpy(), np.asarray(
        jfields.gauge_from_full(jnp.asarray(full), GJ)))
    assert np.array_equal(got.numpy(), u)


@pytest.mark.parametrize("precision", [64, 32])
def test_ildg_round_trip(flds, tmp_path, precision):
    full = np.asarray(jlat.gauge_to_lex(jnp.asarray(flds[0]), GJ))
    path = tmp_path / "conf.lime"
    lime.write_ildg_gauge(str(path), full, precision=precision)
    back = lime.read_ildg_gauge(str(path))
    assert back.shape == (4, GJ.T, GJ.Z, GJ.Y, GJ.X, 3, 3)
    if precision == 64:
        assert np.array_equal(back, full)
    else:
        assert np.abs(back - full).max() <= 1e-6
    names = [n for n, _ in lime.read_records(str(path))]
    assert names == ["ildg-format", "ildg-binary-data"]
