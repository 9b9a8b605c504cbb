"""The port's gauge utilities (``ops/gauge.py``: ``gauge_transform``,
``topological_charge``, ``gauge_fix_fft``, ``gauge_fix_ovr``;
``lattice.gauge_to_lex``; ``ops/dslash.wilson_matpc``) against the JAX
package's, on the CPU in complex128 at 4³×8.

The inputs come from numpy seeds: a gauge of SU(3) links (Gaussian
matrices, Gram-Schmidt) and a gauge transformation.  Tolerances: the
charge to 1e-10, the fixers' θ and fixed links to 1e-10 after the same
iteration count, every other function to 1e-12 relative.  The JAX
tests' properties are mirrored: the charge is gauge invariant, both
fixers lower θ and keep the plaquette (``tests/test_io.py:178-220``), the
field strength is covariant (``tests/test_clover.py:34-40``).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from quda_qkxtm_multigrid_tpu import lattice as jlat
from quda_qkxtm_multigrid_tpu.ops import clover as jclover
from quda_qkxtm_multigrid_tpu.ops import dslash as jdslash
from quda_qkxtm_multigrid_tpu.ops import gauge as jgauge

from quda_qkxtm_multigrid_tpu_torch import lattice
from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry
from quda_qkxtm_multigrid_tpu_torch.ops import clover, dslash, gauge

torch.set_num_threads(1)

GJ = jlat.Geometry(4, 4, 4, 8)
GT = Geometry(4, 4, 4, 8)
OP, FIX = 1e-12, 1e-10


def rel(got, ref) -> float:
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.linalg.norm((got - ref).ravel())
                 / np.linalg.norm(ref.ravel()))


def su3(rng, batch) -> np.ndarray:
    """SU(3) matrices [3, 3, *batch] from Gaussian entries: Gram-Schmidt
    on rows 0 and 1, row 2 = conj(r0 × r1)."""
    a = (rng.standard_normal((3, 3) + batch)
         + 1j * rng.standard_normal((3, 3) + batch))
    r0 = a[0] / np.sqrt((np.abs(a[0]) ** 2).sum(0))
    r1 = a[1] - (r0.conj() * a[1]).sum(0) * r0
    r1 = r1 / np.sqrt((np.abs(r1) ** 2).sum(0))
    return np.stack([r0, r1, np.cross(r0, r1, axis=0).conj()])


def gauge_field(seed: int) -> np.ndarray:
    """A random SU(3) gauge [4, 2, 3, 3, T, Z, W] from a numpy seed."""
    m = su3(np.random.default_rng(seed), (4, 2) + GJ.lat_shape)
    return np.ascontiguousarray(np.moveaxis(m, (0, 1), (2, 3)))


def transformation(seed: int) -> np.ndarray:
    """A random gauge transformation g [2, 3, 3, T, Z, W]."""
    m = su3(np.random.default_rng(seed), (2,) + GJ.lat_shape)
    return np.ascontiguousarray(np.moveaxis(m, (0, 1), (1, 2)))


@pytest.fixture(scope="module")
def flds():
    return gauge_field(101), transformation(102)


def test_gauge_to_lex_matches_jax_and_inverts(flds):
    u, _ = flds
    got = lattice.gauge_to_lex(torch.tensor(u), GT)
    assert np.array_equal(got.numpy(), np.asarray(jlat.gauge_to_lex(u, GJ)))
    assert torch.equal(lattice.gauge_from_lex(got, GT), torch.tensor(u))


@pytest.mark.parametrize("parity,dagger", [(0, False), (1, True)])
def test_wilson_matpc_and_flops_match_jax(flds, parity, dagger):
    u, _ = flds
    rng = np.random.default_rng(103)
    shape = (4, 3) + GJ.lat_shape
    psi = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    got = dslash.wilson_matpc(torch.tensor(u), torch.tensor(psi), 0.13, GT,
                              parity, dagger)
    want = jdslash.wilson_matpc(u, psi, 0.13, GJ, parity, dagger)
    assert rel(got, want) < OP
    for sites in ("half", "full"):
        assert dslash.dslash_flops(GT, sites) == jdslash.dslash_flops(GJ,
                                                                      sites)


def test_gauge_transform_matches_jax_and_keeps_su3(flds):
    u, g = flds
    got = gauge.gauge_transform(torch.tensor(u), torch.tensor(g), GT)
    assert rel(got, jgauge.gauge_transform(u, g, GJ)) < OP
    m = got.movedim((2, 3), (-2, -1))
    eye = torch.eye(3, dtype=m.dtype)
    assert float((m @ m.transpose(-1, -2).conj() - eye).abs().max()) < 1e-13


def test_topological_charge_matches_jax_and_is_gauge_invariant(flds):
    u, g = flds
    ut, gt = torch.tensor(u), torch.tensor(g)
    q = gauge.topological_charge(ut, GT)
    qj = float(jgauge.topological_charge(u, GJ))
    assert q.dim() == 0 and abs(float(q) - qj) <= FIX * abs(qj)
    q2 = gauge.topological_charge(gauge.gauge_transform(ut, gt, GT), GT)
    assert abs(float(q2) - float(q)) <= FIX * abs(float(q))


def test_field_strength_is_covariant(flds):
    """F'(x) = g(x) F(x) g†(x) under ``gauge_transform``, and the same
    transformed field strength as the JAX package's."""
    u, g = flds
    gt = torch.tensor(g)
    ug = gauge.gauge_transform(torch.tensor(u), gt, GT)
    f1 = clover.field_strength(torch.tensor(u), GT)
    f2 = clover.field_strength(ug, GT)
    expect = torch.einsum("pab...,mpbc...,pdc...->mpad...", gt, f1,
                          gt.conj())
    assert float((f2 - expect).abs().max()) < 1e-12
    assert rel(f2, jclover.field_strength(jgauge.gauge_transform(u, g, GJ),
                                          GJ)) < OP


@pytest.mark.parametrize("n_iter", [0, 1, 12])
def test_gauge_fix_ovr_matches_jax(flds, n_iter):
    u, _ = flds
    uf, th = gauge.gauge_fix_ovr(torch.tensor(u), GT, n_iter=n_iter)
    ujf, thj = jgauge.gauge_fix_ovr(jnp.asarray(u), GJ, n_iter=n_iter)
    assert abs(float(th) - float(thj)) <= FIX * float(thj)
    assert rel(uf, ujf) < FIX


@pytest.mark.parametrize("gauge_dir", [4, 3])
@pytest.mark.parametrize("n_iter", [0, 1, 10])
def test_gauge_fix_fft_matches_jax(flds, gauge_dir, n_iter):
    u, _ = flds
    uf, th = gauge.gauge_fix_fft(torch.tensor(u), GT, gauge_dir=gauge_dir,
                                 n_iter=n_iter)
    ujf, thj = jgauge.gauge_fix_fft(jnp.asarray(u), GJ, gauge_dir=gauge_dir,
                                    n_iter=n_iter)
    assert abs(float(th) - float(thj)) <= FIX * float(thj)
    assert rel(uf, ujf) < FIX


def test_gauge_fix_ovr_lowers_theta_and_keeps_the_plaquette(flds):
    """The JAX test's property (``test_gauge_fixing_improves_theta``)."""
    ut = torch.tensor(flds[0])
    _, th0 = gauge.gauge_fix_ovr(ut, GT, n_iter=0)
    uf, th1 = gauge.gauge_fix_ovr(ut, GT, n_iter=40)
    assert float(th1) < 0.5 * float(th0)
    p0, p1 = gauge.plaquette(ut, GT)[0], gauge.plaquette(uf, GT)[0]
    assert abs(float(p1) - float(p0)) <= 1e-12 * abs(float(p0))


@pytest.mark.parametrize("gauge_dir", [4, 3])
def test_gauge_fix_fft_lowers_theta_and_keeps_the_plaquette(flds,
                                                           gauge_dir):
    """The JAX test's property (``test_fft_gauge_fixing``)."""
    ut = torch.tensor(flds[0])
    _, th0 = gauge.gauge_fix_fft(ut, GT, gauge_dir=gauge_dir, n_iter=0)
    uf, th1 = gauge.gauge_fix_fft(ut, GT, gauge_dir=gauge_dir, n_iter=60)
    assert float(th1) < 0.05 * float(th0)
    p0, p1 = gauge.plaquette(ut, GT)[0], gauge.plaquette(uf, GT)[0]
    assert abs(float(p1) - float(p0)) <= 1e-12 * abs(float(p0))
