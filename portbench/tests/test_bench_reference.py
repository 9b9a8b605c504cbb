"""The plain reference against the JAX package and the port's plain
operator.

``data/jax_tmc_4448.npz`` holds what the JAX package's
``dirac.make_dirac(u, DiracParams(kind="twisted-clover", kappa=0.115,
mu=0.05, csw=1.0), Geometry(4, 4, 4, 8)).m(psi)`` gave (float64 on the
CPU) for the gauge ``portbench.gauge.make_gauge((4, 4, 4, 8),
derive_seed(20261018, 0), "cpu", "antiperiodic")`` and a Gaussian ψ
from numpy's ``default_rng(5)``; it is kept as numpy, so that nothing
here imports JAX."""

from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import layout
from portbench.gauge import derive_seed, make_gauge
from portbench.reference.galerkin import (
    coarse_apply, orthonormality_gap, prolong, restrict)
from portbench.reference.operator import TwistedClover
from portbench.reference.solver import cgnr

DATA = Path(__file__).resolve().parent / "data" / "jax_tmc_4448.npz"


def rel(a, b) -> float:
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def test_gauge_is_the_one_of_the_data():
    z = np.load(DATA)
    u = make_gauge((4, 4, 4, 8), derive_seed(20261018, 0), "cpu",
                   "antiperiodic")
    assert np.array_equal(u.numpy(), z["u"])


@pytest.mark.parametrize("slab", [1, 3, 8])
def test_reference_against_jax(slab):
    z = np.load(DATA)
    u = torch.tensor(z["u"])
    ref = TwistedClover(u, tuple(z["dims"]), float(z["kappa"]),
                        float(z["mu"]), float(z["csw"]), slab=slab)
    psi = torch.tensor(z["psi"])
    got = layout.spinor_to_canonical(ref.apply_lex(
        layout.spinor_to_lex(psi, 4)))
    assert rel(got, torch.tensor(z["m_psi"])) < 1e-14
    assert ref.residual(psi, torch.tensor(z["m_psi"])) < 1e-14


@pytest.mark.parametrize("kind", ["twisted-clover", "wilson-clover"])
def test_reference_against_port_plain(kind):
    from quda_qkxtm_multigrid_tpu_torch.dirac import DiracParams, make_dirac
    from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry
    dims = (4, 6, 4, 8)
    mu = 0.05 if kind == "twisted-clover" else 0.0
    u = make_gauge(dims, derive_seed(7, 0), "cpu", "antiperiodic")
    d = make_dirac(u, DiracParams(kind="twisted-clover" if mu else "clover",
                                  kappa=0.115, mu=mu, csw=1.3),
                   Geometry(*dims))
    x = torch.randn((2, 4, 3, 8, 4, 12), dtype=torch.complex128)
    ref = TwistedClover(u, dims, 0.115, mu, 1.3)
    got = layout.spinor_to_canonical(ref.apply_lex(layout.spinor_to_lex(x, 4)))
    assert rel(got, d.m(x)) < 1e-14


def test_layout_round_trips():
    x = torch.randn((2, 4, 3, 8, 4, 12), dtype=torch.complex128)
    lex = layout.spinor_to_lex(x, 4)
    assert torch.equal(layout.spinor_to_canonical(lex), x)
    assert torch.equal(layout.spinor_slab_to_lex(x, 4, -1, 2), lex[[7, 0, 1]])
    u = make_gauge((4, 6, 4, 8), derive_seed(3, 0), "cpu", "antiperiodic")
    ul = layout.gauge_slab_to_lex(u, 4, 0, 8)
    assert torch.equal(layout.gauge_slab_to_canonical(ul, 0), u)
    # unitary, determinant 1, and the antiperiodic sign on the last t row
    eye = torch.eye(3, dtype=u.dtype)
    assert torch.allclose(ul @ ul.mH, eye.expand_as(ul), atol=1e-13)
    det = torch.linalg.det(ul)
    assert torch.allclose(det[:3], torch.ones_like(det[:3]), atol=1e-13)
    assert torch.allclose(det[3, :-1], torch.ones_like(det[3, :-1]),
                          atol=1e-13)
    assert torch.allclose(det[3, -1], -torch.ones_like(det[3, -1]),
                          atol=1e-13)


def test_point_source_matches_port():
    from quda_qkxtm_multigrid_tpu_torch import fields
    from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry
    g = Geometry(4, 6, 4, 8)
    for coords in [(0, 0, 0, 0), (3, 5, 2, 7), (1, 2, 3, 4)]:
        assert torch.equal(
            layout.point_source(g.dims, coords, 2, 1, torch.complex128,
                                "cpu"),
            fields.point_source(g, coords, 2, 1, device="cpu"))


def test_dagger_and_cgnr():
    """M† = γ5 M(−μ) γ5, and the plain CG converges in complex128."""
    dims = (4, 4, 4, 8)
    u = make_gauge(dims, derive_seed(11, 0), "cpu", "antiperiodic")
    ref = TwistedClover(u, dims, 0.115, 0.05, 1.0)
    minus = TwistedClover(u, dims, 0.115, -0.05, 1.0)
    g5 = torch.tensor([1.0, 1.0, -1.0, -1.0]).reshape(4, 1)
    a = torch.randn((8, 4, 4, 4, 4, 3), dtype=torch.complex128)
    b = torch.randn_like(a)
    lhs = torch.vdot(b.reshape(-1), ref.apply_lex(a).reshape(-1))
    rhs = torch.vdot((g5 * minus.apply_lex(g5 * b)).reshape(-1),
                     a.reshape(-1))
    assert abs(lhs - rhs) < 1e-12 * abs(lhs)
    x, iters = cgnr(ref, b, 1e-10, 500)
    assert rel(ref.apply_lex(x), b) < 1e-9 and iters < 500


def test_galerkin_pieces():
    """P and R are adjoint, V V† = 1 for an orthonormal V, and
    ``coarse_apply`` reads X and Y as V†MV built column by column."""
    dims, block, nvec = (6, 6, 6, 8), (2, 2, 2, 2), 1
    cshape = (4, 3, 3, 3)
    gen = torch.Generator().manual_seed(3)
    shape = (2,) + cshape + (nvec, 96)
    v = torch.complex(torch.randn(shape, generator=gen, dtype=torch.float64),
                      torch.randn(shape, generator=gen, dtype=torch.float64))
    v = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    assert orthonormality_gap(v) < 1e-13
    e = torch.randn((2, nvec) + cshape, dtype=torch.complex128)
    f = torch.randn((8, 6, 6, 6, 4, 3), dtype=torch.complex128)
    assert abs(torch.vdot(prolong(v, e, block).reshape(-1), f.reshape(-1))
               - torch.vdot(e.reshape(-1), restrict(v, f, block).reshape(-1))
               ) < 1e-12
    u = make_gauge(dims, derive_seed(5, 0), "cpu", "antiperiodic")
    ref = TwistedClover(u, dims, 0.115, 0.05, 1.0)
    dof, cvol = 2 * nvec, 108
    full = torch.zeros((dof, cvol, dof, cvol), dtype=torch.complex128)
    for j in range(dof * cvol):
        unit = torch.zeros(dof * cvol, dtype=torch.complex128)
        unit[j] = 1
        col = restrict(v, ref.apply_lex(
            prolong(v, unit.reshape(e.shape), block)), block)
        full[:, :, j // cvol, j % cvol] = col.reshape(dof, cvol)
    site = torch.arange(cvol).reshape(cshape)
    x = torch.stack([full[:, s, :, s] for s in range(cvol)])
    ys = []
    for d in range(8):
        mu, back = divmod(d, 2)
        axis = {0: 3, 1: 2, 2: 1, 3: 0}[mu]
        nb = torch.roll(site, 1 if back else -1, dims=axis).reshape(-1)
        ys.append(torch.stack([full[:, s, :, int(nb[s])]
                               for s in range(cvol)]))
    want = torch.einsum("asbt,bt->as", full,
                        e.reshape(dof, cvol)).reshape(e.shape)
    assert rel(coarse_apply(x, torch.stack(ys), e), want) < 1e-12
