"""The Möbius operator on the solve path (``ops.domain_wall.MobiusDirac``,
``invert``'s Möbius route) at 4³×8, Ls 8 and 24, with 48I's b5 1.5, c5
0.5 and m5 −1.8, on a seeded random SU(3) gauge with the antiperiodic t
boundary (``portbench.gauge.make_gauge``).

Against the JAX package's ``mdw_mat`` / ``mdw_matpc`` and against the
benchmark's plain reference (``portbench/reference/mobius.py``, which
imports nothing of the port): ≤ 1e-13 relative in complex128, the same
operator summed in another order.  The Schur pieces (``prepare``,
``reconstruct``) are exact identities of M; ``invert(op, b, "cg")``
solves the wall source of the benchmark's unit, certified by the
reference's residual of the full 5D system; under a profiler the solve
records its span, applies and host reads.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from quda_qkxtm_multigrid_tpu import lattice as jlat
from quda_qkxtm_multigrid_tpu.ops import domain_wall as jdw

from quda_qkxtm_multigrid_tpu_torch.invert import invert
from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry
from quda_qkxtm_multigrid_tpu_torch.ops import domain_wall as dw
from quda_qkxtm_multigrid_tpu_torch.utils import profiling
from portbench.gauge import make_gauge
from portbench.reference.mobius import Mobius, canonical5_slab_to_lex
from portbench.units.dw_solve import wall_source

DIMS = (4, 4, 4, 8)
GT, GJ = Geometry(*DIMS), jlat.Geometry(*DIMS)
M5, MFERM, B5, C5 = -1.8, 0.00078, 1.5, 0.5     # 48I (QUDA's m5 sign)
LIMIT = 1e-13
LS = [8, 24]


@functools.lru_cache(maxsize=None)
def _gauge() -> torch.Tensor:
    torch.set_num_threads(2)
    return make_gauge(DIMS, 2**33 + 21, "cpu", "antiperiodic")


@functools.lru_cache(maxsize=None)
def _op(ls: int, dtype=torch.complex128) -> dw.MobiusDirac:
    return dw.MobiusDirac(_gauge().to(dtype), GT, ls, M5, MFERM, B5, C5)


@functools.lru_cache(maxsize=None)
def _ref(ls: int) -> Mobius:
    return Mobius(_gauge(), DIMS, ls, M5, MFERM, B5, C5, slab=3)


def _field(ls: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    shape = (ls, 2, 4, 3) + GT.lat_shape
    return torch.tensor(rng.standard_normal(shape)
                        + 1j * rng.standard_normal(shape))


def _rel(got, want) -> float:
    got = torch.as_tensor(np.array(got))
    want = torch.as_tensor(np.array(want))
    assert got.shape == want.shape
    return float((got - want).norm() / want.norm())


def _lex(x5: torch.Tensor) -> torch.Tensor:
    return canonical5_slab_to_lex(x5, DIMS[0], 0, DIMS[3], "cpu",
                                  torch.complex128)


@pytest.mark.parametrize("dagger", [False, True])
@pytest.mark.parametrize("ls", LS)
def test_m_and_matpc_match_jax(ls, dagger):
    op, psi = _op(ls), _field(ls, 11)
    u = _gauge().numpy()
    want_m = jdw.mdw_mat(u, psi.numpy(), M5, MFERM, B5, C5, GJ, dagger)
    assert _rel(op.m(psi, dagger), want_m) < LIMIT
    want_pc = jdw.mdw_matpc(u, psi[:, 0].numpy(), M5, MFERM, B5, C5, GJ, 0,
                            dagger)
    assert _rel(op.matpc(psi[:, 0], dagger), want_pc) < LIMIT


@pytest.mark.parametrize("ls", LS)
def test_matpc_dagm_matches_jax(ls):
    op, psi = _op(ls), _field(ls, 12)
    u = _gauge().numpy()
    jmat = functools.partial(jdw.mdw_matpc, u, m5=M5, mferm=MFERM, b5=B5,
                             c5=C5, geom=GJ, parity=0)
    want = jmat(jmat(jnp.asarray(psi[:, 0].numpy())), dagger=True)
    assert _rel(op.matpc_dagm(psi[:, 0]), want) < LIMIT


@pytest.mark.parametrize("ls", LS)
def test_m_matches_the_reference(ls):
    psi = _field(ls, 13)
    got = _lex(_op(ls).m(psi))
    assert _rel(got, _ref(ls).apply_canonical(psi)) < LIMIT


@pytest.mark.parametrize("ls", LS)
def test_matpc_is_the_references_schur_complement(ls):
    """x = (x_e, D̃5⁻¹ κ_b D4 D4pre x_e) makes the reference's M x vanish
    on the odd parity and read D̃5 M_pc x_e on the even one."""
    op, ref = _op(ls), _ref(ls)
    x_e = _field(ls, 14)[:, 0]
    zero = torch.zeros((ls, 2, 4, 3) + GT.lat_shape, dtype=torch.complex128)
    x = op.reconstruct(x_e, zero)
    mx = ref.apply_canonical(x)
    w = torch.zeros_like(zero)
    w[:, 0] = op.matpc(x_e)
    w = _lex(w)
    want = w + ref.kappa5 * ref.d5hop(w)
    assert _rel(mx, want) < LIMIT


@pytest.mark.parametrize("ls", LS)
def test_matpc_dagger_is_the_adjoint(ls):
    op = _op(ls)
    a, b = _field(ls, 15)[:, 0], _field(ls, 16)[:, 0]
    lhs = torch.vdot(a.reshape(-1), op.matpc(b).reshape(-1))
    rhs = torch.vdot(op.matpc(a, dagger=True).reshape(-1), b.reshape(-1))
    assert abs(lhs - rhs) / abs(lhs) < LIMIT


@pytest.mark.parametrize("ls", LS)
def test_prepare_and_reconstruct_are_the_schur_pieces(ls):
    """For b = M x: the Schur source of b is M_pc x_e, and x_e with b
    rebuilds x."""
    op, x = _op(ls), _field(ls, 17)
    b = op.m(x)
    assert _rel(op.prepare(b), op.matpc(x[:, 0])) < LIMIT
    assert _rel(op.reconstruct(x[:, 0], b), x) < LIMIT
    # the channel layout gives the same
    ch = torch.stack([dw.to_channels5(b[:, p]) for p in (0, 1)])
    assert _rel(dw.from_channels5(op.prepare(ch)), op.prepare(b)) < LIMIT


@pytest.mark.parametrize("ls,tol", [(8, 1e-6), (24, 1e-3)])
def test_invert_is_certified_by_the_reference(ls, tol):
    """The wall source of a point, solved by ``invert(op, b, "cg")``:
    its own true residual and the reference's agree, and lie within a
    few times the CG tolerance (it tests the normal equations of the
    Schur system)."""
    op = _op(ls)
    b = wall_source(DIMS, ls, (1, 2, 3, 5), 2, 1, torch.complex128, "cpu")
    res = invert(op, b, tol=tol, maxiter=1000, solver="cg")
    assert res.x.shape == b.shape and res.x.dtype == b.dtype
    assert 0 < res.iters < 1000
    ref = _ref(ls).residual(res.x, lambda t0, t1: canonical5_slab_to_lex(
        b, DIMS[0], t0, t1, "cpu", torch.complex128))
    assert ref < 10 * tol
    assert abs(ref - res.true_res) < 1e-9 * max(ref, 1e-6)


def test_invert_records_its_span_applies_and_reads():
    """One solve under a profiler: the root span ``dw.solve`` with CG
    inside it as the span ``dw.cg`` (the applies its children), 2 applies
    of M_pc a CG iteration and 1 for the source's M_pc†, one host read a
    CG test, and the hops of the Ls slices (4 an iteration, 2 more for
    the source's M_pc†, 1 each for prepare and reconstruct, 2 for M)."""
    op = _op(8, torch.complex64)
    b = wall_source(DIMS, 8, (0, 1, 2, 3), 0, 2, torch.complex64, "cpu")
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        res = invert(op, b, tol=0.3, maxiter=200)
    table = profiling.table()
    profiling.reset()
    n = res.iters
    assert 0 < n < 200
    assert table["spans"]["dw.solve"]["roots"] == 1
    assert table["spans"]["dw.cg"]["calls"] == 1
    assert table["spans"]["dw.cg"]["roots"] == 0
    assert table["spans"]["op.matpc"]["calls"] == n + 1
    assert table["counters"]["op.applies"] == 2 * n + 1
    assert table["counters"]["host_reads"] == n + 1
    assert table["spans"]["op.hop5"]["calls"] == 4 * n + 6
    # nothing records without a profiler
    invert(op, b, tol=0.3, maxiter=200)
    assert profiling.table() == {"spans": {}, "counters": {}}


def test_complex64_operator_is_the_complex128_one():
    psi = _field(8, 18)
    got = _op(8, torch.complex64).m(psi.to(torch.complex64))
    assert got.dtype == torch.complex64
    assert _rel(got.to(torch.complex128), _op(8).m(psi)) < 2e-6


def test_invert_refuses_what_the_route_does_not_take():
    op = _op(8)
    b = torch.zeros((8, 2, 4, 3) + GT.lat_shape, dtype=torch.complex128)
    for kw in (dict(solver="bicgstab"), dict(solver="cg-mixed"),
               dict(sloppy_dirac=op)):
        with pytest.raises(ValueError):
            invert(op, b, **kw)
    with pytest.raises(TypeError):
        dw.MobiusDirac(_gauge(), GT, 8, M5, MFERM, np.full(8, B5), C5)
