"""The compact channel operator of the port (``compact.py``) against the
JAX package's: ``make_compact``'s bf16 and float32 operands bit for bit
(the JAX build is plain ``jnp``), the plain A and A⁻¹ on channels against
JAX's (float32 rounding, 1e-6), the float64 tier against the canonical
operator (1e-12: the same maths on channels), ``invert_compact_full``
against the port's canonical ``invert`` (the JAX package's own bounds,
``tests/test_compact.py``: x within 5e-5, compact residual below 5e-6),
the rounding rule of the bf16 tier, ``invert``'s dispatch of a
``CompactDirac`` and its refusals, and the mixed CG with a compact
sloppy operator (``benchmarks.compact_sloppy_solve``).  The Schur chain
against the JAX ``CompactDirac`` in Pallas interpret mode is
``tests/test_torch_compact_chain.py``; prepare, reconstruct and the full
operator against the JAX ``CompactDirac``'s are
``tests/test_torch_compact_schur.py``.  Tolerances are normwise
relative.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from quda_qkxtm_multigrid_tpu import compact as jc
from quda_qkxtm_multigrid_tpu import dirac as jd
from quda_qkxtm_multigrid_tpu import lattice as jlat
from quda_qkxtm_multigrid_tpu.ops.dslash_pallas import (
    _to_channels as j_to_channels)
from quda_qkxtm_multigrid_tpu.utils import rng as jrng

from quda_qkxtm_multigrid_tpu_torch import convert
from quda_qkxtm_multigrid_tpu_torch import lattice as tlat
from quda_qkxtm_multigrid_tpu_torch.benchmarks import (
    bench_cg, bench_compact_sloppy, compact_sloppy_solve)
from quda_qkxtm_multigrid_tpu_torch.compact import (
    CompactDirac, compact_true_residual, invert_compact,
    invert_compact_full, make_compact)
from quda_qkxtm_multigrid_tpu_torch.convert import spinor_to_numpy as N
from quda_qkxtm_multigrid_tpu_torch.dirac import DiracParams
from quda_qkxtm_multigrid_tpu_torch.invert import invert
from quda_qkxtm_multigrid_tpu_torch.ops.dslash_kernel import (
    cast_channels, to_channels)

# the tests run on the CPU; the converters default to the card
dirac_from_numpy = functools.partial(convert.dirac_from_numpy, device="cpu")
T = functools.partial(convert.spinor_from_numpy, device="cpu")

torch.set_num_threads(1)

BF16, F32, F64 = torch.bfloat16, torch.float32, torch.float64
GJ = jlat.Geometry(4, 4, 4, 8)
GT = tlat.Geometry(4, 4, 4, 8)
GJ_S = jlat.Geometry(8, 4, 4, 8)      # the JAX compact tests' geometry
GT_S = tlat.Geometry(8, 4, 4, 8)
TMC = dict(kind="twisted-clover", kappa=0.115, mu=0.05, csw=1.0)
TM = dict(kind="twisted-mass", kappa=0.115, mu=0.05)
SOLVE_X, SOLVE_RES = 5e-5, 5e-6       # JAX tests/test_compact.py bounds


def rel(got, ref) -> float:
    got = N(got) if torch.is_tensor(got) else np.asarray(got)
    ref = N(ref) if torch.is_tensor(ref) else np.asarray(ref)
    return float(np.linalg.norm((got - ref).ravel())
                 / np.linalg.norm(ref.ravel()))


def _fields(geom, seed):
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    u = np.asarray(jrng.random_gauge(k1, geom, dtype=jnp.complex128))
    b = np.asarray(jrng.random_spinor(k2, geom, dtype=jnp.complex128))
    return u, b


@pytest.fixture(scope="module")
def flds():
    return _fields(GJ, 71)


@pytest.fixture(scope="module")
def jax_compact(flds):
    """The JAX package's ``make_compact`` on ``flds``'s gauge, built once
    per (kind, bf16)."""
    built = {}

    def get(prm, bf16):
        key = (prm["kind"], bf16)
        if key not in built:
            built[key] = jc.make_compact(jnp.asarray(flds[0]),
                                         jd.DiracParams(**prm), GJ, bf16=bf16)
        return built[key]
    return get


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy()


def _jbits(a) -> np.ndarray:
    return np.asarray(jax.lax.bitcast_convert_type(a, jnp.int16))


# ---- make_compact against the JAX build --------------------------------------

@pytest.mark.parametrize("bf16", [True, False])
def test_make_compact_operands_bitexact(flds, jax_compact, bf16):
    """The channel operands of both parities equal the JAX package's bit
    for bit: bf16 gauge and clover with the float32 inverse of the
    bf16-rounded clover, or all float32."""
    u, _ = flds
    ref = jax_compact(TMC, bf16)
    cd = make_compact(T(u), DiracParams(**TMC), GT, BF16 if bf16 else F32)
    assert cd.params.use_kernels and cd.params.kernel_bf16 == bf16
    for p in (0, 1):
        for name in ("g_ch", "cl_ch"):
            got, want = getattr(cd, name)[p], getattr(ref, name)[p]
            if bf16:
                assert got.dtype == BF16
                np.testing.assert_array_equal(_bits(got), _jbits(want))
            else:
                np.testing.assert_array_equal(N(got), np.asarray(want))
        assert cd.cinv_ch[p].dtype == F32
        np.testing.assert_array_equal(N(cd.cinv_ch[p]),
                                      np.asarray(ref.cinv_ch[p]))


def test_make_compact_twisted_mass_and_refusals(flds):
    """Twisted mass keeps the gauge only; ``inverse=False`` leaves out A⁻¹,
    so the Schur operator refuses and the full operator runs; another
    channel dtype raises."""
    u, _ = flds
    tm = make_compact(T(u), DiracParams(**TM), GT, F32)
    assert tm.cinv_ch is None and tm.cl_ch is None
    assert tuple(tm.g_ch.shape) == (2, GT.T, 96, GT.Z, GT.W)
    lean = make_compact(T(u), DiracParams(**TMC), GT, F64, inverse=False)
    assert lean.cinv_ch is None and lean.cl_ch.dtype == F64
    v = to_channels(T(u)[0, 0, :1].expand(4, 3, *GT.lat_shape).contiguous())
    e, o = lean.m_ch(v.to(F64), v.to(F64))
    assert e.dtype == F64 and o.dtype == F64
    with pytest.raises(ValueError, match="without A"):
        lean.matpc_ch(v.to(F64))
    with pytest.raises(ValueError, match="channel dtype"):
        make_compact(T(u), DiracParams(**TMC), GT, torch.float16)


# ---- the plain A and A⁻¹ on channels ------------------------------------------

@pytest.mark.parametrize("kind", ["twisted-clover", "twisted-mass"])
def test_a_apply_and_inverse_match_jax(flds, jax_compact, kind):
    """``_a_apply_ch`` (both daggers) and ``_a_inv_ch`` of the bf16 tier
    against the JAX package's on identical operands: plain ``jnp`` in
    both, float32 with another summation order."""
    u, b = flds
    prm = TMC if kind == "twisted-clover" else TM
    cd = make_compact(T(u), DiracParams(**prm), GT, BF16)
    jcd = jax_compact(prm, True)
    v = j_to_channels(jnp.asarray(b[1]))
    tv = T(np.asarray(v))
    for p in (0, 1):
        for dag in (False, True):
            assert rel(cd._a_apply_ch(tv, p, dag=dag),
                       jcd._a_apply_ch(v, p, dag=dag)) <= 1e-6
        assert rel(cd._a_inv_ch(tv, p), jcd._a_inv_ch(v, p)) <= 1e-6


# ---- the float64 tier is the canonical operator on channels -----------------

@pytest.mark.parametrize("kind", ["twisted-clover", "twisted-mass"])
def test_float64_tier_is_the_canonical_operator(flds, kind):
    """Every adapter of the float64 tier (full operator and its dagger,
    matpc both ways, matpc†matpc, prepare, reconstruct, A) equals the
    canonical ``Dirac`` in complex128."""
    u, b = flds
    prm = TMC if kind == "twisted-clover" else TM
    d = dirac_from_numpy(u, DiracParams(**prm, use_kernels=True), GT)
    cd = make_compact(T(u), DiracParams(**prm), GT, F64)
    psi = T(b)
    assert cd.field_dtype == torch.complex128
    for got, ref in ((cd.m(psi), d.m(psi)), (cd.mdag(psi), d.mdag(psi)),
                     (cd.mdagm(psi), d.mdagm(psi)),
                     (cd.matpc(psi[0]), d.matpc(psi[0])),
                     (cd.matpc(psi[0], True), d.matpc(psi[0], True)),
                     (cd.matpc_dagm(psi[0]), d.matpc_dagm(psi[0])),
                     (cd.prepare(psi), d.prepare(psi)),
                     (cd.reconstruct(psi[0], psi), d.reconstruct(psi[0], psi)),
                     (cd.a_apply(psi[1], 1, True), d.a_apply(psi[1], 1, True))):
        assert rel(got, ref) <= 1e-12


@pytest.mark.parametrize("tier", ["f32", "bf16"])
@pytest.mark.parametrize("dagger", [False, True])
@pytest.mark.parametrize("kind", ["twisted-mass", "twisted-clover"])
def test_compact_chain_is_the_dirac_chain(flds, kind, dagger, tier):
    """``CompactDirac.matpc_ch`` on a ``Dirac``'s own channel operands
    (``_operands``: gauge and clover inverse stacked over the parities)
    is ``Dirac._fused_matpc_ch``, bit for bit, in the float32 and the
    bf16 operand tier: both run the one chain, ``dirac._ch_matpc``."""
    u, b = flds
    params = DiracParams(use_kernels=True, kernel_bf16=tier == "bf16",
                         **(TMC if kind == TMC["kind"] else TM))
    d = dirac_from_numpy(u, params, GT)
    ops = d._operands(F32)
    assert ops["g"][0].dtype == (BF16 if tier == "bf16" else F32)
    ci = ops.get("ci")
    cd = CompactDirac(torch.stack(ops["g"]),
                      None if ci is None else torch.stack(ci), None,
                      d.params, GT, d.antiperiodic)
    v = to_channels(T(b[0])).to(F32)
    assert torch.equal(cd.matpc_ch(v, dagger), d._fused_matpc_ch(v, dagger))


def test_widened_is_the_same_operator(flds):
    """``widened`` casts the stored channels exactly; the float64 chain on
    them agrees with the bf16 tier's float32 chain to float32 rounding."""
    u, b = flds
    cd = make_compact(T(u), DiracParams(**TMC), GT, BF16)
    wide = cd.widened()
    assert wide.g_ch.dtype == F64 and not wide.params.kernel_bf16
    assert torch.equal(wide.g_ch.to(BF16), cd.g_ch)
    assert torch.equal(wide.cinv_ch.to(F32), cd.cinv_ch)
    v = cd._to_ch(T(b[0]))
    assert rel(wide.matpc_dagm_ch(v.to(F64)), cd.matpc_dagm_ch(v)) <= 1e-6


# ---- solves -------------------------------------------------------------------

@pytest.fixture(scope="module")
def solve_fields():
    return _fields(GJ_S, 72)


@pytest.mark.parametrize("kind", ["twisted-mass", "twisted-clover"])
def test_invert_compact_full_matches_canonical_invert(solve_fields, kind):
    """The float32 tier's full solve against the canonical complex128
    ``invert`` (CG, tol 1e-7): the JAX package's bounds on x and on the
    compact operator's own residual; ``compact_true_residual`` agrees."""
    u, b = solve_fields
    prm = TMC if kind == "twisted-clover" else TM
    d = dirac_from_numpy(u, DiracParams(**prm, use_kernels=True), GT_S)
    ref = invert(d, T(b), tol=1e-7, maxiter=400)
    cd = make_compact(T(u), DiracParams(**prm), GT_S, F32)
    out = invert_compact_full(cd, T(b), tol=1e-7, maxiter=400)
    assert out.x.dtype == torch.complex128 and 0 < out.iters < 400
    assert rel(out.x, ref.x) < SOLVE_X
    assert out.true_res < SOLVE_RES
    _, rres = compact_true_residual(cd, out.x, T(b))
    assert abs(float(rres) - out.true_res) <= 1e-3 * out.true_res


def test_bf16_rounding_rule(flds):
    """The bf16 tier inverts the bf16-rounded clover and keeps that
    inverse in float32, so A and A⁻¹ agree and the compact solve
    certifies; the same operands with an independently rounded bf16 A⁻¹
    (the inverse of the unrounded clover) floor near 1e-3."""
    u, b = flds
    cd = make_compact(T(u), DiracParams(**TMC), GT, BF16)
    ruled = invert_compact_full(cd, T(b), tol=1e-7, maxiter=400)
    assert ruled.true_res < SOLVE_RES
    exact = make_compact(T(u), DiracParams(**TMC), GT, F64)
    naive = CompactDirac(cd.g_ch, cast_channels(exact.cinv_ch, BF16).to(F32),
                         cd.cl_ch, cd.params, GT)
    floored = invert_compact_full(naive, T(b), tol=1e-7, maxiter=400)
    assert 1e-4 < floored.true_res < 1e-2


# ---- invert's dispatch ---------------------------------------------------------

def test_invert_dispatches_compact(flds):
    u, b = flds
    cd = make_compact(T(u), DiracParams(**TMC), GT, F32)
    out = invert(cd, T(b), tol=1e-7, maxiter=400)
    ref = invert_compact_full(cd, T(b), tol=1e-7, maxiter=400)
    assert torch.equal(out.x, ref.x) and out.iters == ref.iters
    (x_e, x_o), iters, rel2 = invert_compact(cd, cd._to_ch(T(b)[0]),
                                             cd._to_ch(T(b)[1]), tol=1e-7,
                                             maxiter=400)
    assert iters == ref.iters and float(rel2) <= 1e-14


def test_invert_compact_refusals(flds):
    """A CompactDirac solves with CG only and takes no sloppy operator,
    and is no sloppy operator of ``invert``'s mixed solvers; the compact
    sloppy solve needs a fused outer, and ``bench_cg`` has no compact
    sloppy operator."""
    u, b = flds
    cd = make_compact(T(u), DiracParams(**TMC), GT, BF16)
    d = dirac_from_numpy(u, DiracParams(**TMC, use_kernels=True), GT)
    bb = T(b)
    for solver in ("cg-mixed", "bicgstab", "bicgstab-mixed"):
        with pytest.raises(ValueError, match="solver='cg' only"):
            invert(cd, bb, solver=solver)
    with pytest.raises(ValueError, match="no sloppy operator"):
        invert(cd, bb, sloppy_dirac=d)
    for solver in ("cg-mixed", "bicgstab-mixed"):
        with pytest.raises(ValueError, match="no sloppy operator of invert"):
            invert(d, bb, solver=solver, sloppy_dirac=cd)
    plain = dirac_from_numpy(u, DiracParams(**TMC), GT)
    with pytest.raises(ValueError, match="fused chain"):
        compact_sloppy_solve(plain, cd, bb)
    with pytest.raises(ValueError, match="not one of"):
        bench_cg(GT, problem=(d, bb), solver="cg-mixed",
                 sloppy="compact-bf16")


@pytest.mark.parametrize("dtype", [BF16, F32])
def test_invert_mixed_with_compact_sloppy(flds, dtype, monkeypatch):
    """The mixed CG of ``invert(solver="cg-mixed")`` on the complex128
    operator with a compact tier of the same gauge as its sloppy operator
    (``compact_sloppy_solve``): the bf16 tier's inner chain keeps its
    planes in bf16 (K1e), the float32 tier's in float32; the outer
    certifies 1e-10 in complex128."""
    u, b = flds
    d = dirac_from_numpy(u, DiracParams(**TMC, use_kernels=True), GT)
    cd = make_compact(T(u), DiracParams(**TMC), GT, dtype)
    storages = []
    inner = cd.matpc_dagm_ch
    monkeypatch.setattr(cd, "matpc_dagm_ch", lambda v, storage_dtype=None: (
        storages.append(storage_dtype), inner(v, storage_dtype))[1])
    out = compact_sloppy_solve(d, cd, T(b), tol=1e-10)
    assert out.x.dtype == torch.complex128
    assert out.true_res <= 5e-10 and not out.stats.diverged
    assert out.stats.restarts >= 2
    assert set(storages) == {BF16 if dtype == BF16 else None}


def test_bench_compact_sloppy_record(flds):
    """``bench_compact_sloppy`` keeps ``bench_cg``'s record: a cold and a
    warm solve on the bf16 tier of the problem's gauge, both certified."""
    u, b = flds
    d = dirac_from_numpy(u, DiracParams(**TMC, use_kernels=True), GT)
    rec, cd = bench_compact_sloppy(GT, tol=1e-10, problem=(d, T(b)))
    assert cd.g_ch.dtype == BF16 and cd.cinv_ch.dtype == F32
    assert rec["solver"] == "cg-mixed-compact-bf16"
    assert max(rec["true_res"], rec["true_res_cold"]) <= 5e-10
    assert rec["restarts"] == rec["restarts_cold"] >= 2
    assert rec["iters"] == rec["iters_cold"] and not rec["diverged"]
    assert rec["peak_mem_bytes"] is None


def test_flops_and_protocol(flds):
    u, _ = flds
    cd = make_compact(T(u), DiracParams(**TMC), GT, BF16)
    d = dirac_from_numpy(u, DiracParams(**TMC, use_kernels=True), GT)
    assert cd.flops_per_mat() == d.flops_per_mat()
    assert CompactDirac._has_fused_matpc is False
    assert cd.spinor_dtype == F32 and cd.field_dtype == torch.complex64
