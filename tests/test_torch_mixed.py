"""The mixed-precision solvers of the port against the JAX package's:
``cg_mixed`` and ``bicgstab_mixed`` (complex128 outer, complex64 inner)
and ``invert`` with all four solvers against the JAX package's plain
XLA path (``use_pallas=False``) in complex128 at 4³×8, tol 1e-10, x
within 1e-8 (normwise relative); the fused channel path with the bf16
and the complex64 sloppy operators; the residual-increase counters; the
channel BLAS that the channel BiCGstab uses; and ``bench_cg``'s mixed
record.
"""

import functools
import inspect
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from quda_qkxtm_multigrid_tpu import dirac as jd
from quda_qkxtm_multigrid_tpu import fields as jfields
from quda_qkxtm_multigrid_tpu import lattice as jlat
from quda_qkxtm_multigrid_tpu.invert import (
    _default_sloppy as j_default_sloppy, invert as j_invert)
from quda_qkxtm_multigrid_tpu.solvers.bicgstab import (
    bicgstab_mixed as j_bicgstab_mixed)
from quda_qkxtm_multigrid_tpu.solvers.cg import cg_mixed as j_cg_mixed
from quda_qkxtm_multigrid_tpu.utils import rng as jrng

from quda_qkxtm_multigrid_tpu_torch import fields as tfields
from quda_qkxtm_multigrid_tpu_torch import lattice as tlat
from quda_qkxtm_multigrid_tpu_torch.benchmarks import bench_cg
from quda_qkxtm_multigrid_tpu_torch import convert
from quda_qkxtm_multigrid_tpu_torch.convert import spinor_to_numpy as N
from quda_qkxtm_multigrid_tpu_torch.dirac import DiracParams, as_sloppy
from quda_qkxtm_multigrid_tpu_torch.invert import (
    SOLVERS, _default_sloppy, invert)
from quda_qkxtm_multigrid_tpu_torch.ops.blas import (
    cDotProduct, cDotProduct_ch, cscale_ch)
from quda_qkxtm_multigrid_tpu_torch.ops.dslash_kernel import (
    from_channels, to_channels)
from quda_qkxtm_multigrid_tpu_torch.solvers.bicgstab import (
    bicgstab, bicgstab_mixed)
from quda_qkxtm_multigrid_tpu_torch.solvers.cg import cg_mixed

# the tests run on the CPU; the converters default to the card
dirac_from_numpy = functools.partial(convert.dirac_from_numpy, device="cpu")
T = functools.partial(convert.spinor_from_numpy, device="cpu")

torch.set_num_threads(1)

GJ = jlat.Geometry(4, 4, 4, 8)
GT = tlat.Geometry(4, 4, 4, 8)
TMC = dict(kind="twisted-clover", kappa=0.115, mu=0.05, csw=1.0)
TOL = 1e-10
X_TOL = 1e-8          # solution against the JAX package's
TRUE_RES = 5e-10      # complex128 true residual of a mixed solve at TOL


def rel(got, ref) -> float:
    got = N(got) if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.linalg.norm((got - ref).ravel())
                 / np.linalg.norm(ref.ravel()))


@pytest.fixture(scope="module")
def problem():
    """complex128 gauge and point source; the JAX package's plain
    operator and its default (complex64) sloppy operator."""
    u = np.asarray(jrng.random_gauge(jax.random.PRNGKey(81), GJ))
    b = np.asarray(jfields.point_source(GJ, (1, 0, 2, 3), 0, 0))
    dj = jd.make_dirac(u, jd.DiracParams(**TMC), GJ)
    return u, b, dj, j_default_sloppy(dj)


_JAX = {}


def _jax_invert(problem, solver):
    if solver not in _JAX:
        _, b, dj, _ = problem
        _JAX[solver] = j_invert(dj, b, tol=TOL, maxiter=1000, solver=solver)
    return _JAX[solver]


# ---- the solvers ------------------------------------------------------------

@pytest.mark.parametrize("name", ["cg_mixed", "bicgstab_mixed"])
def test_mixed_solver_matches_jax(problem, name):
    """The solver alone on the plain operators, complex128 outer and
    complex64 inner (the default sloppy operator of both packages),
    inner_tol 1e-2 as ``invert`` passes it."""
    u, b, dj, sj = problem
    normal = name == "cg_mixed"
    src = dj.prepare(b)
    rhs = dj.matpc(src, dagger=True) if normal else src
    jfn, tfn = ((j_cg_mixed, cg_mixed) if normal
                else (j_bicgstab_mixed, bicgstab_mixed))
    op = "matpc_dagm" if normal else "matpc"
    ref = jfn(getattr(dj, op), getattr(sj, op), rhs, tol=TOL, inner_tol=1e-2)
    d = dirac_from_numpy(u, DiracParams(**TMC), GT)
    s = _default_sloppy(d)
    assert s.u.dtype == torch.complex64
    got = tfn(getattr(d, op), getattr(s, op), T(np.asarray(rhs)), tol=TOL,
              inner_tol=1e-2)
    assert rel(got.x, ref.x) <= X_TOL
    assert abs(got.stats.restarts - int(ref.stats.restarts)) <= 1
    assert not got.stats.diverged and not bool(ref.stats.diverged)
    assert float(got.r2) <= TOL ** 2 * float(np.vdot(rhs, rhs).real)


def _hpd(n=30, seed=3):
    r = np.random.default_rng(seed)
    a = r.standard_normal((n, n)) + 1j * r.standard_normal((n, n))
    return (a.conj().T @ a / n + 0.5 * np.eye(n),
            r.standard_normal(n) + 1j * r.standard_normal(n))


def test_residual_increase_counters_match_jax():
    """A sloppy operator 0.3 A overshoots every correction (r → −2.3 r):
    the counters stop the solve after two increases in a row and report
    ``diverged``, as the JAX package's."""
    a, b = _hpd()
    ja, ta = jnp.asarray(a), T(a)
    ref = j_cg_mixed(lambda v: ja @ v, lambda v: (0.3 * ja.astype(
        jnp.complex64)) @ v, jnp.asarray(b), tol=TOL, inner_tol=1e-8)
    got = cg_mixed(lambda v: ta @ v, lambda v: (0.3 * ta.to(
        torch.complex64)) @ v, T(b), tol=TOL, inner_tol=1e-8)
    assert got.stats == (int(ref.stats.restarts), int(ref.stats.res_increase),
                         int(ref.stats.res_increase_total), True)
    assert bool(ref.stats.diverged)
    assert rel(got.x, ref.x) <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_channel_blas(dtype):
    """<x, y> and z·x of the complex fields that channel fields stand for,
    against the complex forms (batched channel fields too)."""
    r = np.random.default_rng(5)
    shape = (2, 4, 3) + GT.lat_shape
    x, y = (T(r.standard_normal(shape) + 1j * r.standard_normal(shape))
            for _ in range(2))
    cdt = torch.complex128 if dtype == torch.float64 else torch.complex64
    x, y = x.to(cdt), y.to(cdt)
    xc = torch.stack([to_channels(v) for v in x])
    yc = torch.stack([to_channels(v) for v in y])
    tol = 1e-13 if dtype == torch.float64 else 1e-5
    ref = cDotProduct(x, y)
    assert abs(complex(cDotProduct_ch(xc, yc)) - complex(ref)) \
        <= tol * abs(complex(ref))
    z = torch.tensor(0.3 - 1.7j, dtype=cdt)
    got = cscale_ch(z, xc)
    assert got.dtype == dtype
    back = torch.stack([from_channels(v, (4, 3)) for v in got])
    assert rel(back, N(z * x)) <= tol
    assert torch.equal(cscale_ch(2.0, xc), 2.0 * xc)


def test_bicgstab_on_channels_is_complex_bicgstab(problem):
    """BiCGstab on channel fields (real, so it takes the channel BLAS)
    takes the same steps as on the complex fields (complex128, plain
    operator)."""
    u, b, _, _ = problem
    d = dirac_from_numpy(u, DiracParams(**TMC), GT)
    src = d.prepare(T(b))
    ref = bicgstab(d.matpc, src, tol=TOL, maxiter=500)
    got = bicgstab(lambda v: to_channels(d.matpc(from_channels(v, (4, 3)))),
                   to_channels(src), tol=TOL, maxiter=500)
    assert got.iters == ref.iters
    assert rel(from_channels(got.x, (4, 3)), N(ref.x)) <= 1e-10


# ---- invert ---------------------------------------------------------------

@pytest.mark.parametrize("solver", SOLVERS)
def test_invert_matches_jax(problem, solver):
    """Every solver of ``invert`` on the plain complex128 operator against
    the JAX package's ``invert(use_pallas=False)``."""
    u, b, _, _ = problem
    ref = _jax_invert(problem, solver)
    d = dirac_from_numpy(u, DiracParams(**TMC), GT)
    out = invert(d, T(b), tol=TOL, maxiter=1000, solver=solver)
    assert rel(out.x, ref.x) <= X_TOL
    assert out.true_res <= 1e-8 and float(ref.true_res) <= 1e-8
    assert (out.stats is None) == (not solver.endswith("-mixed"))
    if out.stats is not None:
        assert not out.stats.diverged


@pytest.mark.parametrize("solver", ["cg-mixed", "bicgstab-mixed"])
@pytest.mark.parametrize("sloppy", ["bf16", "c64"])
def test_invert_mixed_fused(problem, solver, sloppy):
    """The fused channel path (plain hops on the CPU): a float64 outer on
    the complex128 operator around a float32 inner on the bf16 tier
    (``as_sloppy``) or on the default sloppy operator, to tol 1e-10,
    against the JAX package's complex128 CG solution."""
    u, b, _, _ = problem
    ref = _jax_invert(problem, "cg")
    d = dirac_from_numpy(u, DiracParams(**TMC, use_kernels=True), GT)
    sl = as_sloppy(d, kernel_bf16=True) if sloppy == "bf16" else None
    out = invert(d, T(b), tol=TOL, maxiter=1000, solver=solver,
                 sloppy_dirac=sl)
    assert out.true_res <= TRUE_RES
    assert rel(out.x, ref.x) <= X_TOL
    assert out.stats.restarts >= 2 and not out.stats.diverged


@pytest.mark.parametrize("solver", ["cg-mixed", "bicgstab-mixed"])
def test_invert_mixed_maxiter_caps_inner_iterations(problem, solver):
    """``maxiter`` caps the summed inner iterations of a mixed solve (it
    takes ~25 uncapped): with a cap of 3 the solve stops after exactly
    3, far from the tolerance, and does not report divergence."""
    u, b, _, _ = problem
    d = dirac_from_numpy(u, DiracParams(**TMC), GT)
    out = invert(d, T(b), tol=TOL, maxiter=3, solver=solver)
    assert out.iters == 3
    assert out.true_res > 1e-4 and not out.stats.diverged


def test_invert_bicgstab_fused_float32(problem):
    """The fused "bicgstab" runs on float32 channels (as the JAX
    package's fused matpc), so it is held to a float32 tolerance."""
    u, b, _, _ = problem
    ref = _jax_invert(problem, "cg")
    d = dirac_from_numpy(u, DiracParams(**TMC, use_kernels=True), GT)
    out = invert(d, T(b), tol=1e-6, maxiter=500, solver="bicgstab")
    assert out.x.dtype == torch.complex128
    assert out.true_res <= 1e-5 and rel(out.x, ref.x) <= 1e-5


def test_default_sloppy(problem):
    """Fused chain: the operator itself (float32 channels one tier
    down); plain complex128: a complex64 copy; plain complex64: the same
    tensors."""
    u = problem[0]
    fused = dirac_from_numpy(u, DiracParams(**TMC, use_kernels=True), GT)
    assert _default_sloppy(fused) is fused
    plain = dirac_from_numpy(u, DiracParams(**TMC), GT)
    s = _default_sloppy(plain)
    assert s.u.dtype == s.clover_inv.dtype == torch.complex64
    c64 = dirac_from_numpy(u.astype(np.complex64), DiracParams(**TMC), GT)
    s = _default_sloppy(c64)
    assert s.u.data_ptr() == c64.u.data_ptr()


def test_bench_cg_mixed_record(problem):
    u, b, _, _ = problem
    d = dirac_from_numpy(u, DiracParams(**TMC, use_kernels=True), GT)
    rec = bench_cg(GT, tol=TOL, problem=(d, T(b)), solver="cg-mixed",
                   sloppy="bf16")
    assert rec["solver"] == "cg-mixed-fused-bf16"
    assert rec["true_res"] <= TRUE_RES and not rec["diverged"]
    assert rec["restarts"] == rec["restarts_cold"] >= 2
    assert rec["peak_mem_bytes"] is None
    for solver, sloppy in (("cg", "bf16"), ("cg-mixed", None),
                           ("cg-mixed", "f16")):
        with pytest.raises(ValueError):
            bench_cg(GT, problem=(d, T(b)), solver=solver, sloppy=sloppy)


@pytest.mark.parametrize("name", ["spinor_from_numpy", "dirac_from_numpy",
                                  "transfer_from_numpy"])
def test_converters_default_to_the_card(problem, name):
    """The converters from the JAX package's numpy fields build on the
    card unless told otherwise (here, with no card, the default fails)."""
    fn = getattr(convert, name)
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    u = problem[0]
    args = {"spinor_from_numpy": (u,),
            "dirac_from_numpy": (u, DiracParams(**TMC), GT),
            "transfer_from_numpy": (np.zeros((2, 1, 1, 1, 1, 2, 3)),
                                    types.SimpleNamespace(
                                        coarse_shape=(1, 1, 1, 1), nvec=2,
                                        bdof=3))}[name]
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            fn(*args)


def test_fields_default_to_the_card():
    """The field constructors make their field on the card unless told
    otherwise (here, with no card, asking for the default fails)."""
    z = tfields.zeros_spinor(GT, device="cpu")
    assert z.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            tfields.point_source(GT, (0, 0, 0, 0), 0, 0)
