"""The fused steps of a CG iteration (``ops.blas.cg_pap``,
``cg_r_update_norm``, ``cg_xp_update``: ``csrc/blas_cg.cu`` on the card,
their plain versions on the CPU) and ``solvers.cg.cg`` that runs on them.

On the CPU: each step against the eager expressions it fuses
(``reDotProduct``, ``axpy``, ``norm2``, ``xpay``) on float32, float64,
complex64 and complex128 fields, lengths off a multiple of 4 included,
and the reductions against float64 sums of the same products; ``cg``
against a copy of the loop it replaced (the same iterations, x within
1e-6 in single precision and 1e-12 in double: only the order and
precision of the sums changed) with and without ``x0``, ``tol_hq`` and
an ``allreduce``; the counter ``krylov.fused_iters``.  The ``cuda``
tests hold the kernels to the plain versions on the card (a slice off
the 16-byte grid, a scalar tail), two runs to the same bits, the
refusals, and ``cg`` on the card to its launches; they skip themselves
without one.  No JAX here: the card's tests run in files without it.
"""

import ctypes

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from quda_qkxtm_multigrid_tpu_torch import _build
from quda_qkxtm_multigrid_tpu_torch.ops import blas
from quda_qkxtm_multigrid_tpu_torch.ops.blas import (
    axpy, cg_pap, cg_r_update_norm, cg_xp_update, norm2, reDotProduct, xpay)
from quda_qkxtm_multigrid_tpu_torch.solvers.cg import cg
from quda_qkxtm_multigrid_tpu_torch.solvers.support import (
    heavy_quark_residual_sq)
from quda_qkxtm_multigrid_tpu_torch.utils import profiling

DTYPES = [torch.float32, torch.float64, torch.complex64, torch.complex128]
SHAPES = [(7,), (4, 3, 5), (1001,), (2, 24, 4, 8)]
# an update or a sum in the field's precision against another order
LIMIT = {torch.float32: 1e-6, torch.float64: 1e-13,
         torch.complex64: 1e-6, torch.complex128: 1e-13}
X_LIMIT = {torch.float32: 1e-6, torch.float64: 1e-12,
           torch.complex64: 1e-6, torch.complex128: 1e-12}


def _field(shape, dtype, seed: int, device="cpu") -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    wide = torch.complex128 if dtype.is_complex else torch.float64
    return torch.randn(shape, generator=gen, dtype=wide).to(dtype).to(device)


def _rel(a, b) -> float:
    a, b = (torch.as_tensor(t, dtype=torch.float64) if isinstance(t, float)
            else t for t in (a, b))
    wide = torch.complex128 if a.is_complex() else torch.float64
    a, b = a.to(wide), b.to(wide)
    return float((a - b).abs().norm() / b.abs().norm())


def _exact_dot(a: torch.Tensor, b: torch.Tensor) -> float:
    """Re⟨a, b⟩ in numpy float64 (products of floats exact there)."""
    ra = torch.view_as_real(a) if a.is_complex() else a
    rb = torch.view_as_real(b) if b.is_complex() else b
    return float(np.dot(ra.double().reshape(-1).numpy(),
                        rb.double().reshape(-1).numpy()))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_pap_is_the_real_inner_product(dtype, shape):
    p, ap = _field(shape, dtype, 1), _field(shape, dtype, 2)
    got = cg_pap(p, ap)
    assert got.dtype == torch.float64 and got.dim() == 0
    assert _rel(got, reDotProduct(p, ap)) < LIMIT[dtype]
    assert _rel(got, _exact_dot(p, ap)) < 1e-13
    assert _rel(cg_pap(p, p), norm2(p)) < LIMIT[dtype]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_r_update_norm_is_axpy_then_norm2(dtype, shape):
    r, ap = _field(shape, dtype, 3), _field(shape, dtype, 4)
    alpha = torch.tensor(0.37, dtype=torch.float64)
    want = axpy(-alpha.to(r.real.dtype), ap, r.clone())
    got2 = cg_r_update_norm(r, ap, alpha)
    assert got2.dtype == torch.float64 and got2.dim() == 0
    assert _rel(r, want) < LIMIT[dtype]
    assert _rel(got2, norm2(want)) < LIMIT[dtype]
    assert _rel(got2, _exact_dot(r, r)) < 1e-13


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_xp_update_is_axpy_then_xpay(dtype, shape):
    x, p, r = (_field(shape, dtype, s) for s in (5, 6, 7))
    alpha = torch.tensor(0.61, dtype=torch.float64)
    beta = torch.tensor(-1.3, dtype=torch.float64)
    real = r.real.dtype
    want_x = axpy(alpha.to(real), p, x.clone())
    want_p = xpay(r, beta.to(real), p.clone())
    cg_xp_update(x, p, r, alpha, beta)
    assert _rel(x, want_x) < LIMIT[dtype]
    assert _rel(p, want_p) < LIMIT[dtype]


def test_plain_versions_launch_nothing():
    v = _field((9,), torch.complex64, 8)
    before = (cg_pap.launches, cg_r_update_norm.launches,
              cg_xp_update.launches)
    cg_pap(v, v)
    cg_r_update_norm(v, v.clone(), 0.5)
    cg_xp_update(v.clone(), v.clone(), v, 0.5, 0.25)
    assert (cg_pap.launches, cg_r_update_norm.launches,
            cg_xp_update.launches) == before


@pytest.mark.parametrize("step", ["pap", "r_update_norm", "xp_update"])
def test_a_field_off_the_cpu_never_runs_the_plain_version(step):
    """Off the CPU a step launches the kernel or raises: a field on
    another device (``meta`` here) is refused before any launch."""
    v = torch.empty(8, device="meta")
    with pytest.raises(ValueError):
        {"pap": lambda: cg_pap(v, v),
         "r_update_norm": lambda: cg_r_update_norm(v, v, 0.5),
         "xp_update": lambda: cg_xp_update(v, v, v, 0.5, 0.5)}[step]()


def test_entry_point_table():
    """Six entry points (three steps, float32 and float64) in a table of
    their own, beside the hops' (which a launch tally wraps); n as a
    64-bit integer, pointers and the stream as ``c_void_p``."""
    names = {f"qkx_cg_{s}_{f}" for s in ("pap", "r_update_norm", "xp_update")
             for f in ("f32", "f64")}
    assert set(_build.BLAS_ENTRY_POINTS) == names
    assert not names & set(_build.ENTRY_POINTS)
    assert not names & set(_build.CLOVER_ENTRY_POINTS)
    assert not names & set(_build.MOBIUS5_ENTRY_POINTS)
    for name, argtypes in _build.BLAS_ENTRY_POINTS.items():
        assert argtypes.count(ctypes.c_int64) == 1, name
        assert argtypes.count(ctypes.c_int) == 1, name
        assert argtypes[-1] is ctypes.c_void_p
    assert "blas_cg.cu" in {p.name for p in _build._sources()}


# ---- cg against the loop it replaced ----------------------------------

def _loop_cg(matvec, b, x0=None, tol=1e-10, maxiter=1000, allreduce=None,
             tol_hq=None):
    """``solvers.cg.cg`` as it was before the fused steps: separate
    eager updates and reductions in the field's precision."""
    red = (lambda v: v) if allreduce is None else allreduce
    if x0 is None:
        x, r = torch.zeros_like(b), b.clone()
    else:
        x, r = x0.clone(), b - matvec(x0)
    target = (tol * tol) * red(norm2(b))
    r2 = red(norm2(r))
    p = r.clone()
    k = 0

    def not_done(r2):
        if tol_hq is None:
            return bool(r2 > target)
        return bool((r2 > target)
                    | (heavy_quark_residual_sq(x, r) > tol_hq * tol_hq))

    while k < maxiter and not_done(r2):
        ap = matvec(p)
        alpha = r2 / red(reDotProduct(p, ap))
        axpy(alpha, p, x)
        axpy(-alpha, ap, r)
        r2_new = red(norm2(r))
        xpay(r, r2_new / r2, p)
        r2 = r2_new
        k += 1
    return x, k


def _hpd_matrix(n: int, dtype, seed: int) -> torch.Tensor:
    """A random hermitian positive-definite n×n matrix (its spectrum in
    ~[0.4, 4.4])."""
    gen = torch.Generator().manual_seed(seed)
    wide = torch.complex128 if dtype.is_complex else torch.float64
    a = torch.randn(n, n, generator=gen, dtype=wide) / n ** 0.5
    return (a @ a.mH + 0.4 * torch.eye(n, dtype=wide)).to(dtype)


def _hpd(n: int, dtype, seed: int):
    """``_hpd_matrix``'s matvec on the flattened field."""
    mat = _hpd_matrix(n, dtype, seed)
    return lambda v: (mat @ v.reshape(-1)).reshape(v.shape)


SHAPE_HQ = (4, 3, 2, 2, 3)         # canonical [4, 3, T, Z, W]


@pytest.mark.parametrize("dtype, case", [
    (d, c) for d in DTYPES for c in ("plain", "x0", "tol_hq", "allreduce")
    if d.is_complex or c != "tol_hq"])      # hq reads complex fields
def test_cg_matches_the_loop_it_replaced(dtype, case):
    shape = SHAPE_HQ
    n = int(np.prod(shape))
    matvec = _hpd(n, dtype, 11)
    b = _field(shape, dtype, 12)
    single = dtype in (torch.float32, torch.complex64)
    kw = dict(tol=1e-5 if single else 1e-11, maxiter=500)
    if case == "x0":
        kw["x0"] = 0.1 * _field(shape, dtype, 13)
    elif case == "tol_hq":
        kw["tol_hq"] = 1e-3 if single else 1e-9
    elif case == "allreduce":
        kw["allreduce"] = lambda v: v.clone()
    want_x, want_k = _loop_cg(matvec, b, **kw)
    got = cg(matvec, b, **kw)
    assert got.iters == want_k and 3 < want_k < 500
    assert _rel(got.x, want_x) < X_LIMIT[dtype]
    assert got.r2.dtype == b.real.dtype
    assert got.x.is_contiguous() and got.x.dtype == dtype


def test_cg_counts_its_fused_iterations_while_recording():
    matvec = _hpd(60, torch.complex64, 14)
    b = _field((60,), torch.complex64, 15)
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        res = cg(matvec, b, tol=1e-5)
    table = profiling.table()
    profiling.reset()
    assert res.iters > 3
    assert table["counters"]["krylov.fused_iters"] == res.iters
    assert table["counters"]["host_reads"] == res.iters + 1
    cg(matvec, b, tol=1e-5)
    assert profiling.table() == {"spans": {}, "counters": {}}


def test_cg_takes_a_strided_source():
    """A source that is not contiguous is copied into contiguous x, r, p
    (the kernels' layout) and solved as the contiguous one is."""
    matvec = _hpd(48, torch.float64, 16)
    wide = _field((6, 16), torch.float64, 17)
    b = wide[:, ::2]
    assert not b.is_contiguous()
    got = cg(matvec, b, tol=1e-10)
    want = cg(matvec, b.contiguous(), tol=1e-10)
    assert got.iters == want.iters
    assert torch.equal(got.x, want.x)


# ---- on the card --------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _steps(p, ap, x, r, alpha, beta):
    """The three steps on copies: (pap, x, p, r, |r|²)."""
    p, x, r = p.clone(), x.clone(), r.clone()
    pap = cg_pap(p, ap)
    r2 = cg_r_update_norm(r, ap, alpha)
    cg_xp_update(x, p, r, alpha, beta)
    return pap, x, p, r, r2


def _plain_steps(p, ap, x, r, alpha, beta):
    p, x, r = p.clone(), x.clone(), r.clone()
    pap = blas.cg_pap_plain(p, ap)
    r2 = blas.cg_r_update_norm_plain(r, ap, alpha)
    blas.cg_xp_update_plain(x, p, r, alpha, beta)
    return pap, x, p, r, r2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n, offset", [(4096, 0), (4099, 0), (4096, 1),
                                       (1, 0), (3_000_001, 3)])
def test_kernels_match_plain_on_the_card(dtype, n, offset):
    """Kernel against plain: 16-byte vectors with and without a scalar
    tail, a slice off the 16-byte grid (one value a step), a single
    value, a vector longer than one sweep of the grid."""
    _card()
    fields = []
    for seed in range(4):
        buf = _field((n + offset,), dtype, 20 + seed, "cuda")
        fields.append(buf[offset:])
    p, ap, x, r = fields
    alpha = torch.tensor(0.37, dtype=torch.float64, device="cuda")
    beta = torch.tensor(0.81, dtype=torch.float64, device="cuda")
    launches = (cg_pap.launches, cg_r_update_norm.launches,
                cg_xp_update.launches)
    got = _steps(p, ap, x, r, alpha, beta)
    assert (cg_pap.launches, cg_r_update_norm.launches,
            cg_xp_update.launches) == tuple(a + b for a, b in
                                            zip(launches, (2, 2, 1)))
    want = _plain_steps(p, ap, x, r, alpha, beta)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert _rel(g, w) < LIMIT[dtype], (dtype, n, offset)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_two_runs_give_the_same_bits(dtype):
    _card()
    p, ap, x, r = (_field((1_000_003,), dtype, s, "cuda") for s in range(4))
    alpha = torch.tensor(0.37, dtype=torch.float64, device="cuda")
    beta = torch.tensor(0.81, dtype=torch.float64, device="cuda")
    one = _steps(p, ap, x, r, alpha, beta)
    two = _steps(p, ap, x, r, alpha, beta)
    for a, b in zip(one, two):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["strided", "bf16", "mixed", "alias",
                                 "device"])
def test_kernels_refuse_on_the_card(bad):
    """A complex64 field that is not contiguous, a dtype the kernels do
    not take, fields of two dtypes, an update whose fields alias, a CPU
    field beside a CUDA one: each raises, nothing falls back."""
    _card()
    v = _field((64, 6), torch.complex64, 30, "cuda")
    w = _field((64, 6), torch.complex64, 31, "cuda")
    if bad == "strided":
        a, b = v.t(), w.t()
    elif bad == "bf16":
        a, b = (torch.view_as_real(t).to(torch.bfloat16) for t in (v, w))
    elif bad == "mixed":
        a, b = v, w.to(torch.complex128)
    elif bad == "alias":
        a, b = v, v
    else:
        a, b = v, w.cpu()
    launches = cg_r_update_norm.launches
    with pytest.raises((ValueError, TypeError)):
        cg_r_update_norm(a, b, 0.5)
    assert cg_r_update_norm.launches == launches
    if bad != "alias":
        with pytest.raises((ValueError, TypeError)):
            cg_pap(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cg_on_the_card_runs_the_kernels(dtype):
    """``cg`` on a CUDA field: 5 launches an iteration and 2 for the
    first |r|², the same iterations as on the CPU and x within the
    loop's limits of the CPU's answer."""
    _card()
    n = 2048
    mat = _hpd_matrix(n, dtype, 40)
    b = _field((n,), dtype, 41)
    tol = 1e-5 if dtype in (torch.float32, torch.complex64) else 1e-11
    cpu = cg(lambda v: mat @ v, b, tol=tol)
    mat = mat.cuda()
    before = (cg_pap.launches + cg_r_update_norm.launches
              + cg_xp_update.launches)
    card = cg(lambda v: mat @ v, b.cuda(), tol=tol)
    after = (cg_pap.launches + cg_r_update_norm.launches
             + cg_xp_update.launches)
    assert after - before == 5 * card.iters + 2
    assert abs(card.iters - cpu.iters) <= 1
    assert _rel(card.x.cpu(), cpu.x) < 10 * X_LIMIT[dtype] ** 0.5
