"""The Möbius fifth-dimension passes (M5: ``ops.domain_wall.mobius5_plain``
and its kernel ``mobius5_ch``, ``csrc/mobius5_ch.cu``) on channels at
4³×8, Ls 8 and 24, with 48I's b5, c5 and m5.

Each matrix of ``mobius5_matrices`` applied by the plain version equals
the composition of the existing site-local functions it stands for
(``mdw_dslash4_pre``, ``mdw_dslash5``, ``mdw_dslash5_inv``): ≤ 1e-13 with
the float64 matrices on float64 channels (the same products, summed in
another order), ≤ 1e-6 with float32 matrices on float32 channels against
the float64 composition (float32 storage of the matrices and the field,
Ls float32 products summed).  The wrapper refuses what the kernel does
not take, a CPU tensor too; the operator runs the plain version on the
CPU even on the kernel route, and launches nothing there.  The ``cuda``
tests hold the kernel to the plain version on the card and the operator
to its one choice there (a complex128 operator on the kernel route
raises, it does not fall back), and skip themselves without one.  No
JAX here: the card's tests run in files without it.
"""

import ctypes

import numpy as np
import pytest
import torch

from quda_qkxtm_multigrid_tpu_torch import _build
from quda_qkxtm_multigrid_tpu_torch.ops import domain_wall as dw

M5, MFERM, B5, C5 = -1.8, 0.00078, 1.5, 0.5     # 48I (QUDA's m5 sign)
SHAPE = (8, 24, 4, 8)                             # T, 24, Z, W of 4³×8
FORMS = ["pre", "d5", "inv", "pre_inv", "inv_k2", "pre_dag", "d5_dag",
         "inv_k2_dag", "inv_pre_dag", "kb_pre_dag"]


def _field(ls: int, seed: int, dtype=torch.float64) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((ls,) + SHAPE, generator=gen,
                       dtype=torch.float64).to(dtype)


def _composition(name: str, v: torch.Tensor, ls: int) -> torch.Tensor:
    """The pass ``name`` through the existing site-local functions."""
    kb, _, k5 = dw.mdw_kappas(B5, C5, M5, ls)
    k2 = float(-kb[0] ** 2)
    pre = lambda a, d=False: dw.mdw_dslash4_pre(a, B5, C5, MFERM, d)  # noqa
    inv = lambda a, d=False: dw.mdw_dslash5_inv(a, k5, MFERM, d)      # noqa
    return {"pre": lambda: pre(v),
            "d5": lambda: dw.mdw_dslash5(v, k5, MFERM),
            "inv": lambda: inv(v),
            "pre_inv": lambda: pre(inv(v)),
            "inv_k2": lambda: k2 * inv(v),
            "pre_dag": lambda: pre(v, True),
            "d5_dag": lambda: dw.mdw_dslash5(v, k5, MFERM, True),
            "inv_k2_dag": lambda: inv(k2 * v, True),
            "inv_pre_dag": lambda: inv(pre(v, True), True),
            "kb_pre_dag": lambda: -float(kb[0]) * pre(v, True)}[name]()


def _rel(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


def _mats(ls: int, dtype) -> dict:
    return {k: torch.tensor(m, dtype=dtype) for k, m in
            dw.mobius5_matrices(ls, M5, MFERM, B5, C5).items()}


@pytest.mark.parametrize("ls", [8, 24])
@pytest.mark.parametrize("form", FORMS)
def test_plain_pass_is_the_composition(form, ls):
    v = _field(ls, 1)
    want = _composition(form, v, ls)
    got64 = dw.mobius5_plain(_mats(ls, torch.float64)[form], v)
    assert got64.dtype == torch.float64
    assert _rel(got64, want) < 1e-13
    got32 = dw.mobius5_plain(_mats(ls, torch.float32)[form],
                             v.to(torch.float32))
    assert got32.dtype == torch.float32
    assert _rel(got32, want) < 1e-6


@pytest.mark.parametrize("ls", [8, 24])
def test_plain_xpay(ls):
    v, x = _field(ls, 2), _field(ls, 3)
    mat = _mats(ls, torch.float64)["inv_k2"]
    got = dw.mobius5_plain(mat, v, x, -0.37)
    assert _rel(got, dw.mobius5_plain(mat, v) - 0.37 * x) < 1e-15


def test_matrices_are_real_float64_inverses():
    m = dw.mobius5_matrices(24, M5, MFERM, B5, C5)
    assert all(a.shape == (2, 24, 24) and a.dtype == np.float64
               for a in m.values())
    eye = np.broadcast_to(np.eye(24), (2, 24, 24))
    assert np.abs(m["d5"] @ m["inv"] - eye).max() < 1e-13
    assert np.array_equal(m["pre_dag"], np.swapaxes(m["pre"], 1, 2))
    # the chiral halves of the per-spin D̃5 of mdw_dslash5_inv
    _, _, k5 = dw.mdw_kappas(B5, C5, M5, 24)
    spin = dw._d5_matrices(24, k5, MFERM).real
    assert np.abs(m["d5"][0] - spin[0]).max() < 1e-15
    assert np.abs(m["d5"][1] - spin[2]).max() < 1e-15


def _gauge(dtype=torch.complex64) -> torch.Tensor:
    from portbench.gauge import make_gauge
    return make_gauge((4, 4, 4, 8), 2**33 + 21, "cpu",
                      "antiperiodic").to(dtype)


def test_operator_on_the_cpu_runs_the_plain_version():
    """``MobiusDirac._m5`` is the one choice between kernel and plain:
    on the kernel route a CPU field runs the plain passes, launches
    nothing, and gives what the operator off the route gives."""
    from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry
    geom, u = Geometry(4, 4, 4, 8), _gauge()
    on, off = (dw.MobiusDirac(u, geom, 8, M5, MFERM, B5, C5, use_kernels=k)
               for k in (True, False))
    v = _field(8, 4, torch.float32)
    launches = dw.mobius5_ch.launches
    for dag in (False, True):
        assert torch.equal(on.matpc_ch(v, dag), off.matpc_ch(v, dag))
    assert dw.mobius5_ch.launches == launches


@pytest.mark.parametrize("bad", ["shape", "matrix", "dtype", "x", "cpu"])
def test_wrapper_refuses(bad):
    v = _field(8, 5, torch.float32)
    mat = _mats(8, torch.float32)["pre"]
    x = None
    if bad == "shape":
        v = v[:, :, :12]
    elif bad == "matrix":
        mat = mat[:, :4, :4]
    elif bad == "dtype":
        mat = mat.double()
    elif bad == "x":
        x = v[:4]
    with pytest.raises(ValueError):
        dw.mobius5_ch(mat, v, x, 1.0)


def test_entry_point_table():
    """M5's entry point in a table of its own, beside the hops' (which a
    launch tally wraps) and the clover kernel's, its pointers and stream
    as ``c_void_p``."""
    assert set(_build.MOBIUS5_ENTRY_POINTS) == {"qkx_mobius5_ch_f32"}
    assert not set(_build.MOBIUS5_ENTRY_POINTS) & set(_build.ENTRY_POINTS)
    argtypes = _build.MOBIUS5_ENTRY_POINTS["qkx_mobius5_ch_f32"]
    assert argtypes[:4] == [ctypes.c_void_p] * 4
    assert ctypes.c_void_p not in argtypes[4:-1]
    assert argtypes[-1] is ctypes.c_void_p
    assert "mobius5_ch.cu" in {p.name for p in _build._sources()}


@pytest.mark.cuda
def test_kernel_matches_plain_on_the_card():
    """Every form, with and without x, at Ls 8, 24 and 32 (the kernel's
    LS instances 8, 24, 32), and the one-value-a-thread instance (a field
    off the 16-byte grid): ≤ 1e-6 relative, since both sum the same Ls
    float32 products in another order."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for ls in (8, 24, 32):
        v = _field(ls, 6, torch.float32).cuda()
        x = _field(ls, 7, torch.float32).cuda()
        buf = torch.empty(v.numel() + 1, device="cuda")
        off = buf[1:].view(v.shape)
        off.copy_(v)
        mats = {k: m.cuda() for k, m in _mats(ls, torch.float32).items()}
        for name, mat in mats.items():
            for src in (v, off):
                for xx, a in ((None, 0.0), (x, 1.0)):
                    n = dw.mobius5_ch.launches
                    got = dw.mobius5_ch(mat, src, xx, a)
                    assert dw.mobius5_ch.launches == n + 1
                    want = dw.mobius5_plain(mat, src, xx, a)
                    assert _rel(got, want) < 1e-6, (ls, name, a)


@pytest.mark.cuda
def test_operator_on_the_card_takes_no_other_dtype():
    """On the card the kernel route runs M5 through the kernel or not at
    all: a complex128 operator with ``use_kernels`` raises at its first
    pass (the kernel is float32 only), and the same operator off the
    route runs the plain passes."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry
    geom, u = Geometry(4, 4, 4, 8), _gauge(torch.complex128).cuda()
    v = _field(8, 8).cuda()
    with pytest.raises(TypeError):
        dw.MobiusDirac(u, geom, 8, M5, MFERM, B5, C5).matpc_ch(v)
    launches = dw.mobius5_ch.launches
    off = dw.MobiusDirac(u, geom, 8, M5, MFERM, B5, C5, use_kernels=False)
    assert off.matpc_ch(v).dtype == torch.float64
    assert dw.mobius5_ch.launches == launches
