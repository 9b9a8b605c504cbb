"""The recon-8 gauge of the port (the JAX package's ``recon8=True``;
kernel K3): the 8-real encoding against the JAX package's
``gauge_channels(recon8=True)`` (plain ``jnp``) in float32, the plain
decode against the links, the plain recon-8 hop against the plain
recon-12 hop in every epilogue form (≤ 1e-5 normwise, the JAX package's
bound in ``tests/test_pallas.py``), the wrapper's dtype and shape rules
and its dispatch to the K3 entry point, and the kernel on the card
(``cuda``-marked; it skips without one).
"""

import functools
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from quda_qkxtm_multigrid_tpu import dirac as jd
from quda_qkxtm_multigrid_tpu import lattice as jlat
from quda_qkxtm_multigrid_tpu.ops import clover as jcl
from quda_qkxtm_multigrid_tpu.ops import dslash as jdsl
from quda_qkxtm_multigrid_tpu.ops.dslash_pallas5 import (
    gauge_channels as j_gauge_channels)
from quda_qkxtm_multigrid_tpu.utils import rng as jrng

from quda_qkxtm_multigrid_tpu_torch import _build, convert
from quda_qkxtm_multigrid_tpu_torch import lattice as tlat
from quda_qkxtm_multigrid_tpu_torch.ops import dslash_kernel as dk

T = functools.partial(convert.spinor_from_numpy, device="cpu")

torch.set_num_threads(1)

BF16, F32, F64 = torch.bfloat16, torch.float32, torch.float64
GJ = jlat.Geometry(4, 4, 4, 8)
GT = tlat.Geometry(4, 4, 4, 8)
TMC = dict(kind="twisted-clover", kappa=0.115, mu=0.05, csw=1.0)
XC = -TMC["kappa"] ** 2
RECON8_TOL = 1e-5


def _fields(geom, seed):
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    u = jrng.random_gauge(k1, geom, dtype=jnp.complex128)
    psi = np.asarray(jrng.random_spinor(k2, geom, dtype=jnp.complex128))
    x = np.asarray(jrng.random_spinor(k3, geom, dtype=jnp.complex128))
    ud = np.asarray(jdsl.double_gauge(u, geom))
    _, cinv = jcl.make_clover_pair(u, geom, jd.DiracParams(**TMC))
    return ud, psi, x, np.asarray(cinv)


@pytest.fixture(scope="module")
def flds():
    return _fields(GJ, 101)


def rel(a, b) -> float:
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("parity", [0, 1])
def test_encoding_matches_jax(flds, parity):
    """[T, 64, Z, W] in float32: the six link entries equal JAX's bit for
    bit; the two phases (``angle`` in float64, then float32) within one
    float32 ulp."""
    ud = flds[0]
    got = dk.gauge_channels(T(ud), parity, False, F32, recon8=True)
    ref = np.asarray(j_gauge_channels(ud, parity, False, False, recon8=True))
    assert got.dtype == F32 and got.shape == ref.shape == (
        GT.T, 64, GT.Z, GT.W)
    g = got.numpy().reshape(GT.T, 8, 8, GT.Z, GT.W)
    r = ref.reshape(GT.T, 8, 8, GT.Z, GT.W)
    np.testing.assert_array_equal(g[:, :, :6], r[:, :, :6])
    np.testing.assert_allclose(g[:, :, 6:], r[:, :, 6:], rtol=2 ** -23,
                               atol=2 ** -23)


def test_decode_rebuilds_the_links(flds):
    """The plain decode of the float64 encoding gives back the SU(3)
    links to float64 rounding; of the float32 one to float32 rounding."""
    ud = T(flds[0])
    for p in (0, 1):
        links = ud[:, p]
        for dt, tol in ((F64, 1e-13), (F32, 1e-6)):
            enc = dk.gauge_channels(ud, p, False, dt, recon8=True)
            assert rel(dk._links(enc, False, recon8=True),
                       links.to(torch.complex128 if dt == F64
                                else torch.complex64)) <= tol


CASES = {   # name: (parity, keyword arguments)
    "bare": (0, {}),
    "bare dagger": (1, dict(dagger=True)),
    "twist + xpay + post twist": (0, dict(twist=(-0.023, 0.9995),
                                          xpay_coef=XC, x_ch="x",
                                          post_op=("twist", 0.023, 0.9995))),
    "clover fwd + xpay + post clover": (1, dict(clover="fwd", cinv_ch="ci",
                                                xpay_coef=XC, x_ch="x",
                                                post_op=("clover",))),
    "dagger clover dag": (0, dict(dagger=True, clover="dag", cinv_ch="ci")),
}


def _kw(flds, p, kw):
    _, _, x, cinv = flds
    o = dict(x=dk.to_channels(T(x[p])).to(F32),
             ci=dk.clover_channels(T(cinv), p, F32))
    return {k: (o[w] if k in ("x_ch", "cinv_ch") else w)
            for k, w in kw.items()}


@pytest.mark.parametrize("name", list(CASES))
def test_recon8_hop_matches_recon12(flds, name):
    """The plain recon-8 hop against the plain recon-12 hop, float32,
    every epilogue form (both outputs with ``post_op``)."""
    ud, psi, _, _ = flds
    p, kw = CASES[name]
    kw = _kw(flds, p, kw)
    v = dk.to_channels(T(psi[1 - p])).to(F32)
    g8 = dk.gauge_channels(T(ud), p, False, F32, recon8=True)
    g12 = dk.gauge_channels(T(ud), p, True, F32)
    got = dk.dslash_ch(g8, v, p, GT, recon8=True, **kw)
    ref = dk.dslash_ch(g12, v, p, GT, recon12=True, **kw)
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for a, b in zip(got, ref):
        assert a.dtype == F32 and rel(a, b) <= RECON8_TOL


def test_recon8_form_and_dispatch(flds):
    """recon-8 takes float32 operands only and names ``qkx_dslash_ch_
    f32_r8``; the CPU path counts no launch."""
    ud, psi, _, _ = flds
    g8 = dk.gauge_channels(T(ud), 0, False, F32, recon8=True)
    v = dk.to_channels(T(psi[1])).to(F32)
    assert dk._check_operands(g8, v, GT, False, None, None, None, None,
                              None, None, recon8=True) == "f32_r8"
    called = []
    lib = types.SimpleNamespace(**{
        n: (lambda *a, n=n: called.append(n) or 0)
        for n in _build.ENTRY_POINTS})
    out = torch.empty_like(v)
    assert dk._launch(lib, "f32_r8", g8, v, out, None, 0, GT, False, False,
                      None, None, None, None, None, None, 0) == 0
    assert called == ["qkx_dslash_ch_f32_r8"]
    before = dk.dslash_ch.launches_r8
    dk.dslash_ch(g8, v, 0, GT, recon8=True)
    assert dk.dslash_ch.launches_r8 == before


def test_recon8_refusals(flds):
    ud, psi, _, _ = flds
    g8 = dk.gauge_channels(T(ud), 0, False, F32, recon8=True)
    v = dk.to_channels(T(psi[1])).to(F32)
    with pytest.raises(TypeError, match="recon-8"):
        dk.dslash_ch(g8.to(BF16), v, 0, GT, recon8=True)
    with pytest.raises(TypeError, match="recon-8"):
        dk.dslash_ch(g8.to(F64), v.to(F64), 0, GT, recon8=True)
    with pytest.raises(TypeError, match="recon-8"):
        dk.dslash_ch(g8, v, 0, GT, recon8=True, out_dtype=BF16)
    with pytest.raises(ValueError, match="pick one"):
        dk.dslash_ch(g8, v, 0, GT, recon8=True, recon12=True)
    with pytest.raises(ValueError, match="g_ch shape"):
        dk.dslash_ch(dk.gauge_channels(T(ud), 0, True, F32), v, 0, GT,
                     recon8=True)


@pytest.mark.cuda
def test_recon8_kernel_matches_reference_on_card():
    """K3 against its plain version and against K1 recon-12 at 8⁴, every
    epilogue form, each launch counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    dev = torch.device("cuda")
    fl = _fields(jlat.Geometry(8, 8, 8, 8), 102)
    geom = tlat.Geometry(8, 8, 8, 8)
    ud, psi, x, cinv = fl
    for name, (p, kw) in CASES.items():
        o = dict(x=dk.to_channels(T(x[p], device=dev)).to(F32),
                 ci=dk.clover_channels(T(cinv, device=dev), p, F32))
        kw = {k: (o[w] if k in ("x_ch", "cinv_ch") else w)
              for k, w in kw.items()}
        v = dk.to_channels(T(psi[1 - p], device=dev)).to(F32)
        g8 = dk.gauge_channels(T(ud, device=dev), p, False, F32, recon8=True)
        g12 = dk.gauge_channels(T(ud, device=dev), p, True, F32)
        before = dk.dslash_ch.launches_r8
        got = dk.dslash_ch(g8, v, p, geom, recon8=True, **kw)
        assert dk.dslash_ch.launches_r8 == before + 1, name
        ref = dk.dslash_ch_reference(g8, v, p, geom, recon8=True, **kw)
        r12 = dk.dslash_ch(g12, v, p, geom, recon12=True, **kw)
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        r12 = r12 if isinstance(r12, tuple) else (r12,)
        for a, b, c in zip(got, ref, r12):
            assert rel(a, b) <= RECON8_TOL and rel(a, c) <= RECON8_TOL
