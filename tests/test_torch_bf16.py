"""The bf16 operand tier of the port (the JAX package's ``bf16=True`` /
``DiracParams.pallas_bf16``; kernels K1d and K2d): the bf16 channel
operands against the JAX package's (bit-exact), the plain bf16 hop
against the Pallas kernel in interpret mode (float32 arithmetic on the
same bf16 operands, 1e-5), the size of the bf16 rounding against the
float32 hop, ``as_sloppy``'s shared storage and the bf16 chain, the
wrapper's dtype rules and its dispatch to the bf16 entry points, and the
kernels on the card (``cuda``-marked; they skip without one).
Tolerances are normwise relative.
"""

import dataclasses
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
from quda_qkxtm_multigrid_tpu.ops.dslash_pallas import (
    _to_channels as j_to_channels)
from quda_qkxtm_multigrid_tpu.ops.dslash_pallas5 import (
    clover_channels as j_clover_channels, dslash_ch_pallas5,
    dslash_parity_pallas5, gauge_channels as j_gauge_channels)
from quda_qkxtm_multigrid_tpu.utils import rng as jrng

from quda_qkxtm_multigrid_tpu_torch import _build
from quda_qkxtm_multigrid_tpu_torch import lattice as tlat
from quda_qkxtm_multigrid_tpu_torch import convert
from quda_qkxtm_multigrid_tpu_torch.convert import (
    params_from_jax, spinor_to_numpy as N)
from quda_qkxtm_multigrid_tpu_torch.dirac import DiracParams, as_sloppy
from quda_qkxtm_multigrid_tpu_torch.ops import dslash_kernel as dk

# the tests run on the CPU; the converters default to the card
dirac_from_numpy = functools.partial(convert.dirac_from_numpy, device="cpu")
T = functools.partial(convert.spinor_from_numpy, device="cpu")

torch.set_num_threads(1)

BF16, F32 = torch.bfloat16, torch.float32
GJ = jlat.Geometry(4, 4, 4, 8)
GT = tlat.Geometry(4, 4, 4, 8)
GJ_I = jlat.Geometry(8, 4, 4, 4)     # the JAX Pallas tests' geometry
GT_I = tlat.Geometry(8, 4, 4, 4)
TMC = dict(kind="twisted-clover", kappa=0.115, mu=0.05, csw=1.0)
XC = -TMC["kappa"] ** 2
INTERP = 1e-5           # float32 arithmetic on identical bf16 operands
BF16_BAND = (1e-5, 2e-2)  # bf16 hop against float32 hop: bf16 is read


def rel(got, ref) -> float:
    got = N(got) if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.linalg.norm((got - ref).ravel())
                 / np.linalg.norm(ref.ravel()))


def _fields(geom, seed, dtype=jnp.complex128):
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    u = jrng.random_gauge(k1, geom, dtype=dtype)
    psi = np.asarray(jrng.random_spinor(k2, geom, dtype=dtype))
    x = np.asarray(jrng.random_spinor(k3, geom, dtype=dtype))
    ud = np.asarray(jdsl.double_gauge(u, geom))
    _, cinv = jcl.make_clover_pair(u, geom, jd.DiracParams(**TMC))
    return np.asarray(u), ud, psi, x, np.asarray(cinv)


@pytest.fixture(scope="module")
def flds():
    return _fields(GJ, 61)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy()


def _jbits(a) -> np.ndarray:
    return np.asarray(jax.lax.bitcast_convert_type(a, jnp.int16))


# ---- operands -----------------------------------------------------------

@pytest.mark.parametrize("parity", [0, 1])
def test_bf16_operands_bitexact(flds, parity):
    """bf16 gauge (recon-12 and full) and clover-inverse channels equal
    the JAX package's bit for bit (both round complex128 → float32 →
    bfloat16)."""
    _, ud, _, _, cinv = flds
    for recon12 in (True, False):
        got = dk.gauge_channels(T(ud), parity, recon12, BF16)
        assert got.dtype == BF16
        np.testing.assert_array_equal(
            _bits(got), _jbits(j_gauge_channels(ud, parity, recon12, True)))
    got = dk.clover_channels(T(cinv), parity, BF16)
    np.testing.assert_array_equal(
        _bits(got), _jbits(j_clover_channels(cinv, parity, True)))


def test_cast_channels_rounds_through_float32():
    """1 + 2⁻⁸ + 2⁻³⁰ is a tie in bf16 after float32 rounding (→ 1.0);
    rounded once from float64 it would go up to 1 + 2⁻⁷."""
    v = torch.tensor([1 + 2 ** -8 + 2 ** -30], dtype=torch.float64)
    assert float(dk.cast_channels(v, BF16)) == 1.0
    assert dk.cast_channels(v, None) is v


# ---- the plain bf16 hop against the Pallas kernel in interpret mode --------

@pytest.fixture(scope="module")
def flds_interp():
    return _fields(GJ_I, 62, jnp.complex64)


def test_reference_matches_pallas_interpret_bf16_clover(flds_interp):
    """The forward matpc's second hop with its second output (clover fwd
    + xpay + post_op clover), bf16 gauge and clover inverse, float32
    spinors: the form of the bf16 chain."""
    _, ud, psi, x, cinv = flds_interp
    g = j_gauge_channels(ud, 0, True, True)
    ci = j_clover_channels(cinv, 0, True)
    psi_ch, x_ch = j_to_channels(psi[1]), j_to_channels(x[0])
    kw = dict(recon12=True, clover="fwd", xpay_coef=XC, post_op=("clover",))
    ref = dslash_ch_pallas5(g, psi_ch, 0, GJ_I, interpret=True, bf16=True,
                            cinv_ch=ci, x_ch=x_ch, **kw)
    t = lambda a: T(np.asarray(a.astype(jnp.float32))).to(BF16)
    got = dk.dslash_ch_reference(t(g), T(np.asarray(psi_ch)), 0, GT_I,
                                 cinv_ch=t(ci), x_ch=T(np.asarray(x_ch)),
                                 **kw)
    for a, r in zip(got, ref):
        assert a.dtype == F32
        assert rel(a, r) <= INTERP


def test_reference_matches_pallas_interpret_bf16_psi(flds_interp):
    """The bf16-ψ hop of ``dslash_parity_pallas5(bf16=True)``, the form of
    ``Dirac.dslash`` in the bf16 tier, through the port's operator."""
    u, ud, psi, _, _ = flds_interp
    ref = dslash_parity_pallas5(ud, psi[0], 1, GJ_I, True, interpret=True,
                                recon12=True, bf16=True)
    d = dirac_from_numpy(u, DiracParams(**TMC, use_kernels=True,
                                        kernel_bf16=True), GT_I)
    got = d.dslash(T(psi[0]), 1, dagger=True)
    assert got.dtype == torch.complex64
    assert rel(got, ref) <= INTERP


@pytest.mark.parametrize("form", ["bare", "clover fwd + xpay + post"])
def test_bf16_hop_differs_from_f32_hop(flds, form):
    """The plain hop on bf16 operands against the float32 one: the
    difference is the operands' bf16 rounding (~2⁻⁹), so it lies in
    BF16_BAND, which shows the bf16 operands are what is read."""
    _, ud, psi, x, cinv = flds
    kw = {} if form == "bare" else dict(
        clover="fwd", xpay_coef=XC, post_op=("clover",),
        x_ch=dk.to_channels(T(x[0])).to(F32))
    v = dk.to_channels(T(psi[1])).to(F32)
    outs = []
    for op in (F32, BF16):
        extra = ({} if form == "bare"
                 else {"cinv_ch": dk.clover_channels(T(cinv), 0, op)})
        out = dk.dslash_ch_reference(dk.gauge_channels(T(ud), 0, True, op),
                                     v, 0, GT, recon12=True, **kw, **extra)
        outs.append(out if isinstance(out, tuple) else (out,))
    for a, b in zip(*outs):
        assert BF16_BAND[0] <= float((b - a).norm() / a.norm()) \
            <= BF16_BAND[1]


# ---- as_sloppy and the bf16 chain ------------------------------------------

@pytest.fixture(scope="module")
def tmc_dirac(flds):
    u = flds[0]
    return dirac_from_numpy(u, DiracParams(**TMC, use_kernels=True), GT)


def test_as_sloppy_shares_storage(tmc_dirac):
    d = tmc_dirac
    s = as_sloppy(d, kernel_bf16=True)
    assert s.params == dataclasses.replace(d.params, kernel_bf16=True)
    for name in ("u", "clover", "clover_inv", "u_doubled"):
        assert getattr(s, name).data_ptr() == getattr(d, name).data_ptr()
    ops = s._operands(F32)
    assert all(t.dtype == BF16 for t in ops["g"] + ops["ci"])
    assert s._operands(BF16) is ops          # one cache entry per tier


def test_bf16_chain_is_the_f32_chain_on_bf16_operands(tmc_dirac, flds):
    """The bf16 chain (matpc†matpc and both matpc halves) equals the
    float32 chain run on the bf16 operands widened to float32, bit for
    bit: the plain hop widens each operand and computes in float32."""
    d = tmc_dirac
    s = as_sloppy(d, kernel_bf16=True)
    wide = as_sloppy(d)
    wide._ch_cache[F32] = {k: [t.to(F32) for t in v]
                           for k, v in s._operands(F32).items()}
    v = dk.to_channels(T(flds[2][0])).to(F32)
    assert torch.equal(s._fused_matpc_dagm_ch(v), wide._fused_matpc_dagm_ch(v))
    for dagger in (False, True):
        assert torch.equal(s._fused_matpc_ch(v, dagger),
                           wide._fused_matpc_ch(v, dagger))
    ref = d._fused_matpc_ch(d._fused_matpc_ch(v, False), True)
    assert rel(s._fused_matpc_dagm_ch(v), N(ref)) <= BF16_BAND[1]


@pytest.mark.parametrize("dagger", [False, True])
def test_bf16_msrc_chain_is_the_single_source_chain(tmc_dirac, flds, dagger):
    """The bf16 multi-source matpc equals the single-source one source by
    source, bit for bit; its dagger half applies A⁻¹† from the channel
    operand as the single-source half does, so the operator keeps no
    clover matrices: its cache holds the operands of each dtype only."""
    s = as_sloppy(tmc_dirac, kernel_bf16=True)
    cols = torch.stack([dk.to_channels(T(f[0])) for f in flds[2:4]]).to(F32)
    got = s._fused_matpc_ch(cols, dagger, hop=dk.dslash_ch_msrc)
    ref = torch.stack([s._fused_matpc_ch(c, dagger) for c in cols])
    assert torch.equal(got, ref)
    assert list(s._ch_cache) == [BF16]
    assert set(s._ch_cache[BF16]) == {"g", "ci"}


def test_bf16_dirac_matpc_and_dslash_dtypes(tmc_dirac, flds):
    """matpc / matpc_dagm of a complex128 bf16-tier operator run on
    float32 channels and return complex64, as the JAX package's; so
    does the bf16-ψ ``dslash``."""
    s = as_sloppy(tmc_dirac, kernel_bf16=True)
    psi = T(flds[2][0])
    assert s.matpc(psi).dtype == torch.complex64
    assert s.matpc_dagm(psi).dtype == torch.complex64
    assert s.dslash(psi, 1).dtype == torch.complex64


def test_kernel_bf16_needs_kernels():
    with pytest.raises(ValueError, match="needs use_kernels"):
        DiracParams(**TMC, kernel_bf16=True)


def test_params_from_jax_carries_the_bf16_flag(flds):
    jp = jd.DiracParams(**TMC, use_pallas=True, pallas_bf16=True)
    p = params_from_jax(jp)
    assert (p.use_kernels, p.kernel_bf16, p.kind, p.kappa, p.mu, p.csw) == (
        True, True, "twisted-clover", 0.115, 0.05, 1.0)
    assert dirac_from_numpy(flds[0], jp, GT).params == p
    # a non-degenerate doublet's parameters cross; the degenerate
    # operator refuses them (the doublet is make_dirac_ndeg's)
    nd = params_from_jax(jd.DiracParams(kind="twisted-mass", mu=0.1,
                                        epsilon=0.05))
    assert nd.epsilon == 0.05
    with pytest.raises(ValueError, match="epsilon"):
        dirac_from_numpy(flds[0], nd, GT)


# ---- the wrapper: dtype rules and dispatch -------------------------------

def _ops(flds):
    _, ud, psi, x, cinv = flds
    return dict(g=dk.gauge_channels(T(ud), 0, True, BF16),
                g18=dk.gauge_channels(T(ud), 0, False, BF16),
                g32=dk.gauge_channels(T(ud), 0, True, F32),
                ci=dk.clover_channels(T(cinv), 0, BF16),
                ci32=dk.clover_channels(T(cinv), 0, F32),
                v=dk.to_channels(T(psi[1])).to(F32),
                x=dk.to_channels(T(x[0])).to(F32))


FORMS = {   # name: (operands, keyword arguments, kernel form)
    "f32": (("g32", "v"), dict(clover="fwd", cinv_ch="ci32"), "f32"),
    "g16 bare": (("g", "v"), {}, "f32_g16"),
    "g16 clover xpay post": (
        ("g", "v"), dict(clover="fwd", cinv_ch="ci", xpay_coef=XC, x_ch="x",
                         post_op=("clover",)), "f32_g16"),
    "g16 twist post twist": (
        ("g", "v"), dict(twist=(0.1, 0.9), post_op=("twist", 0.1, 0.9)),
        "f32_g16"),
    "g16s16 bare": (("g", "v16"), {}, "f32_g16s16"),
    # the compact channel operator: bf16 gauge with a float32 A⁻¹ (K1d)
    # and the bf16 spinor storage (K1e)
    "g16c32 clover": (("g", "v"), dict(clover="fwd", cinv_ch="ci32"),
                      "f32_g16c32"),
    "g16s16 twist": (("g", "v16"), dict(twist=(0.1, 0.9)), "f32_g16c32_s16"),
    "g16s16 xpay": (("g", "v16"), dict(xpay_coef=XC, x_ch="x"),
                    "f32_g16c32_s16"),
}


def _resolve(o, operands, kw):
    o = dict(o, v16=o["v"].to(BF16), x16=o["x"].to(BF16))
    return ([o[n] for n in operands],
            {k: (o[v] if k in ("cinv_ch", "x_ch") else v)
             for k, v in kw.items()})


@pytest.mark.parametrize("name", list(FORMS))
def test_dtype_forms_pick_the_entry_point(flds, name):
    """The operand dtypes name the entry point, and ``_launch`` calls
    exactly that one: a bf16 operand never reaches qkx_dslash_ch_f32.
    The CPU path (the plain version) counts no launch."""
    operands, kw, form = FORMS[name]
    (g, v), kw = _resolve(_ops(flds), operands, kw)
    assert dk._check_operands(g, v, GT, True, kw.get("twist"),
                              kw.get("xpay_coef"), kw.get("x_ch"),
                              kw.get("clover"), kw.get("cinv_ch"),
                              kw.get("post_op")) == form
    called = []
    lib = types.SimpleNamespace(**{
        n: (lambda *a, n=n: called.append(n) or 0)
        for n in _build.ENTRY_POINTS})
    out = torch.empty(v.shape, dtype=F32)
    assert dk._launch(lib, form, g, v, out, None, 0, GT, False, True,
                      kw.get("twist"), kw.get("xpay_coef"), kw.get("x_ch"),
                      kw.get("clover"), kw.get("cinv_ch"), kw.get("post_op"),
                      0) == 0
    assert called == [f"qkx_dslash_ch_{form}"]
    before = (dk.dslash_ch.launches, dk.dslash_ch.launches_bf16)
    res = dk.dslash_ch(g, v, 0, GT, recon12=True, **kw)
    res = res if isinstance(res, tuple) else (res,)
    assert all(r.dtype == F32 for r in res)
    assert (dk.dslash_ch.launches, dk.dslash_ch.launches_bf16) == before


BAD16 = {   # operand mixes the bf16 tier does not take
    "bf16 gauge, float64 psi": (("g", "v"), dict(v=torch.float64)),
    # the float32-A⁻¹ and bf16-ψ instances with epilogues are built for
    # recon-12 only
    "bf16 gauge, float32 clover": (("g18", "v"),
                                   dict(clover="fwd", cinv_ch="ci32",
                                        recon12=False)),
    "float32 gauge, bf16 clover": (("g32", "v"),
                                   dict(clover="fwd", cinv_ch="ci")),
    "bf16 x": (("g", "v"), dict(clover="fwd", cinv_ch="ci", xpay_coef=XC,
                                x_ch="x16")),
    "bf16 psi, float32 gauge": (("g32", "v16"), {}),
    "bf16 psi with clover": (("g", "v16"), dict(clover="fwd", cinv_ch="ci")),
    "bf16 psi with twist": (("g18", "v16"), dict(twist=(0.1, 0.9),
                                                 recon12=False)),
    "bf16 psi with xpay": (("g", "v16"), dict(xpay_coef=XC, x_ch="x16")),
}


@pytest.mark.parametrize("name", list(BAD16))
def test_bf16_rejects(flds, name):
    operands, kw = BAD16[name]
    kw = dict(kw)
    cast = kw.pop("v", None)
    (g, v), kw = _resolve(_ops(flds), operands, kw)
    if cast is not None:
        v = v.to(cast)
    with pytest.raises(TypeError):
        dk.dslash_ch(g, v, 0, GT, **{"recon12": True, **kw})


def test_msrc_forms(flds):
    """The multi-source wrapper takes bf16 gauge and clover inverse with
    float32 spinors (K2d) and refuses a bf16 batch."""
    o = _ops(flds)
    psi_b = torch.stack([o["v"], 2 * o["v"]])
    assert dk._check_msrc_operands(o["g"], psi_b, GT, True, None, None,
                                   None, "fwd", o["ci"]) == "f32_g16"
    out = dk.dslash_ch_msrc(o["g"], psi_b, 0, GT, recon12=True,
                            clover="fwd", cinv_ch=o["ci"])
    single = dk.dslash_ch(o["g"], o["v"], 0, GT, recon12=True, clover="fwd",
                          cinv_ch=o["ci"])
    assert torch.equal(out[0], single) and out.dtype == F32
    with pytest.raises(TypeError):
        dk.dslash_ch_msrc(o["g"], psi_b.to(BF16), 0, GT, recon12=True)


# ---- the kernels on the card -------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_bf16_kernels_match_reference_on_card():
    """K1d in every form of the bf16 chain and the bf16-ψ form, and K2d
    for n = 1 and 3, against their plain versions (1e-5) and K2d against
    n K1d launches (1e-6), at 8⁴; each launch counted as bf16."""
    dev = _card()
    geom_j, geom = jlat.Geometry(8, 8, 8, 8), tlat.Geometry(8, 8, 8, 8)
    _, ud, psi, x, cinv = _fields(geom_j, 63)
    g = [dk.gauge_channels(T(ud, device=dev), p, True, BF16) for p in (0, 1)]
    ci = [dk.clover_channels(T(cinv, device=dev), p, BF16) for p in (0, 1)]
    v = [dk.to_channels(T(psi[p], device=dev)).to(F32) for p in (0, 1)]
    xs = [dk.to_channels(T(x[p], device=dev)).to(F32) for p in (0, 1)]
    forms = [dict(parity=1, clover="fwd"),
             dict(parity=0, clover="fwd", xpay=True, post_op=("clover",)),
             dict(parity=1, dagger=True, clover="dag"),
             dict(parity=0, dagger=True, xpay=True)]
    for f in forms:
        p = f["parity"]
        kw = dict(dagger=f.get("dagger", False), recon12=True,
                  clover=f.get("clover"), post_op=f.get("post_op"))
        if "clover" in f:
            kw["cinv_ch"] = ci[p]
        if f.get("xpay"):
            kw.update(xpay_coef=XC, x_ch=xs[p])
        before = dk.dslash_ch.launches_bf16
        got = dk.dslash_ch(g[p], v[1 - p], p, geom, **kw)
        assert dk.dslash_ch.launches_bf16 == before + 1
        ref = dk.dslash_ch_reference(g[p], v[1 - p], p, geom, **kw)
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        for a, b in zip(got, ref):
            assert float((a - b).norm() / b.norm()) <= INTERP
        if "post_op" in kw:
            continue
        kw_b = {k: w for k, w in kw.items() if k not in ("post_op", "x_ch")}
        for n in (1, 3):
            psi_b = torch.stack([v[1 - p]] * n) * torch.arange(
                1, n + 1, device=dev, dtype=F32).reshape(n, 1, 1, 1, 1)
            x_b = torch.stack([xs[p]] * n) if f.get("xpay") else None
            before = dk.dslash_ch_msrc.launches_bf16
            out = dk.dslash_ch_msrc(g[p], psi_b, p, geom, x_ch=x_b, **kw_b)
            assert dk.dslash_ch_msrc.launches_bf16 == before + 1
            ref = dk.dslash_ch_msrc_reference(g[p], psi_b, p, geom,
                                              x_ch=x_b, **kw_b)
            assert float((out - ref).norm() / ref.norm()) <= INTERP
            singles = torch.stack([dk.dslash_ch(
                g[p], psi_b[i], p, geom,
                x_ch=None if x_b is None else x_b[i], **kw_b)
                for i in range(n)])
            assert float((out - singles).norm() / singles.norm()) <= 1e-6
    v16 = v[0].to(BF16)
    got = dk.dslash_ch(g[1], v16, 1, geom, recon12=True)
    ref = dk.dslash_ch_reference(g[1], v16, 1, geom, recon12=True)
    assert got.dtype == F32
    assert float((got - ref).norm() / ref.norm()) <= INTERP
