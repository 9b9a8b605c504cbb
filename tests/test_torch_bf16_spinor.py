"""The bf16 spinor storage of the port (the JAX package's
``out_dtype=jnp.bfloat16``; kernel K1e): the plain hop with a bf16 output
against the Pallas kernel in interpret mode on identical operands, the
dtypes of every hop that the compact chains make (each must have an
entry point, so the card cannot meet a form the CPU never saw), the
wrapper's refusals, the plain A⁻¹† and twist on a bf16 spinor against
the JAX package's, and the kernel on the card (``cuda``-marked; it skips
without one).

Tolerances: a bf16 output lies within one bf16 ulp of the reference in
every element, except where the float32 sums (taken in another order)
cancel below an ulp: there within 2⁻²⁰ of the output's largest value;
and 1e-4 normwise.  float32 outputs on identical operands: 1e-5 (1e-6
for the plain 6×6 products).  The JAX package's bf16 twist may round
once per fused operation where torch rounds per operation, so that path
compares at bf16 tolerance (2⁻⁸).
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
from quda_qkxtm_multigrid_tpu.ops.dslash_pallas import (
    _to_channels as j_to_channels)
from quda_qkxtm_multigrid_tpu.ops.dslash_pallas5 import (
    clover_channels as j_clover_channels, dslash_ch_pallas5,
    gauge_channels as j_gauge_channels)
from quda_qkxtm_multigrid_tpu.utils import rng as jrng

from quda_qkxtm_multigrid_tpu_torch import _build, compact
from quda_qkxtm_multigrid_tpu_torch import convert
from quda_qkxtm_multigrid_tpu_torch import lattice as tlat
from quda_qkxtm_multigrid_tpu_torch.dirac import (
    DiracParams, _ch_clover_apply, _ch_twist)
from quda_qkxtm_multigrid_tpu_torch.ops import dslash_kernel as dk

T = functools.partial(convert.spinor_from_numpy, device="cpu")

torch.set_num_threads(1)

BF16, F32, F64 = torch.bfloat16, torch.float32, torch.float64
GJ = jlat.Geometry(4, 4, 4, 8)
GT = tlat.Geometry(4, 4, 4, 8)
GJ_I = jlat.Geometry(8, 4, 4, 4)     # the JAX Pallas tests' geometry
GT_I = tlat.Geometry(8, 4, 4, 4)
TMC = dict(kind="twisted-clover", kappa=0.115, mu=0.05, csw=1.0)
TM = dict(kind="twisted-mass", kappa=0.115, mu=0.05)
XC = -TMC["kappa"] ** 2
BF16_NORM, F32_SUM_BOUND = 1e-4, 2.0 ** -20

K1E_FORMS = {"f32_g16c32_o16", "f32_g16c32_s16o16", "f32_g16c32_x16",
             "f32_g16c32_s16"}


def assert_bf16_close(got: torch.Tensor, ref: torch.Tensor):
    """The bf16 criterion of the module docstring."""
    assert got.dtype == ref.dtype == BF16
    g, r = got.float(), ref.float()
    d = (g - r).abs()
    _, e = torch.frexp(torch.maximum(g.abs(), r.abs()))
    ulp = torch.ldexp(torch.ones_like(g), e - 8)
    assert not bool(((d > ulp) & (d > F32_SUM_BOUND * float(r.abs().max())))
                    .any())
    assert float((g - r).norm() / r.norm()) <= BF16_NORM


def _fields(geom, seed):
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    u = jrng.random_gauge(k1, geom, dtype=jnp.complex128)
    psi = np.asarray(jrng.random_spinor(k2, geom, dtype=jnp.complex128))
    x = np.asarray(jrng.random_spinor(k3, geom, dtype=jnp.complex128))
    ud = np.asarray(jdsl.double_gauge(u, geom))
    _, cinv = jcl.make_clover_pair(u, geom, jd.DiracParams(**TMC))
    return np.asarray(u), ud, psi, x, np.asarray(cinv)


@pytest.fixture(scope="module")
def flds():
    return _fields(GJ, 91)


# ---- the plain bf16-output hop against the Pallas kernel in interpret mode ---

def test_reference_matches_pallas_interpret_bf16_spinor():
    """The second hop of the compact bf16-storage chain: bf16 ψ, bf16
    gauge, float32 A⁻¹ (clover fwd), float32 x (xpay) and a bf16 output,
    against ``dslash_ch_pallas5(bf16=True, out_dtype=jnp.bfloat16)``."""
    _, ud, psi, x, cinv = _fields(GJ_I, 92)
    g = j_gauge_channels(ud, 0, True, True)
    ci = j_clover_channels(cinv, 0, False)
    psi16 = j_to_channels(psi[1]).astype(jnp.bfloat16)
    x_ch = j_to_channels(x[0])
    ref = dslash_ch_pallas5(g, psi16, 0, GJ_I, interpret=True, recon12=True,
                            bf16=True, clover="fwd", cinv_ch=ci,
                            xpay_coef=XC, x_ch=x_ch,
                            out_dtype=jnp.bfloat16)
    b16 = lambda a: T(np.asarray(a.astype(jnp.float32))).to(BF16)
    got = dk.dslash_ch_reference(b16(g), b16(psi16), 0, GT_I, recon12=True,
                                 clover="fwd", cinv_ch=T(np.asarray(ci)),
                                 xpay_coef=XC, x_ch=T(np.asarray(x_ch)),
                                 out_dtype=BF16)
    assert_bf16_close(got, b16(ref))


@pytest.mark.parametrize("post", [None, ("twist", 0.1, 0.9)])
def test_bf16_output_is_the_float32_output_rounded_once(flds, post):
    """The plain hop with ``out_dtype=bf16`` is the float32 hop rounded
    once, output and second output alike."""
    _, ud, psi, x, _ = flds
    g = dk.gauge_channels(T(ud), 1, True, BF16)
    v = dk.to_channels(T(psi[0])).to(F32)
    kw = dict(recon12=True, twist=(-0.1, 0.9), xpay_coef=XC,
              x_ch=dk.to_channels(T(x[1])).to(F32), post_op=post)
    got = dk.dslash_ch_reference(g, v, 1, GT, out_dtype=BF16, **kw)
    ref = dk.dslash_ch_reference(g, v, 1, GT, **kw)
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for a, r in zip(got, ref):
        assert a.dtype == BF16 and torch.equal(a, r.to(BF16))


# ---- the forms of the compact chains ----------------------------------------

@pytest.fixture(scope="module")
def recorded(flds, monkeypatch_module):
    """Every hop of the compact chains, tmc and twisted mass, in each
    tier and storage, as the entry point its operand dtypes select."""
    u, _, psi, x, _ = flds
    seen = {}
    real = compact.dslash_ch

    def spy(g_ch, psi_ch, parity, geom, **kw):
        form = dk._check_operands(
            g_ch, psi_ch, geom, kw.get("recon12", False), kw.get("twist"),
            kw.get("xpay_coef"), kw.get("x_ch"), kw.get("clover"),
            kw.get("cinv_ch"), kw.get("post_op"), kw.get("out_dtype"),
            kw.get("recon8", False))
        seen.setdefault(f"qkx_dslash_ch_{form}", set()).add(
            (g_ch.dtype, psi_ch.dtype, kw.get("out_dtype")))
        return real(g_ch, psi_ch, parity, geom, **kw)

    monkeypatch_module.setattr(compact, "dslash_ch", spy)
    for prm in (TMC, TM):
        for dt in (BF16, F32, F64):
            cd = compact.make_compact(T(u), DiracParams(**prm), GT, dt)
            b_e, b_o = cd._to_ch(T(x)[0]), cd._to_ch(T(x)[1])
            v = cd._to_ch(T(psi)[0])
            cd.matpc_dagm_ch(v)
            if dt == BF16:
                cd.matpc_dagm_ch(v, storage_dtype=BF16)
            for dagger in (False, True):
                cd.matpc_ch(v, dagger)
            cd.reconstruct_ch(cd.prepare_ch(b_e, b_o), b_e, b_o)
            cd.m_ch(b_e, b_o)
            cd.mdag_ch(b_e, b_o)
    return seen


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def test_every_chain_form_has_an_entry_point(recorded):
    assert set(recorded) <= set(_build.ENTRY_POINTS)
    # the bf16 storage reaches all four K1e instances, and the bf16 tier's
    # float32 storage the float32-A⁻¹ K1d instance
    assert {f"qkx_dslash_ch_{f}" for f in K1E_FORMS} <= set(recorded)
    assert "qkx_dslash_ch_f32_g16c32" in recorded
    assert {"qkx_dslash_ch_f32", "qkx_dslash_ch_f64"} <= set(recorded)


def test_kernel_form_table_matches_the_entry_points():
    names = {f"qkx_dslash_ch_{f.name}" for f in dk._FORMS}
    assert names <= set(_build.ENTRY_POINTS)
    assert {f.counter for f in dk._FORMS} == {
        "launches", "launches_bf16", "launches_bf16s", "launches_r8"}
    assert all(f.counter == "launches_bf16s" for f in dk._FORMS
               if f.name in K1E_FORMS)


def _ops(flds):
    _, ud, psi, x, cinv = flds
    v = dk.to_channels(T(psi[1])).to(F32)
    xx = dk.to_channels(T(x[0])).to(F32)
    return dict(g=dk.gauge_channels(T(ud), 0, True, BF16),
                g18=dk.gauge_channels(T(ud), 0, False, BF16),
                g32=dk.gauge_channels(T(ud), 0, True, F32),
                g64=dk.gauge_channels(T(ud), 0, True, F64),
                ci=dk.clover_channels(T(cinv), 0, F32),
                ci16=dk.clover_channels(T(cinv), 0, BF16),
                v=v, v16=v.to(BF16), v64=v.to(F64), x=xx, x16=xx.to(BF16))


FORMS = {   # name: (gauge, ψ, keyword arguments, form)
    "o16 clover": ("g", "v", dict(clover="fwd", cinv_ch="ci",
                                  out_dtype=BF16), "f32_g16c32_o16"),
    "o16 twist": ("g", "v", dict(twist=(0.1, 0.9), out_dtype=BF16),
                  "f32_g16c32_o16"),
    "s16o16 clover xpay": ("g", "v16", dict(clover="fwd", cinv_ch="ci",
                                            xpay_coef=XC, x_ch="x",
                                            out_dtype=BF16),
                           "f32_g16c32_s16o16"),
    "s16o16 bare": ("g", "v16", dict(out_dtype=BF16), "f32_g16c32_s16o16"),
    "x16 xpay": ("g", "v", dict(xpay_coef=XC, x_ch="x16"), "f32_g16c32_x16"),
    "s16 twist": ("g", "v16", dict(twist=(0.1, 0.9)), "f32_g16c32_s16"),
}


def _resolve(o, g, v, kw):
    return o[g], o[v], {k: (o[w] if k in ("cinv_ch", "x_ch") else w)
                        for k, w in kw.items()}


@pytest.mark.parametrize("name", list(FORMS))
def test_k1e_forms_pick_their_entry_point(flds, name):
    """Each K1e form names its entry point, ``_launch`` calls exactly that
    one, and the CPU path (the plain version) returns the output dtype
    and counts no launch."""
    g, v, kw, form = FORMS[name]
    g, v, kw = _resolve(_ops(flds), g, v, kw)
    out_dtype = kw.pop("out_dtype", None)
    assert dk._check_operands(g, v, GT, True, kw.get("twist"),
                              kw.get("xpay_coef"), kw.get("x_ch"),
                              kw.get("clover"), kw.get("cinv_ch"), None,
                              out_dtype) == form
    called = []
    lib = types.SimpleNamespace(**{
        n: (lambda *a, n=n: called.append(n) or 0)
        for n in _build.ENTRY_POINTS})
    out = torch.empty(v.shape, dtype=out_dtype or F32)
    assert dk._launch(lib, form, g, v, out, None, 0, GT, False, True,
                      kw.get("twist"), kw.get("xpay_coef"), kw.get("x_ch"),
                      kw.get("clover"), kw.get("cinv_ch"), None, 0) == 0
    assert called == [f"qkx_dslash_ch_{form}"]
    before = dk.dslash_ch.launches_bf16s
    res = dk.dslash_ch(g, v, 0, GT, recon12=True, out_dtype=out_dtype, **kw)
    assert res.dtype == (out_dtype or F32)
    assert dk.dslash_ch.launches_bf16s == before


BAD = {   # operand mixes no kernel takes
    "bf16 out, float32 gauge": ("g32", "v", dict(out_dtype=BF16)),
    "bf16 out, float64": ("g64", "v64", dict(out_dtype=BF16)),
    "bf16 psi and bf16 x": ("g", "v16", dict(xpay_coef=XC, x_ch="x16")),
    "bf16 out, bf16 clover": ("g", "v", dict(clover="fwd", cinv_ch="ci16",
                                             out_dtype=BF16)),
    "bf16 x, bf16 clover": ("g", "v", dict(clover="fwd", cinv_ch="ci16",
                                           xpay_coef=XC, x_ch="x16")),
    "bf16 out, full gauge": ("g18", "v", dict(out_dtype=BF16,
                                              recon12=False)),
    "float16 out": ("g", "v", dict(out_dtype=torch.float16)),
    "float64 out, float32": ("g32", "v", dict(out_dtype=F64)),
}


@pytest.mark.parametrize("name", list(BAD))
def test_kernel_form_refusals(flds, name):
    g, v, kw = BAD[name]
    g, v, kw = _resolve(_ops(flds), g, v, kw)
    with pytest.raises(TypeError, match="no kernel takes"):
        dk.dslash_ch(g, v, 0, GT, **{"recon12": True, **kw})


def test_msrc_refuses_the_compact_forms(flds):
    """The multi-source kernel has no float32-A⁻¹ or bf16-spinor
    instance."""
    o = _ops(flds)
    psi_b = torch.stack([o["v"], o["v"]])
    with pytest.raises(TypeError, match="multi-source"):
        dk.dslash_ch_msrc(o["g"], psi_b, 0, GT, recon12=True, clover="fwd",
                          cinv_ch=o["ci"])
    with pytest.raises(TypeError, match="multi-source"):
        dk.dslash_ch_msrc(o["g"], psi_b, 0, GT, recon12=True, xpay_coef=XC,
                          x_ch=torch.stack([o["x16"], o["x16"]]))


# ---- the plain A⁻¹† and twist on a bf16 spinor --------------------------------

def test_clover_apply_on_bf16_spinor_matches_jax(flds):
    """``_ch_clover_apply`` widens a bf16 spinor with the matrix to float32
    and returns float32, as the JAX package's (repaired: it used to build
    a complex bf16 tensor, which torch refuses)."""
    _, _, psi, _, cinv = flds
    ci = dk.clover_channels(T(cinv), 1, F32)
    v16 = dk.to_channels(T(psi[0])).to(F32).to(BF16)
    from quda_qkxtm_multigrid_tpu.dirac import (
        _ch_clover_apply as j_ch_clover_apply)
    jv16 = jnp.asarray(v16.to(F32).numpy()).astype(jnp.bfloat16)
    jci = jnp.asarray(ci.numpy())
    for dag in (False, True):
        got = _ch_clover_apply(v16, ci, dag=dag)
        ref = np.asarray(j_ch_clover_apply(jv16, jci, dag=dag))
        assert got.dtype == F32
        assert float(np.linalg.norm(got.numpy() - ref)
                     / np.linalg.norm(ref)) <= 1e-6
    for dt in (F32, F64):
        assert _ch_clover_apply(v16.to(dt), ci.to(dt)).dtype == dt


def test_twist_on_bf16_spinor_matches_jax(flds):
    """``_ch_twist`` keeps a bf16 spinor in bf16, as the JAX package's."""
    _, _, psi, _, _ = flds
    v16 = dk.to_channels(T(psi[0])).to(F32).to(BF16)
    from quda_qkxtm_multigrid_tpu.dirac import _ch_twist as j_ch_twist
    ref = j_ch_twist(jnp.asarray(v16.to(F32).numpy()).astype(jnp.bfloat16),
                     0.023, 0.9995)
    got = _ch_twist(v16, 0.023, 0.9995)
    assert got.dtype == BF16 and ref.dtype == jnp.bfloat16
    r = np.asarray(ref.astype(jnp.float32))
    assert float(np.linalg.norm(got.float().numpy() - r)
                 / np.linalg.norm(r)) <= 2.0 ** -8


# ---- the kernel on the card -----------------------------------------------------

@pytest.mark.cuda
def test_k1e_kernels_match_reference_on_card():
    """Every K1e form against its plain version at 8⁴ (the bf16 criterion
    for bf16 outputs, 1e-5 for float32 ones), each launch counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    dev = torch.device("cuda")
    geom_j, geom = jlat.Geometry(8, 8, 8, 8), tlat.Geometry(8, 8, 8, 8)
    _, ud, psi, x, cinv = _fields(geom_j, 93)
    o = {k: t.to(dev) for k, t in _ops((None, ud, psi, x, cinv)).items()}
    for name, (g, v, kw, form) in FORMS.items():
        g_, v_, kw_ = _resolve(o, g, v, kw)
        out_dtype = kw_.pop("out_dtype", None)
        before = dk.dslash_ch.launches_bf16s
        got = dk.dslash_ch(g_, v_, 0, geom, recon12=True, out_dtype=out_dtype,
                           **kw_)
        assert dk.dslash_ch.launches_bf16s == before + 1, name
        ref = dk.dslash_ch_reference(g_, v_, 0, geom, recon12=True,
                                     out_dtype=out_dtype, **kw_)
        if got.dtype == BF16:
            assert_bf16_close(got, ref)
        else:
            assert float((got - ref).norm() / ref.norm()) <= 1e-5, name
