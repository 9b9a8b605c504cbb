"""The port's fused Wilson-hop module (``ops/dslash_kernel.py``): operand
preparation against the JAX package (bit-exact), the plain version
``dslash_ch_reference`` over every epilogue form of the solve against
the JAX package's plain composition (complex128, 1e-12) and against the
Pallas kernel in interpret mode (float32, 1e-5), and the wrapper's
dispatch and operand checks.  The CUDA kernel itself runs only on a
card: its test carries the ``cuda`` marker and skips elsewhere.
"""

import functools
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from quda_qkxtm_multigrid_tpu import lattice as jlat
from quda_qkxtm_multigrid_tpu.ops import clover as jcl
from quda_qkxtm_multigrid_tpu.ops import dslash as jdsl
from quda_qkxtm_multigrid_tpu.ops.dslash_pallas import (
    _from_channels as j_from_channels, _to_channels as j_to_channels)
from quda_qkxtm_multigrid_tpu.ops.dslash_pallas2 import (
    _proj_rank2 as j_proj_rank2)
from quda_qkxtm_multigrid_tpu.ops.dslash_pallas5 import (
    clover_channels as j_clover_channels, dslash_ch_pallas5,
    gauge_channels as j_gauge_channels)
from quda_qkxtm_multigrid_tpu.utils import rng as jrng

from quda_qkxtm_multigrid_tpu_torch import lattice as tlat
from quda_qkxtm_multigrid_tpu_torch import convert
from quda_qkxtm_multigrid_tpu_torch.convert import spinor_to_numpy as N
from quda_qkxtm_multigrid_tpu_torch.ops import dslash as tdsl
from quda_qkxtm_multigrid_tpu_torch.ops import dslash_kernel as dk

# the tests run on the CPU; the converters default to the card
T = functools.partial(convert.spinor_from_numpy, device="cpu")

torch.set_num_threads(1)

GJ = jlat.Geometry(4, 4, 4, 8)
GT = tlat.Geometry(4, 4, 4, 8)
KAPPA = 0.115
A_TW = 2 * KAPPA * 0.05
B_TW = 1.0 / (1.0 + A_TW * A_TW)
XC = -KAPPA * KAPPA


def rel(got, ref) -> float:
    got = N(got) if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.linalg.norm((got - ref).ravel())
                 / np.linalg.norm(ref.ravel()))


def _fields(geom, seed):
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    u = np.asarray(jrng.random_gauge(k1, geom))
    psi = np.asarray(jrng.random_spinor(k2, geom))
    x = np.asarray(jrng.random_spinor(k3, geom))
    ud = np.asarray(jdsl.double_gauge(u, geom))
    _, cinv = jcl.make_clover_pair(u, geom, _tmc())
    return u, ud, psi, x, np.asarray(cinv)


def _tmc():
    from quda_qkxtm_multigrid_tpu.dirac import DiracParams
    return DiracParams(kind="twisted-clover", kappa=KAPPA, mu=0.05, csw=1.0)


@pytest.fixture(scope="module")
def flds():
    return _fields(GJ, 31)


# ---- operand preparation -------------------------------------------------

def test_to_from_channels(flds):
    psi = flds[2][0]
    ch = dk.to_channels(T(psi))
    assert ch.shape == (GT.T, 24, GT.Z, GT.W) and ch.dtype == torch.float64
    np.testing.assert_array_equal(N(ch.to(torch.float32)),
                                  np.asarray(j_to_channels(psi)))
    np.testing.assert_array_equal(N(dk.from_channels(ch, (4, 3))), psi)
    f32 = np.asarray(j_to_channels(psi))
    np.testing.assert_array_equal(
        N(dk.from_channels(T(f32), (4, 3))),
        np.asarray(j_from_channels(f32, (4, 3))))


@pytest.mark.parametrize("parity,recon12", [(0, True), (1, True),
                                            (0, False), (1, False)])
def test_gauge_channels_bitexact(flds, parity, recon12):
    ud = flds[1]
    ref = np.asarray(j_gauge_channels(ud, parity, recon12, False))
    got = dk.gauge_channels(T(ud), parity, recon12, torch.float32)
    assert got.shape == (GT.T, 96 if recon12 else 144, GT.Z, GT.W)
    np.testing.assert_array_equal(N(got), ref)


@pytest.mark.parametrize("parity", [0, 1])
def test_clover_channels_bitexact(flds, parity):
    cinv = flds[4]
    ref = np.asarray(j_clover_channels(cinv, parity, False))
    got = dk.clover_channels(T(cinv), parity, torch.float32)
    np.testing.assert_array_equal(N(got), ref)


@pytest.mark.parametrize("mu", [0, 1, 2, 3])
def test_proj_rank2(mu):
    for plus in (False, True):
        assert dk._proj_rank2(mu, plus) == j_proj_rank2(mu, plus)


# ---- the plain version against the JAX package's plain composition ------

def _hop_cases():
    cases = [dict(parity=p, dagger=dg, recon12=r)
             for p in (0, 1) for dg in (False, True) for r in (True, False)]
    cases += [
        dict(parity=0, recon12=True, twist=(-A_TW, B_TW), xpay=XC),
        dict(parity=0, recon12=True, twist=(-A_TW, B_TW), xpay=XC,
             post_op=("twist", A_TW, B_TW)),
        dict(parity=1, dagger=True, recon12=True, twist=(A_TW, B_TW)),
        dict(parity=1, recon12=True, clover="fwd"),
        dict(parity=0, recon12=True, clover="fwd", xpay=XC,
             post_op=("clover",)),
        dict(parity=1, dagger=True, recon12=True, clover="dag"),
        dict(parity=0, dagger=True, recon12=True, xpay=XC),
    ]
    return cases


def _case_id(c):
    parts = [f"p{c['parity']}", "dag" if c.get("dagger") else "fwd",
             "r12" if c["recon12"] else "r18"]
    parts += [k for k in ("twist", "clover", "xpay") if k in c]
    if c.get("post_op"):
        parts.append("post-" + c["post_op"][0])
    return "-".join(parts)


def _jax_expected(u, psi, x, cinv, c):
    """The JAX package's plain (XLA) composition of the same epilogues."""
    p, dagger = c["parity"], c.get("dagger", False)
    res = jdsl.dslash_parity(u, psi[1 - p], p, GJ, dagger)
    g5 = jnp.asarray([1.0, 1.0, -1.0, -1.0]).reshape(4, 1, 1, 1, 1)
    if "clover" in c:
        res = jcl.clover_apply(cinv[p], res, dagger=c["clover"] == "dag")
    if "twist" in c:
        a, b = c["twist"]
        res = b * (res + 1j * a * g5 * res)
    if "xpay" in c:
        res = x[p] + c["xpay"] * res
    post = c.get("post_op")
    if post is None:
        return (res,)
    if post[0] == "clover":
        return res, jcl.clover_apply(cinv[p], res, dagger=True)
    return res, post[2] * (res + 1j * post[1] * g5 * res)


def _port_kwargs(c, x, cinv, dtype):
    p = c["parity"]
    kw = dict(dagger=c.get("dagger", False), recon12=c["recon12"],
              twist=c.get("twist"), post_op=c.get("post_op"))
    if "xpay" in c:
        kw.update(xpay_coef=c["xpay"], x_ch=dk.to_channels(T(x[p])).to(dtype))
    if "clover" in c:
        kw.update(clover=c["clover"],
                  cinv_ch=dk.clover_channels(T(cinv), p, dtype))
    return kw


@pytest.mark.parametrize("case", _hop_cases(), ids=_case_id)
def test_reference_matches_jax_composition(flds, case):
    u, ud, psi, x, cinv = flds
    p = case["parity"]
    g_ch = dk.gauge_channels(T(ud), p, case["recon12"])
    out = dk.dslash_ch_reference(g_ch, dk.to_channels(T(psi[1 - p])), p,
                                 GT, **_port_kwargs(case, x, cinv,
                                                    torch.float64))
    out = out if isinstance(out, tuple) else (out,)
    ref = _jax_expected(u, psi, x, cinv, case)
    assert len(out) == len(ref)
    for o, r in zip(out, ref):
        assert rel(dk.from_channels(o, (4, 3)), r) <= 1e-12


# Interpret mode costs tens of seconds per case: two cases, the clover
# forward half with its second output, and a dagger twist.
GJ_I = jlat.Geometry(8, 4, 4, 4)
GT_I = tlat.Geometry(8, 4, 4, 4)


@pytest.fixture(scope="module")
def flds_interp():
    return _fields(GJ_I, 32)


@pytest.mark.parametrize("case", [
    dict(parity=0, recon12=True, clover="fwd", xpay=XC,
         post_op=("clover",)),
    dict(parity=1, dagger=True, recon12=True, twist=(A_TW, B_TW)),
], ids=_case_id)
def test_reference_matches_pallas_interpret(flds_interp, case):
    u, ud, psi, x, cinv = flds_interp
    p = case["parity"]
    g_j = j_gauge_channels(ud, p, True, False)
    psi_j = j_to_channels(psi[1 - p])
    kw_j = dict(dagger=case.get("dagger", False), recon12=True,
                twist=case.get("twist"), post_op=case.get("post_op"))
    if "xpay" in case:
        kw_j.update(xpay_coef=case["xpay"], x_ch=j_to_channels(x[p]))
    if "clover" in case:
        kw_j.update(clover=case["clover"],
                    cinv_ch=j_clover_channels(cinv, p, False))
    ref = dslash_ch_pallas5(g_j, psi_j, p, GJ_I, interpret=True, **kw_j)
    kw_t = {k: (T(np.asarray(v)) if k in ("x_ch", "cinv_ch") else v)
            for k, v in kw_j.items()}
    got = dk.dslash_ch_reference(T(np.asarray(g_j)), T(np.asarray(psi_j)),
                                 p, GT_I, **kw_t)
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32
        assert rel(g, r) <= 1e-5


# ---- wrapper: dispatch, operand checks, counter -----------------------------

def test_dslash_ch_on_cpu_is_the_reference(flds):
    u, ud, psi, x, cinv = flds
    c = _hop_cases()[12]            # clover fwd + xpay + post clover
    kw = _port_kwargs(c, x, cinv, torch.float32)
    g = dk.gauge_channels(T(ud), 0, True, torch.float32)
    v = dk.to_channels(T(psi[1])).to(torch.float32)
    before = dk.dslash_ch.launches
    out = dk.dslash_ch(g, v, 0, GT, **kw)
    ref = dk.dslash_ch_reference(g, v, 0, GT, **kw)
    assert dk.dslash_ch.launches == before
    for o, r in zip(out, ref):
        assert torch.equal(o, r)


@pytest.mark.parametrize("recon12", [True, False])
def test_dslash_parity_kernel(flds, recon12):
    u, ud, psi, _, _ = flds
    ref = jdsl.dslash_parity(u, psi[0], 1, GJ, True)
    got = dk.dslash_parity_kernel(T(ud), T(psi[0]), 1, GT, True,
                                  recon12=recon12)
    assert got.dtype == torch.complex128
    assert rel(got, ref) <= 1e-12


def _ops32(flds):
    u, ud, psi, x, cinv = flds
    g = dk.gauge_channels(T(ud), 0, True, torch.float32)
    v = dk.to_channels(T(psi[1])).to(torch.float32)
    ci = dk.clover_channels(T(cinv), 0, torch.float32)
    return g, v, ci


BAD = {
    "psi shape": lambda g, v, ci: ((g, v[:, :12]), {}),
    "gauge channels": lambda g, v, ci: ((g, v), dict(recon12=False)),
    "complex psi": lambda g, v, ci: ((g, v.to(torch.complex64)), {}),
    "half psi": lambda g, v, ci: ((g.half(), v.half()), {}),
    "mixed dtypes": lambda g, v, ci: ((g.double(), v), {}),
    "non-contiguous": lambda g, v, ci: (
        (g, v.transpose(2, 3).contiguous().transpose(2, 3)), {}),
    "twist and clover": lambda g, v, ci: (
        (g, v), dict(twist=(0.1, 1.0), clover="fwd", cinv_ch=ci)),
    "clover mode": lambda g, v, ci: ((g, v), dict(clover="inv",
                                                  cinv_ch=ci)),
    "clover without cinv": lambda g, v, ci: ((g, v), dict(clover="fwd")),
    "xpay without x": lambda g, v, ci: ((g, v), dict(xpay_coef=0.5)),
    "post clover without clover": lambda g, v, ci: (
        (g, v), dict(post_op=("clover",))),
    "post op": lambda g, v, ci: ((g, v), dict(post_op=("scale", 2.0))),
}


@pytest.mark.parametrize("name", list(BAD))
def test_dslash_ch_rejects(flds, name):
    g, v, ci = _ops32(flds)
    args, kw = BAD[name](g, v, ci)
    with pytest.raises((ValueError, TypeError)):
        dk.dslash_ch(*args, 0, GT, recon12=kw.pop("recon12", True), **kw)


def test_dslash_ch_has_no_fallback_device(flds):
    """A tensor on neither the CPU nor a CUDA device raises."""
    g, v, _ = _ops32(flds)
    with pytest.raises(ValueError, match="no dslash_ch for device"):
        dk.dslash_ch(g.to("meta"), v.to("meta"), 0, GT, recon12=True)


@pytest.mark.cuda
def test_kernel_matches_reference_on_card():
    """The CUDA kernel against its plain version on the card, in both
    precisions, over the epilogue forms of the solve."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    flds = _fields(jlat.Geometry(8, 8, 8, 8), 33)
    u, ud, psi, x, cinv = flds
    geom = tlat.Geometry(8, 8, 8, 8)
    dev = torch.device("cuda")
    for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        for c in _hop_cases():
            p = c["parity"]
            kw = {k: (v.to(dev) if torch.is_tensor(v) else v)
                  for k, v in _port_kwargs(c, x, cinv, dtype).items()}
            g = dk.gauge_channels(T(ud, device=dev), p, c["recon12"], dtype)
            v = dk.to_channels(T(psi[1 - p], device=dev)).to(dtype)
            before = dk.dslash_ch.launches
            got = dk.dslash_ch(g, v, p, geom, **kw)
            assert dk.dslash_ch.launches == before + 1
            ref = dk.dslash_ch_reference(g, v, p, geom, **kw)
            got = got if isinstance(got, tuple) else (got,)
            ref = ref if isinstance(ref, tuple) else (ref,)
            for a, b in zip(got, ref):
                assert float((a - b).norm() / b.norm()) <= tol


@pytest.mark.cuda
def test_msrc_kernel_matches_reference_and_single_source_on_card():
    """The multi-source CUDA kernel against its plain version (float32,
    1e-5) and against n single-source kernel launches (1e-6; the two
    share the per-site device code), over the forms of the multigrid
    setup, for n = 1 and 3."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    geom_j = jlat.Geometry(8, 8, 8, 8)
    u, ud, psi, x, cinv = _fields(geom_j, 34)
    geom = tlat.Geometry(8, 8, 8, 8)
    dev = torch.device("cuda")
    f32 = torch.float32
    g = [dk.gauge_channels(T(ud, device=dev), p, True, f32) for p in (0, 1)]
    ci = [dk.clover_channels(T(cinv, device=dev), p, f32) for p in (0, 1)]
    src = torch.stack([dk.to_channels(T(psi[p], device=dev)) for p in (0, 1, 0)])
    xs = torch.stack([dk.to_channels(T(x[p], device=dev)) for p in (1, 0, 1)])
    forms = [dict(parity=1, clover="fwd"),
             dict(parity=0, clover="fwd", xpay=True),
             dict(parity=1, dagger=True, clover="dag"),
             dict(parity=0, dagger=True, xpay=True),
             dict(parity=0, twist=(-A_TW, B_TW), xpay=True),
             dict(parity=1, dagger=True, twist=(A_TW, B_TW))]
    for n in (1, 3):
        psi_b, x_b = src[:n].to(f32).contiguous(), xs[:n].to(f32).contiguous()
        for f in forms:
            p = f["parity"]
            kw = dict(dagger=f.get("dagger", False), recon12=True,
                      twist=f.get("twist"))
            if "clover" in f:
                kw.update(clover=f["clover"], cinv_ch=ci[p])
            xpay = dict(xpay_coef=XC, x_ch=x_b) if "xpay" in f else {}
            before = dk.dslash_ch_msrc.launches
            got = dk.dslash_ch_msrc(g[p], psi_b, p, geom, **kw, **xpay)
            assert dk.dslash_ch_msrc.launches == before + 1
            ref = dk.dslash_ch_msrc_reference(g[p], psi_b, p, geom, **kw,
                                              **xpay)
            assert float((got - ref).norm() / ref.norm()) <= 1e-5
            singles = torch.stack([
                dk.dslash_ch(g[p], psi_b[i], p, geom, **kw,
                             **({"xpay_coef": XC, "x_ch": x_b[i]}
                                if xpay else {}))
                for i in range(n)])
            assert float((got - singles).norm() / singles.norm()) <= 1e-6
