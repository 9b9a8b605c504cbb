"""The chiral 6×6 clover apply on channels (``ops.dslash_kernel.
clover_ch``, ``csrc/clover_ch.cu``): the wrapper's choice of kernel
form and its refusals, ``dirac._ch_clover_apply`` on a CPU tensor as it
was (the plain version, which the JAX-parity tests hold), the reader of
the benchmark's ``clover6.device_s`` metric, and, ``cuda``-marked (each
skips itself without a card), the kernel against the plain version on
the card for every form, both orderings, with and without the twisted
term, one and three sources, on the vector and the scalar path, the
compact operator's A, prepare and reconstruct through it, and the
multi-source dagger half through it against single-source halves.

Tolerances, kernel against plain on identical operands (the sums taken
in another order): 1e-6 relative normwise in float32 (six-term complex
sums, ~1e-7), 1e-13 in float64.
"""

import ctypes
import functools
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from quda_qkxtm_multigrid_tpu_torch import _build, compact, dirac
from quda_qkxtm_multigrid_tpu_torch.benchmarks import tmc_params
from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry
from quda_qkxtm_multigrid_tpu_torch.ops import dslash_kernel as dk
from quda_qkxtm_multigrid_tpu_torch.utils import profiling, rng

BF16, F32, F64 = torch.bfloat16, torch.float32, torch.float64
F16 = torch.float16
GT = Geometry(4, 4, 4, 8)
TWIST_A = 0.023
TOL = {F32: 1e-6, F64: 1e-13}


@functools.lru_cache(maxsize=None)
def _compact():
    """The float64 compact operator at 4³×8 on the CPU, and three
    spinors [3, T, 24, Z, W]."""
    gen = torch.Generator().manual_seed(29)
    cd = compact.make_compact(rng.random_gauge(gen, GT), tmc_params(), GT,
                              F64)
    psi = rng.random_spinor(gen, GT, batch_shape=(3,))
    return cd, torch.stack([dk.to_channels(psi[i, 0]) for i in range(3)])


def _fields():
    """The clover A and its twisted inverse of parity 0, and the three
    spinors."""
    cd, v = _compact()
    return cd.cl_ch[0], cd.cinv_ch[0], v


def _rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


# ---- the forms and the refusals (CPU) ---------------------------------------

FORMS = {   # (operand dtype, spinor dtype): (form, output dtype)
    (BF16, F32): ("f32_c16", F32), (BF16, BF16): ("f32_c16s16", F32),
    (F32, F32): ("f32", F32), (F32, BF16): ("f32_s16", F32),
    (F64, F64): ("f64", F64)}
REFUSED = {   # name: (operand dtype, spinor dtype, shape edit, error)
    "f64 operand, f32 spinor": (F64, F32, None, TypeError),
    "f32 operand, f64 spinor": (F32, F64, None, TypeError),
    "bf16 operand, f64 spinor": (BF16, F64, None, TypeError),
    "f64 operand, bf16 spinor": (F64, BF16, None, TypeError),
    "f16 operand": (F16, F32, None, TypeError),
    "f16 spinor": (F32, F16, None, TypeError),
    "recon-12 gauge as operand": (F32, F32, "operand96", ValueError),
    "12-channel spinor": (F32, F32, "spinor12", ValueError),
    "spinor of another T": (F32, F32, "spinor_t", ValueError),
    "operand with a source axis": (F32, F32, "operand5d", ValueError),
    "CPU tensors": (F32, F32, None, ValueError)}
CASES = [("form", k) for k in FORMS] + [("refused", k) for k in REFUSED]


def _edit(c, v, edit):
    if edit == "operand96":
        return c[:, :96].contiguous(), v
    if edit == "spinor12":
        return c, v[:, :12].contiguous()
    if edit == "spinor_t":
        return c, v[:-2].contiguous()
    if edit == "operand5d":
        return c[None], v
    return c, v


@pytest.mark.parametrize("kind,key", CASES,
                         ids=[f"{k}-{key}" for k, key in CASES])
def test_clover_form_and_refusals(kind, key):
    """The operand and spinor dtypes select the form, whose output dtype
    the operator's CPU path (the plain version) gives too; any other mix
    or shape raises before any launch, and so do CPU tensors: the
    kernel is CUDA-only."""
    _, cinv, vb = _fields()
    launches = dk.clover_ch.launches
    if kind == "form":
        (cdt, vdt), (name, out_dt) = key, FORMS[key]
        c, v = cinv.to(cdt), vb[0].to(vdt)
        assert dk._clover_form(c, v) == (name, out_dt)
        got = dirac._ch_clover_apply(v, c, dag=True, twist_a=TWIST_A)
        assert got.dtype == out_dt
        assert torch.equal(got, dirac._ch_clover_plain(v, c, True, TWIST_A))
        # the launch: the form's entry point, the sources and the shape
        called = []
        lib = types.SimpleNamespace(**{
            e: (lambda *a, e=e: called.append((e, a[3:9])) or 0)
            for e in _build.CLOVER_ENTRY_POINTS})
        t, _, z, w = c.shape
        assert dk._launch_clover(lib, name, c, vb.to(vdt), got, True,
                                 TWIST_A, 0) == 0
        assert called == [(f"qkx_clover_ch_{name}",
                           (3, t, z, w, 1, TWIST_A))]
    else:
        cdt, vdt, edit, err = REFUSED[key]
        c, v = _edit(cinv.to(cdt), vb[0].to(vdt), edit)
        with pytest.raises(err):
            dk.clover_ch(c, v)
    assert dk.clover_ch.launches == launches


def test_clover_forms_match_the_entry_points():
    """Each form has its C entry point, kept apart from the hops' table,
    with the pointers and the stream as ``c_void_p``."""
    names = {f"qkx_clover_ch_{f[0]}" for f in dk._CLOVER_FORMS.values()}
    assert names == set(_build.CLOVER_ENTRY_POINTS)
    assert len(names) == len(_build.CLOVER_FORMS)
    assert not names & set(_build.ENTRY_POINTS)
    assert dk._CLOVER_FORMS == FORMS
    for argtypes in _build.CLOVER_ENTRY_POINTS.values():
        assert argtypes[:3] == [ctypes.c_void_p] * 3
        assert ctypes.c_void_p not in argtypes[3:-1]
        assert argtypes[-1] is ctypes.c_void_p


def _parent_apply(v_ch, cinv_ch, dag=False):
    """``dirac._ch_clover_apply`` as it was before the kernel: the
    plain body (the chiral blocks as complex 6×6 matrices, an einsum),
    verbatim."""
    if v_ch.dtype == torch.bfloat16:
        v_ch = v_ch.to(torch.float32)
    t, _, z, w = cinv_ch.shape
    c = cinv_ch.to(v_ch.dtype)
    m = torch.complex(c[:, 0::2], c[:, 1::2]).reshape(t, 2, 6, 6, z, w)
    lead = v_ch.shape[:-4]
    v = torch.complex(v_ch[..., 0::2, :, :], v_ch[..., 1::2, :, :]).reshape(
        *lead, t, 2, 6, z, w)
    if dag:
        out = torch.einsum("thcrzw,...thczw->...thrzw", m.conj(), v)
    else:
        out = torch.einsum("thrczw,...thczw->...thrzw", m, v)
    return torch.stack([out.real, out.imag], dim=-3).reshape(v_ch.shape)


@pytest.mark.parametrize("dt", [F64, F32, BF16], ids=str)
def test_ch_clover_apply_on_cpu_unchanged(dt):
    """On CPU tensors ``_ch_clover_apply`` is the plain body it was, bit
    for bit, on one source and on three; with the twisted term it is
    what the compact operator's A computed (A v + ((1 + i a γ5) v −
    v)), and so is ``CompactDirac._a_apply_ch``."""
    cl, cinv, vb = _fields()
    c = cinv.to(F32 if dt == BF16 else dt)
    for v in (vb[1].to(dt), vb.to(dt)):
        for dag in (False, True):
            assert torch.equal(dirac._ch_clover_apply(v, c, dag),
                               _parent_apply(v, c, dag))
    v = vb[2].to(dt)
    old = _parent_apply(v, cl.to(c.dtype), True)
    w = v.to(old.dtype)
    old = old + (dirac._ch_twist(w, TWIST_A, 1.0) - w)
    assert torch.equal(dirac._ch_clover_apply(v, cl.to(c.dtype), True,
                                              TWIST_A), old)
    if dt == F64:
        cd, _ = _compact()
        p = cd.params
        a = 2.0 * p.kappa * p.mu * p.flavor
        want = _parent_apply(v, cd.cl_ch[0])
        want = want + (dirac._ch_twist(v, a, 1.0) - v)
        assert torch.equal(cd._a_apply_ch(v, 0), want)


def test_clover6_reader(monkeypatch):
    """``clover6.device_s`` reads the span ``op.clover6``'s device
    seconds a solve; without a trace, or from a program without the
    span (the parent's), it reads nothing."""
    from portbench import run as run_mod
    read = run_mod._reader("clover6.device_s.dc")
    run = run_mod.Run()
    assert read(run) is None
    run.trace = {}
    span = dict(calls=1, roots=0, host_s=0.0, host_self_s=0.0)
    spans = {"dc.solve": dict(span, roots=4, device_s=8.0,
                              device_self_s=1.0),
             "mg.vcycle": dict(span, device_s=6.0, device_self_s=2.0)}
    tables = iter([{"spans": spans, "counters": {}},
                   {"spans": dict(spans, **{"op.clover6": dict(
                       span, calls=360, device_s=0.4, device_self_s=0.4)}),
                    "counters": {"op.clover6": 360}}])
    monkeypatch.setattr(profiling, "table", lambda: next(tables))
    assert read(run) is None
    assert read(run) == pytest.approx(0.1)


# ---- on the card ------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    return torch.device("cuda")


def _misaligned(x):
    """A contiguous copy of ``x`` that starts one element past an
    aligned address: the kernel takes its scalar path."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


CARD = [(k, dag, tw, n, path) for k in FORMS for dag in (False, True)
        for tw in (0.0, TWIST_A) for n in (1, 3)
        for path in ("vector", "scalar")]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "key,dag,twist_a,n,path", CARD,
    ids=[f"{FORMS[k][0]}-{'dag' if d else 'fwd'}-tw{int(bool(t))}-n{n}-{p}"
         for k, d, t, n, p in CARD])
def test_kernel_matches_plain_on_card(key, dag, twist_a, n, path):
    """The kernel against the plain version on the card on identical
    operands, one launch each."""
    dev = _card()
    _, cinv, vb = _fields()
    c = cinv.to(key[0]).to(dev)
    v = (vb[0] if n == 1 else vb).to(key[1]).to(dev)
    if path == "scalar":
        v = _misaligned(v)
    want = dirac._ch_clover_plain(v, c, dag, twist_a)
    launches = dk.clover_ch.launches
    got = dirac._ch_clover_apply(v, c, dag, twist_a)
    torch.cuda.synchronize()
    assert dk.clover_ch.launches == launches + 1
    assert got.dtype == want.dtype and got.shape == want.shape
    assert _rel(got, want) <= TOL[want.dtype]


TIERS = {"bf16": dict(dtype=BF16), "bf16 cinv_bf16": dict(
    dtype=BF16, cinv_bf16=True), "f32": dict(dtype=F32),
    "f64": dict(dtype=F64)}


@pytest.mark.cuda
@pytest.mark.parametrize("tier", TIERS)
def test_compact_dirac_on_card(tier, monkeypatch):
    """``CompactDirac``'s A (both parities, both orderings, with its
    twist), prepare and reconstruct through the kernel against the same
    with the plain 6×6 applies, on the card."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(31)
    u = rng.random_gauge(gen, GT).to(dev)
    cd = compact.make_compact(u, tmc_params(), GT, **TIERS[tier])
    b = rng.random_spinor(gen, GT).to(dev)
    b_e, b_o = cd._to_ch(b[0]), cd._to_ch(b[1])

    def run():
        out = [cd._a_apply_ch(b_e, p, dag) for p in (0, 1)
               for dag in (False, True)]
        src = cd.prepare_ch(b_e, b_o)
        return out + [src, *cd.reconstruct_ch(src, b_e, b_o)]

    launches = dk.clover_ch.launches
    got = run()
    assert dk.clover_ch.launches > launches
    monkeypatch.setattr(compact, "_ch_clover_apply", dirac._ch_clover_plain)
    want = run()
    tol = TOL[cd.spinor_dtype]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and _rel(g, w) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_msrc_dagger_half_on_card(bf16):
    """The multi-source dagger half M_pc† (``Dirac._fused_matpc_ch`` with
    ``dslash_ch_msrc``) on three sources, its leading A⁻¹† one C6 launch
    over all three, equals three single-source halves (one C6 launch
    each) bit for bit, in the float32 and the bf16 operand tier."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(37)
    u = rng.random_gauge(gen, GT, torch.complex64).to(dev)
    d = dirac.make_dirac(u, tmc_params(bf16=bf16), GT)
    psi = rng.random_spinor(gen, GT, torch.complex64, (3,)).to(dev)
    cols = torch.stack([dk.to_channels(psi[i, 0]) for i in range(3)])
    launches = dk.clover_ch.launches
    got = d._fused_matpc_ch(cols, True, hop=dk.dslash_ch_msrc)
    assert dk.clover_ch.launches == launches + 1
    want = torch.stack([d._fused_matpc_ch(c, True) for c in cols])
    torch.cuda.synchronize()
    assert dk.clover_ch.launches == launches + 4
    assert got.shape == cols.shape and torch.equal(got, want)


@pytest.mark.cuda
def test_kernel_is_a_span_and_a_count_on_card():
    """Under the profiler each kernel apply is the span ``op.clover6``
    (device seconds above 0) and one on the counter ``op.clover6``."""
    dev = _card()
    _, cinv, vb = _fields()
    c, v = cinv.to(BF16).to(dev), vb[0].to(F32).to(dev)
    profiling.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            for _ in range(3):
                dk.clover_ch(c, v, dag=True)
        table = profiling.table()
    finally:
        profiling.reset()
    assert table["counters"]["op.clover6"] == 3
    assert table["spans"]["op.clover6"]["calls"] == 3
    assert table["spans"]["op.clover6"]["device_s"] > 0
