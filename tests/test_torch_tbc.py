"""The antiperiodic t boundary through the recon-12 hops.

The JAX package folds the boundary into the links (``apply_t_boundary``:
U_t at t = T−1 times −1).  Recon-12 rebuilds row 2 as conj(r0 × r1),
which is +row 2 for −U too, so the port reads the boundary from the
doubled links (``antiperiodic_t``) and every recon-12 hop restores the
sign.  Checked here, in complex128 / float64 at 4³×8:

* ``apply_t_boundary`` and ``plaquette`` against the JAX functions;
* the detection: periodic, antiperiodic, and refusals of a gauge off
  SU(3), of another phase and of a boundary on one parity only;
* the port's fused operator on an antiperiodic gauge against the JAX
  package's XLA operator (``make_dirac(use_pallas=False)``), ``matpc``
  (both daggers), ``matpc_dagm`` and ``m`` (≤ 1e-12): on the parent the
  fused chain solved another operator;
* the plain recon-12 hops (single, multi-source, t-local on the slabs of
  a two-way split) with the sign against the recon-18 hop on the same
  links (≤ 1e-13); the compact and the sharded operators read the
  boundary themselves; recon-8 refuses it; the kernel wrappers hand
  the kernels the boundary bit and rows;
* on the card (``cuda``-marked): K1, K2 and K4 with the sign against
  their plain versions.
"""

import functools
import types

import numpy as np
import jax
import pytest
import torch

from quda_qkxtm_multigrid_tpu import dirac as jd
from quda_qkxtm_multigrid_tpu import lattice as jlat
from quda_qkxtm_multigrid_tpu.ops import gauge as jgauge
from quda_qkxtm_multigrid_tpu.utils import rng as jrng

from quda_qkxtm_multigrid_tpu_torch import _build
from quda_qkxtm_multigrid_tpu_torch import convert
from quda_qkxtm_multigrid_tpu_torch.compact import make_compact
from quda_qkxtm_multigrid_tpu_torch.dirac import DiracParams
from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry
from quda_qkxtm_multigrid_tpu_torch.ops import dslash_kernel as dk
from quda_qkxtm_multigrid_tpu_torch.ops.clover import make_clover_pair
from quda_qkxtm_multigrid_tpu_torch.ops.dslash import (
    double_gauge, doubled_links)
from quda_qkxtm_multigrid_tpu_torch.ops.gauge import (
    apply_t_boundary, plaquette)
from quda_qkxtm_multigrid_tpu_torch.parallel.mesh import TMesh
from quda_qkxtm_multigrid_tpu_torch.parallel.sharded import shard_dirac

dirac_from_numpy = functools.partial(convert.dirac_from_numpy, device="cpu")
T = functools.partial(convert.spinor_from_numpy, device="cpu")
torch.set_num_threads(1)

GJ = jlat.Geometry(4, 4, 4, 8)
GT = Geometry(4, 4, 4, 8)
TMC = dict(kind="twisted-clover", kappa=0.115, mu=0.05, csw=1.0)
F64, F64_HOP = 1e-12, 1e-13
F64_, F32 = torch.float64, torch.float32


def rel(got, ref) -> float:
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = ref.numpy() if torch.is_tensor(ref) else np.asarray(ref)
    return float(np.linalg.norm((got - ref).ravel())
                 / np.linalg.norm(ref.ravel()))


@pytest.fixture(scope="module")
def flds():
    """complex128 gauge (JAX ``random_gauge``), the same with the JAX
    ``apply_t_boundary``, and three spinors from numpy seed 31."""
    u = jrng.random_gauge(jax.random.PRNGKey(13), GJ)
    ua = jgauge.apply_t_boundary(u, GJ)
    rng = np.random.default_rng(31)
    shape = (3, 2, 4, 3, GJ.T, GJ.Z, GJ.W)
    psi = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return np.asarray(u), np.asarray(ua), psi


def test_apply_t_boundary_and_plaquette_match_jax(flds):
    u, ua, _ = flds
    got = apply_t_boundary(T(u), GT)
    assert torch.equal(got, T(ua))
    for uu in (u, ua):
        ours = plaquette(T(uu), GT)
        ref = jgauge.plaquette(uu, GJ)
        for a, b in zip(ours, ref):
            assert abs(float(a) - float(b)) <= F64


@pytest.mark.parametrize("one_parity", [False, True])
@pytest.mark.parametrize("bc", ["periodic", "antiperiodic"])
def test_antiperiodic_t_detects_the_boundary(flds, bc, one_parity):
    u = T(flds[1] if bc == "antiperiodic" else flds[0])
    if one_parity:
        for p in (0, 1):
            assert dk.antiperiodic_t(doubled_links(u, GT, p)) == (
                bc == "antiperiodic")
    else:
        assert dk.antiperiodic_t(double_gauge(u, GT)) == (
            bc == "antiperiodic")
    assert dk.antiperiodic_t(double_gauge(u.to(torch.complex64), GT)) == (
        bc == "antiperiodic")


def _bad_gauges(u):
    rng = np.random.default_rng(5)
    off = u + 1e-3 * (rng.standard_normal(u.shape)
                      + 1j * rng.standard_normal(u.shape))
    phase = u.copy()
    phase[3, :, :, :, GJ.T - 1] *= 1j
    half = u.copy()
    half[3, 0, :, :, GJ.T - 1] *= -1          # one parity's sites only
    inner = u.copy()
    inner[3, :, :, :, 3] *= -1                # a −1 inside the lattice
    return {"off SU(3)": off, "phase i": phase, "one parity": half,
            "interior row": inner}


@pytest.mark.parametrize("name", ["off SU(3)", "phase i", "one parity",
                                  "interior row"])
def test_antiperiodic_t_refuses_other_gauges(flds, name):
    bad = T(_bad_gauges(flds[0])[name])
    with pytest.raises(ValueError, match="neither periodic nor antiperiodic"):
        dk.antiperiodic_t(double_gauge(bad, GT))
    d = dirac_from_numpy(_bad_gauges(flds[0])[name],
                         DiracParams(**TMC, use_kernels=True), GT)
    with pytest.raises(ValueError, match="neither periodic nor antiperiodic"):
        d.matpc(T(flds[2][0, 0]))


@pytest.fixture(scope="module")
def operators(flds):
    """The port's fused operator and the JAX package's XLA operator on the
    antiperiodic gauge."""
    _, ua, _ = flds
    ours = dirac_from_numpy(ua, DiracParams(**TMC, use_kernels=True), GT)
    ref = jd.make_dirac(ua, jd.DiracParams(**TMC, use_pallas=False), GJ)
    return ours, ref


@pytest.mark.parametrize("op", ["matpc", "matpc dagger", "matpc_dagm", "m"])
def test_fused_operator_matches_jax_xla(operators, flds, op):
    ours, ref = operators
    assert ours._has_fused_matpc and ours.antiperiodic
    psi = flds[2][0]
    if op == "m":
        got, want = ours.m(T(psi)), ref.m(psi)
    elif op == "matpc_dagm":
        got, want = ours.matpc_dagm(T(psi[0])), ref.matpc_dagm(psi[0])
    else:
        dag = op.endswith("dagger")
        got, want = ours.matpc(T(psi[0]), dag), ref.matpc(psi[0], dagger=dag)
    assert rel(got, want) <= F64


_FORMS = {
    "bare": {},
    "clover fwd + xpay + post clover": dict(clover="fwd", xpay=True,
                                            post_op=("clover",)),
    "twist + xpay + post twist": dict(twist=(-0.023, 0.9995), xpay=True,
                                      post_op=("twist", 0.023, 0.9995)),
    "clover dag": dict(clover="dag"),
}


def _hop_kwargs(form, cinv_ch, x_ch):
    f = dict(_FORMS[form])
    kw = dict(twist=f.get("twist"), post_op=f.get("post_op"))
    if "clover" in f:
        kw.update(clover=f["clover"], cinv_ch=cinv_ch)
    if f.get("xpay"):
        kw.update(xpay_coef=-0.0132, x_ch=x_ch)
    return kw


@pytest.fixture(scope="module")
def channels(flds):
    """Both parities' recon-12 and recon-18 float64 gauge channels of the
    antiperiodic gauge, the clover inverse channels and spinor
    channels."""
    _, ua, psi = flds
    ud = double_gauge(T(ua), GT)
    _, cinv = make_clover_pair(T(ua), GT, DiracParams(**TMC))
    g12 = [dk.gauge_channels(ud, p, True, F64_) for p in (0, 1)]
    g18 = [dk.gauge_channels(ud, p, False, F64_) for p in (0, 1)]
    ci = [dk.clover_channels(cinv, p, F64_) for p in (0, 1)]
    v = [[dk.to_channels(T(psi[i, p])) for p in (0, 1)] for i in range(3)]
    return g12, g18, ci, v


@pytest.mark.parametrize("form", list(_FORMS))
@pytest.mark.parametrize("parity,dagger", [(0, False), (1, True)])
def test_recon12_hop_restores_the_sign(channels, form, parity, dagger):
    g12, g18, ci, v = channels
    kw = _hop_kwargs(form, ci[parity], v[1][parity])
    got = dk.dslash_ch(g12[parity], v[0][1 - parity], parity, GT, dagger,
                       recon12=True, antiperiodic=True, **kw)
    ref = dk.dslash_ch(g18[parity], v[0][1 - parity], parity, GT, dagger,
                       recon12=False, **kw)
    lost = dk.dslash_ch(g12[parity], v[0][1 - parity], parity, GT, dagger,
                        recon12=True, **kw)
    got, ref, lost = ((t,) if torch.is_tensor(t) else t
                      for t in (got, ref, lost))
    for a, b, c in zip(got, ref, lost):
        assert rel(a, b) <= F64_HOP
        assert rel(c, b) > 1e-3           # without the sign: another hop


def test_msrc_hop_restores_the_sign(channels):
    g12, g18, ci, v = channels
    batch = torch.stack([v[i][0] for i in range(3)])
    x = torch.stack([v[i][1] for i in range(3)])
    kw = dict(clover="fwd", cinv_ch=ci[1], xpay_coef=-0.0132, x_ch=x,
              post_op=("clover",))
    got = dk.dslash_ch_msrc_reference(g12[1], batch, 1, GT, recon12=True,
                                      antiperiodic=True, **kw)
    ref = dk.dslash_ch_msrc_reference(g18[1], batch, 1, GT, recon12=False,
                                      **kw)
    for a, b in zip(got, ref):
        assert rel(a, b) <= F64_HOP


@pytest.mark.parametrize("rank", [0, 1])
def test_local_hop_rows_on_a_two_way_split(channels, flds, rank):
    """The slab of ``rank`` of a two-way t split: the t-local hop with its
    rows of global t = 0 and T−1 (``ShardedDirac.t_rows``) equals the
    recon-18 hop of the whole lattice on those rows."""
    g12, g18, ci, v = channels
    tl = GT.T // 2
    t0 = rank * tl
    mesh = TMesh(nt=2, rank=rank, device=torch.device("cpu"))
    d = dirac_from_numpy(flds[1], DiracParams(**TMC, use_kernels=True), GT)
    sd = shard_dirac(d, mesh)
    assert sd.antiperiodic and sd.t_rows == (-t0, GT.T - 1 - t0)
    gl = Geometry(GT.X, GT.Y, GT.Z, tl)
    psi = v[0][0]
    rows = slice(t0, t0 + tl)
    face_m = psi[(t0 - 1) % GT.T][None].contiguous()
    face_p = psi[(t0 + tl) % GT.T][None].contiguous()
    for dagger in (False, True):
        got = dk.dslash_ch_local(g12[1][rows].contiguous(),
                                 psi[rows].contiguous(), face_m, face_p, 1,
                                 gl, dagger, recon12=True,
                                 t_boundary=sd.t_rows)
        ref = dk.dslash_ch(g18[1], psi, 1, GT, dagger, recon12=False)[rows]
        assert rel(got, ref) <= F64_HOP


def test_sharded_and_compact_operators_read_the_boundary(flds, operators):
    """``shard_dirac`` (a ring of one: no exchange) and ``make_compact``
    read the boundary from the whole lattice's links; their operators
    are the plain one."""
    _, ua, psi = flds
    ours, ref = operators
    want = ref.matpc(psi[0, 0])
    sd = shard_dirac(ours, TMesh(nt=1, rank=0, device=torch.device("cpu")))
    assert sd.antiperiodic
    assert rel(sd.matpc(T(psi[0, 0])), want) <= F64
    cd = make_compact(T(ua), DiracParams(**TMC), GT, dtype=F64_)
    assert cd.antiperiodic and cd.widened().antiperiodic
    assert rel(cd.matpc(T(psi[0, 0])), want) <= 1e-10
    periodic = make_compact(T(flds[0]), DiracParams(**TMC), GT, dtype=F64_)
    assert not periodic.antiperiodic


def test_recon8_refuses_the_antiperiodic_gauge(flds, channels):
    ud = double_gauge(T(flds[1]), GT)
    with pytest.raises(ValueError, match="recon-8"):
        dk.gauge_channels(ud, 0, False, F32, recon8=True)
    g8 = dk.gauge_channels(double_gauge(T(flds[0]), GT), 0, False, F32,
                           recon8=True)
    v = channels[3][0][1].to(F32)
    with pytest.raises(ValueError, match="recon-8"):
        dk.dslash_ch(g8, v, 0, GT, recon8=True, antiperiodic=True)


def _recording_lib():
    calls = []
    lib = types.SimpleNamespace(**{
        n: (lambda *a, n=n: calls.append((n, a)) or 0)
        for n in _build.ENTRY_POINTS})
    return lib, calls


@pytest.mark.parametrize("antiperiodic", [False, True])
def test_wrappers_hand_the_kernels_the_boundary(channels, antiperiodic):
    """K1 gets bit 2 of its parity argument; the t-local hop the bit and
    the rows of global t = 0 and T−1 (periodic: −1, −1)."""
    g12, _, _, v = channels
    lib, calls = _recording_lib()
    out = torch.empty_like(v[0][0])
    dk._launch(lib, "f64", g12[1], v[0][0], out, None, 1, GT, False, True,
               None, None, None, None, None, None, 0, antiperiodic)
    assert calls[0][1][10] == 1 | (2 if antiperiodic else 0)
    assert dk._parity_arg(0, antiperiodic) == (2 if antiperiodic else 0)
    gl = Geometry(GT.X, GT.Y, GT.Z, 4)
    rows = (-4, 3) if antiperiodic else None
    dk._run_launches(lib, "local_f64", out[:4], dk._k4_launches(
        g12[1][:4], v[0][0][:4], v[0][0][:1], v[0][0][:1], 1, gl, False,
        None, None, None, None, None), None, 0, "K4", rows)
    a = calls[1][1]
    assert a[12] == 1 | (2 if antiperiodic else 0)
    assert a[16:18] == ((-4, 3) if antiperiodic else (-1, -1))


@pytest.mark.cuda
def test_kernels_restore_the_sign_on_the_card(channels):
    """K1 (float32, float64), K2 and K4 on the antiperiodic gauge against
    their plain versions, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the hops are CUDA kernels")
    g12, _, ci, v = channels
    for dt, lim in ((F32, 1e-6), (F64_, 1e-13)):
        g, c = g12[0].to(dt).cuda(), ci[0].to(dt).cuda()
        s, x = v[0][1].to(dt).cuda(), v[1][0].to(dt).cuda()
        kw = dict(recon12=True, antiperiodic=True, clover="fwd", cinv_ch=c,
                  xpay_coef=-0.0132, x_ch=x)
        got = dk.dslash_ch(g, s, 0, GT, **kw)
        ref = dk.dslash_ch_reference(g.cpu(), s.cpu(), 0, GT, **dict(
            kw, cinv_ch=c.cpu(), x_ch=x.cpu()))
        assert rel(got.cpu(), ref) <= lim
    batch = torch.stack([v[i][1] for i in range(3)]).to(F32)
    g, c = g12[0].to(F32), ci[0].to(F32)
    got = dk.dslash_ch_msrc(g.cuda(), batch.cuda(), 0, GT, recon12=True,
                            antiperiodic=True, clover="fwd",
                            cinv_ch=c.cuda())
    ref = dk.dslash_ch_msrc_reference(g, batch, 0, GT, recon12=True,
                                      antiperiodic=True, clover="fwd",
                                      cinv_ch=c)
    assert rel(got.cpu(), ref) <= 1e-6
    gl = Geometry(GT.X, GT.Y, GT.Z, 4)
    psi = v[0][1].to(F32)
    args = (g[4:].contiguous(), psi[4:].contiguous(), psi[3:4].contiguous(),
            psi[:1].contiguous())
    got = dk.dslash_ch_local(*(a.cuda() for a in args), 0, gl, recon12=True,
                             t_boundary=(-4, 3))
    ref = dk.dslash_ch_local_reference(*args, 0, gl, recon12=True,
                                       t_boundary=(-4, 3))
    assert rel(got.cpu(), ref) <= 1e-6
