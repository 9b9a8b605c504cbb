"""The compact MG solve tiers and the HBM-gated MG setup of the port
against the JAX package's, on the CPU.

* ``make_compact(cinv_bf16=True)``: the bf16 A⁻¹ channels bit for bit
  against the JAX build (plain ``jnp``); ``without_clover``.
* ``setup_mg(solve_operator="compact")``: the two tiers against the
  JAX package's ``_solve_tier_operators`` with the north star's
  ``step_cinv_bf16`` and ``resid_drop_clover`` (gauge and clover
  channels bit for bit, A⁻¹ to single precision); ``mg_solve(
  final_resid=False)`` on them against the JAX ``mg_solve`` at 4⁴×8 on
  the same V (JAX's canonical ``setup_mg`` on the same null vectors
  with JAX's own solve tiers).  The JAX ``CompactDirac``'s hop is the
  port's plain hop there (``_plain_v5``, a ``jax.pure_callback``;
  ``tests/test_torch_compact_chain.py`` and ``tests/test_torch_bf16.py``
  hold that hop against the Pallas kernel in interpret mode):
  everything else (the tiers' channels, A and A⁻¹, the step / residual
  split, the V-cycle, GCR) is the JAX package's own code, and no Pallas
  interpret run is needed.  The two V's are complex64 CholQR² results
  of the same vectors, then bf16: iterations within one GCR cycle,
  solutions within 1e-4 of each other and both certified to 5·tol by
  the complex128 operator.
* ``mg.transfer.block_orthonormalize`` (CholQR² in place, the
  canonical and the HBM-gated setup's) against JAX's ``_host_ortho``,
  and ``mg.hbm_setup``'s lean canonical coarse build against JAX's
  ``_host_coarse_build`` on equal null vectors (XLA on the CPU; both in
  single precision, 1e-5 normwise), the null vectors on the compact
  tier, the refusals.
* ``bench_mg(solve_operator="compact")``, ``bench_mg48_dc`` and the
  inner-MG adapter end to end at a tiny size.

Tolerances are normwise relative unless stated.
"""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from quda_qkxtm_multigrid_tpu import compact as jc
from quda_qkxtm_multigrid_tpu import dirac as jd
from quda_qkxtm_multigrid_tpu import lattice as jlat
from quda_qkxtm_multigrid_tpu.mg import hbm_setup as jhbm
from quda_qkxtm_multigrid_tpu.mg import multigrid as jmg
from quda_qkxtm_multigrid_tpu.mg import transfer as jtr
from quda_qkxtm_multigrid_tpu.utils import rng as jrng

from quda_qkxtm_multigrid_tpu_torch import convert
from quda_qkxtm_multigrid_tpu_torch import lattice as tlat
from quda_qkxtm_multigrid_tpu_torch.benchmarks import (
    _c128_true_res, bench_mg, bench_mg48_dc, make_problem)
from quda_qkxtm_multigrid_tpu_torch.compact import (
    invert_compact_full, make_compact)
from quda_qkxtm_multigrid_tpu_torch.convert import spinor_to_numpy as N
from quda_qkxtm_multigrid_tpu_torch.dirac import DiracParams, make_dirac
from quda_qkxtm_multigrid_tpu_torch.mg import hbm_setup as thbm
from quda_qkxtm_multigrid_tpu_torch.mg import multigrid as tmg
from quda_qkxtm_multigrid_tpu_torch.mg import transfer as ttr
from quda_qkxtm_multigrid_tpu_torch.ops.dslash_kernel import (
    dslash_ch_reference)
from quda_qkxtm_multigrid_tpu_torch.utils import rng as trng

T = functools.partial(convert.spinor_from_numpy, device="cpu")

torch.set_num_threads(1)

BF16, F32 = torch.bfloat16, torch.float32
GJ = jlat.Geometry(4, 4, 4, 8)
GT = tlat.Geometry(4, 4, 4, 8)
TMC = dict(kind="twisted-clover", kappa=0.122, mu=0.03, csw=1.0)
NVEC = 6
KW = dict(block=(2, 2, 2, 2), nvec=NVEC, smoother_pc=True, vec_dtype="bf16")
SOLVE = dict(tol=1e-6, n_krylov=5, max_restarts=30, solver="gcr-pc")
SINGLE = 1e-5        # the same single-precision maths in another order
X_VS_JAX = 1e-4      # mg_solve solutions, port vs JAX, each to tol 1e-6
CERT = 5 * SOLVE["tol"]
# A⁻¹ of the complex64 operator, port vs JAX: single precision; its bf16
# rounding moves a few entries by one or more bf16 steps
CINV = {F32: 1e-6, BF16: 1e-4}
# the JAX package's north-star tiers, the port's solve_operator="compact"
JAX_NORTH_STAR = dict(solve_operator="compact", step_cinv_bf16=True,
                      resid_drop_clover=True)


def rel(got, ref) -> float:
    got = N(got) if torch.is_tensor(got) else np.asarray(got)
    ref = N(ref) if torch.is_tensor(ref) else np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.linalg.norm((got - ref).ravel())
                 / np.linalg.norm(ref.ravel()))


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy()


def _jbits(a) -> np.ndarray:
    return np.asarray(jax.lax.bitcast_convert_type(a, jnp.int16))


def _from_np(a) -> torch.Tensor:
    """A JAX or numpy array (bf16 included) as a CPU tensor of its dtype."""
    a = np.asarray(a)
    t = T(a.astype(np.float32))
    return t.to(BF16) if a.dtype == jnp.bfloat16 else t


def _plain_v5(self, parity, psi_ch, interpret=False, out_dtype=jnp.float32,
              **kw):
    """The JAX ``CompactDirac._v5`` hop through the port's plain hop on
    the JAX operator's own channels, a ``jax.pure_callback`` (so it runs
    inside the JAX package's jitted solve programs)."""
    names = [n for n in ("x_ch", "cinv_ch") if kw.get(n) is not None]
    arrays = [kw.pop(n) for n in names]
    o16 = out_dtype == jnp.bfloat16
    rdt = jnp.bfloat16 if o16 else jnp.float32

    def host(g, psi, *rest):
        out = dslash_ch_reference(
            _from_np(g), _from_np(psi), parity, GT, recon12=True,
            out_dtype=BF16 if o16 else None,
            **{n: _from_np(r) for n, r in zip(names, rest)}, **kw)
        return out.to(F32).numpy().astype(rdt)
    return jax.pure_callback(host, jax.ShapeDtypeStruct(psi_ch.shape, rdt),
                             self.g_ch[parity], psi_ch, *arrays)


@pytest.fixture(scope="module")
def flds():
    """Gauge, source and null vectors from the JAX generator, complex64."""
    k = jax.random.split(jax.random.PRNGKey(67), 2 + NVEC)
    u = np.asarray(jrng.random_gauge(k[0], GJ, dtype=jnp.complex64))
    b = np.asarray(jrng.random_spinor(k[1], GJ, dtype=jnp.complex64))
    vs = [np.asarray(jrng.random_spinor(kk, GJ, dtype=jnp.complex64))
          for kk in k[2:]]
    return u, b, vs


def _port_dirac(u):
    return make_dirac(T(u), DiracParams(**TMC), GT)


@pytest.fixture(scope="module")
def jax_canonical(flds):
    """The JAX operator and its canonical preconditioner on the null
    vectors (bf16 V): the solve tiers are added per test."""
    u, _, vs = flds
    dj = jd.make_dirac(jnp.asarray(u), jd.DiracParams(**TMC), GJ)
    mj = jmg.setup_mg(dj, jmg.MGParams(**KW), jax.random.PRNGKey(0),
                      null_vectors=[jnp.asarray(v) for v in vs])
    return dj, mj


def _port_mg(flds, **tiers):
    u, _, vs = flds
    return tmg.setup_mg(_port_dirac(u), tmg.MGParams(**KW, **tiers), None,
                        null_vectors=[T(v) for v in vs])


@pytest.fixture(scope="module")
def jax_compact_mg(jax_canonical):
    """The JAX canonical preconditioner with JAX's own solve tiers, as
    the JAX ``setup_mg(solve_operator="compact")`` of the north star
    assembles it."""
    dj, mj = jax_canonical
    params = jmg.MGParams(**KW, **JAX_NORTH_STAR)
    jr, js = jmg._solve_tier_operators(dj, params)
    return dataclasses.replace(mj, dirac=jr, dirac_sloppy=js, params=params)


@pytest.fixture(scope="module")
def compact_mg(flds):
    return _port_mg(flds, solve_operator="compact")


# ---- compact.py: cinv_bf16 and without_clover --------------------------

def _one_ulp(got: torch.Tensor, want) -> None:
    """bf16 ``got`` equals ``want`` bit for bit or one bf16 ulp apart in
    at most 0.1 % of the entries (the bf16 rounding of single-precision
    results computed in another order)."""
    d = np.abs(_bits(got).astype(np.int32) - _jbits(want).astype(np.int32))
    assert d.max() <= 1 and np.count_nonzero(d) <= d.size // 1000


def test_make_compact_cinv_bf16_matches_jax():
    """The bf16 tier with A⁻¹ in bf16 from a complex128 gauge: every
    channel operand the JAX package's ``make_compact(bf16=True,
    cinv_bf16=True)`` bit for bit; another tier refuses the option."""
    u = np.asarray(jrng.random_gauge(jax.random.PRNGKey(71), GJ,
                                     dtype=jnp.complex128))
    ref = jc.make_compact(jnp.asarray(u), jd.DiracParams(**TMC), GJ,
                          bf16=True, cinv_bf16=True)
    cd = make_compact(T(u), DiracParams(**TMC), GT, BF16, cinv_bf16=True)
    for p in (0, 1):
        for name in ("g_ch", "cinv_ch", "cl_ch"):
            got = getattr(cd, name)[p]
            assert got.dtype == BF16
            np.testing.assert_array_equal(_bits(got),
                                          _jbits(getattr(ref, name)[p]))
    with pytest.raises(ValueError, match="bfloat16 tier"):
        make_compact(T(u), DiracParams(**TMC), GT, F32, cinv_bf16=True)


def test_without_clover_keeps_the_schur_chain(flds):
    """``without_clover`` shares the gauge and A⁻¹: its Schur operator,
    prepare and reconstruct equal the full tier's bit for bit, and what
    needs A raises."""
    u, b, _ = flds
    cd = make_compact(T(u), DiracParams(**TMC), GT, F32)
    lean = cd.without_clover()
    assert lean.cl_ch is None and lean.g_ch is cd.g_ch
    assert lean.cinv_ch is cd.cinv_ch
    bt = T(b)
    xp = cd.prepare(bt)
    assert torch.equal(lean.prepare(bt), xp)
    assert torch.equal(lean.matpc(xp), cd.matpc(xp))
    assert torch.equal(lean.matpc(xp, dagger=True), cd.matpc(xp, True))
    assert torch.equal(lean.reconstruct(xp, bt), cd.reconstruct(xp, bt))
    with pytest.raises(ValueError, match="no clover channels"):
        lean.m(bt)
    with pytest.raises(ValueError, match="no clover channels"):
        lean.a_apply(xp, 0)


# ---- setup_mg and mg_solve on the compact tiers ------------------------

def test_solve_tiers_match_jax(flds, jax_compact_mg, compact_mg):
    """``_solve_tier_operators`` against the JAX package's north-star
    tiers on the same complex64 operator: the residual tier (float32, no
    clover: ``resid_drop_clover``) and the step tier (bf16, A⁻¹ in bf16:
    ``step_cinv_bf16``): the gauge channels bit for bit (a cast of the
    same links), the bf16 clover (made from the complex64 field
    strength in another order) to one ulp, and A⁻¹ (inverted in single
    precision) within ``CINV``: 1e-6 in float32; in bf16 a few small
    entries round to other bf16 values.  ``setup_mg`` holds exactly
    those tiers, no canonical operator, and the bf16 V."""
    u = flds[0]
    jr, js = jax_compact_mg.dirac, jax_compact_mg.dirac_sloppy
    tr, ts = tmg._solve_tier_operators(_port_dirac(u))
    assert tr.cl_ch is None and jr.cl_ch == (None, None)
    for tier_t, tier_j, dt in ((tr, jr, F32), (ts, js, BF16)):
        for name in ("g_ch", "cinv_ch", "cl_ch"):
            got = getattr(tier_t, name)
            if got is None:
                continue
            for p in (0, 1):
                want = getattr(tier_j, name)[p]
                assert got[p].dtype == dt
                if name == "cinv_ch":
                    assert rel(got[p].to(F32),
                               want.astype(jnp.float32)) <= CINV[dt]
                elif name == "cl_ch":
                    _one_ulp(got[p], want)
                else:
                    np.testing.assert_array_equal(
                        N(got[p].to(F32)), np.asarray(want, np.float32))
    mt = compact_mg
    assert mt._dirac_step is mt.dirac_sloppy
    for a, b_ in ((mt.dirac, tr), (mt.dirac_sloppy, ts)):
        for name in ("g_ch", "cinv_ch", "cl_ch"):
            x, y = getattr(a, name), getattr(b_, name)
            assert (x is None and y is None) or torch.equal(x, y)
    assert isinstance(mt.transfer, ttr.Bf16Transfer)
    assert "solve_tiers_secs" in mt.setup_stats


@pytest.mark.parametrize("n_krylov", [5, 3], ids=["gcr5", "gcr3"])
def test_compact_mg_solve_matches_jax(flds, jax_canonical, jax_compact_mg,
                                      compact_mg, n_krylov):
    """``mg_solve(final_resid=False)`` "gcr-pc" on the compact tiers
    against the JAX ``mg_solve`` on the same V with JAX's own north-star
    tiers (module docstring), with GCR(5) (the north star's) and GCR(3)
    (the 48³×96 inner's): the V's bf16 planes equal to one ulp,
    iterations within one GCR cycle, solutions within ``X_VS_JAX``, both
    certified to 5·tol by the complex128 operator, and r2 the Schur
    residual's, below tol² of the prepared source's."""
    u, b, _ = flds
    _, mj = jax_canonical
    mt = compact_mg
    solve = dict(SOLVE, n_krylov=n_krylov)
    for got, want in ((mt.transfer.vr, mj.transfer.v[0]),
                      (mt.transfer.vi, mj.transfer.v[1])):
        _one_ulp(got, want)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jc.CompactDirac, "_v5", _plain_v5)
        oj = jmg.mg_solve(jax_compact_mg, jnp.asarray(b), final_resid=False,
                          **solve)
        xj = np.asarray(oj.x)
    ot = tmg.mg_solve(mt, T(b), final_resid=False, **solve)
    assert abs(ot.iters - int(oj.iters)) <= n_krylov
    assert rel(ot.x, xj) <= X_VS_JAX
    dt = _port_dirac(u)
    for x in (ot.x, T(xj)):
        assert _c128_true_res(dt.u, dt.params, GT, x, T(b)) <= CERT
    src2 = float((mt.dirac.prepare(T(b)).abs() ** 2).sum())
    assert float(ot.r2) <= SOLVE["tol"] ** 2 * src2


def test_compact_steps_run_on_the_sloppy_tier(flds, compact_mg):
    """Every GCR direction and V-cycle operator application is the bf16
    step tier's; prepare, the restart residuals and reconstruct are the
    float32 residual tier's."""
    _, b, _ = flds
    mt = compact_mg
    calls = {"step": 0, "resid": 0}

    def spy(tier, fn):
        def run(*a, **k):
            calls[tier] += 1
            return fn(*a, **k)
        return run
    with pytest.MonkeyPatch.context() as mp:
        for tier, op in (("step", mt.dirac_sloppy), ("resid", mt.dirac)):
            mp.setattr(op, "_hop", spy(tier, op._hop))
        ot = tmg.mg_solve(mt, T(b), final_resid=False, **SOLVE)
    cycles = ot.iters // SOLVE["n_krylov"]
    # prepare 1 hop, reconstruct 1, a residual 2 (the first and one a cycle)
    assert calls["resid"] == 2 + 2 * (cycles + 1)
    assert calls["step"] > 10 * ot.iters


def test_compact_refusals(flds, compact_mg):
    """What the compact tiers do not do raises: a final residual on the
    residual tier (it has no clover), the pair setup and ``shard_mg``."""
    u, b, _ = flds
    with pytest.raises(ValueError, match="no clover channels"):
        tmg.mg_solve(compact_mg, T(b), **SOLVE)
    d = _port_dirac(u)
    with pytest.raises(ValueError, match="setup_mg_pair keeps"):
        tmg.setup_mg_pair(d, d, tmg.MGParams(**KW, solve_operator="compact"),
                          None)
    with pytest.raises(ValueError, match="no sharded form"):
        tmg.shard_mg(compact_mg, None)


def test_generate_null_vectors_orthonormalises_in_place(flds):
    """The canonical setup's null vectors are solved into V's own layout
    and orthonormalised there: ``block_orthonormalize`` gets the
    accumulator and V is that same storage, orthonormal to single
    precision; one multi-source batch of 8 serves nvec 6."""
    u = flds[0]
    d = make_dirac(T(u), DiracParams(**TMC, use_kernels=True), GT)
    bg = ttr.BlockGeometry(GT, 2, 2, 2, 2, nvec=NVEC)
    seen = []

    def spy(v):
        seen.append(v.data_ptr())
        return ttr.block_orthonormalize(v)
    stats = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmg, "block_orthonormalize", spy)
        v = tmg.generate_null_vectors(d, bg, torch.Generator().manual_seed(1),
                                      tmg.MGParams(**KW, setup_tol=1e-3),
                                      stats=stats)
    assert tuple(v.shape) == (2,) + tuple(bg.coarse_shape) + (NVEC, bg.bdof)
    assert seen == [v.data_ptr()]
    assert len(stats["msrc_iters"]) == 1 and tmg.NULL_BATCH == 8
    g = np.einsum("...md,...nd->...mn", N(v).conj(), N(v))
    np.testing.assert_allclose(g, np.broadcast_to(np.eye(NVEC), g.shape),
                               atol=1e-5)


# ---- mg/hbm_setup.py against the JAX package's -------------------------

@pytest.fixture(scope="module")
def hbm_vs(flds):
    u, _, vs = flds
    bgj = jtr.BlockGeometry(GJ, 2, 2, 2, 2, nvec=NVEC)
    bgt = ttr.BlockGeometry(GT, 2, 2, 2, 2, nvec=NVEC)
    vr, vi = jhbm._host_ortho(np.stack(vs), bgj)
    v = torch.empty((2,) + tuple(bgt.coarse_shape) + (NVEC, bgt.bdof),
                    dtype=torch.complex64)
    for i, x in enumerate(vs):
        v[..., i, :] = ttr.to_blocked_flat(T(x), bgt)
    ttr.block_orthonormalize(v)
    return u, bgj, bgt, (vr, vi), v


def test_hbm_ortho_matches_jax_host_ortho(hbm_vs):
    """``block_orthonormalize``, in place a coarse t row at a time, against JAX's
    ``_host_ortho`` (CholQR² of the whole V on the CPU backend), both in
    single precision, and orthonormal to single precision."""
    _, _, _, (vr, vi), v = hbm_vs
    assert rel(v, vr + 1j * vi) <= SINGLE
    g = np.einsum("...md,...nd->...mn", N(v).conj(), N(v))
    np.testing.assert_allclose(g, np.broadcast_to(np.eye(NVEC), g.shape),
                               atol=1e-5)


def test_hbm_coarse_matches_jax_host_coarse_build(hbm_vs):
    """The level-1 build against the lean complex64 operator
    (``coarse_from_lean``) against JAX's ``_host_coarse_build`` on the
    same V (JAX's planar pair, read as complex64)."""
    u, bgj, bgt, vj, _ = hbm_vs
    cj = jhbm._host_coarse_build(u, jd.DiracParams(**TMC), GJ, vj, bgj)
    v = torch.complex(T(vj[0]), T(vj[1]))
    ct = thbm.coarse_from_lean(T(u), DiracParams(**TMC), GT,
                               ttr.Transfer(v=v, bg=bgt))
    assert ct.x.dtype == torch.complex64
    assert rel(ct.x.permute(1, 2, 0), cj.x) <= SINGLE
    assert rel(ct.y.permute(0, 2, 3, 1), cj.y) <= SINGLE


def test_lean_canonical_holds_no_inverse(flds):
    u = flds[0]
    d = thbm.lean_canonical(T(u).to(torch.complex128), DiracParams(**TMC),
                            GT)
    assert d.u.dtype == torch.complex64 and d.clover.dtype == torch.complex64
    assert d.clover_inv is None and d.u_doubled is None
    assert not d.params.use_kernels


def test_null_vectors_on_the_compact_tier(flds):
    """Each column of the accumulator is ``invert_compact_full``'s
    solution from the generator's next source, blocked."""
    u = flds[0]
    cd = tmg.step_tier(T(u), DiracParams(**TMC), GT)
    bg = ttr.BlockGeometry(GT, 2, 2, 2, 2, nvec=3)
    mgp = tmg.MGParams(**dict(KW, nvec=3), setup_tol=1e-3, setup_maxiter=60)
    stats = {}
    v = thbm.generate_null_vectors_device(
        cd, mgp, torch.Generator().manual_seed(5), bg, stats)
    assert tuple(v.shape) == (2,) + tuple(bg.coarse_shape) + (3, bg.bdof)
    gen = torch.Generator().manual_seed(5)
    for i in range(3):
        b = trng.random_spinor(gen, GT, torch.complex64)
        x = invert_compact_full(cd, b, tol=1e-3, maxiter=60).x
        assert torch.equal(v[..., i, :], ttr.to_blocked_flat(x, bg))
    assert len(stats["cg_iters"]) == 3 and stats["null_true_res"] < 1e-2


@pytest.mark.parametrize("kw", [dict(n_level=3),
                                dict(solve_operator="canonical"),
                                dict(delta_mu_coarse=2.0),
                                dict(vec_outfile="v.npz")])
def test_setup_mg_hbm_refuses(flds, kw):
    u = flds[0]
    mgp = tmg.MGParams(**{**KW, "solve_operator": "compact", **kw})
    with pytest.raises(ValueError, match="two levels on the compact"):
        thbm.setup_mg_hbm(T(u), DiracParams(**TMC), GT, mgp,
                          torch.Generator())


# ---- end to end at a tiny size -----------------------------------------

def test_bench_mg_compact_small():
    """``bench_mg`` with the north star's tiers on the CPU at 4⁴×8: the
    complex128 certificate and its record; no final residual of the
    solve's own."""
    rec, mg = bench_mg(GT, nvec=4, block=(2, 2, 2, 2), vec_dtype="bf16",
                       problem=make_problem(GT, "cpu",
                                            dtype=torch.complex64),
                       solve_operator="compact")
    assert rec["iters"] == rec["iters_cold"] > 0
    assert rec["true_res"] <= 5e-7 and rec["true_res_solve"] is None
    assert rec["solve_operator"] == "compact"
    assert rec["solve_tiers_secs"] > 0 and rec["peak_mem_bytes"] is None
    assert mg.dirac.cl_ch is None and mg.dirac_sloppy.cinv_ch.dtype == BF16


def test_bench_mg48_dc_small():
    """``bench_mg48_dc`` at 8⁴ with nvec 4: certified to tol 1e-8 in
    complex128 by the float64 outer, not diverged, each restart one
    inner GCR(3) cycle or more, the setup split recorded."""
    rec, mg = bench_mg48_dc(tlat.Geometry(8, 8, 8, 8), nvec=4, device="cpu")
    assert rec["true_res"] <= 1e-8 and not rec["diverged"]
    assert rec["restarts"] == len(rec["inner_iters_each"])
    assert rec["inner_iters"] == sum(rec["inner_iters_each"])
    assert min(rec["inner_iters_each"]) >= 3
    assert rec["history"][0] == pytest.approx(1.0)
    for k in ("build_compact_secs", "null_vectors_secs", "ortho_secs",
              "coarse_secs", "cast_secs", "exact_build_secs", "secs",
              "resid_secs"):
        assert rec[k] > 0, k
    assert isinstance(mg.transfer, ttr.Bf16Transfer)
    assert mg.params.solve_operator == "compact"
    assert mg.dirac_sloppy is mg.dirac and mg.dirac.cinv_ch.dtype == BF16


def test_inner_mg_caps_its_restarts(flds, compact_mg):
    """``inner_mg``'s ``solve_lo`` returns the complex64 correction and
    its iterations, at most ``cap`` of them in whole GCR cycles (one
    cycle at least)."""
    _, b, _ = flds
    mt = compact_mg
    solve_lo = tmg.inner_mg(mt, tol=1e-12, max_restarts=4, n_krylov=2)
    r = T(b).to(torch.complex128)
    e = solve_lo(r, 100)
    assert e.x.dtype == torch.complex64 and e.iters == 8
    assert solve_lo(r, 5).iters == 4
    assert solve_lo(r, 1).iters == 2
