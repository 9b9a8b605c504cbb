"""The port's two-level multigrid against the JAX package's, on the same
complex128 fields at Geometry(4,4,4,8) with 2⁴ blocks (the sizes of
``tests/test_multigrid.py``): the blocked layouts (bit-exact), the
orthonormalised V, restrict / prolong, the coarse operator (direct build
against JAX and against the probing oracle, and its application), the
V-cycle, and ``mg_solve`` with the three outer solvers from the same
null vectors (same iteration count, solution to 1e-8).  Also: a JAX
``vec_outfile`` read by the port, the converter for the JAX package's MG
state, the MG options that are not ported, and ``bench_mg`` at a tiny
size.  Tolerances are normwise relative.
"""

import functools
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from quda_qkxtm_multigrid_tpu import dirac as jd
from quda_qkxtm_multigrid_tpu import lattice as jlat
from quda_qkxtm_multigrid_tpu.mg import multigrid as jmg
from quda_qkxtm_multigrid_tpu.mg import transfer as jtr
from quda_qkxtm_multigrid_tpu.ops import dslash as jdsl
from quda_qkxtm_multigrid_tpu.utils import rng as jrng

from quda_qkxtm_multigrid_tpu_torch import lattice as tlat
from quda_qkxtm_multigrid_tpu_torch.benchmarks import bench_mg, make_problem
from quda_qkxtm_multigrid_tpu_torch import convert
from quda_qkxtm_multigrid_tpu_torch.convert import spinor_to_numpy as N
from quda_qkxtm_multigrid_tpu_torch.dirac import DiracParams
from quda_qkxtm_multigrid_tpu_torch.mg import coarse_op as tco
from quda_qkxtm_multigrid_tpu_torch.mg import multigrid as tmg
from quda_qkxtm_multigrid_tpu_torch.mg import transfer as ttr
from quda_qkxtm_multigrid_tpu_torch.ops import dslash as tdsl
from quda_qkxtm_multigrid_tpu_torch.utils import checkpoint as tckpt

# the tests run on the CPU; the converters default to the card
dirac_from_numpy = functools.partial(convert.dirac_from_numpy, device="cpu")
T = functools.partial(convert.spinor_from_numpy, device="cpu")
transfer_from_numpy = functools.partial(
    convert.transfer_from_numpy, device="cpu")

torch.set_num_threads(1)

GJ = jlat.Geometry(4, 4, 4, 8)
GT = tlat.Geometry(4, 4, 4, 8)
NVEC = 4
BJ = jtr.BlockGeometry(GJ, 2, 2, 2, 2, nvec=NVEC)
BT = ttr.BlockGeometry(GT, 2, 2, 2, 2, nvec=NVEC)
TMC = dict(kind="twisted-clover", kappa=0.122, mu=0.03, csw=1.0)
EXACT = 1e-13      # layout moves and the same sums in another order
SOLVE_TOL = 1e-8   # mg_solve solutions, port vs JAX


def rel(got, ref) -> float:
    got = N(got) if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.linalg.norm((got - ref).ravel())
                 / np.linalg.norm(ref.ravel()))


def _coarse_jax_layout(op) -> tuple:
    """The port's site-major X, Y in the JAX package's [.., dof, dof,
    cvol] layout."""
    return N(op.x.permute(1, 2, 0)), N(op.y.permute(0, 2, 3, 1))


@pytest.fixture(scope="module")
def flds():
    k = jax.random.split(jax.random.PRNGKey(61), 3 + 6)
    u = np.asarray(jrng.random_gauge(k[0], GJ))
    psi = np.asarray(jrng.random_spinor(k[1], GJ))
    b = np.asarray(jrng.random_spinor(k[2], GJ))
    vs = [np.asarray(jrng.random_spinor(kk, GJ)) for kk in k[3:]]
    return u, psi, b, vs


@pytest.fixture(scope="module")
def transfers(flds):
    _, _, _, vs = flds
    vj = jtr.block_orthonormalize_flat(
        jnp.stack([jtr.to_blocked_flat(v, BJ) for v in vs[:NVEC]]))
    return jtr.Transfer(v=vj, bg=BJ), transfer_from_numpy(
        np.stack(vs[:NVEC]), BT)


def _coarse_vec(seed):
    r = np.random.default_rng(seed)
    shape = (2, NVEC) + BJ.coarse_shape
    return r.standard_normal(shape) + 1j * r.standard_normal(shape)


# ---- layouts ----------------------------------------------------------

def test_lex_dof_leading_matches_jax(flds):
    psi = flds[1]
    got = tlat.spinor_to_lex_dof_leading(T(psi), GT)
    assert rel(got, jlat.spinor_to_lex_dof_leading(psi, GJ)) == 0.0
    back = tlat.spinor_from_lex_dof_leading(got, GT)
    assert rel(back, psi) == 0.0


def test_blocked_layout_matches_jax(flds):
    psi = flds[1]
    got = ttr.to_blocked_flat(T(psi), BT)
    assert rel(got, jtr.to_blocked_flat(psi, BJ)) == 0.0
    assert rel(ttr.from_blocked_flat(got, BT), psi) == 0.0


def test_blocked_flat_takes_batches(flds):
    vs = np.stack(flds[3][:3])
    got = ttr.to_blocked_flat(T(vs), BT)
    ref = np.stack([np.asarray(jtr.to_blocked_flat(v, BJ)) for v in vs])
    assert rel(got, ref) == 0.0
    assert rel(ttr.from_blocked_flat(got, BT), vs) == 0.0


# ---- transfer ---------------------------------------------------------

def test_block_orthonormalize_matches_jax(transfers):
    tj, tt = transfers
    vj = np.asarray(tj.v[0]) + 1j * np.asarray(tj.v[1])
    assert rel(tt.v, vj) <= EXACT
    g = np.einsum("...md,...nd->...mn", N(tt.v).conj(), N(tt.v))
    np.testing.assert_allclose(g, np.broadcast_to(np.eye(NVEC), g.shape),
                               atol=1e-13)


def test_restrict_prolong_match_jax(flds, transfers):
    tj, tt = transfers
    psi = flds[1]
    vc = _coarse_vec(1)
    assert rel(tt.restrict(T(psi)), tj.restrict(psi)) <= EXACT
    assert rel(tt.prolong(T(vc)), tj.prolong(vc)) <= EXACT
    # R P = 1 on an orthonormal V
    assert rel(tt.restrict(tt.prolong(T(vc))), vc) <= EXACT


def test_transfer_from_planar_pair(transfers):
    tj, tt = transfers
    got = transfer_from_numpy(tuple(np.asarray(a) for a in tj.v), BT)
    assert rel(got.v, tt.v) <= EXACT


def test_hop_apply_matches_jax(flds):
    u, psi = flds[0], flds[1]
    for mu in range(4):
        for sign in (+1, -1):
            got = tdsl.hop_apply(T(u), T(psi), mu, sign, GT)
            assert rel(got, jdsl.hop_apply(u, psi, mu, sign, GJ)) <= EXACT


# ---- coarse operator --------------------------------------------------

@pytest.fixture(scope="module")
def coarse_ops(flds, transfers):
    tj, tt = transfers
    u = flds[0]
    dj = jd.make_dirac(u, jd.DiracParams(**TMC), GJ)
    dt = dirac_from_numpy(u, DiracParams(**TMC), GT)
    return jmg._build_level1(tj, dj), tmg._build_level1(tt, dt), dt


def test_coarse_build_matches_jax(coarse_ops):
    cj, ct, _ = coarse_ops
    x, y = _coarse_jax_layout(ct)
    assert rel(x, cj.x) <= EXACT
    assert rel(y, cj.y) <= EXACT


def test_coarse_build_matches_probing_oracle(coarse_ops, transfers):
    _, ct, dt = coarse_ops
    diag, hops = tmg._level1_terms(dt)
    probe = tco.build_coarse_op(transfers[1], diag, hops, torch.complex128)
    assert rel(probe.x, N(ct.x)) <= EXACT
    assert rel(probe.y, N(ct.y)) <= EXACT


def test_coarse_apply_matches_jax_and_galerkin(coarse_ops, transfers):
    cj, ct, dt = coarse_ops
    vc = _coarse_vec(2)
    assert rel(ct.apply(T(vc)), cj.apply(vc)) <= EXACT
    tt = transfers[1]
    galerkin = tt.restrict(dt.m(tt.prolong(T(vc))))
    assert rel(ct.apply(T(vc)), N(galerkin)) <= 1e-12
    assert ct.flops_per_apply() == cj.flops_per_apply()


# ---- V-cycle and the outer solves ------------------------------------

@pytest.fixture(scope="module")
def mg_pair(flds):
    u, _, _, vs = flds
    kw = dict(block=(2, 2, 2, 2), nvec=6, smoother_pc=True)
    dj = jd.make_dirac(u, jd.DiracParams(**TMC), GJ)
    dt = dirac_from_numpy(u, DiracParams(**TMC), GT)
    mj = jmg.setup_mg(dj, jmg.MGParams(**kw), jax.random.PRNGKey(0),
                      null_vectors=vs)
    mt = tmg.setup_mg(dt, tmg.MGParams(**kw), None,
                      null_vectors=[T(v) for v in vs])
    return mj, mt


def test_vcycle_matches_jax(flds, mg_pair):
    mj, mt = mg_pair
    b = flds[2]
    assert rel(mt.vcycle(T(b)), mj.vcycle(b)) <= 1e-12


@pytest.mark.parametrize("solver", ["gcr-pc", "gcr", "mr-richardson"])
def test_mg_solve_matches_jax(flds, mg_pair, solver):
    mj, mt = mg_pair
    b = flds[2]
    kw = dict(tol=1e-8, n_krylov=5, max_restarts=30, solver=solver)
    oj = jmg.mg_solve(mj, b, **kw)
    ot = tmg.mg_solve(mt, T(b), **kw)
    assert ot.iters == int(oj.iters)
    assert rel(ot.x, oj.x) <= SOLVE_TOL
    r = T(b) - mt.dirac.m(ot.x)
    assert float(r.norm() / T(b).norm()) <= 1e-7


def test_delta_knobs(flds):
    """delta_*_coarse builds the coarse level from the rescaled operator,
    delta_*_pr gives the smoother its own rescaled operator (the JAX
    package's ``_delta_scaled``): the coarse operator equals the one
    built directly on a Dirac with the scaled parameters."""
    u, _, _, vs = flds
    kw = dict(block=(2, 2, 2, 2), nvec=NVEC, smoother_pc=True)
    mt = tmg.setup_mg(dirac_from_numpy(u, DiracParams(**TMC), GT),
                      tmg.MGParams(delta_mu_coarse=3.0,
                                   delta_kappa_coarse=0.98, delta_mu_pr=1.5,
                                   delta_csw_pr=0.9, **kw), None,
                      null_vectors=[T(v) for v in vs[:NVEC]])
    scaled = dict(TMC, mu=TMC["mu"] * 3.0, kappa=TMC["kappa"] * 0.98)
    ref = tmg._build_level1(mt.transfer,
                            dirac_from_numpy(u, DiracParams(**scaled), GT))
    assert rel(mt.coarse.x, N(ref.x)) == 0.0
    assert rel(mt.coarse.y, N(ref.y)) == 0.0
    pr = mt.dirac_pr.params
    assert (pr.mu, pr.kappa, pr.csw) == (TMC["mu"] * 1.5, TMC["kappa"],
                                         TMC["csw"] * 0.9)
    assert mt._dirac_smooth is mt.dirac_pr
    plain = tmg.setup_mg(mt.dirac, tmg.MGParams(**kw), None,
                         null_vectors=[T(v) for v in vs[:NVEC]])
    assert plain.dirac_pr is None


def test_vec_outfile_of_jax_gives_same_coarse_op(tmp_path, flds):
    """The JAX package writes V with ``vec_outfile``; the port reads it
    with ``vec_infile`` (skipping generation) and builds the same coarse
    operator."""
    u = flds[0]
    path = str(tmp_path / "nullvecs.npz")
    kw = dict(block=(2, 2, 2, 2), nvec=NVEC, setup_tol=1e-3,
              setup_maxiter=20)
    mj = jmg.setup_mg(jd.make_dirac(u, jd.DiracParams(**TMC), GJ),
                      jmg.MGParams(vec_outfile=path, **kw),
                      jax.random.PRNGKey(3))
    mt = tmg.setup_mg(dirac_from_numpy(u, DiracParams(**TMC), GT),
                      tmg.MGParams(vec_infile=path, **kw), None)
    assert "null_vector_secs" not in mt.setup_stats
    x, y = _coarse_jax_layout(mt.coarse)
    assert rel(x, mj.coarse.x) <= EXACT
    assert rel(y, mj.coarse.y) <= EXACT


def test_vec_outfile_round_trip(tmp_path, flds):
    """The port's own file: the JAX package's format, read back as it
    was written."""
    u = flds[0]
    path = str(tmp_path / "v.npz")
    d = dirac_from_numpy(u, DiracParams(**TMC), GT)
    kw = dict(block=(2, 2, 2, 2), nvec=NVEC, setup_tol=1e-3,
              setup_maxiter=20)
    m1 = tmg.setup_mg(d, tmg.MGParams(vec_outfile=path, **kw),
                      torch.Generator().manual_seed(4))
    assert m1.setup_stats["bicgstab_iters"]
    a = tckpt.load_null_vectors(path)
    assert a.shape == (2,) + BT.coarse_shape + (NVEC, BT.bdof)
    m2 = tmg.setup_mg(d, tmg.MGParams(vec_infile=path, **kw), None)
    assert rel(m2.transfer.v, N(m1.transfer.v)) == 0.0


@pytest.mark.parametrize("kw,match", [
    (dict(n_level=3), "three- and four-level MG item"),
    (dict(vec_dtype="bf16"), "bf16 null-vector item"),
    (dict(solve_operator="compact"), "not ported on purpose"),
    (dict(outer_solver="cg"), "outer_solver")])
def test_mg_params_refuse_what_is_not_ported(kw, match):
    with pytest.raises(ValueError, match=match):
        tmg.MGParams(**kw)


def test_bench_mg_small():
    """``bench_mg`` end to end on the CPU at a tiny size: the complex64
    problem, null vectors through ``invert_msrc`` on the fused chain
    (plain versions on the CPU), converged and certified in
    complex128."""
    d, b = make_problem(GT, "cpu", dtype=torch.complex64)
    rec, mg = bench_mg(GT, nvec=NVEC, block=(2, 2, 2, 2), problem=(d, b))
    assert rec["iters"] == rec["iters_cold"] > 0
    assert rec["true_res"] <= 5e-7
    assert len(rec["msrc_iters"]) == 1 and rec["msrc_iters"][0] > 0
    assert rec["null_true_res"] < 1e-4
    assert rec["peak_mem_bytes"] is None
    for k in ("setup_secs", "null_vector_secs", "ortho_secs",
              "coarse_build_secs", "secs", "gflops"):
        assert rec[k] > 0
    assert mg.transfer.v.dtype == torch.complex64
