"""The port's three- and four-level multigrid and its bf16 null-vector
storage against the JAX package's, at the sizes of the JAX package's
``TestThreeLevel`` / ``TestFourLevel`` (Geometry(4,4,4,8), 2⁴ blocks,
then (1,1,1,2) and (2,1,1,1) on the coarse lattices, where a block
extent of 1 makes both face masks of its direction all ones).

The JAX package's MG state (V, the coarse operators, V2, V3) crosses as
numpy through ``convert``, so both packages compute on the same inputs,
in complex128 unless stated: the blocked coarse layouts (bit for bit),
CholQR² over (bv, nc) (1e-12), restrict / prolong between coarse levels
(1e-12), the coarse-of-coarse builds (1e-10), the port's own Galerkin
identities (1e-10), the three- and four-level V-cycle (1e-10) and
``mg_solve`` (JAX's iterations, solution to 1e-8); the port's own setup
converging as JAX's tests do; the bf16 tier against the JAX package's
bf16 ``Transfer._ein`` (float32 accumulation in another order, 1e-6) and
its solve; the pair's shared V and level-2 sources; the CLI on three
levels.  Tolerances are normwise relative.
"""

import dataclasses
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
from quda_qkxtm_multigrid_tpu.utils import rng as jrng

from quda_qkxtm_multigrid_tpu_torch import cli
from quda_qkxtm_multigrid_tpu_torch import convert
from quda_qkxtm_multigrid_tpu_torch import lattice as tlat
from quda_qkxtm_multigrid_tpu_torch.convert import spinor_to_numpy as N
from quda_qkxtm_multigrid_tpu_torch.dirac import DiracParams
from quda_qkxtm_multigrid_tpu_torch.mg import coarse_op as tco
from quda_qkxtm_multigrid_tpu_torch.mg import multigrid as tmg
from quda_qkxtm_multigrid_tpu_torch.mg import transfer as ttr

# the tests run on the CPU; the converters default to the card
dirac_from_numpy = functools.partial(convert.dirac_from_numpy, device="cpu")
T = functools.partial(convert.spinor_from_numpy, device="cpu")
coarse_op_from_numpy = functools.partial(convert.coarse_op_from_numpy,
                                         device="cpu")
coarse_transfer_from_numpy = functools.partial(
    convert.coarse_transfer_from_numpy, device="cpu")
transfer_from_numpy = functools.partial(convert.transfer_from_numpy,
                                        device="cpu")

torch.set_num_threads(1)

GJ = jlat.Geometry(4, 4, 4, 8)
GT = tlat.Geometry(4, 4, 4, 8)
TM = dict(kind="twisted-mass", kappa=0.12, mu=0.05)
# the JAX package's TestFourLevel settings (TestThreeLevel's, plus level 3)
LEVELS = dict(block=(2, 2, 2, 2), nvec=4, setup_maxiter=50, setup_tol=1e-3,
              block2=(1, 1, 1, 2), nvec2=3, setup2_maxiter=50,
              block3=(2, 1, 1, 1), nvec3=2, setup3_maxiter=30)
EXACT = 1e-12      # layout moves and the same sums in another order
BUILD = 1e-10      # the coarse-of-coarse builds, V-cycles, Galerkin
SOLVE_TOL = 1e-8   # mg_solve solutions, port vs JAX


def rel(got, ref) -> float:
    got = N(got) if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.linalg.norm((got - ref).ravel())
                 / np.linalg.norm(ref.ravel()))


def _cplx(rng, shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _bg(jbg) -> ttr.CoarseBlockGeometry:
    """The port's geometry of a JAX ``CoarseBlockGeometry``."""
    return ttr.CoarseBlockGeometry(
        tuple(jbg.fine_shape), jbg.fine_ns, jbg.fine_nc, jbg.bx, jbg.by,
        jbg.bz, jbg.bt, jbg.nvec)


@pytest.fixture(scope="module")
def jax_mg():
    """The JAX package's four-level setup of ``TestFourLevel``: the gauge
    (numpy), and the preconditioner, whose levels 1–3 the tests read."""
    u = np.asarray(jrng.random_gauge(jax.random.PRNGKey(4), GJ))
    dj = jd.make_dirac(u, jd.DiracParams(**TM), GJ)
    mg = jmg.setup_mg(dj, jmg.MGParams(n_level=4, **LEVELS),
                      jax.random.PRNGKey(31))
    return u, mg


@pytest.fixture(scope="module")
def port_mg(jax_mg):
    """The port's four-level preconditioner on the JAX package's V, V2
    and V3; its coarse operators built by the port."""
    u, mj = jax_mg
    bg = ttr.BlockGeometry(GT, 2, 2, 2, 2, nvec=LEVELS["nvec"])
    tr = transfer_from_numpy(tuple(np.asarray(a) for a in mj.transfer.v), bg)
    dt = dirac_from_numpy(u, DiracParams(**TM), GT)
    mt = tmg._preconditioner(tr, dt, tmg.MGParams(n_level=4, **LEVELS), {})
    mt.transfer2 = coarse_transfer_from_numpy(np.asarray(mj.transfer2.v),
                                              _bg(mj.transfer2.bg))
    mt.coarse2 = tmg._build_level2(mt.transfer2, mt.coarse)
    mt.transfer3 = coarse_transfer_from_numpy(np.asarray(mj.transfer3.v),
                                              _bg(mj.transfer3.bg))
    mt.coarse3 = tmg._build_level2(mt.transfer3, mt.coarse2)
    return mt


def _three(mg):
    """The three-level preconditioner inside a four-level one."""
    return dataclasses.replace(mg, transfer3=None, coarse3=None)


# ---- the dof-generic transfer ------------------------------------------

def test_coarse_block_geometry(jax_mg):
    jbg = jax_mg[1].transfer2.bg
    bg = _bg(jbg)
    assert bg.coarse_shape == tuple(jbg.coarse_shape)
    assert bg.block_volume == jbg.block_volume
    assert bg.coarse_dof == jbg.coarse_dof
    assert bg.coarse_volume == int(np.prod(jbg.coarse_shape))
    with pytest.raises(ValueError, match="block does not divide"):
        ttr.CoarseBlockGeometry((4, 2, 2, 2), 2, 4, bx=1, by=1, bz=1, bt=3)


@pytest.mark.parametrize("level", [2, 3])
def test_blocked_coarse_matches_jax(jax_mg, level):
    jbg = getattr(jax_mg[1], f"transfer{level}").bg
    bg = _bg(jbg)
    vc = _cplx(np.random.default_rng(level),
               (2, bg.fine_nc) + tuple(bg.fine_shape))
    got = ttr.to_blocked_coarse(T(vc), bg)
    assert rel(got, jtr.to_blocked_coarse(vc, jbg)) == 0.0
    assert rel(ttr.from_blocked_coarse(got, bg), vc) == 0.0
    batch = np.stack([vc, 2 * vc])          # a leading batch axis
    assert rel(ttr.to_blocked_coarse(T(batch), bg),
               np.stack([np.asarray(jtr.to_blocked_coarse(v, jbg))
                         for v in batch])) == 0.0


def test_block_orthonormalize_coarse_matches_jax():
    v = _cplx(np.random.default_rng(5), (4, 2, 2, 2, 2, 8, 2, 6))
    got = ttr.block_orthonormalize_coarse(T(v))
    assert rel(got, jtr.block_orthonormalize_coarse(v)) <= EXACT
    g = np.einsum("m...bsc,n...bsc->...smn", N(got).conj(), N(got))
    np.testing.assert_allclose(g, np.broadcast_to(np.eye(4), g.shape),
                               atol=1e-13)


@pytest.mark.parametrize("level", [2, 3])
def test_coarse_transfer_matches_jax(jax_mg, port_mg, level):
    tj = getattr(jax_mg[1], f"transfer{level}")
    tt = getattr(port_mg, f"transfer{level}")
    bg = tt.bg
    rng = np.random.default_rng(10 + level)
    vc = _cplx(rng, (2, bg.fine_nc) + tuple(bg.fine_shape))
    vc2 = _cplx(rng, (2, bg.nvec) + tuple(bg.coarse_shape))
    assert rel(tt.restrict(T(vc)), tj.restrict(vc)) <= EXACT
    assert rel(tt.prolong(T(vc2)), tj.prolong(vc2)) <= EXACT
    assert rel(tt.restrict(tt.prolong(T(vc2))), vc2) <= EXACT   # R P = 1


# ---- the coarse-of-coarse operators --------------------------------------

def test_level1_matches_jax(jax_mg, port_mg):
    cj = jax_mg[1].coarse
    conv = coarse_op_from_numpy(np.asarray(cj.x), np.asarray(cj.y),
                                port_mg.coarse.bg)
    assert rel(port_mg.coarse.x, N(conv.x)) <= EXACT
    assert rel(port_mg.coarse.y, N(conv.y)) <= EXACT


@pytest.mark.parametrize("level", [2, 3])
def test_coarse_build_matches_jax(jax_mg, level):
    """The level's operator built by the port from the JAX package's
    operator one level up and its V equals the JAX package's."""
    mj = jax_mg[1]
    up = mj.coarse if level == 2 else mj.coarse2
    up_bg = (ttr.BlockGeometry(GT, 2, 2, 2, 2, nvec=LEVELS["nvec"])
             if level == 2 else _bg(mj.transfer2.bg))
    tj = getattr(mj, f"transfer{level}")
    cj = getattr(mj, f"coarse{level}")
    got = tmg._build_level2(
        coarse_transfer_from_numpy(np.asarray(tj.v), _bg(tj.bg)),
        coarse_op_from_numpy(np.asarray(up.x), np.asarray(up.y), up_bg))
    ref = coarse_op_from_numpy(np.asarray(cj.x), np.asarray(cj.y),
                               _bg(tj.bg))
    assert rel(got.x, N(ref.x)) <= BUILD
    assert rel(got.y, N(ref.y)) <= BUILD


@pytest.mark.parametrize("level", [2, 3])
def test_galerkin_identity(port_mg, level):
    tr = getattr(port_mg, f"transfer{level}")
    up = port_mg.coarse if level == 2 else port_mg.coarse2
    op = getattr(port_mg, f"coarse{level}")
    w = T(_cplx(np.random.default_rng(20 + level),
                (2, tr.bg.nvec) + tuple(tr.bg.coarse_shape)))
    assert rel(op.apply(w), N(tr.restrict(up.apply(tr.prolong(w))))) <= BUILD
    assert op.flops_per_apply() == (8 * 8 * op.bg.coarse_dof ** 2
                                    - 2 * op.bg.coarse_dof) \
        * op.bg.coarse_volume


def test_diag_hops_sum_to_apply(port_mg):
    """``coarse_diag_hops``: the diagonal and the 8 hop terms add up to
    the operator, on a batch of fields as on one."""
    op = port_mg.coarse2
    diag, hops = tco.coarse_diag_hops(op)
    w = T(_cplx(np.random.default_rng(7),
                (3, 2, op.bg.nvec) + tuple(op.bg.coarse_shape)))
    total = diag(w) + sum(h(w) for h in hops)
    assert rel(total, np.stack([N(op.apply(v)) for v in w])) <= EXACT


# ---- V-cycles and solves --------------------------------------------------

@pytest.mark.parametrize("levels", [3, 4])
def test_vcycle_matches_jax(jax_mg, port_mg, levels):
    mj, mt = jax_mg[1], port_mg
    if levels == 3:
        mj, mt = _three(mj), _three(mt)
    r = np.asarray(jrng.random_spinor(jax.random.PRNGKey(8), GJ))
    assert rel(mt.vcycle(T(r)), mj.vcycle(r)) <= BUILD


@pytest.mark.parametrize("levels", [3, 4])
def test_mg_solve_matches_jax(jax_mg, port_mg, levels):
    """On equal null vectors at every level the port takes the JAX
    package's outer iterations."""
    mj, mt = jax_mg[1], port_mg
    if levels == 3:
        mj, mt = _three(mj), _three(mt)
    b = np.asarray(jrng.random_spinor(jax.random.PRNGKey(34), GJ))
    kw = dict(tol=1e-7, n_krylov=8, max_restarts=30)
    oj = jmg.mg_solve(mj, b, **kw)
    ot = tmg.mg_solve(mt, T(b), **kw)
    assert ot.iters == int(oj.iters) > 0
    assert rel(ot.x, oj.x) <= SOLVE_TOL


@pytest.mark.parametrize("levels,limit", [(3, 1e-6), (4, 1e-5)])
def test_mg_solve_converges(levels, limit):
    """The port's own setup (its generator's sources at every level) at
    the JAX package's test settings converges as JAX's does
    (``TestThreeLevel.test_three_level_solve_converges``,
    ``TestFourLevel``)."""
    if levels == 3:
        seed, tm = 6, dict(kind="twisted-mass", kappa=0.122, mu=0.03)
        p = tmg.MGParams(block=(2, 2, 2, 2), nvec=6, setup_tol=1e-4,
                         setup_maxiter=200, nu_post=4, n_level=3,
                         block2=(1, 1, 1, 2), nvec2=4, setup2_maxiter=100,
                         coarse2_nkrylov=6)
        kw = dict(tol=1e-8, n_krylov=10, max_restarts=30)
    else:
        seed, tm = 4, TM
        p = tmg.MGParams(n_level=4, **LEVELS)
        kw = dict(tol=1e-7, n_krylov=8, max_restarts=30)
    u = np.asarray(jrng.random_gauge(jax.random.PRNGKey(seed), GJ))
    d = dirac_from_numpy(u, DiracParams(**tm), GT)
    mg = tmg.setup_mg(d, p, torch.Generator().manual_seed(7))
    st = mg.setup_stats
    assert all(i > 0 for i in st["level2"]["bicgstab_iters"])
    assert ("level3" in st) == (levels == 4)
    b = T(np.asarray(jrng.random_spinor(jax.random.PRNGKey(8), GJ)))
    out = tmg.mg_solve(mg, b, **kw)
    r = b - d.m(out.x)
    assert float(r.norm() / b.norm()) < limit


def test_setup_needs_a_generator_below_level_one(jax_mg):
    u = jax_mg[0]
    d = dirac_from_numpy(u, DiracParams(**TM), GT)
    vs = [T(np.asarray(jrng.random_spinor(jax.random.PRNGKey(k), GJ)))
          for k in range(4)]
    with pytest.raises(ValueError, match="gen is None"):
        tmg.setup_mg(d, tmg.MGParams(n_level=3, **LEVELS), None,
                     null_vectors=vs)


@pytest.mark.cuda
@pytest.mark.parametrize("levels", [3, 4])
def test_graphed_coarse_vcycle_on_card(port_mg, levels):
    """On the card the coarse solve replays the level-1 V-cycle from a
    CUDA graph: the same result as the V-cycle run op by op, at every
    call (the graph's input is copied in each time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; CUDA graphs have no CPU mode")
    dev = torch.device("cuda")
    src = port_mg if levels == 4 else _three(port_mg)

    def op(c):
        return None if c is None else tco.CoarseOperator(
            x=c.x.to(dev), y=c.y.to(dev), bg=c.bg)

    def tr(t):
        return None if t is None else ttr.CoarseTransfer(v=t.v.to(dev),
                                                         bg=t.bg)
    mg = tmg.MGPreconditioner(
        transfer=None, coarse=op(src.coarse), dirac=None, params=src.params,
        transfer2=tr(src.transfer2), coarse2=op(src.coarse2),
        transfer3=tr(src.transfer3), coarse3=op(src.coarse3))
    rng = np.random.default_rng(40 + levels)
    shape = (2, LEVELS["nvec"]) + tuple(src.coarse.bg.coarse_shape)
    for _ in range(2):
        rc = torch.tensor(_cplx(rng, shape), device=dev)
        plain = tmg.gcr_cycle(mg.coarse.apply, rc,
                              n_krylov=mg.params.coarse_nkrylov,
                              precond=mg._coarse_vcycle)
        assert rel(mg.coarse_solve(rc), N(plain)) <= 1e-12
    assert len(mg._graphs) == 1


# ---- bf16 null-vector storage --------------------------------------------

@pytest.fixture(scope="module")
def bf16_pair():
    """A JAX package float32 V cast to its bf16 planar pair (the
    ``vec_dtype="bf16"`` tier) and the port's ``Bf16Transfer`` of the
    same bits."""
    k = jax.random.split(jax.random.PRNGKey(77), 4)
    bgj = jtr.BlockGeometry(GJ, 2, 2, 2, 2, nvec=4)
    vs = [jrng.random_spinor(kk, GJ) for kk in k]
    v = jtr.block_orthonormalize_flat(
        jnp.stack([jtr.to_blocked_flat(x, bgj) for x in vs]))
    pair = tuple(a.astype(jnp.float32).astype(jnp.bfloat16) for a in v)
    tj = jtr.Transfer(v=pair, bg=bgj)
    bg = ttr.BlockGeometry(GT, 2, 2, 2, 2, nvec=4)
    return tj, transfer_from_numpy(tuple(np.asarray(a) for a in pair), bg)


def test_bf16_transfer_from_jax(bf16_pair):
    tj, tt = bf16_pair
    assert isinstance(tt, ttr.Bf16Transfer)
    assert tt.vr.dtype == tt.vi.dtype == torch.bfloat16
    np.testing.assert_array_equal(tt.vr.float().numpy(),
                                  np.asarray(tj.v[0], np.float32))
    assert tt.nbytes * 2 == tt.vr.numel() * 8     # half the complex64 V


def test_bf16_restrict_prolong_match_jax(bf16_pair):
    """The JAX package's bf16 ``Transfer._ein`` (the field cast to bf16,
    bf16 × bf16 with float32 accumulation) against the port's slab form:
    the same products, summed in another order."""
    tj, tt = bf16_pair
    rng = np.random.default_rng(3)
    psi = _cplx(rng, (2, 4, 3, GJ.T, GJ.Z, GJ.W)).astype(np.complex64)
    vc = _cplx(rng, (2, 4) + tuple(tt.bg.coarse_shape)).astype(np.complex64)
    got = tt.restrict(T(psi))
    assert got.dtype == torch.complex64
    assert rel(got, tj.restrict(jnp.asarray(psi))) <= 1e-6
    assert rel(tt.prolong(T(vc)), tj.prolong(jnp.asarray(vc))) <= 1e-6


def test_bf16_tier_solves():
    """The port's setup with ``vec_dtype="bf16"`` at the JAX package's
    ``test_vec_dtype_bf16_storage_tier`` settings: the coarse operator
    comes from the complex V (it equals the float32 tier's), V is stored
    as the bf16 pair, and the GCR-PC solve still certifies."""
    u = np.asarray(jrng.random_gauge(jax.random.PRNGKey(7), GJ))
    b = T(np.asarray(jrng.random_spinor(jax.random.PRNGKey(8), GJ)))
    d = dirac_from_numpy(u, DiracParams(kind="twisted-mass", kappa=0.11,
                                        mu=0.3), GT)
    kw = dict(block=(2, 2, 2, 2), nvec=6, setup_tol=1e-4, setup_maxiter=80,
              smoother_pc=True, outer_solver="gcr-pc")
    mg = tmg.setup_mg(d, tmg.MGParams(vec_dtype="bf16", **kw),
                      torch.Generator().manual_seed(3))
    ref = tmg.setup_mg(d, tmg.MGParams(**kw), torch.Generator().manual_seed(3))
    tr = mg.transfer
    assert isinstance(tr, ttr.Bf16Transfer) and not hasattr(tr, "v")
    assert tr.vr.dtype == tr.vi.dtype == torch.bfloat16
    assert 2 * tr.nbytes == ref.transfer.v.to(torch.complex64).nbytes
    assert rel(mg.coarse.x, N(ref.coarse.x)) == 0.0
    out = tmg.mg_solve(mg, b, tol=1e-8, max_restarts=40)
    r = b - d.m(out.x)
    assert float(r.norm() / b.norm()) < 1e-7


# ---- the pair and the CLI -------------------------------------------------

def test_setup_mg_pair_three_levels(jax_mg, monkeypatch):
    """Both flavours get a level 2 built on their own coarse operator
    from the same level-2 sources (generators in one state), and one
    shared V (cast once in the bf16 tier)."""
    u = jax_mg[0]
    tmc = dict(kind="twisted-clover", kappa=0.12, mu=0.05, csw=1.0)
    up = dirac_from_numpy(u, DiracParams(**tmc), GT)
    dn = dirac_from_numpy(u, DiracParams(flavor=-1, **tmc), GT)
    draws = []
    random_coarse = tmg._random_coarse

    def spy(gen, shape, dtype):
        draws.append(random_coarse(gen, shape, dtype))
        return draws[-1]
    monkeypatch.setattr(tmg, "_random_coarse", spy)
    p = tmg.MGParams(n_level=3, vec_dtype="bf16", **LEVELS)
    mu, md = tmg.setup_mg_pair(up, dn, p, torch.Generator().manual_seed(2))
    assert mu.transfer is md.transfer
    assert isinstance(mu.transfer, ttr.Bf16Transfer)
    n = LEVELS["nvec2"]
    assert len(draws) == 2 * n
    for a, b in zip(draws[:n], draws[n:]):
        assert torch.equal(a, b)
    assert mu.coarse2 is not None and md.coarse2 is not None
    assert rel(mu.coarse2.x, N(md.coarse2.x)) > 1e-3   # the twist's sign
    for m in (mu, md):
        assert set(m.setup_stats["level2"]) == {
            "null_vector_secs", "bicgstab_iters", "build_secs"}


def test_cli_twop_three_levels(tmp_path):
    """``cli twop --mg --mg-levels 3`` runs ``run_twop`` on a pair of
    three-level preconditioners, which it returns as given, and agrees
    with the CG route."""
    args = ["twop", "--xdim", "4", "--ydim", "4", "--zdim", "4", "--tdim",
            "8", "--kappa", "0.115", "--mu", "0.05", "--csw", "1.0",
            "--nsmearAPE", "1", "--nsmearGauss", "1", "--tol", "1e-9",
            "--device", "cpu", "--seed", "5", "--precision", "double"]
    cg = cli.main(args + ["--output", str(tmp_path / "cg")])
    mg = cli.main(args + ["--mg", "--mg-levels", "3", "--mg-block",
                          "2,2,2,2", "--mg-nvec", "4", "--mg-solver",
                          "gcr-pc", "--output", str(tmp_path / "mg")])
    pair = mg["mg_pair"]
    assert all(m.params.n_level == 3 and m.coarse2 is not None
               for m in pair)
    assert rel(mg["mesons"], N(cg["mesons"])) <= 1e-6
