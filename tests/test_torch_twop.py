"""The 2pt workflow of the port against the JAX package and its frozen
output.

* the contractions (``meson_correlators``, ``baryon_correlators``),
  ``corr_to_lex``, ``momentum_project_dyn`` and ``fft_project`` against
  their JAX functions at 4³×8 on random propagators in complex128 (≤ 1e-12,
  normwise relative), and the contractions against the site-loop
  oracle of the reference's kernels (``tests/oracles/qkxtm_contract.py``);
* the whole ``run_twop`` against ``tests/oracles/golden_contractions.npz``
  (the JAX ``run_twop`` on ``rng.random_gauge(PRNGKey(42))`` at 4³×8,
  complex128, tol 1e-10): the plain complex128 route within rtol 1e-6,
  atol 1e-10 (the golden test's limits), and the complex64 fused route
  (the multi-source chain through the plain K2 / K1) within 1e-4
  normwise per correlator type (float32 CG at tol 1e-6);
* on an antiperiodic gauge, the fused routes (complex128: a mixed CG a
  column; complex64: one multi-source solve a flavour) against the plain
  one; on the card, the complex128 route through the kernels against the
  golden file;
* the MG pair against CG (the pion within 1e-4, the JAX package's
  ``test_mg_pair_matches_cg``); ``corr_space="position"`` projected
  against the momentum run; ``make_operator``'s routing through its test
  hooks; ``cli.main(["twop", …])`` writing the ASCII files; the HDF5
  writers against the JAX package's.
"""

import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from quda_qkxtm_multigrid_tpu import lattice as jlat
from quda_qkxtm_multigrid_tpu.physics import contract as jcon
from quda_qkxtm_multigrid_tpu.utils import rng as jrng

from quda_qkxtm_multigrid_tpu_torch import cli
from quda_qkxtm_multigrid_tpu_torch import workflows as wf
from quda_qkxtm_multigrid_tpu_torch.compact import CompactDirac
from quda_qkxtm_multigrid_tpu_torch.dirac import DiracParams
from quda_qkxtm_multigrid_tpu_torch.io import hdf5 as h5w
from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry
from quda_qkxtm_multigrid_tpu_torch.mg.multigrid import MGParams
from quda_qkxtm_multigrid_tpu_torch.ops.gauge import apply_t_boundary
from quda_qkxtm_multigrid_tpu_torch.parallel.mesh import TMesh
from quda_qkxtm_multigrid_tpu_torch.physics import contract as con
from quda_qkxtm_multigrid_tpu_torch.utils import rng

sys.path.insert(0, str(Path(__file__).resolve().parent))
from oracles import qkxtm_contract as oracle  # noqa: E402

torch.set_num_threads(1)

GJ = jlat.Geometry(4, 4, 4, 8)
GT = Geometry(4, 4, 4, 8)
GOLDEN = (Path(__file__).resolve().parent / "oracles"
          / "golden_contractions.npz")
# the golden file's run (tests/test_golden.py)
TWOP = dict(kappa=0.115, mu=0.05, csw=1.0, q_sq_max=1, ape_n=2, gauss_n=3)
F64 = 1e-12          # the port against JAX in complex128, normwise
FUSED = 1e-4         # the float32 fused route against the golden file


def rel(got, ref) -> float:
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.linalg.norm((got - ref).ravel())
                 / np.linalg.norm(ref.ravel()))


@pytest.fixture
def hooks(monkeypatch):
    """Set the routing hooks for one test (restored after it)."""
    def set_(kernels=None, compact=None):
        monkeypatch.setattr(wf, "_FORCE_KERNELS", kernels)
        monkeypatch.setattr(wf, "_FORCE_COMPACT", compact)
    return set_


# ---- contractions against JAX and the oracle ------------------------------

@pytest.fixture(scope="module")
def props():
    """Two random complex128 'propagators' [2,4,4,3,3,T,Z,W] from numpy."""
    rng = np.random.default_rng(71)
    shape = (2, 2, 4, 4, 3, 3, GJ.T, GJ.Z, GJ.W)
    a = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return a[0], a[1]


@pytest.fixture(scope="module")
def baryons(props):
    up, dn = props
    return (con.baryon_correlators(torch.tensor(up), torch.tensor(dn)),
            np.asarray(jcon.baryon_correlators(up, dn)))


def test_mesons_match_jax(props):
    up, dn = props
    got = con.meson_correlators(torch.tensor(up), torch.tensor(dn))
    assert rel(got, jcon.meson_correlators(up, dn)) <= F64


@pytest.mark.parametrize("ip", range(10), ids=con.BARYON_NAMES)
def test_baryons_match_jax(baryons, ip):
    got, ref = baryons
    assert rel(got[ip], ref[ip]) <= F64


def _lex(p):
    """[2,4,4,3,3,T,Z,W] → the oracle's [4,4,3,3,T,Z,Y,X]."""
    return con.corr_to_lex(torch.tensor(p).movedim(0, -4), GT).numpy()


def test_contractions_match_the_reference_oracle(props, baryons):
    up, dn = props
    mes = con.corr_to_lex(con.meson_correlators(torch.tensor(up),
                                                torch.tensor(dn)), GT)
    ref_lex = (_lex(up), _lex(dn))
    assert rel(mes, oracle.mesons_ref(*ref_lex)) <= F64
    bar = con.corr_to_lex(baryons[0], GT)
    assert rel(bar, oracle.baryons_ref(*ref_lex)) <= F64


def test_corr_to_lex_and_momentum_projection_match_jax(props):
    up, _ = props
    field = up[:, 1, 2, 0, 1]                       # [2, T, Z, W]
    lex = con.corr_to_lex(torch.tensor(field), GT)
    jlex = np.asarray(jcon.corr_to_lex(field, GJ))
    assert np.array_equal(lex.numpy(), jlex)
    moms = con.momentum_list(2)
    assert np.array_equal(moms, jcon.momentum_list(2))
    src = (1, 2, 3, 5)
    got = con.momentum_project_dyn(lex, GT, moms, src)
    ref = jcon.momentum_project_dyn(jnp.asarray(jlex), GJ, moms,
                                    jnp.asarray(src, jnp.int32))
    assert rel(got, ref) <= F64
    assert rel(con.fft_project(lex), jcon.fft_project(jnp.asarray(jlex))) \
        <= F64


# ---- the whole workflow against the golden file ----------------------------

@pytest.fixture(scope="module")
def gauge():
    """The golden file's gauge: the JAX ``random_gauge(PRNGKey(42))``."""
    return np.asarray(jrng.random_gauge(jax.random.PRNGKey(42), GJ))


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


@pytest.fixture(scope="module")
def plain_run(gauge):
    """``run_twop`` on the complex128 gauge: the plain operator, a CG
    solve a column, the golden file's settings."""
    return wf.run_twop(torch.tensor(gauge), GT, tol=1e-10, maxiter=600,
                       **TWOP)


@pytest.mark.parametrize("key", ["mesons", "baryons"])
def test_run_twop_matches_golden(plain_run, golden, key):
    np.testing.assert_allclose(plain_run[key].numpy(), golden[key],
                               rtol=1e-6, atol=1e-10)


def test_run_twop_fused_route_matches_golden(gauge, golden, monkeypatch):
    """complex64 through the fused chain (K2 at n = 12 in the four-hop
    chain, plain versions on the CPU): one multi-source solve a
    flavour."""
    monkeypatch.setattr(wf, "_FORCE_KERNELS", True)
    stats = {}
    out = wf.run_twop(torch.tensor(gauge).to(torch.complex64), GT, tol=1e-6,
                      maxiter=600, stats=stats, **TWOP)
    for flavour in ("up", "dn"):
        assert isinstance(stats[flavour]["iters"], int)    # one msrc solve
        assert stats[flavour]["true_res"] <= 5e-6
    for key in ("mesons", "baryons"):
        assert out[key].dtype == torch.complex64
        assert rel(out[key].to(torch.complex128), golden[key]) <= FUSED, key


@pytest.fixture(scope="module")
def apbc_plain():
    """An antiperiodic 4⁴ gauge (complex128) and the plain route's run."""
    geom = Geometry(4, 4, 4, 4)
    u = apply_t_boundary(
        rng.random_gauge(torch.Generator().manual_seed(9), geom), geom)
    kw = dict(TWOP, ape_n=1, gauss_n=1, tol=1e-6, maxiter=600)
    return u, geom, kw, wf.run_twop(u, geom, **kw)


def test_run_twop_antiperiodic_fused_matches_plain(apbc_plain, monkeypatch):
    """With the antiperiodic boundary folded into the links, the fused
    route (recon-12 hops restoring the boundary's sign) gives the plain
    route's correlators (4⁴, complex128 gauge: the complex128 fused
    route, a mixed CG a column on the float64 and float32 hops)."""
    u, geom, kw, plain = apbc_plain
    monkeypatch.setattr(wf, "_FORCE_KERNELS", True)
    stats = {}
    fused = wf.run_twop(u, geom, stats=stats, **kw)
    assert len(stats["up"]["iters"]) == 12      # a solve a column
    for key in ("mesons", "baryons"):
        assert rel(fused[key], plain[key].numpy()) <= 1e-4, key


def test_run_twop_antiperiodic_msrc_route_matches_plain(apbc_plain,
                                                        monkeypatch):
    """The complex64 fused route on the antiperiodic gauge: one
    multi-source solve a flavour (K2's plain version with the sign)
    against the plain complex128 route."""
    u, geom, kw, plain = apbc_plain
    monkeypatch.setattr(wf, "_FORCE_KERNELS", True)
    stats = {}
    fused = wf.run_twop(u.to(torch.complex64), geom, stats=stats, **kw)
    assert isinstance(stats["dn"]["iters"], int)   # one msrc solve
    for key in ("mesons", "baryons"):
        assert rel(fused[key].to(torch.complex128), plain[key].numpy()) \
            <= 1e-4, key


def test_mg_pair_matches_cg(gauge, plain_run):
    """MG-GCR with the pair of preconditioners (one set of null vectors,
    a coarse operator a flavour) reproduces the CG pion."""
    mgp = MGParams(block=(2, 2, 2, 2), nvec=4, setup_tol=1e-4,
                   setup_maxiter=200, nu_post=4)
    stats = {}
    out = wf.run_twop(torch.tensor(gauge), GT, tol=1e-6, maxiter=500,
                      mg_params=mgp, mg_gen=torch.Generator().manual_seed(3),
                      stats=stats, **TWOP)
    up, dn = out["mg_pair"]
    assert up.transfer is dn.transfer
    assert up.coarse is not dn.coarse
    assert len(stats["up"]["iters"]) == 12
    assert max(stats["dn"]["true_res"]) <= 1e-5
    np.testing.assert_allclose(out["mesons"][0].numpy(),
                               plain_run["mesons"][0].numpy(), rtol=1e-4,
                               atol=1e-8)


def test_position_space_projects_to_the_momentum_run():
    geom = Geometry(4, 4, 4, 4)
    u = rng.random_gauge(torch.Generator().manual_seed(8), geom)
    kw = dict(TWOP, ape_n=1, gauss_n=1, tol=1e-5, maxiter=300,
              source=(1, 0, 2, 3))
    mom = wf.run_twop(u, geom, **kw)
    pos = wf.run_twop(u, geom, corr_space="position", **kw)
    assert pos["mesons"].shape == (10, 2, 4, 4, 4, 4)
    assert pos["baryons"].shape == (10, 2, 4, 4, 4, 4, 4, 4)
    for key in ("mesons", "baryons"):
        proj = con.momentum_project_dyn(pos[key], geom, mom["moms"],
                                        (1, 0, 2, 3))
        assert rel(proj, mom[key].numpy()) <= 1e-12


# ---- routing -------------------------------------------------------------

def test_make_operator_routes(gauge, hooks):
    p = DiracParams(kind="twisted-clover", kappa=0.115, mu=0.05, csw=1.0)
    u128 = torch.tensor(gauge)
    u64 = u128.to(torch.complex64)
    hooks()
    assert not wf.make_operator(u128, p, GT).params.use_kernels
    assert not wf.make_operator(u64, p, GT).params.use_kernels   # CPU
    hooks(kernels=True)
    assert wf.make_operator(u64, p, GT).params.use_kernels
    hooks(kernels=True, compact=True)
    cd = wf.make_operator(u64, p, GT)
    assert isinstance(cd, CompactDirac) and cd.g_ch.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="compact operator"):
        wf.run_twop(u64, GT, mg_params=MGParams(block=(2, 2, 2, 2), nvec=4),
                    **TWOP)
    ring3 = TMesh(nt=3, rank=0, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="divisible"):
        wf.make_operator(u64, p, GT, mesh=ring3)
    with pytest.raises(ValueError, match="divisible"):
        wf.run_twop(u64, GT, mesh=ring3, **TWOP)
    # the canonical complex128 bundle at 48³×96 (PERF.md §2: 42.8 GB)
    big = Geometry(48, 48, 48, 96)
    assert abs(wf.bundle_bytes(u128, big) / 1e9 - 42.8) < 0.05


@pytest.mark.cuda
def test_run_twop_complex128_on_the_card_runs_the_kernels(gauge, golden):
    """A complex128 gauge on the card takes the fused chain with K1's
    float64 instance (a mixed CG a column), no plain operator, and
    reproduces the golden file at its limits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the fused hops are CUDA kernels")
    from quda_qkxtm_multigrid_tpu_torch.ops.dslash_kernel import dslash_ch
    u = torch.tensor(gauge).cuda()
    p = DiracParams(kind="twisted-clover", kappa=0.115, mu=0.05, csw=1.0)
    d = wf.make_operator(u, p, GT)
    assert d.params.use_kernels and d._has_fused_matpc
    n1 = dslash_ch.launches
    out = wf.run_twop(u, GT, tol=1e-10, maxiter=600, **TWOP)
    assert dslash_ch.launches > n1
    for key in ("mesons", "baryons"):
        np.testing.assert_allclose(out[key].cpu().numpy(), golden[key],
                                   rtol=1e-6, atol=1e-10)


def test_cli_twop_writes_ascii(tmp_path, monkeypatch, capsys):
    def no_h5py():
        raise ImportError("h5py")
    monkeypatch.setattr(h5w, "_h5py", no_h5py)
    out = tmp_path / "run"
    res = cli.main(["twop", "--xdim", "4", "--ydim", "4", "--zdim", "4",
                    "--tdim", "8", "--kappa", "0.115", "--mu", "0.05",
                    "--csw", "1.0", "--nsmearAPE", "1", "--nsmearGauss", "1",
                    "--tol", "1e-5", "--device", "cpu", "--seed", "5",
                    "--output", str(out)])
    printed = capsys.readouterr().out
    assert "plaquette: total=" in printed
    mes = (tmp_path / "run_mesons.dat").read_text().splitlines()
    bar = (tmp_path / "run_baryons.dat").read_text().splitlines()
    nmom = len(res["moms"])
    assert len(mes) == 10 * 2 * 8 * nmom
    assert len(bar) == 10 * 2 * 8 * nmom * 16
    it, fl, t, px, py, pz, re, im = mes[0].split()
    assert complex(float(re), float(im)) == pytest.approx(
        complex(res["mesons"][0, 0, 0, 0]), rel=1e-6)
    assert res["mesons"].dtype == torch.complex64


def test_twop_hdf5_matches_the_jax_writer(tmp_path):
    """The HDF5 2pt writers give the JAX package's tree and datasets."""
    h5py = pytest.importorskip("h5py")
    from quda_qkxtm_multigrid_tpu.io import hdf5 as jh5
    rng = np.random.default_rng(3)
    moms = con.momentum_list(1)
    mes = rng.standard_normal((10, 2, 8, len(moms))) + 1j
    bar = rng.standard_normal((10, 2, 4, 4, 8, len(moms))) - 1j
    for name, ours, theirs, corr in (
            ("mesons", h5w.write_twop_mesons_hdf5,
             jh5.write_twop_mesons_hdf5, mes),
            ("baryons", h5w.write_twop_baryons_hdf5,
             jh5.write_twop_baryons_hdf5, bar)):
        a, b = tmp_path / f"port_{name}.h5", tmp_path / f"jax_{name}.h5"
        ours(str(a), corr, moms, 7, (1, 2, 3, 4))
        theirs(str(b), corr, moms, 7, (1, 2, 3, 4))
        with h5py.File(a, "r") as fa, h5py.File(b, "r") as fb:
            names = []
            fb.visit(names.append)
            got = []
            fa.visit(got.append)
            assert got == names
            for n in names:
                if isinstance(fb[n], h5py.Dataset):
                    assert np.array_equal(fa[n][()], fb[n][()])
