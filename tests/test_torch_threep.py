"""The 3pt of the port against the JAX package, the reference's site-loop
oracle and the frozen output.

* ``physics/threept.py`` function by function against the JAX functions
  at 4³×8 in complex128 on random numpy propagators and gauge (≤ 1e-12,
  normwise relative): ``projector`` (5 names, both particles),
  ``insertion_ops`` (both parts), the sink timeslice and its embedding
  at an even and an odd t, both sequential sources and the three fixSink
  contractions; ``covdev_apply`` (both directions, every mu),
  ``stout_smear_step`` and the parity split / join (≤ 1e-13); the
  timeslice-only Gaussian smearing against the whole field's;
* the threept functions against ``tests/oracles/qkxtm_threept.py`` (the
  JAX package's ``test_reference_threept.py`` limits);
* ``run_threep`` on the golden file's run (the JAX
  ``random_gauge(PRNGKey(42))`` at 4³×8, complex128, tol 1e-10) against
  ``golden_contractions.npz`` at its rtol 1e-6 / atol 1e-10; the
  complex64 fused route (the sequential solves through the plain K2)
  within 1e-4 normwise; the MG pair against CG within 1e-4; position
  space projected against the momentum run; a ring that does not
  divide T refused;
* the 3pt writers against the JAX writers' files, and ``cli threep``.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from quda_qkxtm_multigrid_tpu import lattice as jlat
from quda_qkxtm_multigrid_tpu.ops import smear as jsmear
from quda_qkxtm_multigrid_tpu.physics import threept as jtp
from quda_qkxtm_multigrid_tpu.utils import rng as jrng

from quda_qkxtm_multigrid_tpu_torch import cli
from quda_qkxtm_multigrid_tpu_torch import workflows as wf
from quda_qkxtm_multigrid_tpu_torch.dirac import DiracParams, make_dirac
from quda_qkxtm_multigrid_tpu_torch.io import hdf5 as h5w
from quda_qkxtm_multigrid_tpu_torch.lattice import (
    Geometry, _join_parity_sites, _split_parity_sites)
from quda_qkxtm_multigrid_tpu_torch.mg.multigrid import (
    MGParams, setup_mg_pair)
from quda_qkxtm_multigrid_tpu_torch.ops import smear
from quda_qkxtm_multigrid_tpu_torch.parallel.mesh import TMesh
from quda_qkxtm_multigrid_tpu_torch.physics import contract as con
from quda_qkxtm_multigrid_tpu_torch.physics import threept as tp
from quda_qkxtm_multigrid_tpu_torch.physics.propagator import (
    assemble_prop, smear_propagator)
from quda_qkxtm_multigrid_tpu_torch.utils import rng

sys.path.insert(0, str(Path(__file__).resolve().parent))
from oracles import qkxtm_threept as oracle  # noqa: E402

torch.set_num_threads(1)

GJ = jlat.Geometry(4, 4, 4, 8)
GT = Geometry(4, 4, 4, 8)
F64 = 1e-12
GOLDEN = (Path(__file__).resolve().parent / "oracles"
          / "golden_contractions.npz")
# the golden file's run (tests/test_golden.py)
TWOP = dict(kappa=0.115, mu=0.05, csw=1.0, q_sq_max=1, ape_n=2, gauss_n=3)
THREEP = dict(kappa=0.115, mu=0.05, csw=1.0, tsink=4, projectors=("G4",),
              gauss_n=3)


def rel(got, ref) -> float:
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.linalg.norm((got - ref).ravel())
                 / np.linalg.norm(ref.ravel()))


@pytest.fixture(scope="module")
def flds():
    """Two random complex128 propagators [2,4,4,3,3,T,Z,W] (numpy seed
    17) and a JAX ``random_gauge``."""
    r = np.random.default_rng(17)
    shape = (2, 2, 4, 4, 3, 3) + GJ.lat_shape
    a = r.standard_normal(shape) + 1j * r.standard_normal(shape)
    u = np.asarray(jrng.random_gauge(jax.random.PRNGKey(23), GJ))
    return a[0], a[1], u


# ---- module 4 against JAX -------------------------------------------------

@pytest.mark.parametrize("particle", [tp.PROTON, tp.NEUTRON])
def test_projectors_and_insertion_ops_match_jax(particle):
    for name in tp.PROJ_NAMES:
        assert np.array_equal(tp.projector(name, particle),
                              np.asarray(jtp.projector(name, particle)))
    for part in (1, 2):
        assert np.array_equal(tp.insertion_ops(particle, part),
                              jtp.insertion_ops(particle, part))
    with pytest.raises(ValueError):
        tp.projector("G7", particle)


@pytest.mark.parametrize("t", [2, 5])
def test_timeslices_match_jax(flds, t):
    seq, _, _ = flds
    got = tp.prop_timeslice_lex(torch.tensor(seq), GT, t)
    assert np.array_equal(got.numpy(),
                          np.asarray(jtp.prop_timeslice_lex(seq, GJ, t)))
    r = np.random.default_rng(t)
    shape = (4, 3, 4, 3, GJ.Z, GJ.Y, GJ.X)
    src = r.standard_normal(shape) + 1j * r.standard_normal(shape)
    emb = tp.embed_timeslice(torch.tensor(src), GT, t, torch.complex128)
    assert np.array_equal(emb.numpy(), np.asarray(
        jtp.embed_timeslice(src, GJ, t, jnp.complex128)))


def test_parity_split_and_join_match_jax(flds):
    full = flds[0].reshape(GJ.T, GJ.Z, GJ.Y, GJ.X, -1)[..., :5]
    got = _split_parity_sites(torch.tensor(full))
    assert np.array_equal(got.numpy(),
                          np.asarray(jlat._split_parity_sites(full)))
    assert np.array_equal(_join_parity_sites(got).numpy(), full)


@pytest.mark.parametrize("proj", ["G4", "G5G123"])
def test_seq_sources_match_jax(flds, proj):
    seq, fwd, _ = flds
    t1 = np.asarray(jtp.prop_timeslice_lex(seq, GJ, 3))
    t2 = np.asarray(jtp.prop_timeslice_lex(fwd, GJ, 3))
    pr = tp.projector(proj, tp.PROTON)
    got1 = tp.seq_source_part1(torch.tensor(t1), torch.tensor(t2), pr)
    assert rel(got1, jtp.seq_source_part1(t1, t2, pr)) <= F64
    got2 = tp.seq_source_part2(torch.tensor(t1), pr)
    assert rel(got2, jtp.seq_source_part2(t1, pr)) <= F64


@pytest.mark.parametrize("particle,part", [(tp.PROTON, 1), (tp.NEUTRON, 2)])
def test_fixsink_contractions_match_jax(flds, particle, part):
    seq, fwd, u = flds
    s, f, ut = torch.tensor(seq), torch.tensor(fwd), torch.tensor(u)
    loc, noe, oned = tp.fixsink_all(s, f, ut, GT, particle, part)
    assert rel(loc, jtp.fixsink_local(seq, fwd, particle, part)) <= F64
    assert rel(noe, jtp.fixsink_noether(seq, fwd, u, GJ, particle,
                                        part)) <= F64
    assert rel(oned, jtp.fixsink_oneD(seq, fwd, u, GJ, particle,
                                      part)) <= F64
    assert torch.equal(tp.fixsink_noether(s, f, ut, GT, particle, part), noe)
    assert torch.equal(tp.fixsink_oneD(s, f, ut, GT, particle, part), oned)


def test_fixsink_contracts_the_propagators_first():
    """The pairwise plan contracts SEQ and FWD over (m, b, a) before the
    16 matrices, so no intermediate holds 16 propagators (32³×64 shapes,
    complex64: 16 × 2.4 GB otherwise)."""
    from quda_qkxtm_multigrid_tpu_torch.utils.precision import (
        _contraction_plan)
    p = (2, 4, 4, 3, 3, 64, 32, 512)
    plan = _contraction_plan("okl,pkmbatzw,plmbatzw->optzw",
                             ((16, 4, 4), p, p))
    pos, spec = plan[0]
    assert pos == (2, 1)                       # the two propagators
    assert set(spec.split("->")[1]) == set("pkltzw")


@pytest.mark.parametrize("forward", [True, False])
def test_covdev_matches_jax(flds, forward):
    seq, _, u = flds
    psi = seq[:, 0, :, 0]                       # [2, 4, 3, T, Z, W]
    for mu in range(4):
        got = smear.covdev_apply(torch.tensor(u), torch.tensor(psi), mu,
                                 forward, GT)
        ref = jsmear.covdev_apply(u, psi, mu, forward, GJ)
        assert rel(got, ref) <= 1e-13


def test_stout_step_matches_jax(flds):
    u = flds[2]
    got = smear.stout_smear_step(torch.tensor(u), GT, 0.1, False)
    ref = jsmear.stout_smear_step(jnp.asarray(u), GJ, 0.1, False)
    assert rel(got, ref) <= 1e-13


@pytest.mark.parametrize("t", [3, 4])
def test_timeslice_smearing_equals_the_whole_fields(flds, t):
    """The Gaussian hop is spatial: smearing the sink timeslice alone
    gives the whole field's smearing there, at an even and an odd t (the
    odd one lies on the other checkerboard of the even-odd layout)."""
    seq, _, u = flds
    ut, st = torch.tensor(u), torch.tensor(seq)
    full = smear_propagator(st, ut, GT, 4.0, 3)[..., t:t + 1, :, :]
    one = smear_propagator(st[..., t:t + 1, :, :], ut, GT, 4.0, 3, t0=t)
    assert rel(one, full) <= 1e-13


# ---- against the reference's site-loop oracle ------------------------------

G4 = Geometry(4, 4, 4, 4)


@pytest.fixture(scope="module")
def oracle_flds():
    r = np.random.default_rng(5)
    shape = (2, 2, 4, 4, 3, 3) + G4.lat_shape
    a = r.standard_normal(shape) + 1j * r.standard_normal(shape)
    u = rng.random_gauge(torch.Generator().manual_seed(6), G4)
    seq, fwd = torch.tensor(a[0]), torch.tensor(a[1])
    u_lex = torch.stack([_join_parity_sites(u[mu].movedim((1, 2), (4, 5))
                                            .reshape(2, 4, 4, 4, 2, 3, 3))
                         for mu in range(4)])       # [4,T,Z,Y,X,3,3]

    def lex(p):
        return con.corr_to_lex(p.movedim(0, -4), G4).numpy()
    return seq, fwd, u, lex(seq), lex(fwd), u_lex.movedim((-2, -1),
                                                          (1, 2)).numpy()


def test_fixsink_match_the_oracle(oracle_flds):
    seq, fwd, u, seq_lex, fwd_lex, u_lex = oracle_flds
    loc, noe, oned = tp.fixsink_all(seq, fwd, u, G4, oracle.PROTON, 1)
    for got, ref in (
            (loc, oracle.fixsink_local_ref(seq_lex, fwd_lex, oracle.PROTON,
                                           1)),
            (noe, oracle.fixsink_noether_ref(seq_lex, fwd_lex, u_lex,
                                             oracle.PROTON, 1)),
            (oned, oracle.fixsink_oneD_ref(seq_lex, fwd_lex, u_lex,
                                           oracle.PROTON, 1))):
        np.testing.assert_allclose(con.corr_to_lex(got, G4).numpy(), ref,
                                   rtol=1e-10, atol=1e-8)


@pytest.mark.parametrize("pid", ["G4", "G5G1"])
def test_seq_sources_match_the_oracle(oracle_flds, pid):
    _, _, _, t1_full, t2_full, _ = oracle_flds
    t1, t2 = t1_full[..., 2, :, :, :], t2_full[..., 2, :, :, :]
    pr = tp.projector(pid, oracle.PROTON)
    p1 = tp.seq_source_part1(torch.tensor(t1), torch.tensor(t2), pr).numpy()
    p2 = tp.seq_source_part2(torch.tensor(t1), pr).numpy()
    for q in range(4):
        for s in range(3):
            np.testing.assert_allclose(
                p1[q, s], oracle.seq_source_part1_ref(t1, t2, oracle.PROTON,
                                                      pid, q, s),
                rtol=1e-10, atol=1e-8)
            np.testing.assert_allclose(
                p2[q, s], oracle.seq_source_part2_ref(t1, oracle.PROTON,
                                                      pid, q, s),
                rtol=1e-10, atol=1e-8)


# ---- the whole 3pt ---------------------------------------------------------

@pytest.fixture(scope="module")
def golden_run():
    """The golden file's run through the port: ``run_twop`` and
    ``run_threep`` on the plain complex128 route."""
    u = torch.tensor(np.asarray(jrng.random_gauge(jax.random.PRNGKey(42),
                                                  GJ)))
    twop = wf.run_twop(u, GT, tol=1e-10, maxiter=600, **TWOP)
    st = {}
    thrp = wf.run_threep(u, GT, prop_up=twop["prop_up"],
                         prop_dn=twop["prop_dn"], u_ape=twop["u_ape"],
                         tol=1e-10, maxiter=600, stats=st, **THREEP)
    return u, twop, thrp, st


@pytest.mark.parametrize("key,ttype", [("thrp_ul", "ultra_local"),
                                       ("thrp_noe", "noether"),
                                       ("thrp_oneD", "oneD")])
def test_run_threep_matches_golden(golden_run, key, ttype):
    got = golden_run[2]["thrp"]["G4"]["part1"][ttype]
    np.testing.assert_allclose(got.numpy(), np.load(GOLDEN)[key],
                               rtol=1e-6, atol=1e-10)


def test_sequential_source_scale_is_exact():
    """A power of two brings the largest entry to [1, 2), so scaling by
    it changes no bit: a source far below float32's range survives."""
    t = torch.tensor([3e-25, -1e-26, 0.0], dtype=torch.float32)
    s = wf._pow2_scale(t)
    assert 1.0 <= float((t * s).abs().max()) < 2.0
    assert torch.equal((t * s) / s, t)
    assert wf._pow2_scale(torch.zeros(3)) == 1.0


def test_run_threep_parts_and_stats(golden_run):
    _, _, thrp, st = golden_run
    part2 = thrp["thrp"]["G4"]["part2"]
    assert part2["ultra_local"].shape == (16, GT.T, 7)
    assert part2["noether"].shape == (4, GT.T, 7)
    assert part2["oneD"].shape == (16, 4, GT.T, 7)
    assert all(torch.isfinite(v).all() for v in part2.values())
    assert st[("G4", 1)]["flavor"] == -1 and st[("G4", 2)]["flavor"] == +1
    assert len(st[("G4", 1)]["iters"]) == 12          # a CG a column
    assert max(st[("G4", 2)]["true_res"]) <= 1e-9
    assert set(st["secs"]) == {"smear", "seq_source", "operators", "solve",
                               "fixsink"}


def test_run_threep_fused_route(golden_run, monkeypatch):
    """complex64 through the fused chain: each part's twelve sequential
    columns one multi-source solve (the plain K2 on the CPU)."""
    u, twop, ref, _ = golden_run
    monkeypatch.setattr(wf, "_FORCE_KERNELS", True)
    c64 = torch.complex64
    st = {}
    out = wf.run_threep(u.to(c64), GT, prop_up=twop["prop_up"].to(c64),
                        prop_dn=twop["prop_dn"].to(c64),
                        u_ape=twop["u_ape"].to(c64), tol=1e-6, maxiter=600,
                        stats=st, **THREEP)
    assert isinstance(st[("G4", 1)]["iters"], int)      # one msrc solve
    assert st[("G4", 1)]["sources"].dtype == c64
    for part in ("part1", "part2"):
        for ttype, v in out["thrp"]["G4"][part].items():
            assert v.dtype == torch.complex128     # the scale comes off
            assert rel(v, ref["thrp"]["G4"][part][ttype].numpy()) <= 1e-4


def test_run_threep_mg_pair_matches_cg(golden_run):
    u, twop, ref, _ = golden_run
    p = DiracParams(kind="twisted-clover", kappa=0.115, mu=0.05, csw=1.0)
    pair = setup_mg_pair(make_dirac(u, p, GT),
                         make_dirac(u, dataclasses.replace(p, flavor=-1), GT),
                         MGParams(block=(2, 2, 2, 2), nvec=4, setup_tol=1e-4,
                                  setup_maxiter=200, nu_post=4),
                         torch.Generator().manual_seed(4))
    st = {}
    out = wf.run_threep(u, GT, prop_up=twop["prop_up"],
                        prop_dn=twop["prop_dn"], u_ape=twop["u_ape"],
                        tol=1e-6, maxiter=500, mg_pair=pair, stats=st,
                        **THREEP)
    assert max(st[("G4", 1)]["true_res"]) <= 1e-5
    for ttype in ("ultra_local", "noether", "oneD"):
        assert rel(out["thrp"]["G4"]["part1"][ttype],
                   ref["thrp"]["G4"]["part1"][ttype].numpy()) <= 1e-4


def test_position_space_projects_to_the_momentum_run(golden_run,
                                                      monkeypatch):
    """``corr_space="position"`` on the golden run's inputs, projected,
    gives the momentum run; a ring that does not divide T and an unknown
    space raise.  The
    sequential solves are the golden run's own (``forward_prop`` hands
    back its solutions): everything else of the workflow runs again."""
    u, twop, mom, st = golden_run
    seqprops = [assemble_prop(st[("G4", part)]["x"]) for part in (1, 2)]
    monkeypatch.setattr(wf, "forward_prop",
                        lambda *a, **k: seqprops.pop(0))
    kw = dict(prop_up=twop["prop_up"], prop_dn=twop["prop_dn"],
              u_ape=twop["u_ape"], tol=1e-10, maxiter=600, **THREEP)
    pos = wf.run_threep(u, GT, corr_space="position", **kw)
    assert not seqprops
    assert pos["corr_space"] == "position"
    for part in ("part1", "part2"):
        for ttype, v in pos["thrp"]["G4"][part].items():
            assert v.shape[-4:] == (GT.T, GT.Z, GT.Y, GT.X)
            proj = con.momentum_project_dyn(v, GT, -mom["moms"], (0, 0, 0, 0))
            assert rel(proj, mom["thrp"]["G4"][part][ttype].numpy()) <= 1e-12
    with pytest.raises(ValueError, match="divisible"):
        wf.run_threep(u, GT, mesh=TMesh(nt=3, rank=0,
                                        device=torch.device("cpu")), **kw)
    with pytest.raises(ValueError, match="corr_space"):
        wf.run_threep(u, GT, corr_space="spin", **kw)


# ---- writers and the CLI ----------------------------------------------------

def _h5_equal(h5py, a, b):
    with h5py.File(a, "r") as fa, h5py.File(b, "r") as fb:
        names, got = [], []
        fb.visit(names.append)
        fa.visit(got.append)
        assert got == names
        assert dict(fa.attrs) == dict(fb.attrs)
        for n in names:
            if isinstance(fb[n], h5py.Dataset):
                assert np.array_equal(fa[n][()], fb[n][()]), n


def test_threep_and_twop_writers_match_jax(tmp_path):
    """Every new 3pt / 2pt writer against the JAX writer on the same
    arrays: HDF5 trees, datasets and attributes; ASCII bytes."""
    h5py = pytest.importorskip("h5py")
    from quda_qkxtm_multigrid_tpu.io import hdf5 as jh5
    r = np.random.default_rng(9)
    moms = con.momentum_list(1)
    nm, T = len(moms), 8

    def c(*shape):
        return r.standard_normal(shape) + 1j * r.standard_normal(shape)
    thrp = {"ultra_local": c(16, T, nm), "noether": c(4, T, nm),
            "oneD": c(16, 4, T, nm)}
    by_proj = {"G4": {"up": thrp, "down": thrp}}
    src, meta = (1, 2, 3, 5), {"kappa": 0.115, "mu": 0.05, "csw": 1.0}
    mes, bar = c(10, 2, T, nm), c(10, 2, 4, 4, T, nm)
    pos = {"ultra_local": c(16, T, 4, 4, 4), "oneD": c(16, 4, T, 4, 4, 4)}
    calls = [
        ("thrp", lambda w, p: [w.write_threep_hdf5(
            p, a, moms, 3, src, 4, "G4", t, "proton")
            for t, a in thrp.items()]),
        ("hm_mes", lambda w, p: w.write_twop_mesons_hdf5_highmom(
            p, mes, moms, 3, src, 1, meta)),
        ("hm_bar", lambda w, p: w.write_twop_baryons_hdf5_highmom(
            p, bar, moms, 3, src, 1, meta)),
        ("hm_thrp", lambda w, p: w.write_threep_hdf5_highmom(
            p, by_proj, moms, 3, src, 4, 1, meta)),
        ("pos_twop", lambda w, p: w.write_twop_hdf5_posspace(
            p, c(10, 2, T, 4, 4, 4), c(10, 2, 4, 4, T, 4, 4, 4), 3, src)),
        ("pos_thrp", lambda w, p: [w.write_threep_hdf5_posspace(
            p, a, 3, src, 4, "G4", t, "proton") for t, a in pos.items()]),
    ]
    for name, call in calls:
        state = r.bit_generator.state
        call(h5w, str(tmp_path / f"port_{name}.h5"))
        r.bit_generator.state = state        # the same arrays for JAX
        call(jh5, str(tmp_path / f"jax_{name}.h5"))
        _h5_equal(h5py, tmp_path / f"port_{name}.h5",
                  tmp_path / f"jax_{name}.h5")
    ours = h5w.write_threep_ascii(str(tmp_path / "port"), thrp, moms,
                                  t_src=5, tsink=4)
    theirs = jh5.write_threep_ascii(str(tmp_path / "jax"), thrp, moms,
                                    t_src=5, tsink=4)
    for a, b in zip(ours, theirs):
        assert Path(a).read_bytes() == Path(b).read_bytes()


def test_cli_threep_writes_ascii(tmp_path, monkeypatch, capsys):
    def no_h5py():
        raise ImportError("h5py")
    monkeypatch.setattr(h5w, "_h5py", no_h5py)
    out = tmp_path / "run"
    res = cli.main(["threep", "--xdim", "4", "--ydim", "4", "--zdim", "4",
                    "--tdim", "4", "--kappa", "0.115", "--mu", "0.05",
                    "--csw", "1.0", "--nsmearAPE", "1", "--nsmearGauss", "1",
                    "--tol", "1e-5", "--device", "cpu", "--seed", "5",
                    "--tsink", "3", "--output", str(out)])
    assert "plaquette: total=" in capsys.readouterr().out
    nm = len(res["moms"])
    for part in ("part1", "part2"):
        lines = (tmp_path / f"run_G4_{part}.thrp.oneD.dat").read_text()
        assert len(lines.splitlines()) == 16 * 4 * 4 * nm
        ul = (tmp_path / f"run_G4_{part}.thrp.ultra_local.dat").read_text()
        assert len(ul.splitlines()) == 16 * 4 * nm
    assert res["thrp"]["G4"]["part1"]["noether"].dtype == torch.complex128


@pytest.mark.cuda
def test_run_threep_complex128_on_the_card_matches_golden():
    """A complex128 gauge on the card: the sequential solves on K1's
    float64 instance (a mixed CG a column), the golden file at its
    limits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the fused hops are CUDA kernels")
    from quda_qkxtm_multigrid_tpu_torch.ops.dslash_kernel import dslash_ch
    u = torch.tensor(np.asarray(jrng.random_gauge(jax.random.PRNGKey(42),
                                                  GJ))).cuda()
    twop = wf.run_twop(u, GT, tol=1e-10, maxiter=600, **TWOP)
    n1 = dslash_ch.launches
    out = wf.run_threep(u, GT, prop_up=twop["prop_up"],
                        prop_dn=twop["prop_dn"], u_ape=twop["u_ape"],
                        tol=1e-10, maxiter=600, **THREEP)
    assert dslash_ch.launches > n1
    golden = np.load(GOLDEN)
    for key, ttype in (("thrp_ul", "ultra_local"), ("thrp_noe", "noether"),
                       ("thrp_oneD", "oneD")):
        np.testing.assert_allclose(
            out["thrp"]["G4"]["part1"][ttype].cpu().numpy(), golden[key],
            rtol=1e-6, atol=1e-10)
