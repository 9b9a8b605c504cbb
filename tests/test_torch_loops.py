"""The disconnected loops of the port against the JAX package, on the CPU
in complex128 at 4⁴.

* ``spin_outer_g5`` and ``one_end_trick`` (twisted mass and twisted
  clover, the untwisted partner of each) against the JAX functions
  (≤ 1e-12, normwise relative);
* the partner: the solve operator's links, doubled links and gauge
  channels (one cache), no clover inverse, ``m`` through the hop
  wrapper equal to the plain operator's;
* ``run_loops`` (n_hp = 1) against the JAX ``run_loops`` with the same
  Z4 noise, at tol 1e-12 (≤ 1e-8 a loop type); the compact route against
  the canonical one; ``stochastic_loops``; ``z4_source``;
* the loop writers (HDF5, HighMomForm, ASCII) and checkpoints against
  the JAX package's files, and ``cli loops``.

The JAX noise comes from threefry keys, which the port cannot
reproduce: the tests make it with JAX and hand it to the port through
``workflows.z4_source``.
"""

from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from quda_qkxtm_multigrid_tpu import lattice as jlat
from quda_qkxtm_multigrid_tpu import workflows as jwf
from quda_qkxtm_multigrid_tpu.dirac import DiracParams as JParams
from quda_qkxtm_multigrid_tpu.dirac import make_dirac as jmake_dirac
from quda_qkxtm_multigrid_tpu.physics import loops as jlp
from quda_qkxtm_multigrid_tpu.utils import rng as jrng

from quda_qkxtm_multigrid_tpu_torch import cli
from quda_qkxtm_multigrid_tpu_torch import workflows as wf
from quda_qkxtm_multigrid_tpu_torch.dirac import DiracParams, make_dirac
from quda_qkxtm_multigrid_tpu_torch.io import hdf5 as h5w
from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry
from quda_qkxtm_multigrid_tpu_torch.parallel.mesh import TMesh
from quda_qkxtm_multigrid_tpu_torch.physics import contract as con
from quda_qkxtm_multigrid_tpu_torch.physics import loops as lp
from quda_qkxtm_multigrid_tpu_torch.utils import checkpoint, rng

torch.set_num_threads(1)

GJ = jlat.Geometry(4, 4, 4, 4)
GT = Geometry(4, 4, 4, 4)
KINDS = {"twisted-mass": dict(kappa=0.115, mu=0.05),
         "twisted-clover": dict(kappa=0.115, mu=0.05, csw=1.0)}


def rel(got, ref) -> float:
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.linalg.norm((got - ref).ravel())
                 / np.linalg.norm(ref.ravel()))


def _jax_noise(key, n):
    """The Z4 sources of the JAX ``run_loops`` key sequence."""
    out = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(torch.tensor(np.asarray(
            jrng.z4_source(sub, GJ, jnp.complex128))))
    return out


@pytest.fixture(scope="module")
def gauge():
    return np.asarray(jrng.random_gauge(jax.random.PRNGKey(12), GJ))


@pytest.fixture(scope="module")
def spinor():
    r = np.random.default_rng(13)
    shape = (2, 4, 3) + GJ.lat_shape
    return r.standard_normal(shape) + 1j * r.standard_normal(shape)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_one_end_trick_matches_jax(gauge, spinor, kind):
    jd = jmake_dirac(gauge, JParams(kind=kind, **KINDS[kind]), GJ)
    d = make_dirac(torch.tensor(gauge), DiracParams(kind=kind, **KINDS[kind]),
                   GT)
    x = torch.tensor(spinor)
    assert rel(lp.spin_outer_g5(x, x.roll(1, -1)),
               jlp.spin_outer_g5(spinor, np.roll(spinor, 1, -1))) <= 1e-12
    ours = lp.one_end_trick(x, lp.plain_wilson_partner(d), GT)
    theirs = jlp.one_end_trick(spinor, jlp.plain_wilson_partner(jd), GJ)
    for name in lp.LoopResult._fields:
        assert rel(getattr(ours, name), getattr(theirs, name)) <= 1e-12, name


def test_partner_shares_the_solve_operators_fields(gauge, spinor,
                                                   monkeypatch):
    """With the hop wrapper (``use_kernels``; its plain version on the
    CPU) the partner holds the solve operator's links, doubled links and
    channel cache, no clover inverse, and builds only gauge channels; its
    ``m`` equals the plain operator's."""
    monkeypatch.setattr(wf, "_FORCE_KERNELS", True)
    p = DiracParams(kind="twisted-clover", **KINDS["twisted-clover"])
    d = wf.make_operator(torch.tensor(gauge), p, GT)
    partner = lp.plain_wilson_partner(d)
    assert partner.u is d.u and partner.u_doubled is d.u_doubled
    assert partner.clover is d.clover and partner.clover_inv is None
    assert partner._ch_cache is d._ch_cache
    assert partner.params.use_kernels and not partner._has_fused_matpc
    x = torch.tensor(spinor)
    got = partner.m(x)
    assert set(d._ch_cache[torch.float64]) == {"g"}     # no A⁻¹ channels
    plain = lp.plain_partner_from_gauge(torch.tensor(gauge), p, GT)
    assert plain.clover_inv is None and not plain.params.use_kernels
    assert rel(got, plain.m(x)) <= 1e-13
    d.matpc(x[0])                     # the solve operator adds its own
    assert set(d._ch_cache[torch.float64]) == {"g", "ci"}


def test_z4_source_and_unit_gauge():
    xi = rng.z4_source(torch.Generator().manual_seed(1), GT, torch.complex64)
    assert xi.shape == (2, 4, 3) + GT.lat_shape and xi.dtype == torch.complex64
    vals = torch.unique(torch.view_as_real(xi).reshape(-1, 2), dim=0)
    assert vals.tolist() == [[-1, 0], [0, -1], [0, 1], [1, 0]]
    u = rng.unit_gauge(GT, device="cpu")
    assert torch.equal(u[2, 1, :, :, 0, 0, 0], torch.eye(3,
                                                         dtype=u.dtype))


LOOPS = dict(kappa=0.115, mu=0.05, csw=1.0, n_stoch=2, tol=1e-12,
             tol_lp=1e-4, n_hp=1, maxiter=500)


@pytest.fixture(scope="module")
def loops_pair(gauge):
    """``run_loops`` of both packages on the JAX noise of key 21."""
    key = jax.random.PRNGKey(21)
    noise = _jax_noise(key, 3)
    st = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(wf, "z4_source",
                   lambda gen, geom, dtype: noise.pop(0).to(dtype))
        ours = wf.run_loops(torch.tensor(gauge), GT, gen=torch.Generator(),
                            stats=st, **LOOPS)
    theirs = jwf.run_loops(gauge, GJ, key=key, **LOOPS)
    return ours, theirs, st, noise


@pytest.mark.parametrize("name", sorted(wf.LOOP_NAMES))
def test_run_loops_matches_jax(loops_pair, name):
    ours, theirs, _, noise = loops_pair
    assert not noise                       # one source a sample or pair
    assert ours[name].shape == theirs[name].shape
    assert rel(ours[name], theirs[name]) <= 1e-8


def test_run_loops_stats_and_refusals(loops_pair, gauge):
    _, _, st, _ = loops_pair
    (xi, x_hi, res, iters), = st["hp"]
    assert res <= 1e-11 and iters > 0
    assert set(st["secs"]) == {"operators", "solve", "one_end", "finalize"}
    # the meshed deflated loops refuse a ring that does not divide T,
    # before anything is sent
    ring3 = TMesh(nt=3, rank=0, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="divisible"):
        wf.run_loops_wexact(torch.tensor(gauge), GT, nev=2,
                            gen=torch.Generator(), mesh=ring3,
                            **{k: LOOPS[k] for k in ("kappa", "mu", "csw",
                                                     "n_stoch")})


def test_compact_route_agrees_with_the_canonical(gauge, monkeypatch):
    """The compact operator (bf16 tier, plain versions on the CPU) with
    ``plain_partner_from_gauge``, against the canonical complex64 fused
    route on the same noise: the bf16 tier's solve floor (~2.4e-3 against
    the exact operator, ~3e-3 here), within 1e-2."""
    u = torch.tensor(gauge).to(torch.complex64)
    kw = dict(kappa=0.115, mu=0.05, csw=1.0, n_stoch=1, tol=1e-3,
              maxiter=200)
    noise = rng.z4_source(torch.Generator().manual_seed(4), GT,
                          torch.complex64)
    monkeypatch.setattr(wf, "z4_source", lambda gen, geom, dtype: noise)
    monkeypatch.setattr(wf, "_FORCE_KERNELS", True)
    canon = wf.run_loops(u, GT, gen=torch.Generator(), **kw)
    monkeypatch.setattr(wf, "_FORCE_COMPACT", True)
    st = {}
    comp = wf.run_loops(u, GT, gen=torch.Generator(), stats=st, **kw)
    assert st["partner"].clover_inv is None
    for name in ("Scalar", "dOp", "LpsDw"):
        assert rel(comp[name], canon[name].numpy()) <= 1e-2, name


def test_stochastic_loops(gauge):
    d = make_dirac(torch.tensor(gauge), DiracParams(
        kind="twisted-mass", **KINDS["twisted-mass"]), GT)
    from quda_qkxtm_multigrid_tpu_torch.invert import invert
    res = lp.stochastic_loops(lambda b: invert(d, b, tol=1e-8).x,
                              torch.Generator().manual_seed(2), d, GT, 1,
                              dtype=torch.complex128)
    assert res.std.shape == (16, 4, 4, 4, 4)
    assert res.der_gen.shape == (4, 16, 4, 4, 4, 4)
    assert all(torch.isfinite(f).all() for f in res)
    assert bool((res.std[0].real <= 1e-12).all())   # −|x|² on s1 = s2 = 0


# ---- writers, checkpoints and the CLI ---------------------------------------

def test_loop_writers_and_checkpoints_match_jax(tmp_path):
    h5py = pytest.importorskip("h5py")
    from quda_qkxtm_multigrid_tpu.io import hdf5 as jh5
    from quda_qkxtm_multigrid_tpu.utils import checkpoint as jck
    r = np.random.default_rng(3)
    moms = con.momentum_list(1)

    def c(*shape):
        return r.standard_normal(shape) + 1j * r.standard_normal(shape)
    loops = {"Scalar": c(16, 4, len(moms)), "LpsDw": c(4, 16, 4, len(moms))}
    meta = {"kappa": 0.115, "mu": 0.05, "csw": 1.0}
    calls = {
        "plain": lambda w, p: w.write_loops_hdf5(p, loops, moms, 2, 12),
        "hm": lambda w, p: w.write_loops_hdf5_highmom(p, loops, moms, 2, 12,
                                                      1, meta),
        "hm_lp": lambda w, p: w.write_loops_hdf5_highmom(
            p, loops, moms, 2, 12, 1, meta, low_prec=True),
        "hm_exact": lambda w, p: w.write_loops_hdf5_highmom(
            p, loops, moms, 2, 12, 1, meta, exact_nev=8)}
    for name, call in calls.items():
        a, b = tmp_path / f"port_{name}.h5", tmp_path / f"jax_{name}.h5"
        call(h5w, str(a))
        call(jh5, str(b))
        with h5py.File(a, "r") as fa, h5py.File(b, "r") as fb:
            names, got = [], []
            fb.visit(names.append)
            fa.visit(got.append)
            assert got == names
            assert dict(fa.attrs) == dict(fb.attrs)
            for n in names:
                if isinstance(fb[n], h5py.Dataset):
                    assert np.array_equal(fa[n][()], fb[n][()]), n
    for a, b in zip(h5w.write_loops_ascii(str(tmp_path / "port"), loops, moms),
                    jh5.write_loops_ascii(str(tmp_path / "jax"), loops,
                                          moms)):
        assert Path(a).read_bytes() == Path(b).read_bytes()
    jck.save_loops(str(tmp_path / "jax_loops.npz"), loops, 12)
    got, n = checkpoint.load_loops(str(tmp_path / "jax_loops.npz"))
    assert n == 12 and all(np.array_equal(got[k], loops[k]) for k in loops)
    checkpoint.save_loops(str(tmp_path / "port_loops.npz"),
                          {k: torch.tensor(v) for k, v in loops.items()}, 7)
    got, n = jck.load_loops(str(tmp_path / "port_loops.npz"))
    assert n == 7 and all(np.array_equal(got[k], loops[k]) for k in loops)


def test_cli_loops_writes_ascii(tmp_path, monkeypatch, capsys):
    def no_h5py():
        raise ImportError("h5py")
    monkeypatch.setattr(h5w, "_h5py", no_h5py)
    out = tmp_path / "run"
    res = cli.main(["loops", "--xdim", "4", "--ydim", "4", "--zdim", "4",
                    "--tdim", "4", "--kappa", "0.115", "--mu", "0.05",
                    "--csw", "1.0", "--tol", "1e-6", "--tol-LP", "1e-3",
                    "--nstoch", "2", "--nHP", "1", "--device", "cpu",
                    "--seed", "5", "--output", str(out)])
    printed = capsys.readouterr().out
    assert "plaquette: total=" in printed and "wrote" in printed
    nmom = len(con.momentum_list(1))
    scalar = (tmp_path / "run_Scalar.loop").read_text().splitlines()
    assert len(scalar) == nmom * 4 * 16
    der = (tmp_path / "run_LpsDw.loop").read_text().splitlines()
    assert len(der) == nmom * 4 * 16 * 4
    assert set(res) == set(wf.LOOP_NAMES)
    assert res["Scalar"].dtype == torch.complex64


@pytest.mark.cuda
def test_run_loops_on_the_card_matches_the_cpu(gauge):
    """A complex64 run on the card (the fused chain through K1, the
    partner's hops through K1) against the CPU run on the same noise."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the fused hops are CUDA kernels")
    from quda_qkxtm_multigrid_tpu_torch.ops.dslash_kernel import dslash_ch
    u = torch.tensor(gauge).to(torch.complex64)
    kw = dict(kappa=0.115, mu=0.05, csw=1.0, n_stoch=2, tol=1e-6,
              tol_lp=1e-3, n_hp=1, maxiter=500)
    noise = rng.z4_source(torch.Generator().manual_seed(6), GT,
                          torch.complex64)
    n1 = dslash_ch.launches
    with pytest.MonkeyPatch.context() as mp:
        draws = [noise.cuda()] * 3
        mp.setattr(wf, "z4_source", lambda gen, geom, dtype: draws.pop(0))
        card = wf.run_loops(u.cuda(), GT, gen=torch.Generator("cuda"), **kw)
        mp.setattr(wf, "z4_source", lambda gen, geom, dtype: noise)
        cpu = wf.run_loops(u, GT, gen=torch.Generator(), **kw)
    assert dslash_ch.launches > n1
    for name in wf.LOOP_NAMES:
        assert rel(card[name].cpu(), cpu[name].numpy()) <= 1e-4, name
