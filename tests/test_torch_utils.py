"""The port's solve-side utilities against the JAX package's: the memory
accountant, the verbosity stack, the NaN guards (and ``invert`` raising
under ``QKXTM_GUARD=1``), ``TimeProfile``; and the MG benchmarks
(``bench_mg`` on three levels and with bf16 null vectors,
``bench_light``, ``bench_light2``, ``bench_mg_vecs``) end to end at a
tiny size on the CPU.
"""

import functools
import gc
import itertools

import numpy as np
import jax
import pytest
import torch

from quda_qkxtm_multigrid_tpu import lattice as jlat
from quda_qkxtm_multigrid_tpu.utils import profiling as jprof
from quda_qkxtm_multigrid_tpu.utils import rng as jrng

from quda_qkxtm_multigrid_tpu_torch import benchmarks as bm
from quda_qkxtm_multigrid_tpu_torch import convert
from quda_qkxtm_multigrid_tpu_torch.dirac import DiracParams
from quda_qkxtm_multigrid_tpu_torch.invert import invert
from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry
from quda_qkxtm_multigrid_tpu_torch.mg import multigrid as tmg
from quda_qkxtm_multigrid_tpu_torch.utils import profiling as tprof
from quda_qkxtm_multigrid_tpu_torch.utils.guards import (
    assert_finite, maybe_guard)
from quda_qkxtm_multigrid_tpu_torch.utils.logging import (
    Verbosity, check_params, get_verbosity, log, output_prefix,
    print_params, push_verbosity, warn)
from quda_qkxtm_multigrid_tpu_torch.utils.memory import (
    PeakTracker, assert_no_leak, device_memory_stats, live_bytes)

dirac_from_numpy = functools.partial(convert.dirac_from_numpy, device="cpu")
T = functools.partial(convert.spinor_from_numpy, device="cpu")

torch.set_num_threads(1)

GJ = jlat.Geometry(4, 4, 4, 8)
GT = Geometry(4, 4, 4, 8)
SMALL = dict(block=(2, 2, 2, 2), nvec=4)


# ---- memory, logging, guards (JAX test_core.py's counterparts) -----------

def test_memory_accountant():
    """Live-bytes accounting on the CPU (the JAX package's
    ``test_memory_accountant`` with a tensor for the array)."""
    gc.collect()
    base = live_bytes(device="cpu")
    with PeakTracker(device="cpu") as pt:
        a = torch.ones((256, 1024), dtype=torch.float32) * 2.0
        pt.sample()
    assert pt.peak >= base + 1024 * 1024
    assert "peak" in pt.report()
    total, detail = live_bytes(by_shape=True, device="cpu")
    assert detail[((256, 1024), "torch.float32")] >= 1024 * 1024
    assert total >= 1024 * 1024
    del a
    gc.collect()
    with assert_no_leak(tol_bytes=1 << 20, device="cpu"):
        b = torch.ones((8, 8)) + 1
        del b
        gc.collect()
    with pytest.raises(AssertionError, match="leak"):
        with assert_no_leak(tol_bytes=1 << 20, device="cpu"):
            kept = torch.ones((512, 1024))
    del kept
    if not torch.cuda.is_available():
        assert device_memory_stats() == {}


def test_verbosity_stack(capsys):
    log("summary-level", Verbosity.SUMMARIZE)
    log("debug-level", Verbosity.DEBUG_VERBOSE)
    out = capsys.readouterr().out
    assert "summary-level" in out and "debug-level" not in out
    with push_verbosity(Verbosity.DEBUG_VERBOSE):
        assert get_verbosity() == Verbosity.DEBUG_VERBOSE
        with output_prefix("MG: "):
            log("inner", Verbosity.DEBUG_VERBOSE)
    assert get_verbosity() == Verbosity.SUMMARIZE
    assert "MG: inner" in capsys.readouterr().out
    with push_verbosity(Verbosity.VERBOSE):
        print_params(DiracParams(kind="wilson", kappa=0.12))
    assert "kappa = 0.12" in capsys.readouterr().out
    warn("careful")
    assert "WARNING: careful" in capsys.readouterr().err
    p = tmg.MGParams(n_level=3)
    assert check_params(p) is p
    object.__setattr__(p, "n_level", 5)
    with pytest.raises(ValueError, match="QUDA_MAX_MG_LEVEL"):
        check_params(p)


def test_nan_guards():
    assert_finite({"a": torch.ones(4), "b": torch.ones(3) + 1j}, "ok")
    with pytest.raises(FloatingPointError, match=r"bad\['a'\]"):
        assert_finite({"a": torch.tensor([1.0, float("nan")])}, "bad")
    with pytest.raises(FloatingPointError, match="badc"):
        assert_finite(torch.tensor([1.0 + 1j * float("inf")]), "badc")
    with pytest.raises(FloatingPointError, match=r"l\[1\]"):
        assert_finite([torch.ones(2), torch.tensor([float("inf")])], "l")


def test_invert_guard(monkeypatch):
    """``invert`` returns ``maybe_guard(x)``: a NaN source raises under
    ``QKXTM_GUARD=1`` and passes through without it."""
    u = np.asarray(jrng.random_gauge(jax.random.PRNGKey(3), GJ))
    d = dirac_from_numpy(u, DiracParams(kind="twisted-mass", kappa=0.12,
                                        mu=0.05), GT)
    b = T(np.asarray(jrng.random_spinor(jax.random.PRNGKey(4), GJ)))
    b[:, 0, 0, 0, 0, 0] = float("nan")            # a site of each parity
    monkeypatch.delenv("QKXTM_GUARD", raising=False)
    out = invert(d, b, tol=1e-6, maxiter=20)
    assert not bool(torch.isfinite(out.x).all())
    assert maybe_guard(out.x) is out.x
    monkeypatch.setenv("QKXTM_GUARD", "1")
    with pytest.raises(FloatingPointError, match="invert.x"):
        invert(d, b, tol=1e-6, maxiter=20)


# ---- profiling ------------------------------------------------------------

def test_time_profile_summary_matches_jax(monkeypatch):
    """The same categories, calls and flops on a fake clock give the JAX
    package's summary, line for line."""
    ticks = itertools.count(0.0, 0.25)
    monkeypatch.setattr("time.perf_counter", lambda: next(ticks))
    summaries = []
    for mod in (tprof, jprof):
        prof = mod.TimeProfile("solve")
        with prof("dslash", flops=2e9):
            pass
        for _ in range(3):
            with prof("blas"):
                pass
        prof.add_flops("blas", 1e9)
        summaries.append(prof.summary())
    assert summaries[0] == summaries[1]
    assert summaries[0].splitlines()[1].split()[0] == "blas"
    assert tprof.FLOPS_PER_SITE == jprof.FLOPS_PER_SITE


# ---- the MG benchmarks at a tiny size ------------------------------------

@pytest.mark.parametrize("n_level,vec_dtype", [(3, "f32"), (2, "bf16")])
def test_bench_mg_levels_small(n_level, vec_dtype):
    d, b = bm.make_problem(GT, "cpu", dtype=torch.complex64)
    rec, mg = bm.bench_mg(GT, problem=(d, b), n_level=n_level,
                          vec_dtype=vec_dtype,
                          mg_params=tmg.MGParams(nvec2=4), **SMALL)
    assert rec["true_res"] <= 5e-7
    assert rec["iters"] > 0
    assert rec["n_level"] == n_level and rec["vec_dtype"] == vec_dtype
    assert ("level2" in rec) == (n_level >= 3)
    assert mg.params.nvec2 == 4 and mg.params.smoother_pc


def test_bench_light_small():
    """The light-mass record on a two-rung ladder: every solve's own and
    complex128 residual, and ``mg_beats_cg`` only for a certified MG."""
    rec = bm.bench_light(GT, probe_geom=GT, kappas=(0.125, 0.15),
                         probe_iters_target=20, cg_maxiter=400,
                         device="cpu",
                         mg_params=tmg.MGParams(nvec2=4), **SMALL)
    assert [r["kappa"] for r in rec["probe_ladder"]] == [0.125, 0.15]
    assert rec["kappa"] == 0.15
    for tag in ("cg_", "mg_", "mg_dmu_", "mg3_dmu_"):
        assert np.isfinite(rec[tag + "res"])
        assert rec[tag + "true_res"] <= 5e-7
    assert rec["mg3_dmu_setup_stats"]["level2"]["bicgstab_iters"]
    verdict = bm._mg_verdict(rec, ("mg_", "mg_dmu_", "mg3_dmu_"), 1e-7)
    assert rec["mg_beats_cg"] == verdict["mg_beats_cg"]
    uncertified = dict(rec, mg_true_res=1e-3, mg_dmu_true_res=1e-3,
                       mg3_dmu_true_res=1e-3, mg_secs=0.0)
    assert bm._mg_verdict(uncertified, ("mg_", "mg_dmu_", "mg3_dmu_"),
                          1e-7) == {"mg_beats_cg": False,
                                    "amortise_solves": None}


def test_bench_light2_and_mg_vecs_small(tmp_path):
    rec = bm.bench_light2(GT, kappa=0.15, cg_maxiter=400, device="cpu",
                          **SMALL)
    assert rec["mg_dmu_true_res"] <= 5e-7 and rec["cg_true_res"] <= 5e-7
    assert isinstance(rec["mg_beats_cg"], bool)
    path = str(tmp_path / "vecs.npz")
    vec = bm.bench_mg_vecs(GT, path=path, problem=bm.make_problem(
        GT, "cpu", dtype=torch.complex64), **SMALL)
    assert vec["vec_file_mb"] > 0 and vec["true_res"] <= 5e-7
    assert vec["setup_secs_load"] < vec["setup_secs_generate"]
