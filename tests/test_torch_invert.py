"""The slice end to end: the port's ``cg`` and ``invert`` against the JAX
package's on the same complex128 gauge field and source (CPU), the
benchmark entry point at a small size, and ``chip_smoke.py``'s refusal
to run without a GPU.
"""

import functools
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from quda_qkxtm_multigrid_tpu import dirac as jd
from quda_qkxtm_multigrid_tpu import fields as jfields
from quda_qkxtm_multigrid_tpu import lattice as jlat
from quda_qkxtm_multigrid_tpu.invert import invert as j_invert
from quda_qkxtm_multigrid_tpu.solvers.cg import cg as j_cg
from quda_qkxtm_multigrid_tpu.utils import rng as jrng

from quda_qkxtm_multigrid_tpu_torch import dirac as td
from quda_qkxtm_multigrid_tpu_torch import lattice as tlat
from quda_qkxtm_multigrid_tpu_torch.benchmarks import (
    bench_cg, make_problem, tmc_params)
from quda_qkxtm_multigrid_tpu_torch import convert
from quda_qkxtm_multigrid_tpu_torch.convert import spinor_to_numpy as N
from quda_qkxtm_multigrid_tpu_torch.invert import invert, true_residual
from quda_qkxtm_multigrid_tpu_torch.ops import dslash_kernel as dk
from quda_qkxtm_multigrid_tpu_torch.solvers.cg import cg

# the tests run on the CPU; the converters default to the card
dirac_from_numpy = functools.partial(convert.dirac_from_numpy, device="cpu")
T = functools.partial(convert.spinor_from_numpy, device="cpu")

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
GJ = jlat.Geometry(4, 4, 4, 8)
GT = tlat.Geometry(4, 4, 4, 8)
TMC = dict(kind="twisted-clover", kappa=0.115, mu=0.05, csw=1.0)


def rel(got, ref) -> float:
    got = N(got) if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    return float(np.linalg.norm((got - ref).ravel())
                 / np.linalg.norm(ref.ravel()))


# ---- cg ------------------------------------------------------------------

def _hpd(n=40, seed=0):
    r = np.random.default_rng(seed)
    a = r.standard_normal((n, n)) + 1j * r.standard_normal((n, n))
    return a.conj().T @ a / n + 0.5 * np.eye(n), \
        r.standard_normal(n) + 1j * r.standard_normal(n)


@pytest.mark.parametrize("tol", [1e-6, 1e-10])
def test_cg_matches_jax(tol):
    a, b = _hpd()
    ref = j_cg(lambda v: jnp.asarray(a) @ v, jnp.asarray(b), tol=tol,
               maxiter=500)
    at = T(a)
    got = cg(lambda v: at @ v, T(b), tol=tol, maxiter=500)
    assert got.iters == int(ref.iters)
    assert rel(got.x, ref.x) <= 1e-9
    assert float(got.r2) <= tol * tol * float(np.vdot(b, b).real)


def test_cg_maxiter_and_x0():
    a, b = _hpd(seed=1)
    at = T(a)
    res = cg(lambda v: at @ v, T(b), tol=1e-14, maxiter=3)
    assert res.iters == 3
    again = cg(lambda v: at @ v, T(b), x0=res.x, tol=1e-10, maxiter=500)
    x_true = np.linalg.solve(a, b)
    assert rel(again.x, x_true) <= 1e-8
    zero = cg(lambda v: at @ v, T(b), x0=T(x_true), tol=1e-6)
    assert zero.iters == 0


# ---- invert: the slice -----------------------------------------------------

@pytest.fixture(scope="module")
def problem():
    u = np.asarray(jrng.random_gauge(jax.random.PRNGKey(51), GJ))
    b = np.asarray(jfields.point_source(GJ, (1, 0, 2, 3), 0, 0))
    dj = jd.make_dirac(u, jd.DiracParams(**TMC), GJ)
    ref = j_invert(dj, b, tol=1e-9, maxiter=1000)
    return u, b, ref


def test_invert_slice_matches_jax(problem):
    """Plain CG branch, complex128 throughout, tol 1e-9."""
    u, b, ref = problem
    d = dirac_from_numpy(u, td.DiracParams(**TMC), GT)
    out = invert(d, T(b), tol=1e-9, maxiter=1000)
    assert abs(out.iters - int(ref.iters)) <= 1
    assert rel(out.x, ref.x) <= 1e-8
    assert out.true_res <= 1e-8 and float(ref.true_res) <= 1e-8


def test_invert_fused_chain_matches_jax(problem):
    """The kernel branch (float32 channel CG on dslash_ch, here its plain
    version) against the JAX complex128 solution; tol 1e-6 is within
    float32 reach."""
    u, b, ref = problem
    d = dirac_from_numpy(u, td.DiracParams(**TMC, use_kernels=True), GT)
    assert d._has_fused_matpc
    out = invert(d, T(b), tol=1e-6, maxiter=1000)
    assert out.x.dtype == torch.complex128
    assert out.iters <= int(ref.iters)
    assert out.true_res <= 1e-5
    assert rel(out.x, ref.x) <= 1e-5


def test_true_residual_of_exact_solution(problem):
    u, _, _ = problem
    d = dirac_from_numpy(u, td.DiracParams(**TMC, use_kernels=True), GT)
    x = T(np.asarray(jrng.random_spinor(jax.random.PRNGKey(52), GJ)))
    r, rres = true_residual(d, x, d.m(x))
    assert r.shape == x.shape and float(rres) <= 1e-14


def test_invert_rejects_unported_solver(problem):
    u, b, _ = problem
    d = dirac_from_numpy(u, td.DiracParams(**TMC), GT)
    with pytest.raises(ValueError, match="unknown solver 'gcr'"):
        invert(d, T(b), solver="gcr")


# ---- benchmark entry point and chip_smoke.py -------------------------------

def test_tmc_params():
    p = tmc_params()
    assert (p.kind, p.kappa, p.mu, p.csw, p.use_kernels) == (
        "twisted-clover", 0.115, 0.05, 1.0, True)


def test_bench_cg_on_cpu():
    before = dk.dslash_ch.launches
    d, b = make_problem(GT, "cpu", seed=3)
    assert b.device.type == "cpu" and d.u.dtype == torch.complex128
    res = bench_cg(GT, tol=1e-6, maxiter=500, problem=(d, b))
    assert res["solver"] == "cg-fused"
    assert res["iters"] == res["iters_cold"] and 0 < res["iters"] < 500
    assert res["true_res"] <= 1e-5 and res["secs"] > 0 and res["gflops"] > 0
    assert dk.dslash_ch.launches == before     # no kernel on the CPU


def _run_smoke(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_fails_without_gpu():
    proc = _run_smoke(ROOT)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "torch.cuda.is_available() is false" in proc.stderr


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
