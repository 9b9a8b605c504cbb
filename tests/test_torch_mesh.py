"""The t-sharded solve across processes: gloo rings of 1, 2 and 4 ranks on
the CPU (``tests/_torch_mesh_worker.py``, one process a rank, a file
store under the test's temporary directory) against the JAX package.

Each ring is spawned once and runs all its jobs; the tests read its
results.  The sharded fused matpc and matpc† (twisted-mass and
twisted-clover, K4 and K5 forms, here their plain versions) against the
JAX package's XLA ``Dirac.matpc`` in complex128 (atol 1e-5, the float32
chain); ``invert(mesh=…, tol=1e-12, maxiter=2)`` against the JAX
package's ``invert`` as in ``test_parallel.test_fused_invert_sharded``;
one converged solve on each ring against the port's unsharded fused CG;
the bf16 operand tier's sharded chain against its unsharded one.
The ring of 1 exchanges nothing (its faces are its own edge planes) but
sums through the process group; the ring of 2 has T_loc = 4 at 4³×8
(projected faces, both messages to one peer); the ring of 4 has
T_loc = 4 at 4³×16 (four distinct peers) and T_loc = 2 at 4³×8 (the
overlap form falls back to K4).
"""

import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import pytest
import torch

from quda_qkxtm_multigrid_tpu import dirac as jd
from quda_qkxtm_multigrid_tpu import fields as jfields
from quda_qkxtm_multigrid_tpu import lattice as jlat
from quda_qkxtm_multigrid_tpu.invert import invert as j_invert
from quda_qkxtm_multigrid_tpu.utils import rng as jrng

from quda_qkxtm_multigrid_tpu_torch import convert
from quda_qkxtm_multigrid_tpu_torch import lattice as tlat
from quda_qkxtm_multigrid_tpu_torch.convert import spinor_to_numpy as N
from quda_qkxtm_multigrid_tpu_torch.dirac import DiracParams
from quda_qkxtm_multigrid_tpu_torch.invert import invert
from quda_qkxtm_multigrid_tpu_torch.ops import dslash_kernel as dk

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve().parent / "_torch_mesh_worker.py"
JOIN_TIMEOUT = 240        # seconds for a whole ring, start-up included
TM = dict(kind="twisted-mass", kappa=0.115, mu=0.05)
TMC = dict(kind="twisted-clover", kappa=0.115, mu=0.05, csw=1.0)
KINDS = {"tm": TM, "tmc": TMC}
GEOMS = {"A": (4, 4, 4, 8), "B": (4, 4, 4, 16)}
CONVERGED_TOL = 1e-7


def _fields(dims, seed):
    geom = jlat.Geometry(*dims)
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    u = np.asarray(jrng.random_gauge(k1, geom))
    psi = np.asarray(jrng.random_spinor(k2, geom))
    b = np.asarray(jfields.point_source(geom, (0, 0, 0, 0), 0, 0))
    return u, psi, b


def _jobs(nt: int):
    """The jobs of the ring of ``nt`` ranks."""
    matpc_group = "B" if nt == 4 else "A"
    jobs = [dict(type="matpc", group=matpc_group, name=f"matpc/{k}/{ov}/{dg}",
                 params=KINDS[k], overlap=ov, dagger=dg)
            for k in KINDS for ov in (False, True) for dg in (False, True)]
    jobs += [dict(type="matpc", group=matpc_group, name=f"bf16/{dg}",
                  params=dict(TMC, kernel_bf16=True), overlap=True,
                  dagger=dg) for dg in (False, True)]
    if nt == 4:   # T_loc = 2: the overlap form's fallback to K4
        jobs += [dict(type="matpc", group="A", name=f"fallback/{k}/{dg}",
                      params=KINDS[k], overlap=True, dagger=dg)
                 for k in KINDS for dg in (False, True)]
    jobs += [dict(type="invert", group="A", name=f"invert2/{ov}", params=TM,
                  c64=True, tol=1e-12, maxiter=2, overlap=ov)
             for ov in (False, True)]
    jobs.append(dict(type="invert", group="A", name="converged",
                     params=TMC, tol=CONVERGED_TOL, maxiter=1000,
                     overlap=nt != 4))
    return jobs


def _spawn(nt: int, work: Path, inputs: dict) -> dict:
    """Run the ring of ``nt`` worker processes; returns each result with
    the ranks' slabs joined along t."""
    work.mkdir(parents=True, exist_ok=True)
    (work / "spec.json").write_text(json.dumps(
        {"groups": GEOMS, "jobs": _jobs(nt)}))
    np.savez(work / "inputs.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(r), str(nt),
                               str(work)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(nt)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=JOIN_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    outs = [np.load(work / f"out_{r}.npz") for r in range(nt)]
    res = {}
    for k in outs[0].files:
        if k.endswith("/iters") or k.endswith("/true_res"):
            vals = {float(o[k]) for o in outs}
            assert len(vals) == 1, (k, vals)     # every rank agrees
            res[k] = vals.pop()
        else:
            res[k] = np.concatenate([o[k] for o in outs], axis=-3)
    return res


@pytest.fixture(scope="module")
def inputs():
    data = {}
    for grp, dims in GEOMS.items():
        u, psi, b = _fields(dims, 61 if grp == "A" else 62)
        data.update({f"{grp}_u": u, f"{grp}_psi": psi, f"{grp}_b": b})
    return data


@pytest.fixture(scope="module")
def rings(inputs, tmp_path_factory):
    """nt → the ring's results, each ring spawned on first use."""
    done = {}

    def get(nt):
        if nt not in done:
            done[nt] = _spawn(nt, tmp_path_factory.mktemp(f"ring{nt}"),
                              inputs)
        return done[nt]
    return get


@functools.lru_cache(maxsize=None)
def _jax_dirac(kind: str, grp: str, c64: bool = False):
    u = _fields(GEOMS[grp], 61 if grp == "A" else 62)[0]
    if c64:
        u = u.astype(np.complex64)
    return jd.make_dirac(u, jd.DiracParams(**KINDS[kind]),
                         jlat.Geometry(*GEOMS[grp]))


@pytest.mark.parametrize("nt", [1, 2, 4])
@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("dagger", [False, True])
def test_sharded_matpc_matches_jax(rings, inputs, nt, kind, overlap,
                                   dagger):
    grp = "B" if nt == 4 else "A"
    got = rings(nt)[f"matpc/{kind}/{overlap}/{dagger}"]
    ref = np.asarray(_jax_dirac(kind, grp).matpc(inputs[f"{grp}_psi"][0],
                                                 dagger))
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize("nt", [1, 2, 4])
@pytest.mark.parametrize("dagger", [False, True])
def test_sharded_bf16_tier_is_the_unsharded_chain(rings, inputs, nt, dagger):
    """The bf16 operand tier (``kernel_bf16``, the JAX package's
    ``pallas_bf16``): the sharded chain reads bf16 gauge and A⁻¹ and
    gives the port's unsharded bf16-tier matpc (float32, 1e-6)."""
    grp = "B" if nt == 4 else "A"
    d = convert.dirac_from_numpy(
        inputs[f"{grp}_u"], DiracParams(**TMC, use_kernels=True,
                                        kernel_bf16=True),
        tlat.Geometry(*GEOMS[grp]), device="cpu")
    psi = convert.spinor_from_numpy(inputs[f"{grp}_psi"][0], device="cpu")
    ref = dk.from_channels(d._fused_matpc_ch(
        dk.to_channels(psi).to(torch.float32), dagger), (4, 3))
    got = rings(nt)[f"bf16/{dagger}"]
    assert (np.linalg.norm(got - N(ref)) / np.linalg.norm(N(ref))) <= 1e-6


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("dagger", [False, True])
def test_overlap_fallback_at_t_loc_2(rings, inputs, kind, dagger):
    """Ring of 4 at T = 8: T_loc = 2 has no interior, so the overlap
    form runs K4 on unprojected faces (the JAX package's fallback)."""
    got = rings(4)[f"fallback/{kind}/{dagger}"]
    ref = np.asarray(_jax_dirac(kind, "A").matpc(inputs["A_psi"][0],
                                                 dagger))
    np.testing.assert_allclose(got, ref, atol=1e-5)


@functools.lru_cache(maxsize=None)
def _jax_invert2():
    """The JAX package's XLA solve of ``test_fused_invert_sharded``:
    twisted-mass, complex64, tol 1e-12, two iterations."""
    b = _fields(GEOMS["A"], 61)[2].astype(np.complex64)
    ref = j_invert(_jax_dirac("tm", "A", c64=True), b, tol=1e-12, maxiter=2)
    return np.asarray(ref.x), float(ref.true_res)


@pytest.mark.parametrize("nt", [1, 2, 4])
@pytest.mark.parametrize("overlap", [False, True])
def test_sharded_invert_matches_jax(rings, nt, overlap):
    res = rings(nt)
    x_ref, tr_ref = _jax_invert2()
    assert res[f"invert2/{overlap}/iters"] == 2
    np.testing.assert_allclose(np.real(res[f"invert2/{overlap}/x"]),
                               np.real(x_ref), atol=1e-5)
    np.testing.assert_allclose(res[f"invert2/{overlap}/true_res"], tr_ref,
                               rtol=1e-3)


@pytest.fixture(scope="module")
def unsharded_iters(inputs):
    """The port's unsharded fused CG (complex128 operator, float32
    chain) on the converged job's problem."""
    d = convert.dirac_from_numpy(inputs["A_u"], DiracParams(
        **TMC, use_kernels=True), tlat.Geometry(*GEOMS["A"]), device="cpu")
    out = invert(d, convert.spinor_from_numpy(inputs["A_b"], device="cpu"),
                 tol=CONVERGED_TOL, maxiter=1000)
    return out.iters


@pytest.mark.parametrize("nt", [1, 2, 4])
def test_converged_sharded_solve(rings, unsharded_iters, nt):
    """Twisted-clover point source to tol 1e-7: the complex128 true
    residual of the whole lattice, and the unsharded solve's iteration
    count (overlap on the rings of 1 and 2, K4 on the ring of 4)."""
    res = rings(nt)
    assert res["converged/true_res"] <= 5e-7
    assert res["converged/iters"] == unsharded_iters
