"""One rank of the gloo rings of ``tests/test_torch_mesh.py``,
``tests/test_torch_mesh_mg.py`` and ``tests/test_torch_mesh_workflows.py``.

    python tests/_torch_mesh_worker.py RANK NT WORKDIR

Reads ``WORKDIR/spec.json`` (the geometries and the jobs) and
``WORKDIR/inputs.npz`` (the whole lattice's fields, made by the test
from the JAX package), joins the ring of NT ranks through the file store
``WORKDIR/store``, runs every job on this rank's t-slab with the port
alone, and writes its results to ``WORKDIR/out_RANK.npz``.  The
"matpc" and "invert" jobs write their slabs under plain names; the
other jobs (``JOBS``) name each result with how the test joins the
ranks' values (``tests/_torch_ring.py``): "...|cat" a t-slab [..., T, Z,
W], "...|same" a value every rank holds whole (it must be the same on
every rank), "...|each" one rank's own value.  It imports neither JAX
nor the JAX package.
"""

import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from quda_qkxtm_multigrid_tpu_torch import convert, workflows
from quda_qkxtm_multigrid_tpu_torch.benchmarks import bench_mg_mesh
from quda_qkxtm_multigrid_tpu_torch.convert import (
    sharded_dirac_from_numpy, spinor_slab_from_numpy)
from quda_qkxtm_multigrid_tpu_torch.dirac import DiracParams
from quda_qkxtm_multigrid_tpu_torch.invert import invert, true_residual
from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry, gather_neighbor
from quda_qkxtm_multigrid_tpu_torch.mg.multigrid import (
    MGParams, MGPreconditioner, mg_solve, shard_mg)
from quda_qkxtm_multigrid_tpu_torch.mg.transfer import BlockGeometry
from quda_qkxtm_multigrid_tpu_torch.ops.dslash_kernel import (
    from_channels, to_channels)
from quda_qkxtm_multigrid_tpu_torch.ops.smear import ape_smear, covdev_apply
from quda_qkxtm_multigrid_tpu_torch.parallel.mesh import (
    init_ring, local_geometry, t_slab)
from quda_qkxtm_multigrid_tpu_torch.parallel.schwarz import (
    schwarz_precond, schwarz_precond_multiplicative)
from quda_qkxtm_multigrid_tpu_torch.parallel.sharded import shard_dirac
from quda_qkxtm_multigrid_tpu_torch.solvers.gcr import gcr


def _dirac(data, job, geom, mesh, key="u"):
    """The whole lattice's operator of ``job`` (complex128, on the CPU)."""
    return convert.dirac_from_numpy(data[job.get("u", key)],
                                    DiracParams(**job["params"]), geom,
                                    device="cpu")


def _carried_mg(job, data, geom, mesh):
    """The whole lattice's operator and its preconditioner on the JAX
    package's MG state (V, coarse X and Y) carried across."""
    d = _dirac(data, job, geom, mesh)
    params = MGParams(**job["mg"])
    bg = BlockGeometry(geom, *params.block, nvec=params.nvec)
    return d, MGPreconditioner(
        transfer=convert.transfer_from_numpy(data["mg_v"], bg,
                                             device="cpu"),
        coarse=convert.coarse_op_from_numpy(data["mg_x"], data["mg_y"], bg,
                                            device="cpu"),
        dirac=d, params=params)


def _job_mg(job, data, geom, mesh, out):
    """``mg_solve(mesh=…)`` on the carried-across MG, after
    ``shard_mg``."""
    _, mg = _carried_mg(job, data, geom, mesh)
    ms = shard_mg(mg, mesh)
    b = spinor_slab_from_numpy(data["b"], mesh)
    name = job["name"]
    if job["type"] == "mg_vcycle":
        # one V-cycle: every rank's coarse solution, and the result
        coarse, solve = [], ms.coarse_solve

        def recorded(rc):
            coarse.append(solve(rc))
            return coarse[-1]
        ms.coarse_solve = recorded
        out[f"{name}/x|cat"] = ms.vcycle(b, mesh).numpy()
        out[f"{name}/coarse|each"] = coarse[0].numpy()
        return
    res = mg_solve(ms, b, tol=job["tol"], max_restarts=job["max_restarts"],
                   n_krylov=job.get("n_krylov", 10), solver=job["solver"],
                   mesh=mesh)
    out[f"{name}/x|cat"] = res.x.numpy()
    out[f"{name}/iters|same"] = np.asarray(res.iters)
    out[f"{name}/r2|same"] = np.asarray(float(res.r2))


def _job_bench(job, data, geom, mesh, out):
    """``benchmarks.bench_mg_mesh`` on the carried-across MG: its record
    but the seconds."""
    d, mg = _carried_mg(job, data, geom, mesh)
    rec, _ = bench_mg_mesh(mesh, (d, torch.tensor(data["b"])), mg,
                           tol=job["tol"], solver=job["solver"],
                           n_krylov=job["n_krylov"])
    for k, v in rec.items():
        if k != "secs":
            out[f"{job['name']}/{k}|same"] = np.asarray(v)


def _job_schwarz(job, data, geom, mesh, out):
    """GCR on the sharded full operator, plain and with the additive and
    the multiplicative Schwarz preconditioners; "schwarz_block": one
    application of each preconditioner."""
    ds = shard_dirac(_dirac(data, job, geom, mesh), mesh)
    b = spinor_slab_from_numpy(data[job.get("b", "b")], mesh)
    kinds = {"plain": None,
             "additive": schwarz_precond(ds, mesh, niter=4),
             "multiplicative": schwarz_precond_multiplicative(ds, mesh,
                                                              niter=4)}
    for kind, pc in kinds.items():
        name = f"{job['name']}/{kind}"
        if job["type"] == "schwarz_block":
            if pc is not None:
                out[f"{name}|cat"] = pc(b).numpy()
            continue
        res = gcr(ds.m, b, tol=1e-8, n_krylov=10, max_restarts=40,
                  precond=pc, allreduce=mesh.allreduce)
        out[f"{name}/x|cat"] = res.x.numpy()
        out[f"{name}/iters|same"] = np.asarray(res.iters)
        _, rel = true_residual(ds, res.x, b)
        out[f"{name}/true_res|same"] = np.asarray(float(rel))


def _job_solve(job, data, geom, mesh, out):
    """``invert(mesh=…)`` in complex128 with ``job["solver"]``."""
    ds = shard_dirac(_dirac(data, job, geom, mesh), mesh)
    b = spinor_slab_from_numpy(data[job["b"]], mesh)
    res = invert(ds, b, tol=job["tol"], maxiter=job["maxiter"],
                 solver=job["solver"], mesh=mesh)
    out[f"{job['name']}/x|cat"] = res.x.numpy()
    out[f"{job['name']}/iters|same"] = np.asarray(res.iters)
    out[f"{job['name']}/true_res|same"] = np.asarray(res.true_res)


def _job_pieces(job, data, geom, mesh, out):
    """The ring pieces on this rank's slab: the t gather of a field both
    ways, the covariant shifts, and a transfer's ``t_slab`` restrict
    (its slab of the coarse field) and prolong (of the whole coarse
    field's rows of this rank)."""
    u = torch.tensor(data["u"])
    psi = torch.tensor(data["psi"])
    gl = local_geometry(geom, mesh)
    u_l, psi_l = t_slab(u, mesh), t_slab(psi, mesh)
    for fwd in (True, False):
        out[f"gather/{fwd}|cat"] = gather_neighbor(psi_l[0], 3, fwd, 1, gl,
                                                   mesh=mesh).numpy()
        for mu in range(4):
            out[f"covdev/{mu}/{fwd}|cat"] = covdev_apply(
                u_l, psi_l, mu, fwd, gl, mesh=mesh).numpy()
    bg = BlockGeometry(geom, *job["block"], nvec=job["nvec"])
    tr = convert.transfer_from_numpy(data["mg_v"], bg, device="cpu")
    ts = tr.t_slab(mesh)
    out["restrict|each"] = ts.restrict(psi_l).numpy()
    vc = torch.tensor(data["coarse_vec"])
    t0, n = mesh.t_range(vc.shape[2])
    out["prolong|cat"] = ts.prolong(vc.narrow(2, t0, n)).numpy()


def _job_workflow(job, data, geom, mesh, out):
    """``run_twop``, ``run_threep`` or ``run_loops`` with ``mesh``; every
    result is whole on every rank."""
    u = torch.tensor(data[job["u"]])
    kw = dict(job["kw"])
    name = job["name"]
    if job["type"] == "twop":
        res = workflows.run_twop(u, geom, mesh=mesh, **kw)
        for k in ("mesons", "baryons", "prop_up", "u_ape"):
            out[f"{name}/{k}|same"] = res[k].numpy()
    elif job["type"] == "threep":
        res = workflows.run_threep(
            u, geom, prop_up=torch.tensor(data["pu"]),
            prop_dn=torch.tensor(data["pu"]).conj(),
            u_ape=ape_smear(u, geom, 0.5, 2), mesh=mesh, **kw)
        for part, ins in res["thrp"]["G4"].items():
            for k, v in ins.items():
                out[f"{name}/{part}/{k}|same"] = v.numpy()
    else:
        # the noise, drawn on the whole lattice, from the inputs (the JAX
        # package's) or from a generator seeded alike on every rank
        noise = list(torch.tensor(data[job["noise"]])) if "noise" in job \
            else None
        draw = workflows.z4_source
        if noise is not None:
            workflows.z4_source = lambda gen, geom, dtype: noise.pop(0)
        try:
            res = workflows.run_loops(u, geom, gen=torch.Generator(),
                                      mesh=mesh, **kw)
        finally:
            workflows.z4_source = draw
        for k, v in res.items():
            out[f"{name}/{k}|same"] = v.numpy()


JOBS = {"mg": _job_mg, "mg_vcycle": _job_mg, "bench_mg": _job_bench,
        "schwarz": _job_schwarz,
        "schwarz_block": _job_schwarz, "solve": _job_solve,
        "pieces": _job_pieces, "twop": _job_workflow,
        "threep": _job_workflow, "loops": _job_workflow}


def run(rank: int, nt: int, work: Path):
    torch.set_num_threads(1)
    spec = json.loads((work / "spec.json").read_text())
    data = np.load(work / "inputs.npz")
    mesh = init_ring(nt, rank, f"file://{work / 'store'}", device="cpu")
    ops, out = {}, {}
    for job in spec["jobs"]:
        grp, name = job["group"], job["name"]
        geom = Geometry(*spec["groups"][grp])
        if job["type"] in JOBS:
            JOBS[job["type"]](job, data, geom, mesh, out)
            continue
        dtype = np.complex64 if job.get("c64") else np.complex128
        key = (grp, json.dumps(job["params"]), dtype)
        if key not in ops:
            ops[key] = sharded_dirac_from_numpy(
                data[f"{grp}_u"].astype(dtype),
                DiracParams(**job["params"], use_kernels=True), geom, mesh)
        d = ops[key]
        if job["type"] == "matpc":
            psi = spinor_slab_from_numpy(data[f"{grp}_psi"][0], mesh)
            res = d.matpc_ch(to_channels(psi).to(torch.float32),
                             job["dagger"], job["overlap"])
            out[name] = from_channels(res, (4, 3)).numpy()
        else:
            b = spinor_slab_from_numpy(data[f"{grp}_b"].astype(dtype), mesh)
            res = invert(d, b, tol=job["tol"], maxiter=job["maxiter"],
                         mesh=mesh, overlap=job["overlap"])
            out[f"{name}/x"] = res.x.numpy()
            out[f"{name}/iters"] = np.asarray(res.iters)
            out[f"{name}/true_res"] = np.asarray(res.true_res)
    np.savez(work / f"out_{rank}.npz", **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    run(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))
