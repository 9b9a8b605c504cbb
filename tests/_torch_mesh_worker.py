"""One rank of the gloo rings of ``tests/test_torch_mesh.py`` and the
``tests/test_torch_mesh_*.py`` files (MG, workflows, eigen, the deflated
loops, the slab-local build and what a rank keeps, the sharded setup).

    python tests/_torch_mesh_worker.py RANK GT[,GZ,GW] WORKDIR

Reads ``WORKDIR/spec.json`` (the geometries and the jobs) and
``WORKDIR/inputs.npz`` (the whole lattice's fields, made by the test
from the JAX package), joins the ring of GT ranks, or the grid (GT, GZ,
GW), through the file store ``WORKDIR/store``, runs every job on this
rank's t-slab or box with the port alone, and writes its results to
``WORKDIR/out_RANK.npz``.  The "matpc" and "invert" jobs write their
slabs under plain names; the other jobs (``JOBS``) name each result
with how the test joins the ranks' values (``tests/_torch_ring.py``):
"...|cat" a box [..., T, Z, W], "...|same" a value every rank holds
whole (it must be the same on every rank), "...|each" one rank's own
value.  It imports neither JAX
nor the JAX package.
"""

import dataclasses
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
    MGParams, MGPreconditioner, mg_solve, setup_mg, shard_mg)
from quda_qkxtm_multigrid_tpu_torch.mg.transfer import BlockGeometry
from quda_qkxtm_multigrid_tpu_torch.ops.dslash_kernel import (
    from_channels, to_channels)
from quda_qkxtm_multigrid_tpu_torch.ops.smear import ape_smear, covdev_apply
from quda_qkxtm_multigrid_tpu_torch.parallel import halo
from quda_qkxtm_multigrid_tpu_torch.parallel.mesh import (
    init_ring, local_geometry, make_lattice_mesh, t_slab)
from quda_qkxtm_multigrid_tpu_torch.parallel.schwarz import (
    schwarz_precond, schwarz_precond_multiplicative)
from quda_qkxtm_multigrid_tpu_torch.parallel.sharded import (
    make_sharded_dirac, shard_dirac)
from quda_qkxtm_multigrid_tpu_torch.solvers import eigen
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


def _job_hop(job, data, geom, mesh, out):
    """The bare hop of this rank's box (``ShardedDirac.dslash``: the face
    exchange, then K4's plain version on the CPU) of the whole lattice's
    spinor ``psi`` [2, 4, 3, T, Z, W], parity 0 from parity 1; with
    ``equal_tags`` every halo message carries one tag, so only the order
    in which they are issued pairs them."""
    ds = shard_dirac(_dirac(data, job, geom, mesh), mesh)
    psi = spinor_slab_from_numpy(data[job["psi"]], mesh)
    tags = dict(halo._TAGS)
    if job.get("equal_tags"):
        halo._TAGS.update({a: (0, 0) for a in halo._TAGS})
    try:
        out[f"{job['name']}|cat"] = ds.dslash(psi[1], 0).numpy()
    finally:
        halo._TAGS.update(tags)


def _job_refusals(job, data, geom, mesh, out):
    """What ``make_lattice_mesh`` refuses on this group: a grid of
    another size, and a backend other than the group's (each error's
    message, or "" where it did not raise)."""
    cases = {"size": dict(grid=(mesh.nt, mesh.nz, 1) if mesh.nw > 1
                          else (mesh.nt, mesh.nz, 2)),
             "backend": dict(grid=mesh.grid, backend="nccl")}
    for name, kw in cases.items():
        try:
            make_lattice_mesh(device="cpu", **kw)
            msg = ""
        except ValueError as e:
            msg = str(e)
        out[f"refusals/{name}|same"] = np.asarray(msg)


def _job_box_pieces(job, data, geom, mesh, out):
    """The box pieces: the neighbour gather of every direction both ways,
    the covariant shifts, and a transfer's restrict (the box's coarse
    rows) and prolong (of the whole coarse field's box) on the box."""
    u = spinor_slab_from_numpy(data["u"], mesh)
    psi = spinor_slab_from_numpy(data["psi"], mesh)
    gl = local_geometry(geom, mesh)
    for fwd in (True, False):
        for mu in range(4):
            out[f"gather/{mu}/{fwd}|cat"] = gather_neighbor(
                psi[0], mu, fwd, 1, gl, mesh=mesh).numpy()
            out[f"covdev/{mu}/{fwd}|cat"] = covdev_apply(
                u, psi, mu, fwd, gl, mesh=mesh).numpy()
    bg = BlockGeometry(geom, *job["block"], nvec=job["nvec"])
    tr = convert.transfer_from_numpy(data["mg_v"], bg, device="cpu")
    ts = tr.t_slab(mesh)
    out["restrict|each"] = ts.restrict(psi).numpy()
    vc = torch.tensor(data["coarse_vec"])
    for axis in range(3):
        vc = vc.narrow(axis + 2, *mesh.box_range(axis, vc.shape[axis + 2]))
    out["prolong|cat"] = ts.prolong(vc).numpy()


def _job_op(job, data, geom, mesh, out):
    """The sharded operator's fused chain on the rank's box:
    ``ShardedDirac.matpc`` both ways and ``matpc_dagm`` of the first
    parity of ``job["psi"]``, with the operator and the field in each
    precision of ``job["precs"]`` ("c128", "c64")."""
    types = {"c128": np.complex128, "c64": np.complex64}
    for prec in job["precs"]:
        dtype = types[prec]
        ds = sharded_dirac_from_numpy(
            data[job["u"]].astype(dtype),
            DiracParams(**job["params"], use_kernels=True), geom, mesh)
        psi = spinor_slab_from_numpy(data[job["psi"]][0].astype(dtype), mesh)
        name = f"{job['name']}/{prec}"
        for dagger in (False, True):
            out[f"{name}/matpc/{dagger}|cat"] = ds.matpc(psi, dagger).numpy()
        out[f"{name}/dagm|cat"] = ds.matpc_dagm(psi).numpy()


def _job_workflow(job, data, geom, mesh, out):
    """``run_twop``, ``run_threep`` or ``run_loops`` with ``mesh``: the
    correlators and loops whole on every rank, the 2pt's propagators and
    APE links the rank's slabs."""
    u = torch.tensor(data[job["u"]])
    kw = dict(job["kw"])
    name = job["name"]
    if job["type"] == "twop":
        res = workflows.run_twop(u, geom, mesh=mesh, **kw)
        for k in ("mesons", "baryons"):
            out[f"{name}/{k}|same"] = res[k].numpy()
        for k in ("prop_up", "u_ape"):
            out[f"{name}/{k}|cat"] = res[k].numpy()
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


def _job_eigen(job, data, geom, mesh, out):
    """``lanczos``, ``spectrum_bounds``, ``project_out`` and
    ``deflate_guess`` with ``allreduce=mesh.allreduce`` on this rank's
    slab of M_pc†M_pc (``make_operator(mesh=…)``), from the slab of the
    whole start vector ``v0``."""
    d = workflows.make_operator(torch.tensor(data[job["u"]]),
                                DiracParams(**job["params"]), geom,
                                mesh=mesh)
    v0 = spinor_slab_from_numpy(data["v0"], mesh)
    ex = torch.zeros_like(v0)
    red = mesh.allreduce
    name = job["name"]
    res = eigen.lanczos(d.matpc_dagm, ex, allreduce=red, v0=v0,
                        **job["lanczos"])
    out[f"{name}/evals|same"] = res.evals.numpy()
    out[f"{name}/resid|same"] = res.resid.numpy()
    out[f"{name}/evecs|cat"] = res.evecs.numpy()
    out[f"{name}/bounds|same"] = np.asarray(eigen.spectrum_bounds(
        d.matpc_dagm, ex, job["lanczos"]["nev"], steps=job["steps"],
        allreduce=red, v0=v0))
    b = spinor_slab_from_numpy(data["b_pc"], mesh)
    out[f"{name}/project|cat"] = eigen.project_out(res.evecs, b,
                                                   red).numpy()
    out[f"{name}/deflate|cat"] = eigen.deflate_guess(res.evecs, res.evals,
                                                     b, red).numpy()


def _job_wexact(job, data, geom, mesh, out):
    """``run_loops_wexact(mesh=…)`` from the whole start vector and noise
    of the inputs (the JAX package's draws), sliced by the workflow."""
    noise = list(torch.tensor(data[job["noise"]]))
    start, draw = eigen._start_vector, workflows.z4_source
    eigen._start_vector = lambda ex, gen: torch.tensor(data[job["v0"]])
    workflows.z4_source = lambda gen, geom, dtype: noise.pop(0)
    st = {}
    try:
        loops, eig = workflows.run_loops_wexact(
            torch.tensor(data[job["u"]]), geom, gen=torch.Generator(),
            mesh=mesh, stats=st, **job["kw"])
    finally:
        eigen._start_vector, workflows.z4_source = start, draw
    name = job["name"]
    for k, v in loops.items():
        out[f"{name}/{k}|same"] = v.numpy()
    out[f"{name}/evals|same"] = eig.evals.numpy()
    out[f"{name}/resid|same"] = eig.resid.numpy()
    out[f"{name}/cg_iters|same"] = np.asarray(st["cg_iters"])


def _job_build(job, data, geom, mesh, out):
    """The slab-local operator build (``make_sharded_dirac``) of the
    periodic and the antiperiodic gauge, field by field, and
    ``ape_smear(mesh=…)``, spatial and four-dimensional."""
    for key in ("u", "u_ap"):
        u = spinor_slab_from_numpy(data[key], mesh)
        d = make_sharded_dirac(u, DiracParams(**job["params"]), geom, mesh)
        for f in ("u_doubled", "clover", "clover_inv"):
            out[f"build/{key}/{f}|cat"] = getattr(d, f).numpy()
        out[f"build/{key}/antiperiodic|same"] = np.asarray(d.antiperiodic)
        gl = local_geometry(geom, mesh)
        for spatial in (True, False):
            out[f"ape/{key}/{spatial}|cat"] = ape_smear(
                u, gl, 0.5, 2, spatial_only=spatial, mesh=mesh).numpy()


def _whole_t(obj, t_whole, path: str = "", seen=None) -> list:
    """The paths of the tensors reachable from ``obj`` (attributes,
    buffers, dict / sequence items, dataclass fields) that have an axis
    of the whole lattice's t extent ``t_whole`` (or of any extent of a
    sequence of them), and how many tensors were seen (as
    ``[(path, shape)], count``)."""
    seen = set() if seen is None else seen
    if id(obj) in seen:
        return [], 0
    seen.add(id(obj))
    wholes = (t_whole,) if isinstance(t_whole, int) else tuple(t_whole)
    if torch.is_tensor(obj):
        return ([(path, tuple(obj.shape))]
                if any(n in obj.shape for n in wholes) else []), 1
    if isinstance(obj, dict):
        items = obj.items()
    elif isinstance(obj, (list, tuple)):
        items = enumerate(obj)
    elif isinstance(obj, torch.nn.Module):
        items = vars(obj).items()
    elif dataclasses.is_dataclass(obj):
        items = vars(obj).items()
    elif hasattr(obj, "__dict__") and type(obj).__module__.startswith(
            "quda_qkxtm_multigrid_tpu_torch"):
        items = vars(obj).items()
    else:
        return [], 0
    found, count = [], 0
    for k, v in items:
        f, c = _whole_t(v, t_whole, f"{path}/{k}", seen)
        found += f
        count += c
    return found, count


def _job_memory(job, data, geom, mesh, out):
    """What a rank keeps on the meshed paths, walked for a tensor with
    the whole lattice's t extent (T occurs in no other axis at this
    geometry): the sharded operator after its chain ran, the sharded MG
    pair set up on the slabs and used, ``run_twop``'s returned state and
    stats, and the 3pt, loops and deflated loops' stats and modes."""
    u = torch.tensor(data[job["u"]])
    kw = dict(job["kw"])
    workflows._FORCE_KERNELS = True
    kept = {}
    try:
        d = workflows.make_operator(u, DiracParams(**job["params"]), geom,
                                    mesh=mesh)
        v = spinor_slab_from_numpy(data[job["b"]], mesh)
        d.matpc_dagm(v[0])
        d.matpc_ch(to_channels(v[0]).to(torch.float32), True)
        kept["operator"] = d
        st = {}
        twop = workflows.run_twop(u, geom, mesh=mesh, stats=st,
                                  mg_params=MGParams(**job["mg"]),
                                  **job["twop"], **kw)
        kept["twop"] = {k: twop[k] for k in ("prop_up", "prop_dn", "u_ape",
                                             "mg_pair")}
        kept["twop_stats"] = st
        st = {}
        workflows.run_threep(u, geom, prop_up=twop["prop_up"],
                             prop_dn=twop["prop_dn"], u_ape=twop["u_ape"],
                             tsink=job["tsink"], projectors=["G4"],
                             mesh=mesh, stats=st, **kw)
        kept["threep_stats"] = st
        phys = {k: kw[k] for k in ("kappa", "mu", "csw", "tol", "maxiter")}
        st = {}
        workflows.run_loops(u, geom, n_stoch=1, n_hp=1,
                            gen=torch.Generator().manual_seed(3), mesh=mesh,
                            stats=st, **phys)
        kept["loops_stats"] = st
        st = {}
        _, eig = workflows.run_loops_wexact(
            u, geom, nev=2, ncv=12, n_stoch=1, lanczos_tol=1e-6,
            gen=torch.Generator().manual_seed(4), mesh=mesh, stats=st,
            **phys)
        kept["wexact"] = (eig, st)
    finally:
        workflows._FORCE_KERNELS = None
    found, count = _whole_t(kept, job.get("whole", geom.T))
    out["memory/whole|each"] = np.asarray([f"{p} {s}" for p, s in found],
                                          dtype=str)
    out["memory/tensors|each"] = np.asarray(count)
    out["memory/iters|each"] = np.asarray(
        kept["twop_stats"]["up"]["iters"])


def _job_setup(job, data, geom, mesh, out):
    """``setup_mg`` on this rank's ``make_operator(mesh=…)``: on the null
    vectors of the inputs (the rank's slabs), and generated from a
    seeded generator (``chain``: on the fused route, one sharded CG a
    column, through the plain versions); each preconditioner's coarse X
    / Y (whole on every rank), its V (the rank's rows) and a
    ``mg_solve(mesh=…)``."""
    workflows._FORCE_KERNELS = job.get("chain")
    try:
        d = workflows.make_operator(torch.tensor(data[job["u"]]),
                                    DiracParams(**job["params"]), geom,
                                    mesh=mesh)
    finally:
        workflows._FORCE_KERNELS = None
    params = MGParams(**job["mg"])
    b = spinor_slab_from_numpy(data[job["b"]], mesh)
    setups = {"generated": lambda: setup_mg(
        d, params, torch.Generator().manual_seed(job["seed"]))}
    if "nv" in job:
        nvs = [spinor_slab_from_numpy(v, mesh) for v in data[job["nv"]]]
        setups["given"] = lambda: setup_mg(d, params, None,
                                           null_vectors=nvs)
    for how, setup in setups.items():
        mg = setup()
        name = f"{job['name']}/{how}"
        out[f"{name}/x|same"] = mg.coarse.x.numpy()
        out[f"{name}/y|same"] = mg.coarse.y.numpy()
        out[f"{name}/v|each"] = mg.transfer.v.numpy()
        res = mg_solve(mg, b, mesh=mesh, **job["solve"])
        out[f"{name}/iters|same"] = np.asarray(res.iters)
        out[f"{name}/x_sol|cat"] = res.x.numpy()


JOBS = {"mg": _job_mg, "mg_vcycle": _job_mg, "bench_mg": _job_bench,
        "schwarz": _job_schwarz,
        "schwarz_block": _job_schwarz, "solve": _job_solve,
        "pieces": _job_pieces, "twop": _job_workflow,
        "threep": _job_workflow, "loops": _job_workflow,
        "eigen": _job_eigen, "wexact": _job_wexact, "build": _job_build,
        "memory": _job_memory, "setup": _job_setup, "hop": _job_hop,
        "box_pieces": _job_box_pieces, "refusals": _job_refusals,
        "op": _job_op}


def run(rank: int, grid: tuple, work: Path):
    torch.set_num_threads(1)
    spec = json.loads((work / "spec.json").read_text())
    data = np.load(work / "inputs.npz")
    mesh = init_ring(grid, rank, f"file://{work / 'store'}", device="cpu")
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
    grid = tuple(int(g) for g in sys.argv[2].split(","))
    run(int(sys.argv[1]), grid if len(grid) == 3 else (grid[0], 1, 1),
        Path(sys.argv[3]))
