"""One rank of the gloo rings of ``tests/test_torch_mesh.py``.

    python tests/_torch_mesh_worker.py RANK NT WORKDIR

Reads ``WORKDIR/spec.json`` (the geometries and the jobs) and
``WORKDIR/inputs.npz`` (the whole lattice's fields, made by the test
from the JAX package), joins the ring of NT ranks through the file store
``WORKDIR/store``, runs every job on this rank's t-slab with the port
alone, and writes its slabs of the results to ``WORKDIR/out_RANK.npz``.
It imports neither JAX nor the JAX package.
"""

import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from quda_qkxtm_multigrid_tpu_torch.convert import (
    sharded_dirac_from_numpy, spinor_slab_from_numpy)
from quda_qkxtm_multigrid_tpu_torch.dirac import DiracParams
from quda_qkxtm_multigrid_tpu_torch.invert import invert
from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry
from quda_qkxtm_multigrid_tpu_torch.ops.dslash_kernel import (
    from_channels, to_channels)
from quda_qkxtm_multigrid_tpu_torch.parallel.mesh import init_ring


def run(rank: int, nt: int, work: Path):
    torch.set_num_threads(1)
    spec = json.loads((work / "spec.json").read_text())
    data = np.load(work / "inputs.npz")
    mesh = init_ring(nt, rank, f"file://{work / 'store'}", device="cpu")
    ops, out = {}, {}
    for job in spec["jobs"]:
        grp, name = job["group"], job["name"]
        geom = Geometry(*spec["groups"][grp])
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
