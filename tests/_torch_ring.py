"""Spawning a gloo ring or grid of ``tests/_torch_mesh_worker.py``
processes on the CPU for the tests of the sharded port (one process a
rank, a file store under the test's temporary directory), and joining
the ranks' results by the suffix of their names: "|cat" boxes joined by
their grid coordinates along t, z and the merged axis w (axes −3, −2,
−1; on a ring (nt, 1, 1) the t-slabs joined along t), "|same" a value
that must be equal on every rank (one copy returned), "|each" the list
of every rank's value."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve().parent / "_torch_mesh_worker.py"
JOIN_TIMEOUT = 240        # seconds for a whole ring, start-up included


def _join_boxes(vals: list, grid: tuple) -> np.ndarray:
    """The ranks' boxes (rank r at (it, iz, iw), r = (it·Gz + iz)·Gw +
    iw) joined along axes −3, −2 and −1."""
    nt, nz, nw = grid
    rows = []
    for it in range(nt):
        planes = [np.concatenate(vals[(it * nz + iz) * nw:
                                      (it * nz + iz + 1) * nw], axis=-1)
                  for iz in range(nz)]
        rows.append(np.concatenate(planes, axis=-2))
    return np.concatenate(rows, axis=-3)


def spawn(nt, work: Path, groups: dict, jobs: list,
          inputs: dict) -> dict:
    """Run the ring of ``nt`` worker processes, or the grid ``nt`` =
    (Gt, Gz, Gw) of Gt·Gz·Gw, on ``jobs``; returns each result joined
    over the ranks by its suffix (module docstring)."""
    grid = (nt, 1, 1) if isinstance(nt, int) else tuple(nt)
    nt = int(np.prod(grid))
    work.mkdir(parents=True, exist_ok=True)
    (work / "spec.json").write_text(json.dumps({"groups": groups,
                                                "jobs": jobs}))
    np.savez(work / "inputs.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(r),
                               ",".join(map(str, grid)), str(work)],
                              env=env, stdout=subprocess.PIPE,
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
        name, how = k.rsplit("|", 1)
        vals = [o[k] for o in outs]
        if how == "cat":
            res[name] = _join_boxes(vals, grid)
        elif how == "each":
            res[name] = vals
        else:
            assert all(np.array_equal(v, vals[0]) for v in vals), name
            res[name] = vals[0]
    return res
