"""What a rank keeps on the meshed paths of a box: a (1, 2, 2) gloo grid
on the CPU (``tests/_torch_mesh_worker.py`` through
``tests/_torch_ring.py``, one spawn for the module) at X, Y, Z, T = 2,
20, 20, 4, where 20 (the whole Z, the whole Y and the whole merged axis
W = Y·X/2) is no other extent of any field, and every box is 2 × 10 ×
10 × 4.  The tensors a rank keeps are walked for an axis of 20: the
sharded operator after its fused chain ran, the MG pair set up on the
boxes and used by ``run_twop(mesh=…)``, its returned propagators and
smeared links and its stats, and the stats and modes of
``run_threep``, ``run_loops`` and ``run_loops_wexact`` with ``mesh``
(complex64, the fused route through its plain versions).  None may have
it (the whole t, 4, is not split here).

~40 s serial.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import torch

from quda_qkxtm_multigrid_tpu.lattice import Geometry as JGeom
from quda_qkxtm_multigrid_tpu.utils import rng as jrng

from _torch_ring import spawn
from test_torch_mesh_build import MEMORY

torch.set_num_threads(1)

DIMS = (2, 20, 20, 4)
GRID = (1, 2, 2)
WHOLE = 20


@functools.lru_cache(maxsize=None)
def _inputs():
    g = JGeom(*DIMS)
    return {"u": np.asarray(jrng.random_gauge(jax.random.PRNGKey(22), g,
                                              dtype=jnp.complex64)),
            "b": np.asarray(jrng.random_spinor(jax.random.PRNGKey(23), g,
                                               dtype=jnp.complex64))}


def test_box_paths_keep_no_whole_extent_of_a_split_axis(tmp_path):
    job = dict(MEMORY, type="memory", group="A", name="memory", u="u",
               b="b", tsink=2, whole=[WHOLE])
    got = spawn(GRID, tmp_path / "boxmem", {"A": DIMS}, [job], _inputs())
    for rank, found in enumerate(got["memory/whole"]):
        assert len(found) == 0, (rank, list(found))
    assert all(int(c) > 50 for c in got["memory/tensors"])
    assert all(len(i) == MEMORY["twop"]["columns"]
               for i in got["memory/iters"])
