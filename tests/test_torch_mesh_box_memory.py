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
it (the whole t, 4, is not split here).  The same spawn runs the
sharded operator's fused chain on these boxes (Z_loc = Y_loc = 10,
Xh = 1: ``ShardedDirac.matpc`` both ways and ``matpc_dagm``, twisted
mass and twisted clover on the antiperiodic gauge) against the JAX
package's XLA operator: complex128 to 1e-12 normwise, complex64 (the
float32 chain) to 1e-5.

~45 s serial.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from quda_qkxtm_multigrid_tpu import dirac as jd
from quda_qkxtm_multigrid_tpu.lattice import Geometry as JGeom
from quda_qkxtm_multigrid_tpu.ops.gauge import apply_t_boundary
from quda_qkxtm_multigrid_tpu.utils import rng as jrng

from _torch_ring import spawn
from test_torch_mesh_build import MEMORY

torch.set_num_threads(1)

DIMS = (2, 20, 20, 4)
GRID = (1, 2, 2)
WHOLE = 20
KINDS = {"tm": dict(kind="twisted-mass", kappa=0.115, mu=0.05),
         "tmc": dict(kind="twisted-clover", kappa=0.115, mu=0.05, csw=1.0)}
OPS = ["matpc/False", "matpc/True", "dagm"]


@functools.lru_cache(maxsize=None)
def _inputs():
    g = JGeom(*DIMS)
    # the operator's gauge in complex128: recon-12 rebuilds row 2 in the
    # links' precision, so complex64 links would differ from it by ~1e-8
    u128 = jrng.random_gauge(jax.random.PRNGKey(24), g)
    return {"u": np.asarray(jrng.random_gauge(jax.random.PRNGKey(22), g,
                                              dtype=jnp.complex64)),
            "u_ap": np.asarray(apply_t_boundary(u128, g)),
            "b": np.asarray(jrng.random_spinor(jax.random.PRNGKey(23), g,
                                               dtype=jnp.complex64))}


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    jobs = [dict(MEMORY, type="memory", group="A", name="memory", u="u",
                 b="b", tsink=2, whole=[WHOLE])]
    jobs += [dict(type="op", group="A", name=f"op/{k}", u="u_ap", psi="b",
                  params=p, precs=["c128", "c64"]) for k, p in KINDS.items()]
    return spawn(GRID, tmp_path_factory.mktemp("boxmem"), {"A": DIMS}, jobs,
                 _inputs())


def test_box_paths_keep_no_whole_extent_of_a_split_axis(grid):
    got = grid
    for rank, found in enumerate(got["memory/whole"]):
        assert len(found) == 0, (rank, list(found))
    assert all(int(c) > 50 for c in got["memory/tensors"])
    assert all(len(i) == MEMORY["twop"]["columns"]
               for i in got["memory/iters"])


@functools.lru_cache(maxsize=None)
def _jax_op(kind: str, op: str) -> np.ndarray:
    """The JAX package's XLA ``matpc`` / ``matpc_dagm`` in complex128 on
    the antiperiodic gauge."""
    inp = _inputs()
    d = jd.make_dirac(inp["u_ap"], jd.DiracParams(**KINDS[kind]),
                      JGeom(*DIMS))
    psi = inp["b"][0].astype(np.complex128)
    if op == "dagm":
        return np.asarray(d.matpc_dagm(psi))
    return np.asarray(d.matpc(psi, op.endswith("True")))


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("prec,limit", [("c128", 1e-12), ("c64", 1e-5)])
@pytest.mark.parametrize("op", OPS)
def test_box_operator_is_the_fused_chain(grid, kind, prec, limit, op):
    got = grid[f"op/{kind}/{prec}/{op}"]
    ref = _jax_op(kind, op)
    assert got.shape == ref.shape
    assert (np.linalg.norm(got - ref) / np.linalg.norm(ref)) <= limit
