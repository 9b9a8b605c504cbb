"""The sharded multigrid, the Schwarz preconditioners and the complex128
sharded solves on gloo rings of 1, 2 and 4 ranks on the CPU
(``tests/_torch_mesh_worker.py`` through ``tests/_torch_ring.py``; each
ring spawned once for the module) against the JAX package.

  * ``mg_solve(mesh=…)`` with "gcr" and "gcr-pc" on the JAX package's
    setup of ``test_parallel.test_sharded_mg_solve_matches`` (its V and
    coarse X, Y carried across) against the JAX package's unsharded
    ``mg_solve`` (iterations equal, x to atol 1e-7); "mr-richardson"
    against the port's unsharded run (atol 1e-10); one
    ``vcycle(mesh=…)``: every rank's coarse solve bit-identical, the
    result the unsharded V-cycle's (1e-12); ``benchmarks.bench_mg_mesh``'s
    record on every ring (iterations the unsharded solve's, one
    all-gather a V-cycle);
  * GCR with ``schwarz_precond`` and ``schwarz_precond_multiplicative``
    against the JAX package's on the virtual (nt, 1, 1) mesh
    (``test_parallel.test_schwarz_preconditioned_gcr`` /
    ``test_multiplicative_schwarz``): iterations equal, x to atol 1e-9,
    and fewer iterations than plain GCR; one application of each
    preconditioner on an antiperiodic gauge through the recon-12 kernel
    route (its plain version here) against the JAX package's block
    (recon-18 XLA), 1e-12;
  * ``invert(mesh=…)`` in complex128: the non-fused CG against the JAX
    package's ``invert`` (``test_parallel.test_sharded_invert_matches``,
    tol 1e-10, x to atol 1e-9), and ``cg-mixed`` on the fused chain
    certifying to 1e-9;
  * the ring pieces against the whole lattice's: the t gather both ways,
    ``covdev_apply`` in every direction, and a transfer's ``t_slab``
    restrict and prolong (1e-13).

Every ring runs at 4³×8 (the ring of 4: T_loc = 2, one coarse t row a
rank), except the ring of 4's Schwarz GCR, at 4³×16 (T_loc = 4: the
JAX package's GCR with two-timeslice blocks takes ~4× longer to
compile and run).  ~85 s serial, most of it the JAX package's
compilations and the three rings' start-up.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from quda_qkxtm_multigrid_tpu import fields as jfields
from quda_qkxtm_multigrid_tpu.dirac import (DiracParams as JParams,
                                            make_dirac as j_make_dirac)
from quda_qkxtm_multigrid_tpu.invert import invert as j_invert
from quda_qkxtm_multigrid_tpu.lattice import Geometry as JGeom
from quda_qkxtm_multigrid_tpu.mg import multigrid as jmg
from quda_qkxtm_multigrid_tpu.ops.gauge import apply_t_boundary
from quda_qkxtm_multigrid_tpu.parallel import (make_lattice_mesh,
                                               shard_spinor as j_shard)
from quda_qkxtm_multigrid_tpu.parallel.mesh import shard_dirac as j_shard_d
from quda_qkxtm_multigrid_tpu.parallel.schwarz import (
    schwarz_precond as j_schwarz, schwarz_precond_multiplicative as j_mult)
from quda_qkxtm_multigrid_tpu.solvers.gcr import gcr as j_gcr
from quda_qkxtm_multigrid_tpu.utils import rng as jrng

from quda_qkxtm_multigrid_tpu_torch import convert
from quda_qkxtm_multigrid_tpu_torch import lattice as tlat
from quda_qkxtm_multigrid_tpu_torch.dirac import DiracParams
from quda_qkxtm_multigrid_tpu_torch.mg import multigrid as tmg
from quda_qkxtm_multigrid_tpu_torch.mg.transfer import BlockGeometry
from quda_qkxtm_multigrid_tpu_torch.ops.smear import covdev_apply
from quda_qkxtm_multigrid_tpu_torch.parallel.mesh import TMesh

from _torch_ring import spawn

torch.set_num_threads(1)

GROUPS = {"A": (4, 4, 4, 8), "B": (4, 4, 4, 16)}
TM_MG = dict(kind="twisted-mass", kappa=0.122, mu=0.03)
TM_SZ = dict(kind="twisted-mass", kappa=0.12, mu=0.04)
TMC = dict(kind="twisted-clover", kappa=0.115, mu=0.08, csw=1.0)
MG = dict(block=(2, 2, 2, 2), nvec=6, setup_tol=1e-4, setup_maxiter=200,
          nu_post=4)
MG_SOLVE = dict(tol=1e-8, max_restarts=30)
SOLVE = dict(tol=1e-10, maxiter=500)
BENCH = dict(tol=1e-8, solver="gcr-pc", n_krylov=5)


def _jfields(dims, seed):
    """``test_parallel._fields``: a random gauge and spinor of PRNGKey(seed)."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    geom = JGeom(*dims)
    return jrng.random_gauge(k1, geom), jrng.random_spinor(k2, geom)


@functools.lru_cache(maxsize=None)
def _jax_mg():
    """The JAX package's MG of ``test_sharded_mg_solve_matches``."""
    u, b = _jfields(GROUPS["A"], 3)
    d = j_make_dirac(u, JParams(**TM_MG), JGeom(*GROUPS["A"]))
    return jmg.setup_mg(d, jmg.MGParams(**MG), jax.random.PRNGKey(7)), b


@functools.lru_cache(maxsize=None)
def _inputs(nt):
    mg, b = _jax_mg()
    u_mg = np.asarray(_jfields(GROUPS["A"], 3)[0])
    u5, b5 = (np.asarray(a) for a in _jfields(GROUPS["A"], 5))
    u5b, b5b = (np.asarray(a) for a in _jfields(GROUPS["B"], 5))
    u1 = np.asarray(_jfields(GROUPS["A"], 1)[0])
    geom = JGeom(*GROUPS["A"])
    r = np.random.default_rng(40 + nt)
    bg = mg.transfer.bg
    cshape = (2, bg.nvec) + tuple(bg.coarse_shape)
    return {
        "u": u_mg, "b": np.asarray(b),
        "mg_v": np.asarray(mg.transfer.v[0]) + 1j * np.asarray(
            mg.transfer.v[1]),
        "mg_x": np.asarray(mg.coarse.x), "mg_y": np.asarray(mg.coarse.y),
        "psi": np.asarray(_jfields(GROUPS["A"], 8)[1]),
        "coarse_vec": r.standard_normal(cshape)
        + 1j * r.standard_normal(cshape),
        "u5": u5, "b5": b5, "u5b": u5b, "b5b": b5b,
        "u5a": np.asarray(apply_t_boundary(jnp.asarray(u5), geom)),
        "u1": u1,
        "pt": np.asarray(jfields.point_source(geom, (0, 0, 0, 0), 0, 0))}


def _jobs(nt):
    grp = "A"
    jobs = [dict(type="mg", group="A", name=f"mg/{s}", params=TM_MG, mg=MG,
                 solver=s, **MG_SOLVE)
            for s in ("gcr", "gcr-pc", "mr-richardson")]
    jobs.append(dict(type="mg_vcycle", group="A", name="vcycle",
                     params=TM_MG, mg=MG))
    jobs.append(dict(type="bench_mg", group="A", name="bench",
                     params=TM_MG, mg=MG, **BENCH))
    big = nt == 4
    jobs.append(dict(type="schwarz", group="B" if big else "A",
                     name="schwarz", u="u5b" if big else "u5",
                     b="b5b" if big else "b5", params=TM_SZ))
    jobs.append(dict(type="schwarz_block", group=grp, name="block",
                     u="u5a", b="b5", params=dict(TM_SZ, use_kernels=True)))
    jobs += [dict(type="solve", group=grp, name=f"solve/{s}", u="u1",
                  b="pt", solver=s, params=dict(TMC, use_kernels=k),
                  **SOLVE)
             for s, k in (("cg", False), ("cg-mixed", True))]
    jobs.append(dict(type="pieces", group="A", name="pieces",
                     block=MG["block"], nvec=MG["nvec"]))
    return jobs


@pytest.fixture(scope="module")
def rings(tmp_path_factory):
    done = {}

    def get(nt):
        if nt not in done:
            done[nt] = spawn(nt, tmp_path_factory.mktemp(f"mgring{nt}"),
                             GROUPS, _jobs(nt), _inputs(nt))
        return done[nt]
    return get


# ---- the sharded MG -------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_mg_solve(solver):
    mg, b = _jax_mg()
    out = jmg.mg_solve(mg, b, solver=solver, **MG_SOLVE)
    return np.asarray(out.x), int(out.iters)


def _port_mg():
    """The port's unsharded preconditioner on the same carried-across
    state."""
    inp = _inputs(1)
    geom = tlat.Geometry(*GROUPS["A"])
    params = tmg.MGParams(**MG)
    bg = BlockGeometry(geom, *params.block, nvec=params.nvec)
    d = convert.dirac_from_numpy(inp["u"], DiracParams(**TM_MG), geom,
                                 device="cpu")
    return tmg.MGPreconditioner(
        transfer=convert.transfer_from_numpy(inp["mg_v"], bg, device="cpu"),
        coarse=convert.coarse_op_from_numpy(inp["mg_x"], inp["mg_y"], bg,
                                            device="cpu"),
        dirac=d, params=params), torch.tensor(inp["b"])


@pytest.mark.parametrize("nt", [1, 2, 4])
@pytest.mark.parametrize("solver", ["gcr", "gcr-pc"])
def test_sharded_mg_solve_matches_jax(rings, nt, solver):
    res = rings(nt)
    x_ref, iters_ref = _jax_mg_solve(solver)
    assert res[f"mg/{solver}/iters"] == iters_ref
    np.testing.assert_allclose(res[f"mg/{solver}/x"], x_ref, atol=1e-7)
    b = _inputs(1)["b"]
    assert np.sqrt(res[f"mg/{solver}/r2"]) / np.linalg.norm(b) < 1e-7


@pytest.mark.parametrize("nt", [1, 2, 4])
def test_sharded_mr_richardson_is_the_unsharded(rings, nt):
    mg, b = _port_mg()
    ref = tmg.mg_solve(mg, b, solver="mr-richardson", **MG_SOLVE)
    res = rings(nt)
    assert res["mg/mr-richardson/iters"] == ref.iters
    np.testing.assert_allclose(res["mg/mr-richardson/x"], ref.x.numpy(),
                               atol=1e-10)


@pytest.mark.parametrize("nt", [1, 2, 4])
def test_bench_mg_mesh_record(rings, nt):
    """``bench_mg_mesh``'s record: the cold and the warm solve take the
    unsharded solve's iterations, one all-gather a V-cycle, the
    certificates within tol, and no K4 launch on the CPU (its plain
    version runs)."""
    mg, b = _port_mg()
    ref = tmg.mg_solve(mg, b, tol=BENCH["tol"], solver=BENCH["solver"],
                       n_krylov=BENCH["n_krylov"])
    rec = {k.split("/", 1)[1]: v for k, v in rings(nt).items()
           if k.startswith("bench/")}
    assert str(rec["solver"]) == f"mg-gcr-pc-sharded-nt{nt}"
    assert rec["iters"] == rec["iters_cold"] == ref.iters
    assert rec["vcycles"] > 0
    assert rec["allgathers"] == rec["vcycles"]
    assert rec["k4_launches"] == 0
    assert rec["true_res_solve"] <= BENCH["tol"]
    # the sharded r2 and the whole lattice's complex128 residual: one
    # quantity summed in two orders, so equal to rounding relative to |b|
    np.testing.assert_allclose(rec["true_res"], rec["true_res_solve"],
                               rtol=0, atol=1e-14)


@pytest.mark.parametrize("nt", [2, 4])
def test_replicated_coarse_solve_is_bit_identical(rings, nt):
    """The gathered coarse residual is the same bytes on every rank, so
    every rank's coarse solve is too; the V-cycle is the unsharded one."""
    res = rings(nt)
    coarse = res["vcycle/coarse"]
    assert len(coarse) == nt
    for c in coarse[1:]:
        assert np.array_equal(c, coarse[0])
    mg, b = _port_mg()
    np.testing.assert_allclose(res["vcycle/x"], mg.vcycle(b).numpy(),
                               atol=1e-12)


def test_mg_solve_mesh_refusals():
    """An unsharded preconditioner on a mesh, and a ring that does not
    divide T, raise before anything is sent."""
    mg, b = _port_mg()
    with pytest.raises(ValueError, match="shard_mg"):
        tmg.mg_solve(mg, b, mesh=object())
    with pytest.raises(ValueError, match="divisible"):
        tmg.shard_mg(mg, TMesh(nt=3, rank=0, device=torch.device("cpu")))


# ---- Schwarz ----------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_schwarz(nt):
    grp = "B" if nt == 4 else "A"
    geom = JGeom(*GROUPS[grp])
    u, b = _jfields(GROUPS[grp], 5)
    d = j_make_dirac(u, JParams(**TM_SZ), geom)
    mesh = make_lattice_mesh((nt, 1, 1))
    d_s, b_s = j_shard_d(d, mesh), j_shard(b, mesh)
    out = {}
    with jax.set_mesh(mesh):
        for kind, mk in (("plain", None), ("additive", j_schwarz),
                         ("multiplicative", j_mult)):
            def solve(d, b, mk=mk):
                pc = None if mk is None else mk(d, mesh, niter=4)
                return j_gcr(d.m, b, tol=1e-8, n_krylov=10, max_restarts=40,
                             precond=pc)
            r = jax.jit(solve)(d_s, b_s)
            out[kind] = (np.asarray(r.x), int(r.iters))
    return out


@pytest.mark.parametrize("nt", [1, 2, 4])
@pytest.mark.parametrize("kind", ["additive", "multiplicative"])
def test_schwarz_gcr_matches_jax(rings, nt, kind):
    res = rings(nt)
    ref = _jax_schwarz(nt)
    assert res[f"schwarz/{kind}/iters"] == ref[kind][1]
    np.testing.assert_allclose(res[f"schwarz/{kind}/x"], ref[kind][0],
                               atol=1e-9)
    assert res[f"schwarz/{kind}/true_res"] < 1e-6
    assert res[f"schwarz/{kind}/iters"] < res["schwarz/plain/iters"]
    assert res["schwarz/plain/iters"] == ref["plain"][1]


@pytest.mark.parametrize("kind", ["additive", "multiplicative"])
def test_schwarz_block_on_an_antiperiodic_gauge(rings, kind):
    """The block operator's boundary on a ring of 2: the rank holding
    global t = T−1 wraps its slab through the sign-carrying link, which
    recon-12 drops and the kernel route restores (``local_block``)."""
    nt = 2
    inp = _inputs(nt)
    d = j_make_dirac(jnp.asarray(inp["u5a"]), JParams(**TM_SZ),
                     JGeom(*GROUPS["A"]))
    mesh = make_lattice_mesh((nt, 1, 1))
    mk = j_schwarz if kind == "additive" else j_mult
    with jax.set_mesh(mesh):
        ref = np.asarray(jax.jit(lambda d, b: mk(d, mesh, niter=4)(b))(
            j_shard_d(d, mesh), j_shard(jnp.asarray(inp["b5"]), mesh)))
    np.testing.assert_allclose(rings(nt)[f"block/{kind}"], ref, atol=1e-12)


# ---- the complex128 sharded solves -----------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_invert():
    inp = _inputs(1)
    d = j_make_dirac(jnp.asarray(inp["u1"]), JParams(**TMC),
                     JGeom(*GROUPS["A"]))
    return np.asarray(j_invert(d, jnp.asarray(inp["pt"]), **SOLVE).x)


@pytest.mark.parametrize("nt", [1, 2, 4])
def test_sharded_cg_without_the_chain_matches_jax(rings, nt):
    res = rings(nt)
    assert res["solve/cg/true_res"] < 1e-9
    np.testing.assert_allclose(res["solve/cg/x"], _jax_invert(),
                               atol=1e-9)


@pytest.mark.parametrize("nt", [1, 2, 4])
def test_sharded_cg_mixed_certifies(rings, nt):
    res = rings(nt)
    assert res["solve/cg-mixed/true_res"] <= 1e-9
    np.testing.assert_allclose(res["solve/cg-mixed/x"], _jax_invert(),
                               atol=1e-8)


# ---- ring pieces ------------------------------------------------------------

@pytest.mark.parametrize("nt", [2, 4])
def test_ring_pieces_are_the_whole_lattice_slices(rings, nt):
    res = rings(nt)
    inp = _inputs(nt)
    geom = tlat.Geometry(*GROUPS["A"])
    u, psi = torch.tensor(inp["u"]), torch.tensor(inp["psi"])
    for fwd in (True, False):
        ref = tlat.gather_neighbor(psi[0], 3, fwd, 1, geom)
        assert np.array_equal(res[f"gather/{fwd}"], ref.numpy())
        for mu in range(4):
            ref = covdev_apply(u, psi, mu, fwd, geom)
            np.testing.assert_allclose(res[f"covdev/{mu}/{fwd}"],
                                       ref.numpy(), atol=1e-13)
    bg = BlockGeometry(geom, *MG["block"], nvec=MG["nvec"])
    tr = convert.transfer_from_numpy(inp["mg_v"], bg, device="cpu")
    whole = tr.restrict(psi).numpy()
    rest = res["restrict"]
    tc = whole.shape[2] // nt
    for r, part in enumerate(rest):
        np.testing.assert_allclose(part, whole[:, :, r * tc:(r + 1) * tc],
                                   atol=1e-13)
    np.testing.assert_allclose(
        res["prolong"], tr.prolong(torch.tensor(inp["coarse_vec"])).numpy(),
        atol=1e-13)
