"""The t-halo pieces of the sharded solve against the JAX package, at 4³×8
on the CPU: the face projection and the exchange on a ring of one, the
t-local hop's plain version (K4) against the Pallas kernel in interpret
mode and against the XLA hop restricted to a slab, the split form's
plain version (K5) against K4's, the T_loc = 2 fallback, the launch plans
the CUDA wrappers hand to the kernels, and the refusals.  The kernels
themselves run only on a card: that test carries the ``cuda`` marker.
"""

import functools
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from quda_qkxtm_multigrid_tpu import lattice as jlat
from quda_qkxtm_multigrid_tpu.dirac import DiracParams as JDiracParams
from quda_qkxtm_multigrid_tpu.ops import clover as jcl
from quda_qkxtm_multigrid_tpu.ops import dslash as jdsl
from quda_qkxtm_multigrid_tpu.ops.dslash_pallas import (
    _to_channels as j_to_channels)
from quda_qkxtm_multigrid_tpu.ops.dslash_pallas5 import (
    _project_face as j_project_face, _t_extend as j_t_extend,
    _t_faces as j_t_faces, clover_channels as j_clover_channels,
    dslash_ch_pallas5_local, gauge_channels as j_gauge_channels)
from quda_qkxtm_multigrid_tpu.utils import rng as jrng

from quda_qkxtm_multigrid_tpu_torch import _build, compact, convert
from quda_qkxtm_multigrid_tpu_torch import lattice as tlat
from quda_qkxtm_multigrid_tpu_torch.convert import spinor_to_numpy as N
from quda_qkxtm_multigrid_tpu_torch.dirac import DiracParams
from quda_qkxtm_multigrid_tpu_torch.invert import invert, invert_msrc
from quda_qkxtm_multigrid_tpu_torch.ops import dslash_kernel as dk
from quda_qkxtm_multigrid_tpu_torch.parallel import halo
from quda_qkxtm_multigrid_tpu_torch.parallel.mesh import (
    TMesh, make_lattice_mesh, shard_spinor)
from quda_qkxtm_multigrid_tpu_torch.parallel.sharded import (
    ShardedDirac, shard_dirac)

T = functools.partial(convert.spinor_from_numpy, device="cpu")
F32, F64, BF16 = torch.float32, torch.float64, torch.bfloat16

torch.set_num_threads(1)

GJ = jlat.Geometry(4, 4, 4, 8)
GT = tlat.Geometry(4, 4, 4, 8)
NT, RANK = 2, 1                      # the slab of rank 1 of a ring of 2
TL = GT.T // NT
GL = tlat.Geometry(4, 4, 4, TL)
ROWS = slice(RANK * TL, (RANK + 1) * TL)
EXT = [(RANK * TL - 1 + i) % GT.T for i in range(TL + 2)]   # with halo
KAPPA = 0.115
A_TW = 2 * KAPPA * 0.05
B_TW = 1.0 / (1.0 + A_TW * A_TW)
XC = -KAPPA * KAPPA
TMC = dict(kind="twisted-clover", kappa=KAPPA, mu=0.05, csw=1.0)
ONE = TMesh(nt=1, rank=0, device=torch.device("cpu"))   # ring of one


def rel(got, ref) -> float:
    got = N(got) if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.linalg.norm((got - ref).ravel())
                 / np.linalg.norm(ref.ravel()))


@pytest.fixture(scope="module")
def flds():
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(71), 3)
    u = np.asarray(jrng.random_gauge(k1, GJ))
    psi = np.asarray(jrng.random_spinor(k2, GJ))
    x = np.asarray(jrng.random_spinor(k3, GJ))
    ud = np.asarray(jdsl.double_gauge(u, GJ))
    _, cinv = jcl.make_clover_pair(u, GJ, JDiracParams(**TMC))
    return u, ud, psi, x, np.asarray(cinv)


def _slab_operands(flds, p, dtype):
    """Rank 1's operands for output parity p: gauge and A⁻¹ of the slab,
    ψ (opposite parity) with its two halo rows, and x of the slab."""
    _, ud, psi, x, cinv = flds
    g = dk.gauge_channels(T(ud), p, True, dtype)[ROWS].contiguous()
    ci = dk.clover_channels(T(cinv), p, dtype)[ROWS].contiguous()
    ext = dk.to_channels(T(psi[1 - p])).to(dtype)[EXT].contiguous()
    xs = dk.to_channels(T(x[p])).to(dtype)[ROWS].contiguous()
    return g, ci, ext, xs


def _split(ext):
    """A t-extended block [T+2, ...] as the t-local hop takes it: the
    slab's rows, face_m (row 0) and face_p (row T+1)."""
    return (ext[1:-1].contiguous(), ext[:1].contiguous(),
            ext[-1:].contiguous())


# ---- the face projection and the exchange on a ring of one ----------------

@pytest.mark.parametrize("plus", [False, True])
def test_project_face_matches_jax(flds, plus):
    plane = np.asarray(j_to_channels(flds[2][0]))[2:3]     # float32
    got = halo.project_face(T(plane), plus)
    assert got.shape == (1, 12, GT.Z, GT.W)
    np.testing.assert_array_equal(N(got), np.asarray(j_project_face(
        jnp.asarray(plane), plus)))


@pytest.mark.parametrize("project,dagger", [(False, False), (True, False),
                                            (True, True)])
def test_t_faces_and_extend_match_jax_on_a_ring_of_one(flds, project,
                                                       dagger):
    """The faces are JAX's ``_t_faces``; unprojected, with the slab
    between them, they are JAX's t-extended block ``_t_extend``."""
    ch = np.asarray(j_to_channels(flds[2][1]))
    fm, fp = halo.t_faces(T(ch), ONE, project=project, dagger=dagger)
    jm, jp = j_t_faces(jnp.asarray(ch), 1, project=project, dagger=dagger)
    np.testing.assert_array_equal(N(fm), np.asarray(jm))
    np.testing.assert_array_equal(N(fp), np.asarray(jp))
    fm, fp = halo.t_faces(T(ch), ONE)
    np.testing.assert_array_equal(N(torch.cat([fm, T(ch), fp])),
                                  np.asarray(j_t_extend(jnp.asarray(ch), 1)))


# ---- K4's plain version ------------------------------------------------------

def test_local_reference_matches_pallas_interpret(flds):
    """One case (clover fwd + xpay, parity 0) against the JAX package's
    t-local Pallas kernel in interpret mode, float32."""
    p = 0
    _, ud, psi, x, cinv = flds
    g, ci, ext, xs = _slab_operands(flds, p, F32)
    jg = np.asarray(j_gauge_channels(ud, p, True, False))[ROWS]
    jci = np.asarray(j_clover_channels(cinv, p, False))[ROWS]
    jext = np.asarray(j_to_channels(psi[1 - p]))[EXT]
    jx = np.asarray(j_to_channels(x[p]))[EXT]
    ref = dslash_ch_pallas5_local(
        jnp.asarray(jg), jnp.asarray(jext), p, jlat.Geometry(4, 4, 4, TL),
        interpret=True, recon12=True, clover="fwd", cinv_ch=jnp.asarray(jci),
        xpay_coef=XC, x_ch=jnp.asarray(jx))
    got = dk.dslash_ch_local_reference(g, *_split(ext), p, GL, recon12=True,
                                       clover="fwd", cinv_ch=ci,
                                       xpay_coef=XC, x_ch=xs)
    assert rel(got, ref) <= 1e-6


def _epilogue_cases():
    cases = [dict(parity=p, dagger=dg) for p in (0, 1)
             for dg in (False, True)]
    cases += [
        dict(parity=0, twist=(-A_TW, B_TW), xpay=XC),
        dict(parity=1, dagger=True, twist=(A_TW, B_TW)),
        dict(parity=1, clover="fwd"),
        dict(parity=0, clover="fwd", xpay=XC),
        dict(parity=1, dagger=True, clover="dag"),
        dict(parity=0, dagger=True, xpay=XC),
    ]
    return cases


def _case_id(c):
    return "-".join(f"{k}{v}" if not isinstance(v, tuple) else k
                    for k, v in c.items())


def _jax_slab_reference(flds, c):
    """The XLA hop of the whole lattice, restricted to the slab's rows,
    then the epilogues, in complex128."""
    u, _, psi, x, cinv = flds
    p = c["parity"]
    res = np.asarray(jdsl.dslash_parity(u, psi[1 - p], p, GJ,
                                        c.get("dagger", False)))[..., ROWS,
                                                                 :, :]
    if "clover" in c:
        res = np.asarray(jcl.clover_apply(cinv[p][..., ROWS, :, :], res,
                                          dagger=c["clover"] == "dag"))
    if "twist" in c:
        a, b = c["twist"]
        g5 = np.array([1.0, 1.0, -1.0, -1.0]).reshape(4, 1, 1, 1, 1)
        res = b * (res + 1j * a * g5 * res)
    if "xpay" in c:
        res = x[p][..., ROWS, :, :] + c["xpay"] * res
    return res


def _local_kwargs(c, ci, xs):
    kw = dict(dagger=c.get("dagger", False), recon12=True,
              twist=c.get("twist"))
    if "clover" in c:
        kw.update(clover=c["clover"], cinv_ch=ci)
    if "xpay" in c:
        kw.update(xpay_coef=c["xpay"], x_ch=xs)
    return kw


@pytest.mark.parametrize("c", _epilogue_cases(), ids=_case_id)
def test_local_reference_matches_xla_slab(flds, c):
    p = c["parity"]
    g, ci, ext, xs = _slab_operands(flds, p, F64)
    got = dk.dslash_ch_local_reference(g, *_split(ext), p, GL,
                                       **_local_kwargs(c, ci, xs))
    assert rel(dk.from_channels(got, (4, 3)),
               _jax_slab_reference(flds, c)) <= 1e-12


# ---- K5's plain version (the faces it reads) against K4's -------------------

def _local_ext_plain(g, ext, p, gl, dagger=False, **kw):
    """The t-local hop on a t-extended block, as the JAX package's K4
    takes it: the whole lattice's plain hop on a block of T+2 rows, its
    two end rows dropped (their t neighbours wrapped inside the block),
    then the epilogues on the slab's rows."""
    t = gl.T
    gx = torch.cat([torch.zeros_like(g[:1]), g, torch.zeros_like(g[:1])])
    psi = dk.from_channels(ext, (4, 3))
    # parity of a block starting one row early: the origin is odd
    res = dk._hop_plain(psi, dk._links(gx, True), 1 - p,
                        tlat.Geometry(gl.X, gl.Y, gl.Z, t + 2), dagger)
    res = res[:, :, 1:t + 1]
    cinv = kw.get("cinv_ch")
    return dk.to_channels(dk._epilogues(
        res, cinv, kw.get("clover"), kw.get("twist"), kw.get("xpay_coef"),
        kw.get("x_ch")))


@pytest.mark.parametrize("projected", [False, True])
@pytest.mark.parametrize("c", _epilogue_cases(), ids=_case_id)
def test_overlap_reference_matches_local(flds, c, projected):
    """The split form's faces (24 channels, or 12 projected by the
    sender) against the hop on the t-extended block."""
    p, dagger = c["parity"], c.get("dagger", False)
    g, ci, ext, xs = _slab_operands(flds, p, F64)
    kw = _local_kwargs(c, ci, xs)
    ref = _local_ext_plain(g, ext, p, GL, **kw)
    psi, face_m, face_p = _split(ext)
    if projected:
        face_m = halo.project_face(face_m, plus=not dagger)
        face_p = halo.project_face(face_p, plus=dagger)
    got = dk.dslash_ch_local_reference(g, psi, face_m, face_p, p, GL,
                                       faces_projected=projected, **kw)
    assert rel(got, ref) <= 1e-14


def test_overlap_falls_back_to_local_at_t_loc_2(flds):
    """T_loc = 2 has no interior: the split form runs K4 on ψ between
    unprojected faces, and raises for projected ones."""
    gl2 = tlat.Geometry(4, 4, 4, 2)
    _, ud, psi, x, cinv = flds
    p = 1
    rows = [1, 2, 3, 4]                   # rank 1 of a ring of 4, with halo
    g = dk.gauge_channels(T(ud), p, True, F32)[2:4].contiguous()
    ci = dk.clover_channels(T(cinv), p, F32)[2:4].contiguous()
    ext = dk.to_channels(T(psi[1 - p])).to(F32)[rows].contiguous()
    xs = dk.to_channels(T(x[p])).to(F32)[2:4].contiguous()
    waited = []
    got = dk.dslash_ch_overlap(g, *_split(ext), p, gl2, recon12=True,
                               clover="fwd", cinv_ch=ci, xpay_coef=XC,
                               x_ch=xs, wait=lambda: waited.append(1))
    ref = _local_ext_plain(g, ext, p, gl2, recon12=True, clover="fwd",
                           cinv_ch=ci, xpay_coef=XC, x_ch=xs)
    assert waited == [1]
    assert rel(got, ref) <= 1e-6
    with pytest.raises(ValueError, match="projected faces need T_loc > 2"):
        dk.dslash_ch_overlap(g, ext[1:-1],
                             halo.project_face(ext[:1], True),
                             halo.project_face(ext[-1:], False), p, gl2,
                             recon12=True, faces_projected=True)


# ---- what the CUDA wrappers hand to the kernels --------------------------

def _recording_lib():
    calls = []
    lib = types.SimpleNamespace(**{
        n: (lambda *a, n=n: calls.append((n, a)) or 0)
        for n in _build.ENTRY_POINTS})
    return lib, calls


def test_k4_launch_plan_reads_from_row_one(flds):
    """K4 is one launch over every row of the slab, with ψ, x and the two
    24-channel faces read where they lie (no extended block, no copy)."""
    g, ci, ext, xs = _slab_operands(flds, 0, F32)
    psi, fm, fp = _split(ext)
    lib, calls = _recording_lib()
    out = torch.empty((TL, 24, GT.Z, GT.W))
    dk._run_launches(lib, "local_f32", out, dk._k4_launches(
        g, psi, fm, fp, 0, GL, False, None, XC, xs, "fwd", ci), None, 0,
        "K4")
    (name, a), = calls
    assert name == "qkx_dslash_ch_local_f32"
    assert a[0] == psi.data_ptr() and a[3] == xs.data_ptr()
    assert a[1:3] == (g.data_ptr(), ci.data_ptr()) and a[4] == out.data_ptr()
    assert a[5:8] == (fm.data_ptr(), fp.data_ptr(), 24)
    assert a[8:16] == (TL, GT.Z, GT.W, GT.Xh, 0, 0, 1, TL)
    assert a[16:18] == (-1, -1)          # periodic: no boundary rows
    assert a[18:21] == (0, 1, 0) and a[23:25] == (1, 1)


def test_k5_launch_plan_waits_between_interior_and_edges(flds):
    g, ci, ext, _ = _slab_operands(flds, 1, F32)
    psi = ext[1:-1].contiguous()
    fm = halo.project_face(ext[:1], plus=True)
    fp = halo.project_face(ext[-1:], plus=False)
    lib, calls = _recording_lib()
    out = torch.empty_like(psi)
    plan = dk._k5_launches(g, psi, fm, fp, 1, GL, True, (A_TW, B_TW), None,
                           None, None, None, True)
    dk._run_launches(lib, "local_f32", out, plan,
                     lambda: calls.append(("wait", ())), 0, "K5")
    assert [c[0] for c in calls] == ["qkx_dslash_ch_local_f32", "wait",
                                     "qkx_dslash_ch_local_f32"]
    interior, edges = calls[0][1], calls[2][1]
    assert interior[0] == edges[0] == psi.data_ptr()
    assert interior[5:8] == (None, None, 24)
    assert interior[13:16] == (1, 1, TL - 2)
    assert edges[5:8] == (fm.data_ptr(), fp.data_ptr(), 12)
    assert edges[13:16] == (0, TL - 1, 2)
    assert interior[18] == edges[18] == 1                 # dagger
    assert interior[21:23] == edges[21:23] == (A_TW, B_TW)


def test_wrappers_count_no_launch_on_the_cpu(flds):
    g, ci, ext, _ = _slab_operands(flds, 0, F32)
    before = (dk.dslash_ch_local.launches, dk.dslash_ch_overlap.launches)
    dk.dslash_ch_local(g, *_split(ext), 0, GL, recon12=True)
    dk.dslash_ch_overlap(g, *_split(ext), 0, GL, recon12=True)
    assert (dk.dslash_ch_local.launches,
            dk.dslash_ch_overlap.launches) == before


# ---- refusals ------------------------------------------------------------------

def _bad_mixes(flds):
    """Operand mixes the t-local hop has no instance for: (gauge, ψ with
    its halo, keyword arguments)."""
    g32, ci32, ext32, _ = _slab_operands(flds, 0, F32)
    g64, ci64, ext64, _ = _slab_operands(flds, 0, F64)
    g18 = dk.gauge_channels(T(flds[1]), 0, False, F32)[ROWS].contiguous()
    return {
        "float64 with epilogues": (g64, ext64, dict(clover="fwd",
                                                    cinv_ch=ci64)),
        "full gauge": (g18, ext32, dict(recon12=False)),
        "bf16 psi": (g32, ext32.to(BF16), {}),
        "bf16 gauge, float32 clover": (g32.to(BF16), ext32,
                                       dict(clover="fwd", cinv_ch=ci32)),
    }


@pytest.mark.parametrize("name", ["float64 with epilogues", "full gauge",
                                  "bf16 psi", "bf16 gauge, float32 clover"])
def test_local_refuses_unlisted_mixes(flds, name):
    g, ext, kw = _bad_mixes(flds)[name]
    kw = {"recon12": True, **kw}
    with pytest.raises(TypeError, match="no kernel takes"):
        dk.dslash_ch_local(g, *_split(ext), 0, GL, **kw)


def test_faces_must_match_psi(flds):
    g, _, ext, _ = _slab_operands(flds, 0, F32)
    psi = ext[1:-1].contiguous()
    with pytest.raises(ValueError, match="face_m shape"):
        dk.dslash_ch_overlap(g, psi, ext[:1], ext[-1:], 0, GL, recon12=True,
                             faces_projected=True)
    with pytest.raises(ValueError, match="storage"):
        dk.dslash_ch_overlap(g, psi, ext[:1].double(), ext[-1:], 0, GL,
                             recon12=True)
    with pytest.raises(ValueError, match="face_p shape"):
        dk.dslash_ch_local(g, psi, ext[:1], ext[-2:], 0, GL, recon12=True)


def test_odd_local_t_raises():
    psi = torch.zeros((2, 4, 3, 6) + (GT.Z, GT.W), dtype=torch.complex128)
    with pytest.raises(ValueError, match="must be even"):
        shard_spinor(psi, TMesh(nt=2, rank=0, device=torch.device("cpu")))
    with pytest.raises(ValueError, match="not divisible"):
        shard_spinor(psi, TMesh(nt=4, rank=0, device=torch.device("cpu")))


@pytest.mark.parametrize("grid", [(2, 2, 1), (2, 1, 2), (1, 1, 4)])
def test_z_or_w_split_raises(grid):
    """A z or w split is a grid the mesh takes (since the box path): what
    raises here is the missing process group, not the grid."""
    with pytest.raises(RuntimeError, match="not initialised"):
        make_lattice_mesh(grid, device="cpu")


@pytest.fixture(scope="module")
def tmc_problem(flds):
    u = flds[0]
    d = convert.dirac_from_numpy(u, DiracParams(**TMC, use_kernels=True),
                                 GT, device="cpu")
    b = T(np.asarray(jrng.random_spinor(jax.random.PRNGKey(72), GJ)))
    return d, b


def test_shard_dirac_slices_the_global_build(tmc_problem):
    """The slab's doubled gauge and clover terms are the whole lattice's
    rows, not a rebuild from the slab (which would wrap t inside it)."""
    d, _ = tmc_problem
    ds = shard_dirac(d, TMesh(nt=NT, rank=RANK, device=torch.device("cpu")))
    assert isinstance(ds, ShardedDirac) and ds.geom == GL
    assert ds.global_geom == GT and ds.has_sharded_chain
    assert not ds._has_fused_matpc
    for name in ("u", "u_doubled", "clover", "clover_inv"):
        assert torch.equal(getattr(ds, name), getattr(d, name)[..., ROWS, :, :])
    assert ds.flops_per_mat() == d.flops_per_mat()


def test_sharded_dslash_on_a_ring_of_one_is_the_hop(tmc_problem):
    """On a ring of one the slab is the lattice and the halo the periodic
    wrap: the float64 K4 hop of ``ShardedDirac.dslash`` is ``Dirac``'s."""
    d, b = tmc_problem
    ds = shard_dirac(d, ONE)
    for p in (0, 1):
        for dagger in (False, True):
            assert rel(ds.dslash(b[1 - p], p, dagger),
                       N(d.dslash(b[1 - p], p, dagger))) <= 1e-15


def test_invert_refuses_what_the_sharded_path_does_not_take(tmc_problem):
    d, b = tmc_problem
    ds = shard_dirac(d, ONE)
    with pytest.raises(ValueError, match="solver='cg' or 'cg-mixed'"):
        invert(ds, b, solver="bicgstab", mesh=ONE)
    with pytest.raises(ValueError, match="no sloppy operator"):
        invert(ds, b, solver="cg-mixed", sloppy_dirac=d, mesh=ONE)
    with pytest.raises(ValueError, match="shard_dirac"):
        invert(d, b, mesh=ONE)
    with pytest.raises(ValueError, match="its own mesh"):
        invert(ds, b)
    plain = shard_dirac(convert.dirac_from_numpy(
        N(d.u), DiracParams(**TMC), GT, device="cpu"), ONE)
    with pytest.raises(ValueError, match="fused chain"):
        invert(plain, b, solver="cg-mixed", mesh=ONE)
    cd = compact.make_compact(d.u, d.params, GT, F32)
    with pytest.raises(ValueError, match="CompactDirac"):
        invert(cd, b, mesh=ONE)
    with pytest.raises(ValueError, match="no sharded form"):
        invert_msrc(ds, b[None])


@pytest.mark.cuda
def test_local_kernels_on_the_card(flds):
    """K4 against its plain version, and K5 (projected faces: two
    launches) against K4, on the card; float32, clover fwd + xpay."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the t-local hop is a CUDA kernel")
    g, ci, ext, xs = (t.cuda() for t in _slab_operands(flds, 0, F32))
    psi, fm, fp = _split(ext)
    kw = dict(recon12=True, clover="fwd", cinv_ch=ci, xpay_coef=XC, x_ch=xs)
    n4, n5 = dk.dslash_ch_local.launches, dk.dslash_ch_overlap.launches
    k4 = dk.dslash_ch_local(g, psi, fm, fp, 0, GL, **kw)
    k5 = dk.dslash_ch_overlap(g, psi, halo.project_face(fm, plus=True),
                              halo.project_face(fp, plus=False), 0, GL,
                              faces_projected=True, **kw)
    torch.cuda.synchronize()
    ref = dk.dslash_ch_local_reference(
        g.cpu(), psi.cpu(), fm.cpu(), fp.cpu(), 0, GL, recon12=True,
        clover="fwd", cinv_ch=ci.cpu(), xpay_coef=XC, x_ch=xs.cpu())
    assert (dk.dslash_ch_local.launches, dk.dslash_ch_overlap.launches) == (
        n4 + 1, n5 + 2)
    assert rel(k4.cpu(), N(ref)) <= 1e-6
    assert rel(k5.cpu(), N(k4.cpu())) <= 1e-7


def test_cg_sums_every_reduction_through_its_hook():
    """Two ranks holding identical halves double every reduction: the
    iterates are the same bits only if each of cg's reductions goes
    through ``allreduce`` (one missed would halve or double alpha or
    beta).  Without a hook cg is unchanged."""
    from quda_qkxtm_multigrid_tpu_torch.solvers.cg import cg
    r = np.random.default_rng(5)
    a = r.standard_normal((24, 24)) + 1j * r.standard_normal((24, 24))
    a = T(a.conj().T @ a / 24 + 0.5 * np.eye(24))
    b = T(r.standard_normal(24) + 1j * r.standard_normal(24))
    ref = cg(lambda v: a @ v, b, tol=1e-10, maxiter=100)
    doubled = cg(lambda v: a @ v, b, tol=1e-10, maxiter=100,
                 allreduce=lambda v: 2 * v)
    same = cg(lambda v: a @ v, b, tol=1e-10, maxiter=100,
              allreduce=lambda v: v)
    assert doubled.iters == same.iters == ref.iters > 5
    assert torch.equal(doubled.x, ref.x) and torch.equal(same.x, ref.x)
