"""The sharded hop's fused forms on the CPU, without a spawn: K4's second
output and float64 epilogues (the ``local_post`` and ``box_post``
entry points, the only ones K4 launches).

  * ``dslash_ch_local_reference(post_op=…)`` on a ring of one (the faces
    the slab's own edge planes) is K1's plain version
    ``dslash_ch_reference(post_op=…)``, both outputs, for ("clover",)
    and ("twist", a, b), in float64; the box form (``zw_faces``) on a
    box cut from the lattice, for every grid of ``chip_smoke.BOX_CHECK``,
    is K1's restricted to the box;
  * the calls the wrappers make of the entry points: K4 and K4 on a box,
    with and without the second output, one launch each, with the
    argument count of its C signature (``_build.ENTRY_POINTS``), and the
    instance each form picks;
  * the forms the kernels lack raise (K5 with a second output, a
    float64 K5 with epilogues, a bf16 ψ), on any device; the kernels
    themselves run only on a card: that test carries the ``cuda``
    marker.

~5 s serial.
"""

import types

import pytest
import torch

from quda_qkxtm_multigrid_tpu_torch import _build
from quda_qkxtm_multigrid_tpu_torch import lattice as tlat
from quda_qkxtm_multigrid_tpu_torch.ops import dslash_kernel as dk
from quda_qkxtm_multigrid_tpu_torch.ops.clover import make_clover_pair
from quda_qkxtm_multigrid_tpu_torch.ops.dslash import double_gauge
from quda_qkxtm_multigrid_tpu_torch.dirac import DiracParams
from quda_qkxtm_multigrid_tpu_torch.parallel.mesh import TMesh
from quda_qkxtm_multigrid_tpu_torch.parallel.sharded import halo_hop
from quda_qkxtm_multigrid_tpu_torch.utils import rng
from quda_qkxtm_multigrid_tpu_torch.utils.kernel_bench import virtual_box

torch.set_num_threads(1)

F32, F64, BF16 = torch.float32, torch.float64, torch.bfloat16
GT = tlat.Geometry(4, 4, 4, 8)
KAPPA = 0.115
A_TW = 2 * KAPPA * 0.05
B_TW = 1.0 / (1.0 + A_TW * A_TW)
XC = -KAPPA * KAPPA
TMC = DiracParams(kind="twisted-clover", kappa=KAPPA, mu=0.05, csw=1.0)
BOX_CHECK = ((1, 2, 1), (1, 1, 2), (2, 2, 1), (2, 2, 2))   # chip_smoke 17a
POSTS = {"clover": ("clover",), "twist": ("twist", A_TW, B_TW)}


@pytest.fixture(scope="module")
def flds():
    gen = torch.Generator().manual_seed(151)
    u = rng.random_gauge(gen, GT)
    _, cinv = make_clover_pair(u, GT, TMC)
    psi = rng.random_spinor(gen, GT)
    x = rng.random_spinor(gen, GT)
    return double_gauge(u, GT), cinv, psi, x


def _operands(flds, p):
    """Channels of output parity ``p``: gauge, A⁻¹, ψ (opposite
    parity), x, float64."""
    ud, cinv, psi, x = flds
    return (dk.gauge_channels(ud, p, True, F64),
            dk.clover_channels(cinv, p, F64),
            dk.to_channels(psi[1 - p]), dk.to_channels(x[p]))


def _post_kw(post, ci, xv, dagger):
    """The hop of the chain whose result the second output follows: the
    clover A⁻¹ (fwd, or dag) with A⁻¹† after it, or the twist with its
    opposite after it; xpay with x."""
    if post == "clover":
        return dict(clover="dag" if dagger else "fwd", cinv_ch=ci,
                    xpay_coef=XC, x_ch=xv, post_op=POSTS[post])
    return dict(twist=(-A_TW, B_TW), xpay_coef=XC, x_ch=xv,
                post_op=POSTS[post])


@pytest.mark.parametrize("post", list(POSTS))
@pytest.mark.parametrize("p,dagger", [(0, False), (1, True)])
def test_local_post_is_k1s_on_a_ring_of_one(flds, post, p, dagger):
    g, ci, v, xv = _operands(flds, p)
    kw = dict(dagger=dagger, recon12=True, **_post_kw(post, ci, xv, dagger))
    got = dk.dslash_ch_local(g, v, v[-1:].contiguous(), v[:1].contiguous(),
                             p, GT, **kw)
    ref = dk.dslash_ch_reference(g, v, p, GT, **kw)
    assert len(got) == len(ref) == 2
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-14)


def _cut(f, grid, coords):
    """The box at ``coords`` of ``grid`` with its faces (chip_smoke's
    cut, ``virtual_box``)."""
    return virtual_box(f, grid, coords, GT.Xh)


@pytest.mark.parametrize("grid", BOX_CHECK)
@pytest.mark.parametrize("post", list(POSTS))
def test_box_post_is_k1s_restricted_to_the_box(flds, grid, post):
    p, dagger = 1, False
    g, ci, v, xv = _operands(flds, p)
    coords = tuple(1 if n > 1 else 0 for n in grid)
    gl = tlat.Geometry(GT.X, GT.Y // grid[2], GT.Z // grid[1],
                       GT.T // grid[0])
    vb, fm, fp, zw = _cut(v, grid, coords)
    kw = _post_kw(post, ci, xv, dagger)
    kwb = dict(kw, x_ch=_cut(xv, grid, coords)[0])
    if "cinv_ch" in kw:
        kwb["cinv_ch"] = _cut(ci, grid, coords)[0]
    got = dk.dslash_ch_local(_cut(g, grid, coords)[0], vb, fm, fp, p, gl,
                             recon12=True, zw_faces=zw, **kwb)
    ref = dk.dslash_ch_reference(g, v, p, GT, recon12=True, **kw)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, _cut(b, grid, coords)[0], rtol=0,
                                   atol=1e-14)


def _recording_lib():
    calls = []
    lib = types.SimpleNamespace(**{
        n: (lambda *a, n=n: calls.append((n, a)) or 0)
        for n in _build.ENTRY_POINTS})
    return lib, calls


def test_k4_post_is_one_launch_with_the_second_output(flds):
    g, ci, v, xv = (t.to(F32) for t in _operands(flds, 0))
    fm, fp = v[-1:].contiguous(), v[:1].contiguous()
    out, out2 = torch.empty_like(v), torch.empty_like(v)
    lib, calls = _recording_lib()
    assert dk._launch_k4(lib, "local_post_f32", g, v, out, out2, fm, fp,
                         None, 0, GT, False, None, XC, xv, "fwd", ci,
                         ("clover",), None, 0) == 0
    (name, a), = calls
    assert name == "qkx_dslash_ch_local_post_f32"
    assert len(a) == len(_build.ENTRY_POINTS[name])
    assert a[4:8] == (out.data_ptr(), out2.data_ptr(), fm.data_ptr(),
                      fp.data_ptr())
    assert a[8:15] == (GT.T, GT.Z, GT.W, GT.Xh, 0, -1, -1)
    assert a[-4:-1] == (1, 0.0, 0.0)                  # post: A⁻¹†


@pytest.mark.parametrize("post", [False, True])
def test_box_hop_is_one_launch(flds, post):
    """A box of GT's extents split in z and y: one call of the entry point
    with every face, with or without the second output."""
    g, ci, vb, xv = (t.to(F32) for t in _operands(flds, 0))
    fm, fp = vb[-1:].contiguous(), vb[:1].contiguous()
    zw = (vb[:, :, :1].contiguous(), vb[:, :, -1:].contiguous(),
          vb[..., :GT.Xh].contiguous(), vb[..., -GT.Xh:].contiguous())
    out, out2 = torch.empty_like(vb), torch.empty_like(vb)
    lib, calls = _recording_lib()
    assert dk._launch_k4(
        lib, "box_post_f32", g, vb, out, out2 if post else None, fm, fp, zw,
        0, GT, False, (A_TW, B_TW), None, None, None, None,
        ("twist", A_TW, B_TW) if post else None, (3, 4), 0) == 0
    name = "qkx_dslash_ch_box_post_f32"
    (got, a), = calls
    assert got == name and len(a) == len(_build.ENTRY_POINTS[name])
    assert a[4:6] == (out.data_ptr(), out2.data_ptr() if post else None)
    assert a[6:12] == (fm.data_ptr(), fp.data_ptr(),
                       *(f.data_ptr() for f in zw))
    assert a[17:19] == (3, 4)         # the boundary rows, after parity
    assert a[-4:-1] == ((2, A_TW, B_TW) if post else (0, 0.0, 0.0))


@pytest.mark.parametrize("dtype,post,kernel,form", [
    (F64, None, "k4", "local_post_f64"),
    (F32, ("clover",), "k4", "local_post_f32"),
    (F32, None, "k4", "local_post_f32"),
    (F32, None, "k5", "local_f32"),
    (F64, None, "box", "box_post_f64"),
    (F32, ("clover",), "box", "box_post_f32")])
def test_the_chain_forms_pick_their_instance(flds, dtype, post, kernel,
                                             form):
    g, ci, v, xv = (t.to(dtype) for t in _operands(flds, 0))
    assert dk._check_operands(g, v, GT, True, None, XC, xv, "fwd", ci, post,
                              kernel=kernel) == form


def test_forms_the_kernels_lack_raise(flds):
    g, ci, v, xv = _operands(flds, 0)
    faces = (v[-1:].contiguous(), v[:1].contiguous())
    with pytest.raises(TypeError, match="no kernel takes"):   # K5 float64
        dk.dslash_ch_overlap(g, v, *faces, 0, GT, recon12=True,
                             clover="fwd", cinv_ch=ci)
    with pytest.raises(TypeError, match="no kernel takes"):   # bf16 ψ
        dk.dslash_ch_local(g.to(BF16), v.to(BF16), *(f.to(BF16)
                                                      for f in faces),
                           0, GT, recon12=True, clover="fwd",
                           cinv_ch=ci.to(BF16), post_op=("clover",))
    with pytest.raises(ValueError, match="no second output"):
        halo_hop(TMesh(nt=1, rank=0, device=torch.device("cpu")), True, g,
                 v, 0, GT, recon12=True, clover="fwd", cinv_ch=ci,
                 post_op=("clover",))


@pytest.mark.cuda
def test_post_and_box_kernels_on_the_card(flds):
    """K4 with the second output (float32, float64) against its plain
    version and K4 on a (1, 2, 2) box bit for bit against K1, on the
    card; a form the kernels lack raises there too."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the sharded hops are CUDA kernels")
    for dtype in (F32, F64):
        g, ci, v, xv = (t.to(dtype).cuda() for t in _operands(flds, 0))
        kw = dict(recon12=True, **_post_kw("clover", ci, xv, False))
        faces = (v[-1:].contiguous(), v[:1].contiguous())
        got = dk.dslash_ch_local(g, v, *faces, 0, GT, **kw)
        ref = dk.dslash_ch_reference(g.cpu(), v.cpu(), 0, GT, **dict(
            kw, cinv_ch=ci.cpu(), x_ch=xv.cpu()))
        for a, b in zip(got, ref):
            torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-5)
        gl = tlat.Geometry(GT.X, GT.Y // 2, GT.Z // 2, GT.T)
        vb, fm, fp, zw = _cut(v, (1, 2, 2), (0, 1, 1))
        n = dk.dslash_ch_box.launches
        box = dk.dslash_ch_local(_cut(g, (1, 2, 2), (0, 1, 1))[0], vb, fm,
                                 fp, 0, gl, recon12=True, zw_faces=zw)
        torch.cuda.synchronize()
        assert dk.dslash_ch_box.launches == n + 1
        ref = dk.dslash_ch(g, v, 0, GT, recon12=True)             # K1
        torch.testing.assert_close(box, _cut(ref, (1, 2, 2), (0, 1, 1))[0],
                                   rtol=0, atol=0)
    with pytest.raises(TypeError, match="no kernel takes"):
        dk.dslash_ch_overlap(g, v, *faces, 0, GT, recon12=True,
                             clover="fwd", cinv_ch=ci)
