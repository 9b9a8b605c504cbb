"""The multi-source hop's second output and the multi-source normal
operator's four-hop chain.

* ``dslash_ch_msrc_reference(post_op=…)`` against n single-source
  ``dslash_ch_reference(post_op=…)``, both second outputs, in float64
  (1e-12, normwise relative);
* the four-hop M_pc† M_pc chain on a batch, ``Dirac._fused_matpc_dagm_ch(
  hop=dslash_ch_msrc)`` (the dagger half's A⁻¹† or twist the forward
  half's second output), against two multi-source matpc halves (the
  dagger half leading with a plain A⁻¹†), in float32 (1e-6), for the
  twisted-clover and twisted-mass operators and the bf16 operand tier;
* ``invert_msrc`` on the fused path (float32 channel CG through that
  chain) against the JAX package's ``invert_msrc`` in complex128 at
  4³×8, with ``test_torch_msrc.py``'s tolerances;
* K2 and K2d with both second outputs on the card (``cuda``-marked).
"""

import functools

import numpy as np
import jax
import pytest
import torch

from quda_qkxtm_multigrid_tpu import dirac as jd
from quda_qkxtm_multigrid_tpu import lattice as jlat
from quda_qkxtm_multigrid_tpu.invert import invert_msrc as j_invert_msrc
from quda_qkxtm_multigrid_tpu.ops import clover as jcl
from quda_qkxtm_multigrid_tpu.ops import dslash as jdsl
from quda_qkxtm_multigrid_tpu.utils import rng as jrng

from quda_qkxtm_multigrid_tpu_torch import convert
from quda_qkxtm_multigrid_tpu_torch import lattice as tlat
from quda_qkxtm_multigrid_tpu_torch.dirac import DiracParams, as_sloppy
from quda_qkxtm_multigrid_tpu_torch.invert import invert_msrc
from quda_qkxtm_multigrid_tpu_torch.ops import dslash_kernel as dk

dirac_from_numpy = functools.partial(convert.dirac_from_numpy, device="cpu")
T = functools.partial(convert.spinor_from_numpy, device="cpu")
N = convert.spinor_to_numpy

torch.set_num_threads(1)

GJ = jlat.Geometry(4, 4, 4, 8)
GT = tlat.Geometry(4, 4, 4, 8)
TMC = dict(kind="twisted-clover", kappa=0.115, mu=0.05, csw=1.0)
TM = dict(kind="twisted-mass", kappa=0.12, mu=0.07, flavor=-1)
N_SRC = 3
F64 = 1e-12      # plain batch vs plain single sources, float64
CHAIN = 1e-6     # four-hop chain vs two halves, float32 (sum order)


def rel(got, ref) -> float:
    got = N(got) if torch.is_tensor(got) else np.asarray(got)
    ref = N(ref) if torch.is_tensor(ref) else np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.linalg.norm((got - ref).ravel())
                 / np.linalg.norm(ref.ravel()))


@pytest.fixture(scope="module")
def flds():
    """complex128 gauge, doubled gauge, clover inverse, and N_SRC + 1
    spinors from numpy seed 91 (the gauge through the JAX package's
    ``random_gauge`` on a key from that seed)."""
    seed = int(np.random.default_rng(91).integers(2 ** 31))
    u = np.asarray(jrng.random_gauge(jax.random.PRNGKey(seed), GJ))
    rng = np.random.default_rng(92)
    shape = (N_SRC + 1, 2, 4, 3, GJ.T, GJ.Z, GJ.W)
    psi = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    ud = np.asarray(jdsl.double_gauge(u, GJ))
    _, cinv = jcl.make_clover_pair(u, GJ, jd.DiracParams(**TMC))
    return u, ud, np.asarray(cinv), psi


@pytest.mark.parametrize("post", ["clover", "twist"])
def test_msrc_reference_post_op_is_the_single_source_one(flds, post):
    _, ud, cinv, psi = flds
    a, b = 0.023, 1 / (1 + 0.023 ** 2)
    kw = dict(recon12=True, xpay_coef=-0.0132)
    if post == "clover":
        kw.update(clover="fwd", cinv_ch=dk.clover_channels(T(cinv), 0),
                  post_op=("clover",))
    else:
        kw.update(twist=(-a, b), post_op=("twist", a, b))
    g = dk.gauge_channels(T(ud), 0, True)
    cols = torch.stack([dk.to_channels(T(p[1])) for p in psi[:N_SRC]])
    xs = torch.stack([dk.to_channels(T(p[0])) for p in psi[:N_SRC]])
    assert cols.dtype == torch.float64
    out, out2 = dk.dslash_ch_msrc_reference(g, cols, 0, GT, x_ch=xs, **kw)
    for i in range(N_SRC):
        ref, ref2 = dk.dslash_ch_reference(g, cols[i], 0, GT, x_ch=xs[i],
                                           **kw)
        assert rel(out[i], ref) <= F64 and rel(out2[i], ref2) <= F64
    # the wrapper on float32 CPU tensors: its plain version, two outputs
    kw32 = {k: (v.float() if torch.is_tensor(v) else v)
            for k, v in kw.items()}
    got = dk.dslash_ch_msrc(g.float(), cols.float(), 0, GT,
                            x_ch=xs.float(), **kw32)
    assert isinstance(got, tuple) and len(got) == 2
    assert rel(got[1], out2) <= 1e-6


@pytest.mark.parametrize("kind", ["twisted-clover", "twisted-mass",
                                  "bf16 tier"])
def test_msrc_four_hop_chain_is_two_halves(flds, kind):
    u, _, _, psi = flds
    params = TM if kind == "twisted-mass" else TMC
    d = dirac_from_numpy(u, DiracParams(use_kernels=True, **params), GT)
    if kind == "bf16 tier":
        d = as_sloppy(d, kernel_bf16=True)
    cols = torch.stack([dk.to_channels(T(p[0])) for p in psi[:N_SRC]]).to(
        torch.float32)
    got = d._fused_matpc_dagm_ch(cols, hop=dk.dslash_ch_msrc)
    ref = d._fused_matpc_ch_msrc(d._fused_matpc_ch_msrc(cols, False), True)
    assert got.shape == cols.shape
    assert rel(got, ref) <= CHAIN


def test_invert_msrc_fused_matches_jax(flds):
    """The fused float32 path, whose matvec is the four-hop chain on the
    multi-source hop, against the JAX package's complex128 solve."""
    u, _, _, psi = flds
    bs = psi[:N_SRC]
    ref = j_invert_msrc(jd.make_dirac(u, jd.DiracParams(**TMC), GJ), bs,
                        tol=1e-9, maxiter=500)
    d = dirac_from_numpy(u, DiracParams(use_kernels=True, **TMC), GT)
    got = invert_msrc(d, T(bs), tol=1e-6, maxiter=500)
    assert got.true_res <= 5e-6
    assert rel(got.x, np.asarray(ref.x)) <= 1e-5


# ---- on the card ----------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_k2_post_op_on_card(flds):
    """K2 (float32 operands) and K2d (bf16 operands) with each second
    output, n = 3, at 4³×8: against the plain version (1e-5) and equal
    to n single-source launches of K1 / K1d bit for bit; each launch
    counted on its tier's counter."""
    dev = _card()
    _, ud, cinv, psi = flds
    a, b = 0.023, 1 / (1 + 0.023 ** 2)
    posts = [dict(clover="fwd", post_op=("clover",)),
             dict(twist=(-a, b), post_op=("twist", a, b))]
    cols = torch.stack([dk.to_channels(T(p[1], device=dev))
                        for p in psi[:N_SRC]]).float()
    xs = torch.stack([dk.to_channels(T(p[0], device=dev))
                      for p in psi[:N_SRC]]).float()
    for op, counter in ((torch.float32, "launches"),
                        (torch.bfloat16, "launches_bf16")):
        g = dk.gauge_channels(T(ud, device=dev), 0, True, op)
        ci = dk.clover_channels(T(cinv, device=dev), 0, op)
        for post in posts:
            kw = dict(recon12=True, xpay_coef=-0.0132, **post)
            if "clover" in post:
                kw["cinv_ch"] = ci
            before = getattr(dk.dslash_ch_msrc, counter)
            got = dk.dslash_ch_msrc(g, cols, 0, GT, x_ch=xs, **kw)
            assert getattr(dk.dslash_ch_msrc, counter) == before + 1
            ref = dk.dslash_ch_msrc_reference(g, cols, 0, GT, x_ch=xs, **kw)
            singles = [dk.dslash_ch(g, cols[i], 0, GT, x_ch=xs[i], **kw)
                       for i in range(N_SRC)]
            for j in range(2):
                assert float((got[j] - ref[j]).norm()
                             / ref[j].norm()) <= 1e-5
                assert torch.equal(got[j],
                                   torch.stack([s[j] for s in singles]))
