"""The compact operator's Schur source, solution rebuild and full
operator (``prepare_ch``, ``reconstruct_ch``, ``m_ch``) of the bf16 tier
against the JAX package's ``CompactDirac`` methods on identical operands
(the port's handed to a JAX ``CompactDirac``) at 8×4×4×4.

Each method is one float32 xpay hop on the bf16 gauge (K1d's form) around
the plain A or A⁻¹.  On the JAX side the hop runs through the port's
plain hop, which ``tests/test_torch_bf16.py`` holds against the JAX
Pallas kernel in interpret mode in that form; the rest (which parity, the
coefficients, where A and A⁻¹ go, the plain 6×6 applies in ``jnp``) is
the JAX package's own code.  So no Pallas interpret run is needed here:
the four interpret hops of the compact operator are those of the Schur
chain, ``tests/test_torch_compact_chain.py``.  The outputs are float32:
1e-5 normwise.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from quda_qkxtm_multigrid_tpu import compact as jc
from quda_qkxtm_multigrid_tpu import dirac as jd
from quda_qkxtm_multigrid_tpu import lattice as jlat
from quda_qkxtm_multigrid_tpu.ops.dslash_pallas import (
    _to_channels as j_to_channels)
from quda_qkxtm_multigrid_tpu.utils import rng as jrng

from quda_qkxtm_multigrid_tpu_torch import convert
from quda_qkxtm_multigrid_tpu_torch import lattice as tlat
from quda_qkxtm_multigrid_tpu_torch.compact import make_compact
from quda_qkxtm_multigrid_tpu_torch.dirac import DiracParams
from quda_qkxtm_multigrid_tpu_torch.ops.dslash_kernel import (
    dslash_ch_reference)

T = functools.partial(convert.spinor_from_numpy, device="cpu")

torch.set_num_threads(1)

BF16, F32 = torch.bfloat16, torch.float32
GJ_I = jlat.Geometry(8, 4, 4, 4)
GT_I = tlat.Geometry(8, 4, 4, 4)
TMC = dict(kind="twisted-clover", kappa=0.115, mu=0.05, csw=1.0)
F32_TOL = 1e-5


def to_jax(t: torch.Tensor):
    a = jnp.asarray(t.to(F32).numpy())
    return a.astype(jnp.bfloat16) if t.dtype == BF16 else a


def from_jax(a) -> torch.Tensor:
    t = T(np.asarray(a.astype(jnp.float32)))
    return t.to(BF16) if a.dtype == jnp.bfloat16 else t


def rel(got: torch.Tensor, ref) -> float:
    r = np.asarray(ref)
    return float(np.linalg.norm(got.numpy() - r) / np.linalg.norm(r))


def _plain_v5(self, parity, psi_ch, interpret=False, **kw):
    """The JAX ``CompactDirac._v5`` hop through the port's plain hop, on
    the JAX operator's own gauge channels."""
    for name in ("x_ch", "cinv_ch"):
        if kw.get(name) is not None:
            kw[name] = from_jax(kw[name])
    out = dslash_ch_reference(from_jax(self.g_ch[parity]), from_jax(psi_ch),
                              parity, GT_I, recon12=True, **kw)
    return jnp.asarray(out.numpy())


@pytest.fixture(scope="module")
def schur():
    """The port's bf16-tier operator, channel fields b and x, and the
    JAX CompactDirac's prepare, reconstruct and full operator on them."""
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(83), 3)
    u = np.asarray(jrng.random_gauge(k1, GJ_I, dtype=jnp.complex128))
    b = jrng.random_spinor(k2, GJ_I, dtype=jnp.complex128)
    x = jrng.random_spinor(k3, GJ_I, dtype=jnp.complex128)
    cd = make_compact(T(u), DiracParams(**TMC), GT_I, BF16)
    jcd = jc.CompactDirac(
        g_ch=tuple(to_jax(cd.g_ch[p]) for p in (0, 1)),
        cinv_ch=tuple(to_jax(cd.cinv_ch[p]) for p in (0, 1)),
        cl_ch=tuple(to_jax(cd.cl_ch[p]) for p in (0, 1)),
        params=jd.DiracParams(**TMC, use_pallas=True, pallas_bf16=True),
        geom=GJ_I)
    bj = [j_to_channels(b[p]).astype(jnp.float32) for p in (0, 1)]
    xj = [j_to_channels(x[p]).astype(jnp.float32) for p in (0, 1)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jc.CompactDirac, "_v5", _plain_v5)
        ref = {"prepare": jcd.prepare_ch(*bj),
               "reconstruct": jcd.reconstruct_ch(xj[0], *bj),
               "m": jcd.m_ch(*xj)}
    bt = [T(np.asarray(a)) for a in bj]
    xt = [T(np.asarray(a)) for a in xj]
    return cd, bt, xt, ref


def test_prepare_matches_jax(schur):
    cd, b, _, ref = schur
    got = cd.prepare_ch(*b)
    assert got.dtype == F32 and rel(got, ref["prepare"]) <= F32_TOL


def test_reconstruct_matches_jax(schur):
    cd, b, x, ref = schur
    got = cd.reconstruct_ch(x[0], *b)
    assert torch.equal(got[0], x[0])
    for g, r in zip(got, ref["reconstruct"]):
        assert rel(g, r) <= F32_TOL


def test_full_operator_matches_jax(schur):
    cd, _, x, ref = schur
    for g, r in zip(cd.m_ch(*x), ref["m"]):
        assert g.dtype == F32 and rel(g, r) <= F32_TOL
