"""The compact operator's Schur chain in the bf16 spinor storage against
the JAX package's ``CompactDirac`` in Pallas interpret mode, on identical
operands (the port's bf16-tier operands handed to a JAX ``CompactDirac``)
at the JAX Pallas tests' 8×4×4×4: ``matpc_ch`` with bf16 output planes
(hops K1e o16 and s16o16) and ``matpc_ch(dagger=True)`` on that bf16
output (the plain A⁻¹† on a bf16 spinor, then the float32-A⁻¹ K1d hop
and the bf16-x K1e hop), which together are ``matpc_dagm_ch(
storage_dtype=bf16)``.  Four interpret hops in all, run once.

Tolerances: a bf16 output lies within one bf16 ulp of JAX's in every
element, except where the float32 sums (taken in another order) cancel
to below an ulp: there within 2⁻²⁰ of the output's largest value; and
1e-4 normwise.  A float32 output on identical inputs: 1e-5 normwise.
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

T = functools.partial(convert.spinor_from_numpy, device="cpu")

torch.set_num_threads(1)

BF16, F32 = torch.bfloat16, torch.float32
GJ_I = jlat.Geometry(8, 4, 4, 4)
GT_I = tlat.Geometry(8, 4, 4, 4)
TMC = dict(kind="twisted-clover", kappa=0.115, mu=0.05, csw=1.0)
F32_TOL, BF16_NORM, F32_SUM_BOUND = 1e-5, 1e-4, 2.0 ** -20


def to_jax(t: torch.Tensor):
    """A port channel tensor as a JAX array of the same dtype (bf16
    through float32, exact)."""
    a = jnp.asarray(t.to(F32).numpy() if t.dtype == BF16 else t.numpy())
    return a.astype(jnp.bfloat16) if t.dtype == BF16 else a


def from_jax(a) -> torch.Tensor:
    if a.dtype == jnp.bfloat16:
        return T(np.asarray(a.astype(jnp.float32))).to(BF16)
    return T(np.asarray(a))


def assert_bf16_close(got: torch.Tensor, ref: torch.Tensor):
    assert got.dtype == ref.dtype == BF16
    g, r = got.float(), ref.float()
    d = (g - r).abs()
    _, e = torch.frexp(torch.maximum(g.abs(), r.abs()))
    ulp = torch.ldexp(torch.ones_like(g), e - 8)
    bound = F32_SUM_BOUND * float(r.abs().max())
    assert not bool(((d > ulp) & (d > bound)).any())
    assert float((g - r).norm() / r.norm()) <= BF16_NORM


@pytest.fixture(scope="module")
def chain():
    """The port's bf16-tier operator, the JAX CompactDirac on the same
    operands, a float32 channel spinor, and JAX's two matpc halves."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(81))
    u = np.asarray(jrng.random_gauge(k1, GJ_I, dtype=jnp.complex128))
    psi = jrng.random_spinor(k2, GJ_I, dtype=jnp.complex128)
    cd = make_compact(T(u), DiracParams(**TMC), GT_I, BF16)
    jcd = jc.CompactDirac(
        g_ch=tuple(to_jax(cd.g_ch[p]) for p in (0, 1)),
        cinv_ch=tuple(to_jax(cd.cinv_ch[p]) for p in (0, 1)),
        cl_ch=tuple(to_jax(cd.cl_ch[p]) for p in (0, 1)),
        params=jd.DiracParams(**TMC, use_pallas=True, pallas_bf16=True),
        geom=GJ_I, interpret=True)
    v = j_to_channels(psi[0])
    fwd = jcd.matpc_ch(v, False, interpret=True, out_dtype=jnp.bfloat16)
    dag = jcd.matpc_ch(fwd, True, interpret=True)
    return cd, T(np.asarray(v)), from_jax(fwd), from_jax(dag)


def test_matpc_bf16_storage_matches_interpret(chain):
    """The forward Schur operator with bf16 output planes: the
    intermediate and the output each rounded once from float32."""
    cd, v, fwd, _ = chain
    assert_bf16_close(cd.matpc_ch(v, False, out_dtype=BF16), fwd)


def test_matpc_dagger_on_bf16_matches_interpret(chain):
    """The dagger Schur operator on JAX's bf16 output (identical input):
    the plain A⁻¹† widens the bf16 spinor to float32, as JAX's does."""
    cd, _, fwd, dag = chain
    got = cd.matpc_ch(fwd, True)
    assert got.dtype == F32
    assert float((got - dag).norm() / dag.norm()) <= F32_TOL


def test_matpc_dagm_bf16_storage_is_the_two_halves(chain):
    """``matpc_dagm_ch(storage_dtype=bf16)`` is the forward half in bf16
    storage followed by the dagger half; against JAX's composition it
    differs only through the bf16 intermediate's roundings."""
    cd, v, fwd, dag = chain
    got = cd.matpc_dagm_ch(v, storage_dtype=BF16)
    assert torch.equal(got, cd.matpc_ch(cd.matpc_ch(v, False, BF16), True))
    assert float((got - dag).norm() / dag.norm()) <= BF16_NORM
