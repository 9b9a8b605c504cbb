"""The JAX package's stand-alone Pallas hops V1–V4 against the port's
counterparts, at the JAX tests' Geometry(8, 4, 4, 4), in interpret mode.

Each is an instance of a kernel the port already has:

* V1, ``ops/dslash_pallas.dslash_parity_pallas`` (18-real links): K1's
  recon-18 float instance, ``dslash_parity_kernel(recon12=False)``;
* V2, ``ops/dslash_pallas2.dslash_parity_pallas2``: K1's recon-12 or
  recon-18 float instance, and with ``bf16=True`` K1d's bf16-ψ instance
  (``dslash_ch`` on bf16 gauge and ψ, float32 out);
* V3 and V4 (``attic/dslash_pallas3.py``, ``attic/dslash_pallas4.py``,
  loaded by path) compute V2's hop ("same semantics as
  dslash_parity_pallas2"), with the same options.

On the CPU the port runs its plain versions.  The fields are made from a
numpy seed in complex64: a random SU(3) gauge and a Gaussian spinor.
Tolerances, normwise relative: 1e-5 for the float forms (two float32
sums in another order); the same for bf16, since both packages round
each operand once to bf16 the same way (complex64 → float32 channels →
bf16; ``test_torch_bf16.test_bf16_operands_bitexact``) and then sum in
float32.  One case per kernel runs in the smoke tier, the rest are
``slow`` (each interpret-mode case takes 15–30 s on one CPU core; the
bf16-ψ form of K1d is also held against the v5 kernel's in
``test_torch_bf16.py``, in the smoke tier).
"""

import functools
import importlib.util
from pathlib import Path

import numpy as np
import jax  # noqa: F401  (the JAX package's platform set-up)
import pytest
import torch

from quda_qkxtm_multigrid_tpu import lattice as jlat
from quda_qkxtm_multigrid_tpu.ops import dslash as jdsl
from quda_qkxtm_multigrid_tpu.ops.dslash_pallas import dslash_parity_pallas
from quda_qkxtm_multigrid_tpu.ops.dslash_pallas2 import dslash_parity_pallas2

from quda_qkxtm_multigrid_tpu_torch import convert
from quda_qkxtm_multigrid_tpu_torch import lattice as tlat
from quda_qkxtm_multigrid_tpu_torch.ops import dslash_kernel as dk

T = functools.partial(convert.spinor_from_numpy, device="cpu")
N = convert.spinor_to_numpy

GJ = jlat.Geometry(8, 4, 4, 4)       # the JAX Pallas tests' geometry
GT = tlat.Geometry(8, 4, 4, 4)
LIMIT = 1e-5
ATTIC = Path(__file__).resolve().parent.parent / "attic"


def _attic(name: str):
    spec = importlib.util.spec_from_file_location(f"attic_{name}",
                                                  ATTIC / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _su3(rng, shape):
    """Random SU(3) matrices [..., 3, 3]: the Q of a complex Gaussian's
    QR, its phases fixed, divided by a cube root of its determinant."""
    a = rng.standard_normal(shape + (3, 3)) \
        + 1j * rng.standard_normal(shape + (3, 3))
    q, r = np.linalg.qr(a)
    d = np.diagonal(r, axis1=-2, axis2=-1)
    q = q * (d / np.abs(d))[..., None, :]
    return q / np.linalg.det(q)[..., None, None] ** (1 / 3)


@pytest.fixture(scope="module")
def fields():
    """complex64 doubled gauge [4,2,2,3,3,T,Z,W] and spinor [2,4,3,T,Z,W]
    from numpy seed 81."""
    rng = np.random.default_rng(81)
    vol = (2, GJ.T, GJ.Z, GJ.W)
    u = np.moveaxis(_su3(rng, (4,) + vol), (-2, -1), (2, 3))
    psi = (rng.standard_normal((2, 4, 3) + vol[1:])
           + 1j * rng.standard_normal((2, 4, 3) + vol[1:]))
    ud = np.asarray(jdsl.double_gauge(u.astype(np.complex64), GJ))
    return ud, psi.astype(np.complex64)


def _rel(got, ref) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.linalg.norm((got - ref).ravel())
                 / np.linalg.norm(ref.ravel()))


def _port(ud, psi, parity, dagger, recon12, bf16):
    """The port's counterpart on the CPU: K1's float instance through
    ``dslash_parity_kernel``, or K1d's bf16-ψ instance."""
    if not bf16:
        out = dk.dslash_parity_kernel(T(ud), T(psi), parity, GT, dagger,
                                      recon12=recon12)
        assert out.dtype == torch.complex64
        return N(out)
    g16 = dk.gauge_channels(T(ud), parity, recon12, torch.bfloat16)
    v16 = dk.cast_channels(dk.to_channels(T(psi)), torch.bfloat16)
    out = dk.dslash_ch(g16, v16, parity, GT, dagger, recon12=recon12)
    assert out.dtype == torch.float32
    return N(dk.from_channels(out, (4, 3)))


def _jax(kernel, ud, psi, parity, dagger, recon12, bf16):
    if kernel == "v1":
        assert recon12 is False and not bf16
        return dslash_parity_pallas(ud, psi, parity, GJ, dagger,
                                    interpret=True)
    fn = {"v2": lambda: dslash_parity_pallas2,
          "v3": lambda: _attic("dslash_pallas3").dslash_parity_pallas3,
          "v4": lambda: _attic("dslash_pallas4").dslash_parity_pallas4
          }[kernel]()
    return fn(ud, psi, parity, GJ, dagger, interpret=True, recon12=recon12,
              bf16=bf16)


slow = pytest.mark.slow


@pytest.mark.parametrize("kernel,parity,dagger,recon12,bf16", [
    ("v1", 0, False, False, False),
    pytest.param("v1", 1, True, False, False, marks=slow),
    ("v2", 1, True, False, False),
    pytest.param("v2", 0, True, True, False, marks=slow),
    pytest.param("v2", 1, False, True, True, marks=slow),
    pytest.param("v2", 0, False, False, True, marks=slow),
    ("v3", 0, True, False, False),
    pytest.param("v3", 1, False, True, True, marks=slow),
    ("v4", 1, False, True, False),
    pytest.param("v4", 0, True, True, True, marks=slow),
])
def test_v_kernel_matches_port(fields, kernel, parity, dagger, recon12,
                               bf16):
    ud, psi = fields
    ref = _jax(kernel, ud, psi[1 - parity], parity, dagger, recon12, bf16)
    got = _port(ud, psi[1 - parity], parity, dagger, recon12, bf16)
    assert _rel(got, ref) <= LIMIT
