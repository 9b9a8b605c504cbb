"""The port's fused BLAS updates and reductions (``ops/blas.py``:
``caxpy`` … ``block_cdot``) against the JAX package's ``ops/blas.py``,
on the CPU in complex128: every output, vector or scalar, to 1e-12
relative.  The fields come from a numpy seed; the scalars are complex.
"""

import numpy as np
import pytest
import torch

from quda_qkxtm_multigrid_tpu.ops import blas as jblas

from quda_qkxtm_multigrid_tpu_torch.ops import blas

torch.set_num_threads(1)

LIMIT = 1e-12
SHAPE = (2, 4, 3, 8, 4, 8)
A, B = 0.3 - 0.7j, -1.1 + 0.2j


def close(got, want):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.iscomplexobj(got) == np.iscomplexobj(want)
    err = np.linalg.norm((got - want).ravel())
    assert err <= LIMIT * max(np.linalg.norm(np.ravel(want)), 1e-300), err


@pytest.fixture(scope="module")
def vecs():
    rng = np.random.default_rng(7)
    return [rng.standard_normal(SHAPE) + 1j * rng.standard_normal(SHAPE)
            for _ in range(4)]


CASES = {
    "caxpy": lambda m, x, y, z, w: m.caxpy(A, x, y),
    "caxpby": lambda m, x, y, z, w: m.caxpby(A, x, B, y),
    "caxpbypz": lambda m, x, y, z, w: m.caxpbypz(A, x, B, y, z),
    "axpyZpbx": lambda m, x, y, z, w: m.axpyZpbx(0.4, x, y, z, -0.6),
    "xmyNorm": lambda m, x, y, z, w: m.xmyNorm(x, y),
    "axpyNorm": lambda m, x, y, z, w: m.axpyNorm(-0.25, x, y),
    "axpyCGNorm": lambda m, x, y, z, w: m.axpyCGNorm(0.75, x, y),
    "tripleCGReduction": lambda m, x, y, z, w: m.tripleCGReduction(x, y, z),
    "cDotProductNormA": lambda m, x, y, z, w: m.cDotProductNormA(x, y),
    "caxpyXmazNormX": lambda m, x, y, z, w: m.caxpyXmazNormX(A, x, y, z),
    "norm2": lambda m, x, y, z, w: m.norm2(x),
    "reDotProduct": lambda m, x, y, z, w: m.reDotProduct(x, y),
    "cDotProduct": lambda m, x, y, z, w: m.cDotProduct(x, y),
}


@pytest.mark.parametrize("name", list(CASES))
def test_fused_blas_matches_jax(vecs, name):
    got = CASES[name](blas, *(torch.tensor(v) for v in vecs))
    want = CASES[name](jblas, *vecs)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.is_tensor(g)
        close(g, w)


def test_batched_blas_matches_jax(vecs):
    xs = np.stack(vecs[:3])
    a = np.array([0.5 + 0.1j, -0.2 + 0.9j, 1.3 - 0.4j])
    close(blas.caxpy_batch(torch.tensor(a), torch.tensor(xs),
                           torch.tensor(vecs[3])),
          jblas.caxpy_batch(a, xs, vecs[3]))
    close(blas.block_cdot(torch.tensor(xs), torch.tensor(vecs[3])),
          jblas.block_cdot(xs, vecs[3]))


def test_reductions_stay_on_the_device_as_0d_tensors(vecs):
    """The scalars are 0-d tensors (no host read), real for norms and
    real dots, complex for the complex dot."""
    x, y, z = (torch.tensor(v) for v in vecs[:3])
    n2, n2y, rd = blas.tripleCGReduction(x, y, z)
    cd, na = blas.cDotProductNormA(x, y)
    for s in (n2, n2y, rd, na):
        assert s.dim() == 0 and not s.is_complex()
    assert cd.dim() == 0 and cd.is_complex()
