"""``ops.gamma.apply_gamma`` against the JAX package's, for every
γ_μ and for an explicit matrix (γ5 γ4 and a random complex 4×4), on a
seeded spinor at 4³×8 with a leading batch axis: complex128 to 1e-14,
complex64 to 1e-6."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from quda_qkxtm_multigrid_tpu.ops.gamma import apply_gamma as j_apply_gamma

from quda_qkxtm_multigrid_tpu_torch.ops.gamma import (
    GAMMA, GAMMA5, apply_gamma)

_R = np.random.default_rng(61)
PSI = (_R.standard_normal((2, 2, 4, 3, 8, 4, 8))
       + 1j * _R.standard_normal((2, 2, 4, 3, 8, 4, 8)))
MATRICES = {"g5g4": GAMMA5 @ GAMMA[3],
            "random": _R.standard_normal((4, 4))
            + 1j * _R.standard_normal((4, 4))}
TOL = {np.complex128: 1e-14, np.complex64: 1e-6}


@pytest.mark.parametrize("dtype", [np.complex128, np.complex64])
@pytest.mark.parametrize("which", [0, 1, 2, 3, "g5g4", "random"])
def test_apply_gamma_matches_jax(which, dtype):
    m = which if isinstance(which, int) else MATRICES[which]
    psi = PSI.astype(dtype)
    got = apply_gamma(m, torch.tensor(psi)).numpy()
    ref = np.asarray(j_apply_gamma(m, jnp.asarray(psi)))
    assert got.dtype == ref.dtype
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=TOL[dtype] * np.abs(ref).max())
