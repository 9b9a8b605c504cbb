"""The multigrid's float32 products run in full float32 whatever the
caller has set (``utils.precision.full_float32``, the counterpart of the
JAX package's ``heinsum`` at ``Precision.HIGHEST``): with TF32 allowed by
the caller, restrict, prolong, the block orthonormalisation and the
coarse apply run their products with TF32 off, and the caller's setting
is back afterwards.  Every ``torch.matmul`` is recorded with the
precision in force when it ran.
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry
from quda_qkxtm_multigrid_tpu_torch.mg.coarse_op import CoarseOperator
from quda_qkxtm_multigrid_tpu_torch.mg.transfer import (
    BlockGeometry, Transfer, block_orthonormalize)
from quda_qkxtm_multigrid_tpu_torch.utils.precision import full_float32

ROOT = Path(__file__).resolve().parent.parent
GEOM = Geometry(4, 4, 4, 4)
BG = BlockGeometry(GEOM, 2, 2, 2, 2, nvec=3)


@pytest.fixture
def caller_allows_tf32(monkeypatch):
    """The caller's TF32 switch on, every matmul recorded with the
    precision in force; the switch restored after the test."""
    seen = []
    matmul = torch.matmul

    def spy(*args, **kwargs):
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.get_float32_matmul_precision()))
        return matmul(*args, **kwargs)
    monkeypatch.setattr(torch, "matmul", spy)
    saved = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield seen
    finally:
        torch.set_float32_matmul_precision(saved)


def test_mg_products_run_without_tf32(caller_allows_tf32):
    seen = caller_allows_tf32
    rng = np.random.default_rng(5)

    def cplx(*shape):
        return torch.tensor(rng.standard_normal(shape)
                            + 1j * rng.standard_normal(shape),
                            dtype=torch.complex64)
    v = cplx(2, *BG.coarse_shape, BG.nvec, BG.bdof)
    tr = Transfer(v=block_orthonormalize(v), bg=BG)
    f = cplx(2, 4, 3, GEOM.T, GEOM.Z, GEOM.W)
    vc = tr.restrict(f)
    tr.prolong(vc)
    dof, cvol = BG.coarse_dof, BG.coarse_volume
    CoarseOperator(x=cplx(cvol, dof, dof), y=cplx(8, cvol, dof, dof),
                   bg=BG).apply(vc)
    # CholQR² (2 products a pass, a coarse t row at a time), restrict,
    # prolong, coarse apply (one product of the 9 stencil blocks side by
    # side)
    assert len(seen) == 4 * BG.coarse_shape[0] + 3
    assert set(seen) == {(False, "highest")}
    assert torch.backends.cuda.matmul.allow_tf32 is True
    assert torch.get_float32_matmul_precision() == "high"


def test_three_level_vcycle_runs_without_tf32(caller_allows_tf32,
                                             monkeypatch):
    """The coarse levels of a three-level V-cycle (the level-1 coarse
    operator, the coarse transfer, the level-2 operator and its build)
    run every product in full float32 with TF32 allowed by the caller;
    ``torch.einsum`` is recorded too."""
    from quda_qkxtm_multigrid_tpu_torch.mg.coarse_op import (
        build_coarse_op_direct_coarse, coarse_diag_hops)
    from quda_qkxtm_multigrid_tpu_torch.mg.multigrid import (
        MGParams, MGPreconditioner)
    from quda_qkxtm_multigrid_tpu_torch.mg.transfer import (
        CoarseBlockGeometry, CoarseTransfer, block_orthonormalize_coarse)
    seen = caller_allows_tf32
    einsum = torch.einsum

    def spy(*args, **kwargs):
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.get_float32_matmul_precision()))
        return einsum(*args, **kwargs)
    monkeypatch.setattr(torch, "einsum", spy)
    rng = np.random.default_rng(6)

    def cplx(*shape):
        return torch.tensor(rng.standard_normal(shape)
                            + 1j * rng.standard_normal(shape),
                            dtype=torch.complex64)
    dof, cvol = BG.coarse_dof, BG.coarse_volume
    coarse = CoarseOperator(x=cplx(cvol, dof, dof) + 8 * torch.eye(dof),
                            y=0.1 * cplx(8, cvol, dof, dof), bg=BG)
    bg2 = CoarseBlockGeometry(tuple(BG.coarse_shape), 2, BG.nvec, 1, 1, 1,
                              2, nvec=2)
    v2 = block_orthonormalize_coarse(
        cplx(2, *bg2.coarse_shape, bg2.block_volume, 2, BG.nvec))
    tr2 = CoarseTransfer(v=v2, bg=bg2)
    diag, hops = coarse_diag_hops(coarse)
    coarse2 = build_coarse_op_direct_coarse(tr2, diag, hops, torch.complex64)
    mg = MGPreconditioner(transfer=None, coarse=coarse, dirac=None,
                          params=MGParams(n_level=3, coarse2_nkrylov=2),
                          transfer2=tr2, coarse2=coarse2)
    n0 = len(seen)
    out = mg._coarse_vcycle(cplx(2, BG.nvec, *BG.coarse_shape))
    assert bool(torch.isfinite(out).all())
    assert len(seen) > n0 > 0
    assert set(seen) == {(False, "highest")}
    assert torch.backends.cuda.matmul.allow_tf32 is True


def test_full_float32_keeps_the_per_backend_form():
    """A caller who set ``matmul.fp32_precision`` (the per-backend form,
    which cannot be read through the process-wide one) gets it back.
    In a process of its own: the two forms cannot be mixed in one."""
    script = textwrap.dedent("""
        import torch
        from quda_qkxtm_multigrid_tpu_torch.utils.precision import (
            full_float32)
        m = torch.backends.cuda.matmul
        m.fp32_precision = "tf32"
        with full_float32():
            assert m.fp32_precision == "ieee", m.fp32_precision
        assert m.fp32_precision == "tf32", m.fp32_precision
        print("ok")
    """)
    if not hasattr(torch.backends.cuda.matmul, "fp32_precision"):
        pytest.skip("this PyTorch has only the process-wide form")
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_full_float32_restores_on_error():
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        with pytest.raises(ZeroDivisionError):
            with full_float32():
                assert torch.get_float32_matmul_precision() == "highest"
                1 / 0
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(saved)
