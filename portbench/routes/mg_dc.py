"""MG at a volume where the canonical set-up does not fit: the HBM-gated
set-up ``setup_mg_hbm`` (null vectors on the compact bf16 tier, CholQR²
in place, the coarse build on a lean complex64 operator, bf16 V), the
exact operator ``make_compact(inverse=False)`` (float64:
``exact_dtype``), and each solve a
float64 defect-correction outer (``solvers.support.defect_correction``,
residuals of the exact operator) around ``inner_mg``, MG-GCR-PC in
complex64.  The glue is that of the port's ``bench_mg48_dc``."""

from __future__ import annotations

import types

import torch

from portbench.routes.common import dirac_params, geometry, mg_params


def build(cfg: dict, u: torch.Tensor, gen: torch.Generator,
          use_kernels: bool = True):
    from quda_qkxtm_multigrid_tpu_torch.compact import make_compact
    from quda_qkxtm_multigrid_tpu_torch.mg.hbm_setup import setup_mg_hbm
    geom = geometry(cfg)
    params = dirac_params(cfg, use_kernels, kernel_bf16=use_kernels)
    mg, _ = setup_mg_hbm(u, params, geom, mg_params(cfg), gen)
    exact = make_compact(u, params, geom,
                         getattr(torch, cfg["solve"]["exact_dtype"]),
                         inverse=False)
    return types.SimpleNamespace(mg=mg, exact=exact,
                                 stats=dict(mg.setup_stats),
                                 cfg_solve=cfg["solve"])


def solve(state, b: torch.Tensor):
    from quda_qkxtm_multigrid_tpu_torch.mg.multigrid import inner_mg
    from quda_qkxtm_multigrid_tpu_torch.solvers.support import (
        defect_correction)
    s = state.cfg_solve
    inner = inner_mg(state.mg, tol=s["inner_tol"], solver=s["solver"],
                     max_restarts=s["inner_max_restarts"],
                     n_krylov=s["n_krylov"])
    each = []

    def solve_lo(r, cap):
        e = inner(r, cap)
        each.append(e.iters)
        return e

    x, _, iters, st = defect_correction(
        state.exact.m, solve_lo, b.to(torch.complex128), torch.complex64,
        s["tol"], maxiter=s["maxiter"], max_restarts=s["max_restarts"],
        max_res_increase=s["max_res_increase"],
        max_res_increase_total=s["max_res_increase_total"])
    return x, {"inner_iters": iters, "restarts": st.restarts,
               "diverged": st.diverged}


def setup_outputs(state):
    return None


def release(state):
    state.mg = state.exact = None
