"""The canonical two-level MG: ``make_dirac`` on the complex64 gauge,
``setup_mg`` (null vectors through ``invert_msrc``, CholQR², the
Galerkin build), then ``mg_solve`` — restarted GCR on the even-odd Schur
system, preconditioned by the V-cycle — to the configuration's
tolerance, its final residual that of the full system."""

from __future__ import annotations

import types

import torch

from portbench.routes.common import dirac_params, geometry, mg_params


def build(cfg: dict, u: torch.Tensor, gen: torch.Generator,
          use_kernels: bool = True, null_vectors=None):
    """``null_vectors`` (fields [2, 4, 3, T, Z, W]) replace the set-up's
    null-vector solves: the controls' set-up made without them."""
    from quda_qkxtm_multigrid_tpu_torch.dirac import make_dirac
    from quda_qkxtm_multigrid_tpu_torch.mg.multigrid import setup_mg
    d = make_dirac(u.to(torch.complex64), dirac_params(cfg, use_kernels),
                   geometry(cfg))
    mg = setup_mg(d, mg_params(cfg), gen, null_vectors=null_vectors)
    return types.SimpleNamespace(mg=mg, stats=dict(mg.setup_stats),
                                 cfg_solve=cfg["solve"])


def solve(state, b: torch.Tensor):
    from quda_qkxtm_multigrid_tpu_torch.mg.multigrid import mg_solve
    s = state.cfg_solve
    out = mg_solve(state.mg, b.to(torch.complex64), tol=s["tol"],
                   n_krylov=s["n_krylov"], max_restarts=s["max_restarts"],
                   solver=s["solver"])
    return out.x, {"outer_iters": out.iters}


def setup_outputs(state):
    """(V [2, Tc, Zc, Yc, Xc, nvec, bdof] complex, X [cvol, dof, dof],
    Y [8, cvol, dof, dof], nvec, block) of the set-up."""
    mg = state.mg
    bg = mg.coarse.bg
    return (mg.transfer.v, mg.coarse.x, mg.coarse.y, bg.nvec,
            (bg.bx, bg.by, bg.bz, bg.bt))


def release(state):
    state.mg = None
