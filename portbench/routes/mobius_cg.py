"""Möbius domain-wall fermions through ``invert``: the operator
``ops.domain_wall.MobiusDirac`` on the configuration's links in
``operator_dtype``, and each solve ``invert(op, b, solver="cg")`` — the
5D even-odd Schur system by CG on M_pc† M_pc on channels, the odd parity
rebuilt, the true residual of the full 5D system.  No MG set-up."""

from __future__ import annotations

import types

import torch

from portbench.routes.common import geometry


def build(cfg: dict, u: torch.Tensor, gen: torch.Generator,
          use_kernels: bool = True):
    from quda_qkxtm_multigrid_tpu_torch.ops.domain_wall import MobiusDirac
    a = cfg["action"]
    op = MobiusDirac(u.to(getattr(torch, cfg["operator_dtype"])),
                     geometry(cfg), a["ls"], a["m5"], a["mferm"], a["b5"],
                     a["c5"], use_kernels=use_kernels)
    return types.SimpleNamespace(op=op, stats={}, cfg_solve=cfg["solve"])


def solve(state, b: torch.Tensor):
    from quda_qkxtm_multigrid_tpu_torch.invert import invert
    s = state.cfg_solve
    out = invert(state.op, b, tol=s["tol"], maxiter=s["maxiter"],
                 solver=s["solver"])
    return out.x, {"cg_iters": out.iters}


def setup_outputs(state):
    return None


def release(state):
    state.op = None
