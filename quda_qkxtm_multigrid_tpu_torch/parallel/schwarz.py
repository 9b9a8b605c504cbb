"""Schwarz domain-decomposition preconditioners on a process grid: the
counterpart of the JAX package's ``parallel/schwarz.py`` (the
reference's QudaSchwarzType additive / multiplicative, quda.h:250).

Each rank's block is its box's own operator with the t, z and y wraps
inside the box (``parallel.sharded.local_block``): a preconditioner
application is ``niter`` MR steps of that block, with no communication
(on the card every hop is K1 on the local geometry).  Any fixed local
approximation is an admissible block inverse, and the flexible outer GCR
(on the sharded operator, ``solvers.gcr.gcr(allreduce=mesh.allreduce)``)
absorbs its nonlinearity.
"""

from __future__ import annotations

import torch

from quda_qkxtm_multigrid_tpu_torch.parallel.mesh import TMesh
from quda_qkxtm_multigrid_tpu_torch.parallel.sharded import (
    ShardedDirac, local_block)
from quda_qkxtm_multigrid_tpu_torch.solvers.mr import mr


def schwarz_precond(dirac: ShardedDirac, mesh: TMesh, niter: int = 4,
                    omega: float = 0.85):
    """Additive Schwarz: r → ``niter`` MR steps of this rank's block on
    its box of r (blockdiag(M)⁻¹ r approximately), no communication."""
    if dirac.mesh is not mesh:
        raise ValueError("a ShardedDirac's Schwarz blocks are on its own "
                         "mesh")
    block = local_block(dirac)

    def k(r: torch.Tensor) -> torch.Tensor:
        return mr(block.m, r, niter=niter, omega=omega)
    return k


def schwarz_precond_multiplicative(dirac: ShardedDirac, mesh: TMesh,
                                   niter: int = 4, omega: float = 0.85):
    """Two-colour multiplicative Schwarz: the ranks are coloured by the
    parity of the sum of their grid coordinates (red: it + iz + iw even,
    the JAX package's ``_shard_color_mask``); the red blocks solve r, then the
    black blocks solve the residual that the red half-sweep left, at the
    cost of one more application of the whole sharded operator.  The
    JAX package masks both halves on every shard; here a rank runs only
    its own colour's block (the other half is exactly zero there)."""
    block = schwarz_precond(dirac, mesh, niter=niter, omega=omega)
    red = sum(mesh.coords) % 2 == 0

    def k(r: torch.Tensor) -> torch.Tensor:
        z1 = block(r) if red else torch.zeros_like(r)
        r1 = r - dirac.m(z1)
        return z1 if red else block(r1)
    return k
