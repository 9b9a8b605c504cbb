"""The outputs of an MG set-up, V and the coarse operator:

  v_ortho    max |V V† − 1| over every aggregate
  galerkin   |D_c e − V† M V e| / |V† M V e| for random coarse fields e
             drawn from the seed: the coarse operator, read from its
             matrices, against the reference's own product
  null_hop   |1 − h(V) / h(w)|: V's hopping correlation inside the
             aggregates (``reference.nullspace``) against that of a
             null vector w = M⁻¹η that the reference solves itself (η
             Gaussian, from the seed); a V that is not made of solves
             reads about 1
"""

from __future__ import annotations

import torch

from portbench.gauge import derive_seed
from portbench.reference.galerkin import (
    coarse_apply, orthonormality_gap, prolong, restrict)
from portbench.reference.nullspace import block_hop
from portbench.reference.solver import cgnr

GALERKIN_PROBES = 2
NULL_TOL = 1e-3         # the reference's own null vector: CG to this
NULL_MAXITER = 300


def galerkin_gap(op, outputs, seed: int, probes: int) -> float:
    """The worst ``galerkin`` over ``probes`` random coarse fields."""
    v, x, y, nvec, block = outputs
    gen = torch.Generator(device="cpu").manual_seed(derive_seed(seed, 20))
    shape = (2, nvec) + tuple(v.shape[1:5])
    worst = 0.0
    for _ in range(probes):
        e = torch.complex(torch.randn(shape, generator=gen,
                                      dtype=torch.float64),
                          torch.randn(shape, generator=gen,
                                      dtype=torch.float64)).to(v.device)
        want = restrict(v, op.apply_lex(prolong(v, e, block)), block)
        got = coarse_apply(x, y, e)
        worst = max(worst, float(torch.linalg.vector_norm(
            got.to(torch.complex128) - want)
            / torch.linalg.vector_norm(want)))
    return worst


def reference_null_vector(ref, gauge_seed: int) -> torch.Tensor:
    """w = M⁻¹η in complex128, lexicographic, η Gaussian from the seed."""
    dims = ref.cfg["lattice"]
    gen = torch.Generator(device="cpu").manual_seed(
        derive_seed(ref.seed, 21))
    shape = (dims[3], dims[2], dims[1], dims[0], 4, 3)
    eta = torch.complex(torch.randn(shape, generator=gen,
                                    dtype=torch.float64),
                        torch.randn(shape, generator=gen,
                                    dtype=torch.float64)).to(ref.device)
    w, _ = cgnr(ref.operator(gauge_seed, keep_clover=True), eta, NULL_TOL,
                NULL_MAXITER)
    return w


def null_gap(ref, gauge_seed: int, v: torch.Tensor, block) -> float:
    u, dims = ref.gauge(gauge_seed), ref.cfg["lattice"]
    want = block_hop(u, dims, block,
                     w=reference_null_vector(ref, gauge_seed))
    return abs(1.0 - block_hop(u, dims, block, v=v) / want)


def judge(ref, payload):
    gs, outputs = payload["gauge_seed"], payload["outputs"]
    v, block = outputs[0], outputs[4]
    return [("v_ortho", orthonormality_gap(v)),
            ("galerkin", galerkin_gap(ref.operator(gs), outputs, ref.seed,
                                      GALERKIN_PROBES)),
            ("null_hop", null_gap(ref, gs, v, block))]
