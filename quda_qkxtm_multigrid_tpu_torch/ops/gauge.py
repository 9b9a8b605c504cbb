"""Gauge-field observables on the canonical layout: the counterpart of
the JAX package's ``ops/gauge.py`` (``plaquette`` and
``apply_t_boundary``; the gauge transformations and gauge fixing are
ROADMAP queue 1, "Everything else on one device").

Gauge layout [4, 2, 3, 3, T, Z, W].
"""

from __future__ import annotations

import torch

from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry, gather_neighbor
from quda_qkxtm_multigrid_tpu_torch.ops.smallmat import mat_mul


def plaquette(u: torch.Tensor, geom: Geometry):
    """Mean plaquette (1/3) Re tr U_mu U_nu U_mu† U_nu† over all sites and
    the 6 planes: (total, spatial, temporal) as 0-d real tensors, the
    JAX package's ``plaquette`` (the reference's ``plaqQuda``)."""
    spatial = temporal = 0.0
    for mu in range(4):
        for nu in range(mu + 1, 4):
            acc = 0.0
            for p in (0, 1):
                m = mat_mul(u[mu, p],
                            gather_neighbor(u[nu, 1 - p], mu, True, p, geom))
                n = mat_mul(u[nu, p],
                            gather_neighbor(u[mu, 1 - p], nu, True, p, geom))
                acc = acc + (m * n.conj()).real.sum()
            if nu == 3:
                temporal = temporal + acc
            else:
                spatial = spatial + acc
    norm = 3.0 * geom.volume * 3.0
    spatial, temporal = spatial / norm, temporal / norm
    return (spatial + temporal) / 2.0, spatial, temporal


def apply_t_boundary(u: torch.Tensor, geom: Geometry,
                     phase: float = -1.0) -> torch.Tensor:
    """U_t at t = T−1 multiplied by ``phase`` (−1: the antiperiodic
    fermion boundary in t), as a new field.  The fused operator reads
    the boundary back from the links (``ops.dslash_kernel.
    antiperiodic_t``)."""
    out = u.clone()
    out[3, :, :, :, geom.T - 1] *= phase
    return out
