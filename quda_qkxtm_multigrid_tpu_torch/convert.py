"""Carry fields across from the JAX package through numpy.

Both packages store fields in the same canonical layouts (see
``lattice.py``), so a field crosses as a plain numpy array with no
reindexing.  The functions take and give numpy arrays and never import
the JAX package: the caller turns its arrays into numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from quda_qkxtm_multigrid_tpu_torch.dirac import Dirac, DiracParams, make_dirac
from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry
from quda_qkxtm_multigrid_tpu_torch.mg.coarse_op import CoarseOperator
from quda_qkxtm_multigrid_tpu_torch.mg.transfer import (
    Bf16Transfer, BlockGeometry, CoarseBlockGeometry, CoarseTransfer,
    Transfer, block_orthonormalize_flat, to_blocked_flat)
from quda_qkxtm_multigrid_tpu_torch.parallel.mesh import TMesh, box_slab
from quda_qkxtm_multigrid_tpu_torch.parallel.sharded import (
    ShardedDirac, shard_dirac)


def spinor_from_numpy(a, device="cuda") -> torch.Tensor:
    """numpy field (any canonical layout) → tensor of the same dtype (a
    copy, on ``device``: the card unless the caller asks for the CPU)."""
    return torch.tensor(np.asarray(a), device=device)


def spinor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """tensor → numpy array on the host."""
    return t.detach().resolve_conj().cpu().numpy()


def eigenpairs_from_numpy(evals, evecs, resid=None, device="cuda"):
    """The port's ``solvers.eigen.EigResult`` from the JAX package's
    eigenpairs as numpy (``evecs`` [nev, ...field]), on ``device``."""
    from quda_qkxtm_multigrid_tpu_torch.solvers.eigen import EigResult
    vals = torch.tensor(np.asarray(evals), device=device)
    vecs = torch.tensor(np.asarray(evecs), device=device)
    res = (torch.zeros_like(vals) if resid is None or np.size(resid) == 0
           else torch.tensor(np.asarray(resid), device=device))
    if vecs.shape[0] != vals.shape[0]:
        raise ValueError(f"{vals.shape[0]} eigenvalues for "
                         f"{vecs.shape[0]} eigenvectors")
    return EigResult(evals=vals, evecs=vecs, resid=res)


def params_from_jax(p) -> DiracParams:
    """The port's ``DiracParams`` for a JAX package ``DiracParams`` (read
    by attribute; this module does not import it): ``use_pallas`` maps
    to ``use_kernels`` and ``pallas_bf16`` to ``kernel_bf16``.  A
    non-degenerate ``epsilon`` crosses too: such parameters build a
    ``dirac.DiracNdeg`` (``make_dirac_ndeg``), and ``make_dirac`` refuses
    them.  A doublet field [2f, 2p, 4, 3, T, Z, W] crosses as any field
    (``spinor_from_numpy``)."""
    return DiracParams(kind=p.kind, kappa=p.kappa, mu=p.mu,
                       epsilon=p.epsilon, csw=p.csw,
                       flavor=p.flavor, matpc_parity=p.matpc_parity,
                       asymmetric=p.asymmetric, use_kernels=p.use_pallas,
                       kernel_bf16=p.pallas_bf16)


def dirac_from_numpy(u, params, geom: Geometry, clover=None,
                     clover_inv=None, device="cuda") -> Dirac:
    """Build the port's ``Dirac`` on the JAX package's gauge (and clover)
    fields, given as numpy arrays [4,2,3,3,T,Z,W] (and [2,2,6,6,T,Z,W]).
    ``params`` is the port's ``DiracParams`` or the JAX package's, which
    ``params_from_jax`` carries across (its ``pallas_bf16`` included).
    The operator lives on ``device``, the card unless asked otherwise."""
    def conv(a):
        return None if a is None else spinor_from_numpy(a, device)
    if not isinstance(params, DiracParams):
        params = params_from_jax(params)
    return make_dirac(conv(u), params, geom, clover=conv(clover),
                      clover_inv=conv(clover_inv))


def spinor_slab_from_numpy(a, mesh: TMesh) -> torch.Tensor:
    """This rank's box of a numpy field (any canonical layout, trailing
    [T, Z, W]) on the mesh's device."""
    return box_slab(torch.tensor(np.asarray(a)), mesh)


def sharded_dirac_from_numpy(u, params, geom: Geometry, mesh: TMesh,
                             clover=None, clover_inv=None) -> ShardedDirac:
    """``dirac_from_numpy`` on the whole lattice, on the mesh's device,
    then this rank's box of it (``parallel.sharded.shard_dirac``)."""
    return shard_dirac(dirac_from_numpy(u, params, geom, clover, clover_inv,
                                        device=mesh.device), mesh)


def transfer_from_numpy(v, bg: BlockGeometry, dtype=torch.complex128,
                        device="cuda") -> Transfer | Bf16Transfer:
    """The port's ``Transfer`` from the JAX package's MG state, given as
    numpy: the planar pair ``(vr, vi)`` of ``Transfer.v``, each
    [2, Tc,Zc,Yc,Xc, nvec, bdof], or the complex V of that shape (what
    ``vec_outfile`` holds), used as it is; or raw null vectors
    [nvec, 2,4,3,T,Z,W], block-orthonormalised here as ``setup_mg``
    does.  A planar pair in bf16 (the JAX package's ``vec_dtype="bf16"``
    tier) gives a ``Bf16Transfer`` with the same bits (``dtype`` does
    not apply).  V lives on ``device``, the card unless asked
    otherwise."""
    vshape = (2,) + tuple(bg.coarse_shape) + (bg.nvec, bg.bdof)
    if isinstance(v, (tuple, list)) and len(v) == 2:
        if np.asarray(v[0]).dtype.name == "bfloat16":
            vr, vi = (torch.tensor(np.asarray(p, np.float32), device=device)
                      .to(torch.bfloat16) for p in v)
            if tuple(vr.shape) != vshape:
                raise ValueError(f"bf16 V shape {tuple(vr.shape)} != "
                                 f"{vshape}")
            return Bf16Transfer(vr=vr, vi=vi, bg=bg)
        a = np.asarray(v[0]) + 1j * np.asarray(v[1])
    else:
        a = np.asarray(v)
    if a.shape == vshape:
        return Transfer(v=torch.tensor(a, dtype=dtype, device=device), bg=bg)
    raw = (bg.nvec, 2, 4, 3) + bg.fine.lat_shape
    if a.shape != raw:
        raise ValueError(f"V shape {a.shape} is neither {vshape} nor raw "
                         f"null vectors {raw}")
    flat = to_blocked_flat(torch.tensor(a, dtype=dtype, device=device), bg)
    return Transfer(v=block_orthonormalize_flat(flat), bg=bg)


def coarse_transfer_from_numpy(v, bg2: CoarseBlockGeometry,
                               dtype=torch.complex128,
                               device="cuda") -> CoarseTransfer:
    """The port's ``CoarseTransfer`` from the JAX package's V2 (or V3) as
    numpy, [nvec2, T2,Z2,Y2,X2, bv, ns, nc1] (the same layout), on
    ``device``."""
    a = np.asarray(v)
    want = ((bg2.nvec,) + tuple(bg2.coarse_shape)
            + (bg2.block_volume, bg2.fine_ns, bg2.fine_nc))
    if a.shape != want:
        raise ValueError(f"V2 shape {a.shape} != {want}")
    return CoarseTransfer(v=torch.tensor(a, dtype=dtype, device=device),
                          bg=bg2)


def coarse_op_from_numpy(x, y, bg, dtype=torch.complex128,
                         device="cuda") -> CoarseOperator:
    """The port's ``CoarseOperator`` from the JAX package's X [dof, dof,
    cvol] and Y [8, dof, dof, cvol] as numpy: the site axis moves first,
    X [cvol, dof, dof], Y [8, cvol, dof, dof].  ``bg`` is the level's
    ``BlockGeometry`` or ``CoarseBlockGeometry``."""
    x, y = np.asarray(x), np.asarray(y)
    dof, cvol = bg.coarse_dof, bg.coarse_volume
    if x.shape != (dof, dof, cvol) or y.shape != (8, dof, dof, cvol):
        raise ValueError(f"X {x.shape}, Y {y.shape}: expected "
                         f"{(dof, dof, cvol)}, {(8, dof, dof, cvol)}")
    return CoarseOperator(
        x=torch.tensor(np.moveaxis(x, -1, 0), dtype=dtype, device=device),
        y=torch.tensor(np.moveaxis(y, -1, 1), dtype=dtype, device=device),
        bg=bg)
