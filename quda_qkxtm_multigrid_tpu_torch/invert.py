"""High-level solve entry point.

Factorise the solve (even-odd preconditioned system), prepare the Schur
source, run the Krylov solver, reconstruct the full-lattice solution,
and report the true residual of the full operator in the source's
precision.  Solvers: "cg" and its mixed-precision form "cg-mixed" on the
normal equations M_pc† M_pc x_p = M_pc† src; "bicgstab" and
"bicgstab-mixed" on M_pc x_p = src.  A ``compact.CompactDirac`` solves
with "cg" only, through ``compact.invert_compact_full``.  With ``mesh``
the solve runs t-sharded, one rank's slab per process
(``parallel.sharded``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from quda_qkxtm_multigrid_tpu_torch.compact import (
    CompactDirac, invert_compact_full)
from quda_qkxtm_multigrid_tpu_torch.dirac import Dirac
from quda_qkxtm_multigrid_tpu_torch.ops.blas import norm2
from quda_qkxtm_multigrid_tpu_torch.ops.dslash_kernel import (
    dslash_ch_msrc, from_channels, to_channels)
from quda_qkxtm_multigrid_tpu_torch.parallel.mesh import TMesh
from quda_qkxtm_multigrid_tpu_torch.parallel.sharded import ShardedDirac
from quda_qkxtm_multigrid_tpu_torch.solvers.bicgstab import (
    bicgstab, bicgstab_mixed)
from quda_qkxtm_multigrid_tpu_torch.solvers.cg import cg, cg_mixed
from quda_qkxtm_multigrid_tpu_torch.solvers.msrc import msrc_cg
from quda_qkxtm_multigrid_tpu_torch.solvers.support import ReliableStats

SOLVERS = ("cg", "cg-mixed", "bicgstab", "bicgstab-mixed")


class InvertResult(NamedTuple):
    x: torch.Tensor       # full solution [2,4,3,T,Z,W]
    iters: int            # Krylov iterations (mixed: summed inner ones)
    true_res: float       # |M x − b| / |b|
    stats: Optional[ReliableStats] = None   # restarts of a mixed solver


def _default_sloppy(dirac: Dirac) -> Dirac:
    """The sloppy operator when the caller gives none: the operator one
    tier down, complex128 → complex64 (the JAX package's
    ``_default_sloppy``).  On the fused chain that is the operator
    itself: its kernels read channel operands in the spinors' dtype, so
    the float32 inner loop reads float32 channels cast from the
    complex128 fields (what a complex64 copy gives), cached beside the
    float64 ones, and no field is copied.  Otherwise it is a complex64
    cast copy of the fields (a complex64 field is shared as it is)."""
    if dirac._has_fused_matpc:
        return dirac
    lo = torch.complex64

    def cast(t):
        return None if t is None else t.to(lo)
    return Dirac(cast(dirac.u), dirac.params, dirac.geom,
                 clover=cast(dirac.clover), clover_inv=cast(dirac.clover_inv),
                 u_doubled=cast(dirac.u_doubled))


def invert(dirac: Dirac | CompactDirac, b: torch.Tensor, tol: float = 1e-10,
           maxiter: int = 1000, solver: str = "cg",
           sloppy_dirac: Dirac | None = None,
           inner_tol: float = 1e-2, mesh: TMesh | None = None,
           overlap: bool = False) -> InvertResult:
    """Solve M x = b with ``solver`` (one of ``SOLVERS``) on the even-odd
    preconditioned system.  The mixed solvers run their inner solve on
    ``sloppy_dirac`` (``_default_sloppy`` if None; the bf16 tier is
    ``as_sloppy(dirac, kernel_bf16=True)``) to ``inner_tol``, and
    ``maxiter`` caps the sum of their inner iterations.

    A ``CompactDirac`` operator solves with "cg" only and no sloppy
    operator (``compact.invert_compact_full``, the JAX package's
    dispatch); anything else raises, and so does a ``CompactDirac`` as
    the sloppy operator.

    When the operator has the fused kernel chain (``use_kernels`` with a
    twisted or clover kind, symmetric Schur form), the Krylov loops run
    on planar-channel fields, converted once per solve: "cg" and
    "bicgstab" in float32, each matvec four (two) fused hops; the mixed
    solvers' outer loop in the fields' precision (float64 channels for a
    complex128 operator, K1's double instance) and their inner loop on
    the sloppy operator's float32 channels (bf16 operands in the bf16
    tier).  This differs on purpose from the JAX package, whose fused
    outer matvec is float32 (its ``matpc_dagm``): the card has native
    float64, so the outer here certifies the tolerance in complex128.
    Source preparation, reconstruction and the true residual stay in the
    fields' precision.

    ``mesh`` runs the t-sharded solve (``_invert_sharded``): ``dirac`` is
    this rank's ``parallel.sharded.shard_dirac`` on that mesh and ``b``
    its ``shard_spinor``; the result holds this rank's slab of x and the
    whole lattice's true residual.  ``overlap`` picks K5 for the chain's
    hops instead of K4 (the JAX package's ``None``, read from its tuned
    policy, has no counterpart: the choice is the caller's)."""
    if solver not in SOLVERS:
        raise ValueError(f"unknown solver {solver!r}; one of {SOLVERS}")
    if isinstance(dirac, CompactDirac) and mesh is not None:
        raise ValueError("a CompactDirac is the one-card path for volumes "
                         "the card's memory limits; shard the full Dirac "
                         "instead")
    if mesh is not None or isinstance(dirac, ShardedDirac):
        return _invert_sharded(dirac, b, tol, maxiter, solver,
                               sloppy_dirac, mesh, overlap)
    if isinstance(dirac, CompactDirac):
        if solver != "cg":
            raise ValueError(f"a CompactDirac solves with solver='cg' only, "
                             f"not {solver!r}")
        if sloppy_dirac is not None:
            raise ValueError("a CompactDirac solve takes no sloppy operator")
        return invert_compact_full(dirac, b, tol=tol, maxiter=maxiter)
    if isinstance(sloppy_dirac, CompactDirac):
        raise ValueError("a CompactDirac is no sloppy operator of invert: "
                         "it solves on its own, with solver='cg'")
    mixed = solver.endswith("-mixed")
    if mixed and sloppy_dirac is None:
        sloppy_dirac = _default_sloppy(dirac)
    normal = solver.startswith("cg")
    src = dirac.prepare(b)
    rhs = dirac.matpc(src, dagger=True) if normal else src
    fused = dirac._has_fused_matpc and (
        not mixed or sloppy_dirac._has_fused_matpc)

    def matvec(d: Dirac):
        if fused:
            return (d._fused_matpc_dagm_ch if normal
                    else lambda v: d._fused_matpc_ch(v, False))
        return d.matpc_dagm if normal else d.matpc

    v = rhs
    if fused:
        v = to_channels(rhs)
        if not mixed or dirac.params.kernel_bf16:
            v = v.to(torch.float32)
    if mixed:
        solve = cg_mixed if normal else bicgstab_mixed
        res = solve(matvec(dirac), matvec(sloppy_dirac), v, tol=tol,
                    maxiter=maxiter, inner_tol=inner_tol,
                    lo_dtype=torch.float32 if fused else torch.complex64)
    else:
        res = (cg if normal else bicgstab)(matvec(dirac), v, tol=tol,
                                           maxiter=maxiter)
    x_p = from_channels(res.x, (4, 3)).to(rhs.dtype) if fused else res.x
    x = dirac.reconstruct(x_p, b)
    _, rel = true_residual(dirac, x, b)
    return InvertResult(x, res.iters, float(rel), res.stats)


def _invert_sharded(dirac: ShardedDirac, b: torch.Tensor, tol: float,
                    maxiter: int, solver: str, sloppy_dirac, mesh: TMesh,
                    overlap: bool) -> InvertResult:
    """The t-sharded solve (the JAX package's ``invert(mesh=…)``): CG on
    the float32 sharded chain ``dirac.matpc_ch`` (four halo hops an
    iteration, K4 or with ``overlap`` K5), its reductions summed over
    the ring; prepare, the right-hand side's matpc†, reconstruct and the
    true residual in the fields' precision through the slab's K4 hop
    (float64 for complex128).  "cg" only."""
    if solver != "cg":
        raise ValueError(f"a sharded solve (mesh=...) runs solver='cg' "
                         f"only, not {solver!r}")
    if sloppy_dirac is not None:
        raise ValueError("a sharded solve takes no sloppy operator")
    if not isinstance(dirac, ShardedDirac):
        raise ValueError("mesh= needs this rank's slab of the operator: "
                         "parallel.sharded.shard_dirac(dirac, mesh)")
    if mesh is not dirac.mesh:
        raise ValueError("a ShardedDirac solves on its own mesh: pass "
                         "mesh=dirac.mesh")
    if not dirac.has_sharded_chain:
        raise ValueError("the sharded solve needs the fused chain: "
                         "use_kernels, the symmetric Schur form and a "
                         "twisted or clover kind")
    src = dirac.prepare(b)
    rhs = dirac.matpc(src, dagger=True)

    def matvec(v):
        return dirac.matpc_ch(dirac.matpc_ch(v, False, overlap), True,
                              overlap)

    res = cg(matvec, to_channels(rhs).to(torch.float32), tol=tol,
             maxiter=maxiter, allreduce=mesh.allreduce)
    x = dirac.reconstruct(from_channels(res.x, (4, 3)).to(rhs.dtype), b)
    _, rel = true_residual(dirac, x, b)
    return InvertResult(x, res.iters, float(rel))


def invert_msrc(dirac: Dirac, bs: torch.Tensor, tol: float = 1e-10,
                maxiter: int = 1000) -> InvertResult:
    """Solve M x_i = b_i for a batch bs [n, 2,4,3,T,Z,W] with one
    multi-source CG on M_pc† M_pc (``solvers.msrc.msrc_cg``).

    Source preparation, the M_pc† of the right-hand side, the
    reconstruction and the true residual run source by source.  On the
    fused kernel chain the CG runs on float32 channels [n, T, 24, Z, W]
    and each matvec is the four-hop M_pc† M_pc chain of
    ``Dirac._fused_matpc_dagm_ch`` on the multi-source hop, i.e. four
    multi-source kernel launches (K2d in the bf16 tier), the dagger
    half's leading A⁻¹† the second output of the forward half's last
    hop.  ``true_res``
    is the worst source's |M x_i − b_i| / |b_i|.  A ``ShardedDirac``
    raises: the multi-source CG has no sharded form yet."""
    if isinstance(dirac, ShardedDirac):
        raise ValueError("invert_msrc has no sharded form: its reductions "
                         "would stay on this rank's slab")
    rhs = torch.stack([dirac.matpc(dirac.prepare(b), dagger=True)
                       for b in bs])
    if dirac._has_fused_matpc:
        def matvec_b(v_ch_b):
            return dirac._fused_matpc_dagm_ch(v_ch_b, hop=dslash_ch_msrc)

        rhs_ch = torch.stack([to_channels(r) for r in rhs]).to(torch.float32)
        res = msrc_cg(matvec_b, rhs_ch, tol=tol, maxiter=maxiter)
        x_p = torch.stack([from_channels(v, (4, 3)) for v in res.x]).to(
            rhs.dtype)
    else:
        res = msrc_cg(lambda v: torch.stack([dirac.matpc_dagm(a) for a in v]),
                      rhs, tol=tol, maxiter=maxiter)
        x_p = res.x
    del rhs
    x = torch.stack([dirac.reconstruct(a, b) for a, b in zip(x_p, bs)])
    worst = max(float(true_residual(dirac, a, b)[1]) for a, b in zip(x, bs))
    return InvertResult(x, res.iters, worst)


def true_residual(dirac: Dirac, x: torch.Tensor, b: torch.Tensor):
    """(r, |r|/|b|) of the full operator, |r|/|b| as a 0-d tensor; for a
    ``ShardedDirac`` r is this rank's slab and the norms the whole
    lattice's."""
    r = b - dirac.m(x)
    if isinstance(dirac, ShardedDirac):
        red = dirac.mesh.allreduce
        return r, torch.sqrt(red(norm2(r)) / red(norm2(b)))
    return r, torch.sqrt(norm2(r) / norm2(b))
