"""Adaptive aggregation multigrid, two to four levels: null-vector
setup, the V-cycle preconditioner and the MG-preconditioned outer
solves.

Setup (``setup_mg``): nvec null vectors, each a loose solve of M x = ξ
from a Gaussian source ξ; on the fused kernel chain they are solved in
batches through ``invert_msrc`` (the multi-source kernel), otherwise one
BiCGstab each.  Then block orthonormalisation (CholQR²) into the
transfer V, and the Galerkin coarse operator V†MV.

Three and four levels (``n_level``, at most the reference's
QUDA_MAX_MG_LEVEL = 4): ``setup_coarse_level`` repeats the aggregation
on the explicit coarse operator (BiCGstab null vectors on it, CholQR²
into a ``CoarseTransfer``, the coarse-of-coarse Galerkin build), for
level 2 and then level 3.

V-cycle (``MGPreconditioner.vcycle``): restrict the residual, GCR on
the coarse operator, prolong, then ``nu_post`` MR smoothing steps on the
full operator or, with ``smoother_pc``, on its even-odd Schur system.
With a level 2 the coarse GCR is preconditioned by a V-cycle of the
coarse operator (``_coarse_vcycle``), whose GCR on level 2 is in turn
preconditioned through level 3 when there is one (``_coarse2_vcycle``).

``vec_dtype="bf16"`` stores the level-1 V as a planar bf16 pair
(``transfer.Bf16Transfer``) once every coarse operator has been built
from the complex V.

``mg_solve``: "gcr-pc" runs GCR on the Schur system with the V-cycle
through the Schur embedding (the production path), "gcr" runs GCR on
the full operator, "mr-richardson" V-cycle steps with a minimal-residual
step length.  Every restart recomputes the true residual of its system
and reads it on the host once.

On a process grid the fine level runs on each rank's box through the
sharded operator, and the coarse levels are replicated:
``vcycle(mesh=…)`` gathers the coarse residual and every rank runs the
whole coarse solve.  ``setup_mg`` on a ``ShardedDirac`` sets the
preconditioner up on the boxes: the null vectors by the sharded solves
(``invert(mesh=…)`` a column on the fused chain, else
``bicgstab(allreduce=…)``) from sources drawn whole and sliced, the
block orthonormalisation on the rank's aggregates (the block's t, z
and y extents divide the box's), the level-1 Galerkin build on the box
with the fine hops' shifts across the box faces, and its X / Y
all-gathered by grid coordinates; levels 2–4 are then built from the
replicated level 1 alike on every rank.
``shard_mg`` cuts a preconditioner set up on the whole lattice
instead.  Either feeds ``mg_solve(mesh=…)``.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Optional

import torch

from quda_qkxtm_multigrid_tpu_torch.dirac import Dirac, make_dirac
from quda_qkxtm_multigrid_tpu_torch.invert import invert, invert_msrc
from quda_qkxtm_multigrid_tpu_torch.mg.coarse_op import (
    CoarseOperator, build_coarse_op_direct, build_coarse_op_direct_coarse,
    coarse_diag_hops, coarse_xy_direct)
from quda_qkxtm_multigrid_tpu_torch.mg.transfer import (
    Bf16Transfer, BlockGeometry, CoarseBlockGeometry, CoarseTransfer,
    Transfer, block_orthonormalize_coarse, block_orthonormalize_flat,
    slab_block_geometry, to_blocked_coarse, to_blocked_flat)
from quda_qkxtm_multigrid_tpu_torch.ops import dslash as _dsl
from quda_qkxtm_multigrid_tpu_torch.ops.blas import cDotProduct, norm2
from quda_qkxtm_multigrid_tpu_torch.parallel.mesh import box_slab
from quda_qkxtm_multigrid_tpu_torch.parallel.sharded import (
    ShardedDirac, make_sharded_dirac)
from quda_qkxtm_multigrid_tpu_torch.solvers.bicgstab import bicgstab
from quda_qkxtm_multigrid_tpu_torch.solvers.gcr import GCRResult, gcr_cycle
from quda_qkxtm_multigrid_tpu_torch.solvers.mr import mr
from quda_qkxtm_multigrid_tpu_torch.solvers.support import summed
from quda_qkxtm_multigrid_tpu_torch.utils import checkpoint as ckpt
from quda_qkxtm_multigrid_tpu_torch.utils import rng as _rng
from quda_qkxtm_multigrid_tpu_torch.utils.profiling import solve_telemetry

QUDA_MAX_MG_LEVEL = 4    # the reference's deepest hierarchy


@dataclasses.dataclass(frozen=True)
class MGParams:
    """Multigrid configuration (the analogue of QudaMultigridParam)."""

    block: tuple = (4, 4, 4, 4)       # (bx, by, bz, bt)
    nvec: int = 24
    setup_tol: float = 5e-6
    setup_maxiter: int = 500
    nu_pre: int = 0
    nu_post: int = 4                  # MR smoother steps
    omega: float = 0.85
    smoother_pc: bool = False         # MR on the even-odd Schur system
    outer_solver: str = "gcr"         # "gcr" | "gcr-pc" | "mr-richardson"
    coarse_nkrylov: int = 10          # coarse GCR cycle length
    n_level: int = 2                  # 2, 3 or 4
    # level 2 (n_level >= 3): aggregation of the level-1 coarse lattice,
    # its null vectors (BiCGstab on the coarse operator) and its GCR
    block2: tuple = (2, 2, 2, 2)
    nvec2: int = 24
    coarse2_nkrylov: int = 8
    setup2_tol: float = 1e-4
    setup2_maxiter: int = 200
    # level 3 (n_level = 4)
    block3: tuple = (2, 2, 2, 2)
    nvec3: int = 16
    coarse3_nkrylov: int = 8
    setup3_tol: float = 1e-4
    setup3_maxiter: int = 150
    # multiplicative rescalings of the operator the coarse level is built
    # from (*_coarse) and of the smoother's operator (*_pr)
    delta_mu_coarse: float = 1.0
    delta_kappa_coarse: float = 1.0
    delta_csw_coarse: float = 1.0
    delta_mu_pr: float = 1.0
    delta_kappa_pr: float = 1.0
    delta_csw_pr: float = 1.0
    # null-vector files: infile skips generation, outfile saves V
    vec_infile: str = ""
    vec_outfile: str = ""
    # storage of the level-1 V in the V-cycle: "f32" (complex) or "bf16"
    # (a planar bf16 pair; the coarse operators are built before the cast)
    vec_dtype: str = "f32"
    solve_operator: str = "canonical"

    def __post_init__(self):
        if self.n_level not in range(2, QUDA_MAX_MG_LEVEL + 1):
            raise ValueError(
                f"n_level={self.n_level}: 2 to QUDA_MAX_MG_LEVEL = "
                f"{QUDA_MAX_MG_LEVEL} levels")
        if self.vec_dtype not in ("f32", "bf16"):
            raise ValueError(f"vec_dtype={self.vec_dtype!r}: 'f32' or "
                             "'bf16'")
        if self.solve_operator != "canonical":
            raise ValueError(
                f"solve_operator={self.solve_operator!r}: the compact "
                "operator is a 16 GB-HBM squeeze, not ported on purpose "
                "(ROADMAP queue 1, 'Not ported on purpose')")
        if self.outer_solver not in ("gcr", "gcr-pc", "mr-richardson"):
            raise ValueError(f"unknown outer_solver {self.outer_solver!r}")


@dataclasses.dataclass
class MGPreconditioner:
    transfer: Transfer | Bf16Transfer
    coarse: CoarseOperator
    dirac: Dirac
    params: MGParams
    dirac_pr: Optional[Dirac] = None  # delta-scaled smoother operator
    # what setup_mg measured: host seconds of each part, the multi-source
    # CG iterations of each null-vector batch, the worst null-vector
    # solve's true residual; "level2" / "level3" those of the coarser
    # levels (null-vector seconds, BiCGstab iterations, build seconds)
    setup_stats: dict = dataclasses.field(default_factory=dict)
    transfer2: Optional[CoarseTransfer] = None    # n_level >= 3
    coarse2: Optional[CoarseOperator] = None
    transfer3: Optional[CoarseTransfer] = None    # n_level = 4
    coarse3: Optional[CoarseOperator] = None
    # the level-1 V-cycle's CUDA graphs, by (shape, dtype, device)
    _graphs: dict = dataclasses.field(default_factory=dict, init=False,
                                      repr=False, compare=False)

    @property
    def _dirac_smooth(self) -> Dirac:
        return self.dirac if self.dirac_pr is None else self.dirac_pr

    def _coarse2_vcycle(self, r2: torch.Tensor) -> torch.Tensor:
        """Level-2 V-cycle through level 3: GCR(coarse3_nkrylov) on the
        level-3 operator, prolong, then max(nu_post, 1) MR steps on the
        level-2 operator."""
        p = self.params
        m2 = self.coarse2.apply
        x3 = gcr_cycle(self.coarse3.apply, self.transfer3.restrict(r2),
                       n_krylov=p.coarse3_nkrylov)
        x2 = self.transfer3.prolong(x3)
        return x2 + mr(m2, r2 - m2(x2), niter=max(p.nu_post, 1),
                       omega=p.omega)

    def _coarse_vcycle(self, r1: torch.Tensor) -> torch.Tensor:
        """Level-1 V-cycle through level 2: nu_pre MR steps on the
        coarse operator, GCR(coarse2_nkrylov) on level 2 (preconditioned
        through level 3 when there is one), prolong, then
        max(nu_post, 1) MR steps."""
        p = self.params
        m1 = self.coarse.apply
        if p.nu_pre > 0:
            x1 = mr(m1, r1, niter=p.nu_pre, omega=p.omega)
            rr = r1 - m1(x1)
        else:
            x1, rr = torch.zeros_like(r1), r1
        precond2 = self._coarse2_vcycle if self.transfer3 is not None \
            else None
        x2 = gcr_cycle(self.coarse2.apply, self.transfer2.restrict(rr),
                       n_krylov=p.coarse2_nkrylov, precond=precond2)
        x1 = x1 + self.transfer2.prolong(x2)
        return x1 + mr(m1, r1 - m1(x1), niter=max(p.nu_post, 1),
                       omega=p.omega)

    def coarse_solve(self, rc: torch.Tensor) -> torch.Tensor:
        """One GCR(coarse_nkrylov) cycle on the coarse operator,
        preconditioned by the level-1 V-cycle when there is a level 2
        (on the card, replayed from a CUDA graph: ``_graphed``)."""
        precond = None
        if self.transfer2 is not None:
            precond = (self._coarse_vcycle if rc.device.type != "cuda"
                       else self._graphed(self._coarse_vcycle, rc))
        return gcr_cycle(self.coarse.apply, rc,
                         n_krylov=self.params.coarse_nkrylov,
                         precond=precond)

    def _graphed(self, fn, like: torch.Tensor):
        """``fn`` (one CUDA tensor in, one out, no host read) as the
        replay of a CUDA graph captured at the first call for tensors
        like ``like``.  The levels below the first are small enough that
        launching their thousands of kernels one by one from Python costs
        several times their device time; a replay launches them all at
        once, the same kernels on the same operands.  Each call copies
        its argument into the graph's input and returns a copy of its
        output.  The graph holds this preconditioner's coarse operators
        and transfers: they are not to change after the first call."""
        key = (tuple(like.shape), like.dtype, like.device)
        if key not in self._graphs:
            self._graphs[key] = _cuda_graphed(fn, like)
        return self._graphs[key]

    def _smooth(self, r: torch.Tensor, niter: int,
                allreduce=None) -> torch.Tensor:
        """``niter`` MR steps on M x = r, on the full operator or (with
        ``smoother_pc``) on the Schur system via prepare/reconstruct;
        ``allreduce`` sums MR's reductions over the grid of a sharded
        operator."""
        p = self.params
        d = self._dirac_smooth
        if not p.smoother_pc:
            return mr(d.m, r, niter=niter, omega=p.omega,
                      allreduce=allreduce)
        x_p = mr(d.matpc, d.prepare(r), niter=niter, omega=p.omega,
                 allreduce=allreduce)
        return d.reconstruct(x_p, r)

    def vcycle(self, r: torch.Tensor, mesh=None) -> torch.Tensor:
        """One V(nu_pre, nu_post) cycle approximating M⁻¹ r on the full
        field [2,4,3,T,Z,W].

        ``mesh``: ``r`` is this rank's box of a field on that grid and
        the preconditioner a sharded one (``setup_mg`` on a
        ``ShardedDirac``, or ``shard_mg``'s), with the coarse levels
        replicated (the JAX package's ``vcycle_resharded``): smooth on the
        box through the sharded operator (MR's reductions summed over
        the grid), restrict to the rank's aggregates, gather the coarse
        residual of every rank by its grid coordinates
        (``LatticeMesh.allgather_box`` on the coarse t, z and y axes),
        run the whole coarse solve on every rank with no further
        communication, and prolong the rank's coarse rows.  The gathered
        residual is the same bytes on every rank, so the coarse solves
        agree to the bit and the prolonged corrections meet at the box
        faces; the gather stays outside the CUDA graph of the coarse
        levels (``_graphed``)."""
        p = self.params
        m = self.dirac.m
        red = None if mesh is None else mesh.allreduce
        x = torch.zeros_like(r)
        if p.nu_pre > 0:
            x = self._smooth(r, p.nu_pre, red)
        rr = r - m(x) if p.nu_pre > 0 else r
        rc = self.transfer.restrict(rr)
        if mesh is None:
            xc = self.coarse_solve(rc)
        else:
            rc = mesh.allgather_box(rc, (2, 3, 4))
            xc = self.coarse_solve(rc)
            for axis in range(3):
                xc = xc.narrow(axis + 2, *mesh.box_range(
                    axis, rc.shape[axis + 2]))
        x = x + self.transfer.prolong(xc)
        if p.nu_post > 0:
            x = x + self._smooth(r - m(x), p.nu_post, red)
        return x


def _cuda_graphed(fn, like: torch.Tensor):
    """``fn`` captured into a CUDA graph on an input buffer of ``like``'s
    shape and dtype, after one warm-up call on a side stream (cuBLAS
    handles and workspaces are made there, not in the capture)."""
    static_in = like.clone()
    dev = like.device
    side = torch.cuda.Stream(device=dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        fn(static_in)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static_out = fn(static_in)

    def replay(x: torch.Tensor) -> torch.Tensor:
        static_in.copy_(x)
        graph.replay()
        return static_out.clone()
    return replay


def _mesh(dirac: Dirac):
    """The ring of a sharded operator, None for a whole-lattice one."""
    return dirac.mesh if isinstance(dirac, ShardedDirac) else None


def _level1_terms(dirac: Dirac):
    """(diagonal term, 8 hop terms with their −κ) of the fine operator on
    full fields, for the coarse build; on a sharded operator's box the
    t hops read the neighbours' planes."""
    geom, kappa, mesh = dirac.geom, dirac.params.kappa, _mesh(dirac)

    def diag_apply(psi):
        return torch.stack([dirac.a_apply(psi[0], 0),
                            dirac.a_apply(psi[1], 1)])

    hop_terms = [
        (lambda psi, mu=mu, sign=sign:
         -kappa * _dsl.hop_apply(dirac.u, psi, mu, sign, geom, mesh))
        for mu in range(4) for sign in (+1, -1)]
    return diag_apply, hop_terms


def _build_level1(transfer: Transfer, dirac: Dirac) -> CoarseOperator:
    """The Galerkin operator V†MV.  On a sharded operator (``transfer``
    the rank's aggregates): the box's rows of X and Y, whose links
    across a box face see the neighbour's fine rows, then all-gathered
    by grid coordinates, the whole coarse operator on every rank."""
    diag_apply, hop_terms = _level1_terms(dirac)
    mesh = _mesh(dirac)
    if mesh is None:
        return build_coarse_op_direct(transfer, diag_apply, hop_terms,
                                      dtype=dirac.u.dtype)
    x, y = coarse_xy_direct(transfer, diag_apply, hop_terms,
                            dtype=dirac.u.dtype)
    bl = transfer.bg
    bg = BlockGeometry(dirac.global_geom, bl.bx, bl.by, bl.bz, bl.bt,
                       bl.nvec)
    cs = bl.coarse_shape
    x = mesh.allgather_box(x.unflatten(0, cs), (0, 1, 2)).flatten(0, 3)
    y = mesh.allgather_box(y.unflatten(1, cs), (1, 2, 3)).flatten(1, 4)
    return CoarseOperator(x=x, y=y, bg=bg)


def _sync(t: torch.Tensor):
    """Wait for the device, so that a host clock around the work reads
    its time."""
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def generate_null_vectors(dirac: Dirac, bg: BlockGeometry,
                          gen: torch.Generator, params: MGParams,
                          batch: int = 8,
                          stats: Optional[dict] = None) -> torch.Tensor:
    """Near-kernel vectors — loose solves of M x = ξ to ``setup_tol`` on
    Gaussian sources ξ — block-orthonormalised (CholQR²) into V
    [2, Tc,Zc,Yc,Xc, nvec, bdof].

    On the fused kernel chain the solves run ``batch`` at a time through
    ``invert_msrc`` and the multi-source kernel; each solved batch goes
    straight into the blocked accumulator, so one batch at a time is
    alive beside it.  Otherwise each is one BiCGstab on M.  ``stats``,
    if given, receives the host seconds of the solves and of the
    orthonormalisation, the solver iterations of each batch
    (``msrc_iters``, or ``bicgstab_iters`` per vector) and, for the
    multi-source path, the worst solve's true residual.

    On a ``ShardedDirac`` (``bg`` the box's blocking): the sources are
    drawn whole, as the unsharded setup draws them, and sliced at once;
    on the sharded fused chain each column is one ``invert(mesh=…)``
    "cg" (the normal equations' CG of a column of ``invert_msrc``;
    ``cg_iters`` a column and the worst true residual), otherwise one
    ``bicgstab(allreduce=…)``.  V holds the rank's aggregates."""
    geom = dirac.geom
    dtype = dirac.u.dtype
    mesh = _mesh(dirac)
    if mesh is None:
        whole, fused = geom, dirac._has_fused_matpc
    else:
        whole, fused = dirac.global_geom, dirac.has_sharded_chain

    def sliced(b):
        return b if mesh is None else box_slab(b, mesh)

    t0 = time.perf_counter()
    flat = torch.empty((bg.nvec, 2) + tuple(bg.coarse_shape) + (bg.bdof,),
                       dtype=dtype, device=dirac.u.device)
    iters, worst = [], 0.0
    if fused:
        for i0 in range(0, bg.nvec, batch):
            nb = min(batch, bg.nvec - i0)
            bs = sliced(_rng.random_spinor(gen, whole, dtype,
                                           batch_shape=(nb,)))
            if mesh is None:
                res = invert_msrc(dirac, bs, tol=params.setup_tol,
                                  maxiter=params.setup_maxiter)
                del bs
                flat[i0:i0 + nb] = to_blocked_flat(res.x, bg)
                iters.append(res.iters)
                worst = max(worst, res.true_res)
                continue
            for i, b in enumerate(bs):
                res = invert(dirac, b, tol=params.setup_tol,
                             maxiter=params.setup_maxiter, mesh=mesh)
                flat[i0 + i] = to_blocked_flat(res.x, bg)
                iters.append(res.iters)
                worst = max(worst, res.true_res)
            del bs
    else:
        red = None if mesh is None else mesh.allreduce
        for i in range(bg.nvec):
            b = sliced(_rng.random_spinor(gen, whole, dtype))
            res = bicgstab(dirac.m, b, tol=params.setup_tol,
                           maxiter=params.setup_maxiter, allreduce=red)
            flat[i] = to_blocked_flat(res.x, bg)
            iters.append(res.iters)
    _sync(flat)
    t1 = time.perf_counter()
    v = block_orthonormalize_flat(flat)
    del flat
    _sync(v)
    if stats is not None:
        stats["null_vector_secs"] = t1 - t0
        stats["ortho_secs"] = time.perf_counter() - t1
        if fused:
            stats["msrc_iters" if mesh is None else "cg_iters"] = iters
            stats["null_true_res"] = worst
        else:
            stats["bicgstab_iters"] = iters
    return v


def _delta_scaled(dirac: Dirac, dmu: float, dkappa: float,
                  dcsw: float) -> Dirac:
    """The operator with (mu, kappa, csw) rescaled, clover term rebuilt
    (on a sharded operator's box, from its box of the links)."""
    if dmu == 1.0 and dkappa == 1.0 and dcsw == 1.0:
        return dirac
    p = dirac.params
    newp = dataclasses.replace(p, mu=p.mu * dmu, kappa=p.kappa * dkappa,
                               csw=p.csw * dcsw)
    if isinstance(dirac, ShardedDirac):
        return make_sharded_dirac(dirac.u, newp, dirac.global_geom,
                                  dirac.mesh, antiperiodic=dirac.antiperiodic)
    return make_dirac(dirac.u, newp, dirac.geom)


def _null_vectors_for(dirac: Dirac, bg: BlockGeometry, gen, params: MGParams,
                      stats: dict) -> torch.Tensor:
    """V from ``vec_infile`` if set (generation skipped), else generated
    and orthonormalised; saved to ``vec_outfile`` if set.  The file
    holds the complex V [2, Tc,Zc,Yc,Xc, nvec, bdof], the JAX package's
    format.  A sharded operator takes neither file: it holds only its
    rank's rows of V."""
    if (params.vec_infile or params.vec_outfile) and _mesh(dirac):
        raise ValueError("vec_infile / vec_outfile hold the whole lattice's "
                         "V: set up on the whole lattice and shard_mg it")
    if params.vec_infile:
        a = ckpt.load_null_vectors(params.vec_infile)
        want = (2,) + tuple(bg.coarse_shape) + (bg.nvec, bg.bdof)
        if a.shape != want:
            raise ValueError(f"{params.vec_infile}: V shape {a.shape} != "
                             f"{want}")
        return torch.tensor(a, dtype=dirac.u.dtype, device=dirac.u.device)
    v = generate_null_vectors(dirac, bg, gen, params, stats=stats)
    if params.vec_outfile:
        ckpt.save_null_vectors(params.vec_outfile,
                               v.detach().cpu().numpy())
    return v


def _preconditioner(transfer: Transfer, dirac: Dirac, params: MGParams,
                    stats: dict) -> MGPreconditioner:
    """The preconditioner of ``dirac`` on the null vectors of
    ``transfer``: the coarse operator built (and timed into ``stats``)
    from the delta-scaled operator, and the smoother's operator."""
    d_coarse = _delta_scaled(dirac, params.delta_mu_coarse,
                             params.delta_kappa_coarse,
                             params.delta_csw_coarse)
    t0 = time.perf_counter()
    coarse = _build_level1(transfer, d_coarse)
    _sync(coarse.y)
    stats["coarse_build_secs"] = time.perf_counter() - t0
    dirac_pr = _delta_scaled(dirac, params.delta_mu_pr,
                             params.delta_kappa_pr, params.delta_csw_pr)
    return MGPreconditioner(transfer=transfer, coarse=coarse, dirac=dirac,
                            params=params,
                            dirac_pr=None if dirac_pr is dirac else dirac_pr,
                            setup_stats=stats)


def _coarse_null_solve(coarse: CoarseOperator, b: torch.Tensor, tol: float,
                       maxiter: int):
    """A level-2 (or level-3) null vector: BiCGstab on the coarse
    operator from the source ``b``."""
    return bicgstab(coarse.apply, b, tol=tol, maxiter=maxiter)


def _random_coarse(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    """A complex Gaussian coarse field of ``shape`` from ``gen``."""
    return _rng.normal_complex(gen, shape, dtype)


def _build_level2(transfer2: CoarseTransfer,
                  coarse: CoarseOperator) -> CoarseOperator:
    """The Galerkin operator V2† D_c V2 of the next level down."""
    diag2, hops2 = coarse_diag_hops(coarse)
    return build_coarse_op_direct_coarse(transfer2, diag2, hops2,
                                         coarse.x.dtype)


def setup_coarse_level(coarse: CoarseOperator, params: MGParams,
                       gen: torch.Generator, block=None, nvec=None,
                       tol=None, maxiter=None,
                       stats: Optional[dict] = None) -> tuple:
    """The next level below ``coarse`` (any level): ``nvec`` null
    vectors, each a BiCGstab solve of D_c x = ξ to ``tol`` from a complex
    Gaussian ξ drawn from ``gen``, block-orthonormalised over
    ``block`` aggregates into a ``CoarseTransfer``, and its Galerkin
    operator.  ``block``, ``nvec``, ``tol`` and ``maxiter`` default to
    the level-2 fields of ``params``.  ``stats``, if given, receives the
    host seconds of the null vectors with their orthonormalisation and
    of the build, and the BiCGstab iterations of each vector.  Returns
    (transfer2, coarse2)."""
    block = params.block2 if block is None else block
    nvec = params.nvec2 if nvec is None else nvec
    tol = params.setup2_tol if tol is None else tol
    maxiter = params.setup2_maxiter if maxiter is None else maxiter
    bg1 = coarse.bg
    bx, by, bz, bt = block
    bg2 = CoarseBlockGeometry(fine_shape=tuple(bg1.coarse_shape), fine_ns=2,
                              fine_nc=bg1.nvec, bx=bx, by=by, bz=bz, bt=bt,
                              nvec=nvec)
    dtype = coarse.x.dtype
    fshape = (2, bg1.nvec) + tuple(bg1.coarse_shape)
    t0 = time.perf_counter()
    blk = torch.empty((nvec,) + tuple(bg2.coarse_shape)
                      + (bg2.block_volume, 2, bg1.nvec), dtype=dtype,
                      device=coarse.x.device)
    iters = []
    for i in range(nvec):
        res = _coarse_null_solve(coarse, _random_coarse(gen, fshape, dtype),
                                 tol, maxiter)
        blk[i] = to_blocked_coarse(res.x, bg2)
        iters.append(res.iters)
    transfer2 = CoarseTransfer(v=block_orthonormalize_coarse(blk), bg=bg2)
    del blk
    _sync(transfer2.v)
    t1 = time.perf_counter()
    coarse2 = _build_level2(transfer2, coarse)
    _sync(coarse2.y)
    if stats is not None:
        stats.update(null_vector_secs=t1 - t0, bicgstab_iters=iters,
                     build_secs=time.perf_counter() - t1)
    return transfer2, coarse2


def _add_coarse_levels(mg: MGPreconditioner, gen: torch.Generator):
    """Level 2 (n_level ≥ 3) and level 3 (n_level = 4) of ``mg``, their
    sources drawn from ``gen`` in that order; the timings go to
    ``mg.setup_stats["level2"]`` / ``["level3"]``."""
    p = mg.params
    if p.n_level < 3:
        return
    if gen is None:
        raise ValueError(f"n_level={p.n_level} draws the coarse levels' "
                         "null-vector sources from gen; gen is None")
    st = mg.setup_stats
    mg.transfer2, mg.coarse2 = setup_coarse_level(
        mg.coarse, p, gen, stats=st.setdefault("level2", {}))
    if p.n_level >= 4:
        mg.transfer3, mg.coarse3 = setup_coarse_level(
            mg.coarse2, p, gen, block=p.block3, nvec=p.nvec3,
            tol=p.setup3_tol, maxiter=p.setup3_maxiter,
            stats=st.setdefault("level3", {}))


def _vec_storage_cast(transfer: Transfer,
                      params: MGParams) -> Transfer | Bf16Transfer:
    """The level-1 transfer in the storage of ``params.vec_dtype``: as it
    is for "f32", the planar bf16 pair for "bf16" (the caller drops the
    complex V, which every coarse build has read by then)."""
    if params.vec_dtype != "bf16":
        return transfer
    out = Bf16Transfer.from_transfer(transfer)
    _sync(out.vr)
    return out


def _fine_blocking(dirac: Dirac, params: MGParams) -> BlockGeometry:
    """The blocking of the fine lattice, or of the box of a sharded
    operator (whose T_loc the block's t extent must divide)."""
    mesh = _mesh(dirac)
    whole = dirac.geom if mesh is None else dirac.global_geom
    bg = BlockGeometry(whole, *params.block, nvec=params.nvec)
    return bg if mesh is None else slab_block_geometry(bg, mesh)[0]


def setup_mg(dirac: Dirac, params: MGParams, gen: torch.Generator,
             null_vectors=None) -> MGPreconditioner:
    """Build the MG preconditioner of ``params.n_level`` levels.  ``gen``
    draws the setup sources (a ``torch.Generator`` on the operator's
    device): the fine null vectors, then level 2's and level 3's;
    ``null_vectors`` (a sequence of nvec fields [2,4,3,T,Z,W]) skips the
    fine generation and is orthonormalised as given.  With
    ``vec_dtype="bf16"`` the level-1 V is cast after every build.

    A ``ShardedDirac`` sets up on the boxes of its ring (module
    docstring; ``gen`` in the same state on every rank, ``null_vectors``
    the rank's boxes): the result is what ``shard_mg`` makes of the
    whole lattice's setup, for ``mg_solve(mesh=…)``, and no rank holds
    a fine field of the whole lattice."""
    bg = _fine_blocking(dirac, params)
    stats = {}
    if null_vectors is None:
        v = _null_vectors_for(dirac, bg, gen, params, stats)
    else:
        v = block_orthonormalize_flat(torch.stack(
            [to_blocked_flat(x, bg) for x in null_vectors]))
    mg = _preconditioner(Transfer(v=v, bg=bg), dirac, params, stats)
    del v
    _add_coarse_levels(mg, gen)
    mg.transfer = _vec_storage_cast(mg.transfer, params)
    return mg


def setup_mg_pair(dirac_up: Dirac, dirac_dn: Dirac, params: MGParams,
                  gen: torch.Generator) -> tuple:
    """The two MG preconditioners of a twisted-mass workflow, one per
    twist sign, sharing one set of null vectors (generated on
    ``dirac_up``): the JAX package's ``setup_mg_pair`` (the reference's
    preconditionerUP / DN).  The coarse operator is built for each
    flavour, which carries its twist sign to the coarse level, and so
    are levels 2 and 3: each flavour draws their sources from a
    generator in the state ``gen`` had after the fine null vectors, so
    both solve the same sources against their own coarse operators (JAX
    hands both the same key).  With ``vec_dtype="bf16"`` the one shared
    V is cast after both flavours' builds.  Each preconditioner's
    ``setup_stats`` holds the shared null-vector seconds and its own
    build seconds.  Two ``ShardedDirac`` set up on their boxes, as
    ``setup_mg`` does."""
    bg = _fine_blocking(dirac_up, params)
    shared = {}
    transfer = Transfer(v=_null_vectors_for(dirac_up, bg, gen, params,
                                            shared), bg=bg)
    state = (gen.get_state() if gen is not None and params.n_level >= 3
             else None)
    mgs = []
    for d in (dirac_up, dirac_dn):
        mg = _preconditioner(transfer, d, params, dict(shared))
        g = None
        if state is not None:
            g = torch.Generator(device=gen.device)
            g.set_state(state)
        _add_coarse_levels(mg, g)
        mgs.append(mg)
    cast = _vec_storage_cast(transfer, params)
    del transfer
    for mg in mgs:
        mg.transfer = cast
    return tuple(mgs)


def shard_mg(mg: MGPreconditioner, mesh) -> MGPreconditioner:
    """This rank's part of a preconditioner set up on the whole lattice,
    for ``mg_solve(mesh=…)``: the operator's box
    (``parallel.sharded.shard_dirac``), that of the δ-scaled smoother
    operator, the transfer's aggregates on the box (``t_slab``), and the
    coarse levels whole, replicated on every rank.  The block's t extent
    must divide T_loc.  ``setup_mg`` on a ``ShardedDirac`` gives the same
    without a whole-lattice operator."""
    from quda_qkxtm_multigrid_tpu_torch.parallel.sharded import shard_dirac
    return dataclasses.replace(
        mg, dirac=shard_dirac(mg.dirac, mesh),
        dirac_pr=None if mg.dirac_pr is None else shard_dirac(mg.dirac_pr,
                                                              mesh),
        transfer=mg.transfer.t_slab(mesh))


def mg_solve(mg: MGPreconditioner, b: torch.Tensor, tol: float = 1e-8,
             n_krylov: int = 10, max_restarts: int = 50,
             solver: Optional[str] = None, telemetry: bool = False,
             mesh=None):
    """MG-preconditioned outer solve of M x = b.

    "gcr-pc": restarted GCR(n_krylov) on the even-odd Schur system
    M_pc x_p = prepare(b), preconditioned by the full-operator V-cycle
    through the Schur embedding: M_sym x = r ⇔ M_asym x = A_p r, and the
    full system with right-hand side (A_p r on parity p, 0 on the other)
    prepares to exactly that, so K(r) = [V-cycle((A_p r, 0))]_p.
    Convergence is tested on the Schur residual; x is reconstructed and
    ``r2`` is the full system's |b − M x|².
    "gcr": restarted GCR(n_krylov) on M x = b with the V-cycle.
    "mr-richardson": x += ω z, z = V-cycle(r), ω = <Mz, r>/|Mz|².
    ``iters`` counts n_krylov per GCR cycle, 1 per Richardson step.

    ``mesh``: the sharded solve on that grid (the JAX package's
    ``mg_solve(mesh=…)``): ``mg`` a sharded preconditioner, ``b`` and the
    returned x this rank's box; the V-cycle is ``vcycle(mesh=…)``,
    every reduction of the outer solve is summed over the grid, and
    ``r2`` is the whole lattice's.

    ``telemetry=True`` returns ``(result, utils.profiling.SolveTelemetry)``
    timed on the host clock from before ``prepare`` to after the last
    residual, the device synchronised at both ends."""
    if solver is None:
        solver = mg.params.outer_solver
    d = mg.dirac
    if getattr(d, "mesh", None) is not mesh:
        raise ValueError("a sharded solve needs both a preconditioner on "
                         "that mesh (setup_mg on its ShardedDirac, or "
                         "shard_mg(mg, mesh)) and mg_solve(mesh=mesh)")
    _sync(b)
    t0 = time.perf_counter()
    res = _mg_outer(mg, d, b, tol, n_krylov, max_restarts, solver, mesh)
    if not telemetry:
        return res
    _sync(res.x)
    return res, solve_telemetry(d, res.iters, time.perf_counter() - t0)


def _mg_outer(mg: MGPreconditioner, d: Dirac, b: torch.Tensor, tol: float,
              n_krylov: int, max_restarts: int, solver: str,
              mesh=None) -> GCRResult:
    """The outer solve of ``mg_solve``."""
    if mesh is None:
        allreduce, vcycle = None, mg.vcycle
        red = lambda v: v       # noqa: E731
    else:
        allreduce = red = mesh.allreduce
        vcycle = functools.partial(mg.vcycle, mesh=mesh)
    if solver == "gcr-pc":
        pr = d.params.matpc_parity
        src = d.prepare(b)
        x_p = torch.zeros_like(src)
        r_p = src - d.matpc(x_p)
        r2 = red(norm2(r_p))
        b2 = float(r2)

        def precond(rp):
            full = torch.zeros((2,) + tuple(rp.shape), dtype=rp.dtype,
                               device=rp.device)
            full[pr] = d.a_apply(rp, pr)
            return vcycle(full)[pr]

        iters = 0
        for _ in range(max_restarts):
            if float(r2) <= tol * tol * b2:
                break
            x_p = x_p + gcr_cycle(d.matpc, r_p, n_krylov=n_krylov,
                                  precond=precond, allreduce=allreduce)
            iters += n_krylov
            r_p = src - d.matpc(x_p)
            r2 = red(norm2(r_p))
        x = d.reconstruct(x_p, b)
        return GCRResult(x, iters, red(norm2(b - d.m(x))))

    x = torch.zeros_like(b)
    r = b - d.m(x)
    r2 = red(norm2(r))
    b2 = float(r2)
    iters = 0
    if solver == "mr-richardson":
        for _ in range(max_restarts * n_krylov):
            if float(r2) <= tol * tol * b2:
                break
            z = vcycle(r)
            w = d.m(z)
            denom, num = summed(allreduce, norm2(w), cDotProduct(w, r))
            omega = torch.where(
                denom > 0, num / denom,
                torch.zeros((), dtype=r.dtype, device=r.device))
            x = x + omega * z
            iters += 1
            r = b - d.m(x)
            r2 = red(norm2(r))
    elif solver == "gcr":
        for _ in range(max_restarts):
            if float(r2) <= tol * tol * b2:
                break
            x = x + gcr_cycle(d.m, r, n_krylov=n_krylov, precond=vcycle,
                              allreduce=allreduce)
            iters += n_krylov
            r = b - d.m(x)
            r2 = red(norm2(r))
    else:
        raise ValueError(f"unknown mg_solve solver {solver!r}")
    return GCRResult(x, iters, r2)
