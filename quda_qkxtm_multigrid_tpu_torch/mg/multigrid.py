"""Adaptive aggregation multigrid, two levels: null-vector setup, the
V-cycle preconditioner and the MG-preconditioned outer solves.

Setup (``setup_mg``): nvec null vectors, each a loose solve of M x = ξ
from a Gaussian source ξ; on the fused kernel chain they are solved in
batches through ``invert_msrc`` (the multi-source kernel), otherwise one
BiCGstab each.  Then block orthonormalisation (CholQR²) into the
transfer V, and the Galerkin coarse operator V†MV.

V-cycle (``MGPreconditioner.vcycle``): restrict the residual, GCR on
the coarse operator, prolong, then ``nu_post`` MR smoothing steps on the
full operator or, with ``smoother_pc``, on its even-odd Schur system.

``mg_solve``: "gcr-pc" runs GCR on the Schur system with the V-cycle
through the Schur embedding (the production path), "gcr" runs GCR on
the full operator, "mr-richardson" V-cycle steps with a minimal-residual
step length.  Every restart recomputes the true residual of its system
and reads it on the host once.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from quda_qkxtm_multigrid_tpu_torch.dirac import Dirac, make_dirac
from quda_qkxtm_multigrid_tpu_torch.invert import invert_msrc
from quda_qkxtm_multigrid_tpu_torch.mg.coarse_op import (
    CoarseOperator, build_coarse_op_direct)
from quda_qkxtm_multigrid_tpu_torch.mg.transfer import (
    BlockGeometry, Transfer, block_orthonormalize_flat, to_blocked_flat)
from quda_qkxtm_multigrid_tpu_torch.ops import dslash as _dsl
from quda_qkxtm_multigrid_tpu_torch.ops.blas import cDotProduct, norm2
from quda_qkxtm_multigrid_tpu_torch.solvers.bicgstab import bicgstab
from quda_qkxtm_multigrid_tpu_torch.solvers.gcr import GCRResult, gcr_cycle
from quda_qkxtm_multigrid_tpu_torch.solvers.mr import mr
from quda_qkxtm_multigrid_tpu_torch.utils import checkpoint as ckpt
from quda_qkxtm_multigrid_tpu_torch.utils import rng as _rng


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
    n_level: int = 2
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
    vec_dtype: str = "f32"
    solve_operator: str = "canonical"

    def __post_init__(self):
        if self.n_level != 2:
            raise ValueError(
                f"n_level={self.n_level}: only two-level MG is ported; three "
                "and four levels (setup_coarse_level, CoarseTransfer) are "
                "the three- and four-level MG item of ROADMAP queue 1 "
                "('MG, the rest')")
        if self.vec_dtype != "f32":
            raise ValueError(
                f"vec_dtype={self.vec_dtype!r}: the bf16 null-vector tier is "
                "the bf16 null-vector item of ROADMAP queue 1 ('MG, the "
                "rest')")
        if self.solve_operator != "canonical":
            raise ValueError(
                f"solve_operator={self.solve_operator!r}: the compact "
                "operator is a 16 GB-HBM squeeze, not ported on purpose "
                "(ROADMAP queue 1, 'Not ported on purpose')")
        if self.outer_solver not in ("gcr", "gcr-pc", "mr-richardson"):
            raise ValueError(f"unknown outer_solver {self.outer_solver!r}")


@dataclasses.dataclass
class MGPreconditioner:
    transfer: Transfer
    coarse: CoarseOperator
    dirac: Dirac
    params: MGParams
    dirac_pr: Optional[Dirac] = None  # delta-scaled smoother operator
    # what setup_mg measured: host seconds of each part, the multi-source
    # CG iterations of each null-vector batch, the worst null-vector
    # solve's true residual
    setup_stats: dict = dataclasses.field(default_factory=dict)

    @property
    def _dirac_smooth(self) -> Dirac:
        return self.dirac if self.dirac_pr is None else self.dirac_pr

    def coarse_solve(self, rc: torch.Tensor) -> torch.Tensor:
        """One GCR(coarse_nkrylov) cycle on the coarse operator."""
        return gcr_cycle(self.coarse.apply, rc,
                         n_krylov=self.params.coarse_nkrylov)

    def _smooth(self, r: torch.Tensor, niter: int) -> torch.Tensor:
        """``niter`` MR steps on M x = r, on the full operator or (with
        ``smoother_pc``) on the Schur system via prepare/reconstruct."""
        p = self.params
        d = self._dirac_smooth
        if not p.smoother_pc:
            return mr(d.m, r, niter=niter, omega=p.omega)
        x_p = mr(d.matpc, d.prepare(r), niter=niter, omega=p.omega)
        return d.reconstruct(x_p, r)

    def vcycle(self, r: torch.Tensor) -> torch.Tensor:
        """One V(nu_pre, nu_post) cycle approximating M⁻¹ r on the full
        field [2,4,3,T,Z,W]."""
        p = self.params
        m = self.dirac.m
        x = torch.zeros_like(r)
        if p.nu_pre > 0:
            x = self._smooth(r, p.nu_pre)
        rr = r - m(x) if p.nu_pre > 0 else r
        x = x + self.transfer.prolong(
            self.coarse_solve(self.transfer.restrict(rr)))
        if p.nu_post > 0:
            x = x + self._smooth(r - m(x), p.nu_post)
        return x


def _level1_terms(dirac: Dirac):
    """(diagonal term, 8 hop terms with their −κ) of the fine operator on
    full fields, for the coarse build."""
    geom, kappa = dirac.geom, dirac.params.kappa

    def diag_apply(psi):
        return torch.stack([dirac.a_apply(psi[0], 0),
                            dirac.a_apply(psi[1], 1)])

    hop_terms = [
        (lambda psi, mu=mu, sign=sign:
         -kappa * _dsl.hop_apply(dirac.u, psi, mu, sign, geom))
        for mu in range(4) for sign in (+1, -1)]
    return diag_apply, hop_terms


def _build_level1(transfer: Transfer, dirac: Dirac) -> CoarseOperator:
    diag_apply, hop_terms = _level1_terms(dirac)
    return build_coarse_op_direct(transfer, diag_apply, hop_terms,
                                  dtype=dirac.u.dtype)


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
    multi-source path, the worst solve's true residual."""
    geom = dirac.geom
    dtype = dirac.u.dtype
    fused = dirac._has_fused_matpc
    t0 = time.perf_counter()
    flat = torch.empty((bg.nvec, 2) + tuple(bg.coarse_shape) + (bg.bdof,),
                       dtype=dtype, device=dirac.u.device)
    iters, worst = [], 0.0
    if fused:
        for i0 in range(0, bg.nvec, batch):
            nb = min(batch, bg.nvec - i0)
            bs = _rng.random_spinor(gen, geom, dtype, batch_shape=(nb,))
            res = invert_msrc(dirac, bs, tol=params.setup_tol,
                              maxiter=params.setup_maxiter)
            del bs
            flat[i0:i0 + nb] = to_blocked_flat(res.x, bg)
            iters.append(res.iters)
            worst = max(worst, res.true_res)
    else:
        for i in range(bg.nvec):
            b = _rng.random_spinor(gen, geom, dtype)
            res = bicgstab(dirac.m, b, tol=params.setup_tol,
                           maxiter=params.setup_maxiter)
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
            stats["msrc_iters"] = iters
            stats["null_true_res"] = worst
        else:
            stats["bicgstab_iters"] = iters
    return v


def _delta_scaled(dirac: Dirac, dmu: float, dkappa: float,
                  dcsw: float) -> Dirac:
    """The operator with (mu, kappa, csw) rescaled, clover term rebuilt."""
    if dmu == 1.0 and dkappa == 1.0 and dcsw == 1.0:
        return dirac
    p = dirac.params
    newp = dataclasses.replace(p, mu=p.mu * dmu, kappa=p.kappa * dkappa,
                               csw=p.csw * dcsw)
    return make_dirac(dirac.u, newp, dirac.geom)


def _null_vectors_for(dirac: Dirac, bg: BlockGeometry, gen, params: MGParams,
                      stats: dict) -> torch.Tensor:
    """V from ``vec_infile`` if set (generation skipped), else generated
    and orthonormalised; saved to ``vec_outfile`` if set.  The file
    holds the complex V [2, Tc,Zc,Yc,Xc, nvec, bdof], the JAX package's
    format."""
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


def setup_mg(dirac: Dirac, params: MGParams, gen: torch.Generator,
             null_vectors=None) -> MGPreconditioner:
    """Build the two-level MG preconditioner.  ``gen`` draws the setup
    sources (a ``torch.Generator`` on the operator's device);
    ``null_vectors`` (a sequence of nvec fields [2,4,3,T,Z,W]) skips
    the generation and is orthonormalised as given."""
    bx, by, bz, bt = params.block
    bg = BlockGeometry(dirac.geom, bx, by, bz, bt, params.nvec)
    stats = {}
    if null_vectors is None:
        v = _null_vectors_for(dirac, bg, gen, params, stats)
    else:
        v = block_orthonormalize_flat(torch.stack(
            [to_blocked_flat(x, bg) for x in null_vectors]))
    return _preconditioner(Transfer(v=v, bg=bg), dirac, params, stats)


def setup_mg_pair(dirac_up: Dirac, dirac_dn: Dirac, params: MGParams,
                  gen: torch.Generator) -> tuple:
    """The two MG preconditioners of a twisted-mass workflow, one per
    twist sign, sharing one set of null vectors (generated on
    ``dirac_up``): the JAX package's ``setup_mg_pair`` (the reference's
    preconditionerUP / DN).  The coarse operator is built for each
    flavour, which carries its twist sign to the coarse level.  Each
    preconditioner's ``setup_stats`` holds the shared null-vector
    seconds and its own ``coarse_build_secs``."""
    bx, by, bz, bt = params.block
    bg = BlockGeometry(dirac_up.geom, bx, by, bz, bt, params.nvec)
    shared = {}
    transfer = Transfer(v=_null_vectors_for(dirac_up, bg, gen, params,
                                            shared), bg=bg)
    return tuple(_preconditioner(transfer, d, params, dict(shared))
                 for d in (dirac_up, dirac_dn))


def mg_solve(mg: MGPreconditioner, b: torch.Tensor, tol: float = 1e-8,
             n_krylov: int = 10, max_restarts: int = 50,
             solver: Optional[str] = None) -> GCRResult:
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
    ``iters`` counts n_krylov per GCR cycle, 1 per Richardson step."""
    if solver is None:
        solver = mg.params.outer_solver
    d = mg.dirac
    if solver == "gcr-pc":
        pr = d.params.matpc_parity
        src = d.prepare(b)
        x_p = torch.zeros_like(src)
        r_p = src - d.matpc(x_p)
        r2 = norm2(r_p)
        b2 = float(r2)

        def precond(rp):
            full = torch.zeros((2,) + tuple(rp.shape), dtype=rp.dtype,
                               device=rp.device)
            full[pr] = d.a_apply(rp, pr)
            return mg.vcycle(full)[pr]

        iters = 0
        for _ in range(max_restarts):
            if float(r2) <= tol * tol * b2:
                break
            x_p = x_p + gcr_cycle(d.matpc, r_p, n_krylov=n_krylov,
                                  precond=precond)
            iters += n_krylov
            r_p = src - d.matpc(x_p)
            r2 = norm2(r_p)
        x = d.reconstruct(x_p, b)
        return GCRResult(x, iters, norm2(b - d.m(x)))

    x = torch.zeros_like(b)
    r = b - d.m(x)
    r2 = norm2(r)
    b2 = float(r2)
    iters = 0
    if solver == "mr-richardson":
        for _ in range(max_restarts * n_krylov):
            if float(r2) <= tol * tol * b2:
                break
            z = mg.vcycle(r)
            w = d.m(z)
            denom = norm2(w)
            omega = torch.where(
                denom > 0, cDotProduct(w, r) / denom,
                torch.zeros((), dtype=r.dtype, device=r.device))
            x = x + omega * z
            iters += 1
            r = b - d.m(x)
            r2 = norm2(r)
    elif solver == "gcr":
        for _ in range(max_restarts):
            if float(r2) <= tol * tol * b2:
                break
            x = x + gcr_cycle(d.m, r, n_krylov=n_krylov, precond=mg.vcycle)
            iters += n_krylov
            r = b - d.m(x)
            r2 = norm2(r)
    else:
        raise ValueError(f"unknown mg_solve solver {solver!r}")
    return GCRResult(x, iters, r2)
