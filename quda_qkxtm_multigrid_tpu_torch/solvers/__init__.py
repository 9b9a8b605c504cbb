"""Krylov solvers of the port: the exports of the JAX package's
``solvers`` less ``df64_refine`` and ``host_dc``, which exist for a chip
without float64 and are not ported."""

from quda_qkxtm_multigrid_tpu_torch.solvers.cg import cg, cg_mixed, CGResult
from quda_qkxtm_multigrid_tpu_torch.solvers.bicgstab import (
    bicgstab, bicgstab_mixed, BiCGStabResult)
from quda_qkxtm_multigrid_tpu_torch.solvers.mr import mr
from quda_qkxtm_multigrid_tpu_torch.solvers.gcr import gcr, GCRResult
from quda_qkxtm_multigrid_tpu_torch.solvers.multishift import (
    multishift_cg, multishift_cg_refined, MultiShiftResult,
    RefinedMultiShiftResult)
from quda_qkxtm_multigrid_tpu_torch.solvers.msrc import msrc_cg, MultiSrcResult
from quda_qkxtm_multigrid_tpu_torch.solvers.eigen import (
    lanczos, chebyshev_op, deflate_guess, project_out, EigResult)
from quda_qkxtm_multigrid_tpu_torch.solvers.gmresdr import (
    gmresdr, GMResDRResult)
from quda_qkxtm_multigrid_tpu_torch.solvers.mre import (
    min_res_ext, ChronoHistory)
from quda_qkxtm_multigrid_tpu_torch.solvers.pipelined import (
    pipelined_cg, pipelined_cg_reliable)
from quda_qkxtm_multigrid_tpu_torch.solvers.inc_eigcg import IncEigCG
from quda_qkxtm_multigrid_tpu_torch.solvers.sd import sd
