"""CG iterations a Möbius solve that ran through the fused CG steps
(``ops.blas.cg_pap``, ``cg_r_update_norm``, ``cg_xp_update``): the
program's counter ``krylov.fused_iters`` (``solvers.cg.cg``), over the
roots of ``dw.solve`` in the traced stretch.  A program without the
counter reads nothing."""

from portbench.metrics._dw import dw_counter


def read(run):
    return dw_counter(run, "krylov.fused_iters")
