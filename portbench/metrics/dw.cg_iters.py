"""Mean CG iterations a Möbius solve (``invert``'s count on M_pc† M_pc,
from the unit's ``info``)."""

from portbench.metrics._mean import per_solve


def read(run):
    return per_solve(run, "cg_iters")
