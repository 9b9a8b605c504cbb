"""Mean summed inner MG iterations a defect-correction solve
(``defect_correction``'s count over its restarts)."""

from portbench.metrics._mean import per_solve


def read(run):
    return per_solve(run, "inner_iters")
