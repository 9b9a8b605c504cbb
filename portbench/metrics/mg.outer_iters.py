"""Mean outer GCR iterations a solve (``mg_solve``'s result: n_krylov a
cycle)."""

from portbench.metrics._mean import per_solve


def read(run):
    return per_solve(run, "outer_iters")
