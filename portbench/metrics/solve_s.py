"""Window seconds over the certified solves completed in it: every solve
is one right-hand side solved to the configuration's tolerance (host
clock, the card synchronised at the end of each unit)."""

from portbench.metrics._mean import window_per_solve


def read(run):
    return window_per_solve(run)
