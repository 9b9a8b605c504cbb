"""Window seconds over the certified defect-correction solves completed
in it: every solve is one right-hand side solved by the float64 outer to
the configuration's tolerance (host clock, the card synchronised at the
end of each unit).  A metric of its own beside ``solve_s``: at 48³×96 a
solve's time repeats to 0.2 % from run to run, where the 32³×64 MG
solves spread by more, and one bound for both would blind this cell."""

from portbench.metrics._mean import window_per_solve


def read(run):
    return window_per_solve(run)
