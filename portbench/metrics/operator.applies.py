"""Applications of M, M†, M_pc or M_pc† a solve: the program's counter
``op.applies``, counted at the operators' public entries, over the
solves of the traced stretch.  It reads every
``operator.applies.<cell kind>`` entry."""

from portbench.metrics._spans import counter_per_solve


def read(run):
    return counter_per_solve(run, "op.applies")
