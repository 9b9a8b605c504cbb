"""Applications of M_pc or M_pc† a Möbius solve: the program's counter
``op.applies`` (``MobiusDirac``'s public entries), over the roots of
``dw.solve`` in the traced stretch."""

from portbench.metrics._dw import dw_counter


def read(run):
    return dw_counter(run, "op.applies")
