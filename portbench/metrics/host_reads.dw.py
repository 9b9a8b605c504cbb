"""Reads of a device value on the host a Möbius solve (CG's stopping
tests, each waiting for the card): the program's counter ``host_reads``,
over the roots of ``dw.solve`` in the traced stretch."""

from portbench.metrics._dw import dw_counter


def read(run):
    return dw_counter(run, "host_reads")
