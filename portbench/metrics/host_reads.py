"""Reads of a device value on the host a solve (each waits for the
card): the program's counter ``host_reads``, over the solves of the
traced stretch.  It reads every ``host_reads.<cell kind>`` entry."""

from portbench.metrics._spans import counter_per_solve


def read(run):
    return counter_per_solve(run, "host_reads")
