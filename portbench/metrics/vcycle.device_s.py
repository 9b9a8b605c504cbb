"""Device seconds of the V-cycle a solve: the span ``mg.vcycle``
(``MGPreconditioner.vcycle``) on the card's clock, from a timing event
at each end on the stream (idle time between its kernels included),
over the solves of the traced stretch.  It reads every
``vcycle.device_s.<cell kind>`` entry."""

from portbench.metrics._spans import span_per_solve


def read(run):
    return span_per_solve(run, ["mg.vcycle"], "device_s")
