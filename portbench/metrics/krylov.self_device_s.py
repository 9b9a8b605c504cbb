"""Device self seconds of the Krylov solvers a solve: the spans
``gcr.cycle`` (outer and coarse GCR) and ``mr`` (the smoother) on the
card's clock, less their child spans (operator applies, the
preconditioner, the coarse operator), so their own reductions and
vector updates, over the solves of the traced stretch.  It reads every
``krylov.self_device_s.<cell kind>`` entry."""

from portbench.metrics._spans import span_per_solve


def read(run):
    return span_per_solve(run, ["gcr.cycle", "mr"], "device_self_s")
