"""Seconds from the start of the process to the end of set-up: imports,
the card's context, the kernels' build or load, the gauge, the
operator, the MG set-up and the warm-up units (host clock)."""


def read(run):
    return run.setup_s
