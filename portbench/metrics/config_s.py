"""Window seconds over the gauge configurations completed in it: each
unit makes a gauge from the seed, builds the operator, sets MG up and
runs that set-up's first certified solve (host clock)."""


def read(run):
    return run.window_s / len(run.units) if run.units else None
