"""The 90th percentile of the single solves' host seconds (the card
synchronised around each unit of one solve), over every solve of the
window."""

import statistics


def read(run):
    secs = [u["seconds"] for u in run.units
            if u["info"].get("solves") == 1]
    if len(secs) < 10:
        return None
    return statistics.quantiles(secs, n=10)[8]
