"""Sums over the window's units of what their kinds report."""


def per_solve(run, key):
    """Σ ``info[key]`` over Σ ``info["solves"]``, over the units that
    report ``key``."""
    got = [u["info"] for u in run.units if key in u["info"]]
    solves = sum(i["solves"] for i in got)
    return sum(i[key] for i in got) / solves if solves else None


def window_per_solve(run):
    """Window seconds over the solves completed in it."""
    solves = sum(u["info"].get("solves", 0) for u in run.units)
    return run.window_s / solves if solves else None


def mean_setup(run, key):
    """The mean of ``setup_stats[key]`` over the units that made a
    set-up."""
    vals = [u["info"]["setup_stats"].get(key) for u in run.units
            if "setup_stats" in u["info"]]
    vals = [v for v in vals if v is not None]
    return sum(vals) / len(vals) if vals else None
