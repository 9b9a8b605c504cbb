"""Share of the traced stretch in which nothing ran on the card (no
kernel, copy or set), from the profiler's device activity, in %.  It
reads every ``device.idle.<cell kind>`` entry, one for each end-to-end
metric that it moves."""


def read(run):
    tr = run.trace
    if tr is None or not tr["window_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
