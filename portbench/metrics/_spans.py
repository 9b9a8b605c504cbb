"""What the program's own spans and counters recorded in a traced
stretch (``utils.profiling.table()`` of the port: they record while,
and only while, the profiler records), a solve at a time."""


def _table(run):
    """The program's table, or None: an untraced run, or a program
    without the table."""
    if run.trace is None:
        return None
    from quda_qkxtm_multigrid_tpu_torch.utils import profiling
    read = getattr(profiling, "table", None)
    return None if read is None else read()


def _solves(table) -> int:
    """The solves the table counted: ``mg.solve`` opened inside no other
    span of the program, and ``dc.solve`` (whose inner MG solves are
    its own)."""
    spans = table["spans"]
    return sum(spans.get(n, {}).get("roots", 0)
               for n in ("mg.solve", "dc.solve"))


def span_per_solve(run, names, key):
    """Σ ``key`` (``device_s``, ``device_self_s``, …) of the spans
    ``names`` over the solves; None where nothing was recorded or a span
    has no device seconds (no card)."""
    table = _table(run)
    if table is None or not _solves(table):
        return None
    got = [table["spans"][n][key] for n in names if n in table["spans"]]
    if not got or any(v is None for v in got):
        return None
    return sum(got) / _solves(table)


def counter_per_solve(run, name):
    """The counter ``name`` over the solves; None where nothing was
    recorded."""
    table = _table(run)
    if table is None or not _solves(table) or name not in table["counters"]:
        return None
    return table["counters"][name] / _solves(table)
