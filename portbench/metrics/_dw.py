"""What the program's spans and counters recorded in a traced stretch of
Möbius solves, a solve at a time: the roots of the span ``dw.solve``
(``domain_wall.invert_mobius``) count the solves."""

from portbench.metrics._spans import _table


def dw_table(run):
    """(the program's table, the solves it counted), or (None, 0)."""
    table = _table(run)
    if table is None:
        return None, 0
    return table, table["spans"].get("dw.solve", {}).get("roots", 0)


def dw_span(run, name, key="device_s"):
    """``key`` (``device_s``, ``device_self_s``, …) of the span ``name``
    over the Möbius solves; None where nothing was recorded or the span
    has no device seconds (no card)."""
    table, solves = dw_table(run)
    span = None if table is None else table["spans"].get(name)
    if not solves or span is None or span[key] is None:
        return None
    return span[key] / solves


def dw_counter(run, name):
    """The counter ``name`` over the Möbius solves; None where nothing
    was recorded."""
    table, solves = dw_table(run)
    if not solves or name not in table["counters"]:
        return None
    return table["counters"][name] / solves
