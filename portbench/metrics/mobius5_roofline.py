"""The M5 kernel's share of its bandwidth roofline in a traced stretch:
its bytes (``portbench.m5bytes``: the program's counters ``op.mobius5``,
its launches, and ``op.mobius5.xpay``, those with x, at the 5D half-sites
the unit reports) over the device time of the kernels named
``mobius5_ch`` in the trace, over 3.35 TB/s, in %.  Nothing to read (no
trace, no launch or counter, no kernel time) gives None.  It reads every
``mobius5_roofline.<cell kind>`` entry."""

from portbench.hopbytes import HBM_BYTES_PER_S
from portbench.m5bytes import m5_bytes
from portbench.metrics._dw import dw_table


def read(run):
    table, _ = dw_table(run)
    if table is None or run.trace is None:
        return None
    launches = table["counters"].get("op.mobius5", 0)
    sites = [u["info"]["half_sites5"] for u in run.units
             if "half_sites5" in u["info"]]
    secs = sum(s for k, s in run.trace["kernels"].items()
               if "mobius5_ch" in k)
    if not launches or not sites or secs == 0:
        return None
    nbytes = m5_bytes(sites[0], launches,
                      table["counters"].get("op.mobius5.xpay", 0))
    return 100.0 * nbytes / (secs * HBM_BYTES_PER_S)
