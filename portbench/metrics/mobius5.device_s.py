"""Device seconds of the Möbius fifth-dimension passes a solve: the span
``op.mobius5`` (``ops.domain_wall.mobius5_ch``, one launch of the M5
kernel each) on the card's clock, over the roots of ``dw.solve`` in the
traced stretch.  A program without the span reads nothing.  It reads
every ``mobius5.device_s.<cell kind>`` entry."""

from portbench.metrics._dw import dw_span


def read(run):
    return dw_span(run, "op.mobius5")
