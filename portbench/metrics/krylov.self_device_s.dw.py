"""Device self seconds of the Möbius solve's CG a solve: the span
``dw.cg`` (``domain_wall.invert_mobius``) on the card's clock less its
child spans (the operator's applies, ``op.matpc``), so CG's own vector
updates and reductions, over the roots of ``dw.solve`` in the traced
stretch.  A program without the span reads nothing."""

from portbench.metrics._dw import dw_span


def read(run):
    return dw_span(run, "dw.cg", "device_self_s")
