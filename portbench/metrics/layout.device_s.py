"""Device seconds of the compact operator's layout conversions a solve:
the span ``op.layout`` (``CompactDirac._to_ch`` / ``_from_ch``, a
complex field to the channel spinor and back) on the card's clock, over
the solves of the traced stretch.  It reads every
``layout.device_s.<cell kind>`` entry."""

from portbench.metrics._spans import span_per_solve


def read(run):
    return span_per_solve(run, ["op.layout"], "device_s")
