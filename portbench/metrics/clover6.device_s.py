"""Device seconds of the operator's chiral 6×6 clover applies a solve:
the span ``op.clover6`` (``ops.dslash_kernel.clover_ch``, one kernel
launch each: the A, A⁻¹ and A⁻¹† that no hop epilogue takes) on the
card's clock, over the solves of the traced stretch.  A program without
the span reads nothing.  It reads every ``clover6.device_s.<cell kind>``
entry."""

from portbench.metrics._spans import span_per_solve


def read(run):
    return span_per_solve(run, ["op.clover6"], "device_s")
