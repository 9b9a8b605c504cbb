"""The byte model of the Möbius fifth-dimension kernel M5
(``csrc/mobius5_ch.cu``): a launch on one parity of a 5D field reads ψ
and writes the output once, 24 float32 reals a 5D half-site each, and
reads x once more where it takes one (xpay).  The [2, Ls, Ls] matrix
(≤ 8 KB) is not counted."""

from __future__ import annotations

REAL_BYTES = 4          # float32 channels
REALS = 24              # a spinor's reals at a site


def m5_bytes(half_sites5: int, launches: int, xpay_launches: int) -> int:
    """Least bytes of ``launches`` launches over ``half_sites5`` 5D sites
    of one parity (Ls · T · Z · Y · X / 2), ``xpay_launches`` of them with
    x."""
    per = half_sites5 * REALS * REAL_BYTES
    return per * (2 * launches + xpay_launches)
