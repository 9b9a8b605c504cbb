"""The byte model of a Wilson hop and the card's peak.

A hop writes one parity of the lattice, T·Z·W sites, for each of n
sources.  Its least traffic counts each operand read once and each
output written once (the count of the port's ``chip_smoke._bound``):

  gauge           64 | 96 | 144 reals a site (recon-8 | 12 | 18), once
  clover inverse  144 reals a site, once, where an epilogue reads it
  ψ               24 reals a site and source
  x (xpay)        24 reals a site and source
  out (and out2)  24 reals a site and source each

in the storage precision of each operand, which the kernel's entry
point names (``qkx_dslash_ch_<form>``, ``qkx_dslash_ch_msrc_<form>``).
"""

from __future__ import annotations

# NVIDIA H100 SXM: 3.35 TB/s of HBM3 (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12

# bytes of (gauge, clover inverse, ψ, x, out) of each form
FORM_BYTES = {
    "f32": (4, 4, 4, 4, 4),
    "f64": (8, 8, 8, 8, 8),
    "f32_g16": (2, 2, 4, 4, 4),
    "f32_g16c32": (2, 4, 4, 4, 4),
    "f32_g16s16": (2, 0, 2, 0, 4),
    "f32_g16c32_o16": (2, 4, 4, 4, 2),
    "f32_g16c32_s16o16": (2, 4, 2, 4, 2),
    "f32_g16c32_x16": (2, 4, 4, 2, 4),
    "f32_g16c32_s16": (2, 4, 2, 4, 4),
    "f32_r8": (4, 4, 4, 4, 4),
}
GAUGE_REALS = {8: 64, 12: 96, 18: 144}


def hop_bytes(form: str, sites: int, n: int, recon: int, clover: bool,
              xpay: bool, post: int) -> int:
    """Least bytes of one launch of ``form`` over ``sites`` output sites
    and ``n`` sources."""
    g, c, s, x, o = FORM_BYTES[form]
    per_site = GAUGE_REALS[recon] * g
    if clover or post == 1:
        per_site += 144 * c
    per_src = 24 * s + 24 * o * (2 if post else 1) + (24 * x if xpay else 0)
    return sites * (per_site + n * per_src)
