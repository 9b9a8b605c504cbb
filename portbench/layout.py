"""Field layouts: the lexicographic order of the plain reference and the
port's canonical even-odd order, converted a t-slab at a time.

  lexicographic spinor  [T, Z, Y, X, 4(spin), 3(colour)]
  lexicographic gauge   [4(mu: x, y, z, t), T, Z, Y, X, 3, 3]
  canonical spinor      [2(parity), 4, 3, T, Z, W]
  canonical gauge       [4, 2(parity), 3, 3, T, Z, W]

with W = Y · X/2.  The site (x, y, z, t) has parity (x + y + z + t) % 2
and sits in its parity at w = y · X/2 + x // 2.  These conversions are
the benchmark's own: they hand the fields that the benchmark makes to the
port and bring the port's answers back to the reference.
"""

from __future__ import annotations

import torch


def _odd_rows(t0: int, nt: int, z: int, y: int, device) -> torch.Tensor:
    """[nt, Z, Y, 1] bools: (t + z + y) odd, t counted from ``t0``.  In
    such a row the even site of each x pair is the second one."""
    t = torch.arange(t0, t0 + nt, device=device).reshape(-1, 1, 1, 1)
    zz = torch.arange(z, device=device).reshape(1, -1, 1, 1)
    yy = torch.arange(y, device=device).reshape(1, 1, -1, 1)
    return (t + zz + yy) % 2 == 1


def lex_to_parities(f: torch.Tensor, t0: int = 0) -> torch.Tensor:
    """Sites [nt, Z, Y, X, ...] (t counted from ``t0``) → [2, nt, Z, Y,
    X/2, ...]: the even sites, then the odd ones, each row in x order."""
    nt, z, y, x = f.shape[:4]
    rest = tuple(f.shape[4:])
    pairs = f.reshape(nt, z, y, x // 2, 2, *rest)
    odd = _odd_rows(t0, nt, z, y, f.device).reshape(
        (nt, z, y, 1) + (1,) * len(rest))
    first, second = pairs[:, :, :, :, 0], pairs[:, :, :, :, 1]
    return torch.stack([torch.where(odd, second, first),
                        torch.where(odd, first, second)])


def parities_to_lex(p: torch.Tensor, t0: int = 0) -> torch.Tensor:
    """The inverse of ``lex_to_parities``."""
    _, nt, z, y, xh = p.shape[:5]
    rest = tuple(p.shape[5:])
    odd = _odd_rows(t0, nt, z, y, p.device).reshape(
        (nt, z, y, 1) + (1,) * len(rest))
    even, oddp = p[0], p[1]
    pairs = torch.stack([torch.where(odd, oddp, even),
                         torch.where(odd, even, oddp)], dim=4)
    return pairs.reshape(nt, z, y, 2 * xh, *rest)


def spinor_to_canonical(lex: torch.Tensor) -> torch.Tensor:
    """[T, Z, Y, X, 4, 3] → [2, 4, 3, T, Z, W]."""
    t, z, y, x = lex.shape[:4]
    p = lex_to_parities(lex)                       # [2, T, Z, Y, Xh, 4, 3]
    return p.permute(0, 5, 6, 1, 2, 3, 4).reshape(
        2, 4, 3, t, z, y * (x // 2)).contiguous()


def spinor_slab_to_lex(can: torch.Tensor, x: int, t0: int,
                       t1: int) -> torch.Tensor:
    """Rows t0 … t1−1 of a canonical spinor [2, 4, 3, T, Z, W] (``x``
    the lattice's X) as [t1−t0, Z, Y, X, 4, 3], in its dtype.
    Rows wrap around T, so t0 may be negative and t1 may pass T."""
    tt = can.shape[-3]
    rows = torch.arange(t0, t1, device=can.device) % tt
    s = can.index_select(-3, rows)                 # [2, 4, 3, nt, Z, W]
    nt, z, w = s.shape[-3:]
    s = s.reshape(2, 4, 3, nt, z, w // (x // 2), x // 2)
    return parities_to_lex(s.permute(0, 3, 4, 5, 6, 1, 2), t0 % tt)


def spinor_to_lex(can: torch.Tensor, x: int) -> torch.Tensor:
    """A whole canonical spinor as [T, Z, Y, X, 4, 3]."""
    return spinor_slab_to_lex(can, x, 0, can.shape[-3])


def gauge_slab_to_canonical(lex: torch.Tensor, t0: int) -> torch.Tensor:
    """Lexicographic links [4, nt, Z, Y, X, 3, 3] of rows t0 … → their
    canonical block [4, 2, 3, 3, nt, Z, W]."""
    _, nt, z, y, x = lex.shape[:5]
    p = lex_to_parities(lex.movedim(0, 4), t0)     # [2, nt, Z, Y, Xh, 4, 3, 3]
    return p.permute(5, 0, 6, 7, 1, 2, 3, 4).reshape(
        4, 2, 3, 3, nt, z, y * (x // 2))


def gauge_slab_to_lex(can: torch.Tensor, x: int, t0: int,
                      t1: int) -> torch.Tensor:
    """Rows t0 … t1−1 (wrapping around T) of a canonical gauge [4, 2, 3,
    3, T, Z, W] as [4, t1−t0, Z, Y, X, 3, 3]."""
    tt = can.shape[-3]
    rows = torch.arange(t0, t1, device=can.device) % tt
    g = can.index_select(-3, rows)                 # [4, 2, 3, 3, nt, Z, W]
    nt, z, w = g.shape[-3:]
    g = g.reshape(4, 2, 3, 3, nt, z, w // (x // 2), x // 2)
    lex = parities_to_lex(g.permute(1, 4, 5, 6, 7, 0, 2, 3), t0 % tt)
    return lex.movedim(4, 0)


def point_source(dims, coords, spin: int, colour: int, dtype,
                 device) -> torch.Tensor:
    """The canonical unit source at site ``coords`` (x, y, z, t), spin
    ``spin``, colour ``colour``; ``dims`` (X, Y, Z, T)."""
    xx, yy, zz, tt = dims
    x, y, z, t = coords
    b = torch.zeros((2, 4, 3, tt, zz, yy * (xx // 2)), dtype=dtype,
                    device=device)
    b[(x + y + z + t) % 2, spin, colour, t, z, y * (xx // 2) + x // 2] = 1.0
    return b
