"""How near-null a set-up's V is, plain.

The set-up's null vectors are solves x = M⁻¹ξ of Gaussian sources ξ,
and V spans them aggregate by aggregate.  Such a vector carries M⁻¹'s
correlation between neighbouring sites, which white noise does not: the
gauge-covariant hop

    H ψ(x) = Σ_μ [ U_μ(x) ψ(x+μ) + U_μ(x−μ)† ψ(x−μ) ]      (spin by spin)

has Re⟨x, H x⟩ / |x|² of order one on M⁻¹ξ and zero, to a part in a
thousand, on Gaussian vectors.  ``block_hop`` reads it inside the
aggregates, on V's own basis (its trace over the span), and on a field
that the reference solved itself, cut into the same aggregates.

V is [2(chirality), Tc, Zc, Yc, Xc, nvec, bdof] as ``galerkin`` reads
it; the links are the lexicographic gauge [4, T, Z, Y, X, 3, 3].
"""

from __future__ import annotations

import torch

from portbench.layout import gauge_slab_to_lex

# the block axis of direction mu in [.., bt, bz, by, bx, 2, 3]
_BLOCK_AXIS = {0: -3, 1: -4, 2: -5, 3: -6}


def _row_hop(f: torch.Tensor, links: torch.Tensor) -> tuple:
    """Per (chirality, aggregate) of one coarse t row: (Σ over the
    row's vectors of Re⟨f, H f⟩ inside the aggregate, Σ |f|²).  ``f`` is
    [2, Zc, Yc, Xc, n, bt, bz, by, bx, 2, 3]; ``links`` [4, Zc, Yc, Xc,
    bt, bz, by, bx, 3, 3]."""
    num = torch.zeros(f.shape[:4], dtype=torch.float64, device=f.device)
    for mu in range(4):
        ax = _BLOCK_AXIS[mu]
        n = f.shape[ax]
        lo, hi = f.narrow(ax, 0, n - 1), f.narrow(ax, 1, n - 1)
        u = links[mu].narrow(ax, 0, n - 1).unsqueeze(0).unsqueeze(4)
        uhi = torch.einsum("...ab,...sb->...sa", u, hi)
        num = num + 2 * (lo.conj() * uhi).real.sum(dim=tuple(range(4, 11)))
    den = (f.abs() ** 2).sum(dim=tuple(range(4, 11)))
    return num, den


def _block_links(u: torch.Tensor, x: int, t0: int, block) -> torch.Tensor:
    """The links of coarse t row starting at ``t0`` as [4, Zc, Yc, Xc,
    bt, bz, by, bx, 3, 3] (complex128)."""
    bx, by, bz, bt = block
    g = gauge_slab_to_lex(u, x, t0, t0 + bt).to(torch.complex128)
    _, _, z, y, xx = g.shape[:5]
    g = g.reshape(4, bt, z // bz, bz, y // by, by, xx // bx, bx, 3, 3)
    return g.permute(0, 2, 4, 6, 1, 3, 5, 7, 8, 9)


def block_hop(u: torch.Tensor, dims, block, v: torch.Tensor | None = None,
              w: torch.Tensor | None = None) -> float:
    """The mean over (chirality, aggregate) of Re⟨f, H f⟩ / |f|² inside
    the aggregate, summed over V's basis (``v``: the trace of H over its
    span) or for one lexicographic field ``w`` [T, Z, Y, X, 4, 3]; one
    coarse t row at a time, in complex128."""
    bx, by, bz, bt = block
    xx, yy, zz, tt = dims
    ratios = []
    for tc in range(tt // bt):
        links = _block_links(u, xx, tc * bt, block)
        if v is not None:
            _, _, zc, yc, xc, nvec, _ = v.shape
            f = v[:, tc].to(torch.complex128).reshape(
                2, zc, yc, xc, nvec, bt, bz, by, bx, 2, 3)
        else:
            f = w[tc * bt:(tc + 1) * bt].to(torch.complex128).reshape(
                bt, zz // bz, bz, yy // by, by, xx // bx, bx, 2, 2, 3)
            f = f.permute(7, 1, 3, 5, 0, 2, 4, 6, 8, 9).unsqueeze(4)
        num, den = _row_hop(f, links)
        ratios.append((num / den).reshape(-1))
    return float(torch.cat(ratios).mean())
