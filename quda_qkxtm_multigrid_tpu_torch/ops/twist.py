"""Twisted-mass terms.

Degenerate doublet: A = 1 + i·2κμ·flavor·γ5.  DIRECT applies
(1 + i a γ5), INVERSE applies (1 − i a γ5)/(1+a²), a = 2κμ·flavor,
dagger flips the sign of a; γ5 = diag(+,+,−,−).  Spin is axis -5 of a
spinor [..., 4, 3, T, Z, W].

Non-degenerate doublet (reference ndegTwistGamma5,
tests/wilson_dslash_reference.cpp:413-447): on [..., 2(flavor), 4, 3,
T, Z, W], A = 1 + i a γ5 τ3 − b τ1 and A⁻¹ = (1 − i a γ5 τ3 + b τ1) /
(1 + a² − b²), a = 2κμ, b = 2κε, dagger flips the sign of a.
``ndeg_twist_apply_ch`` is the same on planar-channel fields
[..., 2(flavor), T, 24, Z, W] (``ops.dslash_kernel`` layout: channel
(s*3+c)*2 + re/im).
"""

from __future__ import annotations

import torch


def twist_apply(psi: torch.Tensor, kappa: float, mu: float, flavor: int = +1,
                dagger: bool = False, inverse: bool = False) -> torch.Tensor:
    """Apply the twist (or its inverse) to a spinor [..., 4, 3, T, Z, W]."""
    a = 2.0 * kappa * mu * flavor
    b = 1.0
    if inverse:
        a = -a
        b = 1.0 / (1.0 + a * a)
    if dagger:
        a = -a
    g5 = torch.tensor([1.0, 1.0, -1.0, -1.0], dtype=psi.real.dtype,
                      device=psi.device).reshape(4, 1, 1, 1, 1)
    return b * (psi + (1j * a) * g5 * psi)


def _ndeg_coefficients(kappa: float, mu: float, epsilon: float,
                       dagger: bool, inverse: bool):
    """(a, b, scale) with A's flavour rows up' = s (up + i a γ5 up − b dn),
    dn' = s (dn − i a γ5 dn − b up): the direct and the inverse form."""
    a = 2.0 * kappa * mu
    b = 2.0 * kappa * epsilon
    if dagger:
        a = -a
    if not inverse:
        return a, b, 1.0
    return -a, -b, 1.0 / (1.0 + a * a - b * b)


def ndeg_twist_apply(psi_doublet: torch.Tensor, kappa: float, mu: float,
                     epsilon: float, dagger: bool = False,
                     inverse: bool = False) -> torch.Tensor:
    """The non-degenerate twist (or its inverse) on a doublet
    [..., 2(flavor), 4, 3, T, Z, W]."""
    a, b, s = _ndeg_coefficients(kappa, mu, epsilon, dagger, inverse)
    g5 = torch.tensor([1.0, 1.0, -1.0, -1.0], dtype=psi_doublet.real.dtype,
                      device=psi_doublet.device).reshape(4, 1, 1, 1, 1)
    up, dn = psi_doublet.unbind(-6)
    out = torch.stack([up + (1j * a) * g5 * up - b * dn,
                       dn - (1j * a) * g5 * dn - b * up], dim=-6)
    return out if s == 1.0 else s * out


def ndeg_twist_apply_ch(psi_ch: torch.Tensor, kappa: float, mu: float,
                        epsilon: float, dagger: bool = False,
                        inverse: bool = False) -> torch.Tensor:
    """``ndeg_twist_apply`` on planar-channel doublets
    [..., 2(flavor), T, 24, Z, W]: i a γ5 τ3 turns (re, im) into
    (−a g im, a g re) with g = γ5 τ3 = ±1 a channel pair."""
    a, b, s = _ndeg_coefficients(kappa, mu, epsilon, dagger, inverse)
    v = psi_ch.unflatten(-3, (12, 2))           # [..., 2f, T, 12, 2, Z, W]
    g = torch.tensor([1.0] * 6 + [-1.0] * 6, dtype=psi_ch.dtype,
                     device=psi_ch.device)
    ag = a * torch.stack([g, -g]).reshape(2, 1, 12, 1, 1, 1)   # a γ5 τ3
    rot = torch.cat([-ag * v[..., 1:, :, :], ag * v[..., :1, :, :]], dim=-3)
    out = v + rot - b * v.flip(-6)
    out = out.reshape(psi_ch.shape)
    return out if s == 1.0 else s * out
