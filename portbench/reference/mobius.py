"""The Möbius domain-wall operator, plain, in lexicographic order.

    M ψ(x, s) = D̃5 ψ(x, s)
                − κ_b Σ_μ [ (1 − γ_μ) U_μ(x) χ(x+μ, s)
                            + (1 + γ_μ) U_μ(x−μ)† χ(x−μ, s) ]
    χ      = D4pre ψ = b5 ψ + (c5 / 2) D5hop ψ
    D̃5     = 1 + κ5 D5hop
    D5hop ψ(s) = P_R ψ(s+1) + P_L ψ(s−1),  P_R = 1 − γ5,  P_L = 1 + γ5,
             the two couplings across the wall (ψ(0) into s = Ls−1 and
             ψ(Ls−1) into s = 0) multiplied by −m_f
    κ_b = 1 / (2 (b5 (4 + m5) + 1)),  κ_c = 1 / (2 (c5 (4 + m5) − 1)),
    κ5  = κ_b / (2 κ_c)

with m5 in QUDA's sign convention (−1.8 for a domain-wall height M5 of
1.8), γ in the DeGrand-Rossi basis of ``reference.operator`` (γ5 =
diag(1, 1, −1, −1)), directions μ = 0, 1, 2, 3 for x, y, z, t.  These
are the formulas of the reference's ``tests/domain_wall_dslash_reference
.cpp`` (``mdw_dslash_5``, ``mdw_dslash_4_pre``, ``dslashReference_4d``,
``mdw_mat``) and of the κ's of its ``tests/dslash_test.cpp``.  The links
carry the antiperiodic t boundary as the benchmark made them, so every
shift is periodic.  A 5D field is [T, Z, Y, X, Ls, 4, 3], applied a
t-slab at a time with one row of halo on each side.

Departures from QUDA's ``mdw_mat``: it applies M parity by parity on
even-odd fields (out_p = D̃5 ψ_p − κ_b D4 D4pre ψ_{1−p}); here the whole
field at once, which is the same operator, since D4 joins opposite
parities only.  b5 and c5 are s-constant (zMöbius' per-s values are not
taken).  Only M is applied, never its dagger (whose oracle keeps C5 on
the left).  The arithmetic is complex128 throughout.
"""

from __future__ import annotations

import torch

from portbench.layout import gauge_slab_to_lex, parities_to_lex
from portbench.reference.operator import GAMMA, GAMMA5, bwd, dag, fwd


def canonical5_slab_to_lex(x5: torch.Tensor, xx: int, t0: int, t1: int,
                           device, dtype) -> torch.Tensor:
    """Rows t0 … t1−1 (wrapping around T) of a canonical 5D field [Ls, 2,
    4, 3, T, Z, W] (on any device) as [t1−t0, Z, Y, X, Ls, 4, 3] of
    ``dtype`` on ``device``."""
    tt = x5.shape[-3]
    rows = torch.arange(t0, t1) % tt
    s = x5.index_select(-3, rows.to(x5.device)).to(device=device,
                                                   dtype=dtype)
    ls, _, _, _, nt, z, w = s.shape
    s = s.reshape(ls, 2, 4, 3, nt, z, w // (xx // 2), xx // 2)
    return parities_to_lex(s.permute(1, 4, 5, 6, 7, 0, 2, 3), t0 % tt)


class Mobius:
    """M of the gauge ``u`` (canonical [4, 2, 3, 3, T, Z, W], as the
    benchmark made it) on the lattice ``dims`` (X, Y, Z, T) at Ls
    slices, computed in ``dtype``."""

    def __init__(self, u: torch.Tensor, dims, ls: int, m5: float,
                 mferm: float, b5: float, c5: float,
                 dtype=torch.complex128, slab: int = 2):
        self.u, self.dims, self.ls = u, tuple(dims), int(ls)
        self.mferm, self.b5, self.c5 = mferm, b5, c5
        self.kappa_b = 1.0 / (2.0 * (b5 * (4.0 + m5) + 1.0))
        kappa_c = 1.0 / (2.0 * (c5 * (4.0 + m5) - 1.0))
        self.kappa5 = self.kappa_b / (2.0 * kappa_c)
        self.dtype, self.slab = dtype, slab
        dev = u.device
        one = torch.eye(4, dtype=dtype, device=dev)
        g5 = torch.tensor(GAMMA5, dtype=dtype, device=dev)
        self.p_r, self.p_l = one - g5, one + g5
        gamma = torch.tensor(GAMMA, dtype=dtype, device=dev)
        self.proj = [(one - gamma[m], one + gamma[m]) for m in range(4)]

    @staticmethod
    def _spin(s: torch.Tensor, psi: torch.Tensor) -> torch.Tensor:
        return torch.einsum("st,...tc->...sc", s, psi)

    @staticmethod
    def _col(m: torch.Tensor, psi: torch.Tensor) -> torch.Tensor:
        """Σ_b m[t, z, y, x, a, b] ψ[t, z, y, x, s5, spin, b]."""
        return torch.einsum("tzyxab,tzyxlsb->tzyxlsa", m, psi)

    def d5hop(self, psi: torch.Tensor) -> torch.Tensor:
        """P_R ψ(s+1) + P_L ψ(s−1), −m_f across the wall; ψ [..., Ls, 4,
        3]."""
        up = torch.roll(psi, -1, dims=-3)          # ψ(s+1)
        dn = torch.roll(psi, 1, dims=-3)           # ψ(s−1)
        up[..., -1, :, :] *= -self.mferm
        dn[..., 0, :, :] *= -self.mferm
        return self._spin(self.p_r, up) + self._spin(self.p_l, dn)

    def _local(self, u: torch.Tensor, psi: torch.Tensor) -> torch.Tensor:
        """M ψ on an extended slab (every row but the first and the last
        right)."""
        chi = self.b5 * psi + (0.5 * self.c5) * self.d5hop(psi)
        hop = torch.zeros_like(psi)
        for m in range(4):
            minus, plus = self.proj[m]
            hop += self._spin(minus, self._col(u[m], fwd(chi, m)))
            hop += self._spin(plus, self._col(dag(bwd(u[m], m)),
                                              bwd(chi, m)))
        del chi
        return psi + self.kappa5 * self.d5hop(psi) - self.kappa_b * hop

    def _slabs(self):
        tt = self.dims[3]
        for t0 in range(0, tt, self.slab):
            yield t0, min(tt, t0 + self.slab)

    def apply_canonical(self, x5: torch.Tensor) -> torch.Tensor:
        """M x of a canonical 5D field, as [T, Z, Y, X, Ls, 4, 3]."""
        xx, tt = self.dims[0], self.dims[3]
        out = torch.empty((tt,) + tuple(reversed(self.dims[:3]))
                          + (self.ls, 4, 3), dtype=self.dtype,
                          device=self.u.device)
        for t0, t1 in self._slabs():
            ext = canonical5_slab_to_lex(x5, xx, t0 - 1, t1 + 1,
                                         self.u.device, self.dtype)
            u = gauge_slab_to_lex(self.u, xx, t0 - 1, t1 + 1).to(self.dtype)
            out[t0:t1] = self._local(u, ext)[1:-1]
        return out

    def residual(self, x5: torch.Tensor, b_slab) -> float:
        """|b − M x| / |b| of a canonical 5D answer ``x5``, a t-slab at a
        time; ``b_slab(t0, t1)`` gives the source's rows t0 … t1−1 as
        [t1−t0, Z, Y, X, Ls, 4, 3] on the gauge's device."""
        xx = self.dims[0]
        r2 = b2 = 0.0
        for t0, t1 in self._slabs():
            ext = canonical5_slab_to_lex(x5, xx, t0 - 1, t1 + 1,
                                         self.u.device, self.dtype)
            u = gauge_slab_to_lex(self.u, xx, t0 - 1, t1 + 1).to(self.dtype)
            mx = self._local(u, ext)[1:-1]
            del ext, u
            bs = b_slab(t0, t1).to(self.dtype)
            r2 += float(torch.linalg.vector_norm(bs - mx) ** 2)
            b2 += float(torch.linalg.vector_norm(bs) ** 2)
        return (r2 / b2) ** 0.5
