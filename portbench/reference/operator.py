"""The twisted-clover Wilson operator, plain, in lexicographic order.

    M ψ(x) = A(x) ψ(x) + i 2κμ γ5 ψ(x)
             − κ Σ_μ [ (1 − γ_μ) U_μ(x) ψ(x+μ) + (1 + γ_μ) U_μ(x−μ)† ψ(x−μ) ]
    A(x)   = 1 + i c_sw κ Σ_{μ>ν} σ_μν ⊗ F_μν(x),   σ_μν = (i/2)[γ_μ, γ_ν]
    F_μν   = (Q_μν − Q_μν†) / 8,   Q_μν the sum of the four clover leaves

γ in the DeGrand-Rossi basis (γ5 = diag(1, 1, −1, −1)), directions
μ = 0, 1, 2, 3 for x, y, z, t, κ normalisation (the 1/2 of the Wilson
projectors folded into κ).  The links carry the antiperiodic t boundary
as the benchmark made them, so every shift is periodic.  The operator is
applied a t-slab at a time, with one row of halo on each side, so that a
48³×96 lattice fits beside whatever else is alive.

``round_fn`` (the controls, ``portbench.controls``) rounds the links and
every spinor operand before each product: computing in TF32 rounds the
inputs of each product to a 10-bit mantissa and keeps float32 sums.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.layout import gauge_slab_to_lex, spinor_slab_to_lex

_i = 1j
GAMMA = np.zeros((4, 4, 4), dtype=np.complex128)
GAMMA[0] = [[0, 0, 0, _i], [0, 0, _i, 0], [0, -_i, 0, 0], [-_i, 0, 0, 0]]
GAMMA[1] = [[0, 0, 0, -1], [0, 0, 1, 0], [0, 1, 0, 0], [-1, 0, 0, 0]]
GAMMA[2] = [[0, 0, _i, 0], [0, 0, 0, -_i], [-_i, 0, 0, 0], [0, _i, 0, 0]]
GAMMA[3] = [[0, 0, 1, 0], [0, 0, 0, 1], [1, 0, 0, 0], [0, 1, 0, 0]]
GAMMA5 = GAMMA[0] @ GAMMA[1] @ GAMMA[2] @ GAMMA[3]
PAIRS = ((1, 0), (2, 0), (2, 1), (3, 0), (3, 1), (3, 2))
SIGMA = {(m, n): 0.5j * (GAMMA[m] @ GAMMA[n] - GAMMA[n] @ GAMMA[m])
         for m, n in PAIRS}

# the site axis of direction mu in [T, Z, Y, X, ...]
AXIS = {0: 3, 1: 2, 2: 1, 3: 0}


def fwd(f: torch.Tensor, mu: int) -> torch.Tensor:
    """f(x + μ̂)."""
    return torch.roll(f, -1, dims=AXIS[mu])


def bwd(f: torch.Tensor, mu: int) -> torch.Tensor:
    """f(x − μ̂)."""
    return torch.roll(f, 1, dims=AXIS[mu])


def dag(m: torch.Tensor) -> torch.Tensor:
    return m.transpose(-1, -2).conj()


class TwistedClover:
    """M of the gauge ``u`` (canonical [4, 2, 3, 3, T, Z, W], as the
    benchmark made it) on the lattice ``dims`` (X, Y, Z, T), computed in
    ``dtype``."""

    def __init__(self, u: torch.Tensor, dims, kappa: float, mu: float,
                 csw: float, dtype=torch.complex128, slab: int = 8,
                 round_fn=None, keep_clover: bool = False):
        self.u, self.dims = u, tuple(dims)
        self.kappa, self.mu, self.csw = kappa, mu, csw
        self.dtype, self.slab = dtype, slab
        self.round = round_fn if round_fn is not None else (lambda t: t)
        # an operator applied many times (the controls' CG) keeps each
        # slab's field strength; one residual does not
        self.kept = {} if keep_clover else None
        dev = u.device
        self.gamma = torch.tensor(GAMMA, dtype=dtype, device=dev)
        self.proj = [(torch.eye(4, dtype=dtype, device=dev) - self.gamma[m],
                      torch.eye(4, dtype=dtype, device=dev) + self.gamma[m])
                     for m in range(4)]
        self.sigma = {k: torch.tensor(v, dtype=dtype, device=dev)
                      for k, v in SIGMA.items()}
        self.g5 = torch.tensor(np.diag(GAMMA5).real, dtype=dtype,
                               device=dev)

    # products ---------------------------------------------------------
    def _spin(self, s: torch.Tensor, psi: torch.Tensor) -> torch.Tensor:
        """Σ_t s[a, t] ψ[..., t, c] (a spin matrix: exact in any
        precision, its entries are 0, ±1, ±i)."""
        return torch.einsum("st,...tc->...sc", s, psi)

    def _col(self, m: torch.Tensor, psi: torch.Tensor) -> torch.Tensor:
        """Σ_b m[..., a, b] ψ[..., s, b]."""
        return torch.einsum("...ab,...sb->...sa", self.round(m),
                            self.round(psi))

    def _mm(self, *ms):
        out = self.round(ms[0])
        for m in ms[1:]:
            out = self.round(torch.matmul(out, self.round(m)))
        return out

    # the operator on a slab -------------------------------------------
    def _field_strength(self, u: torch.Tensor, m: int, n: int):
        um, un = u[m], u[n]
        q = self._mm(um, fwd(un, m), dag(fwd(um, n)), dag(un))
        q = q + self._mm(un, dag(bwd(fwd(um, n), m)), dag(bwd(un, m)),
                         bwd(um, m))
        q = q + self._mm(dag(bwd(um, m)), dag(bwd(bwd(un, m), n)),
                         bwd(bwd(um, m), n), bwd(un, n))
        q = q + self._mm(dag(bwd(un, n)), bwd(um, n), fwd(bwd(un, n), m),
                         dag(um))
        return (q - dag(q)) / 8

    def _strengths(self, u: torch.Tensor, t0: int) -> list:
        if self.kept is not None and t0 in self.kept:
            return self.kept[t0]
        fs = [self._field_strength(u, m, n) for m, n in PAIRS]
        if self.kept is not None:
            self.kept[t0] = fs
        return fs

    def _local(self, u: torch.Tensor, psi: torch.Tensor,
               t0: int) -> torch.Tensor:
        """M ψ on the extended slab of rows t0 − 1 … (lexicographic,
        every row but the first and the last right)."""
        out = psi + (2j * self.kappa * self.mu) * (
            self.g5.reshape(4, 1) * psi)
        c = 1j * self.csw * self.kappa
        for (m, n), f in zip(PAIRS, self._strengths(u, t0)):
            out = out + c * self._spin(self.sigma[(m, n)], self._col(f, psi))
        hop = torch.zeros_like(psi)
        for m in range(4):
            minus, plus = self.proj[m]
            hop = hop + self._spin(minus, self._col(u[m], fwd(psi, m)))
            hop = hop + self._spin(plus, self._col(dag(bwd(u[m], m)),
                                                   bwd(psi, m)))
        return out - self.kappa * hop

    def _gauge_rows(self, t0: int, t1: int) -> torch.Tensor:
        key = ("u", t0)
        if self.kept is not None and key in self.kept:
            return self.kept[key]
        rows = gauge_slab_to_lex(self.u, self.dims[0], t0, t1).to(self.dtype)
        if self.kept is not None:
            self.kept[key] = rows
        return rows

    def apply_lex(self, psi: torch.Tensor) -> torch.Tensor:
        """M ψ for a lexicographic field [T, Z, Y, X, 4, 3]."""
        tt = self.dims[3]
        out = torch.empty(psi.shape, dtype=self.dtype, device=psi.device)
        for t0 in range(0, tt, self.slab):
            t1 = min(tt, t0 + self.slab)
            rows = torch.arange(t0 - 1, t1 + 1, device=psi.device) % tt
            ext = psi.index_select(0, rows).to(self.dtype)
            out[t0:t1] = self._local(self._gauge_rows(t0 - 1, t1 + 1),
                                     ext, t0)[1:-1]
        return out

    def residual(self, x: torch.Tensor, b: torch.Tensor) -> float:
        """|b − M x| / |b| of canonical fields [2, 4, 3, T, Z, W], a
        t-slab at a time."""
        xx, tt = self.dims[0], self.dims[3]
        r2 = b2 = 0.0
        for t0 in range(0, tt, self.slab):
            t1 = min(tt, t0 + self.slab)
            ext = spinor_slab_to_lex(x, xx, t0 - 1, t1 + 1).to(self.dtype)
            mx = self._local(self._gauge_rows(t0 - 1, t1 + 1), ext,
                             t0)[1:-1]
            bs = spinor_slab_to_lex(b, xx, t0, t1).to(torch.complex128)
            r2 += float(torch.linalg.vector_norm(
                bs - mx.to(torch.complex128)) ** 2)
            b2 += float(torch.linalg.vector_norm(bs) ** 2)
        return (r2 / b2) ** 0.5
