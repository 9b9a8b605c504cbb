"""Small-matrix primitives over fields whose matrix axes lead.

Every helper contracts the 3x3 / 4x4 / 6x6 axes written out as
elementwise multiply-adds over the trailing lattice axes, the same
formulation as the JAX package, so both packages sum in the same order.
"""

from __future__ import annotations

import numpy as np
import torch


def su3_mul(u, psi):
    """out[..., s, a, t, z, w] = sum_b u[a,b] psi[..., s, b]; color axis
    at -4 so arbitrary leading batch/spin axes are supported."""
    cols = [u[a, 0] * psi[..., 0, :, :, :] + u[a, 1] * psi[..., 1, :, :, :]
            + u[a, 2] * psi[..., 2, :, :, :] for a in range(3)]
    return torch.stack(cols, dim=-4)


def su3_dag_mul(u, psi):
    """out[..., s, a] = sum_b conj(u[b,a]) psi[..., s, b]."""
    cols = [u[0, a].conj() * psi[..., 0, :, :, :]
            + u[1, a].conj() * psi[..., 1, :, :, :]
            + u[2, a].conj() * psi[..., 2, :, :, :] for a in range(3)]
    return torch.stack(cols, dim=-4)


def su3_conj_mul(u, psi):
    """out[..., s, a] = sum_b conj(u[a,b]) psi[..., s, b] (U* v)."""
    cols = [u[a, 0].conj() * psi[..., 0, :, :, :]
            + u[a, 1].conj() * psi[..., 1, :, :, :]
            + u[a, 2].conj() * psi[..., 2, :, :, :] for a in range(3)]
    return torch.stack(cols, dim=-4)


def su3_transp_mul(u, psi):
    """out[..., s, a] = sum_b u[b,a] psi[..., s, b] (Uᵀ v)."""
    cols = [u[0, a] * psi[..., 0, :, :, :] + u[1, a] * psi[..., 1, :, :, :]
            + u[2, a] * psi[..., 2, :, :, :] for a in range(3)]
    return torch.stack(cols, dim=-4)


def mat_mul(a, b):
    """3x3 (leading axes) matrix product: [3,3,...] x [3,3,...]."""
    return torch.stack([torch.stack(
        [a[i, 0] * b[0, j] + a[i, 1] * b[1, j] + a[i, 2] * b[2, j]
         for j in range(3)]) for i in range(3)])


def mat_dag(m):
    """Conjugate transpose over the leading (row, col) axes."""
    return m.transpose(0, 1).conj()


def spinmat_mul(p, psi):
    """out[s] = sum_t p[s,t] psi[t] for a CONSTANT 4x4 numpy matrix p and
    psi [4,C,T,Z,W], unrolled over the nonzero entries only."""
    p = np.asarray(p)
    out = []
    for s in range(4):
        acc = None
        for t in range(4):
            c = complex(p[s, t])
            if c == 0.0:
                continue
            term = psi[t] if c == 1.0 else c * psi[t]
            acc = term if acc is None else acc + term
        out.append(torch.zeros_like(psi[0]) if acc is None else acc)
    return torch.stack(out)


def chiral_mat_mul(m, chi, dagger: bool = False):
    """out[c,i] = sum_j m[c,i,j] chi[c,j]; m [2,6,6,T,Z,W], chi [2,6,T,Z,W]."""
    outs = []
    for i in range(6):
        acc = None
        for j in range(6):
            mm = m[:, j, i].conj() if dagger else m[:, i, j]
            term = mm * chi[:, j]
            acc = term if acc is None else acc + term
        outs.append(acc)
    return torch.stack(outs, dim=1)


def mat3_inv(m):
    """Closed-form (adjugate/determinant) inverse of 3x3 matrices with
    LEADING (row, col) axes."""
    a, b, c = m[0, 0], m[0, 1], m[0, 2]
    d, e, f = m[1, 0], m[1, 1], m[1, 2]
    g, h, i = m[2, 0], m[2, 1], m[2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    inv_det = 1.0 / (a * A + b * B + c * C)
    rows = ([A, -(b * i - c * h), (b * f - c * e)],
            [B, (a * i - c * g), -(a * f - c * d)],
            [C, -(a * h - b * g), (a * e - b * d)])
    return torch.stack([torch.stack([x * inv_det for x in r]) for r in rows])


def mat6_inv_blocks(m):
    """Inverse of a 6x6 matrix (leading axes [6,6,...]) via the 3x3 block
    Schur complement: m = [[P, Qt],[Q, R]], S = R - Q P^-1 Qt,
    inv = [[P^-1 + P^-1 Qt S^-1 Q P^-1, -P^-1 Qt S^-1],
           [-S^-1 Q P^-1,               S^-1]]."""
    P, Qt = m[0:3, 0:3], m[0:3, 3:6]
    Q, R = m[3:6, 0:3], m[3:6, 3:6]
    Pi = mat3_inv(P)
    S = R - mat_mul(Q, mat_mul(Pi, Qt))
    Si = mat3_inv(S)
    PiQt = mat_mul(Pi, Qt)
    QPi = mat_mul(Q, Pi)
    top = torch.cat([Pi + mat_mul(PiQt, mat_mul(Si, QPi)),
                     -mat_mul(PiQt, Si)], dim=1)
    bot = torch.cat([-mat_mul(Si, QPi), Si], dim=1)
    return torch.cat([top, bot], dim=0)
