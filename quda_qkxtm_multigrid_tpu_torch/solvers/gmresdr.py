"""GMRES-DR: GMRES with deflated restarting (Morgan 2002), the JAX
package's ``solvers/gmresdr.py`` (reference lib/inv_gmresdr_quda.cpp,
include/invert_quda.h:802).

A restarted GMRES whose restart subspace keeps ``n_defl`` harmonic Ritz
vectors of the Hessenberg matrix, so the low modes that stall plain
restarted GMRES stay deflated across cycles.  The Krylov basis lives on
the device as one tensor [m+1, ...field] (modified Gram-Schmidt, the
Hessenberg matrix on the device too); the small dense problems, a few
(m+1)×m solves a cycle, run on the host in numpy in the fields'
precision: complex64 fields take complex64 host solves, as the JAX
package's do.  Each cycle reads the Hessenberg matrix and the true
|r|² on the host once.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from quda_qkxtm_multigrid_tpu_torch.ops.blas import norm2


class GMResDRResult(NamedTuple):
    x: torch.Tensor
    iters: int             # Arnoldi matvecs
    r2: torch.Tensor       # final |b − M x|² (0-d)


def _harmonic_ritz(h: np.ndarray, m: int, k: int) -> np.ndarray:
    """[m, k] eigenvectors of the harmonic Ritz problem
    (H_m + h²_{m+1,m} H_m^{-H} e_m e_mᵀ) g = θ g for the k smallest |θ|
    (the deflation subspace of GMRES-DR)."""
    hm = h[:m, :m]
    em = np.zeros((m,), h.dtype)
    em[m - 1] = 1.0
    f = np.linalg.solve(hm.conj().T, em)
    hh = hm + (abs(h[m, m - 1]) ** 2) * np.outer(f, em)
    theta, g = np.linalg.eig(hh)
    order = np.argsort(np.abs(theta))
    return g[:, order[:k]]


def gmresdr(matvec: Callable, b: torch.Tensor,
            x0: Optional[torch.Tensor] = None, tol: float = 1e-8,
            n_krylov: int = 20, n_defl: int = 8,
            max_restarts: int = 100) -> GMResDRResult:
    """Solve M x = b (M non-hermitian) by GMRES-DR(m, k): m = n_krylov
    the cycle length, k = n_defl the harmonic Ritz vectors kept (k < m).
    The first cycle is plain GMRES(m); later ones restart from the
    k-dimensional deflation space.  Stops when the true |r|² ≤ tol²|b|²
    or after ``max_restarts`` cycles."""
    m, k = n_krylov, n_defl
    if not 0 < k < m:
        raise ValueError(f"need 0 < n_defl={k} < n_krylov={m}")
    np_dt = np.complex128 if b.dtype == torch.complex128 else np.complex64
    shape, dev = b.shape, b.device

    def residual(x):
        r = b - matvec(x)
        return r, norm2(r)

    x = torch.zeros_like(b) if x0 is None else x0
    r, r2 = residual(x)
    target = tol * tol * float(norm2(b))
    basis = torch.zeros((m + 1, b.numel()), dtype=b.dtype, device=dev)
    beta = torch.sqrt(r2)
    basis[0] = (r / beta.to(b.dtype)).reshape(-1)
    # c = V_{m+1}^H r at the start of a cycle, kept on the host
    c = np.zeros((m + 1,), np_dt)
    c[0] = float(beta)
    h_dev = torch.zeros((m + 1, m), dtype=b.dtype, device=dev)
    k0 = 0
    iters = 0
    for restart in range(max_restarts):
        # Arnoldi from column k0 to m: A V = V H̄
        for kk in range(k0, m):
            w = matvec(basis[kk].view(shape)).reshape(-1)
            for j in range(kk + 1):
                cj = torch.vdot(basis[j], w)
                h_dev[j, kk] += cj
                w = w - cj * basis[j]
            nrm = torch.linalg.vector_norm(w)
            h_dev[kk + 1, kk] = nrm
            basis[kk + 1] = w * torch.where(nrm > 0, 1.0 / nrm, 0.0).to(
                b.dtype)
        iters += m - k0
        h = h_dev.cpu().numpy().astype(np_dt)
        # least squares y = argmin |c − H̄ y|  (the GMRES projection)
        y, *_ = np.linalg.lstsq(h, c, rcond=None)
        x = x + (torch.from_numpy(y).to(dev, b.dtype) @ basis[:m]).view(shape)
        r, r2 = residual(x)
        if float(r2) <= target or restart == max_restarts - 1:
            break
        # the deflated restart
        g = _harmonic_ritz(h, m, k)                       # [m, k]
        cr = c - h @ y                                    # residual coeffs
        pk = np.zeros((m + 1, k + 1), np_dt)
        pk[:m, :k] = g
        pk[:, k] = cr
        pk, _ = np.linalg.qr(pk)                          # [m+1, k+1]
        h_new = pk.conj().T @ h @ pk[:m, :k]              # [k+1, k]
        small = torch.from_numpy(pk.T.copy()).to(dev, b.dtype) @ basis
        basis.zero_()
        basis[:k + 1] = small
        h_dev.zero_()
        h_dev[:k + 1, :k] = torch.from_numpy(h_new).to(dev, b.dtype)
        # V_new^H r = P^H (c − H̄ y); columns k+1..m are zero
        c = np.zeros((m + 1,), np_dt)
        c[:k + 1] = pk.conj().T @ cr
        k0 = k
    return GMResDRResult(x, iters, r2)
