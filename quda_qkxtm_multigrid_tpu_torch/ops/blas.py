"""Field BLAS with QUDA's names (reference include/blas_quda.h).

Reductions return 0-d real (or complex) tensors on the field's device,
so a solver decides where it synchronises with the host.  ``axpy`` and
``xpay`` update in place; the fused updates and reductions of the JAX
package's ``ops/blas.py`` (``caxpy`` … ``block_cdot``) return new
tensors, as JAX does; nothing in the port calls them yet (``cg`` and
``pipelined_cg`` still spell these updates inline, until a fused CG
takes them over).  They work on complex
fields and on real planar-channel fields alike; ``cDotProduct_ch`` and
``cscale_ch`` give a planar-channel field (channel axis -3, channel
a*2 + re/im, see ``ops/dslash_kernel``) the complex inner product and
complex scaling of the field it stands for.
"""

from __future__ import annotations

import torch


def norm2(x: torch.Tensor) -> torch.Tensor:
    """|x|² as a real 0-d tensor."""
    return torch.vdot(x.reshape(-1), x.reshape(-1)).real


def cDotProduct(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """<x, y> = Σ conj(x) y as a 0-d tensor."""
    return torch.vdot(x.reshape(-1), y.reshape(-1))


def reDotProduct(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Re <x, y> as a real 0-d tensor."""
    return torch.vdot(x.reshape(-1), y.reshape(-1)).real


def axpy(a, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """y += a*x in place (a a number or a 0-d tensor); returns y."""
    return y.add_(x * a)


def xpay(x: torch.Tensor, a, y: torch.Tensor) -> torch.Tensor:
    """y = x + a*y in place; returns y."""
    return y.mul_(a).add_(x)


def _ri(x: torch.Tensor):
    """(re, im) views of a planar-channel field [..., 2k, Z, W]."""
    v = x.unflatten(-3, (-1, 2))
    return v[..., 0, :, :], v[..., 1, :, :]


def cDotProduct_ch(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """<x, y> of the complex fields that two planar-channel fields stand
    for, as a complex 0-d tensor."""
    xr, xi = _ri(x)
    yr, yi = _ri(y)
    re = torch.vdot(x.reshape(-1), y.reshape(-1))
    im = (xr * yi).sum() - (xi * yr).sum()
    return torch.complex(re, im)


def cscale_ch(a, x: torch.Tensor) -> torch.Tensor:
    """The complex number ``a`` (a 0-d tensor or a Python number) times
    the complex field that the planar-channel field ``x`` stands for."""
    a = torch.as_tensor(a, device=x.device)
    ar, ai = (a.real, a.imag) if a.is_complex() else (a, torch.zeros_like(a))
    xr, xi = _ri(x)
    return torch.stack([ar * xr - ai * xi, ar * xi + ai * xr],
                       dim=-3).reshape(x.shape)


# ---- the fused updates and reductions (JAX ``ops/blas.py``) ----------

def caxpy(a, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """y + a x (a complex)."""
    return y + a * x


def caxpby(a, x: torch.Tensor, b, y: torch.Tensor) -> torch.Tensor:
    """a x + b y."""
    return a * x + b * y


def caxpbypz(a, x: torch.Tensor, b, y: torch.Tensor,
             z: torch.Tensor) -> torch.Tensor:
    """z + a x + b y."""
    return z + a * x + b * y


def axpyZpbx(a, p: torch.Tensor, x: torch.Tensor, r: torch.Tensor, b):
    """(x + a p, r + b p): the fused CG update (blas_quda.h:60)."""
    return x + a * p, r + b * p


def xmyNorm(x: torch.Tensor, y: torch.Tensor):
    """(x − y, |x − y|²) (blas_quda.h:56)."""
    d = x - y
    return d, norm2(d)


def axpyNorm(a, x: torch.Tensor, y: torch.Tensor):
    """(y + a x, |y + a x|²) (blas_quda.h:55)."""
    yp = y + a * x
    return yp, norm2(yp)


def axpyCGNorm(a, x: torch.Tensor, y: torch.Tensor):
    """(y' = y + a x, |y'|², Re<y', x>): the fused CG kernel
    (blas_quda.h:72)."""
    yp = y + a * x
    return yp, norm2(yp), reDotProduct(yp, x)


def tripleCGReduction(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor):
    """(|x|², |y|², Re<y, z>) (blas_quda.h:92)."""
    return norm2(x), norm2(y), reDotProduct(y, z)


def cDotProductNormA(a: torch.Tensor, b: torch.Tensor):
    """(<a, b>, |a|²) (blas_quda.h:84)."""
    return cDotProduct(a, b), norm2(a)


def caxpyXmazNormX(a, x: torch.Tensor, y: torch.Tensor, z: torch.Tensor):
    """(y + a x, z − a x, |z − a x|²)."""
    yp = y + a * x
    xp = z - a * x
    return yp, xp, norm2(xp)


def caxpy_batch(a: torch.Tensor, xs: torch.Tensor,
                y: torch.Tensor) -> torch.Tensor:
    """y + Σ_k a[k] xs[k]: the multi-caxpy of GCR's orthogonalisation
    (blas_quda.h:108-144); ``a`` [k], ``xs`` [k, ...field]."""
    ar = a.reshape(a.shape + (1,) * (xs.dim() - 1))
    return y + (ar * xs).sum(dim=0)


def block_cdot(xs: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """[<xs[k], y>]_k as a [k] tensor (multi_reduce_core.h)."""
    return (xs.conj() * y).sum(dim=tuple(range(1, xs.dim())))
