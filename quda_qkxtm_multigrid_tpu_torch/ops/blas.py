"""Field BLAS with QUDA's names (reference include/blas_quda.h).

Reductions return 0-d real (or complex) tensors on the field's device,
so a solver decides where it synchronises with the host.  ``axpy`` and
``xpay`` update in place; the fused updates and reductions of the JAX
package's ``ops/blas.py`` (``caxpy`` … ``block_cdot``) return new
tensors, as JAX does.  They work on complex fields and on real
planar-channel fields alike; ``cDotProduct_ch`` and ``cscale_ch`` give
a planar-channel field (channel axis -3, channel a*2 + re/im, see
``ops/dslash_kernel``) the complex inner product and complex scaling of
the field it stands for.

A CG iteration's vector work is three fused steps, each a hand-written
kernel on a CUDA field (``csrc/blas_cg.cu``) and its plain version on a
CPU one: ``cg_pap`` (Re⟨p, Ap⟩), ``cg_r_update_norm`` (r ← r − αAp and
|r|²) and ``cg_xp_update`` (x ← x + αp, p ← r + βp), 10 passes over the
vectors where the separate calls above make ~19.  ``solvers.cg.cg`` runs
on them; ``pipelined_cg`` still spells its updates inline.
"""

from __future__ import annotations

import ctypes
import functools

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


# ---- the fused steps of a CG iteration (``csrc/blas_cg.cu``) ----------
# Each takes fields of one shape and dtype, complex (through its real
# view: α and β are real, so the updates, Re⟨·,·⟩ and |·|² are the real
# view's) or real.  The reductions sum in float64 and return a 0-d
# float64 tensor; α and β are 0-d tensors that an update reads on the
# device.  A CUDA field launches the kernel (float32 or float64 real
# views, contiguous) or raises; a CPU field runs the plain version.

_CG_FORMS = {torch.float32: "f32", torch.float64: "f64"}
CG_THREADS = 256               # a block of csrc/blas_cg.cu
CG_BLOCKS_PER_SM = 8           # 2048 threads an SM, the H100's most


def _real(t: torch.Tensor) -> torch.Tensor:
    return torch.view_as_real(t) if t.is_complex() else t


def cg_pap_plain(p: torch.Tensor, ap: torch.Tensor) -> torch.Tensor:
    """Re⟨p, Ap⟩ summed in float64: the plain version of ``cg_pap``."""
    return (_real(p).double() * _real(ap).double()).sum()


def cg_r_update_norm_plain(r: torch.Tensor, ap: torch.Tensor,
                           alpha: torch.Tensor) -> torch.Tensor:
    """r ← r − α·Ap in place, and |r|² of the new r summed in float64:
    the plain version of ``cg_r_update_norm``."""
    rr = _real(r)
    rr.addcmul_(_real(ap), -alpha.to(rr.dtype))
    return rr.double().square().sum()


def cg_xp_update_plain(x: torch.Tensor, p: torch.Tensor, r: torch.Tensor,
                       alpha: torch.Tensor, beta: torch.Tensor) -> None:
    """x ← x + α·p, then p ← r + β·p, in place: the plain version of
    ``cg_xp_update``."""
    xr, pr = _real(x), _real(p)
    xr.addcmul_(pr, alpha.to(xr.dtype))
    pr.mul_(beta.to(pr.dtype)).add_(_real(r))


@functools.lru_cache(maxsize=None)
def _cg_max_blocks(index: int) -> int:
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return CG_BLOCKS_PER_SM * sms


def _cg_launch(name: str, fields: tuple, scalars: tuple = ()):
    """The flat real views of ``fields``, the kernel ``qkx_cg_<name>_<form>``,
    its length and grid, the scalars as 0-d float64 tensors on the
    fields' device and the current stream; raises for anything the
    kernels do not take (an update's fields may not alias; ``cg_pap``
    only reads, so p may be Ap)."""
    dev = fields[0].device
    if dev.type != "cuda" or any(t.device != dev for t in fields):
        raise ValueError(f"cg_{name} takes CUDA fields on one device (or CPU "
                         f"fields, for the plain version), not "
                         f"{[str(t.device) for t in fields]}")
    if any(t.shape != fields[0].shape or t.dtype != fields[0].dtype
           for t in fields):
        raise ValueError(f"cg_{name} takes fields of one shape and dtype, "
                         f"not {[(tuple(t.shape), t.dtype) for t in fields]}")
    if not all(t.is_contiguous() for t in fields):
        raise ValueError(f"cg_{name} takes contiguous fields")
    if name != "pap" and len({t.data_ptr() for t in fields}) != len(fields):
        raise ValueError(f"cg_{name} takes fields that do not alias")
    flat = [_real(t).reshape(-1) for t in fields]
    form = _CG_FORMS.get(flat[0].dtype)
    if form is None:
        raise TypeError(f"cg_{name} launches on float32, float64, complex64 "
                        f"or complex128 fields, not {fields[0].dtype}")
    n = flat[0].numel()
    if n == 0:
        raise ValueError(f"cg_{name} takes a non-empty field")
    from quda_qkxtm_multigrid_tpu_torch import _build
    fn = getattr(_build.load_library(), f"qkx_cg_{name}_{form}")
    blocks = max(1, min(_cg_max_blocks(dev.index),
                        -(-n // (CG_THREADS * 4))))
    sc = [torch.as_tensor(s, dtype=torch.float64, device=dev)
          for s in scalars]
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    return flat, fn, n, blocks, sc, stream


def _cg_check(name: str, err: int):
    if err != 0:
        raise RuntimeError(f"cg_{name} kernel launch failed: CUDA error {err}")


def cg_pap(p: torch.Tensor, ap: torch.Tensor) -> torch.Tensor:
    """Re⟨p, Ap⟩ as a 0-d float64 tensor: two launches of
    ``csrc/blas_cg.cu`` (the block partials, then their sum) on a CUDA
    field, ``cg_pap_plain`` on a CPU one."""
    if p.device.type == "cpu" and ap.device.type == "cpu":
        return cg_pap_plain(p, ap)
    (fp, fa), fn, n, blocks, _, stream = _cg_launch("pap", (p, ap))
    partials = torch.empty(blocks, dtype=torch.float64, device=p.device)
    out = torch.empty((), dtype=torch.float64, device=p.device)
    with torch.cuda.device(p.device):
        _cg_check("pap", fn(fp.data_ptr(), fa.data_ptr(), n, blocks,
                            partials.data_ptr(), out.data_ptr(), stream))
    cg_pap.launches += 2
    return out


def cg_r_update_norm(r: torch.Tensor, ap: torch.Tensor,
                     alpha) -> torch.Tensor:
    """r ← r − α·Ap in place and |r|² of the new r as a 0-d float64
    tensor (α a 0-d tensor or a number): two launches on a CUDA field,
    ``cg_r_update_norm_plain`` on a CPU one."""
    if r.device.type == "cpu" and ap.device.type == "cpu":
        return cg_r_update_norm_plain(r, ap, torch.as_tensor(alpha))
    (fr, fa), fn, n, blocks, (a,), stream = _cg_launch(
        "r_update_norm", (r, ap), (alpha,))
    partials = torch.empty(blocks, dtype=torch.float64, device=r.device)
    out = torch.empty((), dtype=torch.float64, device=r.device)
    with torch.cuda.device(r.device):
        _cg_check("r_update_norm", fn(
            fr.data_ptr(), fa.data_ptr(), a.data_ptr(), n, blocks,
            partials.data_ptr(), out.data_ptr(), stream))
    cg_r_update_norm.launches += 2
    return out


def cg_xp_update(x: torch.Tensor, p: torch.Tensor, r: torch.Tensor,
                 alpha, beta) -> None:
    """x ← x + α·p and p ← r + β·p in place, the old p read once for
    both (α, β 0-d tensors or numbers): one launch on a CUDA field,
    ``cg_xp_update_plain`` on a CPU one."""
    if all(t.device.type == "cpu" for t in (x, p, r)):
        cg_xp_update_plain(x, p, r, torch.as_tensor(alpha),
                           torch.as_tensor(beta))
        return
    (fx, fp, fr), fn, n, blocks, (a, b), stream = _cg_launch(
        "xp_update", (x, p, r), (alpha, beta))
    with torch.cuda.device(x.device):
        _cg_check("xp_update", fn(fx.data_ptr(), fp.data_ptr(),
                                  fr.data_ptr(), a.data_ptr(), b.data_ptr(),
                                  n, blocks, stream))
    cg_xp_update.launches += 1


cg_pap.launches = 0
cg_r_update_norm.launches = 0
cg_xp_update.launches = 0
