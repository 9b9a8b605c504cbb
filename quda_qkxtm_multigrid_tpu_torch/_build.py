"""Build the CUDA sources under ``csrc/`` at first use and load them.

``nvcc`` compiles each ``csrc/*.cu`` for ``sm_90a`` into a shared library
of its own with a plain C interface, which ``ctypes`` loads.  The
compilers run side by side, one process per source, all started
together.  The libraries land in ``build/torch_kernels/qkx_kernels-<hash>/``
beside the package, the hash taken over the sources and flags, so an
edited source builds anew and an unchanged one is built once.  Nothing
is downloaded and nothing is prebuilt.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import types
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_L = ctypes.c_int64
# (psi, g, cinv, x, out, out2, T, Z, W, Xh, parity, dagger, recon12,
#  twist, ta, tb, clover, xpay, xc, post, pa, pb, stream)
_DSLASH_ARGTYPES = [_P] * 6 + [_I] * 8 + [_D, _D, _I, _I, _D, _I, _D, _D, _P]
# (psi, g, cinv, x, out, out2, n, T, Z, W, Xh, parity, dagger, recon12,
#  twist, ta, tb, clover, xpay, xc, post, pa, pb, stream)
_MSRC_ARGTYPES = [_P] * 6 + [_I] * 9 + [_D, _D, _I, _I, _D, _I, _D, _D, _P]
# (psi, g, cinv, x, out, face_m, face_p, face_ch, T, Z, W, Xh, parity, t0,
#  tstep, nrows, t_first, t_last, dagger, recon12, twist, ta, tb, clover,
#  xpay, xc, stream)
_LOCAL_ARGTYPES = [_P] * 7 + [_I] * 14 + [_D, _D, _I, _I, _D, _P]
# (psi, g, cinv, x, out, out2, face_m, face_p, T, Z, W, Xh, parity,
#  t_first, t_last, dagger, recon12, twist, ta, tb, clover, xpay, xc,
#  post, pa, pb, stream)
_LOCAL_POST_ARGTYPES = [_P] * 8 + [_I] * 10 + [_D, _D, _I, _I, _D, _I, _D,
                                               _D, _P]
# (psi, g, cinv, x, out, out2, face_m, face_p, face_zm, face_zp, face_wm,
#  face_wp, T, Z, W, Xh, parity, t_first, t_last, dagger, recon12, twist,
#  ta, tb, clover, xpay, xc, post, pa, pb, stream)
_BOX_POST_ARGTYPES = [_P] * 12 + [_I] * 10 + [_D, _D, _I, _I, _D, _I, _D,
                                              _D, _P]
ENTRY_POINTS = {"qkx_dslash_ch_f32": _DSLASH_ARGTYPES,
                "qkx_dslash_ch_f64": _DSLASH_ARGTYPES,
                "qkx_dslash_ch_msrc_f32": _MSRC_ARGTYPES,
                # the bf16 operand tier (csrc/dslash_ch_bf16.cu)
                "qkx_dslash_ch_f32_g16": _DSLASH_ARGTYPES,
                "qkx_dslash_ch_f32_g16c32": _DSLASH_ARGTYPES,
                "qkx_dslash_ch_f32_g16s16": _DSLASH_ARGTYPES,
                "qkx_dslash_ch_msrc_f32_g16": _MSRC_ARGTYPES,
                # the bf16 spinor storage (csrc/dslash_ch_bf16s.cu)
                "qkx_dslash_ch_f32_g16c32_o16": _DSLASH_ARGTYPES,
                "qkx_dslash_ch_f32_g16c32_s16o16": _DSLASH_ARGTYPES,
                "qkx_dslash_ch_f32_g16c32_x16": _DSLASH_ARGTYPES,
                "qkx_dslash_ch_f32_g16c32_s16": _DSLASH_ARGTYPES,
                # the recon-8 gauge (csrc/dslash_ch_r8.cu)
                "qkx_dslash_ch_f32_r8": _DSLASH_ARGTYPES,
                # the t-local hop of the sharded solve, K4 and K5
                # (csrc/dslash_ch_local.cu)
                "qkx_dslash_ch_local_f32": _LOCAL_ARGTYPES,
                "qkx_dslash_ch_local_f64": _LOCAL_ARGTYPES,
                "qkx_dslash_ch_local_f32_g16": _LOCAL_ARGTYPES,
                # K4 with K1's second output and float64 epilogues
                "qkx_dslash_ch_local_post_f32": _LOCAL_POST_ARGTYPES,
                "qkx_dslash_ch_local_post_f64": _LOCAL_POST_ARGTYPES,
                "qkx_dslash_ch_local_post_f32_g16": _LOCAL_POST_ARGTYPES,
                # K4 on a box, with the z and y faces (csrc/dslash_ch_box.cu)
                "qkx_dslash_ch_box_post_f32": _BOX_POST_ARGTYPES,
                "qkx_dslash_ch_box_post_f64": _BOX_POST_ARGTYPES,
                "qkx_dslash_ch_box_post_f32_g16": _BOX_POST_ARGTYPES}
# The chiral 6x6 clover apply (csrc/clover_ch.cu): its instances, each
# ``qkx_clover_ch_<name>``, by (operand, spinor, arithmetic and output)
# dtype.  They stay out of ``ENTRY_POINTS``, which lists the hop kernels
# alone: a launch tally that wraps ``ENTRY_POINTS`` has a byte model for
# every hop entry and none yet for these.
CLOVER_FORMS = {"f32_c16": ("bfloat16", "float32", "float32"),
                "f32_c16s16": ("bfloat16", "bfloat16", "float32"),
                "f32": ("float32", "float32", "float32"),
                "f32_s16": ("float32", "bfloat16", "float32"),
                "f64": ("float64", "float64", "float64")}
# (cinv, v, out, n, T, Z, W, dag, twist_a, stream)
_CLOVER_ARGTYPES = [_P] * 3 + [_I] * 5 + [_D, _P]
CLOVER_ENTRY_POINTS = {f"qkx_clover_ch_{name}": _CLOVER_ARGTYPES
                       for name in CLOVER_FORMS}
# The Möbius fifth-dimension passes (csrc/mobius5_ch.cu, kernel M5):
# (mat, v, x, out, ls, rows, zw, a, stream).  Outside ``ENTRY_POINTS``
# too, for the same reason: they are no hop.
MOBIUS5_ENTRY_POINTS = {"qkx_mobius5_ch_f32": [_P] * 4 + [_I] * 3
                        + [_D, _P]}
# The fused steps of a CG iteration (csrc/blas_cg.cu, kernel CG), float32
# and float64 each, outside ``ENTRY_POINTS`` too: no hop.
#   pap            (p, ap, n, blocks, partials, out, stream)
#   r_update_norm  (r, ap, alpha, n, blocks, partials, out, stream)
#   xp_update      (x, p, r, alpha, beta, n, blocks, stream)
BLAS_ENTRY_POINTS = {
    f"qkx_cg_{name}_{form}": argtypes
    for name, argtypes in (("pap", [_P, _P, _L, _I, _P, _P, _P]),
                           ("r_update_norm", [_P] * 3 + [_L, _I] + [_P] * 3),
                           ("xp_update", [_P] * 5 + [_L, _I, _P]))
    for form in ("f32", "f64")}


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    """sha256 over the CUDA sources and the compiler flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "CUDA kernels cannot be built")
    return str(path)


def library_dir() -> Path:
    """Directory of the libraries built from the current sources."""
    return BUILD_DIR / f"qkx_kernels-{source_hash()}"


def build() -> list[Path]:
    """Compile every ``.cu`` whose library for the current hash is
    missing, one ``nvcc`` process per source, all running at once.  The
    compiler's output (``-Xptxas -v``: registers, spills) is kept beside
    each library as ``<source>.log``.  Returns the libraries."""
    out_dir = library_dir()
    libs = [out_dir / f"{cu.stem}.so" for cu in sorted(CSRC.glob("*.cu"))]
    todo = [so for so in libs if not so.exists()]
    if not todo:
        return libs
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for so in todo:
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{so.stem}.cu")]
        procs.append((so, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for so, tmp, cmd, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{log}")
            continue
        so.with_suffix(".log").write_text(log)
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


@functools.lru_cache(maxsize=None)
def load_library() -> types.SimpleNamespace:
    """Build if needed and load once per process.  Returns every entry
    point of ``ENTRY_POINTS``, ``CLOVER_ENTRY_POINTS``,
    ``MOBIUS5_ENTRY_POINTS`` and ``BLAS_ENTRY_POINTS`` as an attribute,
    with its argument types declared (the loaded libraries stay
    referenced under ``_libs``)."""
    libs = [ctypes.CDLL(str(so)) for so in build()]
    fns = {}
    for name, argtypes in {**ENTRY_POINTS, **CLOVER_ENTRY_POINTS,
                           **MOBIUS5_ENTRY_POINTS,
                           **BLAS_ENTRY_POINTS}.items():
        owners = [lib for lib in libs if hasattr(lib, name)]
        if len(owners) != 1:
            raise RuntimeError(f"entry point {name} found in {len(owners)} "
                               "libraries, expected 1")
        fn = getattr(owners[0], name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    return types.SimpleNamespace(_libs=libs, **fns)
