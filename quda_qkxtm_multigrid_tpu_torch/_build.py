"""Build the CUDA sources under ``csrc/`` at first use and load them.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` into one shared
library with a plain C interface, which ``ctypes`` loads.  The library
lands in ``build/torch_kernels/`` beside the package, named by a hash of
the sources and flags, so an edited source builds anew and an unchanged
one is built once.  Nothing is downloaded and nothing is prebuilt.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
# (psi, g, cinv, x, out, out2, T, Z, W, Xh, parity, dagger, recon12,
#  twist, ta, tb, clover, xpay, xc, post, pa, pb, stream)
_DSLASH_ARGTYPES = [_P] * 6 + [_I] * 8 + [_D, _D, _I, _I, _D, _I, _D, _D, _P]
ENTRY_POINTS = {"qkx_dslash_ch_f32": _DSLASH_ARGTYPES,
                "qkx_dslash_ch_f64": _DSLASH_ARGTYPES}


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


def library_path() -> Path:
    return BUILD_DIR / f"qkx_kernels-{source_hash()}.so"


def build() -> Path:
    """Compile the sources unless the library for their hash exists.
    The compiler's output (``-Xptxas -v``: registers, spills) is kept
    beside the library as ``.log``."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(p) for p in sorted(CSRC.glob("*.cu")))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, so)
    return so


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, declare every entry point."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in ENTRY_POINTS.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
