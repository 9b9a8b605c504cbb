"""ctypes loader for the native byte swap (``native/qkxtm_native.cpp``):
the JAX package's ``io/_native.py`` for the port.

The first call builds the shared library with ``g++`` into the
checkout's ignored ``build/native/`` (never beside the source), named by
a hash of the source and the flags, so an edited source builds anew.
The build writes a temporary file and renames it, so processes that
start together do not load half a library.  Only where ``g++`` is not
on the ``PATH`` do ``decode_be`` / ``encode_be`` run numpy, as the JAX
loader does; a failed build (with g++'s messages) or a built library
that does not load raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent.parent / "native" / "qkxtm_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
_ENTRY_POINTS = ("be64_to_f64", "be32_to_f64", "f64_to_be64", "f64_to_be32")

_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> Path:
    """Where the library of this source and these flags is built."""
    h = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode())
    return BUILD_DIR / f"qkxtm_native-{h.hexdigest()[:16]}.so"


def _build(so: Path) -> bool:
    """Build the library at ``so``; False where ``g++`` is missing."""
    if shutil.which("g++") is None:
        return False
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", str(tmp)],
                       check=True, capture_output=True, text=True,
                       timeout=120)
        os.replace(tmp, so)
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"g++ could not build {_SRC}:\n{e.stderr}") from e
    finally:
        tmp.unlink(missing_ok=True)
    return True


def _load(so: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(so))
    for name in _ENTRY_POINTS:
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
                       ctypes.c_int]
    return lib


def get_lib():
    """The loaded native library, or None (the numpy path) where ``g++``
    is missing.  A failed build or load raises, and the next call tries
    again."""
    global _lib, _tried
    with _lock:
        if not _tried:
            so = library_path()
            if so.exists() or _build(so):
                _lib = _load(so)
            _tried = True
        return _lib


def decode_be(buf: bytes, precision: int) -> np.ndarray:
    """Big-endian float64 / float32 payload → native float64 array
    (threaded native swap where the library loads)."""
    lib = get_lib()
    be = ">f8" if precision == 64 else ">f4"
    if lib is None:
        return np.frombuffer(buf, dtype=be).astype(np.float64)
    n = len(buf) // (8 if precision == 64 else 4)
    out = np.empty(n, np.float64)
    src = np.frombuffer(buf, dtype=np.uint8)
    fn = lib.be64_to_f64 if precision == 64 else lib.be32_to_f64
    fn(src.ctypes.data, out.ctypes.data, n, 0)
    return out


def encode_be(arr: np.ndarray, precision: int) -> bytes:
    """Native float64 array → big-endian float64 / float32 payload."""
    arr = np.ascontiguousarray(arr, np.float64)
    lib = get_lib()
    if lib is None:
        return arr.astype(">f8" if precision == 64 else ">f4").tobytes()
    if precision == 64:
        out = np.empty(arr.size, np.uint64)
        lib.f64_to_be64(arr.ctypes.data, out.ctypes.data, arr.size, 0)
    else:
        out = np.empty(arr.size, np.uint32)
        lib.f64_to_be32(arr.ctypes.data, out.ctypes.data, arr.size, 0)
    return out.tobytes()
