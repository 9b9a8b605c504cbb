"""LIME / ILDG gauge-configuration I/O on the host: the JAX package's
``io/lime.py`` (the reference's ``readLimeGauge``).  The big-endian
payload is swapped by the threaded native helper (``io/_native.py``),
or by numpy where ``g++`` is missing.

LIME container: records with 144-byte headers (magic u32 BE 0x456789ab,
version u16, flags u16, length u64, type 128 bytes NUL-padded), data
padded to a multiple of 8.  ILDG binary data ("ildg-binary-data"):
site-ordered [t][z][y][x][mu][row][col][re, im] big-endian float64 (or
float32), mu in (x, y, z, t) order.
"""

from __future__ import annotations

import re
import struct

import numpy as np

from quda_qkxtm_multigrid_tpu_torch.io._native import decode_be, encode_be

_MAGIC = 0x456789AB
_HDR = struct.Struct(">IHHQ128s")


def read_records(path: str):
    """[(type, bytes)] of every LIME record of the file."""
    out = []
    with open(path, "rb") as f:
        while True:
            hdr = f.read(144)
            if len(hdr) < 144:
                break
            magic, _ver, _flags, length, rtype = _HDR.unpack(hdr)
            if magic != _MAGIC:
                raise ValueError(f"bad LIME magic {magic:#x} in {path}")
            name = rtype.split(b"\0", 1)[0].decode()
            data = f.read(length)
            f.read((8 - length % 8) % 8)
            out.append((name, data))
    return out


def write_records(path: str, records):
    """records: a sequence of (type, bytes)."""
    with open(path, "wb") as f:
        n = len(records)
        for i, (name, data) in enumerate(records):
            flags = (0x8000 if i == 0 else 0) | (0x4000 if i == n - 1 else 0)
            f.write(_HDR.pack(_MAGIC, 1, flags, len(data),
                              name.encode().ljust(128, b"\0")))
            f.write(data)
            f.write(b"\0" * ((8 - len(data) % 8) % 8))


def _check_precision(precision: int):
    if precision not in (32, 64):
        raise ValueError(f"ILDG precision {precision}: 32 or 64")


def read_ildg_gauge(path: str, dims=None, precision=None) -> np.ndarray:
    """An ILDG gauge configuration → [4, T, Z, Y, X, 3, 3] complex128
    (lexicographic; ``fields.gauge_from_full`` gives the canonical
    layout).  ``dims`` = (X, Y, Z, T) and the precision are read from the
    ildg-format record where not given."""
    recs = dict(read_records(path))
    if dims is None:
        fmt = recs.get("ildg-format")
        if fmt is None:
            raise ValueError("no dims given and no ildg-format record")
        txt = fmt.decode(errors="ignore")
        g = {k: int(re.search(f"<{k}>(\\d+)</{k}>", txt).group(1))
             for k in ("lx", "ly", "lz", "lt")}
        dims = (g["lx"], g["ly"], g["lz"], g["lt"])
        if precision is None:
            m = re.search(r"<precision>(\d+)</precision>", txt)
            precision = int(m.group(1)) if m else 64
    if precision is None:
        precision = 64
    X, Y, Z, T = dims
    _check_precision(precision)
    arr = decode_be(recs["ildg-binary-data"], precision)
    arr = arr.reshape(T, Z, Y, X, 4, 3, 3, 2)
    return np.moveaxis(arr[..., 0] + 1j * arr[..., 1], 4, 0)


def write_ildg_gauge(path: str, u_full, precision: int = 64):
    """u_full [4, T, Z, Y, X, 3, 3] → an ILDG LIME file."""
    mu_last = np.moveaxis(np.asarray(u_full), 0, 4)    # [T,Z,Y,X,4,3,3]
    T, Z, Y, X = mu_last.shape[:4]
    flat = np.stack([mu_last.real, mu_last.imag], axis=-1)
    _check_precision(precision)
    payload = encode_be(flat, precision)
    fmt = (f'<?xml version="1.0" encoding="UTF-8"?><ildgFormat>'
           f"<version>1.0</version><field>su3gauge</field>"
           f"<precision>{precision}</precision>"
           f"<lx>{X}</lx><ly>{Y}</ly><lz>{Z}</lz><lt>{T}</lt>"
           f"</ildgFormat>").encode()
    write_records(path, [("ildg-format", fmt), ("ildg-binary-data", payload)])
