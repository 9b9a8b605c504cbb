"""MG null-vector files (the reference's vec_infile / vec_outfile), in
the JAX package's format: one compressed ``.npz`` whose ``v`` is the
complex V [2, Tc,Zc,Yc,Xc, nvec, bdof].  Numpy only, so the port reads
files that the JAX package wrote and the other way round."""

from __future__ import annotations

import numpy as np


def save_null_vectors(path: str, v_blocked, meta: dict | None = None):
    """Save the transfer's V (``meta`` entries are stored as
    ``meta_<key>``)."""
    np.savez_compressed(path, v=np.asarray(v_blocked),
                        **({f"meta_{k}": v for k, v in (meta or {}).items()}))


def load_null_vectors(path: str) -> np.ndarray:
    with np.load(path) as f:
        return f["v"]
