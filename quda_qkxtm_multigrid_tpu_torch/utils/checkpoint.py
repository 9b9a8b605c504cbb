"""Checkpoint files in the JAX package's formats, numpy only, so the
port reads files that the JAX package wrote and the other way round:
MG null vectors (the reference's vec_infile / vec_outfile; ``v`` the
complex V [2, Tc,Zc,Yc,Xc, nvec, bdof]), deflation eigenpairs
(``evals``, ``evecs``, ``resid``) and accumulated loops (one array a
loop type and ``n_stoch``), each one compressed ``.npz``."""

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


def _host(a) -> np.ndarray:
    """A tensor or array as a numpy array on the host."""
    if hasattr(a, "detach"):
        return a.detach().resolve_conj().cpu().numpy()
    return np.asarray(a)


def save_eigenpairs(path: str, evals, evecs, resid=None):
    """Deflation eigenpairs (the reference's eigenvector files)."""
    np.savez_compressed(path, evals=_host(evals), evecs=_host(evecs),
                        resid=_host(resid) if resid is not None
                        else np.zeros(0))


def load_eigenpairs(path: str):
    """(evals, evecs) as numpy arrays."""
    with np.load(path) as f:
        return f["evals"], f["evecs"]


def save_loops(path: str, loops: dict, n_stoch: int):
    """Accumulated loop fields of a resumable stochastic run."""
    np.savez_compressed(path, n_stoch=n_stoch,
                        **{k: _host(v) for k, v in loops.items()})


def load_loops(path: str):
    """({type: array}, n_stoch)."""
    with np.load(path) as f:
        n = int(f["n_stoch"])
        return {k: f[k] for k in f.files if k != "n_stoch"}, n
