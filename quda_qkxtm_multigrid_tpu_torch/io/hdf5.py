"""The 2pt correlator writers of the JAX package's ``io/hdf5.py``, with
the reference's group layout (``writeTwop*HDF5``):

  /conf_%04d/sx%02dsy%02dsz%02dst%02d/<type>/mom_xyz_%+d_%+d_%+d

per-momentum datasets [T, ...spin..., 2 (re, im)], and the plain-text
``write_twop_ascii``.  h5py is optional: without it the HDF5 writers
raise ``ImportError`` and the CLI writes ASCII.  The position-space,
3pt and loop writers come with their callers (ROADMAP queue 1, items 3
and 4).
"""

from __future__ import annotations

import numpy as np

from quda_qkxtm_multigrid_tpu_torch.physics.contract import (
    BARYON_NAMES, MESON_NAMES)


def _h5py():
    import h5py     # optional; ImportError tells the caller to use ASCII
    return h5py


def _src_tag(source):
    x, y, z, t = source
    return f"sx{x:02d}sy{y:02d}sz{z:02d}st{t:02d}"


def _ri(a):
    """complex [..] → float [.., 2]."""
    a = np.asarray(a)
    return np.stack([a.real, a.imag], axis=-1)


def write_twop_mesons_hdf5(path, corr, moms, traj: int, source):
    """corr [10(type), 2(flavour), T, nmom] complex."""
    corr = np.asarray(corr)
    with _h5py().File(path, "w") as f:
        g = f.create_group(f"conf_{traj:04d}").create_group(_src_tag(source))
        for it, name in enumerate(MESON_NAMES):
            gt = g.create_group(name)
            for im, (px, py, pz) in enumerate(moms):
                gt.create_dataset(f"mom_xyz_{px:+d}_{py:+d}_{pz:+d}",
                                  data=_ri(corr[it, :, :, im]))


def write_twop_baryons_hdf5(path, corr, moms, traj: int, source):
    """corr [10(type), 2(flavour), 4, 4, T, nmom] complex."""
    corr = np.asarray(corr)
    with _h5py().File(path, "w") as f:
        g = f.create_group(f"conf_{traj:04d}").create_group(_src_tag(source))
        for it, name in enumerate(BARYON_NAMES):
            gt = g.create_group(name)
            for im, (px, py, pz) in enumerate(moms):
                block = np.moveaxis(corr[it, :, :, :, :, im], (1, 2), (2, 3))
                gt.create_dataset(f"mom_xyz_{px:+d}_{py:+d}_{pz:+d}",
                                  data=_ri(block))


def write_twop_ascii(path, corr, moms, kind: str):
    """The reference's .dat layout, one line per (type, flavour, t,
    momentum): ``it fl t px py pz re im``, with ``s1 s2`` before the
    value for baryons [.., 4, 4, T, nmom]."""
    corr = np.asarray(corr)
    with open(path, "w") as f:
        nt = corr.shape[-2]
        for it in range(corr.shape[0]):
            for fl in range(corr.shape[1]):
                for t in range(nt):
                    for im, (px, py, pz) in enumerate(moms):
                        if corr.ndim == 4:
                            v = corr[it, fl, t, im]
                            f.write(f"{it} {fl} {t} {px:+d} {py:+d} {pz:+d} "
                                    f"{v.real:+.16e} {v.imag:+.16e}\n")
                            continue
                        for s1 in range(4):
                            for s2 in range(4):
                                v = corr[it, fl, s1, s2, t, im]
                                f.write(f"{it} {fl} {t} {px:+d} {py:+d} "
                                        f"{pz:+d} {s1} {s2} "
                                        f"{v.real:+.16e} {v.imag:+.16e}\n")
