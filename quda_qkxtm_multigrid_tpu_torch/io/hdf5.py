"""The correlator and loop writers of the JAX package's ``io/hdf5.py``,
with the reference's group layout (``writeTwop*HDF5``, ``writeThrpHDF5``,
``writeLoops_HDF5``):

  /conf_%04d/sx%02dsy%02dsz%02dst%02d/<type>/mom_xyz_%+d_%+d_%+d

per-momentum datasets [T, ...spin..., 2 (re, im)]; the ETMC
"HighMomForm" trees (one dataset a correlator, [T, nmom, (Mel,) 2], the
time axis rolled to start at the source, the momentum list and string
attributes at the root); the position-space trees ("PosSpace"); and the
plain-text writers of the reference's ``.dat`` / ``.loop`` line
formats.  h5py is optional: without it the HDF5 writers raise
``ImportError`` and the CLI writes ASCII.
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


def write_threep_hdf5(path, thrp, moms, traj: int, source, tsink: int,
                      proj: str, thrp_type: str, particle: str):
    """thrp: ultra_local [16, T, nmom] / noether [4, T, nmom] / oneD
    [16, 4, T, nmom] complex, appended under
    conf/src/tsink_%02d/proj_%s/<particle>/<type>."""
    thrp = np.asarray(thrp)
    with _h5py().File(path, "a") as f:
        root = f.require_group(f"conf_{traj:04d}").require_group(
            _src_tag(source))
        g = root.require_group(f"tsink_{tsink:02d}").require_group(
            f"proj_{proj}").require_group(particle).require_group(thrp_type)
        for im, (px, py, pz) in enumerate(moms):
            g.create_dataset(f"mom_xyz_{px:+d}_{py:+d}_{pz:+d}",
                             data=_ri(thrp[..., im]))


def write_loops_hdf5(path, loops, moms, traj: int, n_stoch: int):
    """loops: {type: [16 (or 4, 16), T, nmom]} under
    conf/Nstoch_%04d/<type>."""
    with _h5py().File(path, "w") as f:
        g = f.create_group(f"conf_{traj:04d}").create_group(
            f"Nstoch_{n_stoch:04d}")
        for name, arr in loops.items():
            gt = g.create_group(name)
            arr = np.asarray(arr)
            for im, (px, py, pz) in enumerate(moms):
                gt.create_dataset(f"mom_xyz_{px:+d}_{py:+d}_{pz:+d}",
                                  data=_ri(arr[..., im]))


# ---- HighMomForm ----------------------------------------------------------

def _mom_list_and_attrs(f, moms, q_sq, corr_info: str, meta: dict):
    f.create_dataset("Momenta_list_xyz", data=np.asarray(moms, np.int32))
    f.attrs["Nmoms"] = str(len(moms))
    f.attrs["Qsq"] = str(q_sq)
    f.attrs["Correlator-info"] = corr_info
    kappa, mu, csw = (meta.get(k, 0.0) for k in ("kappa", "mu", "csw"))
    f.attrs["Ensemble-info"] = (f"kappa = {kappa:10.8f}\nmu = {mu:8.6f}\n"
                                f"Csw = {csw:8.6f}")


def _roll_t(a, t_axis: int, t_src: int):
    return np.roll(a, -t_src, axis=t_axis)


def write_twop_mesons_hdf5_highmom(path, corr, moms, traj: int, source,
                                   q_sq: int = 0, meta=None):
    """corr [10, 2(flavour), T, nmom] → datasets twop_meson_{1,2}
    [T, nmom, 2], t = 0 at the source."""
    corr = _roll_t(np.asarray(corr), 2, source[3])
    with _h5py().File(path, "w") as f:
        g = f.create_group(f"conf_{traj:04d}").create_group(_src_tag(source))
        for it, name in enumerate(MESON_NAMES):
            gt = g.create_group(name)
            for ip in range(2):
                gt.create_dataset(f"twop_meson_{ip + 1}",
                                  data=_ri(corr[it, ip]))
        _mom_list_and_attrs(
            f, moms, q_sq,
            "Momentum-space meson 2pt-correlator\n"
            "Quark field basis: Physical\n"
            "Index Order: [t, mom-index, real/imag]", meta or {})


def write_twop_baryons_hdf5_highmom(path, corr, moms, traj: int, source,
                                    q_sq: int = 0, meta=None):
    """corr [10, 2(flavour), 4, 4, T, nmom] → datasets
    twop_baryon_{1,2} [T, nmom, 16, 2] (spin row-major)."""
    corr = _roll_t(np.asarray(corr), 4, source[3])
    nt, nmom = corr.shape[4], corr.shape[5]
    with _h5py().File(path, "w") as f:
        g = f.create_group(f"conf_{traj:04d}").create_group(_src_tag(source))
        for it, name in enumerate(BARYON_NAMES):
            gt = g.create_group(name)
            for ip in range(2):
                block = np.moveaxis(corr[it, ip].reshape(16, nt, nmom), 0, 2)
                gt.create_dataset(f"twop_baryon_{ip + 1}", data=_ri(block))
        _mom_list_and_attrs(
            f, moms, q_sq,
            "Momentum-space baryon 2pt-correlator\n"
            "Quark field basis: Physical\n"
            "Index Order: [t, mom-index, spin, real/imag]\n"
            "Spin-index order: Row-major", meta or {})


def write_threep_hdf5_highmom(path, thrp_by_proj, moms, traj: int, source,
                              tsink: int, q_sq: int = 0, meta=None):
    """conf/src/tsink_%02d/proj_%s/{up,down}/<type>[/dir_%02d]/threep
    datasets [tsink + 1, nmom, Mel, 2], t = 0 at the source;
    thrp_by_proj: {proj: {part: {"ultra_local": [16, T, nmom],
    "noether": [4, T, nmom], "oneD": [16, 4, T, nmom]}}}."""
    t_src = source[3]
    with _h5py().File(path, "a") as f:
        g3 = f.require_group(f"conf_{traj:04d}").require_group(
            _src_tag(source)).require_group(f"tsink_{tsink:02d}")
        for proj, parts in thrp_by_proj.items():
            g4 = g3.require_group(f"proj_{proj}")
            for part_name, types in parts.items():
                g5 = g4.require_group(part_name)
                for tname, arr in types.items():
                    g6 = g5.require_group(tname)
                    arr = _roll_t(np.asarray(arr), -2, t_src)[
                        ..., :tsink + 1, :]
                    if tname == "oneD":
                        for mu in range(4):
                            g6.require_group(f"dir_{mu:02d}").create_dataset(
                                "threep",
                                data=_ri(np.moveaxis(arr[:, mu], 0, 2)))
                    else:
                        g6.create_dataset("threep",
                                          data=_ri(np.moveaxis(arr, 0, 2)))
        if "Momenta_list_xyz" not in f:
            _mom_list_and_attrs(
                f, moms, q_sq,
                "Momentum-space three-point function\n"
                "Quark field basis: Physical\n"
                "Index Order: [t, mom-index, op-index, real/imag]",
                meta or {})


def write_loops_hdf5_highmom(path, loops, moms, traj: int, n_stoch: int,
                             q_sq: int = 0, meta=None,
                             exact_nev: int | None = None,
                             low_prec: bool | None = None):
    """conf/<Nstoch_%04d | NLP_%04d | NHP_%04d>/<type>[/dir_%02d]/loop
    datasets [T, nmom, 16, 2]; exact (deflation) loops hang their types
    under conf directly.  loops: {type: [16, T, nmom] or [4, 16, T,
    nmom]}."""
    with _h5py().File(path, "a") as f:
        root = f.require_group(f"conf_{traj:04d}")
        if exact_nev is not None:
            g = root
        elif low_prec is None:
            g = root.require_group(f"Nstoch_{n_stoch:04d}")
        else:
            g = root.require_group(
                f"{'NLP' if low_prec else 'NHP'}_{n_stoch:04d}")
        for name, arr in loops.items():
            arr = np.asarray(arr)
            gt = g.require_group(name)
            if arr.ndim == 4:
                for mu in range(arr.shape[0]):
                    gt.require_group(f"dir_{mu:02d}").create_dataset(
                        "loop", data=_ri(np.moveaxis(arr[mu], 0, 2)))
            else:
                gt.create_dataset("loop", data=_ri(np.moveaxis(arr, 0, 2)))
        if "Momenta_list_xyz" not in f:
            _mom_list_and_attrs(
                f, moms, q_sq,
                "Disconnected quark loops\n"
                "Index Order: [t, mom-index, gamma-index, real/imag]",
                meta or {})


# ---- position space (HDF5 only, as the reference) ------------------------

def write_twop_hdf5_posspace(path, mesons, baryons, traj: int, source):
    """mesons [10, 2, T, Z, Y, X], baryons [10, 2, 4, 4, T, Z, Y, X] →
    conf/src/PosSpace/{mesons,baryons}/<name>/twop_*_{1,2} datasets
    [T, Z, Y, X, (16,) 2]."""
    mesons, baryons = np.asarray(mesons), np.asarray(baryons)
    with _h5py().File(path, "w") as f:
        g = f.create_group(f"conf_{traj:04d}").create_group(
            _src_tag(source)).create_group("PosSpace")
        gm = g.create_group("mesons")
        for it, name in enumerate(MESON_NAMES):
            gt = gm.create_group(name)
            for ip in range(2):
                gt.create_dataset(f"twop_meson_{ip + 1}",
                                  data=_ri(mesons[it, ip]))
        gb = g.create_group("baryons")
        for it, name in enumerate(BARYON_NAMES):
            gt = gb.create_group(name)
            for ip in range(2):
                blk = baryons[it, ip].reshape((16,) + baryons.shape[-4:])
                gt.create_dataset(f"twop_baryon_{ip + 1}",
                                  data=_ri(np.moveaxis(blk, 0, -1)))


def write_threep_hdf5_posspace(path, thrp, traj: int, source, tsink: int,
                               proj: str, thrp_type: str, particle: str):
    """thrp: ultra_local [16, T, Z, Y, X] / noether [4, ...] / oneD
    [16, 4, T, Z, Y, X] → conf/src/PosSpace/tsink_%02d/proj_%s/
    <particle>/<type>[/dir_%02d]/threep [T, Z, Y, X, Mel, 2]."""
    thrp = np.asarray(thrp)
    with _h5py().File(path, "a") as f:
        root = f.require_group(f"conf_{traj:04d}").require_group(
            _src_tag(source)).require_group("PosSpace")
        g = root.require_group(f"tsink_{tsink:02d}").require_group(
            f"proj_{proj}").require_group(particle).require_group(thrp_type)
        if thrp.ndim == 6:
            for mu in range(4):
                g.require_group(f"dir_{mu:02d}").create_dataset(
                    "threep", data=_ri(np.moveaxis(thrp[:, mu], 0, -1)))
        else:
            g.create_dataset("threep", data=_ri(np.moveaxis(thrp, 0, -1)))


# ---- ASCII 3pt and loops ---------------------------------------------------

def write_threep_ascii(path_prefix, thrp, moms, t_src: int = 0,
                       tsink: int = 0):
    """One file ``<prefix>.thrp.<type>.dat`` a type of ``thrp``
    ({"ultra_local": [16, T, nmom], "noether": [4, T, nmom], "oneD":
    [16, 4, T, nmom]}), the reference's lines
    ``iop \t [dir \t] it \t +px +py +pz \t +re +im`` with the
    source-shifted time and the antiperiodic wrap-around sign.  Returns
    the paths."""
    paths = []
    for tname, arr in thrp.items():
        arr = np.asarray(arr)
        nt = arr.shape[-2]
        sign = -1.0 if (tsink + t_src) >= nt else 1.0
        path = f"{path_prefix}.thrp.{tname}.dat"
        paths.append(path)
        with open(path, "w") as f:
            dirs = range(arr.shape[1]) if tname == "oneD" else [None]
            for iop in range(arr.shape[0]):
                for mu in dirs:
                    for it in range(nt):
                        its = (it + t_src) % nt
                        for im, (px, py, pz) in enumerate(moms):
                            if mu is None:
                                v = sign * arr[iop, its, im]
                                head = f"{iop} \t {it} \t "
                            else:
                                v = sign * arr[iop, mu, its, im]
                                head = f"{iop} \t {mu} \t {it} \t "
                            f.write(f"{head}{px:+d} {py:+d} {pz:+d} \t "
                                    f"{v.real:+e} {v.imag:+e}\n")
    return paths


def write_loops_ascii(path_prefix, loops, moms, oneD_factor: float = 0.25):
    """One file ``<prefix>_<type>.loop`` a loop type, the reference's
    ``writeLoops_ASCII`` lines ``t gm [mu] +px +py +pz +re +im`` (the
    one-derivative types scaled by ``oneD_factor`` at write time, as the
    reference does).  loops: {type: [16, T, nmom] or [4, 16, T, nmom]}.
    Returns the paths."""
    paths = []
    for name, arr in loops.items():
        arr = np.asarray(arr)
        path = f"{path_prefix}_{name}.loop"
        paths.append(path)
        with open(path, "w") as f:
            nt = arr.shape[-2]
            for im, (px, py, pz) in enumerate(moms):
                for t in range(nt):
                    for gm in range(16):
                        if arr.ndim == 4:
                            for mu in range(arr.shape[0]):
                                v = oneD_factor * arr[mu, gm, t, im]
                                f.write(f"{t:02d} {gm:02d} {mu:02d} "
                                        f"{px:+d} {py:+d} {pz:+d} "
                                        f"{v.real:+16.15e} "
                                        f"{v.imag:+16.15e}\n")
                        else:
                            v = arr[gm, t, im]
                            f.write(f"{t:02d} {gm:02d} "
                                    f"{px:+d} {py:+d} {pz:+d} "
                                    f"{v.real:+16.15e} "
                                    f"{v.imag:+16.15e}\n")
    return paths
