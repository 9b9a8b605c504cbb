"""Command-line physics executables: the counterpart of the JAX
package's ``cli.py`` (the reference's ``CalcMG_2pt3pt_EvenOdd`` and
``CalcMG_Loops_w_oneD_TSM_EvenOdd``), its flag names included.

    python -m quda_qkxtm_multigrid_tpu_torch.cli twop --xdim 32 --ydim 32 \\
        --zdim 32 --tdim 64 --kappa 0.115 --mu 0.05 --csw 1.0 --src 0,0,0,0
    python -m quda_qkxtm_multigrid_tpu_torch.cli threep ... --tsink 12 \\
        --proj G4
    python -m quda_qkxtm_multigrid_tpu_torch.cli loops ... --nstoch 12 \\
        --tol-LP 1e-2 --nHP 2

Runs on the card unless ``--device cpu``.  Without ``--conf`` the gauge
is the port's random SU(3) field from ``--seed``; either way the
antiperiodic t boundary is folded into the links (``apply_t_boundary``)
and the plaquette is printed.  ``--precision single`` (the default)
runs the fused float32 kernels on the card, ``double`` the complex128
operator through K1's float64 instance, a mixed CG a column
(``workflows.make_operator``, ``workflows.forward_prop``).  ``threep``
runs the 2pt first (its propagators, smeared links and MG pair) and
then ``run_threep`` at ``--tsink``; ``loops`` runs ``run_loops`` on Z4
noise from a generator seeded ``--seed``.  The results go to HDF5 where
h5py is installed, else to ASCII: ``<output>_{mesons,baryons}.dat``,
``<output>_<proj>_<part>.thrp.<type>.dat``,
``<output>_<loop type>.loop``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def _common(p):
    p.add_argument("--xdim", type=int, default=8)
    p.add_argument("--ydim", type=int, default=8)
    p.add_argument("--zdim", type=int, default=8)
    p.add_argument("--tdim", type=int, default=16)
    p.add_argument("--kappa", type=float, required=True)
    p.add_argument("--mu", type=float, required=True)
    p.add_argument("--csw", type=float, default=0.0)
    p.add_argument("--conf", type=str, default=None,
                   help="ILDG/LIME gauge configuration (random if omitted)")
    p.add_argument("--traj", type=int, default=0)
    p.add_argument("--Q-sq", dest="q_sq", type=int, default=1)
    p.add_argument("--tol", type=float, default=1e-8)
    p.add_argument("--maxiter", type=int, default=2000)
    p.add_argument("--nsmearAPE", type=int, default=20)
    p.add_argument("--alphaAPE", type=float, default=0.5)
    p.add_argument("--nsmearGauss", type=int, default=50)
    p.add_argument("--alphaGauss", type=float, default=4.0)
    p.add_argument("--precision", choices=["single", "double"],
                   default="single")
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--output", type=str, default="out")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (the card unless 'cpu')")
    p.add_argument("--mg", action="store_true",
                   help="solve with MG-preconditioned GCR")
    p.add_argument("--mg-block", type=str, default="4,4,4,4")
    p.add_argument("--mg-nvec", type=int, default=24)
    p.add_argument("--mg-levels", type=int, default=2)
    p.add_argument("--mg-setup-tol", type=float, default=5e-6)
    p.add_argument("--mg-setup-maxiter", type=int, default=500)
    p.add_argument("--mg-nu-pre", type=int, default=0)
    p.add_argument("--mg-nu-post", type=int, default=4)
    p.add_argument("--mg-solver", choices=["gcr", "gcr-pc",
                                           "mr-richardson"], default="gcr")
    p.add_argument("--mg-load-vecs", dest="mg_vec_infile", type=str,
                   default="")
    p.add_argument("--mg-save-vecs", dest="mg_vec_outfile", type=str,
                   default="")
    for name, dest in (("muPR", "delta_mu_pr"), ("kappaPR", "delta_kappa_pr"),
                       ("cswPR", "delta_csw_pr"),
                       ("muCG", "delta_mu_coarse"),
                       ("kappaCG", "delta_kappa_coarse"),
                       ("cswCG", "delta_csw_coarse")):
        p.add_argument(f"--delta-{name}", dest=dest, type=float, default=1.0)


def _mg_params(args):
    if not args.mg:
        return None
    from quda_qkxtm_multigrid_tpu_torch.mg.multigrid import MGParams
    bx, by, bz, bt = (int(v) for v in args.mg_block.split(","))
    return MGParams(block=(bx, by, bz, bt), nvec=args.mg_nvec,
                    outer_solver=args.mg_solver, n_level=args.mg_levels,
                    setup_tol=args.mg_setup_tol,
                    setup_maxiter=args.mg_setup_maxiter,
                    nu_pre=args.mg_nu_pre, nu_post=args.mg_nu_post,
                    smoother_pc=True, vec_infile=args.mg_vec_infile,
                    vec_outfile=args.mg_vec_outfile,
                    delta_mu_pr=args.delta_mu_pr,
                    delta_kappa_pr=args.delta_kappa_pr,
                    delta_csw_pr=args.delta_csw_pr,
                    delta_mu_coarse=args.delta_mu_coarse,
                    delta_kappa_coarse=args.delta_kappa_coarse,
                    delta_csw_coarse=args.delta_csw_coarse)


def load_gauge(args, geom, dtype, device) -> torch.Tensor:
    """The configuration of ``--conf`` or the random gauge of ``--seed``,
    with the antiperiodic t boundary; prints the plaquette."""
    from quda_qkxtm_multigrid_tpu_torch import fields
    from quda_qkxtm_multigrid_tpu_torch.ops.gauge import (
        apply_t_boundary, plaquette)
    from quda_qkxtm_multigrid_tpu_torch.utils import rng

    if args.conf:
        from quda_qkxtm_multigrid_tpu_torch.io import lime
        full = torch.tensor(lime.read_ildg_gauge(args.conf),
                            device=device).to(dtype)
        u = fields.gauge_from_full(full, geom)
    else:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        u = rng.random_gauge(gen, geom, dtype)
    u = apply_t_boundary(u, geom)
    tot, sp, tm = plaquette(u, geom)
    print(f"plaquette: total={float(tot):.8f} spatial={float(sp):.8f} "
          f"temporal={float(tm):.8f}")
    return u


def _write_twop(args, out, src):
    moms = out["moms"]
    mes = out["mesons"].cpu().numpy()
    bar = out["baryons"].cpu().numpy()
    from quda_qkxtm_multigrid_tpu_torch.io import hdf5 as h5w
    try:
        h5w.write_twop_mesons_hdf5(f"{args.output}_mesons.h5", mes, moms,
                                   args.traj, src)
        h5w.write_twop_baryons_hdf5(f"{args.output}_baryons.h5", bar, moms,
                                    args.traj, src)
        print(f"wrote {args.output}_mesons.h5, {args.output}_baryons.h5")
    except ImportError:
        h5w.write_twop_ascii(f"{args.output}_mesons.dat", mes, moms,
                             "mesons")
        h5w.write_twop_ascii(f"{args.output}_baryons.dat", bar, moms,
                             "baryons")
        print(f"wrote {args.output}_mesons.dat, {args.output}_baryons.dat")


def _write_threep(args, res, src):
    from quda_qkxtm_multigrid_tpu_torch.io import hdf5 as h5w
    host = {proj: {part: {t: a.cpu().numpy() for t, a in types.items()}
                   for part, types in parts.items()}
            for proj, parts in res["thrp"].items()}
    try:
        for proj, parts in host.items():
            for part, types in parts.items():
                for ttype, arr in types.items():
                    h5w.write_threep_hdf5(
                        f"{args.output}_thrp.h5", arr, res["moms"],
                        args.traj, src, args.tsink, proj, f"{ttype}_{part}",
                        "proton")
        print(f"wrote {args.output}_thrp.h5")
    except ImportError:
        for proj, parts in host.items():
            for part, types in parts.items():
                paths = h5w.write_threep_ascii(
                    f"{args.output}_{proj}_{part}", types, res["moms"],
                    t_src=src[3], tsink=args.tsink)
                print("wrote " + ", ".join(paths))


def _write_loops(args, out):
    """The FFT grid's entries at the momenta of ``--Q-sq``."""
    from quda_qkxtm_multigrid_tpu_torch.io import hdf5 as h5w
    from quda_qkxtm_multigrid_tpu_torch.physics.contract import momentum_list
    moms = momentum_list(args.q_sq)
    sel = {}
    for name, arr in out.items():
        a = arr.cpu().numpy()
        sel[name] = np.stack([a[..., pz, py, px] for (px, py, pz) in moms],
                             axis=-1)
    try:
        h5w.write_loops_hdf5(f"{args.output}_loops.h5", sel, moms,
                             args.traj, args.nstoch)
        print(f"wrote {args.output}_loops.h5")
    except ImportError:
        paths = h5w.write_loops_ascii(args.output, sel, moms)
        print("wrote " + ", ".join(paths))


def main(argv=None):
    parser = argparse.ArgumentParser(prog="quda_qkxtm_multigrid_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    for name in ("twop", "threep", "loops"):
        sp = sub.add_parser(name)
        _common(sp)
        if name in ("twop", "threep"):
            sp.add_argument("--src", type=str, default="0,0,0,0",
                            help="source position x,y,z,t")
        if name == "threep":
            sp.add_argument("--tsink", type=int, required=True)
            sp.add_argument("--proj", type=str, default="G4",
                            help="comma list of G4,G5G123,G5G1,G5G2,G5G3")
        if name == "loops":
            sp.add_argument("--nstoch", type=int, default=12)
            sp.add_argument("--tol-LP", dest="tol_lp", type=float,
                            default=None)
            sp.add_argument("--nHP", dest="n_hp", type=int, default=0)
    args = parser.parse_args(argv)

    from quda_qkxtm_multigrid_tpu_torch import workflows as wf
    from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry

    dtype = (torch.complex128 if args.precision == "double"
             else torch.complex64)
    device = torch.device(args.device)
    geom = Geometry(args.xdim, args.ydim, args.zdim, args.tdim)
    u = load_gauge(args, geom, dtype, device)
    if args.cmd == "loops":
        out = wf.run_loops(u, geom, args.kappa, args.mu, args.csw,
                           n_stoch=args.nstoch,
                           gen=torch.Generator(device).manual_seed(args.seed),
                           tol=args.tol, maxiter=args.maxiter,
                           tol_lp=args.tol_lp, n_hp=args.n_hp)
        _write_loops(args, out)
        return out
    src = tuple(int(v) for v in args.src.split(","))
    out = wf.run_twop(u, geom, args.kappa, args.mu, args.csw, source=src,
                      q_sq_max=args.q_sq, ape_alpha=args.alphaAPE,
                      ape_n=args.nsmearAPE, gauss_alpha=args.alphaGauss,
                      gauss_n=args.nsmearGauss, tol=args.tol,
                      maxiter=args.maxiter, verbose=True,
                      mg_params=_mg_params(args))
    if args.cmd == "twop":
        _write_twop(args, out, src)
        return out
    res = wf.run_threep(u, geom, args.kappa, args.mu, args.csw,
                        prop_up=out["prop_up"], prop_dn=out["prop_dn"],
                        u_ape=out["u_ape"], tsink=args.tsink, source=src,
                        projectors=tuple(args.proj.split(",")),
                        q_sq_max=args.q_sq, gauss_alpha=args.alphaGauss,
                        gauss_n=args.nsmearGauss, tol=args.tol,
                        maxiter=args.maxiter, mg_pair=out["mg_pair"])
    _write_threep(args, res, src)
    return res


if __name__ == "__main__":
    main()
