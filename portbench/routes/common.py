"""What the routes share: the port's operator parameters and MG
parameters from a configuration."""

from __future__ import annotations

import dataclasses


def dirac_params(cfg: dict, use_kernels: bool, **extra):
    from quda_qkxtm_multigrid_tpu_torch.dirac import DiracParams
    a = cfg["action"]
    return DiracParams(kind=a["kind"], kappa=a["kappa"], mu=a["mu"],
                       csw=a["csw"], use_kernels=use_kernels, **extra)


def mg_params(cfg: dict):
    """``MGParams`` with every field that the configuration states; a key
    that ``MGParams`` lacks raises."""
    from quda_qkxtm_multigrid_tpu_torch.mg.multigrid import MGParams
    known = {f.name for f in dataclasses.fields(MGParams)}
    given = dict(cfg["mg"])
    unknown = set(given) - known
    if unknown:
        raise ValueError(f"MGParams has no field(s) {sorted(unknown)}")
    for key in ("block", "block2", "block3"):
        if key in given:
            given[key] = tuple(given[key])
    return MGParams(**given)


def geometry(cfg: dict):
    from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry
    return Geometry(*cfg["lattice"])

