"""true_res of a Möbius domain-wall solve: |b − M x| / |b| of the full 5D
system, M the reference's own complex128 Möbius operator
(``reference/mobius.py``) on the gauge made again from its seed, b the
wall source rebuilt here from the column: (1 + γ5)/2 η on s = 0 and
(1 − γ5)/2 η on s = Ls − 1, η the unit point source."""

from __future__ import annotations

import torch

from portbench.layout import point_source, spinor_slab_to_lex
from portbench.reference.mobius import Mobius


def reference_operator(ref, gauge_seed: int) -> Mobius:
    a, cfg = ref.cfg["action"], ref.cfg
    return Mobius(ref.gauge(gauge_seed), cfg["lattice"], a["ls"], a["m5"],
                  a["mferm"], a["b5"], a["c5"])


def wall_slabs(op: Mobius, dims, coords, spin: int, colour: int, device):
    """``b_slab(t0, t1)`` of the column's wall source, for
    ``Mobius.residual``."""
    eta = point_source(dims, coords, spin, colour, torch.complex128, device)

    def b_slab(t0: int, t1: int) -> torch.Tensor:
        e = spinor_slab_to_lex(eta, dims[0], t0, t1)     # [nt, Z, Y, X, 4, 3]
        b = torch.zeros(e.shape[:4] + (op.ls, 4, 3), dtype=e.dtype,
                        device=e.device)
        b[..., 0, :, :] = op._spin(op.p_l / 2, e)
        b[..., op.ls - 1, :, :] = op._spin(op.p_r / 2, e)
        return b
    return b_slab


def judge(ref, payload):
    op = reference_operator(ref, payload["gauge_seed"])
    dims = ref.cfg["lattice"]
    return [("true_res", op.residual(x, wall_slabs(
        op, dims, payload["coords"], spin, colour, ref.device)))
        for spin, colour, x in payload["answers"]]
