"""true_res: |b − M x| / |b| of each solve's answer x, M the reference's
own complex128 twisted-clover operator of the gauge that the benchmark
made (its clover term from the field strength)."""

from __future__ import annotations

import torch

from portbench.layout import point_source


def judge(ref, payload):
    op = ref.operator(payload["gauge_seed"])
    out = []
    for spin, colour, x in payload["answers"]:
        b = point_source(ref.cfg["lattice"], payload["coords"], spin, colour,
                         torch.complex128, ref.device)
        out.append(("true_res", op.residual(x, b)))
    return out
