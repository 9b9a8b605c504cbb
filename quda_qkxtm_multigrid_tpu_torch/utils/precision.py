"""Full float32 matrix products, whatever the caller has set: the
counterpart of the JAX package's ``utils/precision.heinsum``, which pins
every contraction to ``Precision.HIGHEST``.

A float32 or complex64 product on the card runs in TF32 (about three
decimal digits) once a caller sets ``torch.backends.cuda.matmul.
allow_tf32 = True`` or ``torch.set_float32_matmul_precision("high")``;
the multigrid transfers and the coarse operator then lose the accuracy
their complex128 checks hold them to.  ``full_float32`` turns TF32 off
for the products inside it and restores the caller's setting after;
``heinsum`` runs a contraction of many operands that way, pairwise in an
optimal order.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch


@contextlib.contextmanager
def full_float32():
    """Context (or decorator) that runs float32 products in full float32
    and restores the caller's setting on exit.  A caller who set the
    per-backend ``torch.backends.cuda.matmul.fp32_precision`` instead of
    the process-wide precision keeps that form."""
    matmul = torch.backends.cuda.matmul
    try:
        saved = torch.get_float32_matmul_precision()
    except RuntimeError:    # set through the per-backend form
        saved = None
        saved_backend = matmul.fp32_precision
        matmul.fp32_precision = "ieee"
    else:
        torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        if saved is None:
            matmul.fp32_precision = saved_backend
        else:
            torch.set_float32_matmul_precision(saved)


@functools.lru_cache(maxsize=None)
def _contraction_plan(subscripts: str, shapes: tuple) -> tuple:
    """The pairwise steps of ``subscripts`` on operands of ``shapes``:
    (positions taken from the operand list, their two-operand
    subscripts), in the order ``numpy.einsum_path`` finds optimal (no
    limit on the intermediates' size), each result appended to the
    list."""
    inputs, output = subscripts.replace(" ", "").split("->")
    subs = inputs.split(",")
    probes = [np.broadcast_to(np.zeros((), np.complex64), s) for s in shapes]
    path = np.einsum_path(subscripts, *probes,
                          optimize=("optimal", float(2 ** 62)))[0][1:]
    steps = []
    for k, contract in enumerate(path):
        pos = tuple(sorted(contract, reverse=True))
        taken = [subs.pop(i) for i in pos]
        if k == len(path) - 1:
            new = output
        else:
            keep = "".join(subs) + output
            new = "".join(dict.fromkeys(c for s in taken for c in s
                                        if c in keep))
        steps.append((pos, ",".join(taken) + "->" + new))
        subs.append(new)
    return tuple(steps)


def heinsum(subscripts: str, *operands: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` in full float32 (``full_float32``), contracted
    pairwise in the order ``numpy.einsum_path(optimize="optimal")`` finds
    for these shapes: the counterpart of the JAX package's ``heinsum``
    (``Precision.HIGHEST`` and opt_einsum's order).  ``torch.einsum``
    alone contracts left to right unless the optional ``opt_einsum``
    package is present; a many-operand contraction (a baryon term has
    seven) then builds intermediates far larger than the result."""
    ops = list(operands)
    plan = _contraction_plan(subscripts, tuple(tuple(o.shape) for o in ops))
    with full_float32():
        for pos, spec in plan:
            taken = [ops.pop(i) for i in pos]
            ops.append(torch.einsum(spec, *taken))
    return ops[0]
