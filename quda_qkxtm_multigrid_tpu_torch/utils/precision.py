"""Full float32 matrix products, whatever the caller has set: the
counterpart of the JAX package's ``utils/precision.heinsum``, which pins
every contraction to ``Precision.HIGHEST``.

A float32 or complex64 product on the card runs in TF32 (about three
decimal digits) once a caller sets ``torch.backends.cuda.matmul.
allow_tf32 = True`` or ``torch.set_float32_matmul_precision("high")``;
the multigrid transfers and the coarse operator then lose the accuracy
their complex128 checks hold them to.  ``full_float32`` turns TF32 off
for the products inside it and restores the caller's setting after.
"""

from __future__ import annotations

import contextlib

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
