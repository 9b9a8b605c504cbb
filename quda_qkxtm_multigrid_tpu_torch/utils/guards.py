"""NaN / Inf guards: the counterpart of the JAX package's
``utils/guards.py`` without its checkify tier.

``assert_finite(tree)`` checks every tensor of a tensor, or of a dict,
list or tuple of them, reading one flag a tensor on the host;
``maybe_guard(tree)`` does so when the environment sets
``QKXTM_GUARD=1`` and is a no-op (no device read) otherwise, cheap
enough to stay in the solve entry points (``invert.invert`` returns
``maybe_guard(x, "invert.x")``)."""

from __future__ import annotations

import os

import torch


def _leaves(tree, path: str = ""):
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")


def assert_finite(tree, name: str = "tree"):
    """Raise ``FloatingPointError`` naming the first tensor of ``tree``
    with a non-finite entry (a complex entry counts when either part
    is), and the share of such entries; return ``tree``."""
    for path, t in _leaves(tree):
        bad = ~torch.isfinite(t)
        if bool(bad.any()):
            share = float(bad.float().mean())
            raise FloatingPointError(
                f"non-finite values in {name}{path}: {share * 100:.4f}% of "
                "entries")
    return tree


def maybe_guard(tree, name: str = "tree"):
    """``assert_finite`` when ``QKXTM_GUARD=1``, else ``tree`` as is."""
    if os.environ.get("QKXTM_GUARD") == "1":
        return assert_finite(tree, name)
    return tree
