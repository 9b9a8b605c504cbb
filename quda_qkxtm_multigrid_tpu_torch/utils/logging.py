"""Verbosity stack and rank-0 logging: the counterpart of the JAX
package's ``utils/logging.py`` (the reference's printfQuda /
warningQuda with pushVerbosity / popVerbosity and setOutputPrefix).
Messages print on rank 0 only: the rank of ``torch.distributed`` when it
is initialised, else this process."""

from __future__ import annotations

import contextlib
import dataclasses
import enum
import sys

import torch


class Verbosity(enum.IntEnum):
    SILENT = 0
    SUMMARIZE = 1
    VERBOSE = 2
    DEBUG_VERBOSE = 3


_stack = [Verbosity.SUMMARIZE]
_prefix = [""]


def get_verbosity() -> Verbosity:
    return _stack[-1]


def set_verbosity(v: Verbosity):
    _stack[-1] = Verbosity(v)


@contextlib.contextmanager
def push_verbosity(v: Verbosity):
    """pushVerbosity / popVerbosity as a context manager."""
    _stack.append(Verbosity(v))
    try:
        yield
    finally:
        _stack.pop()


@contextlib.contextmanager
def output_prefix(p: str):
    _prefix.append(p)
    try:
        yield
    finally:
        _prefix.pop()


def _rank0() -> bool:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank() == 0
    return True


def log(msg: str, level: Verbosity = Verbosity.SUMMARIZE, file=None):
    """printfQuda: print on rank 0 when the verbosity reaches ``level``."""
    if get_verbosity() >= level and _rank0():
        print(f"{_prefix[-1]}{msg}", file=file or sys.stdout, flush=True)


def warn(msg: str):
    """warningQuda: always printed on rank 0, to stderr."""
    if _rank0():
        print(f"{_prefix[-1]}WARNING: {msg}", file=sys.stderr, flush=True)


def debug(msg: str):
    log(msg, Verbosity.DEBUG_VERBOSE)


def print_params(obj, name: str | None = None,
                 level: Verbosity = Verbosity.VERBOSE):
    """printQudaXParam: a params dataclass field by field."""
    log(f"{name or type(obj).__name__}:", level)
    for f in dataclasses.fields(obj):
        log(f"  {f.name} = {getattr(obj, f.name)!r}", level)


def check_params(obj):
    """checkQudaXParam: re-run a dataclass's validation (``__post_init__``)
    on a possibly ``dataclasses.replace``'d instance; return it."""
    post = getattr(obj, "__post_init__", None)
    if post is not None:
        post()
    return obj
