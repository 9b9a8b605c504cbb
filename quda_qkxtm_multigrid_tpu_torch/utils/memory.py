"""Live-memory accounting: the counterpart of the JAX package's
``utils/memory.py`` (the reference's tracking allocator with
printPeakMemUsage and assertAllMemFree).

On the card the numbers are the caching allocator's
(``torch.cuda.memory_allocated``, ``max_memory_allocated``,
``mem_get_info``).  On the CPU, where PyTorch keeps no such count,
``live_bytes`` sums the storages of the live tensors that ``gc`` finds,
as the JAX package counts ``jax.live_arrays``.  Every function takes the
device; the card unless the caller says "cpu"."""

from __future__ import annotations

import contextlib
import gc
from collections import defaultdict

import torch


def _tensors_on(device: torch.device):
    for obj in gc.get_objects():
        try:
            # type(), not isinstance(): the latter reads __class__, which
            # some deprecated module attributes answer with a warning
            if issubclass(type(obj), torch.Tensor) and obj.device == device:
                yield obj
        except ReferenceError:          # a weak proxy whose object died
            continue


def live_bytes(by_shape: bool = False, device="cuda"):
    """Bytes in use on ``device``; with ``by_shape`` also a
    {(shape, dtype): bytes} breakdown of the live tensors there (a
    storage shared by several tensors counts once, under the first)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    total = 0
    detail = defaultdict(int)
    if device.type != "cuda" or by_shape:
        seen = set()
        for t in _tensors_on(device):
            try:
                st = t.untyped_storage()
            except (RuntimeError, NotImplementedError):   # sparse, nested
                continue
            if st.data_ptr() in seen:
                continue
            seen.add(st.data_ptr())
            total += st.nbytes()
            detail[(tuple(t.shape), str(t.dtype))] += st.nbytes()
    if device.type == "cuda":
        total = torch.cuda.memory_allocated(device)
    return (total, dict(detail)) if by_shape else total


def device_memory_stats() -> dict:
    """{device: {bytes_in_use, peak_bytes_in_use, bytes_limit}} for each
    CUDA device; {} without one."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        dev = torch.device("cuda", i)
        out[str(dev)] = {
            "bytes_in_use": torch.cuda.memory_allocated(dev),
            "peak_bytes_in_use": torch.cuda.max_memory_allocated(dev),
            "bytes_limit": torch.cuda.mem_get_info(dev)[1]}
    return out


class PeakTracker:
    """Peak bytes in use over a region (printPeakMemUsage).  On the card
    it resets the allocator's peak at entry and reads it at each
    ``sample()`` and at exit, so allocations between samples count; on
    the CPU it samples ``live_bytes`` at entry, at exit and at each
    ``sample()``."""

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        self.start = self.peak = 0

    def sample(self):
        if self.device.type == "cuda":
            now = torch.cuda.max_memory_allocated(self.device)
        else:
            now = live_bytes(device=self.device)
        self.peak = max(self.peak, now)

    def __enter__(self):
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        self.start = live_bytes(device=self.device)
        self.peak = self.start
        return self

    def __exit__(self, *exc):
        self.sample()
        return False

    def report(self) -> str:
        return (f"live bytes: start {self.start / 1e9:.3f} GB, "
                f"peak {self.peak / 1e9:.3f} GB "
                f"(+{(self.peak - self.start) / 1e9:.3f} GB)")


@contextlib.contextmanager
def assert_no_leak(tol_bytes: int = 1 << 20, device="cuda"):
    """assertAllMemFree for a scope: the bytes in use at exit may exceed
    those at entry by ``tol_bytes`` at most."""
    start = live_bytes(device=device)
    yield
    end = live_bytes(device=device)
    if end - start > tol_bytes:
        raise AssertionError(
            f"live-buffer leak: {start / 1e6:.1f} MB -> "
            f"{end / 1e6:.1f} MB (+{(end - start) / 1e6:.1f} MB)")
