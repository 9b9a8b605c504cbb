"""Timing profiles and the analytic-flops ledger: the counterpart of
the JAX package's ``utils/profiling.py`` (the reference's TimeProfile
and the per-operator analytic flop counts).

``TimeProfile`` sums host seconds, calls and flops per category; it
reads the host clock only, so a caller timing device work synchronises
the device inside the timed region.  ``SolveTelemetry`` is the per-solve
record (iterations, seconds, GFLOP/s) that ``mg.multigrid.mg_solve(
telemetry=True)`` returns.  The JAX package's ``enable_compile_cache``
(an XLA cache) has no counterpart: PyTorch runs eagerly.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict


class TimeProfile:
    """Accumulate wall time and optional flops per category."""

    def __init__(self, name: str = ""):
        self.name = name
        self.seconds = defaultdict(float)
        self.calls = defaultdict(int)
        self.flops = defaultdict(float)

    @contextlib.contextmanager
    def __call__(self, category: str, flops: float = 0.0):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[category] += time.perf_counter() - t0
            self.calls[category] += 1
            self.flops[category] += flops

    def add_flops(self, category: str, n: float):
        self.flops[category] += n

    def summary(self) -> str:
        """One line for the total, then one a category, slowest first,
        with GFLOP/s where flops were counted."""
        total = sum(self.seconds.values())
        lines = [f"TimeProfile {self.name}: total {total:.3f} s"]
        for cat in sorted(self.seconds, key=self.seconds.get, reverse=True):
            s = self.seconds[cat]
            extra = ""
            if self.flops[cat]:
                extra = f"  {self.flops[cat] / max(s, 1e-12) / 1e9:.1f} GF/s"
            lines.append(f"  {cat:24s} {s:9.3f} s  x{self.calls[cat]:5d}"
                         f"{extra}")
        return "\n".join(lines)


# analytic per-site flop counts (the reference's flops ledgers)
FLOPS_PER_SITE = {
    "wilson_dslash": 1320,
    "clover_apply": 504,
    "twist_apply": 48,
    "staggered_dslash": 570,
}


class SolveTelemetry:
    """Per-solve performance record: iterations, seconds, GFLOP/s (the
    reference's per-solve gflops / secs / iter fields)."""

    def __init__(self, iters: int, secs: float, gflops: float):
        self.iters = int(iters)
        self.secs = float(secs)
        self.gflops = float(gflops)

    def __repr__(self):
        return (f"SolveTelemetry(iters={self.iters}, secs={self.secs:.3f}, "
                f"gflops={self.gflops:.1f})")

    def as_dict(self) -> dict:
        return {"iters": self.iters, "secs": round(self.secs, 4),
                "gflops": round(self.gflops, 1)}


def solve_telemetry(dirac, iters: int, secs: float) -> SolveTelemetry:
    """GFLOP/s of a solve from the analytic ledger: one outer-operator
    application (``dirac.flops_per_mat()``) an iteration; the V-cycle's
    work is not counted, as the reference attributes a solver's flops to
    its outer operator."""
    flops = dirac.flops_per_mat() * max(iters, 1)
    return SolveTelemetry(iters, secs, flops / max(secs, 1e-12) / 1e9)
