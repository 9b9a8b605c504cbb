"""What a traced run reads: the profiler's device activity and the
launches of the hop kernels.

``Tracer`` profiles a stretch of the window with ``torch.profiler``
(CPU and CUDA) and, over the same stretch, counts every call into the
port's kernel library at its C entry points (``_build.load_library()``,
the boundary between the kernel wrappers and the kernels), with the
bytes that the byte model (``hopbytes``) gives each launch from its
arguments.  It works out the device's busy seconds (the union of every
kernel, copy and set on the card), the device time by kernel name, and
the idle gaps with what the host was doing in each.
"""

from __future__ import annotations

import heapq
import time
from collections import defaultdict

import numpy as np

from portbench.hopbytes import FORM_BYTES, hop_bytes

# argument positions of the entry points (quda_qkxtm_multigrid_tpu_torch/
# _build.py): K1's (psi, g, cinv, x, out, out2, T, Z, W, Xh, parity,
# dagger, recon12, twist, ta, tb, clover, xpay, xc, post, pa, pb, stream);
# the multi-source one has n after out2
_K1 = dict(n=None, T=6, Z=7, W=8, recon12=12, clover=16, xpay=17, post=19,
           cinv=2)
_K2 = dict(n=6, T=7, Z=8, W=9, recon12=13, clover=17, xpay=18, post=20,
           cinv=2)


def _launch_bytes(entry: str, args) -> int | None:
    """Bytes of one launch of ``qkx_dslash_ch_<form>`` or
    ``qkx_dslash_ch_msrc_<form>``; None for any other entry point."""
    if entry.startswith("qkx_dslash_ch_msrc_"):
        form, pos = entry[len("qkx_dslash_ch_msrc_"):], _K2
    elif entry.startswith("qkx_dslash_ch_"):
        form, pos = entry[len("qkx_dslash_ch_"):], _K1
    else:
        return None
    if form not in FORM_BYTES:
        return None
    recon = 8 if form == "f32_r8" else (12 if args[pos["recon12"]] else 18)
    n = 1 if pos["n"] is None else int(args[pos["n"]])
    sites = int(args[pos["T"]]) * int(args[pos["Z"]]) * int(args[pos["W"]])
    return hop_bytes(form, sites, n, recon,
                     bool(args[pos["clover"]]) and args[pos["cinv"]]
                     is not None, bool(args[pos["xpay"]]),
                     int(args[pos["post"]]))


class LaunchTally:
    """Counts the calls into the kernel library's entry points while it is
    installed: launches and bytes by entry point, and launches of entry
    points the byte model has no count for."""

    def __init__(self):
        self.launches = defaultdict(int)
        self.bytes = defaultdict(int)
        self.unknown = 0
        self._saved = {}

    def install(self):
        try:
            from quda_qkxtm_multigrid_tpu_torch import _build
        except ImportError:
            return
        if not _build.library_dir().exists():
            return      # no card: the plain versions run, nothing launches
        lib = _build.load_library()
        for entry in _build.ENTRY_POINTS:
            fn = getattr(lib, entry)
            self._saved[entry] = fn
            setattr(lib, entry, self._wrap(entry, fn))
        self._lib = lib

    def remove(self):
        for entry, fn in self._saved.items():
            setattr(self._lib, entry, fn)
        self._saved = {}

    def _wrap(self, entry, fn):
        def counted(*args):
            nbytes = _launch_bytes(entry, args)
            self.launches[entry] += 1
            if nbytes is None:
                self.unknown += 1
            else:
                self.bytes[entry] += nbytes
            return fn(*args)
        return counted


def _merge(intervals: np.ndarray) -> np.ndarray:
    """Union of [start, end) rows, sorted and merged."""
    if len(intervals) == 0:
        return intervals.reshape(0, 2)
    iv = intervals[np.argsort(intervals[:, 0])]
    out = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.array(out)


def _short(name: str) -> str:
    """A kernel's name without its argument list."""
    cut = name.find("(")
    return name if cut < 0 else name[:cut]


class Tracer:
    """Profile from ``start()`` to ``stop()``; then ``result()``."""

    def __init__(self):
        self.tally = LaunchTally()
        self.prof = None

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.tally.install()
        self.t0 = time.perf_counter()

    def stop(self):
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self.t0
        self.tally.remove()
        self.prof.__exit__(None, None, None)

    def result(self) -> dict:
        """``busy_s``, ``window_s``, ``kernels`` ({name: device seconds}),
        ``device_ops`` (the ten kernels with the most device time) and
        ``idle_gaps`` (every gap between device activity, summed by the
        host event it fell in; the ten largest sums, seconds),
        the tally's ``hop_launches``, ``hop_bytes``, ``unknown_launches``."""
        from torch.autograd import DeviceType
        events = self.prof.profiler.kineto_results.events()
        dev, cpu, names = [], [], defaultdict(float)
        for e in events:
            start, dur = e.start_ns(), e.duration_ns()
            if e.is_user_annotation() or e.name().startswith("portbench."):
                # a span of the benchmark's own, mirrored on the card's
                # timeline by the profiler: not device work
                if e.device_type() == DeviceType.CPU:
                    cpu.append((start, start + dur, e.name()))
                continue
            if e.device_type() == DeviceType.CUDA:
                dev.append((start, start + dur))
                names[e.name()] += dur * 1e-9
            elif e.device_type() == DeviceType.CPU and dur > 0:
                cpu.append((start, start + dur, e.name()))
        busy = _merge(np.array(dev, dtype=np.float64).reshape(-1, 2))
        busy_s = float((busy[:, 1] - busy[:, 0]).sum()) * 1e-9
        by_host = defaultdict(float)
        if len(busy) > 1:
            gaps = np.stack([busy[:-1, 1], busy[1:, 0]], axis=1)
            cpu.sort(key=lambda c: c[0])
            live, k = [], 0      # a max-heap by start of the events begun
            for s, e in gaps:
                mid = 0.5 * (s + e)
                while k < len(cpu) and cpu[k][0] <= mid:
                    heapq.heappush(live, (-cpu[k][0], cpu[k][1], cpu[k][2]))
                    k += 1
                # the innermost host event around the gap's middle: the
                # latest to start that has not ended (the middles rise,
                # so an event ended here has ended for every later gap)
                while live and live[0][1] < mid:
                    heapq.heappop(live)
                name = live[0][2] if live else "no host activity traced"
                by_host[name] += float(e - s) * 1e-9
        kernels = {}
        for name, secs in names.items():
            kernels[_short(name)] = kernels.get(_short(name), 0.0) + secs
        top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
        idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:10]
        return {"busy_s": busy_s, "window_s": self.window_s,
                "kernels": kernels,
                "device_ops": [[k, v] for k, v in top],
                "idle_gaps": [[k, v] for k, v in idle],
                "hop_launches": dict(self.tally.launches),
                "hop_bytes": dict(self.tally.bytes),
                "unknown_launches": self.tally.unknown}
