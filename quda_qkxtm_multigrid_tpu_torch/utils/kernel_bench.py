"""Helpers of the kernel checks and timings (``chip_smoke.py``,
``time_kernels.py`` and the CPU tests of the box hop): the box of one
rank of a process grid cut from a whole field, with the faces its
exchange would receive, so that one process stands in for the grid; and
the CUDA-graph timer, which gives a kernel's time on the card without
its wrapper's host time.

The module imports torch and the standard library only:
``time_kernels.py`` loads it by path beside checkouts that predate it.
"""

from __future__ import annotations

import statistics

import torch


def virtual_box(field_ch: torch.Tensor, grid, coords, xh: int):
    """The box of the rank at ``coords`` = (it, iz, iw) of ``grid`` =
    (Gt, Gz, Gw) cut from a whole channel field [T, C, Z, W], with the
    faces that rank's exchange would receive: (box, face_m, face_p,
    zw_faces) as ``parallel.halo.box_faces`` returns them, each
    contiguous.  The t faces always (on a ring of one, the box's own
    edge planes); ``zw_faces`` = (z−1, z+1, y−1, y+1), the z planes
    [T_loc, C, 1, W_loc] and the y rows [T_loc, C, Z_loc, xh] (entries k
    of the merged axis), None for an axis the grid does not split."""
    T, _, Z, W = field_ch.shape
    tl, zl, wl = T // grid[0], Z // grid[1], W // grid[2]
    t0, z0, w0 = coords[0] * tl, coords[1] * zl, coords[2] * wl
    dev = field_ch.device
    t_idx = torch.arange(t0, t0 + tl, device=dev)
    z_idx = torch.arange(z0, z0 + zl, device=dev)
    w_idx = torch.arange(w0, w0 + wl, device=dev)

    def cut(ts, zs, ws):
        return field_ch.index_select(0, ts % T).index_select(
            2, zs % Z).index_select(3, ws % W).contiguous()
    one = torch.ones(1, dtype=torch.long, device=dev)
    zw = [None] * 4
    if grid[1] > 1:
        zw[0] = cut(t_idx, (z0 - 1) * one, w_idx)
        zw[1] = cut(t_idx, (z0 + zl) * one, w_idx)
    if grid[2] > 1:
        row = torch.arange(xh, device=dev)
        zw[2] = cut(t_idx, z_idx, w0 - xh + row)
        zw[3] = cut(t_idx, z_idx, w0 + wl + row)
    return (cut(t_idx, z_idx, w_idx), cut((t0 - 1) * one, z_idx, w_idx),
            cut((t0 + tl) * one, z_idx, w_idx), tuple(zw))


def graph_turns(fns: dict, n=20, reps: int = 5) -> dict:
    """Median ms a call of each callable of ``fns`` on the card alone:
    ``n`` calls (an int, or {name: int}) captured in one CUDA graph after
    a warm-up call, the graphs replayed in turns ``reps`` times between
    CUDA events, so the wrappers' host time does not enter."""
    counts = n if isinstance(n, dict) else {k: n for k in fns}
    graphs = {}
    for k, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        graphs[k] = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graphs[k]):
            for _ in range(counts[k]):
                fn()
        graphs[k].replay()
    times = {k: [] for k in fns}
    for _ in range(reps):
        for k, g in graphs.items():
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            g.replay()
            stop.record()
            stop.synchronize()
            times[k].append(start.elapsed_time(stop) / counts[k])
    del graphs
    return {k: statistics.median(t) for k, t in times.items()}
