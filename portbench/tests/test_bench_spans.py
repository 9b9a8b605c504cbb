"""The readers of the program's spans and counters on a traced run of
each solve cell at 4×4×4×8 on the CPU (``use_kernels=False``): the
counters a solve read what the solves' structure gives, every read of a
device value on the host inside a solve is counted, and the readers of
device seconds have nothing to read without a card."""

import time

import pytest
import torch
from torch.autograd import DeviceType

from portbench import run as run_mod
from portbench.tests.tiny import tiny
from portbench.trace import Tracer


def _traced(monkeypatch, name):
    """(result, the readers' ``Run``, the traced stretch's host events)
    of a traced run whose window is the traced stretch."""
    from quda_qkxtm_multigrid_tpu_torch.utils import profiling
    spec, cell, cfg, traffic = tiny(name)
    traffic = dict(traffic, trace_units=10**6)
    got = {}
    result, reader = Tracer.result, run_mod._reader

    def keep_events(self):
        got["events"] = [
            (e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in self.prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CPU]
        return result(self)

    def keep_run(metric):
        read = reader(metric)

        def kept(run):
            got["run"] = run
            return read(run)
        return kept

    monkeypatch.setattr(Tracer, "result", keep_events)
    monkeypatch.setattr(run_mod, "_reader", keep_run)
    profiling.reset()
    out = run_mod.run_cell(spec, cell, 2**33 + 5, 0.5, True,
                           torch.device("cpu"), cfg=cfg, traffic=traffic,
                           use_kernels=False, t_start=time.perf_counter())
    profiling.reset()
    assert out["correct"], out["checks"]
    return out, cfg, got["run"], got["events"]


def _reads_inside(events, name) -> int:
    """``aten::_local_scalar_dense`` events inside the spans ``name``
    opened inside no other span of that name."""
    spans = [(s, e) for n, s, e in events if n == name]
    outer = [(s, e) for s, e in spans
             if not any(s0 < s and e <= e0 for s0, e0 in spans)]
    return sum(1 for n, s, _ in events if n == "aten::_local_scalar_dense"
               and any(s0 <= s <= e0 for s0, e0 in outer))


def test_mg_solves_counters(monkeypatch):
    """``operator.applies.solve`` and ``host_reads.solve`` against the
    mean outer iterations of the same run: GCR-PC(n_k) with a V-cycle of
    nu_post MR steps and one residual, a direction one matvec more, a
    cycle one restart residual, and an initial and a final residual; a
    read of |b|² and one of |r|² before each cycle and after the last."""
    out, cfg, run, events = _traced(monkeypatch, "tmc32.mg_solves")
    m = {k: v["value"] for k, v in out["metrics"].items()}
    nk, nu = cfg["solve"]["n_krylov"], cfg["mg"]["nu_post"]
    cycles = m["mg.outer_iters"] / nk
    assert m["operator.applies.solve"] == pytest.approx(
        2 + cycles * (nk * (nu + 2) + 1))
    assert m["host_reads.solve"] == pytest.approx(cycles + 2)
    solves = sum(u["info"]["solves"] for u in run.units)
    assert _reads_inside(events, "mg.solve") == round(
        m["host_reads.solve"] * solves)
    assert "vcycle.device_s.solve" not in m
    assert "krylov.self_device_s.solve" not in m


def test_dc_solves_counters(monkeypatch):
    """``operator.applies.dc`` and ``host_reads.dc``: the float64 outer's
    M a restart and each inner GCR-PC(n_k) (no final residual) with the
    V-cycle's nu_post MR steps and residual; every host read inside the
    defect-correction solves counted."""
    out, cfg, run, events = _traced(monkeypatch, "tmc48.dc_solves")
    m = {k: v["value"] for k, v in out["metrics"].items()}
    nk, nu = cfg["solve"]["n_krylov"], cfg["mg"]["nu_post"]
    solves = sum(u["info"]["solves"] for u in run.units)
    restarts = sum(u["info"]["restarts"] for u in run.units)
    inner_iters = sum(u["info"]["inner_iters"] for u in run.units)
    assert m["operator.applies.dc"] * solves == pytest.approx(
        2 * restarts + inner_iters / nk * (nk * (nu + 2) + 1))
    assert m["host_reads.dc"] * solves == pytest.approx(
        _reads_inside(events, "dc.solve"))
    assert m["host_reads.dc"] >= 2 * restarts / solves + 2
    for name in ("vcycle.device_s.dc", "krylov.self_device_s.dc",
                 "layout.device_s.dc"):
        assert name not in m


def test_readers_without_a_trace():
    """An untraced run has nothing for the span readers to read."""
    run = run_mod.Run()
    for name in ("vcycle.device_s.solve", "krylov.self_device_s.dc",
                 "operator.applies.solve", "host_reads.dc",
                 "layout.device_s.dc"):
        assert run_mod._reader(name)(run) is None
