"""The port's spans and counters (``utils.profiling``) on the MG solve
at 4³×8 on the CPU: nothing is recorded, built or timed while no
profiler records; while one records, the table's calls, roots, counts
and self times follow the solve's structure, and every read of a device
value on the host is counted.  The ``cuda`` test adds the device
seconds and the rule that a span inside a CUDA graph's capture records
nothing; it skips itself without a card."""

import functools
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from quda_qkxtm_multigrid_tpu_torch import benchmarks as bm
from quda_qkxtm_multigrid_tpu_torch.compact import make_compact
from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry
from quda_qkxtm_multigrid_tpu_torch.mg import multigrid as tmg
from quda_qkxtm_multigrid_tpu_torch.solvers.support import defect_correction
from quda_qkxtm_multigrid_tpu_torch.utils import profiling

GT = Geometry(4, 4, 4, 8)
MGP = tmg.MGParams(block=(2, 2, 2, 2), nvec=4, smoother_pc=True)
N_KRYLOV = 5
SOLVERS = ["gcr-pc", "gcr"]


@pytest.fixture(autouse=True)
def _fresh_table():
    profiling.reset()
    yield
    profiling.reset()


@functools.lru_cache(maxsize=None)
def _problem():
    torch.set_num_threads(2)
    d, b = bm.make_problem(GT, "cpu", dtype=torch.complex64)
    mg = tmg.setup_mg(d, MGP, torch.Generator().manual_seed(3))
    return d, b, mg


def _events(prof):
    """(name, start ns, end ns) of every host event of a profile."""
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()]


def _scalar_reads_inside(events, names) -> int:
    """``aten::_local_scalar_dense`` events (a device value read on the
    host) inside the outermost spans called one of ``names``."""
    spans = [(s, e) for n, s, e in events if n in names]
    outer = [(s, e) for s, e in spans
             if not any(s0 < s and e <= e0 for s0, e0 in spans)]
    return sum(1 for n, s, _ in events if n == "aten::_local_scalar_dense"
               and any(s0 <= s <= e0 for s0, e0 in outer))


@functools.lru_cache(maxsize=None)
def _traced_solve(solver: str):
    """(result, table, events) of one traced ``mg_solve``."""
    _, b, mg = _problem()
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = tmg.mg_solve(mg, b, tol=1e-6, n_krylov=N_KRYLOV, solver=solver)
    table = profiling.table()
    profiling.reset()
    return out, table, _events(prof)


def _applies(solver: str, cycles: int, nu_post: int) -> int:
    """Applications of M or M_pc in a solve of ``cycles`` GCR cycles: a
    V-cycle is nu_post MR steps and one residual, a direction one more
    (the GCR's matvec), a cycle one restart residual; "gcr-pc" has an
    initial Schur residual and a final full one, "gcr" an initial one."""
    per_cycle = N_KRYLOV * (nu_post + 2) + 1
    return (2 if solver == "gcr-pc" else 1) + cycles * per_cycle


@pytest.mark.parametrize("solver", SOLVERS)
def test_off_records_and_builds_nothing(solver, monkeypatch):
    """With no profiler a solve leaves the table empty, and no span
    builds a ``record_function``, reads the clock or makes an event."""
    _, b, mg = _problem()

    def refuse(*args, **kwargs):
        raise AssertionError("built while no profiler records")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(profiling, "time",
                        types.SimpleNamespace(perf_counter=refuse))
    out = tmg.mg_solve(mg, b, tol=1e-6, n_krylov=N_KRYLOV, solver=solver)
    assert out.iters > 0
    assert profiling.table() == {"spans": {}, "counters": {}}


CHECKS = ["roots", "vcycles", "host_reads", "applies", "self_times",
          "profiler_names", "scalar_reads"]


@pytest.mark.parametrize("check", CHECKS)
@pytest.mark.parametrize("solver", SOLVERS)
def test_traced_solve(solver, check):
    out, table, events = _traced_solve(solver)
    spans, counters = table["spans"], table["counters"]
    cycles = out.iters // N_KRYLOV
    assert out.iters > 0 and out.iters % N_KRYLOV == 0
    if check == "roots":
        assert spans["mg.solve"]["calls"] == spans["mg.solve"]["roots"] == 1
        assert all(s["roots"] == 0 for n, s in spans.items()
                   if n != "mg.solve")
    elif check == "vcycles":
        assert spans["mg.vcycle"]["calls"] == out.iters
        assert spans["mr"]["calls"] == out.iters
        # the outer cycles and one coarse GCR a V-cycle
        assert spans["gcr.cycle"]["calls"] == cycles + out.iters
        assert (spans["coarse.apply"]["calls"]
                == out.iters * MGP.coarse_nkrylov)
        assert ("mg.precond" in spans) == (solver == "gcr-pc")
    elif check == "host_reads":
        assert counters["host_reads"] == cycles + 2
    elif check == "applies":
        assert counters["op.applies"] == _applies(solver, cycles,
                                                  MGP.nu_post)
    elif check == "self_times":
        for s in spans.values():
            # the children's sum is the inclusive time less the self time
            assert -1e-9 <= s["host_self_s"] <= s["host_s"] + 1e-9
            assert s["device_s"] is None and s["device_self_s"] is None
        # the solve's own reductions and updates are a small part
        assert spans["gcr.cycle"]["host_self_s"] < spans["gcr.cycle"]["host_s"]
    elif check == "profiler_names":
        names = {n for n, _, _ in events}
        assert set(spans) <= names
    elif check == "scalar_reads":
        assert _scalar_reads_inside(events, {"mg.solve"}) == \
            counters["host_reads"]


@functools.lru_cache(maxsize=None)
def _traced_dc():
    """A float64 defect-correction outer on the complex128 operator
    around ``inner_mg``'s complex64 GCR-PC: (table, events, restarts,
    each inner solve's (iterations, cycle cap))."""
    _, _, mg = _problem()
    profiling.reset()
    d_hi, b = bm.make_problem(GT, "cpu", dtype=torch.complex128)
    d_hi.m(b)       # the operator reads its t boundary at its first apply
    inner = tmg.inner_mg(mg, tol=1e-3, n_krylov=3, max_restarts=4)
    each = []

    def solve_lo(r, cap):
        e = inner(r, cap)
        each.append((e.iters, min(4, max(1, cap // 3))))
        return e

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, _, _, st = defect_correction(
            d_hi.m, solve_lo, b, torch.complex64, 1e-9, maxiter=10000,
            max_restarts=12, max_res_increase=1, max_res_increase_total=10)
    table = profiling.table()
    profiling.reset()
    return table, _events(prof), st.restarts, each


@pytest.mark.parametrize("check", ["roots", "host_reads", "applies"])
def test_traced_defect_correction(check):
    table, events, restarts, each = _traced_dc()
    spans, counters = table["spans"], table["counters"]
    assert restarts == len(each) > 1
    if check == "roots":
        assert spans["dc.solve"]["calls"] == spans["dc.solve"]["roots"] == 1
        assert spans["mg.solve"]["calls"] == restarts
        assert spans["mg.solve"]["roots"] == 0
    elif check == "host_reads":
        # an inner solve reads |b|², then |r|² before each cycle and once
        # after the last unless it ran to its cap
        inner = sum(1 + it // 3 + (it // 3 < cap) for it, cap in each)
        assert counters["host_reads"] == 2 * restarts + 2 + inner
        assert _scalar_reads_inside(events, {"dc.solve"}) == \
            counters["host_reads"]
    elif check == "applies":
        # the outer's M a restart; an inner GCR-PC(3) has no final M
        inner = sum(1 + (it // 3) * (3 * (MGP.nu_post + 2) + 1)
                    for it, _ in each)
        assert counters["op.applies"] == restarts + inner


ENTRIES = [("m", 1, "op.m"), ("mdag", 1, "op.m"), ("mdagm", 2, "op.m"),
           ("matpc", 1, "op.matpc"), ("matpc_dagm", 2, "op.matpc"),
           ("a_apply", 0, "op.a_apply")]


@pytest.mark.parametrize("compact", [False, True], ids=["dirac", "compact"])
@pytest.mark.parametrize("entry,applies,name", ENTRIES,
                         ids=[e[0] for e in ENTRIES])
def test_operator_entries(entry, applies, name, compact):
    """Each public entry is one span and counts its applications of M or
    M_pc once, whatever it calls inside; the compact operator's layout
    conversions are spans of their own inside it."""
    d, b, _ = _problem()
    if compact:
        d = make_compact(d.u, d.params, GT, torch.float32)
    pr = d.params.matpc_parity
    args = {"m": (b,), "mdag": (b,), "mdagm": (b,), "matpc": (b[pr],),
            "matpc_dagm": (b[pr],), "a_apply": (b[pr], pr)}[entry]
    with profile(activities=[ProfilerActivity.CPU]):
        getattr(d, entry)(*args)
    table = profiling.table()
    ops = {n: s for n, s in table["spans"].items() if n.startswith("op.")
           and n != "op.layout"}
    assert list(ops) == [name] and ops[name]["calls"] == 1
    assert table["counters"].get("op.applies", 0) == applies
    layout = table["spans"].get("op.layout", {"calls": 0, "roots": 0})
    assert layout["roots"] == 0
    assert (layout["calls"] > 0) == compact


def test_summary_lists_the_spans():
    """``TimeProfile.summary`` prints the recorded spans as categories."""
    prof = profiling.TimeProfile("t")
    with profile(activities=[ProfilerActivity.CPU]):
        with prof.span("outer"):
            with prof.span("inner"):
                prof.count("n", 3)
    lines = prof.summary().splitlines()
    assert {ln.split()[0] for ln in lines[1:]} == {"outer", "inner"}
    t = prof.table()
    assert t["spans"]["outer"]["roots"] == 1 and t["counters"] == {"n": 3}
    assert t["spans"]["inner"]["roots"] == 0
    prof.reset()
    assert prof.table() == {"spans": {}, "counters": {}}


@pytest.mark.cuda
def test_device_seconds_and_graph_capture():
    """On the card: the spans' device seconds (self within inclusive),
    and a span inside ``_cuda_graphed``'s capture records nothing, the
    replay being the span ``mg.coarse_graph``."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    dev = torch.device("cuda", 0)
    d, b = bm.make_problem(Geometry(8, 8, 8, 16), "cuda",
                           dtype=torch.complex64)
    mg = tmg.setup_mg(d, tmg.MGParams(block=(4, 4, 4, 4), nvec=8,
                                      smoother_pc=True),
                      torch.Generator(device=dev).manual_seed(3))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        out = tmg.mg_solve(mg, b, tol=1e-6, n_krylov=N_KRYLOV,
                           solver="gcr-pc")
    spans = profiling.table()["spans"]
    assert spans["mg.vcycle"]["calls"] == out.iters
    for s in spans.values():
        assert s["device_s"] > 0
        assert -1e-6 <= s["device_self_s"] <= s["device_s"] + 1e-6
    assert spans["mg.vcycle"]["device_s"] < spans["mg.solve"]["device_s"]
    profiling.reset()

    def fn(x):
        with profiling.span("probe"):
            profiling.PROFILE.count("probe")
            return x * 2

    like = torch.ones(64, device=dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        replay = tmg._cuda_graphed(fn, like)    # a warm-up call, a capture
        got = replay(like + 1)
    table = profiling.table()
    assert torch.equal(got, (like + 1) * 2)
    assert table["spans"]["probe"]["calls"] == 1      # the warm-up only
    assert table["counters"] == {"probe": 1}
    assert table["spans"]["mg.coarse_graph"]["calls"] == 1
