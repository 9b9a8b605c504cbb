"""Run one cell of ``BENCHMARK.json`` once:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up runs the traffic's unit kind's own preparation (``units/``: for
point solves, the gauge made from the seed on the card, the operator and
the MG set-up) and its warm-up units; ``setup_s`` is the time from the
start of the process to the end of set-up.  The window then runs units
one after another (a closed loop) until ``--seconds`` have passed; the
unit running then finishes, and the window ends with it.  Afterwards the peak memory is read, the program's
state is freed, and the plain reference judges a sample of the window's
answers (``check``).  The last line of standard output is the result;
the numbers compared, each beside its limit, are the last lines of
standard error and the last key of the result.

With ``--trace 0`` the result's metrics are the cell's end-to-end
metrics; with ``--trace 1`` the first ``trace_units`` units of the
window are profiled and the metrics are the cell's per-layer ones
(``metrics/<name>.py``, or the reader of the name's longest dotted
prefix, reads each).  Without a card the run fails.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
import zlib  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "quda_qkxtm_multigrid_tpu")


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def find_cell(spec: dict, name: str) -> dict:
    for cell in spec["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def forbidden_modules() -> list:
    """Modules of JAX or of the JAX package loaded in this process,
    compared by whole top-level names."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def reader_path(name: str) -> Path:
    """The reader of a metric: ``metrics/<name>.py`` or, where there is
    none, that of its longest dotted prefix (``device.idle.dc`` falls
    back on ``device.idle``), so that one reader serves the metric split
    by the end-to-end metric it moves."""
    parts = name.split(".")
    for k in range(len(parts), 0, -1):
        path = HERE / "metrics" / (".".join(parts[:k]) + ".py")
        if path.is_file():
            return path
    raise FileNotFoundError(f"no reader for metric {name!r}")


def _reader(name: str):
    path = reader_path(name)
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _applies(metric: dict, cell: dict) -> bool:
    return "workloads" not in metric or cell["name"] in metric["workloads"]


class Run:
    """What the readers of ``metrics/`` see: ``units`` (a record per
    window unit: ``index``, ``seconds`` and the ``info`` its unit kind
    reports), ``window_s``, ``setup_s`` and, in a traced run, ``trace``
    (``trace.Tracer.result``)."""

    def __init__(self):
        self.units, self.window_s = [], None
        self.setup_s, self.trace = None, None


class Bench:
    """One run of a cell: set-up, window, comparison.  The traffic's
    unit kind (``units/<unit>.py``) does each unit's work; the
    configuration's route (``routes/<route>.py``) is the program."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 use_kernels: bool = True):
        from portbench import mix
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device, self.use_kernels = device, use_kernels
        self.route = importlib.import_module(
            f"portbench.routes.{cfg['route']}")
        self.kind = importlib.import_module(
            f"portbench.units.{traffic['unit']}")
        self.dims = tuple(cfg["lattice"])
        self.run_gauge_seed = mix.run_gauge_seed(traffic, seed)
        self.window_items = mix.items(traffic, self.dims, seed, mix.WINDOW)
        self.warm_items = mix.items(traffic, self.dims, seed, mix.WARMUP)
        self.kept = {}          # comparison → Reservoir of (item, payload)
        self.state = None
        self.run = Run()

    def _sync(self):
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def build(self, gauge_seed: int):
        """The route's state (operator and MG set-up) on the gauge of
        ``gauge_seed``, made on the device."""
        import torch
        from portbench.gauge import config_gauge, derive_seed
        u = config_gauge(self.cfg, gauge_seed, self.device)
        gen = torch.Generator(device=self.device).manual_seed(
            derive_seed(gauge_seed, 1))
        state = self.route.build(self.cfg, u, gen, self.use_kernels)
        del u
        return state

    def setup(self):
        self.state = self.kind.prepare(self)
        for _ in range(self.traffic["warmup_units"]):
            self.unit(next(self.warm_items))
        self._sync()

    def unit(self, item):
        """One unit of the traffic's kind on ``item``: (record, parts)."""
        import torch
        t0 = time.perf_counter()
        with torch.profiler.record_function("portbench.unit"):
            info, parts = self.kind.work(self, self.state, item)
            self._sync()
        rec = {"index": item["index"], "seconds": time.perf_counter() - t0,
               "info": info}
        return rec, parts

    def _keep(self, item, parts: dict):
        from portbench import mix
        for kind, payload in parts.items():
            if kind not in self.kept:
                self.kept[kind] = mix.Reservoir(
                    self.cfg["check_sample"][kind], self.seed,
                    zlib.crc32(kind.encode()))
            self.kept[kind].offer((item, payload))

    def window(self, seconds: float, tracer=None):
        traced = self.traffic["trace_units"] if tracer else 0
        failed = 0
        if tracer:
            tracer.start()
        t0 = time.perf_counter()
        while True:
            item = next(self.window_items)
            try:
                rec, parts = self.unit(item)
            except Exception:       # a unit that raises counts as failed
                traceback.print_exc()
                failed += 1
                rec, parts = None, None
            if rec is not None:
                self.run.units.append(rec)
                self._keep(item, parts)
            del parts
            done = len(self.run.units) + failed
            if tracer and done == traced:
                tracer.stop()
                tracer = None
            if time.perf_counter() - t0 >= seconds:
                break
        if tracer:
            tracer.stop()
        self.run.window_s = time.perf_counter() - t0
        return done, failed

    def release(self):
        import torch
        if self.state is not None:
            self.route.release(self.state)
        self.state = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> list:
        from portbench.check import compare
        return compare(self.cfg, {k: r.kept for k, r in self.kept.items()},
                       self.seed, self.device)


def run_cell(spec: dict, cell: dict, seed: int, seconds: float,
             trace: bool, device, cfg: dict | None = None,
             traffic: dict | None = None, use_kernels: bool = True,
             t_start: float | None = None) -> dict:
    """One run of ``cell``: the result's fields, before printing.  ``cfg``
    and ``traffic`` replace the files the cell names (the tests run a
    tiny lattice on the CPU with ``use_kernels=False``)."""
    import torch
    from portbench.trace import Tracer
    cfg = cfg or load_json(HERE / "configs" / f"{cell['config']}.json")
    traffic = traffic or load_json(HERE / "traffic" /
                                   f"{cell['traffic']}.json")
    if device.type == "cuda":
        torch.zeros(1, device=device)        # the context, then its stats
        torch.cuda.reset_peak_memory_stats(device)
    bench = Bench(cfg, traffic, seed, device, use_kernels)
    bench.setup()
    bench.run.setup_s = time.perf_counter() - (
        _T0 if t_start is None else t_start)
    tracer = Tracer() if trace else None
    attempted, failed = bench.window(seconds, tracer)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    run = bench.run
    if tracer is not None:
        run.trace = tracer.result()
    bench.release()
    numbers = bench.check()
    failed_units = {n[3] for n in numbers if not n[1] <= n[2]}
    failed += len(failed_units)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in spec[kind]:
        if not _applies(m, cell):
            continue
        value = _reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": failed == 0 and attempted > 0,
           "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": {"platform": "gpu" if device.type == "cuda" else "cpu",
                      "kind": (torch.cuda.get_device_name(device)
                               if device.type == "cuda" else "cpu"),
                      "count": cell["chips"],
                      "memory_peak_bytes": peak}}
    if trace:
        out["device"]["busy_s"] = run.trace["busy_s"]
        out["device"]["window_s"] = run.trace["window_s"]
        out["breakdown"] = {"device_ops": run.trace["device_ops"],
                            "idle_gaps": run.trace["idle_gaps"]}
    out["checks"] = {f"{name}.u{idx}": {"value": value, "limit": limit}
                     for name, value, limit, idx in numbers}
    return out


def _power_limit() -> str:
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    spec = load_json(ROOT / "BENCHMARK.json")
    cell = find_cell(spec, args.workload)
    import torch
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "build" / "torch_extensions"))
    out = run_cell(spec, cell, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {found}; the benchmark runs "
              "without JAX and without the JAX package", file=sys.stderr)
        return 3
    print(f"card: {_power_limit()}", file=sys.stderr)
    for name, c in out["checks"].items():
        ok = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"{name} {c['value']:.6e} limit {c['limit']:.1e} {ok}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
