"""The benchmark's harness: finds a cell's files by name, runs its driver,
reads its metrics, and prints the one result line.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything about a cell is data found by name under ``benchmark/``:
``workloads/<cell>.json`` (its configuration, traffic, driver and the
limits of its output check), ``configs/<config>.json``,
``traffic/<traffic>.json``, ``drivers/<driver>.py`` (``run(cell)``) and
``metrics/<metric>.py`` (``read(run)``), the metrics being those that
``BENCHMARK.json`` lists for the cell. A later cell, configuration, mix or
metric is added by adding files and entries.

A driver builds the program's system under test from the cell's files and
the seed, warms up every shape it will use, calls ``cell.begin()`` when
the measured window opens and ``cell.tick()`` after each unit of work,
closes the window, reads the device's memory peak, frees the program's
state and compares what the window produced with the plain reference
(``reference/``). It returns a dict: ``attempted``, ``failed``, ``e2e``
(end-to-end metric values), ``counters`` (what per-layer readers read),
``checks`` (name -> (value, limit)), ``memory_peak_bytes``.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import math
import os
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: top-level modules that may not be loaded in the process that prints
FORBIDDEN = ("jax", "jaxlib", "flax", "fast_srgan_tpu")


def load_json(kind: str, name: str) -> Dict[str, Any]:
    with open(os.path.join(HERE, kind, f"{name}.json")) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``benchmark/<kind>/<name>.py`` as a module (names may hold dots),
    loaded once a process."""
    key = f"benchmark_{kind}_{name.replace('.', '_')}"
    if key not in sys.modules:
        path = os.path.join(HERE, kind, f"{name}.py")
        spec = importlib.util.spec_from_file_location(key, path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        sys.modules[key] = module
    return sys.modules[key]


def benchmark_spec() -> Dict[str, Any]:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def metrics_of(spec: Dict[str, Any], section: str, cell: str) -> List[Dict[str, Any]]:
    """The entries of ``end_to_end`` or ``per_layer`` that the cell reports."""
    return [m for m in spec[section] if cell in m.get("workloads", [cell])]


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


class Spans:
    """Host spans of the benchmark's own calls into the program:
    (name, start, end) in ``time.perf_counter`` seconds, kept in memory."""

    def __init__(self):
        self.items: List[Tuple[str, float, float]] = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.items.append((name, t0, time.perf_counter()))

    def between(self, name: str, t0: float, t1: float) -> List[float]:
        """Durations of the spans called ``name`` that start in [t0, t1)."""
        return [e - s for n, s, e in self.items if n == name and t0 <= s < t1]

    def quarters(self, name: str, t0: float, t1: float) -> str:
        """How many spans called ``name`` start in each quarter of [t0, t1):
        a window that speeds up or slows down shows here."""
        q = (t1 - t0) / 4
        return ", ".join(str(len(self.between(name, t0 + i * q, t0 + (i + 1) * q)))
                         for i in range(4))


class Cell:
    """One run of one cell: its files, the run's arguments, and the window."""

    def __init__(self, name: str, seed: int, seconds: float, trace: bool, device: str,
                 start: float, overrides: Optional[Dict[str, Dict[str, Any]]] = None):
        self.name, self.seed, self.seconds, self.trace = name, int(seed), float(seconds), trace
        self.device = device
        self.start = start
        overrides = overrides or {}
        self.workload = {**load_json("workloads", name), **overrides.get("workload", {})}
        self.config = {**load_json("configs", self.workload["config"]), **overrides.get("config", {})}
        self.traffic = {**load_json("traffic", self.workload["traffic"]), **overrides.get("traffic", {})}
        self.spans = Spans()
        self.window_start: Optional[float] = None
        self.tracer = None
        if trace and device != "cpu":
            from benchmark.trace import Tracer

            self.tracer = Tracer(self.spans, self.workload.get("trace_seconds", 2.0))

    def begin(self) -> float:
        """The window opens: set-up ends here (the tracer starts first, so
        its own start-up stays out of the window)."""
        if self.tracer is not None:
            self.tracer.start()
        self.window_start = time.perf_counter()
        return self.window_start

    def tick(self) -> None:
        if self.tracer is not None:
            self.tracer.tick()

    def end(self) -> None:
        if self.tracer is not None:
            self.tracer.stop()

    def paused(self) -> float:
        """Seconds of the window spent stopping the profiler (0 untraced):
        rates over the window leave them out."""
        return self.tracer.paused_s if self.tracer is not None else 0.0


class Run:
    """What a metric reader reads: the cell, the driver's counters, and the
    trace's summary (None without a traced slice)."""

    def __init__(self, cell: Cell, outcome: Dict[str, Any], trace: Optional[Dict[str, Any]]):
        self.cell, self.outcome, self.trace = cell, outcome, trace
        self.counters = outcome.get("counters", {})


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             start: Optional[float] = None, overrides=None) -> Dict[str, Any]:
    """Run the cell once and return the result object (no printing)."""
    start = time.perf_counter() if start is None else start
    spec = benchmark_spec()
    cell = Cell(name, seed, seconds, trace, device, start, overrides)
    driver_start = time.perf_counter()
    outcome = load_module("drivers", cell.workload["driver"]).run(cell)
    print(f"set-up: {driver_start - start:.3f} s to the driver, then " + ", ".join(
        f"{n[6:]} {e - s:.3f} s" for n, s, e in cell.spans.items if n.startswith("setup.")),
        file=sys.stderr)
    summary = cell.tracer.summary() if cell.tracer is not None else None
    run = Run(cell, outcome, summary)
    metrics: Dict[str, Dict[str, Any]] = {}
    if not trace:
        values = dict(outcome["e2e"], setup_s=cell.window_start - start)
        for m in metrics_of(spec, "end_to_end", name):
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        for m in metrics_of(spec, "per_layer", name):
            value = load_module("metrics", m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info: Dict[str, Any] = {"platform": "gpu" if device != "cpu" else "cpu",
                                   "kind": device_kind(device),
                                   "count": int(cell.workload.get("chips", 1)),
                                   "memory_peak_bytes": outcome["memory_peak_bytes"]}
    result: Dict[str, Any] = {"correct": None, "attempted": outcome["attempted"],
                              "failed": outcome["failed"], "metrics": metrics,
                              "device": device_info}
    if summary is not None:
        device_info["busy_s"] = summary["busy_s"]
        device_info["window_s"] = summary["window_s"]
        result["breakdown"] = summary["breakdown"]
    checks = {k: {"value": v, "limit": lim} for k, (v, lim) in outcome["checks"].items()}
    result["correct"] = bool(checks) and outcome["failed"] == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    result["checks"] = checks
    return result


def device_kind(device: str) -> str:
    if device == "cpu":
        return "cpu"
    import torch

    return torch.cuda.get_device_name(torch.device(device))


def _card_error(chips: int) -> Optional[str]:
    import torch

    if not torch.cuda.is_available():
        return "no CUDA card: torch.cuda.is_available() is False; the benchmark runs only on the card"
    if torch.cuda.device_count() < chips:
        return f"the cell needs {chips} CUDA cards, this machine has {torch.cuda.device_count()}"
    return None


def main(argv: Optional[List[str]] = None, start: Optional[float] = None) -> int:
    start = time.perf_counter() if start is None else start
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    workload = load_json("workloads", args.workload)
    if not os.path.isdir(os.path.join(ROOT, "fast_srgan_torch")):
        print(f"the program under test, fast_srgan_torch, is not in {ROOT}", file=sys.stderr)
        return 2
    error = _card_error(int(workload.get("chips", 1)))
    if error:
        print(error, file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", start)
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded in this process: {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r}) {verdict}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
