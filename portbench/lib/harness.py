"""Cells, runs and the result line.

Everything of a cell is found by name from ``BENCHMARK.json``: its
configuration file, its traffic file (which names its driver,
``portbench/drivers/<driver>.py``), and one reader per per-layer metric,
``portbench/metrics/<family>.py`` with the family the metric name's part
before its first dot. A driver fills a :class:`Run`; the harness reads the
per-layer metrics from it and prints the result.
"""

import importlib
import json
import math
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = ("jax", "jaxlib", "flax", "vectorquantizedcpc_tpu")


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def resolve_cell(bench: dict, workload: str, root: Path = ROOT) -> Tuple[dict, dict, dict]:
    """(cell, configuration, traffic) of the workload named ``workload``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[workload]
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(root / config["file"]) as f:
        config_data = json.load(f)
    with open(root / "portbench" / "traffic" / f"{workload}.json") as f:
        traffic = json.load(f)
    return cell, config_data, traffic


def candidate_cell(bench: dict, workload: str, root: Path = ROOT) -> Tuple[dict, dict, dict]:
    """``resolve_cell``, or for a cell that is not in BENCHMARK.json yet but
    has its traffic file (``<config>.<traffic>.json``), the same on one
    card: for ``readings.py`` and the tests, never for a benchmark run."""
    if any(w["name"] == workload for w in bench["workloads"]):
        return resolve_cell(bench, workload, root)
    config_name, _, traffic_name = workload.partition(".")
    config = next(c for c in bench["configs"] if c["name"] == config_name)
    with open(root / config["file"]) as f:
        config_data = json.load(f)
    with open(root / "portbench" / "traffic" / f"{workload}.json") as f:
        traffic = json.load(f)
    cell = {"name": workload, "config": config_name, "traffic": traffic_name, "chips": 1}
    return cell, config_data, traffic


def cell_metrics(bench: dict, workload: str, kind: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics this cell reports."""
    return [m for m in bench[kind] if workload in m.get("workloads", [workload])]


def driver_module(traffic: dict):
    return importlib.import_module(f"portbench.drivers.{traffic['driver']}")


def reader_module(metric_name: str):
    return importlib.import_module(f"portbench.metrics.{metric_name.split('.')[0]}")


class Check:
    """One number compared with its limit: ``value <= limit`` passes."""

    def __init__(self, name: str, value: float, limit: float):
        self.name, self.value, self.limit = name, float(value), float(limit)

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


class Run:
    """What one run of a cell measured and judged.

    A driver sets ``window_start`` (host clock, ``time.perf_counter``) when
    the timed work begins, the end-to-end values in ``e2e``, the counts in
    ``attempted`` and ``failed``, the judged numbers in ``checks``, and, for
    the per-layer readers, ``counters`` (its own counts and host times),
    ``calls`` (the shapes of the kernel calls it queued inside the traced
    window, by kernel) and ``tracer`` (the traced window's summary).
    """

    def __init__(self, cell: dict, config: dict, traffic: dict, seed: int, seconds: float,
                 trace: bool, device, workdir: Path):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = device
        self.workdir = workdir
        self.window_start: Optional[float] = None
        self.e2e: Dict[str, float] = {}
        self.attempted = 0
        self.failed = 0
        self.checks: List[Check] = []
        self.counters: Dict[str, Any] = {}
        self.calls: Dict[str, List[dict]] = {}
        self.tracer = None
        self.memory_peak_bytes = 0
        self.notes: List[str] = []

    @property
    def name(self) -> str:
        return self.cell["name"]

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(c.ok for c in self.checks) and self.failed == 0

    @property
    def summary(self):
        return None if self.tracer is None else self.tracer.summary

    def note(self, text: str) -> None:
        """A line for standard error, printed before the checks."""
        self.notes.append(text)

    def judged(self, checks: List[Check]) -> None:
        """Store the checks, each with its limit from the traffic's ``limits``
        (a number without one fails)."""
        for c in checks:
            c.limit = float(self.traffic["limits"].get(c.name, c.limit))
        self.checks.extend(checks)


def clock() -> float:
    return time.perf_counter()


def device_sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def peak_memory(device) -> int:
    import torch

    return torch.cuda.max_memory_allocated(device) if torch.device(device).type == "cuda" else 0


def read_per_layer(run: Run, metrics: List[dict]) -> Dict[str, dict]:
    out = {}
    for m in metrics:
        value = reader_module(m["name"]).read(m["name"], run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that a run may not hold, compared whole."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))
