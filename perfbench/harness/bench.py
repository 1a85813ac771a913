"""One run of one cell: find its files by name, drive it, read its
metrics and build the result line.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``. Its files:

* ``perfbench/workloads/<cell>.json``: the driver, the warm-up, the
  traced sub-window's length, the sample that decides ``correct`` and the
  limits of each number compared;
* ``perfbench/configs/<config>.json``: the model configuration;
* ``perfbench/traffic/<traffic>.json``: the traffic's parameters;
* ``perfbench/drivers/<driver>.py``: ``run(run)`` sets up, measures and
  checks (one loop a kind of traffic);
* ``perfbench/metrics/<metric>.py``: ``read(run)`` gives the metric, or
  None where this run has nothing to read.

A metric belongs to a cell where its ``workloads`` names the cell or,
without that key, where the cell reports the end-to-end metric it moves.
So a new cell, configuration, traffic mix, driver or metric is a new file
and new entries in ``BENCHMARK.json``, and no existing file changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Any

ROOT = Path(__file__).resolve().parents[2]
# Top-level module names the measured process must never hold: the JAX
# package the port was made from, and JAX itself. Compared whole, since
# the port's own name begins with the JAX package's.
FORBIDDEN = ("jax", "jaxlib", "flax", "rcvpose_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    root: Path
    chips: int
    workload: dict
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


@dataclasses.dataclass
class Run:
    """What a driver gets, and what it fills in for the readers."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: Any
    t0: float                       # the process's start, perf_counter
    control: bool = False
    overrides: dict = dataclasses.field(default_factory=dict)
    setup_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    window: dict = dataclasses.field(default_factory=dict)
    events: list = dataclasses.field(default_factory=list)
    device_events: list = dataclasses.field(default_factory=list)
    counters: dict = dataclasses.field(default_factory=dict)
    checks: list = dataclasses.field(default_factory=list)
    memory_peak_bytes: int = 0
    notes: dict = dataclasses.field(default_factory=dict)

    def note(self, key, value):
        """A number printed on standard error, not a metric."""
        self.notes[key] = value

    def setup_done(self):
        """Close set-up: record ``setup_s`` and check that set-up loaded
        no forbidden module."""
        self.setup_s = time.perf_counter() - self.t0
        found = forbidden_modules()
        if found:
            print(f"perfbench: set-up loaded {found}", file=sys.stderr)
            raise SystemExit(3)


def _json(path):
    with open(path) as f:
        return json.load(f)


def load_cell(name, root=ROOT):
    """The cell ``name`` with its files and its metrics."""
    bench = _json(Path(root) / "BENCHMARK.json")
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    entry = found[0]
    pb = Path(root) / "perfbench"
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    moves = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in moves)]
    return Cell(name=name, root=Path(root), chips=entry["chips"],
                workload=_json(pb / "workloads" / f"{name}.json"),
                config=_json(pb / "configs" / f"{entry['config']}.json"),
                traffic=_json(pb / "traffic" / f"{entry['traffic']}.json"),
                end_to_end=e2e, per_layer=per_layer)


def _module(root, kind, name):
    path = Path(root) / "perfbench" / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench.{kind}.{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules():
    """Loaded modules whose top-level name is forbidden."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def drive(run):
    """Run the cell's driver on ``run``; returns ``run``."""
    _module(run.cell.root, "drivers", run.cell.workload["driver"]).run(run)
    return run


def result(run, device_kind):
    """The result line's object, and the lines for standard error."""
    specs = run.cell.per_layer if run.trace else run.cell.end_to_end
    metrics = {}
    for m in specs:
        value = _module(run.cell.root, "metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device = {"platform": "gpu" if run.device.type == "cuda" else "cpu",
              "kind": device_kind, "count": run.cell.chips,
              "memory_peak_bytes": int(run.memory_peak_bytes)}
    out = {"correct": all(v <= lim for _, v, lim in run.checks)
           and run.failed == 0 and bool(run.checks),
           "attempted": run.attempted, "failed": run.failed,
           "metrics": metrics, "device": device}
    if run.trace:
        from perfbench.harness import trace

        device["busy_s"] = trace.busy_ns(run.device_events) / 1e9
        device["window_s"] = trace.window_ns(run.device_events) / 1e9
        out["breakdown"] = {
            "device_ops": trace.breakdown(run.device_events)["device_ops"],
            "idle_gaps": trace.breakdown(run.events)["idle_gaps"]}
    out["checks"] = {name: {"value": v, "limit": lim}
                     for name, v, lim in run.checks}
    lines = [f"{k}: {v}" for k, v in run.notes.items()]
    lines += [f"check {name}: {v!r} limit {lim!r}"
              + ("" if v <= lim else "  FAILED")
              for name, v, lim in run.checks]
    return out, lines
