"""Resolve a cell of ``BENCHMARK.json`` to its files, and shape its result.

A cell names a configuration (``configs/<config>.json``) and a traffic mix
(``mixes/<traffic>.json``). The mix names its driver
(``drivers/<driver>.py``), which runs the window and returns a
:class:`Run`. Each per-layer metric is a reader ``metrics/<name>.py`` with a
function ``read(run) -> float | None``; a reader that finds nothing to
read returns None and the metric is left out of the line.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
from pathlib import Path
from typing import Any, Optional

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent

# Top-level module names that must never be loaded by a run (compared whole,
# since the port's name begins with the JAX package's).
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(spec: dict, workload: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def config_entry(spec: dict, name: str) -> dict:
    for c in spec["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def load_config(spec: dict, name: str, root: Path = ROOT) -> dict:
    return json.loads((root / config_entry(spec, name)["file"]).read_text())


def mix_path(traffic: str) -> Path:
    return PKG / "mixes" / f"{traffic}.json"


def load_mix(traffic: str) -> dict:
    return json.loads(mix_path(traffic).read_text())


def _load_file(path: Path, modname: str):
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    s = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod


def driver_path(driver: str) -> Path:
    return PKG / "drivers" / f"{driver}.py"


def load_driver(driver: str):
    return _load_file(driver_path(driver), f"perfbench_driver_{driver}")


def metric_path(name: str) -> Path:
    return PKG / "metrics" / f"{name}.py"


def load_metric(name: str):
    return _load_file(metric_path(name), "perfbench_metric_" + name.replace(".", "_"))


def metrics_for(spec: dict, kind: str, workload: str) -> list[dict]:
    """The cell's ``end_to_end`` or ``per_layer`` metrics: those without a
    ``workloads`` key, and those that list the cell."""
    return [m for m in spec[kind]
            if "workloads" not in m or workload in m["workloads"]]


@dataclasses.dataclass
class Run:
    """What a driver hands back: its end-to-end numbers, what the readers
    read, and the comparison that decides ``correct``."""

    end_to_end: dict[str, float]
    attempted: int
    failed: int
    checks: list[tuple[str, float, float]]  # (name, value, limit): value <= limit
    memory_peak_bytes: int
    facts: dict[str, Any] = dataclasses.field(default_factory=dict)
    trace: Optional[Any] = None  # trace.Window of a --trace 1 run

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(
            math.isfinite(v) and v <= lim for _n, v, lim in self.checks)


def check_line(run: Run) -> dict:
    return {n: {"value": v, "limit": lim} for n, v, lim in run.checks}


def result_line(spec: dict, workload: str, run: Run, trace: bool,
                device: dict) -> dict:
    metrics = {}
    if not trace:
        for m in metrics_for(spec, "end_to_end", workload):
            if m["name"] in run.end_to_end:
                metrics[m["name"]] = {"value": run.end_to_end[m["name"]], "unit": m["unit"]}
    else:
        for m in metrics_for(spec, "per_layer", workload):
            v = load_metric(m["name"]).read(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    line = {"correct": run.correct, "attempted": run.attempted, "failed": run.failed,
            "metrics": metrics, "device": device}
    if trace and run.trace is not None:
        line["breakdown"] = run.trace.breakdown()
    line["checks"] = check_line(run)  # last key: each compared number and its limit
    return line


def forbidden_loaded(modules) -> list[str]:
    return sorted({m for m in modules if m.split(".", 1)[0] in FORBIDDEN_MODULES})
