"""A cell's files, found by the names in BENCHMARK.json: its
configuration (`file`), its traffic (`port_bench/traffic/<traffic>.json`),
its limits (`port_bench/limits/<cell>.json`), the task module the traffic
names (`port_bench/steps/<task>.py`) and a reader for each of its metrics
(`port_bench/metrics/<metric>.py`)."""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
from dataclasses import dataclass

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_DIR = os.path.join(ROOT, "port_bench")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list       # BENCHMARK.json entries this cell reports
    per_layer: list

    @property
    def task(self):
        return importlib.import_module(
            f"port_bench.steps.{self.traffic['task']}")


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(workload: str, root: str = ROOT) -> Cell:
    """The cell named `workload`; KeyError if BENCHMARK.json has none."""
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no cell {workload!r}; cells: {sorted(cells)}")
    cell = cells[workload]
    cfg = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    limits_path = os.path.join(BENCH_DIR, "limits", f"{workload}.json")
    return Cell(
        name=workload, chips=int(cell["chips"]),
        config=_json(os.path.join(root, cfg["file"])),
        traffic=_json(os.path.join(BENCH_DIR, "traffic",
                                   f"{cell['traffic']}.json")),
        limits=_json(limits_path) if os.path.exists(limits_path) else {},
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)])


def reader(metric: str):
    """The module of port_bench/metrics/<metric>.py (names hold dots, so
    it is loaded by path)."""
    path = os.path.join(BENCH_DIR, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        f"port_bench.metrics.{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
