"""``BENCHMARK.json`` and the files it names.

A cell (an entry of ``workloads``) resolves by name to its configuration's
scene file (``configs``' ``file``), its traffic mix
(``benchmark/traffic/<traffic>.json``) and the metrics it reports: every
end-to-end or per-layer metric whose ``workloads`` lists it, or that has
no ``workloads`` key.  Each metric is read by ``benchmark/metrics/<name>.py``
(``read(run)``, ``harness.Run``), so a later cell, mix or metric adds
files and never edits one.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_DIR = os.path.join(ROOT, "benchmark")
SPEC_PATH = os.path.join(ROOT, "BENCHMARK.json")


@dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config_path: str      # absolute path of its scene file
    traffic_name: str
    traffic: dict         # the traffic mix's parameters
    end_to_end: tuple     # metric entries this cell reports with --trace 0
    per_layer: tuple      # ... with --trace 1


def load_spec(path: str = SPEC_PATH) -> dict:
    with open(path) as f:
        return json.load(f)


def traffic_path(name: str) -> str:
    return os.path.join(BENCH_DIR, "traffic", f"{name}.json")


def metric_path(name: str) -> str:
    return os.path.join(BENCH_DIR, "metrics", f"{name}.py")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(spec: dict, name: str) -> Cell:
    """The cell called ``name``; KeyError names what is missing."""
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    configs = {c["name"]: c for c in spec["configs"]}
    if w["config"] not in configs:
        raise KeyError(f"workload {name!r}: no config {w['config']!r}")
    with open(traffic_path(w["traffic"])) as f:
        traffic = json.load(f)
    return Cell(
        name=name, chips=int(w["chips"]),
        config_path=os.path.join(ROOT, configs[w["config"]]["file"]), traffic_name=w["traffic"],
        traffic=traffic,
        end_to_end=tuple(m for m in spec["end_to_end"] if _reports(m, name)),
        per_layer=tuple(m for m in spec["per_layer"] if _reports(m, name)),
    )


def load_reader(name: str):
    """The ``read(run)`` function of metric ``name``'s reader file."""
    path = metric_path(name)
    mod_spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read
