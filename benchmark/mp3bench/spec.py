"""BENCHMARK.json and the files it names, found by name.

A workload `<config>.<traffic>` resolves to the configuration's file (its
`file` in BENCHMARK.json), the traffic mix benchmark/traffic/<traffic>.json,
the entry module mp3bench/entries/<entry>.py that the mix names, and one
reader benchmark/metrics/<metric>.py for each per-layer metric of the cell.
A new configuration, mix or metric is new files and new entries: nothing
here changes.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
from dataclasses import dataclass, field

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)           # benchmark/
ROOT = os.path.dirname(BENCH)           # the checkout


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """One workload of BENCHMARK.json with everything it names."""
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list          # BENCHMARK.json entries this cell reports
    per_layer: list
    root: str = ROOT
    limits: dict = field(default_factory=dict)

    @property
    def entry(self) -> str:
        return self.traffic["entry"]


def _reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, root: str = ROOT) -> Cell:
    """The Cell of `workload`; KeyError names what is missing."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(there are {sorted(cells)})")
    w = cells[workload]
    cfgs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(root, cfgs[w["config"]]["file"]))
    traffic = load_json(traffic_path(w["traffic"], root))
    e2e = [m for m in bench["end_to_end"] if _reports(m, workload)]
    per = [m for m in bench["per_layer"] if _reports(m, workload)]
    limits = dict(config.get("limits", {}))
    limits.update(traffic.get("limits", {}))
    return Cell(name=workload, chips=int(w["chips"]), config=config,
                traffic=traffic, end_to_end=e2e, per_layer=per, root=root,
                limits=limits)


def traffic_path(name: str, root: str = ROOT) -> str:
    return os.path.join(root, "benchmark", "traffic", f"{name}.json")


def metric_path(name: str, root: str = ROOT) -> str:
    return os.path.join(root, "benchmark", "metrics", f"{name}.py")


def load_metric(name: str, root: str = ROOT):
    """The reader module of per-layer metric `name`: read(ctx) -> number or
    None, and optionally instrument(probe)."""
    path = metric_path(name, root)
    spec = importlib.util.spec_from_file_location(
        "mp3bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_entry(name: str):
    """The entry module mp3bench/entries/<name>.py of a traffic mix."""
    return importlib.import_module(f"mp3bench.entries.{name}")
