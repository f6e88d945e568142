"""Find a cell, its configuration, its traffic mix and its metric readers by
name. Nothing here knows a cell, a mix or a metric: a later cell is a new
configuration file, traffic file, metric reader and entries in
BENCHMARK.json.

    configs/<config>.json    the configuration as it is run
    traffic/<mix>.json       the traffic mix's parameters, read by drivers.py
    metrics/<metric>.py      a reader: read(ctx) -> number or None
"""
from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))   # bench_port/
ROOT = os.path.dirname(HERE)                                          # the checkout


class SpecError(Exception):
    pass


def load_benchmark(root: str = ROOT) -> dict:
    path = os.path.join(root, "BENCHMARK.json")
    if not os.path.exists(path):
        raise SpecError(f"no BENCHMARK.json in {root}")
    with open(path) as f:
        return json.load(f)


def _read_json(path: str) -> dict:
    if not os.path.exists(path):
        raise SpecError(f"missing file {path}")
    with open(path) as f:
        return json.load(f)


def traffic_path(name: str, here: str = HERE) -> str:
    return os.path.join(here, "traffic", f"{name}.json")


def metric_path(name: str, here: str = HERE) -> str:
    return os.path.join(here, "metrics", f"{name}.py")


def load_reader(name: str, here: str = HERE):
    """The `read(ctx)` function of metrics/<name>.py."""
    path = metric_path(name, here)
    if not os.path.exists(path):
        raise SpecError(f"no reader for metric {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{len(name)}_{abs(hash(name))}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if not callable(getattr(mod, "read", None)):
        raise SpecError(f"{path} defines no read(ctx)")
    return mod.read


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


class Cell:
    """One entry of `workloads` with what it names, read from its files."""

    def __init__(self, bench: dict, name: str, here: str = HERE):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SpecError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
        self.entry = cells[name]
        self.name = name
        self.chips = int(self.entry["chips"])
        configs = {c["name"]: c for c in bench["configs"]}
        if self.entry["config"] not in configs:
            raise SpecError(f"workload {name!r} names no known config {self.entry['config']!r}")
        self.config_entry = configs[self.entry["config"]]
        self.config = _read_json(os.path.join(os.path.dirname(here),
                                              self.config_entry["file"]))
        self.traffic_name = self.entry["traffic"]
        self.traffic = _read_json(traffic_path(self.traffic_name, here))
        self.end_to_end = [m for m in bench["end_to_end"] if _applies(m, name)]
        self.per_layer = [m for m in bench["per_layer"] if _applies(m, name)]
        self.here = here

    def metrics(self, trace: bool) -> list:
        return self.per_layer if trace else self.end_to_end
