"""Finds a cell's files by the names that BENCHMARK.json gives.

A cell names a configuration (`benchmark/configs/<file>`, named in the
configuration's entry) and a traffic mix (`benchmark/traffic/<mix>.json`).
The mix names the program entry that drives it
(`benchmark/entries/<entry>.py`). Each metric is read by
`benchmark/metrics/<metric name>.py`, and each cell's limits of the
correctness check are in `benchmark/limits/<cell>.json`. A later change
adds a configuration, a mix, a cell or a metric by adding files and
appending entries; nothing here names one.
"""
from __future__ import annotations

import importlib.util
import json
import os
from typing import Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """Everything one run of a cell needs, read from files."""

    def __init__(self, name: str, root: str = ROOT):
        spec = benchmark(root)
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
        self.root = root
        self.workload = cells[name]
        self.name = name
        self.chips = int(self.workload["chips"])
        configs = {c["name"]: c for c in spec["configs"]}
        self.config_entry = configs[self.workload["config"]]
        self.config = load_json(os.path.join(root, self.config_entry["file"]))
        bench = os.path.join(root, "benchmark")
        self.traffic = load_json(os.path.join(bench, "traffic", self.workload["traffic"] + ".json"))
        self.entry = load_module(os.path.join(bench, "entries", self.traffic["entry"] + ".py"),
                                 "bench_entry_" + self.traffic["entry"])
        limits = os.path.join(bench, "limits", name + ".json")
        self.limits: Dict[str, float] = load_json(limits) if os.path.exists(limits) else {}
        self.end_to_end = [m for m in spec["end_to_end"] if self._reports(m)]
        e2e = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in spec["per_layer"]
                          if (name in m["workloads"] if "workloads" in m else m["moves"] in e2e)]
        self.bench_dir = bench

    def _reports(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]

    def reader(self, metric: str):
        return load_module(os.path.join(self.bench_dir, "metrics", metric + ".py"),
                           "bench_metric_" + metric.replace(".", "_"))


def compositor_kernels(root: str = ROOT) -> List[str]:
    """Names (substrings) of the program's hand-written compositor kernels,
    one per line of every file under benchmark/kernels/compositor/."""
    d = os.path.join(root, "benchmark", "kernels", "compositor")
    names = []
    for f in sorted(os.listdir(d)):
        with open(os.path.join(d, f)) as fh:
            names += [ln.strip() for ln in fh if ln.strip() and not ln.startswith("#")]
    return names
