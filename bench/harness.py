"""The benchmark's harness, driven by data.

`BENCHMARK.json` at the root names the cells and the metrics. Each name is
found as a file of its own: a cell's limits in `workloads/<cell>.json`, a
configuration in `configs/<config>.json`, a traffic mix in
`traffic/<traffic>.json` (whose `driver` names the module under this
folder that runs it), and each metric's reader in `metrics/<metric>.py`,
a `read(record)` that returns a number, or None where the run gave it
nothing to read.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Refused(Exception):
    """A run that must print no result (exit code `code`)."""

    def __init__(self, msg: str, code: int):
        super().__init__(msg)
        self.code = code


def load_json(path: pathlib.Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


class Cell:
    """One entry of BENCHMARK.json's `workloads` with the files its names
    point at, under `bench` (this folder, or a copy of it)."""

    def __init__(self, name: str, spec: dict, bench=HERE):
        self.bench = pathlib.Path(bench)
        entry = [w for w in spec["workloads"] if w["name"] == name]
        if not entry:
            raise Refused(f"no workload named {name!r} in BENCHMARK.json", 2)
        self.name, self.entry, self.spec = name, entry[0], spec
        self.chips = int(self.entry["chips"])
        self.config = load_json(self.bench / "configs"
                                / f"{self.entry['config']}.json")
        self.traffic = load_json(self.bench / "traffic"
                                 / f"{self.entry['traffic']}.json")
        self.limits = load_json(self.bench / "workloads"
                                / f"{name}.json")["limits"]

    def metrics(self, trace: bool) -> list:
        """The metric entries this cell reports: end-to-end ones untraced,
        per-layer ones traced."""
        group = self.spec["per_layer" if trace else "end_to_end"]
        return [m for m in group
                if self.name in m.get("workloads", [self.name])]

    def driver(self):
        return importlib.import_module(f"bench.{self.traffic['driver']}")


def reader(name: str, bench=HERE):
    """The `read` function of metrics/<name>.py."""
    path = pathlib.Path(bench) / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the port must not load."""
    return sorted({m for m in sys.modules
                   if m.partition(".")[0] in FORBIDDEN})


def result(cell: Cell, rec: dict, trace: bool, device: dict) -> dict:
    """The result line: correct, attempted, failed, metrics, device,
    breakdown when traced, and the numbers compared, last."""
    verdict = rec["verdict"]
    metrics = {}
    for m in cell.metrics(trace):
        value = reader(m["name"], cell.bench)(dict(rec, config=cell.config))
        if value is not None:
            if not math.isfinite(value):
                raise Refused(f"metric {m['name']} reads {value}", 6)
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line = {"correct": bool(verdict["correct"]),
            "attempted": int(rec["attempted"]),
            "failed": 0 if verdict["correct"] else 1,
            "metrics": metrics, "device": device}
    if trace:
        t = rec.get("trace")
        if not t or t["busy_s"] <= 0:
            raise Refused("the traced slice recorded no device operation", 6)
        device["busy_s"], device["window_s"] = t["busy_s"], t["window_s"]
        line["breakdown"] = {"device_ops": t["top_ops"],
                             "idle_gaps": t["idle_gaps"]}
    line["compared"] = verdict["numbers"]
    return line


def compared_lines(verdict: dict) -> list:
    return [f"compared {name} {v['value']!r} limit {v['limit']!r}"
            for name, v in verdict["numbers"].items()] + \
        [f"correct {verdict['correct']}"]
