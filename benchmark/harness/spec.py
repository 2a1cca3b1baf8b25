"""Finding a cell's pieces by name.

`BENCHMARK.json` at the root of the checkout names the cells, the
configurations and the metrics. Each piece sits in a file of its own under
`benchmark/`, found by the name there:

- a configuration: `configs/<config>.json` (its `file` in BENCHMARK.json);
- a traffic mix: `traffic/<traffic>.json`, parameters that the one general
  generator (`harness.drive`) reads;
- the limits of the comparison that decides `correct`: `limits/<cell>.json`;
- a metric: `metrics/<metric>.py`, a reader with `read(run) -> float | None`.

A cell, a mix or a metric is added by adding files and entries, with no
edit of a file that is there.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Spec:
    """BENCHMARK.json and the files of one cell."""

    def __init__(self, root: str = ROOT, bench_dir: Optional[str] = None):
        self.root = root
        self.bench_dir = bench_dir or os.path.join(root, "benchmark")
        self.bench = load_json(os.path.join(root, "BENCHMARK.json"))

    def workload(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config_entry(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                return c
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        return load_json(os.path.join(self.root,
                                      self.config_entry(name)["file"]))

    def traffic(self, name: str) -> dict:
        return load_json(os.path.join(self.bench_dir, "traffic",
                                      f"{name}.json"))

    def limits(self, workload: str) -> dict:
        return load_json(os.path.join(self.bench_dir, "limits",
                                      f"{workload}.json"))

    def metrics_of(self, workload: str, kind: str) -> list:
        """The entries of `end_to_end` or `per_layer` that this cell
        reports: those whose `workloads` list it, or that list none."""
        return [m for m in self.bench[kind]
                if workload in m.get("workloads", [workload])]

    def reader(self, metric: str):
        """The `read` function of metrics/<metric>.py."""
        path = os.path.join(self.bench_dir, "metrics", f"{metric}.py")
        mod_spec = importlib.util.spec_from_file_location(
            "bench_metric_" + metric.replace(".", "_").replace("-", "_"),
            path)
        mod = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(mod)
        return mod.read


def dataclass_from_dict(default, values: dict):
    """A frozen dataclass equal to `default` with every field that `values`
    names set from it: nested dataclasses recursively, lists as tuples.
    Refuses a key the dataclass does not have."""
    fields = {f.name for f in dataclasses.fields(default)}
    unknown = set(values) - fields
    if unknown:
        raise KeyError(f"{type(default).__name__} has no field "
                       f"{sorted(unknown)}")
    kw = {}
    for k, v in values.items():
        cur = getattr(default, k)
        if dataclasses.is_dataclass(cur):
            kw[k] = dataclass_from_dict(cur, v)
        elif isinstance(v, list):
            kw[k] = tuple(v)
        else:
            kw[k] = v
    return dataclasses.replace(default, **kw)


def merge(base: dict, patch: dict) -> dict:
    """`base` with the keys of `patch` set, nested dicts merged."""
    out = dict(base)
    for k, v in (patch or {}).items():
        out[k] = merge(base.get(k, {}), v) if isinstance(v, dict) else v
    return out
