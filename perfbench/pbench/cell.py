"""A cell of BENCHMARK.json, found by name: its configuration file, its
traffic mix and its metrics, each a file of its own under `perfbench/`."""

from __future__ import annotations

import copy
import importlib.util
import json
import os
from pathlib import Path

PERFBENCH = Path(__file__).resolve().parent.parent
ROOT = PERFBENCH.parent


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def find(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_config(path: Path) -> dict:
    """A configuration file: the program's config dict under `config`,
    beside its source, what was assumed and what was reduced."""
    with open(path) as f:
        node = json.load(f)
    if "config" not in node:
        raise ValueError(f"{path}: no `config` section")
    return node


def load_traffic(name: str, perfbench: Path = PERFBENCH) -> dict:
    with open(perfbench / "traffic" / f"{name}.json") as f:
        return json.load(f)


def load_metric(name: str, perfbench: Path = PERFBENCH):
    """perfbench/metrics/<name>.py's `read(rec)`: the metric's value from
    the run's record, or None where the run has nothing to read."""
    path = perfbench / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"pb_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Cell:
    """Everything a run of one workload needs to know."""

    def __init__(self, workload: str, root: Path = ROOT, bench: dict | None = None):
        self.root = Path(root)
        self.bench = bench if bench is not None else load_benchmark(self.root)
        self.workload = find(self.bench["workloads"], workload, "workload")
        self.config_entry = find(self.bench["configs"], self.workload["config"], "config")
        self.config_file = load_config(self.root / self.config_entry["file"])
        self.traffic = load_traffic(self.workload["traffic"], self.root / "perfbench")
        self.name = workload

    def metrics(self, trace: bool) -> list[dict]:
        """The cell's end-to-end metrics (trace 0) or per-layer ones
        (trace 1): those without a `workloads` list, or whose list names
        this cell."""
        kind = "per_layer" if trace else "end_to_end"
        return [m for m in self.bench[kind]
                if "workloads" not in m or self.name in m["workloads"]]

    def program_config(self, workspace: str) -> dict:
        """The program's config dict as run: the file's, with the workspace
        under the run's temporary directory and the traffic's work mode."""
        d = copy.deepcopy(self.config_file["config"])
        d["workspace_dir"] = os.path.join(workspace, self.name)
        d["work_mode"] = self.traffic.get("work_mode", d["work_mode"])
        return d
