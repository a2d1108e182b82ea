"""Finding a cell's files by the names in BENCHMARK.json.

Every configuration, traffic mix, cell and metric is a file of its own:

    portbench/configs/<config>.json      a deployment: the cloud, the options
    portbench/traffic/<traffic>.json     what a job asks for (readback, order)
    portbench/workloads/<cell>.json      the cell's correctness limits
    portbench/metrics/<metric>.py        a reader: `read(ctx)` -> number or None

A later change adds a cell, a configuration or a metric by adding files and
entries; it edits none of these.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))


@dataclass
class Cell:
    """One entry of `workloads` with the files it names."""
    name: str
    entry: Dict          # its BENCHMARK.json entry
    config: Dict         # configs/<config>.json
    traffic: Dict        # traffic/<traffic>.json
    spec: Dict           # workloads/<name>.json
    end_to_end: List[Dict]
    per_layer: List[Dict]

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str) -> Dict:
    """BENCHMARK.json of the checkout at `root`."""
    return load_json(os.path.join(root, "BENCHMARK.json"))


def cell_names(bench: Dict) -> List[str]:
    return [w["name"] for w in bench["workloads"]]


def applies(metric: Dict, cell: str) -> bool:
    """Whether `metric` is reported in `cell` (no `workloads` key: all)."""
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(bench: Dict, name: str, base: str = HERE) -> Cell:
    """The cell `name` and its files under `base` (the benchmark's
    folder). Raises KeyError for a cell BENCHMARK.json does not list and
    ValueError where its files disagree with the entry."""
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r}; known: {sorted(entries)}")
    entry = entries[name]
    config = load_json(os.path.join(base, "configs", entry["config"] + ".json"))
    traffic = load_json(os.path.join(base, "traffic", entry["traffic"] + ".json"))
    spec = load_json(os.path.join(base, "workloads", name + ".json"))
    for key in ("config", "traffic"):
        if spec.get(key) != entry[key]:
            raise ValueError(f"workloads/{name}.json says {key} "
                             f"{spec.get(key)!r}, BENCHMARK.json "
                             f"{entry[key]!r}")
    if int(config["chips"]) != int(entry["chips"]):
        raise ValueError(f"configs/{entry['config']}.json is for "
                         f"{config['chips']} chips, the cell asks "
                         f"{entry['chips']}")
    return Cell(name=name, entry=entry, config=config, traffic=traffic,
                spec=spec,
                end_to_end=[m for m in bench["end_to_end"]
                            if applies(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if applies(m, name)])


def metric_reader(name: str, base: str = HERE):
    """The `read(ctx)` function of metrics/<name>.py."""
    path = os.path.join(base, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def read_metrics(metrics: List[Dict], ctx, base: str = HERE
                 ) -> Dict[str, Dict]:
    """{name: {"value", "unit"}} of every metric whose reader finds
    something to read; the others are left out."""
    out: Dict[str, Dict] = {}
    for m in metrics:
        value: Optional[float] = metric_reader(m["name"], base)(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
