"""Cells, configurations, traffic and per-layer metrics, found by name.

``BENCHMARK.json`` (at the root of the checkout) lists them; each lives in
files of its own under the benchmark's folder:

* ``configs/<config>.json``: a configuration's sizes;
* ``traffic/<traffic>.json``: a traffic mix's parameters, read by the one
  generator (harness/gen.py);
* ``workloads/<cell>.json``: a cell's configuration, traffic and the
  limits of its correctness check;
* ``metrics/<metric>.py``: a per-layer metric's reader, ``read(ctx)``.

Adding one is adding its file and its entry; nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # the BENCHMARK.json metric entries this cell reports
    per_layer: list


def _load(path):
    with open(path) as f:
        return json.load(f)


def _applies(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name, bench_dir=HERE, root=ROOT):
    bench = _load(os.path.join(root, "BENCHMARK.json"))
    entry = {w["name"]: w for w in bench["workloads"]}.get(name)
    if entry is None:
        raise SystemExit(f"benchmark: no workload {name!r} in BENCHMARK.json")
    cell = _load(os.path.join(bench_dir, "workloads", f"{name}.json"))
    if (cell["config"], cell["traffic"]) != (entry["config"],
                                             entry["traffic"]):
        raise SystemExit(f"benchmark: workloads/{name}.json and "
                         "BENCHMARK.json name different cells")
    return Cell(
        name=name, chips=entry["chips"],
        config=_load(os.path.join(bench_dir, "configs",
                                  f"{entry['config']}.json")),
        traffic=_load(os.path.join(bench_dir, "traffic",
                                   f"{entry['traffic']}.json")),
        limits=cell["limits"],
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
    )


def metric_reader(name, bench_dir=HERE):
    """``read(ctx) -> value or None`` of metrics/<name>.py."""
    path = os.path.join(bench_dir, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
