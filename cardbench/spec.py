"""Finding a cell's parts by name.

``BENCHMARK.json`` at the checkout's root names the cells. A cell's
configuration is the ``file`` of its ``configs`` entry; its traffic mix is
``cardbench/mixes/<traffic>.json``; each per-layer metric is read by
``cardbench/metrics/<metric name>.py``, a module with ``read(readings)``.
So a new cell, mix, configuration or metric is new files and entries, and
no file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    mix: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]


def _load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench_path: Optional[str] = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` (or of ``bench_path``, whose
    relative file names start at its own directory)."""
    bench_path = bench_path or os.path.join(ROOT, "BENCHMARK.json")
    base = os.path.dirname(os.path.abspath(bench_path))
    bench = _load_json(bench_path)
    work = [w for w in bench["workloads"] if w["name"] == name]
    if not work:
        raise KeyError(f"no workload {name!r} in {bench_path}")
    work = work[0]
    conf = [c for c in bench["configs"] if c["name"] == work["config"]][0]
    mixes_dir = os.path.join(base, "cardbench", "mixes")
    return Cell(
        name=name, chips=int(work["chips"]),
        config=_load_json(os.path.join(base, conf["file"])),
        mix=_load_json(os.path.join(mixes_dir, f"{work['traffic']}.json")),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


def reader(metric: str):
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        f"cardbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
