"""Everything a cell is made of, found by the names in ``BENCHMARK.json``:

  * ``portbench/configs/<config>.json``: the deployment; its ``domain``
    (``pic`` where it names none) picks ``portbench/domains/<domain>.py``,
    which draws its inputs, runs its plain reference and compares (PIC:
    scenario, grid, boxes, particles per cell, masses, bin-capacity rule);
  * ``portbench/traffic/<traffic>.json``: the run (its ``entry`` in
    ``portbench/entries/``, ``stretch_intervals`` and ``trace_intervals``;
    PIC: logical devices, cost strategy, LB interval);
  * ``portbench/limits/<workload>.json``: the limit of each number the
    output check compares;
  * ``portbench/metrics/<metric>.py``: one reader per per-layer metric.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional

__all__ = ["Cell", "load", "HERE", "ROOT"]

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]

    def reader(self, metric: str) -> Callable:
        path = HERE / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load(workload: str, benchmark: Optional[dict] = None) -> Cell:
    """The cell ``workload`` of ``BENCHMARK.json`` with its files."""
    bench = benchmark if benchmark is not None else _json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    w = cells[workload]
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    reported = {m["name"] for m in e2e}
    per_layer = [
        m
        for m in bench["per_layer"]
        if (workload in m["workloads"] if "workloads" in m else m["moves"] in reported)
    ]
    limits_path = HERE / "limits" / f"{workload}.json"
    return Cell(
        name=workload,
        chips=int(w["chips"]),
        config=_json(HERE / "configs" / f"{w['config']}.json"),
        traffic=_json(HERE / "traffic" / f"{w['traffic']}.json"),
        limits=_json(limits_path) if limits_path.exists() else {},
        end_to_end=e2e,
        per_layer=per_layer,
    )
