"""The harness finds every cell, configuration, traffic mix, limit and
metric reader of ``BENCHMARK.json`` by name."""
import json

import pytest

from portbench import entries, spec

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["per_layer"]]


@pytest.mark.parametrize("workload", CELLS)
def test_cell_loads_by_name(workload):
    cell = spec.load(workload)
    path = entries.module(cell.traffic["entry"])
    assert hasattr(path, "Entry")
    assert isinstance(path.DEPOSIT_LEAVERS, bool) and isinstance(path.ORDER_KEPT, bool)
    assert cell.config["scenario"] in ("laser_ion", "uniform_plasma")
    assert cell.limits, "every cell has the limits of its output check"
    assert {m["name"] for m in cell.end_to_end} == {"step_ms", "peak_mem_gib", "setup_s"}
    assert cell.per_layer, "every cell reports a per-layer metric"


@pytest.mark.parametrize("metric", METRICS)
def test_metric_reader_loads_by_name(metric):
    cell = spec.load(next(w for w in CELLS))
    assert callable(cell.reader(metric))


def test_config_files_match_benchmark():
    for c in BENCH["configs"]:
        path = spec.ROOT / c["file"]
        body = json.loads(path.read_text())
        assert body["name"] == c["name"] and path.stem == c["name"]
        assert body["reduced"] == c["reduced"]
        assert all(k in body["published"] for k in c["reduced"])
