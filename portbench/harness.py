"""One run of one cell: inputs, set-up, the measured window, the traced
stretch, the output check, the result.

The harness holds the generic loop only.  What the cell's problem is (its
inputs, the plain reference, the numbers the check compares, what the
per-layer readers read besides the trace) comes from the configuration's
domain (``portbench/domains/``), and the program is driven through the
traffic mix's entry (``portbench/entries/``).

The window replays a fixed stretch: ``stretch_intervals`` intervals from
the seeded start, each stretch on a runtime made anew from the inputs kept
on the device since set-up.  The window holds whole stretches, re-makes
included, and ends with the first stretch completed after ``seconds``: on
a completed interval, after its fetch.  So a faster program covers the
same steps more often, never later steps with other work, and every
window holds re-makes and intervals in the same proportion.  The last
stretch's final state is what the reference judges.  A ``--trace 1`` run
then makes one more stretch and runs its first ``trace_intervals``
intervals under the profiler (the re-make before them untraced), for the
per-layer metrics.
"""
from __future__ import annotations

import statistics
import sys
import time
from types import SimpleNamespace
from typing import Dict, Optional

import torch
from torch.profiler import record_function

from . import domains, entries, spec, trace as trace_mod

__all__ = ["run_cell", "forbidden_modules", "FORBIDDEN"]

#: intervals of the warm-up: the first round (the balancer's first decision,
#: an adoption) and steady rounds, with the kernel library loaded
WARMUP_INTERVALS = 3
#: top-level module names the benchmark's process must never hold
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _quartiles(v):
    if len(v) < 2:
        return (v[0], v[0], v[0]) if v else (float("nan"),) * 3
    q1, q2, q3 = statistics.quantiles(v, n=4)
    return q1, q2, q3


def _remake(entry) -> None:
    with record_function(trace_mod.SPAN_PREFIX + "remake"):
        entry.remake()


def _interval(entry) -> None:
    with record_function(trace_mod.SPAN_PREFIX + "interval"):
        entry.run_interval()


def _run_intervals(entry, n: int) -> int:
    for _ in range(n):
        _interval(entry)
    return n * entry.interval


def run_cell(
    cell: spec.Cell,
    seed: int,
    seconds: float,
    trace: bool,
    *,
    device="cuda",
    t_start: Optional[float] = None,
    config_overrides: Optional[dict] = None,
    traffic_overrides: Optional[dict] = None,
) -> Dict[str, object]:
    """Run ``cell`` once and return the result's fields (``correct``,
    ``attempted``, ``failed``, ``metrics``, ``device``, optionally
    ``breakdown``, and ``checks``)."""
    t_start = time.perf_counter() if t_start is None else t_start
    config = dict(cell.config, **(config_overrides or {}))
    traffic = dict(cell.traffic, **(traffic_overrides or {}))
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    domain = domains.module(config)
    path = entries.module(traffic["entry"])

    # -- set-up: inputs, a re-make and the first intervals of a stretch ------
    plain = domain.draw(config, seed, dev)
    entry = path.Entry(plain, config, traffic, dev)
    _remake(entry)
    _run_intervals(entry, min(WARMUP_INTERVALS, int(traffic["stretch_intervals"])))
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    log(f"portbench: {cell.name} seed {seed}: {domain.describe(plain)}, set-up {setup_s:.3f} s")

    # -- the measured window: whole stretches until ``seconds`` have passed ---
    host = {"steps": 0, "intervals": 0}
    interval_s, remake_s = [], []
    attempted = failed = 0
    t0 = time.perf_counter()
    while not remake_s or time.perf_counter() - t0 < seconds:
        t = time.perf_counter()
        _remake(entry)
        remake_s.append(time.perf_counter() - t)
        while not entry.stretch_done:
            h0 = entry.host_stats()
            t = time.perf_counter()
            _interval(entry)
            interval_s.append(time.perf_counter() - t)
            for k, v in entry.host_stats().items():
                host[k] = host.get(k, 0.0) + v - h0[k]
            host["steps"] += entry.interval
            host["intervals"] += 1
            attempted += entry.interval
            row = entry.rows()[-1]
            if row["dropped"] or not row["finite"]:
                failed += entry.interval
    window_s = time.perf_counter() - t0
    step_ms = 1e3 * window_s / attempted
    q = _quartiles([1e3 * v / entry.interval for v in interval_s])
    log(
        f"portbench: window {window_s:.3f} s, {attempted} steps, {len(interval_s)} intervals, "
        f"{len(remake_s)} stretches; re-makes {sum(remake_s):.3f} s, "
        f"{100 * sum(remake_s) / window_s:.2f}% of the window; "
        f"interval ms/step quartiles {q[0]:.3f} {q[1]:.3f} {q[2]:.3f}"
    )

    traced = None
    if trace:
        _remake(entry)
        n_traced = int(traffic["trace_intervals"])
        traced = trace_mod.capture(lambda: _run_intervals(entry, n_traced), on_card)
        log(f"portbench: traced {traced.window_s:.3f} s, {traced.steps} steps, "
            f"{len(traced.device)} device and {len(traced.host)} host operations")
        context = domain.context(entry, entry.rows()[:n_traced], plain)
        while not entry.stretch_done:
            _interval(entry)
    memory_peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    outcome = entry.outcome()
    entry.release()
    del entry
    if on_card:
        torch.cuda.empty_cache()

    # -- metrics -------------------------------------------------------------
    metrics: Dict[str, Dict[str, object]] = {}
    device_info: Dict[str, object] = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "count": cell.chips,
        "memory_peak_bytes": int(memory_peak),
    }
    if traced is None:
        values = {"step_ms": step_ms, "peak_mem_gib": memory_peak / 2**30, "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        ctx = SimpleNamespace(trace=traced, host=host, remake_s=remake_s, **context)
        for m in cell.per_layer:
            v = cell.reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        device_info["busy_s"] = trace_mod.busy_s(traced)
        device_info["window_s"] = traced.window_s

    # -- the output check: the stretch against the plain reference ------------
    t = time.perf_counter()
    ref = domain.reference(plain, traffic, path)
    numbers = domain.numbers(outcome, ref, plain)
    del ref, outcome
    log(f"portbench: reference and comparison {time.perf_counter() - t:.3f} s")
    log("portbench: readings " + " ".join(f"{k}={v:.6g}" for k, v in numbers.items()))
    checks = {
        k: {"value": numbers[k], "limit": float(lim)} for k, lim in sorted(cell.limits.items())
    }
    correct = bool(checks) and all(c["value"] <= c["limit"] for c in checks.values())
    if failed:
        correct = False
    result: Dict[str, object] = dict(
        correct=correct, attempted=attempted, failed=failed, metrics=metrics, device=device_info
    )
    if traced is not None:
        result["breakdown"] = trace_mod.breakdown(traced)
    result["checks"] = checks
    return result
