#!/usr/bin/env python3
"""The control of the output check: the plain reference put in the
program's place and computed one precision lower (bfloat16 fields,
currents, momenta and weights), judged by the same numbers as a run.

    python3 portbench/control.py --workload laser_ion.sim --seeds 11 12 13

prints, per seed, the readings the control gives: each compared number
must come out above its limit on one of them at least.  The benchmark's
own runs never run it.  ``portbench/tests/test_portbench_control.py``
runs it at a small size on the CPU.
"""
from __future__ import annotations

import sys
from pathlib import Path
from typing import Dict, Optional

if __name__ == "__main__":
    _root = Path(__file__).resolve().parent.parent
    sys.path[:0] = [str(_root / "src"), str(_root)]

import torch

from portbench import entries, inputs as inputs_mod, spec
from portbench.harness import outcome_steps
from portbench.reference import compare, pic as ref_pic

__all__ = ["control_outcome", "readings"]


def control_outcome(plain, traffic: dict, dtype=torch.bfloat16) -> dict:
    """What the reference computed in ``dtype`` gives, in the form of the
    program's outcome for the cell's entry."""
    path = entries.module(traffic["entry"])
    low = ref_pic.run(plain, outcome_steps(traffic), deposit_leavers=path.DEPOSIT_LEAVERS, dtype=dtype)
    out = {
        "fields": low["fields"],
        "rows": [],
        "lb": [],
        "lb_start": "round_robin",
        "lb_devices": 1,
        "lb_max_boxes": None,
        "lb_threshold": 0.0,
        "dropped": 0,
    }
    if path.ORDER_KEPT:
        out["species"] = low["species"]
    else:
        out["pooled"] = [
            {k: sp[k][sp["alive"]] for k in ("z", "x", "ux", "uy", "uz")} for sp in low["species"]
        ]
    return out


def readings(
    cell: spec.Cell, seed: int, device="cuda", config_overrides: Optional[dict] = None
) -> Dict[str, float]:
    """The control's numbers for ``cell`` on ``seed``."""
    config = dict(cell.config, **(config_overrides or {}))
    plain = inputs_mod.draw(config, seed, torch.device(device))
    low = control_outcome(plain, cell.traffic)
    leavers = entries.module(cell.traffic["entry"]).DEPOSIT_LEAVERS
    ref = ref_pic.run(plain, outcome_steps(cell.traffic), deposit_leavers=leavers)
    return compare.numbers(low, ref, plain)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = spec.load(args.workload)
    for seed in args.seeds:
        nums = readings(cell, seed)
        shown = " ".join(f"{k}={v!r}" for k, v in nums.items())
        limits = " ".join(f"{k}<={v!r}" for k, v in cell.limits.items())
        print(f"control {cell.name} seed {seed}: {shown} | limits {limits}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
