#!/usr/bin/env python3
"""The control of the output check: the plain reference put in the
program's place and computed one precision lower (for the PIC domain:
bfloat16 fields, currents, momenta and weights), judged by the same
numbers as a run.

    python3 portbench/control.py --workload laser_ion.sim --seeds 11 12 13

prints, per seed, the readings the control gives: each cell's numbers
must come out above their limits on one of them at least.  The control
is the domain's (``portbench/domains/<domain>.py``, ``control``); a domain
without one says so and exits non-zero.  The benchmark's own runs never
run it.  ``portbench/tests/test_portbench_control.py`` runs it at a small
size on the CPU.
"""
from __future__ import annotations

import sys
from pathlib import Path
from typing import Dict, Optional

if __name__ == "__main__":
    _root = Path(__file__).resolve().parent.parent
    sys.path[:0] = [str(_root / "src"), str(_root)]

import torch

from portbench import domains, entries, spec

__all__ = ["readings", "NoControl"]


class NoControl(LookupError):
    """The cell's domain has no control."""


def readings(
    cell: spec.Cell, seed: int, device="cuda", config_overrides: Optional[dict] = None
) -> Dict[str, float]:
    """The control's numbers for ``cell`` on ``seed``."""
    config = dict(cell.config, **(config_overrides or {}))
    domain = domains.module(config)
    if not hasattr(domain, "control"):
        raise NoControl(f"domain {domains.name(config)!r} of {cell.name} has no control")
    path = entries.module(cell.traffic["entry"])
    plain = domain.draw(config, seed, torch.device(device))
    low = domain.control(plain, cell.traffic, path)
    ref = domain.reference(plain, cell.traffic, path)
    return domain.numbers(low, ref, plain)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = spec.load(args.workload)
    for seed in args.seeds:
        try:
            nums = readings(cell, seed)
        except NoControl as e:
            print(f"control: {e}", file=sys.stderr)
            return 2
        shown = " ".join(f"{k}={v!r}" for k, v in nums.items())
        limits = " ".join(f"{k}<={v!r}" for k, v in cell.limits.items())
        print(f"control {cell.name} seed {seed}: {shown} | limits {limits}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
