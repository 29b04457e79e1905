"""The PIC loop: a seeded particle problem (``portbench/inputs/``), the plain
PIC reference (``portbench/reference/pic.py``) and the comparison of fields,
momenta, census, counters and LB rounds (``portbench/reference/compare.py``).
"""
from __future__ import annotations

import torch

from portbench import inputs, yardstick
from portbench.reference import compare, pic as ref_pic

__all__ = ["draw", "describe", "reference", "numbers", "context", "control", "outcome_steps"]

draw = inputs.draw
numbers = compare.numbers


def describe(plain) -> str:
    return f"{plain.n_particles} particles"


def outcome_steps(traffic: dict) -> int:
    """The steps of one stretch: the reference runs them from t = 0."""
    return int(traffic["lb_interval"]) * int(traffic["stretch_intervals"])


def reference(plain, traffic: dict, path, dtype=torch.float32) -> dict:
    """The plain PIC run over the stretch, with the entry's leaver semantics
    (``path.DEPOSIT_LEAVERS``); ``dtype`` the precision of fields,
    currents, momenta and weights."""
    return ref_pic.run(
        plain, outcome_steps(traffic), deposit_leavers=path.DEPOSIT_LEAVERS, dtype=dtype
    )


def context(entry, rows, plain) -> dict:
    """Each kernel launch's per-box alive counts and the cells of a kernel's
    field tile (the rooflines), the alive particles of each step and the
    grid's cells, and each step's physics bound (``step_mfu``)."""
    cells = plain.geometry.nz * plain.geometry.nx
    alive = entry.alive_per_step(rows)
    return dict(
        launches=entry.kernel_launches(rows),
        tile_cells=entry.tile_cells(),
        alive_per_step=alive,
        cells=cells,
        step_bounds_s=[yardstick.step_bound_s(a, cells) for a in alive],
    )


def control(plain, traffic: dict, path, dtype=torch.bfloat16) -> dict:
    """What the reference computed in ``dtype`` gives, in the form of the
    program's outcome for the cell's entry (no work rows, no LB rounds)."""
    low = reference(plain, traffic, path, dtype=dtype)
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
