"""The numbers that decide ``correct``: a stretch of the program's run held
against the plain reference from the same inputs.

  * ``field_gap``: the worst of the six field components,
    ||E_program - E_reference|| / ||E_reference|| after the stretch (a
    component the reference leaves at exactly 0 must be exactly 0).  J
    enters E every step, so E carries the deposited current.
  * ``momentum_gap`` (particles in input order): the worst species'
    ||u_program - u_reference|| / ||u_reference - u_start||, the error
    against the change the stretch made.
  * ``moment_gap`` (particles pooled, their order lost): the same on each
    box's summed momentum of its alive particles.
  * ``census_gap``: alive particles, program against reference, summed
    over species.
  * ``dropped``: particles the program dropped at a bin or pack capacity.
  * ``counter_mismatch``: (step, box) entries whose fetched work counter
    differs from the counter formula applied to the fetched per-species
    counts (the kernels' in-kernel counters, bit for bit).
  * ``lb_mismatch``: LB rounds whose adoption or mapping differs from the
    reference balancer's decision on the costs the program's balancer was
    offered.
  * ``count_gap``: the program's per-box alive counts against the
    reference's, summed absolute difference over all of them.

Norms are taken in float64.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from . import balancer
from .pic import box_ids

__all__ = ["numbers", "work_formula", "CELL_OPS", "LANE_OPS", "TILE"]

#: the kernels' work accounting: ops per executed lane (gather 96 + push 32
#: + deposit 48), per cell (FDTD 24), lanes per chunk
LANE_OPS = 176
CELL_OPS = 24
TILE = 256


def work_formula(counts: np.ndarray, cells_per_box: int) -> np.ndarray:
    """Per-box work units of one species' alive counts."""
    chunks = np.ceil(np.asarray(counts, np.float64) / TILE)
    return chunks * TILE * LANE_OPS + cells_per_box * CELL_OPS


def _rel(a: torch.Tensor, b: torch.Tensor, base: torch.Tensor) -> float:
    num = torch.linalg.vector_norm((a.double() - b.double()).reshape(-1)).item()
    den = torch.linalg.vector_norm(base.double().reshape(-1)).item()
    if den == 0.0:
        return 0.0 if num == 0.0 else float("inf")
    return num / den


def field_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    prog = prog.to(ref.device)
    return max(_rel(prog[c], ref[c], ref[c]) for c in range(ref.shape[0]))


def momentum_gap(prog, ref, start) -> float:
    worst = 0.0
    for p, r, s in zip(prog, ref, start):
        dev = r["ux"].device
        up = torch.stack([p[k].to(dev) for k in ("ux", "uy", "uz")])
        ur = torch.stack([r[k] for k in ("ux", "uy", "uz")])
        u0 = torch.stack([s[k].to(dev) for k in ("ux", "uy", "uz")])
        worst = max(worst, _rel(up, ur, ur.double() - u0.double()))
    return worst


def _box_moments(z, x, ux, uy, uz, g) -> torch.Tensor:
    ids = box_ids(z, x, g)
    out = torch.zeros((3, g.n_boxes), dtype=torch.float64, device=z.device)
    for c, u in enumerate((ux, uy, uz)):
        out[c].index_add_(0, ids, u.double())
    return out


def moment_gap(pooled, ref, start, g) -> float:
    worst = 0.0
    for p, r, s in zip(pooled, ref, start):
        dev = r["ux"].device
        a = r["alive"]
        mp = _box_moments(*(p[k].to(dev) for k in ("z", "x", "ux", "uy", "uz")), g)
        mr = _box_moments(*(r[k][a] for k in ("z", "x", "ux", "uy", "uz")), g)
        m0 = _box_moments(*(s[k] for k in ("z", "x", "ux", "uy", "uz")), g)
        worst = max(worst, _rel(mp, mr, mr - m0))
    return worst


def numbers(outcome: dict, ref: dict, inputs) -> Dict[str, float]:
    """Every number the program's stretch reads against the reference."""
    g = inputs.geometry
    out: Dict[str, float] = {"field_gap": field_gap(outcome["fields"], ref["fields"])}
    ref_alive = [int(r["alive"].sum()) for r in ref["species"]]
    if "species" in outcome:
        out["momentum_gap"] = momentum_gap(outcome["species"], ref["species"], inputs.species)
        prog_alive = [int(p["alive"].sum()) for p in outcome["species"]]
    else:
        out["moment_gap"] = moment_gap(outcome["pooled"], ref["species"], inputs.species, g)
        prog_alive = [int(p["z"].numel()) for p in outcome["pooled"]]
    out["census_gap"] = float(sum(abs(a - b) for a, b in zip(prog_alive, ref_alive)))
    out["dropped"] = float(outcome["dropped"])

    rows = outcome["rows"]
    if rows and "species_counts" in rows[0]:
        mismatch = 0
        prog_counts = []
        for row in rows:
            sc = np.asarray(row["species_counts"])  # (steps, species, boxes)
            want = sum(work_formula(sc[:, s], g.cells_per_box) for s in range(sc.shape[1]))
            mismatch += int(np.sum(np.asarray(row["work"], np.float64) != want))
            prog_counts.append(sc)
        out["counter_mismatch"] = float(mismatch)
        pc = np.concatenate(prog_counts)
        rc = ref["counts"].cpu().numpy()[: len(pc)]
        out["count_gap"] = float(np.abs(pc.astype(np.int64) - rc).sum())

    start = outcome["lb_start"]
    n = int(outcome["lb_devices"])
    if start == "round_robin":
        initial, home = balancer.round_robin(g.n_boxes, n), None
    else:
        home = balancer.morton_home(g.boxes_z, g.boxes_x, n)
        initial = home
    decided = balancer.replay(
        [r["costs"] for r in outcome["lb"]],
        initial,
        n,
        max_boxes=outcome["lb_max_boxes"],
        threshold=float(outcome["lb_threshold"]),
        home=home,
    )
    out["lb_mismatch"] = float(
        sum(
            (d["adopted"] != p["adopted"]) or not np.array_equal(d["mapping"], p["mapping"])
            for d, p in zip(decided, outcome["lb"])
        )
    )
    out["lb_adoptions"] = float(sum(p["adopted"] for p in outcome["lb"]))
    return out
