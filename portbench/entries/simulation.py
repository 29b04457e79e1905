"""``repro_torch.pic.Simulation``: the paper's loop on one device."""
from __future__ import annotations

import numpy as np
import torch

from . import kernel_cap, to_problem

#: particles keep their input order (un-binned after each step)
ORDER_KEPT = True
#: a particle leaving the domain still deposits in that step (binned path)
DEPOSIT_LEAVERS = True


class Entry:
    def __init__(self, inputs, config: dict, traffic: dict, device):
        from repro_torch.pic import SimConfig

        self.device = torch.device(device)
        self.problem = to_problem(inputs)
        self.interval = int(traffic["lb_interval"])
        self.stretch_steps = self.interval * int(traffic["stretch_intervals"])
        self.n_devices = int(traffic["n_virtual_devices"])
        self.sim_config = SimConfig(
            engine_backend=traffic["engine_backend"],
            cost_strategy=traffic["cost_strategy"],
            lb_interval=self.interval,
            n_virtual_devices=self.n_devices,
            strict_syncs=bool(traffic["strict_syncs"]),
            sponge_width=inputs.sponge_width,
            lb_threshold=float(traffic["lb_threshold"]),
            max_boxes_per_device=float(traffic["max_boxes_per_device"]),
            kernel_cap=kernel_cap(inputs, int(config["kernel_cap_factor"])),
        )
        self.sim = None
        self._rows = []

    def remake(self) -> None:
        from repro_torch.pic import Simulation

        self.sim = None
        self.sim = Simulation(self.problem, self.sim_config, device=self.device)
        self._rows = []
        self._lb = []

    @property
    def stretch_done(self) -> bool:
        return self.sim.step_idx >= self.stretch_steps

    def run_interval(self) -> None:
        sim = self.sim
        n_events = len(sim.balancer.events)
        sim.run(self.interval)
        h = sim.last_outputs
        self._rows.append(
            {
                "work": h.work,
                "species_counts": h.species_counts,
                "dropped": int(np.asarray(h.dropped).sum()),
                "finite": bool(np.isfinite(h.field_energy).all() and np.isfinite(h.kinetic_energy).all()),
            }
        )
        if len(sim.balancer.events) > n_events:
            self._lb.append(
                {
                    "costs": sim.balancer.smoothed_costs,
                    "adopted": bool(sim.balancer.events[-1].adopted),
                    "mapping": np.asarray(sim.balancer.mapping).copy(),
                }
            )

    def rows(self):
        return list(self._rows)

    def host_stats(self) -> dict:
        return {}

    def tile_cells(self) -> int:
        from repro_torch.kernels.common import HALO

        g = self.problem.grid
        return (g.box_nz + 2 * HALO) * (g.box_nx + 2 * HALO)

    def kernel_launches(self, rows):
        """Per launch of either kernel, its boxes' alive counts: one launch
        per species per step."""
        return [sc for row in rows for step in row["species_counts"] for sc in step]

    def alive_per_step(self, rows):
        return [float(step.sum()) for row in rows for step in row["species_counts"]]

    def outcome(self) -> dict:
        sim = self.sim
        return {
            "fields": torch.stack(tuple(sim.fields)),
            "species": [
                {k: getattr(p, k) for k in ("z", "x", "ux", "uy", "uz", "alive")} for p in sim.species
            ],
            "rows": self.rows(),
            "lb": list(self._lb),
            "lb_start": "round_robin",
            "lb_devices": self.n_devices,
            "lb_max_boxes": self.sim_config.max_boxes_per_device,
            "lb_threshold": self.sim_config.lb_threshold,
            "dropped": int(sim.dropped_total),
        }

    def release(self) -> None:
        self.sim = None
