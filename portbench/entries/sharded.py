"""``repro_torch.dist.ShardedRuntime``: the production path, slot stacks on
logical devices."""
from __future__ import annotations

import numpy as np
import torch

from . import to_problem

#: particles are packed by slot: their input order is lost
ORDER_KEPT = False
#: a particle leaving the domain deposits nothing (slot path)
DEPOSIT_LEAVERS = False


class Entry:
    def __init__(self, inputs, config: dict, traffic: dict, device):
        self.device = torch.device(device)
        self.problem = to_problem(inputs)
        self.traffic = traffic
        self.interval = int(traffic["lb_interval"])
        self.stretch_steps = self.interval * int(traffic["stretch_intervals"])
        self.n_devices = int(traffic["n_devices"])
        self.threshold = float(traffic["lb_threshold"])
        self.sponge_width = inputs.sponge_width
        self.rt = None
        self._rows = []
        self._lb = []

    def remake(self) -> None:
        from repro_torch.dist import ShardedRuntime

        tr = self.traffic
        self.rt = None
        self.rt = ShardedRuntime(
            self.problem,
            self.n_devices,
            lb_interval=self.interval,
            comm=tr["comm"],
            pipeline=tr["pipeline"],
            engine_backend=tr["engine_backend"],
            improvement_threshold=self.threshold,
            sponge_width=self.sponge_width,
            strict_syncs=bool(tr["strict_syncs"]),
            device=self.device,
        )
        self._rows = []
        self._lb = []

    @property
    def stretch_done(self) -> bool:
        return self.rt.step_idx >= self.stretch_steps

    def run_interval(self) -> None:
        rt = self.rt
        n_events = len(rt.balancer.events)
        rt.run(self.interval)
        h = rt.last_history
        self._rows.append(
            {
                "work": h["work"],
                "counts": h["counts"],
                "dropped": int(np.asarray(h["dropped"]).sum()),
                "finite": bool(
                    np.isfinite(h["field_energy"]).all() and np.isfinite(h["kinetic_energy"]).all()
                ),
            }
        )
        if len(rt.balancer.events) > n_events:
            self._lb.append(
                {
                    "costs": rt.slot_costs(),
                    "adopted": bool(rt.balancer.events[-1].adopted),
                    "mapping": np.asarray(rt.balancer.mapping).copy(),
                }
            )

    def rows(self):
        return list(self._rows)

    def host_stats(self) -> dict:
        s = self.rt.pipeline_stats()
        return {k: float(s[k]) for k in ("dispatch_s", "fetch_s", "balance_s")}

    def tile_cells(self) -> int:
        return self.rt.local_grid.nz * self.rt.local_grid.nx

    def kernel_launches(self, rows):
        """Per launch of either kernel, its slots' alive counts: one launch
        per species per logical device per step.  The fetched counts sum
        the species, so each species is given an equal share."""
        per = self.problem.grid.n_boxes // self.n_devices
        n_sp = len(self.problem.species)
        return [
            step[d * per : (d + 1) * per] / n_sp
            for row in rows
            for step in np.asarray(row["counts"], np.float64)
            for d in range(self.n_devices)
            for _ in range(n_sp)
        ]

    def alive_per_step(self, rows):
        return [float(step.sum()) for row in rows for step in np.asarray(row["counts"])]

    def outcome(self) -> dict:
        rt = self.rt
        snap = rt.snapshot()
        pooled = [
            {k: torch.from_numpy(np.asarray(sp[k])) for k in ("z", "x", "ux", "uy", "uz")}
            for sp in snap["species"]
        ]
        return {
            "fields": torch.stack(tuple(rt.fields)),
            "pooled": pooled,
            "rows": self.rows(),
            "lb": list(self._lb),
            "lb_start": "morton_home",
            "lb_devices": self.n_devices,
            "lb_max_boxes": 1.0,
            "lb_threshold": self.threshold,
            "dropped": int(rt.dropped_total),
        }

    def release(self) -> None:
        self.rt = None
