"""A toy domain that is not PIC, with its entry, for the tests of the
domain layer: a seeded (rows, width) tensor advanced by an elementwise map,
its plain reference in float64, and one checked number.  The tests put it
in ``sys.modules`` as ``portbench.domains.toy`` and ``portbench.entries.toy``;
no file of the harness knows it."""
from types import SimpleNamespace

import torch

#: the card's peak bytes a second, for the toy's step bound
PEAK_BYTES_PER_S = 3.35e12


def draw(config, seed, device):
    g = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    x = torch.randn((int(config["rows"]), int(config["width"])), generator=g, device=device)
    return SimpleNamespace(x=x)


def describe(plain):
    return f"{plain.x.shape[0]} rows of {plain.x.shape[1]}"


def step(x):
    """The program's step, which a planted fault replaces."""
    return torch.tanh(0.5 * x) + 0.25 * x


def steps(traffic):
    return int(traffic["steps_per_interval"]) * int(traffic["stretch_intervals"])


def reference(plain, traffic, path):
    y = plain.x.double()
    for _ in range(steps(traffic)):
        y = 0.25 * y + torch.tanh(y / 2)
    return y


def numbers(outcome, ref, plain):
    gap = (outcome["x"].double() - ref).abs().max() / ref.abs().max()
    return {"gap": float(gap)}


def context(entry, rows, plain):
    per_step = 2 * plain.x.element_size() * plain.x.numel() / PEAK_BYTES_PER_S
    return {"step_bounds_s": [per_step] * (len(rows) * entry.interval)}


class Entry:
    def __init__(self, plain, config, traffic, device):
        self.x0 = plain.x
        self.interval = int(traffic["steps_per_interval"])
        self.stretch_steps = steps(traffic)
        self.x = None

    def remake(self):
        self.x = self.x0.clone()
        self.n = 0
        self._rows = []

    @property
    def stretch_done(self):
        return self.n >= self.stretch_steps

    def run_interval(self):
        for _ in range(self.interval):
            self.x = step(self.x)
        self.n += self.interval
        self._rows.append({"dropped": 0, "finite": bool(torch.isfinite(self.x).all())})

    def rows(self):
        return list(self._rows)

    def host_stats(self):
        return {}

    def outcome(self):
        return {"x": self.x}

    def release(self):
        self.x = None
