"""Run a cell through the harness at the tests' small size on the CPU."""
import torch

from _small import CONFIG, SEED, TRAFFIC
from portbench import harness, spec


def run_small(workload: str, seed: int = SEED):
    return harness.run_cell(
        spec.load(workload), seed, 0.0, False, device=torch.device("cpu"),
        config_overrides=CONFIG, traffic_overrides=TRAFFIC,
    )
