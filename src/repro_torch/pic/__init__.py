"""2D3V electromagnetic particle-in-cell substrate on torch tensors
(counterpart of ``repro.pic``).

Normalized plasma units: c = 1, electron charge magnitude = 1, electron
mass = 1, ω_pe(n0) = 1.  Lengths in c/ω_pe, times in 1/ω_pe.
"""
from .grid import Grid2D
from .fields import Fields, step_e, step_b_half
from .particles import Particles, boris_push, gather_fields, advance_positions
from .deposition import deposit_current, box_work_counters
from .boxes import BoxDecomposition
from .engine import StepOutputs, build_step_body, make_interval_fn
from .laser import LaserAntenna
from .problem import (
    ProblemSetup,
    Scenario,
    colliding_beams_problem,
    density_ramp_problem,
    get_scenario,
    laser_ion_problem,
    list_scenarios,
    moving_laser_problem,
    register_scenario,
    uniform_null_problem,
    uniform_plasma_problem,
)
from .stepper import Simulation, SimConfig

__all__ = [
    "Grid2D",
    "Fields",
    "step_e",
    "step_b_half",
    "Particles",
    "boris_push",
    "gather_fields",
    "advance_positions",
    "deposit_current",
    "box_work_counters",
    "BoxDecomposition",
    "LaserAntenna",
    "ProblemSetup",
    "laser_ion_problem",
    "uniform_plasma_problem",
    "moving_laser_problem",
    "colliding_beams_problem",
    "density_ramp_problem",
    "uniform_null_problem",
    "Scenario",
    "register_scenario",
    "get_scenario",
    "list_scenarios",
    "Simulation",
    "SimConfig",
    "StepOutputs",
    "build_step_body",
    "make_interval_fn",
]
