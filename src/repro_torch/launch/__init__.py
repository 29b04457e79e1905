"""Launch layer (counterpart of ``repro.launch``): the CUDA environment,
the meshes of logical devices (the box ring and the production meshes) and
the dry run on ``meta`` (``python -m repro_torch.launch.dryrun``).

Importing the package initializes no CUDA state, so callers can set the
environment (``set_performance_flags``) before CUDA initializes.
"""
from .cuda_env import GPU_PERF_ENV, merge_env, set_performance_flags
from .mesh import (
    Mesh,
    as_mesh,
    make_box_mesh,
    make_mesh,
    make_production_mesh,
    require_devices,
    ring_distance,
    ring_offset,
    slot_home_devices,
)

__all__ = [
    "GPU_PERF_ENV",
    "merge_env",
    "set_performance_flags",
    "Mesh",
    "make_mesh",
    "make_production_mesh",
    "make_box_mesh",
    "as_mesh",
    "require_devices",
    "ring_offset",
    "ring_distance",
    "slot_home_devices",
]
