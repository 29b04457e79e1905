"""The distributed PIC runtimes and what they are built from (counterpart
of ``repro.dist``).

``ShardedRuntime`` steps box slots over a ring of logical devices, one
device-resident loop and one history fetch per LB interval, with the
neighbour or ring collectives of ``collectives`` between the phases (both
pipelines; ``overlap=True`` splits each step around the current fold).
``BoxRuntime`` is the host-driven validation runtime: one dispatch per box
per step, each box's state on its own logical device.
``recovery.RecoveryRunner`` makes either crash-safe with checkpoints
(``repro_torch.ckpt``), seeded faults (``faults``) and the elastic device
set (``elastic``).  ``sharding`` holds the logical-axis rule table the LM
stack's params, batches and decode states are sharded by (the dry run,
``repro_torch.launch.dryrun``), the slot-major runtime rules, and the
placement of a tree over a mesh of logical devices (``device_put``,
``gather``).
"""
from .box_runtime import BoxRuntime
from .collectives import (
    NeighborExchangeHandle,
    neighbor_exchange,
    neighbor_exchange_done,
    neighbor_exchange_start,
    neighbor_reduce,
    ring_all_gather,
)
from .elastic import DeviceSet, ElasticRunner
from .faults import (
    CorruptState,
    DeviceLoss,
    Fault,
    FaultInjector,
    FaultSchedule,
    TransientFault,
)
from .recovery import RecoveryError, RecoveryRunner
from .runtime_api import (
    ENGINE_BACKENDS,
    PIPELINES,
    BalancedRuntime,
    DistributedPICRuntime,
    StragglerLoop,
    device_work,
    restore_balancer,
    snapshot_balancer,
    validate_engine_backend,
    validate_pipeline,
)
from .sharded_runtime import ShardedRuntime, split_phase_order
from .sharding import (
    NamedSharding,
    P,
    ShardedTensor,
    batch_sharding,
    bytes_per_device,
    default_rules,
    device_put,
    gather,
    runtime_rules,
    spec_for,
    state_shardings,
    tree_shardings,
)
from .straggler import StragglerDetector

__all__ = [
    "BoxRuntime",
    "ShardedRuntime",
    "split_phase_order",
    "StragglerDetector",
    "StragglerLoop",
    "DeviceSet",
    "ElasticRunner",
    "CorruptState",
    "DeviceLoss",
    "Fault",
    "FaultInjector",
    "FaultSchedule",
    "RecoveryError",
    "RecoveryRunner",
    "TransientFault",
    "BalancedRuntime",
    "DistributedPICRuntime",
    "device_work",
    "snapshot_balancer",
    "restore_balancer",
    "validate_pipeline",
    "validate_engine_backend",
    "PIPELINES",
    "ENGINE_BACKENDS",
    "ring_all_gather",
    "neighbor_exchange",
    "neighbor_reduce",
    "NeighborExchangeHandle",
    "neighbor_exchange_start",
    "neighbor_exchange_done",
    "P",
    "NamedSharding",
    "ShardedTensor",
    "batch_sharding",
    "default_rules",
    "runtime_rules",
    "spec_for",
    "state_shardings",
    "tree_shardings",
    "device_put",
    "gather",
    "bytes_per_device",
]
