"""Model building blocks of the port (counterpart of ``repro.models``):
the config and the MoE block the serving lane runs.  The LM models
(attention, SSM, RG-LRU, the transformer) are not ported yet."""
from .common import ModelConfig
from .moe import apply_expert_permutation, expert_costs, init_mlp, init_moe, mlp, moe

__all__ = [
    "ModelConfig",
    "init_mlp",
    "mlp",
    "init_moe",
    "moe",
    "expert_costs",
    "apply_expert_permutation",
]
