"""Model building blocks of the port (counterpart of ``repro.models``):
the config, the MoE block, attention, the SSD and RG-LRU blocks, and the
transformer's serving path (params, forward, prefill, decode).  The
training loss comes with the training slice."""
from .common import ModelConfig
from .moe import apply_expert_permutation, expert_costs, init_mlp, init_moe, mlp, moe
from .transformer import (
    DecodeState,
    decode_step,
    forward_train,
    init_decode_state,
    init_params,
    prefill,
)

__all__ = [
    "ModelConfig",
    "init_mlp",
    "mlp",
    "init_moe",
    "moe",
    "expert_costs",
    "apply_expert_permutation",
    "init_params",
    "forward_train",
    "prefill",
    "decode_step",
    "init_decode_state",
    "DecodeState",
]
