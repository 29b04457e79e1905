"""Model building blocks of the port (counterpart of ``repro.models``):
the config, the MoE block, attention, the SSD and RG-LRU blocks, and the
transformer (params, forward, the training loss, prefill, decode)."""
from .common import ModelConfig
from .moe import apply_expert_permutation, expert_costs, init_mlp, init_moe, mlp, moe
from .transformer import (
    DecodeState,
    decode_step,
    forward_train,
    init_decode_state,
    init_params,
    loss_fn,
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
    "loss_fn",
    "prefill",
    "decode_step",
    "init_decode_state",
    "DecodeState",
]
