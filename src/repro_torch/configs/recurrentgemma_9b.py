"""recurrentgemma-9b [hybrid]: RG-LRU + local attention, 1:2 pattern.

38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000
[arXiv:2402.19427; unverified]  Sub-quadratic (local window 2048 + linear
recurrence) -> runs long_500k.
"""
from ..models import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    kind="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab=256_000,
    block_pattern=("r", "r", "a"),
    rglru_width=4096,
    sliding_window=2048,
    conv_width=4,
    sub_quadratic=True,
    source="arXiv:2402.19427",
)

SMOKE = CONFIG.scaled(
    n_layers=6, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
    d_ff=128, vocab=512, rglru_width=64, sliding_window=16,
)
