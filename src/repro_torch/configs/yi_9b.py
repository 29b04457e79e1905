"""yi-9b [dense]: llama-architecture GQA.

48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000
[arXiv:2403.04652; hf]
"""
from ..models import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b",
    kind="dense",
    n_layers=48,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=11_008,
    vocab=64_000,
    sub_quadratic=False,
    source="arXiv:2403.04652",
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab=512,
)
