"""qwen2.5-32b [dense]: GQA with QKV bias.

64L d_model=5120 40H (GQA kv=8) d_ff=27648 vocab=152064
[hf:Qwen/Qwen2.5-0.5B; hf]
"""
from ..models import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    kind="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=27_648,
    vocab=152_064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    sub_quadratic=False,
    source="hf:Qwen/Qwen2.5-0.5B",
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab=512,
)
