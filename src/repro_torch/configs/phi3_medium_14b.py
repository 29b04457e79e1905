"""phi3-medium-14b [dense]: RoPE + SwiGLU + GQA.

40L d_model=5120 40H (GQA kv=10) d_ff=17920 vocab=100352
[arXiv:2404.14219; unverified]
"""
from ..models import ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b",
    kind="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=10,
    head_dim=128,
    d_ff=17_920,
    vocab=100_352,
    sub_quadratic=False,
    source="arXiv:2404.14219",
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab=512,
)
