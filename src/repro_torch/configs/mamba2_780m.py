"""mamba2-780m [ssm]: SSD (state-space duality), attention-free.

48L d_model=1536 vocab=50280 ssm_state=128  [arXiv:2405.21060; unverified]
d_inner = 2*d_model = 3072, head_dim 64 -> 48 SSD heads.  O(1)-state decode
-> runs long_500k.  n_heads/n_kv_heads are placeholders (no attention).
"""
from ..models import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    kind="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=1,
    n_kv_heads=1,
    d_ff=0,
    vocab=50_280,
    block_pattern=("s",),
    ssm_state=128,
    ssm_heads=48,
    ssm_head_dim=64,
    ssm_chunk=256,
    conv_width=4,
    sub_quadratic=True,
    source="arXiv:2405.21060",
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=64, vocab=512, ssm_state=16, ssm_heads=4, ssm_head_dim=32,
    ssm_chunk=8,
)
