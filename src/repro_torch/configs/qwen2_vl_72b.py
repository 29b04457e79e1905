"""qwen2-vl-72b [vlm]: GQA backbone; M-RoPE + dynamic resolution.

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064
[arXiv:2409.12191; hf]  Vision frontend stubbed: input_specs() provides
precomputed patch embeddings (early fusion over the first n_patches
positions).  M-RoPE's 3-D position decomposition is simplified to 1-D text
RoPE for the backbone dry-run (DESIGN.md §Arch-applicability).
Full attention -> long_500k skipped.
"""
from ..models import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    kind="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=29_568,
    vocab=152_064,
    n_patches=256,
    rope_theta=1_000_000.0,
    sub_quadratic=False,
    source="arXiv:2409.12191",
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
    vocab=512, n_patches=8,
)
