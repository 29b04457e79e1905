"""llama4-scout-17b-a16e [moe]: 16 experts top-1 + shared expert, chunked
attention, early fusion.

48L d_model=5120 40H (GQA kv=8) d_ff=8192 (expert) vocab=202048
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]  Chunked attention
(8192) bounds the KV reach -> runs long_500k.
"""
from ..models import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    kind="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=202_048,
    n_experts=16,
    top_k=1,
    shared_expert=True,
    capacity_factor=1.25,
    attn_chunk=8192,
    rope_theta=500_000.0,
    sub_quadratic=True,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=96,
    vocab=512, n_experts=4, top_k=1, attn_chunk=16,
)
