"""whisper-medium [audio]: encoder-decoder, conv frontend stubbed.

24L (dec) + 24L (enc) d_model=1024 16H (kv=16) d_ff=4096 vocab=51865
[arXiv:2212.04356; unverified]  input_specs() provides precomputed frame
embeddings (B, 1500, d); full attention -> long_500k skipped.
"""
from ..models import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    kind="encdec",
    n_layers=24,
    n_enc_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=51_865,
    mlp_type="gelu",
    enc_seq=1500,
    sub_quadratic=False,
    source="arXiv:2212.04356",
)

SMOKE = CONFIG.scaled(
    n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=512, enc_seq=32,
)
