"""whisper-medium [arXiv:2212.04356].

Enc-dec: 24+24L, d_model=1024, 16 heads (MHA), d_ff=4096, vocab 51865 →
padded 51968.  Conv frontend stubbed: inputs are precomputed frame
embeddings (B, 1500, 1024).  Decoder learned positions extended to the
shape cells (native 448).  The same ``CONFIG``, ``SMOKE`` and ``SHAPES``
as the JAX package's.  Full attention → long_500k skipped.
"""
from repro_torch.configs import FULL_ATTN_SHAPES
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="audio",
    n_layers=24, encoder_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=51968,  # 51865 padded
    encoder_tokens=1500, max_positions=32768, tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="whisper-smoke", family="audio",
    n_layers=2, encoder_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=256, encoder_tokens=16, max_positions=64,
    tie_embeddings=True,
)

SHAPES = FULL_ATTN_SHAPES
