"""llama-3.2-vision-90b [hf:meta-llama/Llama-3.2-11B-Vision family].

100L total, d_model=8192, 64 heads (GQA kv=8, hd=128), d_ff=28672,
vocab 128256.  Every 5th layer is a gated cross-attention layer to the
vision embeddings (20 cross + 80 self).  The vision frontend is a stub:
the inputs hold precomputed patch embeddings (B, 1600, 8192).  The same
``CONFIG``, ``SMOKE`` and ``SHAPES`` as the JAX package's.  Full
attention → long_500k skipped.
"""
from repro_torch.configs import FULL_ATTN_SHAPES
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b", family="vlm",
    n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=28672, vocab=128256, cross_attn_every=5, vision_tokens=1600,
    rope_theta=5e5,
)

SMOKE = ModelConfig(
    name="llama32-vision-smoke", family="vlm",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=256, cross_attn_every=2, vision_tokens=8,
)

SHAPES = FULL_ATTN_SHAPES
