"""qwen3-moe-235b-a22b [hf:Qwen/Qwen3-30B-A3B family; hf].

94L, d_model=4096, 64 q heads (GQA kv=4, head_dim 128), per-expert
d_ff=1536, vocab 151936, 128 experts top-8, per-head q/k RMSNorm.  The
same ``CONFIG``, ``SMOKE`` and ``SHAPES`` as the JAX package's.  Full
attention → long_500k skipped.
"""
from repro_torch.configs import FULL_ATTN_SHAPES
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
    d_ff=0, moe_d_ff=1536, n_experts=128, experts_per_token=8,
    vocab=151936, qk_norm=True, rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="qwen3-moe-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=0, moe_d_ff=32, n_experts=8, experts_per_token=2,
    vocab=256, qk_norm=True,
)

SHAPES = FULL_ATTN_SHAPES
