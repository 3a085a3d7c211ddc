"""zamba2-1.2b [arXiv:2411.15242; hf].

38 Mamba-2 layers (d_model=2048, d_inner 4096, headdim 64 → 64 SSD
heads, ssm_state=64) + one SHARED attention block (32 MHA heads, hd=64,
d_ff=8192) applied after every 6 mamba layers.  The same ``CONFIG``,
``SMOKE`` and ``SHAPES`` as the JAX package's.  Hybrid → long_500k runs
(SSM state O(1); the shared block's KV is the only cache that grows).
"""
from repro_torch.configs import SUBQUADRATIC_SHAPES
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab=32000,
    ssm_state=64, ssm_expand=2, ssm_headdim=64, ssm_chunk=256, ssm_conv=4,
    hybrid_attn_every=6,
)

SMOKE = ModelConfig(
    name="zamba2-smoke", family="hybrid",
    n_layers=5, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=256,
    ssm_state=16, ssm_expand=2, ssm_headdim=16, ssm_chunk=8, ssm_conv=4,
    hybrid_attn_every=2,
)

SHAPES = SUBQUADRATIC_SHAPES
