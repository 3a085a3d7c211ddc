"""deepseek-v2-lite-16b [arXiv:2405.04434; hf].

27L, d_model=2048, 16 heads, MLA kv_lora=512 (qk_nope 128 + qk_rope 64,
v 128), MoE 64 routed experts top-6 + 2 shared, per-expert d_ff=1408,
first layer dense (d_ff 10944), vocab 102400.  The same ``CONFIG``,
``SMOKE`` and ``SHAPES`` as the JAX package's (64 routed experts, top-6:
the leading per-arch spec, DESIGN.md §4).  Full attention → long_500k
skipped.
"""
from repro_torch.configs import FULL_ATTN_SHAPES
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=10944, moe_d_ff=1408, n_experts=64, experts_per_token=6,
    n_shared_experts=2, first_dense_layers=1,
    mla_kv_lora=512, mla_qk_nope=128, mla_qk_rope=64, mla_v_dim=128,
    vocab=102400, rope_theta=1e4,
)

SMOKE = ModelConfig(
    name="deepseek-v2-lite-smoke", family="moe",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, moe_d_ff=32, n_experts=8, experts_per_token=2,
    n_shared_experts=1, first_dense_layers=1,
    mla_kv_lora=32, mla_qk_nope=16, mla_qk_rope=8, mla_v_dim=16,
    vocab=256,
)

SHAPES = FULL_ATTN_SHAPES
