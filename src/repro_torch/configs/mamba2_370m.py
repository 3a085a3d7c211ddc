"""mamba2-370m [arXiv:2405.21060].

48L, d_model=1024 (d_inner 2048, headdim 64 → 32 SSD heads),
ssm_state=128, conv width 4, vocab 50280 → padded to 50432.  The same
``CONFIG``, ``SMOKE`` and ``SHAPES`` as the JAX package's.
Attention-free → long_500k runs (O(1) decode state).
"""
from repro_torch.configs import SUBQUADRATIC_SHAPES
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab=50432,  # 50280 padded
    ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_chunk=256, ssm_conv=4,
)

SMOKE = ModelConfig(
    name="mamba2-smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=0, n_kv_heads=0, d_ff=0, vocab=256,
    ssm_state=16, ssm_expand=2, ssm_headdim=16, ssm_chunk=8, ssm_conv=4,
)

SHAPES = SUBQUADRATIC_SHAPES
