"""granite-20b (code) [arXiv:2405.04324; hf].

52L, d_model=6144, 48 heads (hd=128, MQA kv=1), d_ff=24576, vocab 49152.
llama-arch.  The same ``CONFIG``, ``SMOKE`` and ``SHAPES`` as the JAX
package's.  Full attention → long_500k skipped.
"""
from repro_torch.configs import FULL_ATTN_SHAPES
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b", family="dense",
    n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1, head_dim=128,
    d_ff=24576, vocab=49152,
)

SMOKE = ModelConfig(
    name="granite-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
    d_ff=128, vocab=256,
)

SHAPES = FULL_ATTN_SHAPES
