"""tinyllama-1.1b [arXiv:2401.02385; hf].

22L, d_model=2048, 32 heads (hd=64, GQA kv=4), d_ff=5632, vocab 32000,
untied head.  The same ``CONFIG``, ``SMOKE`` and ``SHAPES`` as the JAX
package's.  Full attention → long_500k skipped.
"""
from repro_torch.configs import FULL_ATTN_SHAPES
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b", family="dense",
    n_layers=22, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=64,
    d_ff=5632, vocab=32000,
)

SMOKE = ModelConfig(
    name="tinyllama-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=256,
)

SHAPES = FULL_ATTN_SHAPES
