"""gemma2-27b [arXiv:2408.00118; hf].

46L (23 local/global pairs, window 4096), d_model=4608, 32 heads
(hd=128, GQA kv=16), d_ff=36864, vocab 256000, attn softcap 50, final
logit softcap 30, sandwich (post) norms, tied embeddings.  The same
``CONFIG``, ``SMOKE`` and ``SHAPES`` as the JAX package's.  Global
layers are full attention → long_500k skipped.
"""
from repro_torch.configs import FULL_ATTN_SHAPES
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b", family="dense",
    n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16, head_dim=128,
    d_ff=36864, vocab=256000, local_global=True, window=4096,
    attn_softcap=50.0, logit_softcap=30.0, post_norms=True,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="gemma2-27b-smoke", family="dense",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=256, local_global=True, window=8,
    attn_softcap=50.0, logit_softcap=30.0, post_norms=True,
    tie_embeddings=True,
)

SHAPES = FULL_ATTN_SHAPES
