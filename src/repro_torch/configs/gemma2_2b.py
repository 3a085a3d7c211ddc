"""gemma2-2b [arXiv:2408.00118; hf].

26L (13 local/global pairs), d_model=2304, 8 heads (hd=256, GQA kv=4),
d_ff=9216, vocab 256000, softcaps, sandwich norms, tied embeddings.
The same ``CONFIG``, ``SMOKE`` and ``SHAPES`` as the JAX package's.
long_500k skipped.
"""
from repro_torch.configs import FULL_ATTN_SHAPES
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b", family="dense",
    n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4, head_dim=256,
    d_ff=9216, vocab=256000, local_global=True, window=4096,
    attn_softcap=50.0, logit_softcap=30.0, post_norms=True,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="gemma2-2b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=256, local_global=True, window=8,
    attn_softcap=50.0, logit_softcap=30.0, post_norms=True,
    tie_embeddings=True,
)

SHAPES = FULL_ATTN_SHAPES
