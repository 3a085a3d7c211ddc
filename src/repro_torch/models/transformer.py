"""Parameter tree of the dense decoder-only transformer (Llama family).

The port of ``init_params`` from ``repro/models/transformer.py`` for the
dense GQA variant (tinyllama-1.1b, granite-20b): the same dict of
leaves, per-layer weights stacked on a leading ``L`` axis, so a gradient
pytree of this shape flattens to the JAX package's leaves in the same
order.  Weights are random from a ``torch.Generator``; they will not
equal the JAX package's ``jax.random`` draws (use ``convert`` to carry
those across).  The forward pass and the other variants come later
(ROADMAP queue 1 items 6 and 14).
"""
from __future__ import annotations

import torch

from repro_torch.models.base import ModelConfig


def dense_init(gen: torch.Generator, shape: tuple[int, ...],
               scale: float | None = None) -> torch.Tensor:
    if scale is None:
        scale = shape[-2] ** -0.5 if len(shape) >= 2 else 0.02
    return torch.randn(shape, generator=gen, device=gen.device) * scale


def _layers(cfg: ModelConfig, gen: torch.Generator) -> dict:
    n, d, f = cfg.n_layers, cfg.d_model, cfg.d_ff
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    scale = d ** -0.5
    zeros = lambda *s: torch.zeros(s, device=gen.device)
    return {
        "ln1": zeros(n, d),
        "attn": {
            "wq": dense_init(gen, (n, d, h * hd), scale),
            "wk": dense_init(gen, (n, d, kv * hd), scale),
            "wv": dense_init(gen, (n, d, kv * hd), scale),
            "wo": dense_init(gen, (n, h * hd, d), scale),
        },
        "ln2": zeros(n, d),
        "ffn": {
            "w_gate": dense_init(gen, (n, d, f), scale),
            "w_up": dense_init(gen, (n, d, f), scale),
            "w_down": dense_init(gen, (n, f, d), f ** -0.5),
        },
    }


def init_params(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """fp32 parameters of a dense transformer, on ``gen``'s device."""
    if (cfg.is_moe or cfg.mla_kv_lora or cfg.cross_attn_every
            or cfg.local_global or cfg.first_dense_layers or cfg.qk_norm
            or cfg.post_norms or cfg.family != "dense"):
        raise NotImplementedError(
            f"{cfg.name}: only the dense GQA transformer is ported; the "
            "other variants are ROADMAP queue 1 item 14")
    params = {
        "embed": dense_init(gen, (cfg.vocab, cfg.d_model), 0.02),
        "final_norm": torch.zeros(cfg.d_model, device=gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab),
                                       cfg.d_model ** -0.5)
    params["layers"] = _layers(cfg, gen)
    return params
