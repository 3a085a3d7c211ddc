"""Analytic MODEL_FLOPS per (arch × shape) cell.

The port of ``repro/launch/analytic.py``, the same arithmetic over the
port's parameter tree (its leaves named by their tree path).  The
§Roofline "useful compute" reference: 6·N·D for training (N =
non-embedding active params, D = tokens) and 2·N·D for inference, plus
the attention context term where applicable.  Compared against the
counted step's FLOPs (``step_analysis``) to expose remat and redundant
work.
"""
from __future__ import annotations

import math
from typing import Any

from repro_torch import tree
from repro_torch.configs import ShapeCell
from repro_torch.models.base import ModelConfig

_EMBED_NAMES = {"embed", "dec_pos", "enc_pos"}


def active_params(cfg: ModelConfig, params_shapes: Any) -> float:
    """Non-embedding parameters active per token (MoE experts scaled)."""
    total = 0.0
    for path, leaf in zip(tree.paths(params_shapes),
                          tree.flatten(params_shapes)[0]):
        keys = [k for k in path if isinstance(k, str)]
        name = keys[-1] if keys else ""
        n = float(math.prod(leaf.shape)) if leaf.shape else 1.0
        if name in _EMBED_NAMES:
            continue
        if cfg.is_moe and len(leaf.shape) >= 3 \
                and name in ("w_gate", "w_up", "w_down") \
                and "shared" not in keys:
            n *= cfg.experts_per_token / cfg.n_experts
        total += n
    return total


def attention_context_flops(cfg: ModelConfig, tokens: float, kv_len: float,
                            train: bool) -> float:
    """Score+output matmul FLOPs against a kv_len context."""
    if cfg.family == "ssm":
        return 0.0
    if cfg.family == "hybrid":
        n_attn = cfg.n_layers // max(1, cfg.hybrid_attn_every)
    elif cfg.family == "vlm":
        g = cfg.cross_attn_every
        n_attn = cfg.n_layers - cfg.n_layers // g  # self layers only
    else:
        n_attn = cfg.n_layers
    width = cfg.n_heads * cfg.hd
    fwd = 4.0 * tokens * kv_len * width * n_attn   # qk^T and pv
    if cfg.local_global:
        # half the layers see only a window-sized context
        capped = min(kv_len, cfg.window)
        fwd = 0.5 * fwd + 0.5 * 4.0 * tokens * capped * width * n_attn
    return fwd * (3.0 if train else 1.0)


def model_flops(cfg: ModelConfig, params_shapes: Any,
                cell: ShapeCell) -> float:
    """Global useful FLOPs for one step of this cell."""
    n = active_params(cfg, params_shapes)
    if cell.kind == "train":
        tokens = float(cell.global_batch) * cell.seq_len
        return 6.0 * n * tokens + attention_context_flops(
            cfg, tokens, cell.seq_len / 2.0, True)
    if cell.kind == "prefill":
        tokens = float(cell.global_batch) * cell.seq_len
        return 2.0 * n * tokens + attention_context_flops(
            cfg, tokens, cell.seq_len / 2.0, False)
    # decode: one token per sequence against a seq_len cache
    tokens = float(cell.global_batch)
    return 2.0 * n * tokens + attention_context_flops(
        cfg, tokens, float(cell.seq_len), False)
