"""The shared model configuration (dataclass only).

The port of ``ModelConfig`` from ``repro/models/base.py``: one config
covers every architecture the repo supports; the layer library comes
with the model forward in a later slice (ROADMAP queue 1 item 6).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One config covers all ten assigned architectures (unused fields 0)."""

    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 → d_model // n_heads

    # --- MoE ---------------------------------------------------------------
    n_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    first_dense_layers: int = 0
    capacity_factor: float = 1.25

    # --- MLA (deepseek) ------------------------------------------------------
    mla_kv_lora: int = 0
    mla_qk_nope: int = 128
    mla_qk_rope: int = 64
    mla_v_dim: int = 128

    # --- gemma2 --------------------------------------------------------------
    local_global: bool = False     # alternate local(window)/global layers
    window: int = 4096
    attn_softcap: float = 0.0
    logit_softcap: float = 0.0
    post_norms: bool = False       # gemma2 sandwich norms

    # --- attention extras ------------------------------------------------------
    qk_norm: bool = False          # qwen3 per-head q/k RMSNorm
    rope_theta: float = 1e4

    # --- SSM (mamba2) ----------------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 256
    ssm_conv: int = 4

    # --- hybrid (zamba2) ---------------------------------------------------------
    hybrid_attn_every: int = 0     # shared attn block after every N ssm layers

    # --- VLM (llama-3.2-vision) -----------------------------------------------
    cross_attn_every: int = 0      # one cross-attn layer per N self layers
    vision_tokens: int = 0

    # --- audio (whisper) ---------------------------------------------------------
    encoder_layers: int = 0
    encoder_tokens: int = 0
    max_positions: int = 32768     # learned-pos-emb table size (whisper)

    # --- head tying ----------------------------------------------------------------
    tie_embeddings: bool = False

    # --- numerics -----------------------------------------------------------------
    norm_eps: float = 1e-6
    dtype: Any = torch.bfloat16    # computation dtype (params stay fp32)

    # --- performance knobs (hillclimb levers; defaults = paper-faithful
    # baseline, see EXPERIMENTS.md §Perf) -----------------------------------
    attn_chunk: int = 0            # >0 → chunked online-softmax attention
    moe_combine: str = "gather"    # gather | scatter_ar (EP combine path)
    remat_policy: str = "full"     # full | dots | names
    mla_absorbed: bool = False     # decode attends in the latent space

    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def scaled(self, **overrides) -> "ModelConfig":
        """Reduced config for CPU smoke tests (same family/topology)."""
        return dataclasses.replace(self, **overrides)
