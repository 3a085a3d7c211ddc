"""Zamba2 hybrid: a Mamba-2 backbone and one *shared* attention block.

The port of ``repro/models/zamba2.py``.  Every ``hybrid_attn_every``
mamba layers, one transformer block runs with parameters **shared across
all its applications** (arXiv:2411.15242).  The shared block's leaves
receive the summed gradients of every reuse site: autograd adds the
uses' gradients (each one's FSDP reduce-scatter, where the block is
sharded) in the order the backward reaches them, the last group first,
as the reference's scan transpose accumulates them.

Layout: ``n_layers`` mamba layers (``mamba2``'s parameters and layer)
split into ``n_layers // g`` full groups, each closed by the shared block
(``transformer._self_layer``, no MoE), and a tail of ``n_layers % g``
mamba layers after the last group.  In training only the mamba layers
run under ``base.remat``; the shared block keeps its activations, as the
reference's does.

Serving (on the rank axes too, ``serve.engine.make_serve_fns``): the
cache is ``{"mamba": {"conv_x", "conv_b",
"conv_c", "ssm"} (L, B, ...), "attn": {"k", "v"} (ngroups, B, max_seq,
KV, hd), "pos"}``; ``decode_step`` writes both parts in place.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch import tree
from repro_torch.models import base, mamba2
from repro_torch.models import transformer as tf
from repro_torch.models.base import ModelConfig

Gather = Callable | None


def _groups(cfg: ModelConfig) -> tuple[int, int]:
    g = cfg.hybrid_attn_every
    return cfg.n_layers // g, cfg.n_layers % g


def init_params(cfg: ModelConfig, gen: torch.Generator,
                cast: Callable = lambda t: t) -> dict:
    """mamba2's parameters and one ``shared_block``: a transformer layer
    without MoE and without a stack axis, drawn after the mamba layers."""
    params = mamba2.init_params(cfg, gen, cast)
    block = tf._layers(cfg, gen, 1, moe=False)
    params["shared_block"] = cast(tree.map_leaves(lambda t: t[0], block))
    return params


def _run(cfg: ModelConfig, params: dict, x: torch.Tensor, *, mode: str,
         cache: dict | None = None, pos: int | None = None,
         gather: Gather = None):
    """The groups and the tail; ``mode`` is ``train`` (``(x, None)``),
    ``prefill`` (from a zero state: ``(x, {"mamba": ..., "attn":
    ...})``) or ``decode`` (``cache`` that layout without ``pos``, the
    step's first position ``pos``; stepped in place and returned)."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"_run: mode {mode!r} is not one of train, "
                         "prefill, decode")
    ngroups, _ = _groups(cfg)
    g = cfg.hybrid_attn_every
    slices = tf._layer_slices(params["layers"], tf._rank_dims(params))
    shared = params["shared_block"]

    def mamba(x, lp, c=None):
        lp = tf._g(gather, lp)
        h = base.rmsnorm(x, lp["ln"], cfg.norm_eps)
        out, nc = mamba2.mamba_block(cfg, lp, h, cache=c)
        return x + base.tag_block_out(cfg, out), nc

    def attn(x, c=None, po=None):
        return tf._self_layer(cfg, tf._g(gather, shared), x, moe=False,
                              cache=c, pos_offset=po)

    # the mamba layers in order, each followed by the shared block where
    # it closes a group
    closes = [i % g == g - 1 and i < ngroups * g for i in range(cfg.n_layers)]
    if mode == "train":
        run = base.remat(cfg, lambda x, lp: mamba(x, lp)[0])
        for i, lp in enumerate(slices):
            x = run(x, lp)
            if closes[i]:
                x = attn(x)[0]
        return x, None
    rd = tf._rank_dims(params)
    if mode == "decode":
        states, kv = cache["mamba"], cache["attn"]
        for i, lp in enumerate(slices):
            x, nc = mamba(x, lp, {k: t.select(rd, i)
                                  for k, t in states.items()})
            for k, t in nc.items():
                states[k].select(rd, i).copy_(t)
            if closes[i]:
                j = i // g
                x, _ = attn(x, {"k": kv["k"].select(rd, j),
                                "v": kv["v"].select(rd, j), "pos": pos,
                                "seq": base.seq_split("attn")}, pos)
        return x, cache
    new: dict = {}
    kvs: dict = {"k": [], "v": []}
    rows = base.seq_split("attn")
    for i, lp in enumerate(slices):
        x, nc = mamba(x, lp, {})              # from a zero state
        for k, t in nc.items():
            new.setdefault(k, []).append(t)
        if closes[i]:
            x, kv = attn(x)
            for name, t in zip(("k", "v"), kv):
                kvs[name].append(base.cache_rows(t, rd) if rows else t)
    none = x.new_zeros((*x.shape[:rd], 0, *x.shape[rd:-1], cfg.n_kv_heads,
                        cfg.hd))
    return x, {"mamba": {k: torch.stack(v, rd) for k, v in new.items()},
               "attn": {k: torch.stack(v, rd) if v else none
                        for k, v in kvs.items()}}


def loss_fn(cfg: ModelConfig, params: dict, batch: dict, *,
            gather: Gather = None, loss_chunk: int = 2048) -> torch.Tensor:
    """Mean next-token cross-entropy, one value per rank."""
    tokens, labels = batch["tokens"], batch["labels"]
    x, emb = tf._embed(cfg, params, tokens, gather)
    x, _ = _run(cfg, params, x, mode="train", gather=gather)
    x = base.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    head = tf._head(cfg, params, emb, gather)
    return tf.chunked_ce(cfg, x, head, labels, loss_chunk,
                         rank_dims=tf._rank_dims(params))


def prefill(cfg: ModelConfig, params: dict, batch: dict, *,
            gather: Gather = None):
    """The prompt from a zero state; returns (last-token logits, cache)."""
    tokens = batch["tokens"]
    x, emb = tf._embed(cfg, params, tokens, gather)
    x, cache = _run(cfg, params, x, mode="prefill", gather=gather)
    cache["pos"] = tokens.shape[-1]
    last = x[..., -1:, :].contiguous()
    return mamba2._logits(cfg, params, last, emb, gather), cache


def decode_step(cfg: ModelConfig, params: dict, token: torch.Tensor,
                cache: dict, *, gather: Gather = None):
    """One decode step: token (B, S) + cache → (logits (B, S, V), cache),
    the mamba state and the shared block's K/V written in place (the
    input cache is consumed)."""
    pos = tf._host_pos(cache["pos"])
    x, emb = tf._embed(cfg, params, token, gather)
    layer_caches = {k: v for k, v in cache.items() if k != "pos"}
    x, new_cache = _run(cfg, params, x, mode="decode", cache=layer_caches,
                        pos=pos, gather=gather)
    new_cache["pos"] = pos + token.shape[-1]
    return mamba2._logits(cfg, params, x, emb, gather), new_cache


def init_cache(cfg: ModelConfig, batch_size: int, max_seq: int,
               dtype: torch.dtype | None = None,
               device: str | torch.device | None = None) -> dict:
    """Zero decode state on ``device``: every mamba layer's conv windows
    (in the compute dtype) and fp32 SSM state, and each group's K/V in
    ``dtype`` (the compute dtype by default), ``pos`` at ``max_seq - 1``
    as in the reference."""
    dtype = dtype or cfg.dtype
    ngroups, _ = _groups(cfg)
    mcache = mamba2._zero_layer_cache(cfg, (cfg.n_layers, batch_size),
                                      device)
    shape = (ngroups, batch_size, max_seq, cfg.n_kv_heads, cfg.hd)
    attn = {k: torch.zeros(shape, dtype=dtype, device=device)
            for k in ("k", "v")}
    return {"mamba": mcache, "attn": attn, "pos": max_seq - 1}
