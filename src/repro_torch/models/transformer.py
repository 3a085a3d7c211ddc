"""The dense decoder-only transformer (Llama family): parameters, the
train-mode forward and the serving steps.

The port of ``repro/models/transformer.py`` for the dense GQA variant
(tinyllama-1.1b, granite-20b).  ``init_params`` builds the same dict of
leaves, per-layer weights stacked on a leading ``L`` axis, so a gradient
pytree of this shape flattens to the JAX package's leaves in the same
order.  Weights are random from a ``torch.Generator``; they will not
equal the JAX package's ``jax.random`` draws (use ``convert`` to carry
those across).

``loss_fn`` is the train forward: embed → ``run_stack`` (a Python loop
over the layers, each under ``base.remat``, the FSDP ``gather`` applied
inside it so the backward re-gathers) → final norm → sequence-chunked
cross-entropy.  Parameters may carry the mesh's rank axes in front
(``(*R, ...)``, with the stacked ``L`` axis after them) and the batch
``(*R, B, S)``; the loss then has one value per rank.  ``params["layers"]``
may also be a list of per-layer dicts (how the trainer hands autograd
one leaf per layer).

``prefill``, ``decode_step`` and ``init_cache`` are the serving steps, on
one rank: the prompt's forward returning its last logits and a ``{"layers":
{"k", "v"}, "pos"}`` cache of ``(L, B, S, KV, hd)``, and one token a row
against that cache, written in place.  The cache's ``pos`` is a host
int, so the flash kernel's masks are launch arguments.  The other
variants are the other families' (ROADMAP queue 1 item 14).
"""
from __future__ import annotations

import math
import operator
from typing import Callable

import torch

from repro_torch import tree
from repro_torch.models import base
from repro_torch.models.base import ModelConfig

Gather = Callable | None


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


# ---------------------------------------------------------------------------
# Layer application and the train-mode stack.
# ---------------------------------------------------------------------------

def _check_dense(cfg: ModelConfig) -> None:
    if (cfg.is_moe or cfg.mla_kv_lora or cfg.cross_attn_every
            or cfg.local_global or cfg.post_norms or cfg.family != "dense"):
        raise NotImplementedError(
            f"{cfg.name}: only the dense GQA transformer's forward is "
            "ported; the other variants are ROADMAP queue 1 item 14")


def _g(gather: Gather, lp: dict) -> dict:
    return gather(lp) if gather is not None else lp


def _rank_dims(params: dict) -> int:
    return params["final_norm"].dim() - 1


def _self_layer(cfg: ModelConfig, lp: dict, x: torch.Tensor, *,
                window: int = 0, cache: dict | None = None,
                pos_offset: int | None = None) -> tuple:
    h = base.rmsnorm(x, lp["ln1"], cfg.norm_eps)
    attn_out, newkv = base.gqa_attention(cfg, lp["attn"], h, window=window,
                                         cache=cache, pos_offset=pos_offset)
    x = x + base.tag_block_out(cfg, attn_out)
    h = base.rmsnorm(x, lp["ln2"], cfg.norm_eps)
    return x + base.tag_block_out(cfg, base.swiglu(lp["ffn"], h)), newkv


def _layer_slices(stack, rank_dims: int) -> list:
    """Per-layer dicts of a stacked tree (a list is taken as it is)."""
    if isinstance(stack, list):
        return stack
    n = tree.flatten(stack)[0][0].shape[rank_dims]
    return [tree.map_leaves(lambda t, i=i: t.select(rank_dims, i), stack)
            for i in range(n)]


def run_stack(cfg: ModelConfig, params: dict, x: torch.Tensor, *,
              mode: str = "train", cache: dict | None = None,
              pos: int | None = None, gather: Gather = None):
    """All layers; ``mode`` is ``train``, ``prefill`` or ``decode``.

    ``train`` → ``(x, None)``, each layer (its FSDP gather included)
    recomputed in the backward.  ``prefill`` → ``(x, {"layers": {"k",
    "v"}})``, every layer's rotated K and V stacked ``(L, B, S, KV,
    hd)``.  ``decode`` takes that layout as ``cache`` (``{"layers":
    ...}``, without ``pos``) and the step's first position ``pos``, writes
    each layer's K/V into it in place and returns ``(x, cache)``.
    """
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"run_stack: mode {mode!r} is not one of train, "
                         "prefill, decode")
    _check_dense(cfg)
    layers = _layer_slices(params["layers"], _rank_dims(params))
    if mode == "train":
        body = base.remat(cfg, lambda x, lp: _self_layer(
            cfg, _g(gather, lp), x)[0])
        for lp in layers:
            x = body(x, lp)
        return x, None
    if mode == "decode":
        kc, vc = cache["layers"]["k"], cache["layers"]["v"]
        for i, lp in enumerate(layers):
            c = {"k": kc[i], "v": vc[i], "pos": pos}
            x, _ = _self_layer(cfg, _g(gather, lp), x, cache=c,
                               pos_offset=pos)
        return x, cache
    ks, vs = [], []
    for lp in layers:
        x, (kk, vv) = _self_layer(cfg, _g(gather, lp), x)
        ks.append(kk)
        vs.append(vv)
    return x, {"layers": {"k": torch.stack(ks), "v": torch.stack(vs)}}


# ---------------------------------------------------------------------------
# Public entry points.
# ---------------------------------------------------------------------------

def _take_rows(table: torch.Tensor, tokens: torch.Tensor,
               rank_dims: int) -> torch.Tensor:
    """``table[tokens]`` on every rank: ``(*R, V, D)`` and ``(*R, ...)``."""
    if rank_dims == 0:
        return table[tokens.long()]
    p = math.prod(table.shape[:rank_dims])
    t = table.reshape(p, *table.shape[rank_dims:])
    idx = tokens.reshape(p, -1).long()
    rows = torch.arange(p, device=table.device)[:, None]
    return t[rows, idx].reshape(*tokens.shape, table.shape[-1])


def _embed(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
           gather: Gather):
    emb = params["embed"]
    if gather is not None:
        emb = gather({"embed": emb})["embed"]
    x = _take_rows(emb.to(cfg.dtype), tokens, _rank_dims(params))
    return x, emb


def _head(cfg: ModelConfig, params: dict, emb: torch.Tensor,
          gather: Gather) -> torch.Tensor:
    if "lm_head" in params:
        head = params["lm_head"]
        if gather is not None:
            head = gather({"lm_head": head})["lm_head"]
        return head.to(cfg.dtype)
    return emb.transpose(-1, -2).to(cfg.dtype)


def loss_fn(cfg: ModelConfig, params: dict, batch: dict, *,
            gather: Gather = None, loss_chunk: int = 2048) -> torch.Tensor:
    """Mean next-token cross-entropy, one value per rank."""
    tokens, labels = batch["tokens"], batch["labels"]
    x, emb = _embed(cfg, params, tokens, gather)
    x, _ = run_stack(cfg, params, x, mode="train", gather=gather)
    x = base.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    head = _head(cfg, params, emb, gather)
    return chunked_ce(cfg, x, head, labels, loss_chunk,
                      rank_dims=_rank_dims(params))


def chunked_ce(cfg: ModelConfig, x: torch.Tensor, head: torch.Tensor,
               labels: torch.Tensor, chunk: int, rank_dims: int = 0
               ) -> torch.Tensor:
    """Sequence-chunked cross-entropy: no ``(B, S, V)`` logits at once."""
    s = x.shape[-2]
    chunk = min(chunk, s)
    if s % chunk:
        chunk = s
    nc = s // chunk
    tot = torch.zeros(x.shape[:rank_dims], device=x.device)
    for c in range(nc):
        xx = x[..., c * chunk:(c + 1) * chunk, :]
        ll = labels[..., c * chunk:(c + 1) * chunk]
        logits = base.mm(xx, head)
        tot = tot + base.cross_entropy(logits, ll, cfg.logit_softcap,
                                       rank_dims) * (1.0 / nc)
    return tot


def prefill(cfg: ModelConfig, params: dict, batch: dict, *,
            gather: Gather = None):
    """Forward pass over a prompt; returns (last-token logits, cache)."""
    tokens = batch["tokens"]
    x, emb = _embed(cfg, params, tokens, gather)
    x, cache = run_stack(cfg, params, x, mode="prefill", gather=gather)
    x = base.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    head = _head(cfg, params, emb, gather)
    logits = base.softcap(base.mm(x[..., -1:, :], head), cfg.logit_softcap)
    cache["pos"] = tokens.shape[-1]
    return logits, cache


def _host_pos(pos) -> int:
    """The cache's position as a host int (a numpy integer is taken; a
    tensor is refused, since reading one off the card syncs it)."""
    if isinstance(pos, torch.Tensor):
        raise TypeError("cache['pos'] is a host int, not a tensor")
    return operator.index(pos)


def decode_step(cfg: ModelConfig, params: dict, token: torch.Tensor,
                cache: dict, *, gather: Gather = None):
    """One decode step: token (B, S) + cache → (logits (B, S, V), cache).

    The K/V of the step are written into ``cache``'s tensors in place
    (the input cache is consumed, as the reference's is when its decode
    donates it) and the returned cache holds them with ``pos + S``."""
    pos = _host_pos(cache["pos"])
    x, emb = _embed(cfg, params, token, gather)
    layer_caches = {k: v for k, v in cache.items() if k != "pos"}
    x, new_cache = run_stack(cfg, params, x, mode="decode",
                             cache=layer_caches, pos=pos, gather=gather)
    x = base.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    head = _head(cfg, params, emb, gather)
    logits = base.softcap(base.mm(x, head), cfg.logit_softcap)
    new_cache["pos"] = pos + token.shape[-1]
    return logits, new_cache


def init_cache(cfg: ModelConfig, batch_size: int, max_seq: int,
               dtype: torch.dtype | None = None,
               device: str | torch.device | None = None) -> dict:
    """Zero KV cache sized for ``max_seq`` (the decode dry-run's shapes:
    ``pos`` stands at ``max_seq - 1``), on ``device``."""
    _check_dense(cfg)
    dtype = dtype or cfg.dtype
    shape = (cfg.n_layers, batch_size, max_seq, cfg.n_kv_heads, cfg.hd)
    return {"layers": {"k": torch.zeros(shape, dtype=dtype, device=device),
                       "v": torch.zeros(shape, dtype=dtype, device=device)},
            "pos": max_seq - 1}
