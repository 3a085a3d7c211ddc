"""The decoder-only transformer: parameters, the train-mode forward and
the serving steps.

The port of ``repro/models/transformer.py`` for its GQA variants: dense
GQA/MQA (tinyllama-1.1b, granite-20b), local/global layer pairs with
attention and final-logit softcaps, sandwich norms and a tied head
(gemma2-2b, gemma2-27b), and per-head q/k RMSNorm with the MoE FFN
(qwen3-moe-235b-a22b).  ``init_params`` builds the same dict of leaves,
per-layer weights stacked on a leading ``L`` axis (``layers``, or the
pair stacks ``local_layers`` and ``global_layers``), so a gradient
pytree of this shape flattens to the JAX package's leaves in the same
order.  Weights are random from a ``torch.Generator``; they will not
equal the JAX package's ``jax.random`` draws (use ``convert`` to carry
those across).  MLA, cross-attention and the first-dense-layer stack
(deepseek, the VLM) are ROADMAP queue 1 item 14 and refuse.

``loss_fn`` is the train forward: embed → ``run_stack`` (a Python loop
over the layers, or the local/global pairs, each under ``base.remat``,
the FSDP ``gather`` applied inside it so the backward re-gathers) →
final norm → sequence-chunked cross-entropy.  Parameters may carry the
mesh's rank axes in front (``(*R, ...)``, with the stacked ``L`` axis
after them) and the batch ``(*R, B, S)``; the loss then has one value per
rank.  A stack may also be a list of per-layer dicts (how the trainer
hands autograd one leaf per layer).  A tied head is the gathered
embedding's transpose, so autograd sums the embedding's two uses.

``prefill``, ``decode_step`` and ``init_cache`` are the serving steps, on
one rank: the prompt's forward returning its last logits and a cache of
``(L, B, S, KV, hd)`` K/V stacks (``{"layers": {"k", "v"}, "pos"}``, or
``{"local": ..., "global": ..., "pos"}``), and one token a row against
that cache, written in place.  The cache's ``pos`` is a host int, so the
flash kernel's masks (the local layers' window among them) are launch
arguments.
"""
from __future__ import annotations

import math
import operator
from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree
from repro_torch.models import base
from repro_torch.models.base import ModelConfig

Gather = Callable | None


def dense_init(gen: torch.Generator, shape: tuple[int, ...],
               scale: float | None = None) -> torch.Tensor:
    if scale is None:
        scale = shape[-2] ** -0.5 if len(shape) >= 2 else 0.02
    return torch.randn(shape, generator=gen, device=gen.device) * scale


def _mlp(gen: torch.Generator, n: int, d: int, f: int, scale: float
         ) -> dict:
    return {"w_gate": dense_init(gen, (n, d, f), scale),
            "w_up": dense_init(gen, (n, d, f), scale),
            "w_down": dense_init(gen, (n, f, d), f ** -0.5)}


def _layers(cfg: ModelConfig, gen: torch.Generator, n: int) -> dict:
    """``n`` layers' parameters stacked on a leading axis: attention (q/k
    norms with ``qk_norm``), a SwiGLU or MoE FFN, the norms (the post
    norms ``ln1b``/``ln2b`` with ``post_norms``)."""
    d = cfg.d_model
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    scale = d ** -0.5
    zeros = lambda *s: torch.zeros(s, device=gen.device)
    attn = {
        "wq": dense_init(gen, (n, d, h * hd), scale),
        "wk": dense_init(gen, (n, d, kv * hd), scale),
        "wv": dense_init(gen, (n, d, kv * hd), scale),
        "wo": dense_init(gen, (n, h * hd, d), scale),
    }
    if cfg.qk_norm:
        attn["q_norm"] = zeros(n, hd)
        attn["k_norm"] = zeros(n, hd)
    if cfg.is_moe:
        e, f = cfg.n_experts, cfg.moe_d_ff
        ffn = {"router": dense_init(gen, (n, d, e), scale),
               "w_gate": dense_init(gen, (n, e, d, f), scale),
               "w_up": dense_init(gen, (n, e, d, f), scale),
               "w_down": dense_init(gen, (n, e, f, d), f ** -0.5)}
        if cfg.n_shared_experts:
            ffn["shared"] = _mlp(gen, n, d, f * cfg.n_shared_experts, scale)
    else:
        ffn = _mlp(gen, n, d, cfg.d_ff, scale)
    p = {"ln1": zeros(n, d), "attn": attn, "ln2": zeros(n, d), "ffn": ffn}
    if cfg.post_norms:
        p["ln1b"] = zeros(n, d)
        p["ln2b"] = zeros(n, d)
    return p


def _check_ported(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported: ROADMAP "
            "queue 1 item 14")
    for field, what in (("mla_kv_lora", "MLA attention"),
                        ("cross_attn_every", "cross-attention"),
                        ("first_dense_layers", "the first-dense-layer stack")):
        if getattr(cfg, field):
            raise NotImplementedError(
                f"{cfg.name}: {what} is not ported: ROADMAP queue 1 item 14")


def init_params(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """fp32 parameters, on ``gen``'s device: one stack ``layers``, or the
    local/global pair stacks ``local_layers`` and ``global_layers`` of
    ``n_layers // 2`` each."""
    _check_ported(cfg)
    params = {
        "embed": dense_init(gen, (cfg.vocab, cfg.d_model), 0.02),
        "final_norm": torch.zeros(cfg.d_model, device=gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab),
                                       cfg.d_model ** -0.5)
    if cfg.local_global:
        params["local_layers"] = _layers(cfg, gen, cfg.n_layers // 2)
        params["global_layers"] = _layers(cfg, gen, cfg.n_layers // 2)
    else:
        params["layers"] = _layers(cfg, gen, cfg.n_layers)
    return params


# ---------------------------------------------------------------------------
# Layer application and the train-mode stack.
# ---------------------------------------------------------------------------

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
    attn_out = base.tag_block_out(cfg, attn_out)
    if cfg.post_norms:
        attn_out = base.rmsnorm(attn_out, lp["ln1b"], cfg.norm_eps)
    x = x + attn_out
    h = base.rmsnorm(x, lp["ln2"], cfg.norm_eps)
    ffn_out = base.moe_block(cfg, lp["ffn"], h) if cfg.is_moe \
        else base.swiglu(lp["ffn"], h)
    ffn_out = base.tag_block_out(cfg, ffn_out)
    if cfg.post_norms:
        ffn_out = base.rmsnorm(ffn_out, lp["ln2b"], cfg.norm_eps)
    return x + ffn_out, newkv


def _layer_slices(stack, rank_dims: int) -> list:
    """Per-layer dicts of a stacked tree (a list is taken as it is)."""
    if isinstance(stack, list):
        return stack
    n = tree.flatten(stack)[0][0].shape[rank_dims]
    return [tree.map_leaves(lambda t, i=i: t.select(rank_dims, i), stack)
            for i in range(n)]


def _stacks(cfg: ModelConfig) -> tuple[tuple[str, str, int], ...]:
    """The parameter stacks a layer walk interleaves, each with its cache
    entry and attention window: one ``layers``, or the local/global
    pairs."""
    if cfg.local_global:
        return (("local_layers", "local", cfg.window),
                ("global_layers", "global", 0))
    return (("layers", "layers", 0),)


def run_stack(cfg: ModelConfig, params: dict, x: torch.Tensor, *,
              mode: str = "train", cache: dict | None = None,
              pos: int | None = None, gather: Gather = None):
    """All layers; ``mode`` is ``train``, ``prefill`` or ``decode``.

    The layers are ``params["layers"]``, or with ``local_global`` the
    pairs of ``local_layers[i]`` (attending within ``cfg.window``) and
    ``global_layers[i]``.  ``train`` → ``(x, None)``, each layer (a pair
    with ``local_global``), its FSDP gather included, recomputed in the
    backward.  ``prefill`` → ``(x, cache)``, every layer's rotated K and
    V stacked ``(L, B, S, KV, hd)`` under ``{"layers": {"k", "v"}}`` (or
    ``{"local": ..., "global": ...}``, ``L`` the pairs).  ``decode`` takes
    that layout as ``cache`` (without ``pos``) and the step's first
    position ``pos``, writes each layer's K/V into it in place and returns
    ``(x, cache)``.
    """
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"run_stack: mode {mode!r} is not one of train, "
                         "prefill, decode")
    _check_ported(cfg)
    stacks = _stacks(cfg)
    rd = _rank_dims(params)
    groups = list(zip(*(_layer_slices(params[name], rd)
                        for name, _, _ in stacks)))
    if mode == "train":
        def group(x, *lps):
            for (_, _, win), lp in zip(stacks, lps):
                x = _self_layer(cfg, _g(gather, lp), x, window=win)[0]
            return x
        body = base.remat(cfg, group)
        for lps in groups:
            x = body(x, *lps)
        return x, None
    if mode == "decode":
        for i, lps in enumerate(groups):
            for (_, entry, win), lp in zip(stacks, lps):
                c = {"k": cache[entry]["k"][i], "v": cache[entry]["v"][i],
                     "pos": pos}
                x, _ = _self_layer(cfg, _g(gather, lp), x, window=win,
                                   cache=c, pos_offset=pos)
        return x, cache
    kvs = {entry: ([], []) for _, entry, _ in stacks}
    for lps in groups:
        for (_, entry, win), lp in zip(stacks, lps):
            x, (kk, vv) = _self_layer(cfg, _g(gather, lp), x, window=win)
            kvs[entry][0].append(kk)
            kvs[entry][1].append(vv)
    return x, {entry: {"k": torch.stack(ks), "v": torch.stack(vs)}
               for entry, (ks, vs) in kvs.items()}


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


def _chunk_ce(cap: float, x: torch.Tensor, head: torch.Tensor,
              labels: torch.Tensor, rank_dims: int = 0) -> torch.Tensor:
    return base.cross_entropy(base.mm(x, head), labels, cap, rank_dims)


def _ce_fits(nbytes: int, device: torch.device) -> bool:
    """Whether ``nbytes`` may be held on ``device`` now with as much again
    left for the backward: twice ``nbytes`` within the device's free
    memory plus the CUDA allocator's cached-but-free bytes.  On the CPU,
    always."""
    if device.type != "cuda":
        return True
    free, _ = torch.cuda.mem_get_info(device)
    cached = (torch.cuda.memory_reserved(device)
              - torch.cuda.memory_allocated(device))
    return 2 * nbytes <= free + cached


def chunked_ce(cfg: ModelConfig, x: torch.Tensor, head: torch.Tensor,
               labels: torch.Tensor, chunk: int, rank_dims: int = 0
               ) -> torch.Tensor:
    """Sequence-chunked cross-entropy: no ``(B, S, V)`` logits at once.

    Each chunk's fp32 log-softmax (and its softcap's tanh) is kept for
    the backward, so the loss holds about ``nc · (1 + capped) + 2``
    copies of one chunk's fp32 logits over every rank.  Where those fit
    in the device's free memory (``_ce_fits``) the chunks are taken over
    all ranks at once, as the reference does.  Where they do not (gemma2's
    vocab of 256000: 16.8 GB of logits a chunk of 2048 on 8 ranks), each
    rank's chunk is taken alone under ``checkpoint`` and recomputed in the
    backward, so one rank's logits are all that is live.  Both sum a
    rank's chunks in order, as the reference's scan does, and give the
    same values."""
    s = x.shape[-2]
    chunk = min(chunk, s)
    if s % chunk:
        chunk = s
    nc = s // chunk
    rows = math.prod(labels.shape[:-1]) * chunk
    copies = nc * (2 if cfg.logit_softcap else 1) + 2
    if _ce_fits(copies * rows * head.shape[-1] * 4, x.device):
        tot = torch.zeros(x.shape[:rank_dims], device=x.device)
        for c in range(nc):
            sl = slice(c * chunk, (c + 1) * chunk)
            tot = tot + _chunk_ce(cfg.logit_softcap, x[..., sl, :], head,
                                  labels[..., sl], rank_dims) * (1.0 / nc)
        return tot
    xs = x.reshape(-1, *x.shape[rank_dims:])
    hs = head.reshape(-1, *head.shape[-2:])
    ls = labels.reshape(-1, *labels.shape[rank_dims:])
    tot = []
    for r in range(xs.shape[0]):
        t = torch.zeros((), device=x.device)
        for c in range(nc):
            sl = slice(c * chunk, (c + 1) * chunk)
            ce = checkpoint(_chunk_ce, cfg.logit_softcap, xs[r, ..., sl, :],
                            hs[r], ls[r, ..., sl], use_reentrant=False)
            t = t + ce * (1.0 / nc)
        tot.append(t)
    return torch.stack(tot).reshape(x.shape[:rank_dims])


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
    ``pos`` stands at ``max_seq - 1``), on ``device``: ``{"layers": {"k",
    "v"}}`` of ``(L, B, max_seq, KV, hd)``, or ``{"local": ..., "global":
    ...}`` of the pairs."""
    _check_ported(cfg)
    dtype = dtype or cfg.dtype
    n = cfg.n_layers // 2 if cfg.local_global else cfg.n_layers
    shape = (n, batch_size, max_seq, cfg.n_kv_heads, cfg.hd)
    cache: dict = {entry: {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device)}
        for _, entry, _ in _stacks(cfg)}
    cache["pos"] = max_seq - 1
    return cache
