"""Whisper-medium encoder-decoder backbone (arXiv:2212.04356).

The port of ``repro/models/whisper.py``.  The conv frontend is a stub:
the batch holds precomputed frame embeddings ``enc_frames`` ``(B,
encoder_tokens, D)`` (fp32 from the data pipeline; the model casts
them).  LayerNorm with a bias, tanh-GELU MLPs with biases, learned
positional embeddings (the decoder's table extended past Whisper's
native 448 to the shape cells), a tied output head.  Attention has
biases on q, v and o, none on k.  Encoder layers: non-causal
self-attention and MLP, each under ``base.remat`` in every mode, as the
reference's.  Decoder layers: causal self-attention, cross-attention
over the encoder output, MLP; under ``base.remat`` in training only.

Parameters may carry the mesh's rank axes in front (``(*R, ...)``, the
stacked ``L`` axis after them) with the batch ``(*R, B, ...)``, as in
``transformer``; a stack may be a list of per-layer dicts (the
trainer's autograd view).  Every weight product runs once per rank
(``base.mm``); attention folds the rank axes into its batch.

Serving (on the rank axes too, the cache's heads split over ``model``,
``serve.engine.make_serve_fns``): ``prefill`` encodes the frames and
returns the last logits and the cache ``{"dec": {"k", "v", "xk", "xv"},
"pos"}``,
the self K/V ``(L, B, S, H, hd)`` of the prompt and the cross K/V ``(L,
B, encoder_tokens, H, hd)``, filled once.  ``decode_step`` writes the
step's self K/V into the cache in place at ``pos`` (clamped as
``dynamic_update_slice`` clamps) and attends over the first ``pos + S``
entries; the cross-attention reads the cross K/V, non-causal, and never
rewrites them.  ``pos`` is a host int, so the flash kernel's masks are
launch arguments.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core import tp
from repro_torch.models import base
from repro_torch.models import transformer as tf
from repro_torch.models.base import ModelConfig
from repro_torch.models.transformer import dense_init

Gather = Callable | None


def _ln(shape: tuple, device) -> dict:
    return {"w": torch.ones(shape, device=device),
            "b": torch.zeros(shape, device=device)}


def _attn(cfg: ModelConfig, gen: torch.Generator, n: int) -> dict:
    d, hd = cfg.d_model, cfg.n_heads * cfg.hd
    zeros = lambda *s: torch.zeros(s, device=gen.device)      # noqa: E731
    return {"wq": dense_init(gen, (n, d, hd)),
            "wk": dense_init(gen, (n, d, hd)),
            "wv": dense_init(gen, (n, d, hd)),
            "wo": dense_init(gen, (n, hd, d)),
            "bq": zeros(n, hd), "bv": zeros(n, hd), "bo": zeros(n, d)}


def _mlp(cfg: ModelConfig, gen: torch.Generator, n: int) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {"w_up": dense_init(gen, (n, d, f)),
            "b_up": torch.zeros((n, f), device=gen.device),
            "w_down": dense_init(gen, (n, f, d)),
            "b_down": torch.zeros((n, d), device=gen.device)}


def init_layer(cfg: ModelConfig, gen: torch.Generator, decoder: bool
               ) -> dict:
    """One encoder or decoder layer's parameters, on a leading axis of 1:
    norms ``ln1``/``ln2`` (and the decoder's ``ln_x``), ``attn``, the
    decoder's ``xattn`` and ``mlp``."""
    ln = (1, cfg.d_model)
    p = {"ln1": _ln(ln, gen.device), "attn": _attn(cfg, gen, 1)}
    if decoder:
        p.update(ln_x=_ln(ln, gen.device), xattn=_attn(cfg, gen, 1))
    p.update(ln2=_ln(ln, gen.device), mlp=_mlp(cfg, gen, 1))
    return p


def init_params(cfg: ModelConfig, gen: torch.Generator,
                cast: Callable = lambda t: t) -> dict:
    """fp32 parameters on ``gen``'s device, the reference's leaves
    (``embed``, ``dec_pos``, ``enc_pos``, ``enc_layers``, ``dec_layers``,
    ``enc_norm``, ``final_norm``), each layer drawn and ``cast`` one at a
    time (``transformer.draw_stack``)."""
    d, dev = cfg.d_model, gen.device
    params = cast({
        "embed": dense_init(gen, (cfg.vocab, d), 0.02),
        "dec_pos": dense_init(gen, (cfg.max_positions, d), 0.01),
        "enc_pos": dense_init(gen, (cfg.encoder_tokens, d), 0.01),
        "enc_norm": _ln((d,), dev),
        "final_norm": _ln((d,), dev),
    })
    params["enc_layers"] = tf.draw_stack(
        cfg.encoder_layers, lambda: init_layer(cfg, gen, False), cast)
    params["dec_layers"] = tf.draw_stack(
        cfg.n_layers, lambda: init_layer(cfg, gen, True), cast)
    return params


# ---------------------------------------------------------------------------
# Blocks.
# ---------------------------------------------------------------------------

def _g(gather: Gather, lp: dict) -> dict:
    return gather(lp) if gather is not None else lp


def _rank_dims(params: dict) -> int:
    return params["final_norm"]["w"].dim() - 1


def _norm(x: torch.Tensor, p: dict) -> torch.Tensor:
    return base.layernorm(x, p["w"], p["b"])


def _bias(y: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return y + base._lift(b, y)


def _rows(table: torch.Tensor, start: int, n: int, rank_dims: int
          ) -> torch.Tensor:
    """Rows ``start … start + n`` of a ``(*R, P, D)`` table, shaped to add
    to ``(*R, B, n, D)`` activations."""
    t = table[..., start:start + n, :]
    return t.unsqueeze(rank_dims) if rank_dims else t


def _mha(cfg: ModelConfig, p: dict, xq: torch.Tensor,
         xkv: torch.Tensor | None, *, causal: bool,
         cache: dict | None = None) -> tuple:
    """Multi-head attention with biases on q, v and o; returns ``(out,
    (k, v))``.  ``xkv`` is the keys' source (``xq`` itself, or the
    encoder output), or ``None`` to read precomputed cross K/V from
    ``cache`` (``{"k", "v"}``).  With both, ``cache`` is a self-attention
    decode's ``{"k", "v", "pos"}``: the step's K/V are written into it in
    place at ``pos`` and the queries attend at ``pos + arange(S)`` over
    its first ``pos + S`` entries.  Under tensor parallelism a rank runs
    its heads (its blocks of ``bq`` and ``bv``), ``wo`` row-parallel and
    ``bo`` once, after the sum over ``model``."""
    *lead, s, _ = xq.shape
    hd = cfg.hd
    h, md = base._heads(cfg, p["wq"])
    bq, bv = p["bq"], p["bv"]
    if md is not None:
        same = xkv is xq
        xq = tp.copy_to_model(xq, md)
        if xkv is not None:
            xkv = xq if same else tp.copy_to_model(xkv, md)
        bq, bv = tp.local_slice(bq, md), tp.local_slice(bv, md)
    q = _bias(base.mm(xq, p["wq"]), bq).reshape(*lead, s, h, hd)
    if xkv is not None:
        t = xkv.shape[-2]
        k = base.mm(xkv, p["wk"]).reshape(*lead, t, h, hd)
        v = _bias(base.mm(xkv, p["wv"]), bv).reshape(*lead, t, h, hd)
    else:
        k, v = cache["k"], cache["v"]              # precomputed cross K/V
    q_pos = kv_len = None
    if cache is not None and base.seq_split("dec"):
        raise NotImplementedError(
            f"whisper's cache lies split over its sequence on model (its "
            f"{cfg.n_heads} heads over {tp.size()} ranks); the port "
            "attends it split over its heads only")
    if cache is not None and xkv is not None:      # self-attention decode
        q_pos = cache["pos"]
        kv_len = q_pos + s
        base.write_cache(cache["k"], k, q_pos, dim=len(lead))
        base.write_cache(cache["v"], v, q_pos, dim=len(lead))
        k, v = cache["k"], cache["v"]
    if cache is not None and len(lead) > 1:        # a cache on the rank axes
        out = base.attend_ranks(q, k, v, causal=causal, q_pos=q_pos,
                                kv_len=kv_len)
    else:
        out = base.attend(q.reshape(-1, s, h, hd),
                          k.reshape(-1, *k.shape[-3:]),
                          v.reshape(-1, *v.shape[-3:]), causal=causal,
                          q_pos=q_pos, kv_len=kv_len,
                          chunk=cfg.attn_chunk if cache is None else 0)
    out = base.mm(out.reshape(*lead, s, h * hd), p["wo"])
    if md is not None:
        out = tp.reduce_from_model(out, md)
    return _bias(out, p["bo"]), (k, v)


def encode(cfg: ModelConfig, params: dict, frames: torch.Tensor, *,
           gather: Gather = None) -> torch.Tensor:
    """``frames`` ``(*R, B, encoder_tokens, D)`` (the stub frontend's
    output, any float dtype) → the encoder output in the compute dtype.
    Every layer runs under ``base.remat``, in every mode, as the
    reference's scan body does."""
    rd = _rank_dims(params)
    enc_pos = params["enc_pos"]
    if gather is not None:
        enc_pos = gather({"enc_pos": enc_pos})["enc_pos"]
    x = frames.to(cfg.dtype) + _rows(enc_pos.to(cfg.dtype), 0,
                                     cfg.encoder_tokens, rd)

    def body(x, lp):
        lp = _g(gather, lp)
        h = _norm(x, lp["ln1"])
        x = x + _mha(cfg, lp["attn"], h, h, causal=False)[0]
        return x + base.gelu_mlp(lp["mlp"], _norm(x, lp["ln2"]), cfg.d_ff)
    body = base.remat(cfg, body)
    for lp in tf._layer_slices(params["enc_layers"], rd):
        x = body(x, lp)
    return _norm(x, params["enc_norm"])


def _decoder(cfg: ModelConfig, params: dict, x: torch.Tensor,
             enc_out: torch.Tensor | None, *, mode: str,
             cache: dict | None = None, pos: int | None = None,
             gather: Gather = None):
    """The decoder stack; ``mode`` is ``train`` (``(x, None)``, each layer
    under ``base.remat``), ``prefill`` (``(x, {"dec": {"k", "v", "xk",
    "xv"}})``, every layer's K/V stacked) or ``decode`` (``cache`` that
    layout, written in place, and returned)."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"_decoder: mode {mode!r} is not one of train, "
                         "prefill, decode")
    slices = tf._layer_slices(params["dec_layers"], _rank_dims(params))

    def layer(x, lp, enc_out, lc=None):
        lp = _g(gather, lp)
        h = _norm(x, lp["ln1"])
        c = None if lc is None else {"k": lc["k"], "v": lc["v"], "pos": pos}
        a, kv = _mha(cfg, lp["attn"], h, h, causal=True, cache=c)
        x = x + base.tag_block_out(cfg, a)
        h = _norm(x, lp["ln_x"])
        if lc is None:
            a, xkv = _mha(cfg, lp["xattn"], h, enc_out, causal=False)
        else:
            a, xkv = _mha(cfg, lp["xattn"], h, None, causal=False,
                          cache={"k": lc["xk"], "v": lc["xv"]})
        x = x + a
        h = _norm(x, lp["ln2"])
        x = x + base.tag_block_out(cfg, base.gelu_mlp(lp["mlp"], h,
                                                      cfg.d_ff))
        return x, kv, xkv

    if mode == "train":
        run = base.remat(cfg, lambda x, enc_out, lp: layer(x, lp, enc_out)[0])
        for lp in slices:
            x = run(x, enc_out, lp)
        return x, None
    rd = _rank_dims(params)
    if mode == "decode":
        dec = cache["dec"]
        for i, lp in enumerate(slices):
            x = layer(x, lp, None, {k: t.select(rd, i)
                                    for k, t in dec.items()})[0]
        return x, cache
    kvs: dict = {"k": [], "v": [], "xk": [], "xv": []}
    for lp in slices:
        x, kv, xkv = layer(x, lp, enc_out)
        for name, t in zip(kvs, (*kv, *xkv)):
            kvs[name].append(t)
    return x, {"dec": {k: torch.stack(v, rd) for k, v in kvs.items()}}


def _embed(cfg: ModelConfig, params: dict, tokens: torch.Tensor, pos: int,
           gather: Gather) -> tuple:
    """Token rows plus the decoder positions ``pos …`` (the start clamped
    to the table as ``dynamic_slice`` clamps it); returns ``(x, emb)``."""
    emb, dec_pos = params["embed"], params["dec_pos"]
    if gather is not None:
        g = gather({"embed": emb, "dec_pos": dec_pos})
        emb, dec_pos = g["embed"], g["dec_pos"]
    rd = _rank_dims(params)
    s = tokens.shape[-1]
    start = min(max(pos, 0), dec_pos.shape[-2] - s)
    x = tf.lookup(cfg, emb, tokens, rd) \
        + _rows(dec_pos, start, s, rd).to(cfg.dtype)
    return x, emb


def _logits(cfg: ModelConfig, params: dict, x: torch.Tensor,
            emb: torch.Tensor) -> torch.Tensor:
    """The final norm and the tied head."""
    x = _norm(x, params["final_norm"])
    return base.mm(x, emb.transpose(-1, -2).to(cfg.dtype))


# ---------------------------------------------------------------------------
# Public entry points.
# ---------------------------------------------------------------------------

def loss_fn(cfg: ModelConfig, params: dict, batch: dict, *,
            gather: Gather = None, loss_chunk: int = 2048) -> torch.Tensor:
    """Mean next-token cross-entropy of the decoder, one value per rank."""
    tokens, labels = batch["tokens"], batch["labels"]
    enc_out = encode(cfg, params, batch["enc_frames"], gather=gather)
    x, emb = _embed(cfg, params, tokens, 0, gather)
    x, _ = _decoder(cfg, params, x, enc_out, mode="train", gather=gather)
    x = _norm(x, params["final_norm"])
    head = emb.transpose(-1, -2).to(cfg.dtype)
    return tf.chunked_ce(cfg, x, head, labels, loss_chunk,
                         rank_dims=_rank_dims(params))


def prefill(cfg: ModelConfig, params: dict, batch: dict, *,
            gather: Gather = None):
    """Encode ``enc_frames`` and run the prompt; returns (last-token
    logits, cache)."""
    tokens = batch["tokens"]
    enc_out = encode(cfg, params, batch["enc_frames"], gather=gather)
    x, emb = _embed(cfg, params, tokens, 0, gather)
    x, cache = _decoder(cfg, params, x, enc_out, mode="prefill",
                        gather=gather)
    cache["pos"] = tokens.shape[-1]
    return _logits(cfg, params, x[..., -1:, :].contiguous(), emb), cache


def decode_step(cfg: ModelConfig, params: dict, token: torch.Tensor,
                cache: dict, *, gather: Gather = None):
    """One decode step: token (B, S) + cache → (logits (B, S, V), cache),
    the cache's self K/V written in place (the input cache is consumed,
    as the reference's is under donation)."""
    pos = tf._host_pos(cache["pos"])
    x, emb = _embed(cfg, params, token, pos, gather)
    layer_caches = {k: v for k, v in cache.items() if k != "pos"}
    x, new_cache = _decoder(cfg, params, x, None, mode="decode",
                            cache=layer_caches, pos=pos, gather=gather)
    new_cache["pos"] = pos + token.shape[-1]
    return _logits(cfg, params, x, emb), new_cache


def init_cache(cfg: ModelConfig, batch_size: int, max_seq: int,
               dtype: torch.dtype | None = None,
               device: str | torch.device | None = None) -> dict:
    """Zero cache sized for ``max_seq`` (``pos`` at ``max_seq - 1``), on
    ``device``, in ``dtype`` (the compute dtype by default): self K/V
    ``(L, B, max_seq, H, hd)`` and zero cross K/V ``(L, B,
    encoder_tokens, H, hd)``.  Decoding against the zero cross K/V is what
    the slot server does, as the reference's does: it passes no
    ``enc_frames``."""
    dtype = dtype or cfg.dtype
    h, hd, n, b = cfg.n_heads, cfg.hd, cfg.n_layers, batch_size
    zeros = lambda *s: torch.zeros(s, dtype=dtype,            # noqa: E731
                                   device=device)
    return {"dec": {"k": zeros(n, b, max_seq, h, hd),
                    "v": zeros(n, b, max_seq, h, hd),
                    "xk": zeros(n, b, cfg.encoder_tokens, h, hd),
                    "xv": zeros(n, b, cfg.encoder_tokens, h, hd)},
            "pos": max_seq - 1}
