"""The decoder-only transformer: parameters, the train-mode forward and
the serving steps.

The port of ``repro/models/transformer.py``, all its variants: dense
GQA/MQA (tinyllama-1.1b, granite-20b), local/global layer pairs with
attention and final-logit softcaps, sandwich norms and a tied head
(gemma2-2b, gemma2-27b), per-head q/k RMSNorm with the MoE FFN
(qwen3-moe-235b-a22b), MLA attention with a dense first layer and MoE
layers with shared experts (deepseek-v2-lite-16b), and groups of self
layers each closed by a gated cross-attention layer over vision
embeddings (llama-3.2-vision-90b).  ``init_params`` builds the same dict
of leaves, per-layer weights stacked on a leading ``L`` axis (the roots
:func:`stacks` names), so a gradient pytree of this shape flattens to
the JAX package's leaves in the same order.  Weights are random from a
``torch.Generator``; they will not equal the JAX package's
``jax.random`` draws (use ``convert`` to carry those across).

``loss_fn`` is the train forward: embed → ``run_stack`` (a Python loop
over the layers in :func:`_walk`'s order, each self layer or
local/global pair under ``base.remat``, the FSDP ``gather`` applied
inside it so the backward re-gathers) → final norm → sequence-chunked
cross-entropy.  Parameters may carry the mesh's rank axes in front
(``(*R, ...)``, with the stacked ``L`` axis after them) and the batch
``(*R, B, S)`` (the VLM's ``vision_embeds`` ``(*R, B, T, D)``); the loss
then has one value per rank.  A stack may also be a list of per-layer
dicts (how the trainer hands autograd one leaf per layer).  A tied head
is the gathered embedding's transpose, so autograd sums the embedding's
two uses.

``prefill``, ``decode_step`` and ``init_cache`` are the serving steps, on
one rank: the prompt's forward returning its last logits and a cache of
per-stack K/V (``{"layers": {"k", "v"}, "pos"}``, ``{"local", "global",
"pos"}``, deepseek's ``{"dense": {"c_kv", "k_rope"}, "moe": ...,
"pos"}`` or the VLM's ``{"self", "cross", "pos"}``), and one token a row
against that cache, written in place.  The cache's ``pos`` is a host
int, so the flash kernel's masks (the local layers' window among them)
are launch arguments.
"""
from __future__ import annotations

import math
import operator
from typing import Callable, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree
from repro_torch.core import tp
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


def _attn(cfg: ModelConfig, gen: torch.Generator, n: int, scale: float,
          mla: bool) -> dict:
    """``n`` layers' attention: GQA (q/k norms with ``qk_norm``), or MLA's
    query, compressed KV (``w_dkv``), shared rope key (``w_kr``) and KV
    up-projection (``w_ukv``)."""
    d, h = cfg.d_model, cfg.n_heads
    if mla:
        qk = cfg.mla_qk_nope + cfg.mla_qk_rope
        lora = cfg.mla_kv_lora
        return {"wq": dense_init(gen, (n, d, h * qk), scale),
                "w_dkv": dense_init(gen, (n, d, lora), scale),
                "w_kr": dense_init(gen, (n, d, cfg.mla_qk_rope), scale),
                "w_ukv": dense_init(gen, (n, lora, h * (cfg.mla_qk_nope
                                                        + cfg.mla_v_dim)),
                                    lora ** -0.5),
                "wo": dense_init(gen, (n, h * cfg.mla_v_dim, d), scale)}
    kv, hd = cfg.n_kv_heads, cfg.hd
    attn = {"wq": dense_init(gen, (n, d, h * hd), scale),
            "wk": dense_init(gen, (n, d, kv * hd), scale),
            "wv": dense_init(gen, (n, d, kv * hd), scale),
            "wo": dense_init(gen, (n, h * hd, d), scale)}
    if cfg.qk_norm:
        attn["q_norm"] = torch.zeros((n, hd), device=gen.device)
        attn["k_norm"] = torch.zeros((n, hd), device=gen.device)
    return attn


def _layers(cfg: ModelConfig, gen: torch.Generator, n: int, *,
            moe: bool, mla: bool = False) -> dict:
    """``n`` layers' parameters stacked on a leading axis: attention
    (``_attn``), a SwiGLU FFN ``d_ff`` wide or the MoE FFN (its shared
    experts ``moe_d_ff · n_shared_experts`` wide), the norms (the post
    norms ``ln1b``/``ln2b`` with ``post_norms``)."""
    d = cfg.d_model
    scale = d ** -0.5
    zeros = lambda *s: torch.zeros(s, device=gen.device)    # noqa: E731
    attn = _attn(cfg, gen, n, scale, mla)
    if moe:
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


class Stack(NamedTuple):
    """One stack of layers: its parameter root, its serving cache entry,
    its depth, whether its FFN is the MoE block and its attention
    window (0: none)."""

    name: str
    entry: str
    n: int
    moe: bool = False
    window: int = 0


def stacks(cfg: ModelConfig) -> tuple[Stack, ...]:
    """The model's layer stacks, in the reference's ``init_params``
    order: the VLM's ``ngroups · (g − 1)`` self ``layers`` and ``ngroups``
    ``cross_layers`` (g = ``cross_attn_every``); gemma2's
    ``local_layers`` and ``global_layers`` pairs; deepseek's
    ``first_dense_layers`` ``dense_layers`` and its MoE ``layers``; or one
    ``layers`` stack."""
    n, moe = cfg.n_layers, cfg.is_moe
    if cfg.cross_attn_every > 0:
        ngroups = n // cfg.cross_attn_every
        return (Stack("layers", "self", ngroups * (cfg.cross_attn_every - 1)),
                Stack("cross_layers", "cross", ngroups))
    if cfg.local_global:
        return (Stack("local_layers", "local", n // 2, moe, cfg.window),
                Stack("global_layers", "global", n // 2, moe))
    if cfg.first_dense_layers > 0:
        return (Stack("dense_layers", "dense", cfg.first_dense_layers),
                Stack("layers", "moe", n - cfg.first_dense_layers, moe))
    return (Stack("layers", "layers", n, moe),)


def init_layer(cfg: ModelConfig, gen: torch.Generator, stack: Stack
               ) -> dict:
    """One layer of ``stack``'s parameters, on a leading axis of 1; a
    cross layer also has its tanh gates and its q/k norms."""
    p = _layers(cfg, gen, 1, moe=stack.moe,
                mla=cfg.mla_kv_lora > 0 and stack.name != "cross_layers")
    if stack.name == "cross_layers":
        zeros = lambda *s: torch.zeros(s, device=gen.device)  # noqa: E731
        p.update(gate_attn=zeros(1, 1), gate_mlp=zeros(1, 1),
                 q_norm=zeros(1, cfg.hd), k_norm=zeros(1, cfg.hd))
    return p


def init_top(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """The parameters outside the layer stacks: the embedding, the final
    norm and (untied) the head."""
    params = {
        "embed": dense_init(gen, (cfg.vocab, cfg.d_model), 0.02),
        "final_norm": torch.zeros(cfg.d_model, device=gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab),
                                       cfg.d_model ** -0.5)
    return params


def init_params(cfg: ModelConfig, gen: torch.Generator,
                cast: Callable = lambda t: t) -> dict:
    """fp32 parameters, on ``gen``'s device: :func:`init_top`'s and each
    of :func:`stacks` under its root, passed through ``cast`` (a function
    of a parameter tree, e.g. to the compute dtype; none by default).

    The layers are drawn one at a time, each cast as it is drawn and
    copied into its stack, so that no fp32 stack is ever whole beside its
    cast (at deepseek-v2-lite's 27 layers it would be 62.8 GB); the draws
    come in the same order with or without ``cast``, so a seed gives the
    same weights either way."""
    params = cast(init_top(cfg, gen))
    for stack in stacks(cfg):
        params[stack.name] = draw_stack(
            stack.n, lambda stack=stack: init_layer(cfg, gen, stack), cast)
    return params


def draw_stack(n: int, draw: Callable, cast: Callable) -> dict:
    """``n`` layers stacked on a leading axis: each one ``draw()`` (a
    layer on a leading axis of 1), ``cast`` as it is drawn and copied into
    the stack, so that no uncast stack is ever whole."""
    first = cast(draw())
    out = tree.map_leaves(lambda t: t.new_empty((n, *t.shape[1:])), first)
    for i in range(n):
        layer = first if i == 0 else cast(draw())
        for dst, src in zip(tree.flatten(out)[0], tree.flatten(layer)[0]):
            dst[i].copy_(src[0])
        del layer
    return out


# ---------------------------------------------------------------------------
# Layer application and the stack walk.
# ---------------------------------------------------------------------------

def _g(gather: Gather, lp: dict) -> dict:
    return gather(lp) if gather is not None else lp


def _rank_dims(params: dict) -> int:
    return params["final_norm"].dim() - 1


def _ffn(cfg: ModelConfig, p: dict, h: torch.Tensor, moe: bool
         ) -> torch.Tensor:
    return base.moe_block(cfg, p, h) if moe else base.swiglu(p, h, cfg.d_ff)


def _self_layer(cfg: ModelConfig, lp: dict, x: torch.Tensor, *,
                window: int = 0, cache: dict | None = None,
                pos_offset: int | None = None, moe: bool = False) -> tuple:
    h = base.rmsnorm(x, lp["ln1"], cfg.norm_eps)
    attn_out, newkv = base.gqa_attention(cfg, lp["attn"], h, window=window,
                                         cache=cache, pos_offset=pos_offset)
    attn_out = base.tag_block_out(cfg, attn_out)
    if cfg.post_norms:
        attn_out = base.rmsnorm(attn_out, lp["ln1b"], cfg.norm_eps)
    x = x + attn_out
    h = base.rmsnorm(x, lp["ln2"], cfg.norm_eps)
    ffn_out = base.tag_block_out(cfg, _ffn(cfg, lp["ffn"], h, moe))
    if cfg.post_norms:
        ffn_out = base.rmsnorm(ffn_out, lp["ln2b"], cfg.norm_eps)
    return x + ffn_out, newkv


def _mla_layer(cfg: ModelConfig, lp: dict, x: torch.Tensor, *,
               cache: dict | None = None, pos_offset: int | None = None,
               moe: bool = False) -> tuple:
    """Deepseek's MLA block: low-rank compressed KV and a decoupled rope
    key shared by the heads; returns ``(x, (c_kv, k_rope))``.

    ``cache`` is ``{"c_kv": (B, Smax, kv_lora), "k_rope": (B, Smax, 1,
    rope), "pos": int}`` for a decode step: the step's rows are written
    into it in place (``base.write_cache``) and the queries attend over
    its first ``pos + S`` entries.  Expanded (the default): ``c_kv ·
    w_ukv`` gives every cached row's ``k_nope`` and ``v`` (``v`` a strided
    view), the rope key is broadcast over the heads and concatenated, and
    ``base.attend`` runs at ``(nope + rope, v_dim)``.  ``mla_absorbed``
    with a cache attends in the latent space instead, with fp32 products
    over the compressed cache, as the reference does.

    On the rank axes with ``model`` > 1 the cache is split over its
    sequence (it has no heads): the rows go to the rank that holds them,
    every head's query attends over each rank's block (expanded with
    every head's ``w_ukv`` columns, or in the latent space) and the
    blocks combine by their log-sum-exp."""
    *lead, s, _ = x.shape
    h = base.rmsnorm(x, lp["ln1"], cfg.norm_eps)
    ap = lp["attn"]
    nope, rope, vd = cfg.mla_qk_nope, cfg.mla_qk_rope, cfg.mla_v_dim
    nh, md = base._heads(cfg.scaled(head_dim=nope + rope), ap["wq"])
    scale = (nope + rope) ** -0.5

    hc = tp.copy_to_model(h, md) if md is not None else h
    q = base.mm(hc, ap["wq"]).reshape(*lead, s, nh, nope + rope)
    if md is not None and tp.splits(cfg.mla_kv_lora):
        c_kv = tp.gather_from_model(base.mm(hc, ap["w_dkv"]), md)
    else:
        c_kv = base.mm(h, ap["w_dkv"])                      # (..., S, lora)
    k_r = base.mm(h, ap["w_kr"]).reshape(*lead, s, 1, rope)
    pos0 = pos_offset if pos_offset is not None else 0
    pos = pos0 + torch.arange(s, device=x.device)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = base.apply_rope(q_rope, pos, cfg.rope_theta)
    k_r = base.apply_rope(k_r, pos, cfg.rope_theta)
    if md is not None:
        # the latent and the shared rope key enter the rank's heads
        c_kv, k_r = tp.copy_to_model(c_kv, md), tp.copy_to_model(k_r, md)

    q_pos = kv_len = None
    shards = cache is not None and bool(cache.get("seq"))
    mdx = len(lead) - 2                   # model: the last rank axis
    if cache is not None:
        q_pos = cache["pos"]
        kv_len = q_pos + s
        for name, t in (("c_kv", c_kv), ("k_rope", k_r)):
            base.write_cache(cache[name], t, q_pos, dim=len(lead),
                             md=mdx if shards else None)
        c_kv, k_r = cache["c_kv"], cache["k_rope"]
    sk = c_kv.shape[-2]

    def every_head(t):                    # the rank's heads → all of them
        if not shards or md is None:
            return t
        return tp.copy_to_model(tp.gather_from_model(t, md, -2),
                                md).contiguous()

    def own_heads(t):                     # all the heads → the rank's own
        if not shards or md is None:
            return t
        return tp.own_slice(t, md, t.dim() - 2, nh)

    if cfg.mla_absorbed and cache is not None:
        # scores q_nope·(c_kv·W_uk)ᵀ = (q_nope·W_ukᵀ)·c_kvᵀ: the cache is
        # never re-expanded, and the output stays latent until W_uv; over
        # a sequence split, each rank's block of the latent cache scores
        # every head's latent query, and the blocks' softmaxes combine by
        # their log-sum-exp
        w_ukv = ap["w_ukv"].reshape(*ap["w_ukv"].shape[:-1], nh, nope + vd)
        w_uk, w_uv = w_ukv[..., :nope], w_ukv[..., nope:]
        q_lat = every_head(torch.einsum("...bshn,...lhn->...bshl", q_nope,
                                        w_uk))
        ckv = c_kv.float()
        scores = torch.einsum("...bshl,...btl->...bhst", q_lat.float(), ckv)
        scores = scores + torch.einsum("...bshr,...btqr->...bhst",
                                       every_head(q_rope).float(),
                                       k_r.float())
        scores = scores * scale
        kpos = torch.arange(sk, device=x.device)
        if shards:
            kpos = kpos + tp.rank_index(scores, mdx) * sk
        qp = (q_pos + torch.arange(s, device=x.device))[:, None]
        mask = (kpos <= qp) & (kpos < kv_len)
        scores = torch.where(mask, scores, -1e30)
        if shards:
            seen = mask.any(-1)
            mx = scores.amax(-1, keepdim=True)
            e = torch.exp(scores - mx)
            tot = e.sum(-1, keepdim=True)
            p_attn = torch.where(seen[..., None], e / tot, 0.0)
            lse = torch.where(seen, (mx + torch.log(tot))[..., 0],
                              -torch.inf)
            o_lat = torch.einsum("...bhst,...btl->...bshl", p_attn, ckv)
            o_lat = own_heads(tp.lse_combine(o_lat, lse.transpose(-1, -2),
                                             mdx))
        else:
            p_attn = torch.softmax(scores, dim=-1)
            o_lat = torch.einsum("...bhst,...btl->...bshl", p_attn, ckv)
        out = torch.einsum("...bshl,...lhv->...bshv", o_lat.to(cfg.dtype),
                           w_uv)
    else:
        w_ukv = ap["w_ukv"]
        if shards and md is not None:     # every head's columns
            w_ukv = tp.gather_from_model(w_ukv, md)
        hk = cfg.n_heads if shards and md is not None else nh
        ukv = base.mm(c_kv, w_ukv).reshape(*lead, sk, hk, nope + vd)
        k = torch.cat([ukv[..., :nope],
                       k_r.expand(*lead, sk, hk, rope)], dim=-1)
        qq = torch.cat([q_nope, q_rope], dim=-1)
        if shards:
            out = own_heads(base.attend_shards(
                every_head(qq), k, ukv[..., nope:], q_pos=q_pos,
                kv_len=kv_len, scale=scale))
        elif cache is not None and len(lead) > 1:
            out = base.attend_ranks(qq, k, ukv[..., nope:], causal=True,
                                    q_pos=q_pos, kv_len=kv_len, scale=scale)
        else:
            out = base.attend(qq.reshape(-1, s, nh, nope + rope),
                              k.reshape(-1, sk, nh, nope + rope),
                              ukv[..., nope:].reshape(-1, sk, nh, vd),
                              causal=True, q_pos=q_pos, kv_len=kv_len,
                              scale=scale,
                              chunk=cfg.attn_chunk if cache is None else 0)
    out = base.mm(out.reshape(*lead, s, nh * vd), ap["wo"])
    if md is not None:
        out = tp.reduce_from_model(out, md)
    x = x + base.tag_block_out(cfg, out)
    h = base.rmsnorm(x, lp["ln2"], cfg.norm_eps)
    x = x + base.tag_block_out(cfg, _ffn(cfg, lp["ffn"], h, moe))
    return x, (c_kv, k_r)


def _gated(gate: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``tanh(gate) · y``, a ``(*R, 1)`` gate on every rank's rows."""
    return torch.tanh(base._lift(gate, y)) * y


def _cross_layer(cfg: ModelConfig, lp: dict, x: torch.Tensor,
                 vision_kv: tuple, cached: bool = False,
                 seq: bool = False) -> torch.Tensor:
    """The gated cross-attention layer (llama-3.2-vision): the normed
    queries attend, not causally, over the vision K/V, whose dtype may be
    wider than the queries'.  ``vision_kv`` is :func:`cross_kv`'s, or with
    ``cached`` a decode step's cache entry; on the rank axes a cache
    split over its vision tokens (``seq``) is attended by
    every head's query over each rank's block, combined over ``model``
    (``base.attend_shards``)."""
    h = base.rmsnorm(x, lp["ln1"], cfg.norm_eps)
    *lead, s, _ = x.shape
    hd = cfg.hd
    ap = lp["attn"]
    nh, md = base._heads(cfg, ap["wq"])
    qn = lp["q_norm"]
    if md is not None:
        h, qn = tp.copy_to_model(h, md), tp.copy_to_model(qn, md)
    q = base.mm(h, ap["wq"]).reshape(*lead, s, nh, hd)
    q = base.rmsnorm(q, qn, cfg.norm_eps)
    k, v = vision_kv
    if cached and seq:
        qa = q if md is None else tp.copy_to_model(
            tp.gather_from_model(q, md, -2), md).contiguous()
        out = base.attend_shards(qa, k, v, causal=False,
                                 kv_len=k.shape[-3] * tp.size())
        if md is not None:
            out = tp.own_slice(out, md, out.dim() - 2, nh)
    elif cached:
        out = base.attend_ranks(q, k, v, causal=False)
    else:
        k, v = base.heads_of(cfg, (k, v), md)
        out = base.attend(q.reshape(-1, s, nh, hd),
                          k.reshape(-1, *k.shape[-3:]),
                          v.reshape(-1, *v.shape[-3:]), causal=False)
    out = base.mm(out.reshape(*lead, s, nh * hd), ap["wo"])
    if md is not None:
        out = tp.reduce_from_model(out, md)
    x = x + _gated(lp["gate_attn"], out)
    h = base.rmsnorm(x, lp["ln2"], cfg.norm_eps)
    return x + _gated(lp["gate_mlp"], base.swiglu(lp["ffn"], h, cfg.d_ff))


def cross_kv(cfg: ModelConfig, lp: dict, vision_embeds: torch.Tensor
             ) -> tuple:
    """A cross layer's K/V ``(*R, B, T, KV, hd)`` from the (gathered)
    layer's weights, as a cache holds them (``base.kv_heads``), in the
    promoted dtype of the embeddings and the weights, as ``jnp``'s ``@``
    promotes them: the data pipeline's fp32 ``vision_embeds`` give fp32
    K/V against bf16 weights."""
    ap = lp["attn"]
    dt = torch.promote_types(vision_embeds.dtype, ap["wk"].dtype)
    _, md = base._heads(cfg, ap["wq"])
    ve = vision_embeds.to(dt)
    return base.kv_heads(cfg, {"wk": ap["wk"].to(dt), "wv": ap["wv"].to(dt),
                               "k_norm": lp["k_norm"]}, ve, md,
                         tp.copy_to_model(ve, md) if md is not None else None)


def _layer_slices(stack, rank_dims: int) -> list:
    """Per-layer dicts of a stacked tree (a list is taken as it is)."""
    if isinstance(stack, list):
        return stack
    n = tree.flatten(stack)[0][0].shape[rank_dims]
    return [tree.map_leaves(lambda t, i=i: t.select(rank_dims, i), stack)
            for i in range(n)]


def _walk(cfg: ModelConfig) -> list[tuple[Stack, int]]:
    """The layers in the order they run, each a (stack, index): the VLM's
    groups of ``g − 1`` self layers then one cross layer, gemma2's
    local/global pairs, or each stack after the other (deepseek's dense
    layers, then its MoE layers)."""
    st = stacks(cfg)
    if cfg.cross_attn_every > 0:
        selfs, cross = st
        per = selfs.n // max(cross.n, 1)
        return [step for j in range(cross.n)
                for step in [(selfs, j * per + i) for i in range(per)]
                + [(cross, j)]]
    if cfg.local_global:
        local, glob = st
        return [step for i in range(local.n)
                for step in ((local, i), (glob, i))]
    return [(stack, i) for stack in st for i in range(stack.n)]


def _kv_names(cfg: ModelConfig, stack: Stack) -> tuple[str, str]:
    if cfg.mla_kv_lora > 0 and stack.name != "cross_layers":
        return "c_kv", "k_rope"
    return "k", "v"


def run_stack(cfg: ModelConfig, params: dict, x: torch.Tensor, *,
              mode: str = "train", cache: dict | None = None,
              pos: int | None = None,
              vision_embeds: torch.Tensor | None = None,
              gather: Gather = None):
    """All layers, in :func:`_walk`'s order; ``mode`` is ``train``,
    ``prefill`` or ``decode``.

    A self layer is GQA attention (a gemma2 local layer's within
    ``cfg.window``) or, with ``mla_kv_lora``, MLA; a cross layer attends
    over :func:`cross_kv` of ``vision_embeds``.  ``train`` → ``(x,
    None)``, each self layer (a local/global pair) with its FSDP gather
    recomputed in the backward under ``base.remat``; a cross layer is not
    (the reference remats only the VLM's self layers).  ``prefill`` →
    ``(x, cache)``: every layer's K/V stacked ``(L, B, S, KV, hd)`` under
    its stack's entry, ``{"k", "v"}`` (MLA's ``{"c_kv": (L, B, S,
    kv_lora), "k_rope": (L, B, S, 1, rope)}``; a cross layer's ``(L, B,
    T, KV, hd)`` vision K/V).  ``decode`` takes that layout as ``cache``
    (without ``pos``) and the step's first position ``pos``, writes each
    self layer's K/V into it in place, reads the cross K/V and never
    rewrites them, and returns ``(x, cache)``.
    """
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"run_stack: mode {mode!r} is not one of train, "
                         "prefill, decode")
    rd = _rank_dims(params)
    slices = {s.name: _layer_slices(params[s.name], rd) for s in stacks(cfg)}
    mla = cfg.mla_kv_lora > 0

    def layer(x, stack, lp, c=None, po=None, kv=None):
        if stack.name == "cross_layers":
            cached = kv is not None
            kv = kv if cached else cross_kv(cfg, lp, vision_embeds)
            return _cross_layer(cfg, lp, x, kv, cached,
                                base.seq_split(stack.entry)), kv
        if mla:
            return _mla_layer(cfg, lp, x, cache=c, pos_offset=po,
                              moe=stack.moe)
        return _self_layer(cfg, lp, x, window=stack.window, cache=c,
                           pos_offset=po, moe=stack.moe)

    steps = _walk(cfg)
    if mode == "train":
        n = 2 if cfg.local_global else 1
        for u in range(0, len(steps), n):
            unit = steps[u:u + n]

            def run(x, *lps, unit=unit):
                for (stack, _), lp in zip(unit, lps):
                    x = layer(x, stack, _g(gather, lp))[0]
                return x
            if unit[0][0].name != "cross_layers":
                run = base.remat(cfg, run)
            x = run(x, *(slices[st.name][i] for st, i in unit))
        return x, None
    if mode == "decode":
        for stack, i in steps:
            lp = _g(gather, slices[stack.name][i])
            names = _kv_names(cfg, stack)
            entry = {k: cache[stack.entry][k].select(rd, i) for k in names}
            if stack.name == "cross_layers":
                x, _ = layer(x, stack, lp, kv=(entry["k"], entry["v"]))
            else:
                x, _ = layer(x, stack, lp, po=pos, c=dict(
                    entry, pos=pos, seq=base.seq_split(stack.entry)))
        return x, cache
    kvs: dict = {}
    for stack, i in steps:
        x, kv = layer(x, stack, _g(gather, slices[stack.name][i]))
        for name, t in zip(_kv_names(cfg, stack), kv):
            if base.seq_split(stack.entry):
                t = base.cache_rows(t, rd)
            kvs.setdefault(stack.entry, {}).setdefault(name, []).append(t)
    return x, {entry: {k: torch.stack(v, rd) for k, v in e.items()}
               for entry, e in kvs.items()}


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
    """The token rows of the (gathered) embedding; returns ``(x, emb)``.
    Where the vocabulary splits over ``model`` (vocab-parallel), each rank
    looks up the tokens of its rows, zero for the others, and the rows
    are summed over ``model``."""
    emb = params["embed"]
    if gather is not None:
        emb = gather({"embed": emb})["embed"]
    return lookup(cfg, emb, tokens, _rank_dims(params)), emb


def lookup(cfg: ModelConfig, emb: torch.Tensor, tokens: torch.Tensor,
           rank_dims: int) -> torch.Tensor:
    """``emb[tokens]`` in the compute dtype on every rank; vocab-parallel
    where the vocabulary splits over ``model``."""
    if not tp.splits(cfg.vocab):
        return _take_rows(emb.to(cfg.dtype), tokens, rank_dims)
    md = rank_dims - 1
    idx = tokens.long() - tp.rank_index(tokens, md) * emb.shape[-2]
    mine = (idx >= 0) & (idx < emb.shape[-2])
    rows = _take_rows(emb.to(cfg.dtype), torch.where(mine, idx, 0),
                      rank_dims)
    rows = torch.where(mine[..., None], rows, 0)
    return tp.reduce_from_model(rows, md)


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
    x, _ = run_stack(cfg, params, x, mode="train",
                     vision_embeds=batch.get("vision_embeds"), gather=gather)
    x = base.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    head = _head(cfg, params, emb, gather)
    return chunked_ce(cfg, x, head, labels, loss_chunk,
                      rank_dims=_rank_dims(params))


def _chunk_ce(cap: float, x: torch.Tensor, head: torch.Tensor,
              labels: torch.Tensor, rank_dims: int = 0,
              md: int | None = None) -> torch.Tensor:
    """One chunk's cross-entropy; vocab-parallel with a ``model`` axis
    ``md`` (the head holds the rank's vocabulary columns)."""
    if md is not None:
        x = tp.copy_to_model(x, md)
    return base.cross_entropy(base.mm(x, head), labels, cap, rank_dims, md)


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
    same values.

    Where the vocabulary splits over ``model`` (``head`` holds a rank's
    columns) the cross-entropy is vocab-parallel
    (``base.cross_entropy``), and the rank-at-a-time path takes the
    ``model`` ranks of one ``(pod, data)`` rank together."""
    md = rank_dims - 1 if tp.splits(cfg.vocab) else None
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
                                  labels[..., sl], rank_dims, md) * (1.0 / nc)
        return tot
    # one (pod, data) rank at a time, its model ranks (if any) together
    g = () if md is None else (x.shape[md],)
    xs = x.reshape(-1, *g, *x.shape[rank_dims:])
    hs = head.reshape(-1, *g, *head.shape[-2:])
    ls = labels.reshape(-1, *g, *labels.shape[rank_dims:])
    tot = []
    for r in range(xs.shape[0]):
        t = torch.zeros(g, device=x.device)
        for c in range(nc):
            sl = slice(c * chunk, (c + 1) * chunk)
            ce = checkpoint(_chunk_ce, cfg.logit_softcap, xs[r, ..., sl, :],
                            hs[r], ls[r, ..., sl], len(g), 0 if g else None,
                            use_reentrant=False)
            t = t + ce * (1.0 / nc)
        tot.append(t)
    return torch.stack(tot).reshape(x.shape[:rank_dims])


def prefill(cfg: ModelConfig, params: dict, batch: dict, *,
            gather: Gather = None):
    """Forward pass over a prompt; returns (last-token logits, cache)."""
    tokens = batch["tokens"]
    x, emb = _embed(cfg, params, tokens, gather)
    x, cache = run_stack(cfg, params, x, mode="prefill",
                         vision_embeds=batch.get("vision_embeds"),
                         gather=gather)
    x = base.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    head = _head(cfg, params, emb, gather)
    logits = base.softcap(base.mm(x[..., -1:, :].contiguous(), head),
                          cfg.logit_softcap)
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
    ``pos`` stands at ``max_seq - 1``), on ``device``, in ``dtype`` (the
    compute dtype by default): each stack's entry as :func:`run_stack`'s
    prefill makes it, ``{"k", "v"}`` of ``(L, B, max_seq, KV, hd)``
    (MLA's ``{"c_kv", "k_rope"}``), a cross stack's ``(L, B,
    vision_tokens, KV, hd)``.  Decoding against the zero cross K/V is what
    the slot server does, as the reference's does: it passes no vision
    embeddings."""
    dtype = dtype or cfg.dtype
    zeros = lambda *s: torch.zeros(s, dtype=dtype,            # noqa: E731
                                   device=device)
    kv, hd = cfg.n_kv_heads, cfg.hd
    cache: dict = {}
    for st in stacks(cfg):
        b, n = batch_size, st.n
        if st.name == "cross_layers":
            shapes = [(n, b, cfg.vision_tokens, kv, hd)] * 2
        elif cfg.mla_kv_lora > 0:
            shapes = [(n, b, max_seq, cfg.mla_kv_lora),
                      (n, b, max_seq, 1, cfg.mla_qk_rope)]
        else:
            shapes = [(n, b, max_seq, kv, hd)] * 2
        cache[st.entry] = {name: zeros(*shape) for name, shape in
                           zip(_kv_names(cfg, st), shapes)}
    cache["pos"] = max_seq - 1
    return cache
