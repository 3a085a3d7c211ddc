"""The shared model configuration and the layer library.

The port of ``repro/models/base.py``: ``ModelConfig``, RMSNorm,
LayerNorm with a bias, RoPE, soft-capping, remat, attention (dense and
chunked online-softmax on the CPU, the flash kernel on the card, masked
decode over a KV cache on both; windows and tanh caps), the GQA block
with its q/k norms, cache write and precomputed cross-attention K/V
(``kv_override``), SwiGLU, the tanh-GELU MLP with biases, the MoE block
(``moe_block`` and its dispatch) and cross-entropy.

Rank axes.  The port runs every emulated rank in one process, so a
weight may carry the mesh's rank axes in front, ``(*R, *shape)``, with
activations ``(*R, B, S, D)`` beside it.  The functions here take the
number of rank axes from the weight (``w.dim()`` less its own rank) and
run one product per rank (``mm``): a weight is never broadcast across
another rank's rows, so autograd hands each rank its own gradient.  With
no rank axes they are the reference's functions on one rank.

Tensor parallelism.  Under ``core.tp.parallel(tp)`` with ``tp`` > 1 the
last rank axis is ``model``, and a leaf that the sharding rules split
holds its rank's block: the attention blocks run on the rank's heads
(the count read from the leaves' shapes), ``swiglu`` and ``gelu_mlp``
column- then row-parallel, ``moe_block`` on the rank's ``E / tp``
experts, and ``rmsnorm(split_dim=)`` normalizes a dim split over
``model``; ``core.tp``'s operators join the regions.  Whether a dim is
split follows the rules' divisibility (``tp.splits`` of its full size).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Any, Callable

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.core import tp
from repro_torch.kernels import ops
from repro_torch.launch import step_analysis


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


# ---------------------------------------------------------------------------
# Products and normalization over rank axes.
# ---------------------------------------------------------------------------

def mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` on every rank: ``w`` ``(*R, K, N)``, ``x`` ``(*R, ..., K)``
    → ``(*R, ..., N)``, one batched product over ``R`` (never a broadcast
    that lines ``R`` up with a batch dim)."""
    r = w.dim() - 2
    if r == 0:
        return x @ w
    lead = x.shape[:-1]
    y = torch.matmul(x.reshape(*x.shape[:r], -1, x.shape[-1]), w)
    return y.reshape(*lead, w.shape[-1])


def _lift(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A ``(*R, D)`` weight shaped to broadcast against ``(*R, ..., D)``."""
    return w.reshape(*w.shape[:-1], *([1] * (x.dim() - w.dim())),
                     w.shape[-1])


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6,
            split_dim: int | None = None) -> torch.Tensor:
    """RMSNorm over the last dim in fp32, back in ``x``'s dtype.  With
    ``split_dim`` (the ``model`` axis) the last dim is split over
    ``model``: its sum of squares is summed over the ranks first."""
    dt = x.dtype
    x = x.float()
    if split_dim is None:
        ms = (x * x).mean(-1, keepdim=True)
    else:
        n = x.shape[-1] * x.shape[split_dim]
        ms = tp.allreduce_model((x * x).sum(-1, keepdim=True), split_dim) / n
    x = x * torch.rsqrt(ms + eps)
    return (x * (1.0 + _lift(w, x).float())).to(dt)


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm in fp32 with weight and bias, back in ``x``'s dtype."""
    dt = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * _lift(w, x).float() + _lift(b, x).float()).to(dt)


def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x: torch.Tensor, pos: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., S, H, hd); pos: (..., S) absolute positions."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)              # (hd/2,)
    ang = pos[..., None].float() * freqs                 # (..., S, hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return torch.tanh(x / cap) * cap if cap > 0 else x


@torch.library.custom_op("repro_torch::block_out", mutates_args=())
def _block_out(x: torch.Tensor) -> torch.Tensor:
    """A copy of ``x`` under an operator of its own, which the ``names``
    policy saves by name (a custom op's output may not alias its
    input)."""
    return x.clone()


@_block_out.register_fake
def _(x):
    return torch.empty_like(x)


_block_out.register_autograd(lambda ctx, grad: grad)

#: the matrix products that ``dots`` saves (``einsum`` and ``@`` reach
#: them), as ``jax.checkpoint_policies.checkpoint_dots`` saves dots
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                   torch.ops.aten.addmm.default,
                   torch.ops.aten.baddbmm.default})


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _save_block_out(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return (CheckpointPolicy.MUST_SAVE
            if op is torch.ops.repro_torch.block_out.default
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat(cfg: ModelConfig, fn: Callable) -> Callable:
    """Layer-boundary remat with the configured policy
    (``torch.utils.checkpoint``, non-reentrant).  ``full`` recomputes the
    layer in the backward, keeping only its input; ``dots`` also keeps
    every matrix product's output; ``names`` keeps the tensors
    :func:`tag_block_out` marks, the attention and FFN block outputs.
    The flash kernel launches outside PyTorch's dispatch, so no policy
    can keep its output: the backward recomputes it under every one."""
    policy = {"dots": _save_dots, "names": _save_block_out}.get(
        cfg.remat_policy)
    if policy is None:
        return lambda *args: checkpoint(fn, *args, use_reentrant=False)
    ctx = functools.partial(create_selective_checkpoint_contexts, policy)
    return lambda *args: checkpoint(fn, *args, use_reentrant=False,
                                    context_fn=ctx)


def tag_block_out(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Mark ``x`` as a named remat checkpoint (``remat_policy="names"``,
    at the cost of one copy of ``x``); the identity otherwise."""
    if cfg.remat_policy == "names":
        return torch.ops.repro_torch.block_out(x)
    return x


# ---------------------------------------------------------------------------
# Attention.
# ---------------------------------------------------------------------------

def _scale(q: torch.Tensor, scale: float | None) -> float:
    """The query scale as the reference's step applies it: rounded to
    ``q``'s dtype (the identity in fp32)."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    return torch.tensor(scale, dtype=q.dtype).item()


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool, q_pos: torch.Tensor | int | None = None,
           kv_len: torch.Tensor | int | None = None, window: int = 0,
           attn_cap: float = 0.0, scale: float | None = None,
           chunk: int = 0) -> torch.Tensor:
    """Scaled dot-product attention.

    q: (B, Sq, H, hd); k/v: (B, Sk, KV, vd) with H % KV == 0.  On the CPU
    it follows the reference's two branches: dense softmax, or with
    ``chunk > 0`` the online softmax over query and KV chunks.  On the
    card both are the flash kernel (``ops.attention``), which computes
    the same function.  Every branch scales queries as the reference's
    jitted step does: ``scale`` (given or ``hd ** -0.5``) is rounded to
    ``q``'s dtype, as a weakly typed constant is, and ``fl32(q)`` is
    multiplied by it in fp32, unrounded (XLA drops the round trip
    through ``q``'s dtype).

    Masked decode: ``q_pos`` gives the queries' absolute positions for the
    causal mask and ``kv_len`` the number of valid cache entries, as in
    the reference.  ``q_pos`` may also be a host int, the first query's
    position (the queries then sit at ``q_pos + arange(Sq)``, the only
    form a decode step makes); on the card it must be, and ``kv_len`` a
    host int too: they are the flash kernel's launch arguments, so that
    no layer syncs the card to read a position.

    The tensors may also be ``(N, B, …)`` (a cache on the rank axes,
    :func:`attend_ranks`): on the card one launch reads them where they
    lie, on the CPU the batch dims are folded.
    """
    if q.dim() == 5 and q.device.type == "cpu":
        n, b = q.shape[:2]
        out = attend(q.reshape(n * b, *q.shape[2:]),
                     k.reshape(n * b, *k.shape[2:]),
                     v.reshape(n * b, *v.shape[2:]), causal=causal,
                     q_pos=q_pos, kv_len=kv_len, window=window,
                     attn_cap=attn_cap, scale=scale, chunk=chunk)
        return out.reshape(n, b, *out.shape[1:])
    if q.device.type != "cpu":
        if not (q_pos is None or isinstance(q_pos, int)) or not (
                kv_len is None or isinstance(kv_len, int)):
            raise TypeError("attend on the card takes q_pos (the first "
                            "query's position) and kv_len as host ints")
        return ops.attention(q, k, v, causal=causal,
                             scale=_scale(q, scale), attn_cap=attn_cap,
                             window=window, q_offset=q_pos or 0,
                             kv_len=kv_len)
    if isinstance(q_pos, int):
        q_pos = q_pos + torch.arange(q.shape[1], device=q.device)
    if chunk > 0 and q.shape[1] > 1 and k.shape[1] % chunk == 0 \
            and kv_len is None:
        return _attend_chunked(q, k, v, causal=causal, window=window,
                               attn_cap=attn_cap, scale=scale, chunk=chunk)
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    qf = (q.float() * _scale(q, scale)).reshape(b, sq, kv, g, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float())
    scores = softcap(scores, attn_cap)
    kpos = torch.arange(sk, device=q.device)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        qp = q_pos if q_pos is not None else torch.arange(sq, device=q.device)
        mask &= kpos[None, :] <= qp[:, None]
        if window > 0:
            mask &= kpos[None, :] > qp[:, None] - window
    if kv_len is not None:
        mask &= kpos[None, :] < kv_len
    scores = torch.where(mask, scores, -1e30)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(b, sq, h, v.shape[-1]).to(q.dtype)


def _attend_chunked(q, k, v, *, causal, window, attn_cap, scale, chunk):
    """Online-softmax attention tiled over both queries and keys (the
    flash-attention schedule), carrying a query-chunk-sized (m, l, o)."""
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    vd = v.shape[-1]
    nq = max(1, sq // chunk)
    qc_len = sq // nq
    nk = sk // chunk
    qf = (q.float() * _scale(q, scale)).reshape(b, nq, qc_len, kv, g, hd)
    outs = []
    for qi in range(nq):
        qb = qf[:, qi]                                    # (B,qc,KV,G,hd)
        qpos = qi * qc_len + torch.arange(qc_len, device=q.device)
        m = torch.full((b, kv, g, qc_len), -torch.inf, device=q.device)
        l = torch.zeros((b, kv, g, qc_len), device=q.device)
        o = torch.zeros((b, kv, g, qc_len, vd), device=q.device)
        for ki in range(nk):
            kb = k[:, ki * chunk:(ki + 1) * chunk].float()
            vb = v[:, ki * chunk:(ki + 1) * chunk].float()
            s = torch.einsum("bqkgd,bckd->bkgqc", qb, kb)
            s = softcap(s, attn_cap)
            kpos = ki * chunk + torch.arange(chunk, device=q.device)
            mask = torch.ones((qc_len, chunk), dtype=torch.bool,
                              device=q.device)
            if causal:
                mask &= kpos[None, :] <= qpos[:, None]
                if window > 0:
                    mask &= kpos[None, :] > qpos[:, None] - window
            s = torch.where(mask, s, -1e30)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(-1)
            o = o * alpha[..., None] + torch.einsum("bkgqc,bckd->bkgqd",
                                                    p, vb)
            m = m_new
        out = o / torch.clamp(l[..., None], min=1e-30)   # (B,KV,G,qc,vd)
        outs.append(out.permute(0, 3, 1, 2, 4))           # (B,qc,KV,G,vd)
    out = torch.stack(outs, 1).reshape(b, sq, h, vd)
    return out.to(q.dtype)


def write_cache(cache: torch.Tensor, new: torch.Tensor, pos: int, *,
                dim: int = 1, md: int | None = None) -> None:
    """``new``'s ``S`` rows into ``cache`` in place at ``pos`` along
    ``dim``, the start clamped to ``[0, Smax − S]`` as
    ``dynamic_update_slice`` clamps it.  With ``md`` (the ``model`` axis)
    the cache is split over its sequence: ``model`` rank ``m`` holds rows
    ``m·S_l … (m+1)·S_l`` of the whole (``Smax = tp·S_l``) and takes the
    new rows that fall there (``new`` whole on every rank)."""
    s = new.shape[dim]
    if md is None:
        start = min(max(pos, 0), cache.shape[dim] - s)
        if dim == 1:
            cache[:, start:start + s] = new
        else:
            cache.narrow(dim, start, s).copy_(new)
        return
    sl, shards = cache.shape[dim], cache.shape[md]
    start = min(max(pos, 0), sl * shards - s)
    for m in range(shards):
        lo, hi = max(start, m * sl), min(start + s, (m + 1) * sl)
        if lo < hi:
            cache.select(md, m).narrow(dim - 1, lo - m * sl, hi - lo).copy_(
                new.select(md, m).narrow(dim - 1, lo - start, hi - lo))


@dataclasses.dataclass(frozen=True)
class Serving:
    """What a sharded serving step takes from its layout beyond
    ``tp.parallel``'s size; ``serve.engine.make_serve_fns`` sets it
    (:func:`serving`) from ``rules.cache_specs`` and ``batch_spec``, the
    one place that decides them.  ``route``: the leading rank dims whose
    rows form one global batch (the ``(pod, data)`` axes the tokens are
    split over, ``()`` where every rank holds them whole; ``None``: each
    rank routes its own rows, as a train step does).  ``seq``: the cache
    entries (a cache's top-level keys) that lie split over their
    sequence on ``model``."""

    route: tuple[int, ...] | None = None
    seq: frozenset = frozenset()


_SERVING: list = [Serving()]


@contextlib.contextmanager
def serving(route: tuple[int, ...], seq: frozenset):
    """Run the layers as one sharded serving step (:class:`Serving`)."""
    before = _SERVING[0]
    _SERVING[0] = Serving(tuple(route), frozenset(seq))
    try:
        yield
    finally:
        _SERVING[0] = before


def seq_split(entry: str) -> bool:
    """Whether the serving step's cache ``entry`` lies split over its
    sequence on ``model`` (:func:`serving`; False outside one)."""
    return entry in _SERVING[0].seq


def cache_rows(t: torch.Tensor, rank_dims: int) -> torch.Tensor:
    """Each ``model`` rank's block of rows of K/V ``(*R, B, S, …)`` that
    every rank holds whole: what a sequence-split cache keeps of a
    prefill (``model`` the last of the ``rank_dims`` rank axes)."""
    s, n = t.shape[rank_dims + 1], tp.size()
    if s % n:
        raise NotImplementedError(
            f"a cache split over its sequence on {n} model ranks needs a "
            f"length that divides by {n}, got {s}")
    return tp.own_slice(t, rank_dims - 1, rank_dims + 1, s // n)


def attend_ranks(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 **kw) -> torch.Tensor:
    """:func:`attend` of ``(*R, B, S, heads, d)`` tensors with rank axes
    ``R`` (a cache's layer slice among them): the rank axes fold into one
    outer batch dim, a view even of a slice of a ``(*R, L, B, …)`` cache,
    so that the card reads the cache where it lies."""
    r = q.dim() - 4
    if r == 0:
        return attend(q, k, v, **kw)
    out = attend(*(t.flatten(0, r - 1) for t in (q, k, v)), **kw)
    return out.reshape(*q.shape[:-1], out.shape[-1])


def attend_shards(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, q_pos: int = 0,
                  kv_len: int | None = None, window: int = 0,
                  attn_cap: float = 0.0, scale: float | None = None
                  ) -> torch.Tensor:
    """Attention over a cache split over its sequence on ``model``: ``q``
    ``(*R, B, Sq, H, hd)`` every query head on every rank, ``k``/``v``
    ``(*R, B, S_l, KV, d)`` each ``model`` rank's block of keys (``model``
    the last rank axis; ``kv_len`` and the positions count in the whole
    sequence).  One partial launch over every rank's rows
    (``ops.attention_partial``), then ``core.tp.lse_combine`` over
    ``model``: the whole attention, on every rank.  The query scale is
    :func:`attend`'s."""
    r = q.dim() - 4
    o, lse = ops.attention_partial(
        *(t.flatten(0, r - 1) for t in (q, k, v)), shards=q.shape[r - 1],
        causal=causal, scale=_scale(q, scale), attn_cap=attn_cap,
        window=window, q_offset=q_pos, kv_len=kv_len)
    o = o.reshape(*q.shape[:-1], v.shape[-1])
    lse = lse.reshape(*q.shape[:-3], q.shape[-2], q.shape[-3])
    return tp.lse_combine(o, lse.transpose(-1, -2), r - 1)


def _rank_kv(t: torch.Tensor, md: int, h: int, hl: int) -> torch.Tensor:
    """Replicated K or V ``(*R, B, S, KV, hd)`` → each ``model`` rank's
    KV heads for its ``hl`` query heads of ``h`` (heads ``m·hl …``):
    consecutive KV heads where the rank's query heads cover whole groups,
    the one KV head where a group spans ranks (MQA)."""
    kv = t.shape[-2]
    g = h // kv
    if hl % g == 0:
        n = hl // g
    elif g % hl == 0:
        n = 1
    else:
        raise NotImplementedError(
            f"{hl} query heads a rank of {h} do not align with the groups "
            f"of {kv} KV heads")
    t = tp.copy_to_model(t, md)
    return torch.stack([t.select(md, m).narrow(-2, m * hl // g, n)
                        for m in range(t.shape[md])], md)


def _heads(cfg: ModelConfig, wq: torch.Tensor, inside: bool = False
           ) -> tuple[int, int | None]:
    """(the query heads a rank attends over, the ``model`` axis or
    ``None``) from the query projection's width.  Where ``model`` splits
    the projection inside a head (``h·hd`` divides by it, ``h`` does
    not), a caller that takes ``inside`` gets every head: it attends over
    all of them on every rank (:func:`gqa_attention`); any other caller
    raises."""
    h, hd = cfg.n_heads, cfg.hd
    if not tp.splits(h * hd):
        return h, None
    if h % tp.size():
        if not inside:
            raise NotImplementedError(
                f"tensor parallelism of {tp.size()} splits {h} query heads "
                "inside a head")
        return h, tp.model_dim(wq, 2)
    return wq.shape[-1] // hd, tp.model_dim(wq, 2)


def kv_heads(cfg: ModelConfig, p: dict, x: torch.Tensor, md: int | None,
             xl: torch.Tensor | None = None, rope_pos=None) -> tuple:
    """K/V ``(*R, B, T, KV_r, hd)`` of ``x`` as a KV cache holds them: the
    rank's own KV heads where the heads split whole over ``model``;
    otherwise every KV head, the same on every rank (computed
    replicated, or gathered over ``model`` where the projection splits
    inside a head, granite's MQA).  ``k_norm`` (where ``p`` has it) and
    rope at ``rope_pos`` apply to K.  ``xl`` is ``x`` entered into the
    rank-local region (``x`` itself without one)."""
    kv, hd = cfg.n_kv_heads, cfg.hd
    *lead, t, _ = x.shape
    xl = x if xl is None else xl
    local = md is not None and kv % tp.size() == 0
    if md is None or local:
        kk, vv = mm(xl, p["wk"]), mm(xl, p["wv"])
    elif tp.splits(kv * hd):
        kk = tp.gather_from_model(mm(xl, p["wk"]), md)
        vv = tp.gather_from_model(mm(xl, p["wv"]), md)
    else:
        kk, vv = mm(x, p["wk"]), mm(x, p["wv"])
    kk = kk.reshape(*lead, t, -1, hd)
    vv = vv.reshape(*lead, t, -1, hd)
    if "k_norm" in p:
        w = tp.copy_to_model(p["k_norm"], md) if local else p["k_norm"]
        kk = rmsnorm(kk, w, cfg.norm_eps)
    if rope_pos is not None:
        kk = apply_rope(kk, rope_pos, cfg.rope_theta)
    return kk, vv


def heads_of(cfg: ModelConfig, kvs: tuple, md: int | None) -> tuple:
    """The K/V of :func:`kv_heads` for the rank's query heads: as they
    are, or, where every rank holds them whole, each rank's
    (:func:`_rank_kv`; with a query head split over ``model``, all of
    them, a copy a rank)."""
    if md is None or cfg.n_kv_heads % tp.size() == 0:
        return kvs
    # a query head split over model: every rank holds all the K/V
    return tuple(_rank_kv(a, md, cfg.n_heads, cfg.n_heads // tp.size())
                 if cfg.n_heads % tp.size() == 0
                 else tp.copy_to_model(a, md).contiguous() for a in kvs)


def gqa_attention(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  pos_offset: int | torch.Tensor | None = None,
                  cache: dict | None = None,
                  kv_override: tuple | None = None) -> tuple:
    """Full attention block: qkv proj + rope + attend + out proj.

    ``x`` is ``(*R, B, S, D)`` with weights ``(*R, ...)``; returns
    ``(out, (k, v))``.  The rank axes fold into attention's batch dim.
    Under tensor parallelism a rank runs its query heads (``wq``'s width
    over ``hd``), the K/V of :func:`heads_of`, and ``wo`` row-parallel,
    its partial output summed over ``model``.  Where ``model`` splits a
    query head (gemma2-2b's 8 heads over 16 ranks), it partitions as XLA
    does: a rank's query columns are gathered over ``model``, every rank
    attends over all the heads and all the K/V, and keeps its own
    columns of the output for ``wo``; the gather's backward is a sum over
    ``model`` of the ranks' partial gradients, then each rank's block.

    ``cache`` is ``{"k": (B, Smax, KV, hd), "v": ..., "pos": int}`` for a
    decode step: the new K/V are written into it **in place** at ``pos``,
    the start clamped to ``[0, Smax - S]`` as ``dynamic_update_slice``
    clamps it, and the queries attend at positions ``pos + arange(S)``
    over the first ``pos + S`` entries.  The returned ``(k, v)`` are the
    cache's own tensors: the caller's cache is consumed, as the
    reference's is under donation.  ``pos_offset`` is the rotary position
    of the first token (``pos`` when decoding).  ``kv_override`` supplies
    precomputed ``(k, v)`` ``(*R, B, T, KV, hd)`` for cross-attention:
    neither the queries nor those keys get rope, only the queries the q/k
    norm, and (without a cache) the queries attend over them
    non-causally.  The reference's models call it with no override
    (whisper and the VLM have their own cross blocks).  Without a cache
    the returned ``(k, v)`` are the step's K/V as a cache holds them
    (:func:`kv_heads`).

    Sharded serving: the cache may carry the rank axes, ``(*R, B, Smax_r,
    KV_r, hd)``, laid out as ``rules.cache_specs`` says.  Its KV heads
    split over ``model`` (or no ``model`` axis): each rank writes and
    attends over its own heads.  Its sequence split over ``model``
    (``cache["seq"]`` true: the caller's :func:`seq_split` of the cache's
    entry): the new K/V, whole on every rank, are written on
    the rank that holds position ``pos``; the queries are gathered over
    ``model`` (every head on every rank); one partial launch attends over
    every rank's block of keys and ``lse_combine`` joins them
    (:func:`attend_shards`); each rank keeps its own heads for ``wo``.
    """
    *lead, s, _ = x.shape
    hd = cfg.hd
    h, md = _heads(cfg, p["wq"], inside=True)
    cols = p["wq"].shape[-1]
    split = md is not None and cols != h * hd       # a head split over model
    xl = tp.copy_to_model(x, md) if md is not None else x
    q = mm(xl, p["wq"])
    if split:       # the whole query, replicated, and back in below
        q = tp.gather_from_model(q, md)
    q = q.reshape(*lead, s, h, hd)
    pos = None
    if kv_override is None:
        pos0 = pos_offset if pos_offset is not None else 0
        pos = pos0 + torch.arange(s, device=x.device)
    if cfg.qk_norm:
        qn = (p["q_norm"] if md is None or split
              else tp.copy_to_model(p["q_norm"], md))
        q = rmsnorm(q, qn, cfg.norm_eps)
    if kv_override is None:
        kvs = kv_heads(cfg, p, x, md, xl, rope_pos=pos)
        kk, vv = heads_of(cfg, kvs, md)
        q = apply_rope(q, pos, cfg.rope_theta)
    else:
        kk, vv = kvs = kv_override
        if split:
            kk, vv = (tp.copy_to_model(a, md).contiguous() for a in (kk, vv))
        elif md is not None:
            kk, vv = (_rank_kv(a, md, cfg.n_heads, h) for a in (kk, vv))
    if split:       # each rank's own copy (the kernel reads no stride 0)
        q = tp.copy_to_model(q, md).contiguous()
    if cache is not None:
        out = _attend_cache(cfg, q, kvs if cache.get("seq") else (kk, vv),
                            cache, window=window, md=md, whole=split)
        newkv = (cache["k"], cache["v"])
    else:
        out = attend(q.reshape(-1, s, h, hd),
                     kk.reshape(-1, *kk.shape[-3:]),
                     vv.reshape(-1, *vv.shape[-3:]),
                     causal=causal and kv_override is None, window=window,
                     attn_cap=cfg.attn_softcap, chunk=cfg.attn_chunk)
        newkv = kvs
    out = out.reshape(*lead, s, h * hd)
    if split:                           # the rank's own columns for wo
        out = tp.own_slice(out, md, out.dim() - 1, cols)
    out = mm(out, p["wo"])
    return (out if md is None else tp.reduce_from_model(out, md)), newkv


def _attend_cache(cfg: ModelConfig, q: torch.Tensor, kv: tuple,
                  cache: dict, *, window: int, md: int | None,
                  whole: bool) -> torch.Tensor:
    """The decode attention of :func:`gqa_attention`: ``kv`` (the step's
    K/V, every KV head where the cache splits its sequence) written into
    ``cache`` at its ``pos``, then ``q`` ``(*R, B, S, H_r, hd)`` over it;
    returns ``q``'s shape.  ``whole``: ``q`` holds every head already (a
    head split over ``model``)."""
    pos = cache["pos"]
    s = q.shape[-3]
    dim = q.dim() - 3                               # the cache's sequence
    kw = dict(q_pos=pos, kv_len=pos + s, window=window,
              attn_cap=cfg.attn_softcap)
    if not cache.get("seq"):
        write_cache(cache["k"], kv[0], pos, dim=dim)
        write_cache(cache["v"], kv[1], pos, dim=dim)
        return attend_ranks(q, cache["k"], cache["v"], causal=True, **kw)
    mdx = dim - 2                                   # model: the last rank axis
    write_cache(cache["k"], kv[0], pos, dim=dim, md=mdx)
    write_cache(cache["v"], kv[1], pos, dim=dim, md=mdx)
    hl = q.shape[-2]
    if md is not None and not whole:                # every head on every rank
        q = tp.copy_to_model(tp.gather_from_model(q, md, -2), md).contiguous()
    out = attend_shards(q, cache["k"], cache["v"], **kw)
    if md is not None and not whole:                # the rank's own heads
        out = tp.own_slice(out, md, out.dim() - 2, hl)
    return out


# ---------------------------------------------------------------------------
# Feed-forward and loss.
# ---------------------------------------------------------------------------

def swiglu(p: dict, x: torch.Tensor, d_ff: int = 0) -> torch.Tensor:
    """``(silu(x·w_gate) · x·w_up)·w_down``; where the hidden width
    ``d_ff`` splits over ``model``, column- then row-parallel, the
    partial outputs summed over ``model``."""
    md = tp.model_dim(p["w_gate"], 2) if tp.splits(d_ff) else None
    if md is not None:
        x = tp.copy_to_model(x, md)
    out = mm(F.silu(mm(x, p["w_gate"])) * mm(x, p["w_up"]), p["w_down"])
    return out if md is None else tp.reduce_from_model(out, md)


def gelu_mlp(p: dict, x: torch.Tensor, d_ff: int = 0) -> torch.Tensor:
    """``gelu(x·w_up + b_up)·w_down + b_down`` with ``jax.nn.gelu``'s
    default, the tanh approximation.  Where ``d_ff`` splits over
    ``model``: column- then row-parallel, each rank its block of
    ``b_up``, and ``b_down`` added once, after the sum over ``model``."""
    md = tp.model_dim(p["w_up"], 2) if tp.splits(d_ff) else None
    b_up = p["b_up"]
    if md is not None:
        x = tp.copy_to_model(x, md)
        b_up = tp.local_slice(b_up, md)
    up = mm(x, p["w_up"])
    h = F.gelu(up + _lift(b_up, up), approximate="tanh")
    out = mm(h, p["w_down"])
    if md is not None:
        out = tp.reduce_from_model(out, md)
    return out + _lift(p["b_down"], out)


def _top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` along the last dim: the ``k`` largest, descending,
    equal values in index order (``torch.topk`` promises no order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _before(flat_e: torch.Tensor, e: int, lead: tuple,
            dims: tuple[int, ...]) -> torch.Tensor:
    """For each (token, choice) of ``flat_e`` ``(P, T·k)``, the choices of
    its expert on the ranks before its own along ``dims`` (in rank order,
    the other rank dims apart): an exclusive scan of the ranks' counts,
    which the ranks all-gather."""
    counts = F.one_hot(flat_e, e).sum(1).reshape(*lead, e)
    front = counts.movedim(dims, tuple(range(len(dims))))
    flat = front.flatten(0, len(dims) - 1)
    step_analysis.collective("all-gather", flat, flat.shape[0],
                             math.prod(lead))
    excl = flat.cumsum(0) - flat
    back = excl.reshape(front.shape).movedim(tuple(range(len(dims))), dims)
    return back.reshape(-1, e).gather(-1, flat_e)


def moe_block(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """Capacity-based top-k MoE with scatter dispatch, on every rank.

    ``x`` is ``(*R, B, S, D)`` with the router ``(*R, D, E)`` and the
    expert weights ``w_gate``/``w_up`` ``(*R, E, D, F)``, ``w_down``
    ``(*R, E, F, D)``.  Each rank routes its own ``T = B·S`` tokens: the
    router's fp32 softmax, its top-k (ties to the lower index)
    renormalized, each (token, choice) placed at its running count within
    its expert, choices past the capacity dropped.  The dispatch adds
    every choice's row into its expert slot, a dropped one as a zero row
    at its clipped slot (``flat_c`` is clipped, not dropped, in the
    reference's ``.at[].add``); the experts are batched products.
    ``moe_combine`` ``gather`` (the default) gathers each choice's slot
    weighted by its gate and sums the ``k``; ``scatter_ar`` scatters each
    kept slot's gated row into its token (``slot_to_row``), through
    :class:`_EPDispatch`, whose backward is the reference's f32 scatter.

    Serving (:func:`serving`'s ``route``) takes the capacity and the
    drops of the global batch, the ranks' rows in rank order; a rank's
    expert buffer holds its own choices only, ``min(cap, T·k)`` slots an
    expert (a kept choice has ``pos < cap`` and ``pos < T·k``).

    Expert parallelism: where ``E`` splits over ``model`` a rank holds
    ``E / tp`` experts (``w_*`` ``(*R, E/tp, ...)``).  The router, the
    capacity and the choices stay global (the replicated region); the
    dispatch keeps the rows of the rank's own experts only, the others
    become zero rows as a dropped choice does, and the combine's partial
    output is summed over ``model`` once.  The shared experts run
    column- then row-parallel (``swiglu``).
    """
    r = p["router"].dim() - 2
    lead = x.shape[:r]
    nr = math.prod(lead)
    b, s, d = x.shape[r:]
    t = b * s
    e, k = cfg.n_experts, cfg.experts_per_token
    dims = _SERVING[0].route if r else None
    tg = t * math.prod(lead[d] for d in dims or ())   # the global batch's
    cap = max(int(cfg.capacity_factor * tg * k / e), min(tg * k, 32))
    dev = x.device
    md = tp.model_dim(p["router"], 2) if tp.splits(e) else None
    el = p["w_gate"].shape[-3]                                    # own E

    xt = x.reshape(*lead, t, d)
    logits = mm(xt.to(p["router"].dtype), p["router"]).float()   # (*R,T,E)
    u = torch.exp(logits - logits.amax(-1, keepdim=True))
    probs = u / u.sum(-1, keepdim=True)
    gate_vals, gate_idx = _top_k(probs, k)                        # (*R,T,k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)

    flat_e = gate_idx.reshape(nr, t * k)
    pos, keep_f = _expert_slots(flat_e, e, cap)                   # (P,Tk)
    if tg > t:                                 # placed in the global batch
        keep_f = pos + _before(flat_e, e, lead, dims) < cap
    slots = min(cap, t * k)                 # a rank's own, an expert
    flat_c = torch.clamp(pos, 0, slots - 1)
    ranks = torch.arange(nr, device=dev)[:, None]
    xs, own_e = xt, flat_e
    if md is not None:
        # the rank's own experts: ids m·el … (m+1)·el - 1, made local
        # (``model`` is the last rank axis: flat rank r is model rank
        # r mod tp)
        xs = tp.copy_to_model(xt, md)
        gate_vals = tp.copy_to_model(gate_vals, md)
        own_e = flat_e - (ranks % x.shape[md]) * el
        mine = (own_e >= 0) & (own_e < el)
        keep_f = keep_f & mine
        own_e = torch.where(mine, own_e, 0)
    slot = (ranks * el + own_e) * slots + flat_c                  # (P,Tk)

    src = xs.reshape(nr, t, 1, d).expand(nr, t, k, d).reshape(nr, t * k, d)
    src = torch.where(keep_f[..., None], src, 0).to(cfg.dtype)
    w = torch.where(keep_f.reshape(gate_vals.shape), gate_vals,
                    0.0).to(cfg.dtype)                            # (*R,T,k)

    if cfg.moe_combine == "scatter_ar":
        # slot → flat row (unique by construction); a dropped choice's
        # slot is out of range and never written
        rows = torch.arange(t * k, device=dev).expand(nr, t * k)
        slot_to_row = torch.full((nr * el * slots,), t * k,
                                 dtype=torch.int64, device=dev)
        slot_to_row.scatter_reduce_(0, slot[keep_f], rows[keep_f],
                                    reduce="amin")
        slot_to_row = slot_to_row.reshape(nr, el * slots)
        xin = _EPDispatch.apply(src, slot, slot_to_row, el * slots)
    else:
        xin = _dispatch(src, slot, el * slots)
    xin = xin.reshape(*lead, el, slots, d)

    h = F.silu(torch.matmul(xin, p["w_gate"]))
    h = h * torch.matmul(xin, p["w_up"])
    out_e = torch.matmul(h, p["w_down"]).reshape(nr, el * slots, d)

    if cfg.moe_combine == "scatter_ar":
        kept = slot[keep_f]
        slot_gate = torch.zeros(nr * el * slots, dtype=cfg.dtype,
                                device=dev).index_put(
            (kept,), w.reshape(nr, t * k)[keep_f], accumulate=True)
        tok = slot_to_row // k + ranks * (t + 1)                  # (P,E·C)
        out = torch.zeros(nr * (t + 1), d, dtype=cfg.dtype,
                          device=dev).index_put(
            (tok.reshape(-1),),
            (out_e * slot_gate.reshape(nr, el * slots, 1)).reshape(-1, d),
            accumulate=True)
        out = out.reshape(nr, t + 1, d)[:, :t]
    else:
        gath = out_e.reshape(nr * el * slots, d)[slot.reshape(-1)]
        out = (gath.reshape(nr, t, k, d)
               * w.reshape(nr, t, k, 1)).sum(2)
    out = out.reshape(*lead, t, d)
    if md is not None:
        out = tp.reduce_from_model(out, md)
    if cfg.n_shared_experts > 0:
        out = out + swiglu(p["shared"], xt,
                           cfg.moe_d_ff * cfg.n_shared_experts)
    return out.reshape(x.shape)


def _expert_slots(flat_e: torch.Tensor, e: int, cap: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Each (token, choice)'s running count within its expert, in flat
    order, and whether it is under the capacity ``cap`` (else dropped),
    for ``flat_e`` ``(P, T·k)`` expert ids of ``e``."""
    pos = (F.one_hot(flat_e, e).cumsum(1) - 1).gather(
        -1, flat_e[..., None])[..., 0]
    return pos, pos < cap


def _dispatch(src: torch.Tensor, slot: torch.Tensor, n: int
              ) -> torch.Tensor:
    """Every rank's ``(T·k, D)`` rows added into its ``(n, D)`` slots."""
    nr, _, d = src.shape
    return torch.zeros(nr * n, d, dtype=src.dtype, device=src.device
                       ).index_put((slot.reshape(-1),), src.reshape(-1, d),
                                   accumulate=True).reshape(nr, n, d)


class _EPDispatch(torch.autograd.Function):
    """The token → expert-slot scatter whose backward is also a scatter
    (the reference's ``_ep_dispatch`` custom VJP): the slots' gradient
    rows are added, in fp32, into a ``(T·k + 1, D)`` buffer through
    ``slot_to_row`` (an empty slot names row ``T·k``, dropped), instead
    of autograd's gather from the slots."""

    @staticmethod
    def forward(ctx, src, slot, slot_to_row, n):
        ctx.save_for_backward(slot_to_row)
        ctx.t_k = src.shape[1]
        return _dispatch(src, slot, n)

    @staticmethod
    def backward(ctx, g):
        (slot_to_row,) = ctx.saved_tensors
        nr, _, d = g.shape
        t_k = ctx.t_k
        rows = slot_to_row + torch.arange(nr, device=g.device)[:, None] \
            * (t_k + 1)
        gsrc = torch.zeros(nr * (t_k + 1), d, device=g.device).index_put(
            (rows.reshape(-1),), g.reshape(-1, d).float(), accumulate=True)
        gsrc = gsrc.reshape(nr, t_k + 1, d)[:, :t_k].to(g.dtype)
        return gsrc, None, None, None


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  logit_cap: float = 0.0, rank_dims: int = 0,
                  md: int | None = None) -> torch.Tensor:
    """Mean token cross-entropy, one value per rank (the leading
    ``rank_dims`` axes are kept).

    Vocab-parallel with a ``model`` axis ``md``: ``logits`` are the
    rank's block of the vocabulary.  The maximum and the sum of the
    exponentials are taken over ``model`` too, and the label's logit
    comes from the rank that holds it."""
    logits = softcap(logits.float(), logit_cap)
    labels = labels.long()[..., None]
    if md is None:
        lp = torch.log_softmax(logits, dim=-1)
        ll = torch.take_along_dim(lp, labels, dim=-1)[..., 0]
    else:
        vl = logits.shape[-1]
        mx = tp.pmax(logits.amax(-1, keepdim=True), md)
        se = tp.reduce_from_model(
            torch.exp(logits - mx).sum(-1, keepdim=True), md)
        idx = labels - tp.rank_index(labels, md) * vl
        mine = (idx >= 0) & (idx < vl)
        own = torch.take_along_dim(logits, torch.where(mine, idx, 0), dim=-1)
        pick = tp.reduce_from_model(torch.where(mine, own, 0.0), md)
        ll = (pick - mx - torch.log(se))[..., 0]
    return -ll.mean(dim=tuple(range(rank_dims, ll.dim())))
