"""Mamba-2 (SSD, arXiv:2405.21060): the attention-free LM.

The port of ``repro/models/mamba2.py``.  The SSD layer is the chunked
state-space-duality algorithm: within a chunk the interactions are
batched products (``einsum`` in fp32, as the reference casts them),
across chunks a short loop carries the ``(H, P, N)`` state over the
chunk boundaries.  A sequence whose length is not a multiple of
``ssm_chunk``, or of length 1 (a decode step), takes the recurrent path,
an S-step loop over the state.  Decode keeps O(1) state a layer: the
conv windows and the fp32 SSM state.

Projections are per component (``wz``, ``wx``, ``wb``, ``wc``,
``wdt``), as the reference stores them.  Parameters may carry the mesh's
rank axes in front (``(*R, ...)``, the stacked ``L`` axis after them)
with activations ``(*R, B, S, D)``; every weight product runs once per
rank (``base.mm``), the conv taps, ``A_log``, ``D`` and ``dt_bias`` are
lifted onto each rank's rows, and only the SSD scan, which holds no
weight, folds the rank axes into its batch.  ``A_log``, ``D`` and
``dt_bias`` stay fp32 (``rules.KEEP_F32``).

Serving (on the rank axes too, ``serve.engine.make_serve_fns``):
``prefill`` runs from a zero state and returns the last logits and the
cache ``{"layers": {"conv_x", "conv_b", "conv_c",
"ssm"}, "pos"}`` (the conv windows in the compute dtype, ``ssm`` fp32,
each stacked ``(L, B, ...)``); ``decode_step`` steps it, writing the new
state into the cache in place.
"""
from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.core import tp
from repro_torch.models import base
from repro_torch.models import transformer as tf
from repro_torch.models.base import ModelConfig
from repro_torch.models.transformer import dense_init

Gather = Callable | None


def segsum(x: torch.Tensor) -> torch.Tensor:
    """(..., Q) → (..., Q, Q): out[i, j] = Σ_{k=j+1..i} x[k] (−inf above the
    diagonal)."""
    q = x.shape[-1]
    cs = torch.cumsum(x, -1)
    d = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    return torch.where(mask, d, -torch.inf)


def ssd_chunked(xdt: torch.Tensor, a_bar: torch.Tensor, bb: torch.Tensor,
                cc: torch.Tensor, chunk: int, h0: torch.Tensor) -> tuple:
    """The chunked SSD scan.

    xdt: (B, S, H, P) inputs pre-multiplied by dt; a_bar: (B, S, H) log
    decay; bb/cc: (B, S, N); h0: (B, H, P, N) initial state.  Returns
    (y (B, S, H, P), h_final).
    """
    b, s, h, p = xdt.shape
    n = bb.shape[-1]
    if s % chunk:
        raise ValueError(f"seq {s} % chunk {chunk} != 0")
    c = s // chunk
    x = xdt.reshape(b, c, chunk, h, p)
    ab = a_bar.reshape(b, c, chunk, h).permute(0, 3, 1, 2)    # (B,H,C,Q)
    bbc = bb.reshape(b, c, chunk, n)
    ccc = cc.reshape(b, c, chunk, n)

    acum = torch.cumsum(ab, -1)                               # (B,H,C,Q)
    # 1) intra-chunk: the quadratic-in-chunk, attention-like term
    ll = torch.exp(segsum(ab))                                # (B,H,C,Q,Q)
    scores = torch.einsum("bcqn,bckn->bcqk", ccc, bbc)
    w = scores[:, None] * ll                                  # (B,H,C,Q,Q)
    y_diag = torch.einsum("bhcqk,bckhp->bcqhp", w, x)

    # 2) each chunk's end state
    decay_to_end = torch.exp(acum[..., -1:] - acum)           # (B,H,C,Q)
    states = torch.einsum("bckn,bhck,bckhp->bchpn", bbc, decay_to_end, x)

    # 3) the recurrence over the chunk boundaries
    chunk_decay = torch.exp(acum[..., -1])                    # (B,H,C)
    hprev, prev = h0, []
    for i in range(c):
        prev.append(hprev)
        hprev = hprev * chunk_decay[..., i, None, None] + states[:, i]
    prev_states = torch.stack(prev, 1)                        # (B,C,H,P,N)

    # 4) the state carried into each chunk's outputs
    state_decay = torch.exp(acum)                             # (B,H,C,Q)
    y_off = torch.einsum("bcqn,bchpn,bhcq->bcqhp", ccc, prev_states,
                         state_decay)
    return (y_diag + y_off).reshape(b, s, h, p), hprev


def _ssd_recurrent(xdt: torch.Tensor, a_bar: torch.Tensor, bb: torch.Tensor,
                   cc: torch.Tensor, h0: torch.Tensor) -> tuple:
    """The same scan one step at a time (decode, odd lengths): the shapes
    of :func:`ssd_chunked`."""
    hcur, ys = h0, []
    for t in range(xdt.shape[1]):
        hcur = hcur * torch.exp(a_bar[:, t])[..., None, None] \
            + xdt[:, t, ..., None] * bb[:, t, None, None, :]
        ys.append(torch.einsum("bhpn,bn->bhp", hcur, cc[:, t]))
    return torch.stack(ys, 1), hcur


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor | None) -> tuple:
    """Depthwise causal conv of width ``w.shape[-2]`` over ``x`` ``(*R, B,
    S, C)`` with taps ``(*R, W, C)``; ``state`` holds the last W − 1
    inputs (zeros when ``None``).  Returns (silu(conv + b), the new
    state)."""
    s, width = x.shape[-2], w.shape[-2]
    if state is None:
        state = x.new_zeros((*x.shape[:-2], width - 1, x.shape[-1]))
    xp = torch.cat([state, x], -2)
    out = 0
    for i in range(width):
        out = out + xp[..., i:i + s, :] * base._lift(w[..., i, :], x)
    return F.silu(out + base._lift(b, x)), xp[..., -(width - 1):, :]


def mamba_block(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
                cache: dict | None = None) -> tuple:
    """One Mamba-2 mixer over ``x`` ``(*R, B, S, D)``; ``cache`` is
    ``{"conv_x", "conv_b", "conv_c", "ssm"}`` (the state to start from; a
    missing entry is zero, ``{}`` the zero state), and the new state is
    returned beside the output when it is given.  On the rank axes a
    serving cache lies as ``rules.cache_specs`` says: ``ssm`` over the
    rank's heads, ``conv_x`` its ``d_inner`` block, ``conv_b`` /
    ``conv_c`` its block of the state's features, gathered over
    ``model`` for the (replicated) convolution and cut again after it.

    Where ``d_inner`` splits over ``model`` the SSD heads do: a rank holds
    its ``d_inner / tp`` columns of ``wz``, ``wx`` and ``conv_xw`` and
    rows of ``out_proj`` (row-parallel, summed over ``model``).  ``wb``,
    ``wc``, ``wdt``, the B/C convs, ``dt``'s softplus and the decay run
    replicated; each rank takes its heads of ``dt`` and of the decay, and
    its block of ``conv_xb``, ``D`` and ``gate_norm``, whose norm sums
    its squares over ``model``."""
    *lead, s, _ = x.shape
    di, n, h, pd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    nb = math.prod(lead)
    md = tp.model_dim(p["wz"], 2) if tp.splits(di) else None
    xl, conv_xb, d_skip, gate_norm = x, p["conv_xb"], p["D"], p["gate_norm"]
    if md is not None:
        if h % tp.size():
            raise NotImplementedError(
                f"tensor parallelism of {tp.size()} splits {h} SSD heads "
                "inside a head")
        h //= tp.size()
        xl = tp.copy_to_model(x, md)
        conv_xb, d_skip, gate_norm = (tp.local_slice(t, md) for t in (
            conv_xb, d_skip, gate_norm))

    z = base.mm(xl, p["wz"])                                  # (...,S,di)
    xin = base.mm(xl, p["wx"])
    bb = base.mm(x, p["wb"])                                  # (...,S,N)
    cc = base.mm(x, p["wc"])
    dt = base.mm(x, p["wdt"])                                 # (...,S,H)

    state = cache or {}
    # a serving cache on the rank axes holds a rank's block of the B/C
    # conv windows (rules.cache_specs splits their features over model);
    # the convolution runs on them whole
    bc_split = cache is not None and tp.splits(n)
    mdx = len(lead) - 2
    cb, c_c = state.get("conv_b"), state.get("conv_c")
    if bc_split and cb is not None:
        cb, c_c = (tp.gather_from_model(t, mdx) for t in (cb, c_c))
    xin, ncx = _causal_conv(xin, p["conv_xw"], conv_xb, state.get("conv_x"))
    bb, ncb = _causal_conv(bb, p["conv_bw"], p["conv_bb"], cb)
    cc, ncc = _causal_conv(cc, p["conv_cw"], p["conv_cb"], c_c)
    if bc_split:
        ncb, ncc = (tp.own_slice(t, mdx, t.dim() - 1, n // tp.size())
                    for t in (ncb, ncc))

    dt = dt.float() + base._lift(p["dt_bias"], dt).float()
    dt = torch.logaddexp(dt, torch.zeros_like(dt))            # softplus
    a = -torch.exp(p["A_log"].float())                        # (*R, H)
    a_bar = dt * base._lift(a, dt)                            # log decay
    if md is not None:
        bb, cc = tp.copy_to_model(bb, md), tp.copy_to_model(cc, md)
        dt, a_bar = tp.local_slice(dt, md), tp.local_slice(a_bar, md)
    xh = xin.reshape(*lead, s, h, pd)
    xdt = xh.float() * dt[..., None]

    h0 = state.get("ssm")
    h0 = (h0.reshape(nb, h, pd, n) if h0 is not None else
          torch.zeros((nb, h, pd, n), device=x.device))
    args = (xdt.reshape(nb, s, h, pd), a_bar.reshape(nb, s, h),
            bb.float().reshape(nb, s, n), cc.float().reshape(nb, s, n))
    if s % cfg.ssm_chunk == 0 and s > 1:
        y, h_final = ssd_chunked(*args, cfg.ssm_chunk, h0)
    else:
        y, h_final = _ssd_recurrent(*args, h0)
    y = y.reshape(*lead, s, h, pd)

    y = y + xh.float() * base._lift(d_skip, xh[..., 0]).float()[..., None]
    y = y.reshape(*lead, s, h * pd).to(
        cfg.dtype if x.dtype != torch.float32 else torch.float32)
    y = base.rmsnorm(y * F.silu(z), gate_norm, cfg.norm_eps, split_dim=md)
    out = base.mm(y, p["out_proj"])
    if md is not None:
        out = tp.reduce_from_model(out, md)
    new_cache = None
    if cache is not None:
        new_cache = {"conv_x": ncx, "conv_b": ncb, "conv_c": ncc,
                     "ssm": h_final.reshape(*lead, h, pd, n)}
    return out, new_cache


def init_layer(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """One layer's parameters, on a leading axis of 1."""
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    w = cfg.ssm_conv
    zeros = lambda *s: torch.zeros(s, device=gen.device)      # noqa: E731
    return {
        "ln": zeros(1, d),
        "wz": dense_init(gen, (1, d, di)),
        "wx": dense_init(gen, (1, d, di)),
        "wb": dense_init(gen, (1, d, n)),
        "wc": dense_init(gen, (1, d, n)),
        "wdt": dense_init(gen, (1, d, h)),
        "conv_xw": dense_init(gen, (1, w, di), 0.2),
        "conv_xb": zeros(1, di),
        "conv_bw": dense_init(gen, (1, w, n), 0.2),
        "conv_bb": zeros(1, n),
        "conv_cw": dense_init(gen, (1, w, n), 0.2),
        "conv_cb": zeros(1, n),
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, device=gen.device)
                           )[None],
        "D": torch.ones((1, h), device=gen.device),
        "dt_bias": zeros(1, h),
        "gate_norm": zeros(1, di),
        "out_proj": dense_init(gen, (1, di, d)),
    }


def init_params(cfg: ModelConfig, gen: torch.Generator,
                cast: Callable = lambda t: t) -> dict:
    """fp32 parameters on ``gen``'s device, the reference's leaves
    (``embed``, ``layers``, ``final_norm``, the untied ``lm_head``), each
    layer drawn and ``cast`` one at a time (``transformer.draw_stack``)."""
    params = cast(tf.init_top(cfg, gen))
    params["layers"] = tf.draw_stack(cfg.n_layers,
                                     lambda: init_layer(cfg, gen), cast)
    return params


# ---------------------------------------------------------------------------
# The stack and the public entry points.
# ---------------------------------------------------------------------------

def _zero_layer_cache(cfg: ModelConfig, lead: tuple, device) -> dict:
    w = cfg.ssm_conv - 1
    zeros = lambda *s, dt=cfg.dtype: torch.zeros(             # noqa: E731
        (*lead, *s), dtype=dt, device=device)
    return {"conv_x": zeros(w, cfg.d_inner),
            "conv_b": zeros(w, cfg.ssm_state),
            "conv_c": zeros(w, cfg.ssm_state),
            "ssm": zeros(cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state,
                         dt=torch.float32)}


def _run(cfg: ModelConfig, params: dict, x: torch.Tensor, *, mode: str,
         cache: dict | None = None, gather: Gather = None):
    """The layers; ``mode`` is ``train`` (``(x, None)``, each layer under
    ``base.remat``), ``prefill`` (from a zero state: ``(x, {"layers":
    ...})``, every layer's new state stacked) or ``decode`` (``cache``
    that layout, stepped in place, and returned)."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"_run: mode {mode!r} is not one of train, "
                         "prefill, decode")
    slices = tf._layer_slices(params["layers"], tf._rank_dims(params))

    def layer(x, lp, c=None):
        lp = gather(lp) if gather is not None else lp
        h = base.rmsnorm(x, lp["ln"], cfg.norm_eps)
        out, nc = mamba_block(cfg, lp, h, cache=c)
        return x + base.tag_block_out(cfg, out), nc

    if mode == "train":
        run = base.remat(cfg, lambda x, lp: layer(x, lp)[0])
        for lp in slices:
            x = run(x, lp)
        return x, None
    rd = tf._rank_dims(params)
    if mode == "decode":
        states = cache["layers"]
        for i, lp in enumerate(slices):
            x, nc = layer(x, lp, {k: t.select(rd, i)
                                  for k, t in states.items()})
            for k, t in nc.items():
                states[k].select(rd, i).copy_(t)
        return x, cache
    new: dict = {}
    for lp in slices:
        x, nc = layer(x, lp, {})              # from a zero state
        for k, t in nc.items():
            new.setdefault(k, []).append(t)
    return x, {"layers": {k: torch.stack(v, rd) for k, v in new.items()}}


def _logits(cfg: ModelConfig, params: dict, x: torch.Tensor,
            emb: torch.Tensor, gather: Gather) -> torch.Tensor:
    x = base.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return base.mm(x, tf._head(cfg, params, emb, gather))


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
    return _logits(cfg, params, last, emb, gather), cache


def decode_step(cfg: ModelConfig, params: dict, token: torch.Tensor,
                cache: dict, *, gather: Gather = None):
    """One decode step: token (B, S) + cache → (logits (B, S, V), cache),
    the state stepped in place (the input cache is consumed)."""
    pos = tf._host_pos(cache["pos"])
    x, emb = tf._embed(cfg, params, token, gather)
    layer_caches = {k: v for k, v in cache.items() if k != "pos"}
    x, new_cache = _run(cfg, params, x, mode="decode", cache=layer_caches,
                        gather=gather)
    new_cache["pos"] = pos + token.shape[-1]
    return _logits(cfg, params, x, emb, gather), new_cache


def init_cache(cfg: ModelConfig, batch_size: int, max_seq: int,
               dtype: torch.dtype | None = None,
               device: str | torch.device | None = None) -> dict:
    """Zero decode state on ``device`` (``pos`` 0): O(1) in the sequence,
    so ``max_seq`` is unused, and so is ``dtype``, as in the reference
    (the conv windows are in the compute dtype, the SSM state fp32)."""
    del max_seq, dtype
    zl = _zero_layer_cache(cfg, (cfg.n_layers, batch_size), device)
    return {"layers": zl, "pos": 0}
