"""Plain PyTorch versions of the kernels (the correctness contract).

The port of ``repro/kernels/ref.py``.  On a CPU tensor the ``ops``
wrappers run these; on the card they are what each CUDA kernel is held
against, bit for bit.
"""
from __future__ import annotations

import torch


def tree_reduce(x: torch.Tensor, accum_dtype: torch.dtype = torch.float32,
                dim: int = 0) -> torch.Tensor:
    """Fixed aligned-binary-tree reduction over axis ``dim``.

    Pairs ``(2i, 2i+1)`` combine first, then pairs of pairs, over
    ``log2 P`` levels, in ``accum_dtype``; the result is cast back to
    ``x.dtype`` (round to nearest even for floats).  ``P`` must be a
    power of two.  Splitting ``dim`` is always a view, so a strided
    stack is folded without a copy.
    """
    p = x.shape[dim]
    if p & (p - 1) or p == 0:
        raise ValueError(f"tree_reduce: P={p} must be a power of two")
    y = x.to(accum_dtype)
    while p > 1:
        y = y.unflatten(dim, (p // 2, 2))
        y = y.select(dim + 1, 0) + y.select(dim + 1, 1)
        p //= 2
    return y.select(dim, 0).to(x.dtype)


# ---------------------------------------------------------------------------
# Blockwise int8 quantization (F1).
#
# These reproduce the bits XLA computes for the JAX package's jitted
# quantization code, which is not what its source says literally:
#   * ``max|x| / 127`` is compiled as ``max|x| * fl32(1/127)``;
#   * the dequant-accumulate fold ``acc = q0·s0; acc = acc + qi·si`` is
#     contracted to ``acc = fma(q0, s0, q1·s1)``, then ``fma(qi, si, acc)``;
#     the wire protocol's ``jnp.sum`` of the dequantized stack to
#     ``acc = q0·s0``, then ``fma(qi, si, acc)``;
#   * the error-feedback residual ``v - q·s`` is ``fma(-q, s, v)``.
# A fused multiply-add is computed here in fp64 (see ``fma_f32``).
# ---------------------------------------------------------------------------

INT8_MAX = 127.0
#: fl32(1/127): the reciprocal XLA multiplies by in place of ``/ 127``
INV_INT8_MAX = 1.0 / 127.0
#: the scale floor of an all-zero block, 1e-30 as fp32
SCALE_FLOOR = 1e-30


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``fl32(a·b + c)`` with one rounding, as a fused multiply-add.

    ``a`` holds int8 values and ``b`` fp32, so ``a·b`` is exact in fp64;
    the fp64 sum with ``c`` is rounded to odd (its error is found by
    TwoSum, and an inexact sum with an even last bit moves one ulp
    toward the exact value), which makes the final rounding to fp32 the
    single rounding of the exact value.
    """
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def quantize(x: torch.Tensor, qblock: int = 256
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Blockwise symmetric int8 along the last axis: ``(..., n)`` →
    int8 ``(..., n)`` and fp32 scales ``(..., n / qblock)``.

    ``scale = max(max|x| · fl32(1/127), 1e-30)`` (NaN kept), then
    ``q = clamp(round_half_even(x / scale), ±127)`` with a true division.
    """
    *lead, n = x.shape
    xb = x.float().reshape(*lead, n // qblock, qblock)
    scale = xb.abs().amax(dim=-1, keepdim=True) * xb.new_tensor(INV_INT8_MAX)
    scale = torch.maximum(scale, scale.new_tensor(SCALE_FLOOR))
    q = torch.clamp(torch.round(xb / scale), -INT8_MAX, INT8_MAX)
    return q.to(torch.int8).reshape(x.shape), scale[..., 0]


def dequantize(q: torch.Tensor, scales: torch.Tensor, qblock: int = 256,
               out_dtype: torch.dtype = torch.float32,
               minuend: torch.Tensor | None = None) -> torch.Tensor:
    """``q · s`` blockwise along the last axis, cast to ``out_dtype``.

    With ``minuend`` ``v``, returns the error-feedback residual
    ``v - q·s`` in ``v``'s dtype, as XLA computes it: ``fma(-q, s, v)``
    for fp32; for bf16 and f16, ``v - cast(q·s)`` in fp32 rounded once
    (the cast between product and difference stops the contraction).
    """
    *lead, n = q.shape
    qb = q.reshape(*lead, n // qblock, qblock)
    s = scales.unsqueeze(-1)
    if minuend is None:
        return (qb.float() * s).reshape(q.shape).to(out_dtype)
    v = minuend.reshape(qb.shape)
    if v.dtype == torch.float32:
        return fma_f32(-qb, s, v).reshape(q.shape)
    dec = (qb.float() * s).to(v.dtype)
    return (v.float() - dec.float()).to(v.dtype).reshape(q.shape)


def dequant_accum_slots(q: torch.Tensor, scales: torch.Tensor,
                        qblock: int = 256, wire_order: bool = False
                        ) -> torch.Tensor:
    """Dequantize and fold a ``(..., P, S, E)`` int8 stack over its child
    axis in stack order → ``(..., S, E)`` fp32, contracted as XLA does:
    for the switch's fold ``q0·s0`` for one child, else ``fma(q0, s0,
    q1·s1)`` and then ``fma(qi, si, acc)``; with ``wire_order`` (the wire
    protocol's ``jnp.sum``) ``q0·s0`` and then ``fma(qi, si, acc)``.
    Scales are ``(..., P, S, E / qblock)``."""
    *lead, p, s, e = q.shape
    qb = q.reshape(*lead, p, s, e // qblock, qblock)
    sc = scales.unsqueeze(-1)
    if p == 1 or wire_order:
        acc = qb[..., 0, :, :, :].float() * sc[..., 0, :, :, :]
        for i in range(1, p):
            acc = fma_f32(qb[..., i, :, :, :], sc[..., i, :, :, :], acc)
    else:
        acc = fma_f32(qb[..., 0, :, :, :], sc[..., 0, :, :, :],
                      qb[..., 1, :, :, :].float() * sc[..., 1, :, :, :])
        for i in range(2, p):
            acc = fma_f32(qb[..., i, :, :, :], sc[..., i, :, :, :], acc)
    return acc.reshape(*lead, s, e)


def dequant_accum(q: torch.Tensor, scales: torch.Tensor,
                  qblock: int = 256, wire_order: bool = False
                  ) -> torch.Tensor:
    """The flat form: a ``(..., P, n)`` stack with ``(..., P, n / qblock)``
    scales → ``(..., n)`` fp32, the slot fold with one block a slot."""
    *lead, p, n = q.shape
    out = dequant_accum_slots(q.reshape(*lead, p, n // qblock, qblock),
                              scales.unsqueeze(-1), qblock, wire_order)
    return out.reshape(*lead, n)


# ---------------------------------------------------------------------------
# Sparse accumulate (§7 array storage).
# ---------------------------------------------------------------------------

def scatter_add_rows(out: torch.Tensor, idx: torch.Tensor,
                     val: torch.Tensor) -> torch.Tensor:
    """``out[r, idx[r, j]] += val[r, j]`` on ``(R, size)`` rows, in list
    order, in ``out``'s dtype; indices outside ``[0, size)`` drop.

    Entries that share an index add one after another in list order,
    the order XLA's CPU scatter adds them: the entries are taken in
    rounds, round ``r`` holding every entry that is the ``r``-th of its
    index, so no round adds twice to one element and the result does not
    depend on the device's scatter order.  Returns ``out``.
    """
    rows, size = out.shape
    keep = (idx >= 0) & (idx < size)
    key = torch.where(keep, idx.long() + torch.arange(
        rows, device=idx.device).unsqueeze(1) * size, -1).reshape(-1)
    val = val.reshape(-1).to(out.dtype)
    order = torch.argsort(key, stable=True)
    sk = key[order]
    head = torch.ones_like(sk, dtype=torch.bool)
    head[1:] = sk[1:] != sk[:-1]
    pos = torch.arange(sk.numel(), device=sk.device)
    start = torch.cummax(torch.where(head, pos, 0), 0).values
    nth = torch.empty_like(pos)
    nth[order] = pos - start
    flat = out.view(-1)
    kept = keep.reshape(-1)
    rounds = int(nth[kept].max()) + 1 if bool(kept.any()) else 0
    for r in range(rounds):
        m = kept & (nth == r)
        flat.index_add_(0, key[m], val[m])
    return out


def sparse_accum_slots(idx: torch.Tensor, val: torch.Tensor,
                       size: int) -> torch.Tensor:
    """``(R, E)`` int32 coordinate lists → ``(R, size)`` fp32 buffers:
    zeros plus each entry, in list order (``scatter_add_rows``)."""
    out = torch.zeros((idx.shape[0], size), dtype=torch.float32,
                      device=idx.device)
    return scatter_add_rows(out, idx, val)


# ---------------------------------------------------------------------------
# Per-block magnitude top-k (the SparCML sparsifier).
# ---------------------------------------------------------------------------

#: the bisection's headroom above the block maximum, 1e-30 as fp32
TOPK_HEADROOM = 1e-30


def topk_threshold(xb: torch.Tensor, k: int, n_iter: int = 24
                   ) -> torch.Tensor:
    """The reference's threshold ``lo`` of each ``(nb, block)`` row,
    ``(nb, 1)`` fp32: ``n_iter`` bisection steps from ``lo = 0``, ``hi =
    max|x| + 1e-30`` (NaN kept), each counting the row's ``|x| >= mid``
    against ``k``."""
    ax = xb.float().abs()
    lo = torch.zeros((ax.shape[0], 1), dtype=torch.float32, device=ax.device)
    hi = ax.amax(dim=1, keepdim=True) + TOPK_HEADROOM
    for _ in range(n_iter):
        mid = 0.5 * (lo + hi)
        ge = (ax >= mid).sum(dim=1, keepdim=True) >= k
        lo = torch.where(ge, mid, lo)
        hi = torch.where(ge, hi, mid)
    return lo


def topk_compact(xb: torch.Tensor, k: int, n_iter: int = 24
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row top-k of ``(nb, block)`` rows → ``(values (nb, k)`` in
    ``xb``'s dtype, ``local indices (nb, k)`` int32).

    The reference's algorithm in its own arithmetic: ``n_iter`` fp32
    bisection steps for a threshold that admits at least ``k`` magnitudes
    (``hi = max|x| + 1e-30`` with NaN kept, ``mid = 0.5·(lo + hi)``),
    then the elements strictly above it in index order, then the ties
    at it in index order, ``k`` in all; ``-1`` and ``0`` fill the slots
    of a row that admits fewer (only NaN does).  The output is not
    index-sorted: a tie can follow larger indices.

    Each value is what the reference's one-hot product gives: ``0 +``
    the sum over the row of ``x[j]·(j == sel)``.  So a NaN or an inf
    anywhere else in the row makes it NaN (``inf·0``), and a selected
    ``-0.0`` comes out ``+0.0``.
    """
    x = xb.float()
    ax = x.abs()
    lo = topk_threshold(xb, k, n_iter)
    gt = ax > lo
    n1 = gt.cumsum(dim=1, dtype=torch.int32)
    total1 = torch.clamp(n1[:, -1:], max=k)
    sel1 = gt & (n1 <= k)
    eq = (ax >= lo) & ~gt
    n2 = eq.cumsum(dim=1, dtype=torch.int32)
    sel2 = eq & (n2 <= k - total1)
    pos = torch.where(sel1, n1 - 1, total1 + n2 - 1)
    sel = sel1 | sel2

    bad = ~torch.isfinite(x)
    others_bad = bad.sum(dim=1, keepdim=True) - bad.int() > 0
    value = torch.where(others_bad, torch.nan, x + 0.0)

    nb, block = x.shape
    row = torch.arange(nb, device=x.device).unsqueeze(1).expand(nb, block)
    col = torch.arange(block, dtype=torch.int32,
                       device=x.device).expand(nb, block)
    vals = torch.zeros((nb, k), dtype=torch.float32, device=x.device)
    idxs = torch.full((nb, k), -1, dtype=torch.int32, device=x.device)
    vals[row[sel], pos[sel].long()] = value[sel]
    idxs[row[sel], pos[sel].long()] = col[sel]
    return vals.to(xb.dtype), idxs


# ---------------------------------------------------------------------------
# Flash attention (online softmax over KV tiles, fp32 state).
# ---------------------------------------------------------------------------

#: the score of a masked (query, key) pair, as the TPU kernel writes it
MASKED = -1e30


def _mask(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
          window: int, kv_len: int | None = None) -> torch.Tensor | None:
    """Visible (query, key) pairs, ``(Sq, Sk)`` bool (``(1, Sk)`` when
    only ``kv_len`` masks); None = all."""
    mask = None
    if causal:
        mask = k_pos[None, :] <= q_pos[:, None]
        if window > 0:
            mask &= k_pos[None, :] > q_pos[:, None] - window
    if kv_len is not None:
        live = k_pos[None, :] < kv_len
        mask = live if mask is None else mask & live
    return mask


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, scale: float | None = None,
                         attn_cap: float = 0.0, window: int = 0,
                         kv_tile: int = 512, q_offset: int = 0,
                         kv_len: int | None = None,
                         k_base: torch.Tensor | None = None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the flash kernel: ``(o, lse)``.

    ``q`` ``(B, Sq, H, hd)``, ``k``/``v`` ``(B, Sk, KV, vd)``, head ``h``
    reading KV head ``h // (H / KV)``.  Like the TPU kernel it walks the
    keys in tiles of ``kv_tile`` carrying fp32 ``(m, l, o)``: the scores
    are ``fl32(q)·scale · k``, tanh-capped when ``attn_cap > 0``,
    ``-1e30`` where masked; ``o / max(l, 1e-30)`` in ``q``'s dtype, and
    ``lse = m + log(l)`` ``(B, H, Sq)`` fp32.  Memory is O(Sq · kv_tile)
    a head, never O(Sq · Sk).  A ragged last tile is just shorter.
    Masked decode, as the reference's ``attend``: query row ``i`` sits at
    position ``q_offset + i`` for the causal mask and the window, and
    keys at or past ``kv_len`` are masked too (every key is walked).

    ``k_base`` ``(B,)`` (with ``kv_len``; a shard of a sequence,
    :func:`flash_attention_partial`): batch row ``b``'s key ``j`` sits at
    the position ``k_base[b] + j`` for those masks, and a query row that
    sees none of its keys gets ``o = 0`` and ``lse = -inf``.
    """
    b, sq, h, hd = q.shape
    sk, kv, vd = k.shape[1], k.shape[2], v.shape[-1]
    g = h // kv
    scale = scale if scale is not None else hd ** -0.5
    qf = (q.float() * scale).reshape(b, sq, kv, g, hd).permute(0, 2, 3, 1, 4)
    m = torch.full((b, kv, g, sq), -torch.inf, device=q.device)
    l = torch.zeros((b, kv, g, sq), device=q.device)
    o = torch.zeros((b, kv, g, sq, vd), device=q.device)
    q_pos = q_offset + torch.arange(sq, device=q.device)
    seen = torch.zeros((b, 1, 1, sq), dtype=torch.bool, device=q.device)
    for t0 in range(0, sk, kv_tile):
        kb = k[:, t0:t0 + kv_tile].float().permute(0, 2, 1, 3).unsqueeze(2)
        vb = v[:, t0:t0 + kv_tile].float().permute(0, 2, 1, 3).unsqueeze(2)
        s = qf @ kb.transpose(-1, -2)                        # (B,KV,G,Sq,T)
        if attn_cap > 0:
            s = torch.tanh(s / attn_cap) * attn_cap
        k_pos = torch.arange(t0, t0 + kb.shape[-2], device=q.device)
        if k_base is None:
            mask = _mask(q_pos, k_pos, causal, window, kv_len)
        else:                   # each row's keys at positions of its own
            kp = (k_base[:, None] + k_pos)[:, None, :]          # (B, 1, T)
            qp = q_pos[:, None]
            mask = (kp < kv_len).expand(b, sq, kp.shape[-1])
            if causal:
                mask = mask & (kp <= qp)
                if window > 0:
                    mask = mask & (kp > qp - window)
            mask = mask[:, None, None]                          # (B,1,1,Sq,T)
            seen = seen | mask.any(-1)
        if mask is not None:
            s = torch.where(mask, s, MASKED)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + p @ vb
        m = m_new
    out = o / torch.clamp(l[..., None], min=1e-30)
    lse = m + torch.log(l)
    if k_base is not None:
        out = torch.where(seen[..., None], out, 0.0)
        lse = torch.where(seen, lse, -torch.inf)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, vd).to(q.dtype)
    return out, lse.reshape(b, h, sq)


def flash_attention_partial(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, shards: int,
                            kv_len: int | None = None, **kw
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the flash kernel's partial launch over a
    sequence split across ``shards`` ranks: ``(o, lse)``.

    ``q`` ``(N, B, Sq, H, hd)``, ``k``/``v`` ``(N, B, Sk, KV, vd)``: outer
    row ``n`` holds the ``(n mod shards)``-th block of ``Sk`` keys, key
    ``j`` at the absolute position ``(n mod shards)·Sk + j``, where the
    causal mask, the window and ``kv_len`` (the whole sequence's valid
    keys, all of them by default) apply; a query row that sees none of
    its block's keys gets ``o = 0`` and ``lse = -inf``
    (:func:`flash_attention_bshd` with ``k_base``).  Returns ``o (N, B,
    Sq, H, vd)`` in ``q``'s dtype and ``lse (N, B, H, Sq)`` fp32."""
    n, b, sk = q.shape[0], q.shape[1], k.shape[2]
    base = ((torch.arange(n, device=q.device) % shards) * sk
            ).repeat_interleave(b)
    o, lse = flash_attention_bshd(
        *(t.reshape(n * b, *t.shape[2:]) for t in (q, k, v)),
        kv_len=sk * shards if kv_len is None else kv_len, k_base=base, **kw)
    return o.reshape(n, b, *o.shape[1:]), lse.reshape(n, b, *lse.shape[1:])


def visible_keys(sq: int, sk: int, *, causal: bool, window: int,
                 q_offset: int, kv_len: int, base: int = 0
                 ) -> tuple[int, int]:
    """``[lo, hi)``: the keys of a block of ``sk`` at the absolute
    positions ``base …`` that some of ``sq`` query rows from ``q_offset``
    on can see (the causal edge of the last row, the window of the first,
    ``kv_len``), counted from the block's first key; ``hi == lo`` where no
    row sees one."""
    qoff = q_offset - base
    hi = min(sk, kv_len - base)
    lo = 0
    if causal:
        hi = min(hi, qoff + sq)
        if window > 0:
            lo = max(0, qoff - window + 1)
    return lo, max(lo, hi)


def split_keys(lo: int, hi: int, s: int, *, tile: int, tiles: int,
               splits: int) -> tuple[int, int]:
    """Split ``s``'s keys ``[a, e)`` of the visible range ``[lo, hi)``:
    tiles ``s·tiles // splits`` up to ``(s + 1)·tiles // splits`` of
    ``tile`` keys from ``lo``, cut at ``hi`` (empty, at ``hi``, past
    it)."""
    a = min(hi, lo + s * tiles // splits * tile)
    return a, max(a, min(hi, lo + (s + 1) * tiles // splits * tile))


def flash_attention_split(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, tile: int, tiles: int, splits: int,
                          causal: bool = True, scale: float | None = None,
                          attn_cap: float = 0.0, window: int = 0,
                          q_offset: int = 0, kv_len: int | None = None,
                          shards: int | None = None, kv_tile: int = 512
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the decode kernel's launch: ``(o, lse)`` by
    its splits (``flash_attn.decode_plan``'s ``tile``, ``tiles`` and
    ``splits``).

    Shapes as :func:`flash_attention_bshd` (``(B, …)``) or, with an outer
    dim, :func:`flash_attention_partial` (``(N, B, …)``; with ``shards``
    outer row ``n``'s keys sit at ``(n mod shards)·Sk …``).  Each split
    ``s`` of each outer row's visible keys (:func:`visible_keys`,
    :func:`split_keys`) is :func:`flash_attention_bshd` over those keys
    alone (``k_base``: their positions; a row that sees none of them gets
    ``o = 0``, ``lse = -inf``), in fp32; the splits are joined in split
    order by their log-sum-exp, ``o = Σ w_s o_s / Σ w_s`` with ``w_s =
    exp(lse_s − max lse)`` (a keyless split weighs exactly 0), ``lse =
    max lse + log Σ w_s``.  A row that sees no key of the launch gets
    ``o = 0``, ``lse = -inf``.  ``o`` in ``q``'s dtype, ``lse`` fp32."""
    outer = q.dim() == 5
    if not outer:
        q, k, v = (t.unsqueeze(0) for t in (q, k, v))
    n, b, sq, h, _ = q.shape
    sk, vd = k.shape[2], v.shape[-1]
    kv_len = sk * (shards or 1) if kv_len is None else kv_len
    kw = dict(causal=causal, scale=scale, attn_cap=attn_cap, window=window,
              q_offset=q_offset, kv_len=kv_len, kv_tile=kv_tile)
    os_ = torch.zeros((splits, n, b, sq, h, vd), device=q.device)
    lses = torch.full((splits, n, b, h, sq), -torch.inf, device=q.device)
    for m in range(shards or 1):
        rows = torch.arange(m, n, shards or 1, device=q.device)
        base = m * sk
        lo, hi = visible_keys(sq, sk, causal=causal, window=window,
                              q_offset=q_offset, kv_len=kv_len, base=base)
        for s in range(splits):
            a, e = split_keys(lo, hi, s, tile=tile, tiles=tiles,
                              splits=splits)
            if e == a:
                continue
            qs, ks, vs = (t[rows].float().reshape(-1, *t.shape[2:])
                          for t in (q, k[:, :, a:e], v[:, :, a:e]))
            o, lse = flash_attention_bshd(
                qs, ks, vs, k_base=torch.full((qs.shape[0],), base + a,
                                              device=q.device), **kw)
            os_[s, rows] = o.reshape(len(rows), b, *o.shape[1:])
            lses[s, rows] = lse.reshape(len(rows), b, *lse.shape[1:])
    top = lses.amax(0)
    w = torch.where(torch.isneginf(lses), 0.0,
                    torch.exp(lses - torch.where(torch.isneginf(top), 0.0,
                                                 top)))
    num = torch.zeros_like(os_[0])
    den = torch.zeros_like(lses[0])
    for s in range(splits):                     # the kernel's fixed order
        num = num + w[s].transpose(-1, -2)[..., None] * os_[s]
        den = den + w[s]
    o = (num / torch.clamp(den.transpose(-1, -2)[..., None], min=1e-30)
         ).to(q.dtype)
    lse = torch.where(torch.isneginf(top), -torch.inf, top + torch.log(den))
    if not outer:
        return o[0], lse[0]
    return o, lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: float | None = None,
                    attn_cap: float = 0.0, window: int = 0,
                    kv_tile: int = 512) -> torch.Tensor:
    """The TPU kernel's signature: ``(BH, S, hd)`` q, k, v, heads folded
    into the leading dim, GQA broadcast by the caller."""
    o, _ = flash_attention_bshd(q.unsqueeze(2), k.unsqueeze(2),
                                v.unsqueeze(2), causal=causal, scale=scale,
                                attn_cap=attn_cap, window=window,
                                kv_tile=kv_tile)
    return o.squeeze(2)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        lse: torch.Tensor, do: torch.Tensor, *,
                        causal: bool, scale: float, attn_cap: float,
                        window: int, q_chunk: int = 512,
                        max_elems: int = 1 << 26
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients of :func:`flash_attention_bshd`'s output, in fp32.

    Query rows are independent, so the probabilities are recomputed from
    the forward's log-sum-exp for ``q_chunk`` rows (and as many batch
    rows as keep a chunk's scores under ``max_elems``) at a time, against
    the keys those rows can see; dK and dV accumulate in fp32.  The
    softmax's own backward, ``ds = p·(dp − Σ p·dp)``, is taken over the
    whole row, as the reference's autodiff of ``softmax`` does; masked
    scores get no gradient.  Each block is :func:`_bwd_block`.  The
    card's ``csrc/flash_bwd.cu`` computes the same function; this is its
    plain version, which the tests and ``chip_smoke.py`` hold it against.
    """
    b, sq, h, hd = q.shape
    sk, kv, vd = k.shape[1], k.shape[2], v.shape[-1]
    dq = torch.empty_like(q)
    dk = torch.zeros((b, sk, kv, hd), device=q.device)
    dv = torch.zeros((b, sk, kv, vd), device=q.device)
    nb = max(1, max_elems // (h * min(q_chunk, sq) * sk))
    opts = dict(causal=causal, scale=scale, attn_cap=attn_cap, window=window)
    for b0 in range(0, b, nb):
        b1 = min(b, b0 + nb)
        for i0 in range(0, sq, q_chunk):
            i1 = min(sq, i0 + q_chunk)
            lo, hi = 0, sk
            if causal and i1 - 1 < sk:     # every row sees its own key
                hi = i1
                if window > 0:
                    lo = max(0, i0 - window + 1)
            dq_c, dk_c, dv_c = _bwd_block(
                q[b0:b1, i0:i1], k[b0:b1, lo:hi], v[b0:b1, lo:hi],
                lse[b0:b1, :, i0:i1], do[b0:b1, i0:i1], i0=i0, lo=lo, **opts)
            dv[b0:b1, lo:hi] += dv_c
            dq[b0:b1, i0:i1] = dq_c
            dk[b0:b1, lo:hi] += dk_c
            del dq_c, dk_c, dv_c
    return dq, dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_dot(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``D = Σ_d dO·O`` of ``(B, Sq, H, vd)`` ``o`` and ``do`` in fp32,
    ``(B, H, Sq)``: the plain version of the backward's first kernel
    (``flash_attn.attention_dot``)."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def _bwd_block(q, k, v, lse, do, *, i0: int, lo: int, causal: bool,
               scale: float, attn_cap: float, window: int) -> tuple:
    """One block of :func:`flash_attention_bwd`: query rows ``i0 …`` of
    ``q`` (``(n, qn, H, hd)``) against keys ``lo …`` → the block's dQ in
    ``q``'s dtype and its fp32 dK and dV terms ``(n, kn, KV, ·)``."""
    n, qn, h, hd = q.shape
    kn, kv, vd = k.shape[1], k.shape[2], v.shape[-1]
    g = h // kv
    qc = (q.float() * scale).reshape(
        n, qn, kv, g, hd).permute(0, 2, 3, 1, 4)             # (n,KV,G,qn,hd)
    doc = do.float().reshape(n, qn, kv, g, vd).permute(0, 2, 3, 1, 4)
    kk = k.float().permute(0, 2, 1, 3).unsqueeze(2)
    vv = v.float().permute(0, 2, 1, 3).unsqueeze(2)
    s = qc @ kk.transpose(-1, -2)                            # (n,KV,G,qn,kn)
    t = None
    if attn_cap > 0:
        t = torch.tanh(s.div_(attn_cap))
        s = t * attn_cap
    mask = _mask(torch.arange(i0, i0 + qn, device=q.device),
                 torch.arange(lo, lo + kn, device=q.device), causal, window)
    if mask is not None:
        s.masked_fill_(~mask, MASKED)
    lse_c = lse.reshape(n, kv, g, qn, 1)
    p = s.sub_(lse_c).exp_()
    dv = (p.transpose(-1, -2) @ doc).sum(2).permute(0, 2, 1, 3)
    dp = doc @ vv.transpose(-1, -2)
    ds = dp.sub_((p * dp).sum(-1, keepdim=True)).mul_(p)
    del p, s
    if t is not None:
        ds.mul_(t.mul_(t).neg_().add_(1.0))
        del t
    if mask is not None:
        ds.masked_fill_(~mask, 0.0)
    dq = (ds @ kk).mul_(scale).permute(0, 3, 1, 2, 4).reshape(
        n, qn, h, hd).to(q.dtype)
    dk = (ds.transpose(-1, -2) @ qc).sum(2).permute(0, 2, 1, 3)
    return dq, dk, dv
