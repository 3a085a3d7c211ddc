"""Public wrappers over the kernels: padding, accumulation type, dispatch.

The port of ``repro/kernels/ops.py``: the fixed-tree fold, the int8
quantization kernels, the sparse accumulate, the per-block top-k and
flash attention.  A
tensor on the CPU takes the plain PyTorch version (``ref``); a tensor on
the card launches the CUDA kernel or raises — there is no fallback.

A ``meta`` tensor (the dry-run's shapes without storage,
``launch/dryrun.py``) takes an explicit branch of its own: it returns
outputs of the kernel's shapes and dtypes and adds the kernel's
operations and bytes to the step being counted
(``launch.step_analysis.kernel``).  Nothing on the card reaches it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attn as _fa
from repro_torch.kernels import quant as _quant
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import sparse_accum as _sa
from repro_torch.kernels import topk_compact as _tk
from repro_torch.kernels import tree_reduce as _tr
from repro_torch.launch import step_analysis as _sa_count


def _meta_launch(name: str, outs: tuple, moved: int, flops: int = 0):
    """The ``meta`` branch's launch: count the kernel's work, return its
    outputs (no storage).  The byte-bound kernels count no operations,
    as ``FlopCounterMode`` counts none for elementwise work."""
    _sa_count.kernel(name, flops, moved, outs)
    return outs


def accum_dtype_for(dtype: torch.dtype) -> torch.dtype:
    """fp32 for floating inputs (the F3 accumulator), the input dtype
    for integers — integer sums stay exact, never round through fp32."""
    return torch.float32 if dtype.is_floating_point else dtype


def _pad_pow2(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Pad ``dim`` to a power of two with real zero rows, which the tree
    then adds in their tree position (``-0.0 + 0.0`` is ``+0.0``)."""
    p = x.shape[dim]
    pp = 1 << max(0, (p - 1).bit_length())
    if pp == p:
        return x
    shape = list(x.shape)
    shape[dim] = pp - p
    return torch.cat([x, x.new_zeros(shape)], dim=dim)


def _grouped(x: torch.Tensor) -> tuple[torch.Tensor, bool]:
    if x.dim() == 3:
        return x.unsqueeze(0), True
    if x.dim() != 4:
        raise ValueError(f"tree_reduce_slots wants (P, S, E) or "
                         f"(G, P, S, E), got {tuple(x.shape)}")
    return x, False


def tree_reduce_slots_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of :func:`tree_reduce_slots`, on any
    device: the same padding and accumulation, folded by ``ref``."""
    g, squeeze = _grouped(x)
    out = _ref.tree_reduce(_pad_pow2(g, 1), accum_dtype_for(x.dtype), dim=1)
    return out[0] if squeeze else out


def tree_reduce_slots(x: torch.Tensor) -> torch.Tensor:
    """Fixed-tree reduce of a packed slot stack over its child axis.

    ``(P, S, E)`` → ``(S, E)``, or ``(G, P, S, E)`` → ``(G, S, E)`` for G
    switches at once.  ``P`` is padded to a power of two with zero rows;
    floats accumulate in fp32, integers natively.
    """
    if x.device.type == "cpu":
        return tree_reduce_slots_plain(x)
    g, squeeze = _grouped(x)
    if x.device.type == "meta":
        gp = _pad_pow2(g, 1)
        out, = _meta_launch("tree_reduce_slots", (gp.new_empty(
            (gp.shape[0], *gp.shape[2:])),), _tr.bytes_moved(gp))
        return out[0] if squeeze else out
    out = _tr.tree_reduce_slots(_pad_pow2(g, 1))
    return out[0] if squeeze else out


def tree_reduce(x: torch.Tensor) -> torch.Tensor:
    """Fixed-tree reduce of a ``(P, N)`` stack over axis 0 → ``(N,)``:
    the slot fold with one group and one slot."""
    if x.dim() != 2:
        raise ValueError(f"tree_reduce wants (P, N), got {tuple(x.shape)}")
    p, n = x.shape
    if x.device.type == "cpu":
        return tree_reduce_slots_plain(x.reshape(1, p, 1, n)).reshape(n)
    if x.device.type == "meta":
        xp = _pad_pow2(x, 0)
        return _meta_launch("tree_reduce", (x.new_empty(n),),
                            _tr.bytes_moved(xp.reshape(1, -1, 1, n)))[0]
    return _tr.tree_reduce(_pad_pow2(x, 0))


# ---------------------------------------------------------------------------
# Blockwise int8 quantization (F1): the port of ``repro/kernels/ops.py``'s
# ``quantize``, ``dequantize``, ``dequant_accum`` and
# ``dequant_accum_slots``.  The ``*_plain`` functions run the plain
# versions in pieces of about ``PLAIN_CHUNK`` elements (the pieces are
# independent, so the bits are the same), which keeps their fp64
# temporaries small on a full-width arena.
# ---------------------------------------------------------------------------

PLAIN_CHUNK = 1 << 24


def _row_chunks(rows: int, width: int):
    step = max(1, PLAIN_CHUNK // max(1, width))
    return [slice(i, min(i + step, rows)) for i in range(0, rows, step)]


def _rows(x: torch.Tensor) -> tuple[torch.Tensor, bool]:
    if x.dim() == 1:
        return x.unsqueeze(0), True
    if x.dim() != 2:
        raise ValueError(f"want (n,) or (R, n), got {tuple(x.shape)}")
    return x, False


def quantize_plain(x: torch.Tensor, qblock: int = 256
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of :func:`quantize` on ``(R, n)`` rows."""
    r, n = x.shape
    q = torch.empty((r, n), dtype=torch.int8, device=x.device)
    s = torch.empty((r, n // qblock), dtype=torch.float32, device=x.device)
    for c in _row_chunks(r, n):
        q[c], s[c] = _ref.quantize(x[c], qblock)
    return q, s


def quantize(x: torch.Tensor, qblock: int = 256
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Blockwise symmetric int8 of ``(n,)`` or ``(R, n)`` rows →
    ``(q, scales)`` of shape ``(..., n)`` and ``(..., n / qblock)``.  A
    ragged ``n`` is zero-padded to whole blocks, as the JAX wrapper
    does."""
    x2, squeeze = _rows(x)
    pad = (-x2.shape[-1]) % qblock
    if pad:
        x2 = torch.cat([x2, x2.new_zeros(x2.shape[0], pad)], dim=-1)
    if x2.device.type == "cpu":
        q, s = quantize_plain(x2, qblock)
    elif x2.device.type == "meta":
        r, n = x2.shape
        q, s = _meta_launch("quantize", (
            x2.new_empty((r, n), dtype=torch.int8),
            x2.new_empty((r, n // qblock), dtype=torch.float32)),
            _quant.quantize_bytes(x2, qblock))
    else:
        q, s = _quant.quantize(x2, qblock)
    return (q[0], s[0]) if squeeze else (q, s)


def dequantize_plain(q: torch.Tensor, scales: torch.Tensor,
                     qblock: int = 256,
                     out_dtype: torch.dtype = torch.float32,
                     minuend: torch.Tensor | None = None,
                     out: torch.Tensor | None = None) -> torch.Tensor:
    """The plain version of :func:`dequantize`."""
    if minuend is not None:
        out_dtype = minuend.dtype
    if out is None:
        out = torch.empty(q.shape, dtype=out_dtype, device=q.device)
    nb = q.numel() // qblock
    q2, s2, o2 = (q.reshape(nb, qblock), scales.reshape(nb, 1),
                  out.view(nb, qblock))
    v2 = None if minuend is None else minuend.reshape(nb, qblock)
    for c in _row_chunks(nb, qblock):
        o2[c] = _ref.dequantize(q2[c], s2[c], qblock, out_dtype,
                                minuend=None if v2 is None else v2[c])
    return out


def dequantize(q: torch.Tensor, scales: torch.Tensor, qblock: int = 256,
               out_dtype: torch.dtype = torch.float32,
               minuend: torch.Tensor | None = None,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """Inverse of :func:`quantize`: ``q·s`` blockwise in ``out_dtype``,
    ``q``'s shape.  With ``minuend`` ``v``, the error-feedback residual
    ``v − q·s`` in ``v``'s dtype; ``out`` may be ``v`` itself."""
    if q.numel() % qblock:
        raise ValueError(f"dequantize: n={q.numel()} % qblock={qblock} "
                         "!= 0")
    if q.device.type == "cpu":
        return dequantize_plain(q, scales, qblock, out_dtype, minuend, out)
    if q.device.type == "meta":
        if minuend is not None:
            out_dtype = minuend.dtype
        if out is None:
            out = q.new_empty(q.shape, dtype=out_dtype)
        return _meta_launch("dequantize", (out,), _quant.dequantize_bytes(
            q, qblock, out_dtype, minuend is not None))[0]
    return _quant.dequantize(q, scales, qblock, out_dtype, minuend, out)


def _stack_slots(q: torch.Tensor, scales: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, bool]:
    if q.dim() == 3:
        return q.unsqueeze(0), scales.unsqueeze(0), True
    if q.dim() != 4:
        raise ValueError(f"dequant_accum_slots wants (P, S, E) or "
                         f"(G, P, S, E), got {tuple(q.shape)}")
    return q, scales, False


def dequant_accum_slots_plain(q: torch.Tensor, scales: torch.Tensor,
                              qblock: int = 256, wire_order: bool = False
                              ) -> torch.Tensor:
    """The plain version of :func:`dequant_accum_slots`, on any device."""
    q4, s4, squeeze = _stack_slots(q, scales)
    g, p, s, e = q4.shape
    out = torch.empty((g, s, e), dtype=torch.float32, device=q.device)
    for c in _row_chunks(s, g * p * e):
        out[:, c] = _ref.dequant_accum_slots(q4[:, :, c], s4[:, :, c],
                                             qblock, wire_order)
    return out[0] if squeeze else out


def dequant_accum_slots(q: torch.Tensor, scales: torch.Tensor,
                        qblock: int = 256, wire_order: bool = False
                        ) -> torch.Tensor:
    """Fused dequantize and fold of a ``(P, S, E)`` int8 slot stack over
    its child axis, in stack order → ``(S, E)`` fp32; or ``(G, P, S, E)``
    → ``(G, S, E)`` for G switches at once.  Scales are ``(..., P, S,
    E / qblock)``.  The fold is contracted as the switch's, or with
    ``wire_order`` as the int8 wire protocol's reduce-scatter leg
    (``ref.dequant_accum_slots``).  Raises when ``E % qblock``: the
    caller owns the per-slot scales layout."""
    e = q.shape[-1]
    if e % qblock:
        raise ValueError(f"dequant_accum_slots: E={e} % qblock={qblock} "
                         "!= 0")
    if q.device.type == "cpu":
        return dequant_accum_slots_plain(q, scales, qblock, wire_order)
    q4, s4, squeeze = _stack_slots(q, scales)
    if q.device.type == "meta":
        g, _, s, e = q4.shape
        out, = _meta_launch("dequant_accum_slots", (q4.new_empty(
            (g, s, e), dtype=torch.float32),),
            _quant.dequant_accum_bytes(q4, qblock))
        return out[0] if squeeze else out
    out = _quant.dequant_accum_slots(q4, s4, qblock, wire_order)
    return out[0] if squeeze else out


def dequant_accum_plain(q: torch.Tensor, scales: torch.Tensor,
                        qblock: int = 256, wire_order: bool = False
                        ) -> torch.Tensor:
    """The plain version of :func:`dequant_accum`."""
    p, n = q.shape
    return dequant_accum_slots_plain(
        q.reshape(p, n // qblock, qblock), scales.reshape(p, -1, 1),
        qblock, wire_order).reshape(n)


def dequant_accum(q: torch.Tensor, scales: torch.Tensor,
                  qblock: int = 256, wire_order: bool = False
                  ) -> torch.Tensor:
    """Fused dequantize and fold of a ``(P, n)`` int8 child stack with
    ``(P, n / qblock)`` scales → ``(n,)`` fp32, in stack order.  Raises
    when ``n % qblock``."""
    if q.dim() != 2:
        raise ValueError(f"dequant_accum wants (P, n), got "
                         f"{tuple(q.shape)}")
    n = q.shape[1]
    if n % qblock:
        raise ValueError(f"dequant_accum: n={n} % qblock={qblock} != 0")
    if q.device.type == "cpu":
        return dequant_accum_plain(q, scales, qblock, wire_order)
    if q.device.type == "meta":
        return _meta_launch("dequant_accum", (q.new_empty(
            n, dtype=torch.float32),), _quant.dequant_accum_bytes(
            q.reshape(1, q.shape[0], n // qblock, qblock), qblock))[0]
    return _quant.dequant_accum(q, scales, qblock, wire_order)


# ---------------------------------------------------------------------------
# Sparse accumulate and per-block top-k (§7): the port of
# ``repro/kernels/ops.py``'s ``sparse_accum``, ``sparse_accum_slots``,
# ``topk_compact`` and ``blockwise_sparsify``.  Their plain versions run
# in pieces of about ``PLAIN_CHUNK`` entries or elements, as above.
# ---------------------------------------------------------------------------

def sparse_accum_slots_plain(idx: torch.Tensor, val: torch.Tensor,
                             size: int) -> torch.Tensor:
    """The plain version of :func:`sparse_accum_slots`, on any device."""
    *lead, e = idx.shape
    i2, v2 = idx.reshape(-1, e), val.reshape(-1, e)
    out = torch.empty((i2.shape[0], size), dtype=torch.float32,
                      device=idx.device)
    for c in _row_chunks(i2.shape[0], e):
        out[c] = _ref.sparse_accum_slots(i2[c], v2[c], size)
    return out.reshape(*lead, size)


def _meta_sparse_bytes(idx: torch.Tensor, val: torch.Tensor,
                       size: int) -> int:
    """``sparse_accum_bytes`` with every entry kept: a ``meta`` list has
    no values to tell a dropped entry by."""
    rows = idx.numel() // max(1, idx.shape[-1])
    return idx.numel() * (4 + val.element_size()) + 4 * rows * size


def _lists(t: torch.Tensor) -> torch.Tensor:
    """``(..., B, E)`` lists as ``(G, B, E)``: a view where the leading
    axes merge, else a copy."""
    if t.dim() == 2:
        return t.unsqueeze(0)
    return t if t.dim() == 3 else t.reshape(-1, *t.shape[-2:])


def sparse_accum_slots(idx: torch.Tensor, val: torch.Tensor, size: int,
                       indices_sorted: bool = False) -> torch.Tensor:
    """Scatter-add ``(..., B, E)`` bucket-local coordinate lists into
    ``(..., B, size)`` fp32 buffers: zeros plus every entry whose index
    lies in ``[0, size)``; duplicates add.  ``indices_sorted`` says every
    list is ascending as unsigned integers (a ``-1`` tail last), which
    lets the kernel write each output once; it is not checked."""
    if idx.dim() < 2 or idx.shape != val.shape:
        raise ValueError(f"sparse_accum_slots wants (..., B, E) indices and "
                         f"values, got {tuple(idx.shape)} and "
                         f"{tuple(val.shape)}")
    if idx.device.type == "cpu":
        return sparse_accum_slots_plain(idx, val, size)
    if idx.device.type == "meta":
        return _meta_launch("sparse_accum_slots", (val.new_empty(
            (*idx.shape[:-1], size), dtype=torch.float32),),
            _meta_sparse_bytes(idx, val, size))[0]
    out = _sa.sparse_accum_slots(_lists(idx), _lists(val), size,
                                 indices_sorted)
    return out.reshape(*idx.shape[:-1], size)


def sparse_accum(idx: torch.Tensor, val: torch.Tensor,
                 size: int) -> torch.Tensor:
    """Scatter-add one ``(E,)`` coordinate list, in any order, into
    ``(size,)`` fp32 (−1 entries dropped): one row of
    :func:`sparse_accum_slots`."""
    if idx.dim() != 1 or idx.shape != val.shape:
        raise ValueError(f"sparse_accum wants (E,) indices and values, got "
                         f"{tuple(idx.shape)} and {tuple(val.shape)}")
    if idx.device.type == "cpu":
        return sparse_accum_slots_plain(idx.unsqueeze(0), val.unsqueeze(0),
                                        size).reshape(size)
    if idx.device.type == "meta":
        return _meta_launch("sparse_accum", (val.new_empty(
            size, dtype=torch.float32),),
            _meta_sparse_bytes(idx, val, size))[0]
    return _sa.sparse_accum(idx, val, size)


def topk_compact_plain(x: torch.Tensor, k: int, block: int = 512
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of :func:`topk_compact` on a padded ``(n,)``."""
    nb = x.numel() // block
    xb = x.reshape(nb, block)
    vals = torch.empty((nb, k), dtype=x.dtype, device=x.device)
    idxs = torch.empty((nb, k), dtype=torch.int32, device=x.device)
    for c in _row_chunks(nb, block):
        vals[c], idxs[c] = _ref.topk_compact(xb[c], k)
    return vals, idxs


def topk_compact(x: torch.Tensor, k: int, block: int = 512
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-block magnitude top-k of a flat vector → ``(values, local
    indices)``, each ``(n / block, k)``, ``-1`` in empty slots; a ragged
    ``n`` is zero-padded to whole blocks, as the JAX wrapper does.  The
    strictly-above entries come first, the threshold ties after them:
    the output is not index-sorted."""
    if x.dim() != 1:
        raise ValueError(f"topk_compact wants (n,), got {tuple(x.shape)}")
    if k > block:
        raise ValueError(f"topk_compact: k={k} > block={block}")
    pad = (-x.shape[0]) % block
    if pad:
        x = torch.cat([x, x.new_zeros(pad)])
    if x.device.type == "cpu":
        return topk_compact_plain(x, k, block)
    if x.device.type == "meta":
        nb = x.numel() // block
        return _meta_launch("topk_compact", (
            x.new_empty((nb, k)), x.new_empty((nb, k), dtype=torch.int32)),
            _tk.topk_bytes(x, k, block))
    return _tk.topk_compact(x.contiguous(), k, block)


def blockwise_sparsify(x: torch.Tensor, k: int, block: int = 512
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Global ``(values, indices)`` from per-block top-k (SparCML
    packetization): flat vectors of length ``(n / block)·k`` with global
    indices; zero-valued tie fills and empty slots get index ``-1``,
    which ``sparse_accum`` drops.  Within a block the order is
    ``topk_compact``'s, so the lists are not sorted."""
    vals, idx = topk_compact(x, k, block)
    base = (torch.arange(vals.shape[0], dtype=torch.int32,
                         device=x.device) * block).unsqueeze(1)
    gidx = torch.where((idx >= 0) & (vals != 0), idx + base, -1)
    return vals.reshape(-1), gidx.reshape(-1)


# ---------------------------------------------------------------------------
# Flash attention: the port of ``repro/kernels/flash_attn.py``'s
# ``flash_attention``.  ``attention`` takes the model's ``(B, S, H, hd)``
# layout with GQA; ``flash_attention`` keeps the TPU kernel's ``(BH, S,
# hd)`` signature.  On the card both run the kernel under an autograd
# Function whose backward is a kernel too (``csrc/flash_bwd.cu``).
# ---------------------------------------------------------------------------

def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, scale: float | None = None,
              attn_cap: float = 0.0, window: int = 0, q_offset: int = 0,
              kv_len: int | None = None) -> torch.Tensor:
    """Attention of ``(B, Sq, H, hd)`` queries over ``(B, Sk, KV, hd)``
    keys and ``(B, Sk, KV, vd)`` values (``H % KV == 0``) → ``(B, Sq, H,
    vd)`` in ``q``'s dtype, differentiable.  Scores are ``fl32(q)·scale ·
    k`` in fp32, capped by ``attn_cap``, ``-1e30`` where the causal mask,
    the window or ``kv_len`` hides a key; query row ``i`` sits at
    position ``q_offset + i`` (masked decode over a KV cache).  On the
    card bf16 runs on the tensor cores in bf16 and fp32 on them in three
    TF32 products (``flash_attn``), and a decode-shaped launch (``G·Sq``
    at most ``flash_attn.DECODE_ROWS``) on the decode kernel in either
    dtype;
    when no gradient is wanted the kernel launches
    directly, so nothing is saved for a backward.  The masked form is
    serving's and has no backward on the card.

    A bf16 query over fp32 K/V (the VLM's cross layers over the
    pipeline's fp32 vision embeddings) is upcast and takes the fp32
    kernel, its output cast back to bf16: the reference's ``attend``
    computes it in fp32 and returns ``q``'s dtype.  Any other mix of
    dtypes raises on the card."""
    if (q.dtype == torch.bfloat16 and k.dtype == v.dtype == torch.float32):
        return attention(q.float(), k, v, causal=causal, scale=scale,
                         attn_cap=attn_cap, window=window,
                         q_offset=q_offset, kv_len=kv_len).to(q.dtype)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    kw = dict(causal=causal, scale=scale, attn_cap=attn_cap, window=window,
              q_offset=q_offset, kv_len=kv_len)
    if q.dim() == 5:
        return _attention_ranks(q, k, v, **kw)
    if q.device.type == "cpu":
        return _ref.flash_attention_bshd(q, k, v, **kw)[0]
    if q.device.type == "meta":
        if not (torch.is_grad_enabled()
                and any(t.requires_grad for t in (q, k, v))):
            return _meta_attention_fwd(q, k, v, **kw)[0]
        return _MetaFlash.apply(q, k, v, causal, scale, attn_cap, window)
    if not (torch.is_grad_enabled()
            and any(t.requires_grad for t in (q, k, v))):
        return _fa.attention_fwd(q, k, v, **kw)[0]
    if q_offset or kv_len is not None:
        raise ValueError("masked attention on the card is forward-only: "
                         "run it under torch.no_grad or inference_mode")
    return _fa.FlashAttention.apply(q, k, v, causal, scale, attn_cap, window)


def _attention_ranks(q, k, v, *, causal, scale, attn_cap, window,
                     q_offset, kv_len) -> torch.Tensor:
    """:func:`attention` of ``(N, B, …)`` tensors, forward only: on the
    card one launch reads k and v where they lie (an outer and an inner
    batch stride: one layer of a cache laid out ``(ranks, L, B, …)``);
    on ``meta`` the kernel's count.  On the CPU the caller folds the
    batch dims (``models.base.attend``)."""
    kw = dict(causal=causal, scale=scale, attn_cap=attn_cap, window=window,
              q_offset=q_offset, kv_len=kv_len)
    if q.device.type == "cuda":
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v)):
            raise ValueError("attention over rank axes on the card is "
                             "forward-only: run it under torch.no_grad or "
                             "inference_mode")
        return _fa.attention_fwd(q, k, v, **kw)[0]
    if q.device.type == "meta":
        return _meta_attention_fwd(q, k, v, **kw)[0]
    raise ValueError(f"attention over (N, B, ...) tensors runs on the card "
                     f"or on meta, not on {q.device}: fold the batch dims")


def attention_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      shards: int, causal: bool = True,
                      scale: float | None = None, attn_cap: float = 0.0,
                      window: int = 0, q_offset: int = 0,
                      kv_len: int | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Partial attention over a sequence split across ``shards`` ranks,
    forward only: ``q`` ``(N, B, Sq, H, hd)``, ``k``/``v`` ``(N, B, Sk,
    KV, vd)``, outer row ``n`` holding the ``(n mod shards)``-th block of
    ``Sk`` keys (rank-major rows, ``model`` the last rank axis), the masks
    and ``kv_len`` at the keys' absolute positions → ``(o (N, B, Sq, H,
    vd), lse (N, B, H, Sq) fp32)``, ``o = 0`` and ``lse = -inf`` on a row
    that sees no key of its block.  ``core.tp.lse_combine`` joins the
    blocks.  On the CPU the plain version (``ref.flash_attention_partial``),
    on the card one launch of the flash kernel over every rank's rows."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    kw = dict(causal=causal, scale=scale, attn_cap=attn_cap, window=window,
              q_offset=q_offset, kv_len=kv_len, shards=shards)
    if q.device.type == "cpu":
        return _ref.flash_attention_partial(q, k, v, **kw)
    if q.device.type == "meta":
        return _meta_attention_fwd(q, k, v, **kw)
    return _fa.attention_fwd(q, k, v, **kw)


def _meta_attention_fwd(q, k, v, *, causal, scale, attn_cap, window,
                        q_offset=0, kv_len=None, shards=None):
    """The ``meta`` branch of ``flash_attn.attention_fwd``: ``(o, lse)`` of
    the kernel's shapes and dtypes, its flops and bytes counted (of a
    partial launch, each shard's visible keys).  The dtypes and head dims
    the card's kernels refuse are refused here."""
    del scale, attn_cap
    *lead, sq, h, hd = q.shape
    sk, vd = k.shape[-3], v.shape[-1]
    dims = _fa.dims(q.dtype, h, k.shape[-2], sq)
    if q.dtype not in _fa.DTYPES or k.dtype != q.dtype \
            or v.dtype != q.dtype or (hd, vd) not in dims:
        raise ValueError(f"flash_attention kernel: {q.dtype} {k.dtype} "
                         f"{v.dtype} at (hd, vd) = {(hd, vd)}; wants one "
                         f"dtype of {list(_fa.DTYPES)} and {dims}")
    rows = 1
    for d in lead:
        rows *= d
    return _meta_launch(
        "flash_attention",
        (q.new_empty((*lead, sq, h, vd)),
         q.new_empty((*lead, h, sq), dtype=torch.float32)),
        _fa.bytes_moved(q, k, v, kv_len, window=window, q_offset=q_offset,
                        shards=shards),
        _fa.flops(rows, h, sq, sk, hd, causal=causal, window=window, vd=vd,
                  q_offset=q_offset, kv_len=kv_len, shards=shards))


class _MetaFlash(_fa.FlashAttention):
    """``FlashAttention`` with the ``meta`` branch's forward and backward:
    the backward counts the card's backward kernel (its outputs, bytes
    and flops, ``flash_attn.flops_bwd``) and refuses what it refuses."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, attn_cap, window):
        o, lse = _meta_attention_fwd(q, k, v, causal=causal, scale=scale,
                                     attn_cap=attn_cap, window=window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.opts = (causal, scale, attn_cap, window)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, _, _ = ctx.saved_tensors
        causal, _, _, window = ctx.opts
        b, sq, h, hd = q.shape
        sk = k.shape[1]
        if not _fa.rows_see_a_key(sq, sk, causal=causal, window=window,
                                  q_offset=0, kv_len=sk):
            raise ValueError(f"flash_attention backward kernel: window "
                             f"{window} leaves a query row of "
                             f"{tuple(q.shape)} without a key")
        dq, dk, dv = _meta_launch(
            "flash_attention_bwd", (q.new_empty(q.shape),
                                    k.new_empty(k.shape),
                                    v.new_empty(v.shape)),
            _fa.bytes_moved_bwd(q, k, v),
            _fa.flops_bwd(b, h, sq, sk, hd, causal=causal, window=window,
                          vd=v.shape[-1]))
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: float | None = None,
                    attn_cap: float = 0.0, window: int = 0) -> torch.Tensor:
    """``(BH, S, hd)`` q and k, ``(BH, S, vd)`` v (heads folded into the
    leading dim, GQA broadcast by the caller) → ``(BH, S, vd)``: the TPU
    kernel's signature.  Any ``S`` is taken: the kernel masks ragged
    tails."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"flash_attention wants (BH, S, hd), got "
                         f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    return attention(q.unsqueeze(2), k.unsqueeze(2), v.unsqueeze(2),
                     causal=causal, scale=scale, attn_cap=attn_cap,
                     window=window).squeeze(2)
