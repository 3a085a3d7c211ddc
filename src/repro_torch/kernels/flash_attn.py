"""CUDA kernel: flash attention forward (online softmax), for Hopper.

The port of the Pallas kernel ``repro/kernels/flash_attn.py::
flash_attention``: one kernel, written by hand in ``csrc/flash_attn.cu``,
computes causal / sliding-window / tanh-capped attention with fp32
state over ``(B, Sq, H, hd)`` queries and ``(B, Sk, KV, hd)`` keys and
values (GQA: head ``h`` reads KV head ``h // (H / KV)``), and writes each
query row's log-sum-exp beside the output.  Ragged ``Sq``/``Sk`` tails
are masked in the kernel.  It is bound by operations: ``4·hd`` flops per
visible (query, key) pair.

``FlashAttention`` is the ``torch.autograd.Function`` around it.  The
JAX package has no backward kernel (its training path differentiates
the attention through XLA), so the backward is the plain PyTorch
``ref.flash_attention_bwd``: it recomputes the probabilities from the
saved log-sum-exp one chunk of query rows at a time.

The source is compiled with ``nvcc`` for ``sm_90a`` at first use into
``build/`` beside this file and loaded with ``ctypes`` (``build.py``);
the kernel launches on PyTorch's current stream.  Nothing is built when
this module is imported.  The plain version of the forward is
``ref.flash_attention_bshd``; ``ops`` picks between them by device.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels import ref as _ref

SOURCE = _build.CSRC / "flash_attn.cu"

#: dtype codes of the C entry point
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: head dims the kernel is instantiated for
HEAD_DIMS = (16, 32, 64)
#: query rows a block (the grid's second dimension is ceil(Sq / QT))
QT = 128

#: Kernel launches so far; the wrapper adds one per launch and nothing
#: else touches it but a caller that resets it.
launches = 0


@functools.cache
def _entry():
    fn = _build.load(SOURCE).flash_attn_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                      ctypes.c_int, ctypes.c_float, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flops(b: int, h: int, sq: int, sk: int, hd: int, *, causal: bool,
          window: int = 0) -> int:
    """Flops one forward launch needs: ``4·hd`` for every (query, key)
    pair the mask leaves visible (a score and its share of ``P·V``)."""
    if not causal:
        pairs = sq * sk
    else:
        i = torch.arange(sq, dtype=torch.int64)
        hi = torch.clamp(i + 1, max=sk)
        lo = torch.clamp(i - window + 1, min=0) if window > 0 else 0 * i
        pairs = int(torch.clamp(hi - lo, min=0).sum())
    return 4 * hd * pairs * b * h


def bytes_moved(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> int:
    """Bytes one launch must move: q, k and v read once, the output and
    the fp32 log-sum-exp written once."""
    b, sq, h, _ = q.shape
    return (2 * q.numel() * q.element_size() + k.numel() * k.element_size()
            + v.numel() * v.element_size() + 4 * b * h * sq)


def attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool, scale: float, attn_cap: float,
                  window: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel → ``(o (B, Sq, H, hd), lse (B, H, Sq) fp32)``.

    ``q`` is ``(B, Sq, H, hd)``, ``k``/``v`` ``(B, Sk, KV, hd)`` CUDA
    tensors of one dtype (fp32 or bf16), ``H % KV == 0``, ``hd`` in
    ``HEAD_DIMS``, each with a contiguous last dim (other strides free).
    """
    global launches
    ts = (q, k, v)
    if any(t.device.type != "cuda" for t in ts):
        raise ValueError(f"flash_attention kernel needs CUDA tensors, got "
                         f"{[str(t.device) for t in ts]}")
    if len({t.device for t in ts}) != 1:
        raise ValueError("flash_attention kernel: q, k, v on different "
                         "devices")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention kernel: dtypes {q.dtype} "
                         f"{k.dtype} {v.dtype}; wants one of {list(DTYPES)}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention kernel wants (B, Sq, H, hd) q and "
                         f"(B, Sk, KV, hd) k, v; got {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != hd or h % kv:
        raise ValueError(f"flash_attention kernel: q {tuple(q.shape)} and "
                         f"k {tuple(k.shape)} do not match (H % KV == 0)")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel: head dim {hd} not in "
                         f"{HEAD_DIMS}")
    if sq < 1 or sk < 1 or b < 1 or sq > 65535 * QT:
        raise ValueError(f"flash_attention kernel: empty or too long "
                         f"{tuple(q.shape)} {tuple(k.shape)}")
    if any(t.stride(3) != 1 for t in ts):
        raise ValueError("flash_attention kernel: the head dim must be "
                         "contiguous")
    o = torch.empty((b, sq, h, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                       *v.stride()[:3], *o.stride()[:3])
    fn = _entry()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), DTYPES[q.dtype], hd, b, h, kv, sq, sk,
                 strides, float(scale), int(bool(causal)), float(attn_cap),
                 int(window), stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError "
                           f"{err} for q {tuple(q.shape)} k {tuple(k.shape)} "
                           f"{q.dtype}")
    launches += 1
    return o, lse


class FlashAttention(torch.autograd.Function):
    """Attention whose forward is the kernel and whose backward is the
    plain chunked recompute from the saved log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, attn_cap, window):
        o, lse = attention_fwd(q, k, v, causal=causal, scale=scale,
                               attn_cap=attn_cap, window=window)
        ctx.save_for_backward(q, k, v, lse)
        ctx.opts = (causal, scale, attn_cap, window)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, lse = ctx.saved_tensors
        causal, scale, attn_cap, window = ctx.opts
        dq, dk, dv = _ref.flash_attention_bwd(
            q, k, v, lse, do, causal=causal, scale=scale, attn_cap=attn_cap,
            window=window)
        return dq, dk, dv, None, None, None, None
