"""CUDA kernels: flash attention forward (online softmax), for Hopper.

The port of the Pallas kernel ``repro/kernels/flash_attn.py::
flash_attention``: ``csrc/flash_attn.cu``, written by hand, computes
causal / sliding-window / tanh-capped attention with fp32 state over
``(B, Sq, H, hd)`` queries, ``(B, Sk, KV, hd)`` keys and ``(B, Sk, KV,
vd)`` values (GQA: head ``h`` reads KV head ``h // (H / KV)``), and
writes each query row's log-sum-exp beside the output.  Ragged
``Sq``/``Sk`` tails are masked in the kernel.  It is bound by
operations: ``2·(hd + vd)`` flops per visible (query, key) pair.

Masked decode: ``q_offset`` places query row ``i`` at position
``q_offset + i`` and ``kv_len`` hides the keys at or past it, the
reference's ``attend(q_pos=pos + arange(Sq), kv_len=pos + Sq)`` over a KV
cache.  The kernel streams only the keys some row can see, so a decode
step reads the cache's filled part; it is then bound by those bytes.

The dtype alone picks the kernel: bf16 runs on the tensor cores
(``wgmma`` fed by TMA, probabilities split into two bf16 halves; head
dims ``TC_DIMS``), fp32 on the CUDA cores (``FP32_DIMS``), the only
route that holds fp32 to the reference's 3e-5.  ``launches`` counts
every launch, ``tc_launches`` the tensor-core kernel's alone.

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
#: (hd, vd) the CUDA-core kernel takes, fp32 only (128: two threads a
#: query row)
FP32_DIMS = ((16, 16), (32, 32), (64, 64), (128, 128))
#: (hd, vd) the tensor-core kernel takes, bf16 only
TC_DIMS = ((16, 16), (32, 32), (64, 64), (128, 128), (256, 256), (192, 128))
#: query rows a block (the grid's second dimension is ceil(Sq / QT))
QT = 128

#: Kernel launches so far, either kernel; the wrapper adds one per launch
#: and nothing else touches it but a caller that resets it.
launches = 0
#: The tensor-core kernel's launches alone, counted the same way.
tc_launches = 0


@functools.cache
def _entry():
    fn = _build.load(SOURCE).flash_attn_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                      ctypes.c_int, ctypes.c_float, ctypes.c_int,
                      ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flops(b: int, h: int, sq: int, sk: int, hd: int, *, causal: bool,
          window: int = 0, vd: int | None = None, q_offset: int = 0,
          kv_len: int | None = None) -> int:
    """Flops one forward launch needs: ``2·hd`` for the score and ``2·vd``
    for its share of ``P·V``, for every (query, key) pair the mask leaves
    visible."""
    vd = hd if vd is None else vd
    klim = sk if kv_len is None else min(sk, kv_len)
    if not causal:
        pairs = sq * klim
    else:
        pos = q_offset + torch.arange(sq, dtype=torch.int64)
        hi = torch.clamp(pos + 1, max=klim)
        lo = torch.clamp(pos - window + 1, min=0) if window > 0 else 0 * pos
        pairs = int(torch.clamp(hi - lo, min=0).sum())
    return 2 * (hd + vd) * pairs * b * h


def bytes_moved(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                kv_len: int | None = None, *, window: int = 0,
                q_offset: int = 0) -> int:
    """Bytes one launch must move: q and the keys and values some query
    row can see read once (those below ``kv_len``, all of them by
    default, and with a causal ``window`` none before the first row's
    window, which starts at ``q_offset - window + 1``), the output ``(B,
    Sq, H, vd)`` and the fp32 log-sum-exp written once."""
    b, sq, h, _ = q.shape
    sk = k.shape[1]
    keys = sk if kv_len is None else min(sk, kv_len)
    if window > 0:
        keys -= min(keys, max(0, q_offset - window + 1))
    out = b * sq * h * v.shape[-1] * q.element_size()
    return (q.numel() * q.element_size()
            + (k.numel() * k.element_size()
               + v.numel() * v.element_size()) // sk * keys
            + out + 4 * b * h * sq)


def rows_see_a_key(sq: int, sk: int, *, causal: bool, window: int,
                   q_offset: int, kv_len: int) -> bool:
    """Whether every query row sees at least one key under the mask.

    The kernel leaves out keys that no row of a block sees, exactly only
    if every row sees one (a row that sees none gets the reference's
    mean over all ``-1e30`` scores).  The visible span of row ``i`` is
    ``[lo_i, hi_i)`` with both ends nondecreasing in ``i``, so its
    length is smallest at the first or the last row."""
    klim = min(sk, kv_len)
    if not causal:
        return klim >= 1
    for pos in (q_offset, q_offset + sq - 1):
        lo = max(0, pos - window + 1) if window > 0 else 0
        if min(klim, pos + 1) <= lo:
            return False
    return True


def _strides(t: torch.Tensor) -> tuple[int, int, int]:
    """``t``'s (batch, seq, head) element strides, a size-1 dim's taken
    as if packed (it is never stepped, and TMA checks every stride)."""
    out = []
    inner = t.shape[3]                      # the head dim is contiguous
    for d in (2, 1, 0):
        out.append(t.stride(d) if t.shape[d] > 1 else inner)
        inner = out[-1] * t.shape[d]
    return out[2], out[1], out[0]


def attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool, scale: float, attn_cap: float, window: int,
                  q_offset: int = 0, kv_len: int | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch a kernel → ``(o (B, Sq, H, vd), lse (B, H, Sq) fp32)``.

    ``q`` is ``(B, Sq, H, hd)``, ``k`` ``(B, Sk, KV, hd)`` and ``v``
    ``(B, Sk, KV, vd)``, CUDA tensors of one dtype, ``H % KV == 0``, each
    with a contiguous last dim.  bf16 launches the tensor-core kernel at
    ``(hd, vd)`` in ``TC_DIMS``; it reads q, k and v by TMA, so each base
    is 16-byte aligned and each stride a multiple of 8 elements.  fp32
    launches the CUDA-core kernel at ``(hd, vd)`` in ``FP32_DIMS`` (other
    strides free).  ``q_offset`` (a host int, at least 0) is query row
    0's position and ``kv_len`` (a host int, at least 1; ``Sk`` by
    default) hides the keys at or past it; a mask under which some row
    sees no key raises.  Anything else raises; nothing is copied.
    """
    global launches, tc_launches
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
    if q.dim() != 4 or k.dim() != 4 or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"flash_attention kernel wants (B, Sq, H, hd) q, "
                         f"(B, Sk, KV, hd) k and (B, Sk, KV, vd) v; got "
                         f"{tuple(q.shape)} {tuple(k.shape)} "
                         f"{tuple(v.shape)}")
    b, sq, h, hd = q.shape
    sk, kv, vd = k.shape[1], k.shape[2], v.shape[3]
    if k.shape[0] != b or k.shape[3] != hd or h % kv:
        raise ValueError(f"flash_attention kernel: q {tuple(q.shape)} and "
                         f"k {tuple(k.shape)} do not match (H % KV == 0)")
    tc = q.dtype == torch.bfloat16
    dims = TC_DIMS if tc else FP32_DIMS
    if (hd, vd) not in dims:
        raise ValueError(f"flash_attention kernel: (hd, vd) = {(hd, vd)} "
                         f"not in {dims} for {q.dtype}")
    if sq < 1 or sk < 1 or b < 1 or sq > 65535 * QT:
        raise ValueError(f"flash_attention kernel: empty or too long "
                         f"{tuple(q.shape)} {tuple(k.shape)}")
    kv_len = sk if kv_len is None else kv_len
    if not (isinstance(q_offset, int) and isinstance(kv_len, int)):
        raise TypeError(f"flash_attention kernel: q_offset and kv_len are "
                        f"host ints, got {type(q_offset).__name__} and "
                        f"{type(kv_len).__name__}")
    if (q_offset, kv_len) != (0, sk) and (
            q_offset < 0 or kv_len < 1 or not rows_see_a_key(
                sq, sk, causal=causal, window=window, q_offset=q_offset,
                kv_len=kv_len)):
        raise ValueError(f"flash_attention kernel: q_offset {q_offset}, "
                         f"kv_len {kv_len} leave a query row of "
                         f"{tuple(q.shape)} without a key")
    if any(t.stride(3) != 1 for t in ts):
        raise ValueError("flash_attention kernel: the head dim must be "
                         "contiguous")
    strides = [_strides(t) for t in ts]
    if tc and (any(t.data_ptr() % 16 for t in ts)
               or any(x % 8 for st in strides for x in st)):
        raise ValueError(f"flash_attention kernel: TMA wants 16-byte "
                         f"aligned bases and strides of 8 elements; got "
                         f"strides {strides}")
    o = torch.empty((b, sq, h, vd), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    cstrides = (ctypes.c_longlong * 12)(*strides[0], *strides[1],
                                        *strides[2], *o.stride()[:3])
    fn = _entry()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), DTYPES[q.dtype], hd, vd, b, h, kv, sq, sk,
                 cstrides, float(scale), int(bool(causal)), float(attn_cap),
                 int(window), q_offset, kv_len, stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError "
                           f"{err} for q {tuple(q.shape)} k {tuple(k.shape)} "
                           f"v {tuple(v.shape)} {q.dtype}")
    launches += 1
    tc_launches += tc
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
