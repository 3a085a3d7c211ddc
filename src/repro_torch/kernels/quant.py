"""CUDA kernels: blockwise int8 quantize, dequantize, dequant-accumulate (F1).

The port of the Pallas kernels of ``repro/kernels/quant.py``, written by
hand in ``csrc/quant.cu`` (its head comment gives the design and the
exact rounding): ``quantize`` (rows → int8 and one fp32 scale a block),
``dequantize`` (int8 → f32/bf16/f16, or the fused error-feedback
residual ``v − q·s``) and ``dequant_accum_slots`` (the switch's fold of a
``(G, P, S, E)`` int8 stack, G switches in one launch, or with
``wire_order`` the int8 wire protocol's accumulation), with
``dequant_accum`` as its reshape.  All three are bound by memory; each
wrapper's ``*_bytes`` gives the bytes a launch must move.

Built with ``nvcc`` at first launch (``build.py``) and launched on
PyTorch's current stream.  The plain versions are in ``ref``; ``ops``
picks between them by the tensor's device.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build as _build

SOURCE = _build.CSRC / "quant.cu"

#: dtype codes of the C entry points
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: quantization blocks the quantize kernel is built for (32 lanes × 1..32)
QBLOCKS = (32, 64, 128, 256, 512, 1024)

#: Kernel launches so far, by wrapper; each wrapper adds one per launch
#: and nothing else touches them but a caller that resets them.
launches = {"quantize": 0, "dequantize": 0, "dequant_accum_slots": 0,
            "dequant_accum": 0}
#: of those fold launches, the ones in the wire order
wire_launches = 0

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.cache
def _entry(name: str):
    fn = getattr(_build.load(SOURCE), name)
    fn.argtypes = {
        "quantize": [_P, _P, _P, _I, _I, _L, _L, _L, _P],
        "dequantize": [_P, _P, _P, _P, _I, _I, _L, _P],
        "dequant_accum_slots": [_P, _P, _P, _I, _L, _L, _I, _L, _L, _L, _L,
                                _I, _P],
    }[name]
    fn.restype = ctypes.c_int
    return fn


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_cuda(name: str, *ts: torch.Tensor) -> None:
    for t in ts:
        if t.device.type != "cuda":
            raise ValueError(f"{name} kernel needs CUDA tensors, got "
                             f"{t.device}")


def _raise_on(err: int, name: str, what) -> None:
    if err:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err} "
                           f"for {what}")


# ---------------------------------------------------------------------------
# Bytes each launch must move: every input read once, every output
# written once.
# ---------------------------------------------------------------------------

def quantize_bytes(x: torch.Tensor, qblock: int) -> int:
    n = x.numel()
    return n * x.element_size() + n + 4 * (n // qblock)


def dequantize_bytes(q: torch.Tensor, qblock: int, out_dtype: torch.dtype,
                     residual: bool = False) -> int:
    n = q.numel()
    return n + 4 * (n // qblock) + n * out_dtype.itemsize * (2 if residual
                                                              else 1)


def dequant_accum_bytes(q: torch.Tensor, qblock: int) -> int:
    """For a ``(G, P, S, E)`` stack."""
    g, p, s, e = q.shape
    return g * p * s * e + 4 * g * p * s * (e // qblock) + 4 * g * s * e


# ---------------------------------------------------------------------------
# The wrappers.
# ---------------------------------------------------------------------------

def quantize(x: torch.Tensor, qblock: int = 256
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch on ``(R, n)`` rows of f32/bf16/f16 → int8 ``(R, n)`` and
    fp32 scales ``(R, n / qblock)``, both contiguous.  The rows may lie
    a stride apart (a sliced view); each row must be contiguous."""
    _check_cuda("quantize", x)
    if x.dtype not in DTYPES:
        raise ValueError(f"quantize kernel: unsupported dtype {x.dtype}; "
                         f"have {list(DTYPES)}")
    if qblock not in QBLOCKS:
        raise ValueError(f"quantize kernel: qblock={qblock} not in {QBLOCKS}")
    if x.dim() != 2:
        raise ValueError(f"quantize kernel wants (R, n), got "
                         f"{tuple(x.shape)}")
    r, n = x.shape
    if n % qblock:
        raise ValueError(f"quantize kernel: n={n} % qblock={qblock} != 0")
    if n > 1 and x.stride(1) != 1:
        raise ValueError(f"quantize kernel: rows must be contiguous, "
                         f"strides {x.stride()}")
    q = torch.empty((r, n), dtype=torch.int8, device=x.device)
    scales = torch.empty((r, n // qblock), dtype=torch.float32,
                         device=x.device)
    if q.numel() == 0:
        return q, scales
    with torch.cuda.device(x.device):
        err = _entry("quantize")(x.data_ptr(), q.data_ptr(),
                                 scales.data_ptr(), DTYPES[x.dtype], qblock,
                                 r * (n // qblock), n // qblock,
                                 x.stride(0) if r > 1 else n, _stream(x))
    _raise_on(err, "quantize", (tuple(x.shape), x.dtype))
    launches["quantize"] += 1
    return q, scales


def dequantize(q: torch.Tensor, scales: torch.Tensor, qblock: int = 256,
               out_dtype: torch.dtype = torch.float32,
               minuend: torch.Tensor | None = None,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """Launch on contiguous int8 ``q`` and its fp32 ``scales`` (one a
    ``qblock`` of ``q``'s elements, in order) → ``q·s`` in ``out_dtype``.

    With ``minuend`` ``v`` (``q``'s shape, the output's dtype), returns
    the error-feedback residual ``v − q·s`` instead.  ``out`` may be
    given, ``v`` itself included (the residual in place)."""
    _check_cuda("dequantize", q, scales)
    if minuend is not None:
        _check_cuda("dequantize", minuend)
        out_dtype = minuend.dtype
    if out_dtype not in DTYPES:
        raise ValueError(f"dequantize kernel: unsupported dtype {out_dtype}")
    if qblock < 16 or qblock % 16:
        raise ValueError(f"dequantize kernel: qblock={qblock} must be a "
                         "multiple of 16")
    n = q.numel()
    if n % qblock or scales.numel() != n // qblock:
        raise ValueError(f"dequantize kernel: {n} elements and "
                         f"{scales.numel()} scales at qblock={qblock}")
    if q.dtype != torch.int8 or scales.dtype != torch.float32:
        raise ValueError(f"dequantize kernel wants int8 and float32, got "
                         f"{q.dtype} and {scales.dtype}")
    for t in (q, scales, minuend, out):
        if t is not None and not t.is_contiguous():
            raise ValueError("dequantize kernel: operands must be "
                             "contiguous")
    if minuend is not None and minuend.shape != q.shape:
        raise ValueError(f"dequantize kernel: minuend {tuple(minuend.shape)}"
                         f" != q {tuple(q.shape)}")
    if out is None:
        out = torch.empty(q.shape, dtype=out_dtype, device=q.device)
    elif out.shape != q.shape or out.dtype != out_dtype:
        raise ValueError(f"dequantize kernel: out {tuple(out.shape)} "
                         f"{out.dtype} != {tuple(q.shape)} {out_dtype}")
    if n == 0:
        return out
    with torch.cuda.device(q.device):
        err = _entry("dequantize")(
            q.data_ptr(), scales.data_ptr(),
            None if minuend is None else minuend.data_ptr(), out.data_ptr(),
            DTYPES[out_dtype], qblock, n, _stream(q))
    _raise_on(err, "dequantize", (tuple(q.shape), out_dtype))
    launches["dequantize"] += 1
    return out


def _accum(q: torch.Tensor, scales: torch.Tensor, qblock: int,
           name: str, wire_order: bool) -> torch.Tensor:
    global wire_launches
    _check_cuda(name, q, scales)
    if q.dtype != torch.int8 or scales.dtype != torch.float32:
        raise ValueError(f"{name} kernel wants int8 and float32, got "
                         f"{q.dtype} and {scales.dtype}")
    if q.dim() != 4 or scales.dim() != 4:
        raise ValueError(f"{name} kernel wants (G, P, S, E) and "
                         f"(G, P, S, E/qblock), got {tuple(q.shape)} and "
                         f"{tuple(scales.shape)}")
    g, p, s, e = q.shape
    if p < 1:
        raise ValueError(f"{name} kernel: P={p}")
    if qblock < 16 or qblock % 16 or e % qblock:
        raise ValueError(f"{name} kernel: E={e} and qblock={qblock} must be "
                         "multiples of qblock and of 16")
    if tuple(scales.shape) != (g, p, s, e // qblock):
        raise ValueError(f"{name} kernel: scales {tuple(scales.shape)} != "
                         f"{(g, p, s, e // qblock)}")
    for t, w in ((q, e), (scales, e // qblock)):
        if (w > 1 and t.stride(3) != 1) or (s > 1 and t.stride(2) != w):
            raise ValueError(f"{name} kernel: each (S, E) block must be "
                             f"contiguous, strides {t.stride()}")
    out = torch.empty((g, s, e), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        err = _entry("dequant_accum_slots")(
            q.data_ptr(), scales.data_ptr(), out.data_ptr(), p, g, s * e,
            qblock, q.stride(0), q.stride(1), scales.stride(0),
            scales.stride(1), int(wire_order), _stream(q))
    _raise_on(err, name, tuple(q.shape))
    launches[name] += 1
    wire_launches += int(wire_order)
    return out


def dequant_accum_slots(q: torch.Tensor, scales: torch.Tensor,
                        qblock: int = 256, wire_order: bool = False
                        ) -> torch.Tensor:
    """Launch on a ``(G, P, S, E)`` int8 stack with ``(G, P, S,
    E/qblock)`` fp32 scales → ``(G, S, E)`` fp32, children folded in
    stack order: the switch's contraction, or with ``wire_order`` the
    wire protocol's (``ref.dequant_accum_slots``).  Each ``(S, E)``
    block must be contiguous; the G and P strides are free."""
    return _accum(q, scales, qblock, "dequant_accum_slots", wire_order)


def dequant_accum(q: torch.Tensor, scales: torch.Tensor,
                  qblock: int = 256, wire_order: bool = False
                  ) -> torch.Tensor:
    """Launch on a ``(P, n)`` int8 stack with ``(P, n/qblock)`` scales →
    ``(n,)`` fp32: the slot kernel on the reshape ``(1, P, n/qblock,
    qblock)``, one block a slot."""
    p, n = q.shape
    out = _accum(q.reshape(1, p, n // qblock, qblock),
                 scales.reshape(1, p, n // qblock, 1), qblock,
                 "dequant_accum", wire_order)
    return out.reshape(n)
