"""Gradient transport compression (paper F1: custom data types).

The port of the int8 half of ``repro/core/compression.py`` that the
in-network int8 transport runs: blockwise symmetric int8 quantization
with one fp32 scale a block of ``block`` elements, and error feedback,
which keeps each rank's compression residual (int8 or sparse) and adds
it into its next step.  Quantization goes through ``kernels.ops`` (the
CUDA kernels on the card, their plain versions on the CPU), with leading
axes flattened into rows of blocks.

The wire protocol (``quantized_*``) is not ported yet (ROADMAP queue 1
item 7).
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.kernels import ops


def quantize_int8(x: torch.Tensor, block: int = 256
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Blockwise symmetric int8 quantization along the last axis.

    Returns ``(q, scales)``: ``q`` int8 of ``x.shape`` and ``scales``
    fp32 of shape ``(*lead, n // block)``.  Leading axes (rank and bucket
    axes) vectorize: each row quantizes exactly as the flat form would.
    """
    *lead, n = x.shape
    if n % block:
        raise ValueError(f"quantize_int8: len {n} % {block} != 0")
    q, s = ops.quantize(x.reshape(-1, n), block)
    return q.reshape(x.shape), s.reshape(*lead, n // block)


def dequantize_int8(q: torch.Tensor, scales: torch.Tensor, block: int = 256,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_int8`, in ``dtype``."""
    return ops.dequantize(q.contiguous(), scales.contiguous(), block, dtype)


def _pad_last(x: torch.Tensor, m: int) -> tuple[torch.Tensor, int]:
    """Pad the last axis of ``x`` to a multiple of ``m``; return (padded, n)."""
    n = x.shape[-1]
    rem = (-n) % m
    if rem:
        x = torch.cat([x, x.new_zeros(*x.shape[:-1], rem)], dim=-1)
    return x, n


def quantize_roundtrip(x: torch.Tensor, block: int = 256) -> torch.Tensor:
    """What this rank's contribution looks like after encode + decode.

    Accepts leading batch axes; padding and the quantization blocks run
    along the last axis.
    """
    xp, n = _pad_last(x, block)
    q, s = quantize_int8(xp, block)
    return dequantize_int8(q, s, block, dtype=x.dtype)[..., :n]


def roundtrip_residual_(v: torch.Tensor, block: int = 256) -> torch.Tensor:
    """Replace ``v`` by ``v - quantize_roundtrip(v)`` in one pass that
    never holds the decoded copy (fp32 gives ``fma(-q, s, v)``, the bits
    XLA computes for the subtraction); returns ``v``."""
    vp, n = _pad_last(v, block)
    q, s = quantize_int8(vp, block)
    if vp is v and v.is_contiguous():
        return ops.dequantize(q, s, block, minuend=v, out=v)
    return v.copy_(ops.dequantize(q, s, block,
                                  minuend=vp.contiguous())[..., :n])


def error_feedback_step(grad: torch.Tensor, ef: torch.Tensor | None,
                        transmit: Callable[[torch.Tensor], tuple],
                        residual_: Callable[[torch.Tensor, Any],
                                            torch.Tensor]
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """One EF-compressed reduction step.

    ``v = grad + ef``; ``transmit(v)`` returns ``(reduced, sent)``: the
    (lossy) reduced ``v`` and what this rank put on the wire, in whatever
    form the encoding keeps it.  ``residual_(v, sent)`` then writes the
    new state ``v − decode(sent)`` over ``v``: the residual against the
    rank's own lossy encoding, which accumulates into the next step.
    Returns ``(reduced, new_ef)``.

    ``grad`` is consumed: ``v`` is formed in its storage and the residual
    is written over ``v``, so callers pass a tensor of their own (the
    engine passes the arena it packed).  The JAX function has
    ``transmit`` return the decoded local copy, an arena's size; here the
    residual is formed from what was sent without holding that copy
    (:func:`roundtrip_residual_` for int8, ``sparse.residual_``).  The
    bits are the same.
    """
    v = grad if ef is None else grad.add_(ef)
    reduced, sent = transmit(v)
    if reduced is v:            # a reduction over one rank hands v back
        reduced = v.clone()
    return reduced, residual_(v, sent)
