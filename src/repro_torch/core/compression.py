"""Gradient transport compression (paper F1: custom data types).

The port of ``repro/core/compression.py``: blockwise symmetric int8
quantization with one fp32 scale a block of ``block`` elements, the int8
wire protocol, and error feedback, which keeps each rank's compression
residual (int8 or sparse) and adds it into its next step.  Quantization
goes through ``kernels.ops`` (the CUDA kernels on the card, their plain
versions on the CPU), with leading axes flattened into rows of blocks.

The wire protocol (``quantized_*``) runs on the rank-axis layout
``(*mesh.lead, ..., Z)``: every leading axis after the mesh's (the
arena's bucket axis) vectorizes, so a batched form is the same function
as the flat one and every exchange carries all buckets.  Each leg:
quantize (the ``quantize`` kernel) → ``mesh.all_to_all`` (rank ``r``
holds every rank's int8 copy of chunk ``r``; on a ``ProcessMesh`` the
group's ``alltoall``) → the fp32 accumulation in stack order (the
``dequant_accum`` kernel in its wire order) → requantize → all-gather →
``dequantize``.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.kernels import ops
from repro_torch.mesh import RankMesh, axis_tuple


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


def quantized_reduce_scatter(x: torch.Tensor, mesh: RankMesh, axis: str, *,
                             block: int = 256) -> tuple[torch.Tensor, int]:
    """The reduce-scatter leg of the int8 wire protocol (steps 1–3).

    Pads ``x``'s last axis to whole blocks of P chunks, quantizes,
    exchanges with one ``all_to_all`` for the int8 payload and one for
    the scales (rank ``r`` then holds every rank's copy of chunk ``r``),
    and accumulates them in fp32 in rank order.  Returns ``(red, n)``:
    ``(*mesh, ..., Zp / P)`` fp32, the rank's reduced chunk, and the
    unpadded length for :func:`quantized_all_gather`.
    """
    p = mesh.axis_size(axis)
    xp, n = _pad_last(x, p * block)
    chunk = xp.shape[-1] // p
    q, s = quantize_int8(xp, block)
    last = xp.dim() - mesh.ndim - 1          # the vector's rank-local axis
    qt = mesh.all_to_all(q, axis, last, last)
    st = mesh.all_to_all(s, axis, last, last)
    del q, s
    nb = chunk // block
    red = ops.dequant_accum_slots(qt.reshape(-1, p, nb, block),
                                  st.reshape(-1, p, nb, 1), block,
                                  wire_order=True)
    return red.reshape(*xp.shape[:-1], chunk), n


def _gather_last(mesh: RankMesh, x: torch.Tensor, axis: str) -> torch.Tensor:
    """A tiled all-gather along the last axis: ``(*mesh, ..., c)`` →
    ``(*mesh, ..., P·c)``, every rank's own copy."""
    g = mesh.all_gather(x, axis)                     # (*mesh, P, ..., c)
    return g.movedim(mesh.ndim, -2).flatten(-2)


def quantized_all_gather(red: torch.Tensor, mesh: RankMesh, axis: str, *,
                         block: int = 256,
                         dtype: torch.dtype = torch.float32,
                         n: int | None = None) -> torch.Tensor:
    """The broadcast leg (steps 4–5): requantize, all-gather the int8
    payload and the scales, dequantize in ``dtype``; ``n`` cuts the
    pad."""
    qr, sr = quantize_int8(red, block)
    out = dequantize_int8(_gather_last(mesh, qr, axis),
                          _gather_last(mesh, sr, axis), block, dtype=dtype)
    return out if n is None else out[..., :n]


def quantized_allreduce(x: torch.Tensor, mesh: RankMesh, axis: str, *,
                        block: int = 256, mean: bool = False
                        ) -> torch.Tensor:
    """int8-transport allreduce over one mesh axis: the reduce-scatter
    leg, then the broadcast leg, in ``x``'s dtype.  The result carries
    the quantization error of the two legs' rounds; error feedback
    (:func:`error_feedback_step`) folds the residual into the next
    step."""
    red, n = quantized_reduce_scatter(x, mesh, axis, block=block)
    if mean:
        red = mesh.mean(red, axis)
    return quantized_all_gather(red, mesh, axis, block=block, dtype=x.dtype,
                                n=n)


def quantized_allreduce_hier(x: torch.Tensor, mesh: RankMesh,
                             inner_axis: str, outer_axes, *,
                             block: int = 256, mean: bool = False
                             ) -> torch.Tensor:
    """Hierarchical int8 allreduce over a multi-level reduction tree:
    reduce-scatter over ``inner_axis`` (Z int8 on the intra-pod wires),
    a quantized allreduce of the owned ``Z / fanin`` chunk over each
    upper level (``outer_axes``, a name or names, innermost first; one
    more quantization round each), then requantize and all-gather back
    down."""
    red, n = quantized_reduce_scatter(x, mesh, inner_axis, block=block)
    outer = axis_tuple(outer_axes)
    for ax in outer:
        red = quantized_allreduce(red, mesh, ax, block=block)
    if mean:
        red = mesh.mean(red, (inner_axis, *outer))
    return quantized_all_gather(red, mesh, inner_axis, block=block,
                                dtype=x.dtype, n=n)


# The batched ``(*mesh, B, Z)`` forms: the leading bucket axis vectorizes,
# one all_to_all and one all-gather pair carry every bucket, and per
# bucket the chain is the flat form's, so the functions are the same.
quantized_reduce_scatter_batched = quantized_reduce_scatter
quantized_all_gather_batched = quantized_all_gather
quantized_allreduce_batched = quantized_allreduce
quantized_allreduce_hier_batched = quantized_allreduce_hier


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
