"""Plain PyTorch versions of the kernels (the correctness contract).

The port of ``repro/kernels/ref.py`` for the kernels ported so far.  On a
CPU tensor the ``ops`` wrappers run these; on the card they are what
each CUDA kernel is held against, bit for bit.
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
