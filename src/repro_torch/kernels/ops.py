"""Public wrappers over the kernels: padding, accumulation type, dispatch.

The port of ``repro/kernels/ops.py`` for the fixed-tree fold.  A tensor
on the CPU takes the plain PyTorch version (``ref``); a tensor on the
card launches the CUDA kernel or raises — there is no fallback.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels import tree_reduce as _tr


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
    out = _tr.tree_reduce_slots(_pad_pow2(g, 1))
    return out[0] if squeeze else out


def tree_reduce(x: torch.Tensor) -> torch.Tensor:
    """Fixed-tree reduce of a ``(P, N)`` stack over axis 0 → ``(N,)``:
    the slot fold with one group and one slot."""
    if x.dim() != 2:
        raise ValueError(f"tree_reduce wants (P, N), got {tuple(x.shape)}")
    p, n = x.shape
    return tree_reduce_slots(x.reshape(1, p, 1, n)).reshape(n)
