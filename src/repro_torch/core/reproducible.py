"""Opt-in bitwise-reproducible reduction (paper F3).

The port of ``repro/core/reproducible.py``.  Floating-point summation is
commutative but not associative: the tree shape of the combine decides
the bits.  Flare's answer (§6.3) is tree aggregation with a structure
that is a pure function of the input port, never of arrival order; here
the aligned binary tree over rank ids
(``collectives.allreduce_fixed_tree``) with fp32 accumulation.  It is
opt-in (``FlareConfig(reproducible=True)``) because the fixed tree costs
Z·log2(P) wire bytes a rank against ~2Z for the ring.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core import collectives as coll
from repro_torch.mesh import RankMesh


def reproducible_allreduce(x: torch.Tensor, mesh: RankMesh,
                           axes: Sequence[str], *,
                           hierarchical: bool = False) -> torch.Tensor:
    """Bitwise-deterministic allreduce: fixed tree, fp32 accumulation.

    ``hierarchical=True`` takes the tree-driven schedule's fixed-tree
    variant (``collectives.hierarchical_allreduce``): the leaf level
    reduce-scatters with the recursive-halving aligned tree, upper levels
    combine with the XOR fixed tree.  The two modes give different (each
    stable) bits: their combine trees differ.
    """
    return coll.allreduce(x, mesh, axes,
                          algorithm="hierarchical" if hierarchical
                          else "fixed_tree",
                          reproducible=True, accum_dtype=torch.float32)


def reproducible_reduce_scatter(x: torch.Tensor, mesh: RankMesh,
                                axes: Sequence[str]) -> torch.Tensor:
    """Deterministic reduce-scatter: the recursive-halving aligned tree
    (the FSDP gradient path with ``algorithm="fixed_tree"``)."""
    return coll.reduce_scatter(x, mesh, axes, algorithm="fixed_tree")


def combine_order(p: int) -> list[tuple[int, int, int]]:
    """The documented combine schedule: ``(step, left, right)`` says that
    at ``step`` the partial of the rank block starting at ``left``
    combines with the block starting at ``right``.  A pure function of
    P."""
    out = []
    for k in range(p.bit_length() - 1):
        d = 1 << k
        for base in range(0, p, 2 * d):
            out.append((k, base, base + d))
    return out
