"""FSDP parameter streaming routed through Flare collectives.

The port of ``repro/core/fsdp.py``.  ZeRO/FSDP keeps each parameter
sharded over the ``data`` axis (replicated over ``pod``), all-gathers it
just before use and reduce-scatters its gradient; that reduce-scatter is
the leaf level of the paper's reduction tree.  ``gather_params`` is a
``torch.autograd.Function`` whose forward is a Flare all-gather over the
inner axis and whose backward is a Flare reduce-scatter over it plus an
allreduce over the outer (pod) axes, the root of the tree.
``algorithm="fixed_tree"`` makes the gradient path bitwise-reproducible
(F3).

On the rank-axis layout the shard is ``(*mesh, *local)`` and the gathered
leaf ``(*mesh, *full)``: every rank's copy.  The backward therefore
receives every rank's own gradient of the full leaf, unreduced, and
returns every rank's reduced shard, as each rank's ``custom_vjp`` does
in the reference.  ``axis`` is the sharded dim of the rank-local leaf.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core import collectives as coll
from repro_torch.mesh import RankMesh


def _alg(algorithm: str) -> str:
    """Map the engine-level algorithm names onto the gather/scatter pair."""
    return ("rhd" if algorithm in ("auto", "two_level", "hierarchical")
            else algorithm)


def _gather_impl(shard: torch.Tensor, mesh: RankMesh, axes: Sequence[str],
                 algorithm: str, axis: int) -> torch.Tensor:
    nd = mesh.ndim
    x = shard.movedim(nd + axis, nd) if axis else shard
    full = coll.all_gather(x, mesh, (axes[-1],), algorithm=_alg(algorithm),
                           ordered=True)
    return full.movedim(nd, nd + axis) if axis else full


def _scatter_impl(g: torch.Tensor, mesh: RankMesh, axes: Sequence[str],
                  algorithm: str, axis: int) -> torch.Tensor:
    nd = mesh.ndim
    x = g.movedim(nd + axis, nd) if axis else g
    gs = coll.reduce_scatter(x, mesh, tuple(axes), algorithm=_alg(algorithm),
                             ordered=True)
    return gs.movedim(nd, nd + axis) if axis else gs


class _GatherParams(torch.autograd.Function):

    @staticmethod
    def forward(ctx, shard, mesh, axes, algorithm, axis):
        ctx.args = (mesh, tuple(axes), algorithm, axis)
        return _gather_impl(shard, mesh, axes, algorithm, axis)

    @staticmethod
    def backward(ctx, g):
        return (_scatter_impl(g, *ctx.args), None, None, None, None)


def gather_params(shard: torch.Tensor, mesh: RankMesh, axes: Sequence[str],
                  algorithm: str = "ring", axis: int = 0) -> torch.Tensor:
    """All-gather a param sharded on ``axis``; backward = Flare
    reduce-scatter over the inner axis + allreduce over the outer ones."""
    return _GatherParams.apply(shard, mesh, tuple(axes), algorithm, axis)


def fsdp_pad(x: torch.Tensor, p: int) -> torch.Tensor:
    """Pad the leading axis to a multiple of the FSDP world size."""
    return coll.pad_to_multiple(x, p, 0)[0]
