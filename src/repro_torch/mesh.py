"""The rank mesh: emulated ranks as explicit leading tensor axes.

The JAX package runs every reduction inside a ``shard_map`` region over
a device mesh, one program per rank, with collectives over named axes.
The port emulates the same mesh in one process on one device: a
rank-local tensor ``x`` becomes ``(pod, data, *x.shape)`` and every
collective becomes a tensor operation along the rank axes.  This module
is the counterpart of ``compat.axis_size`` / ``world_size``, of the
fake meshes ``launch/mesh.FAKE_FLAT`` / ``FAKE_2D`` and of its
production meshes ``SINGLE_POD`` / ``MULTI_POD`` (``mesh_cfg``).

* ``all_gather`` returns a **view** — every rank's copy of the stack is
  the same storage, never materialised.
* ``psum`` sums in rank order (a fixed order; XLA's psum leaves it
  unspecified, and under nested ``vmap`` on the CPU takes the same).
* ``ppermute`` is an index along the rank axis; ranks that receive
  nothing get zeros, as in ``lax.ppermute``.
* ``all_to_all`` swaps the rank axis with the chunk axis, one copy.
* ``mean`` divides by a world size as XLA does, by its reciprocal.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

from repro_torch.launch import step_analysis

#: Reduction meshes over 8 emulated ranks, axes ``("pod", "data")``.
FLAT = (1, 8)
TWO_LEVEL = (2, 4)
AXES = ("pod", "data")

#: The production meshes the dry-run describes: 256 chips ``(data,
#: model)``, and 2 pods of 256 ``(pod, data, model)``.
SINGLE_POD = (16, 16)
MULTI_POD = (2, 16, 16)


def mesh_cfg(*, multi_pod: bool = False):
    """The production mesh as a ``sharding.rules.MeshCfg``."""
    from repro_torch.sharding.rules import MeshCfg
    if multi_pod:
        return MeshCfg(("pod", "data", "model"), MULTI_POD)
    return MeshCfg(("data", "model"), SINGLE_POD)


def axis_tuple(axes: str | Sequence[str]) -> tuple[str, ...]:
    """A mesh axis name or names as a tuple (``compat.axis_tuple``)."""
    return (axes,) if isinstance(axes, str) else tuple(axes)


@dataclasses.dataclass(frozen=True)
class RankMesh:
    """A mesh of emulated ranks laid out as the leading tensor axes."""

    shape: tuple[int, ...] = TWO_LEVEL
    axes: tuple[str, ...] = AXES

    def __post_init__(self):
        object.__setattr__(self, "shape", tuple(int(s) for s in self.shape))
        object.__setattr__(self, "axes", tuple(self.axes))
        if len(self.shape) != len(self.axes):
            raise ValueError(f"mesh shape {self.shape} has {len(self.shape)} "
                             f"axes, names {self.axes}")
        if len(set(self.axes)) != len(self.axes):
            raise ValueError(f"duplicate mesh axis names {self.axes}")
        if any(s < 1 for s in self.shape):
            raise ValueError(f"mesh axis sizes must be >= 1: {self.shape}")

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def dim(self, axis: str) -> int:
        """Position of ``axis`` among the leading rank dims."""
        try:
            return self.axes.index(axis)
        except ValueError:
            raise ValueError(f"no mesh axis {axis!r} in {self.axes}") from None

    def axis_size(self, axis: str) -> int:
        return self.shape[self.dim(axis)]

    def world_size(self, axes: Sequence[str] | None = None) -> int:
        axes = self.axes if axes is None else axes
        return math.prod(self.axis_size(a) for a in axes)

    def mean(self, x: torch.Tensor, axes: str | Sequence[str]
             ) -> torch.Tensor:
        """``x`` over the world size of ``axes``, as the jitted reference
        computes ``x / world``: XLA turns a division by a constant into
        a product with its reciprocal."""
        return x * (1.0 / self.world_size(axis_tuple(axes)))

    def _check(self, x: torch.Tensor) -> None:
        if tuple(x.shape[:self.ndim]) != self.shape:
            raise ValueError(f"tensor {tuple(x.shape)} does not lead with "
                             f"the mesh shape {self.shape}")

    def axis_index(self, axis: str, device=None) -> torch.Tensor:
        """Each rank's index on ``axis``: an int32 tensor that broadcasts
        over the leading rank dims (``lax.axis_index``)."""
        k = self.dim(axis)
        view = [1] * self.ndim
        view[k] = self.shape[k]
        return torch.arange(self.shape[k], dtype=torch.int32,
                            device=device).reshape(view)

    def all_gather(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """``(*mesh, *s)`` → ``(*mesh, P, *s)``: every rank sees the stack
        of its axis group, slot ``c`` = child ``c``'s copy.  A view."""
        self._check(x)
        k = self.dim(axis)
        shape = list(x.shape)
        shape.insert(k, self.shape[k])
        out = x.unsqueeze(k).expand(shape).movedim(k + 1, self.ndim)
        step_analysis.collective("all-gather", out, self.shape[k],
                                 self.world_size())
        return out

    def group_stack(self, x: torch.Tensor, axis: str,
                    rank: int) -> torch.Tensor:
        """The gathered stack of the rank at index ``rank`` of every
        ``axis`` group, as ``(G, P, *s)``: G runs over the other mesh
        axes.  A view (the switch ranks' ingress, all groups at once)."""
        st = self.all_gather(x, axis).select(self.dim(axis), rank)
        return st.reshape(-1, *st.shape[self.ndim - 1:])

    def collapse(self, axis: str) -> "RankMesh":
        """The mesh with ``axis`` cut to size 1: the ranks that still hold
        data once every group of ``axis`` has been reduced to one rank."""
        k = self.dim(axis)
        return dataclasses.replace(
            self, shape=self.shape[:k] + (1,) + self.shape[k + 1:])

    def scatter_group(self, y: torch.Tensor, axis: str, rank: int,
                      fill: int | float = 0) -> torch.Tensor:
        """Inverse of a group reduction: ``(G, *s)`` held by rank ``rank``
        of every ``axis`` group → ``(*mesh, *s)``, ``fill`` elsewhere."""
        k = self.dim(axis)
        others = tuple(n for i, n in enumerate(self.shape) if i != k)
        rest = tuple(y.shape[1:])
        out = y.new_full(self.shape + rest, fill)
        out.select(k, rank).copy_(y.reshape(others + rest))
        return out

    def psum(self, x: torch.Tensor, axes: str | Sequence[str]) -> torch.Tensor:
        """Sum over ``axes`` in rank order, result on every rank.  Over
        several axes the ranks are taken in their flat (row-major) order,
        the order XLA's psum takes under nested ``vmap``."""
        self._check(x)
        ks = sorted(self.dim(a) for a in axis_tuple(axes))
        ranks = x.movedim(ks, list(range(len(ks)))).flatten(0, len(ks) - 1)
        acc = ranks[0]
        for c in range(1, ranks.shape[0]):
            acc = acc + ranks[c]
        for k in ks:
            acc = acc.unsqueeze(k)
        out = acc.expand(x.shape)
        step_analysis.collective("all-reduce", out, ranks.shape[0],
                                 self.world_size())
        return out

    def all_to_all(self, x: torch.Tensor, axis: str, split_axis: int,
                   concat_axis: int, tiled: bool = True) -> torch.Tensor:
        """``lax.all_to_all`` over ``axis``: each rank splits its tensor
        into P chunks along ``split_axis`` and sends chunk ``j`` to rank
        ``j``, which concatenates what it receives along ``concat_axis``
        in source-rank order.  The axes count in the rank-local tensor.
        ``tiled`` keeps the rank-local shape's rank; untiled, the split
        axis (of size P) goes and an axis of size P is inserted at
        ``concat_axis``.  One strided copy: the rank axis swapped with
        the chunk axis."""
        self._check(x)
        k, nd, p = self.dim(axis), self.ndim, self.axis_size(axis)
        sa, ca = nd + split_axis, nd + concat_axis
        if tiled:
            if x.shape[sa] % p:
                raise ValueError(f"all_to_all: split axis of size "
                                 f"{x.shape[sa]} is not divisible by {p}")
            x = x.unflatten(sa, (p, x.shape[sa] // p))   # chunk axis at sa
        elif x.shape[sa] != p:
            raise ValueError(f"all_to_all: untiled split axis has size "
                             f"{x.shape[sa]}, not {p}")
        # rank r's chunk j ← rank j's chunk r: swap the two axes
        x = x.transpose(k, sa).movedim(sa, ca).contiguous()
        # tiled: the sources' chunks, in rank order, join concat_axis
        out = x.flatten(ca, ca + 1) if tiled else x
        step_analysis.collective("all-to-all", out, p, self.world_size())
        return out

    def ppermute(self, x: torch.Tensor, axis: str,
                 perm: Sequence[tuple[int, int]]) -> torch.Tensor:
        """``lax.ppermute``: rank ``dst`` receives rank ``src``'s tensor
        for each ``(src, dst)`` pair; ranks that receive nothing get 0."""
        self._check(x)
        k = self.dim(axis)
        p = self.shape[k]
        src = [None] * p
        for s, d in perm:
            src[d] = s
        step_analysis.collective("collective-permute", x, p,
                                 self.world_size())
        if all(s is not None for s in src):
            idx = torch.tensor(src, dtype=torch.long, device=x.device)
            return x.index_select(k, idx)
        out = torch.zeros_like(x)
        for d, s in enumerate(src):
            if s is not None:
                out.select(k, d).copy_(x.select(k, s))
        return out
