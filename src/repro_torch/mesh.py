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

``ProcessMesh`` is the same mesh with one OS process (or, in tests, one
thread) a rank: a rank-local tensor leads with ``(1,) * ndim``
(``lead``), and every collective goes through ``torch.distributed``
process groups, one for every slice of the mesh along each set of axes.
It has ``RankMesh``'s methods and meaning, so the callers do not branch,
and every rank's result is, bit for bit, the slice of ``RankMesh``'s
result that belongs to it: ``psum`` gathers and sums in rank order with
``RankMesh.psum``'s loop (never ``all_reduce``, whose order NCCL leaves
open).  The switch's shortcuts become the switch's own traffic: a level's
children gather their arenas at the switch rank (``group_stack``), which
alone folds its one group; ranks that are no longer switches skip the
upper levels (``collapse``, ``holds``); the root's result comes back down
the tree level by level, a broadcast from each switch rank within its
group (``multicast``).  ``MeshCfg.rank_mesh`` returns the ``ProcessMesh``
that this thread has activated (``activate``), ``RankMesh`` otherwise.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import itertools
import math
import threading
from typing import Any, Sequence

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


def _check_axes(shape, axes) -> tuple[tuple[int, ...], tuple[str, ...]]:
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} has {len(shape)} axes, names "
                         f"{axes}")
    if len(set(axes)) != len(axes):
        raise ValueError(f"duplicate mesh axis names {axes}")
    if any(s < 1 for s in shape):
        raise ValueError(f"mesh axis sizes must be >= 1: {shape}")
    return shape, axes


class _Axes:
    """What both meshes read of their axes: names, sizes, world sizes."""

    shape: tuple[int, ...]
    axes: tuple[str, ...]

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
        if tuple(x.shape[:self.ndim]) != self.lead:
            raise ValueError(f"tensor {tuple(x.shape)} does not lead with "
                             f"the mesh shape's rank dims {self.lead}")


@dataclasses.dataclass(frozen=True)
class RankMesh(_Axes):
    """A mesh of emulated ranks laid out as the leading tensor axes."""

    shape: tuple[int, ...] = TWO_LEVEL
    axes: tuple[str, ...] = AXES

    def __post_init__(self):
        shape, axes = _check_axes(self.shape, self.axes)
        object.__setattr__(self, "shape", shape)
        object.__setattr__(self, "axes", axes)

    @property
    def lead(self) -> tuple[int, ...]:
        """The leading shape of a rank-local tensor: every rank's."""
        return self.shape

    @property
    def holds(self) -> bool:
        """Whether this program holds data after the collapses: always,
        every rank's stack is in the one tensor."""
        return True

    def own(self, x: torch.Tensor) -> torch.Tensor:
        """This program's ranks of an every-rank tensor ``(*shape,
        *s)``: all of them."""
        return x

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

    def collapse(self, axis: str, rank: int = 0) -> "RankMesh":
        """The mesh with ``axis`` cut to size 1: the ranks that still hold
        data once every group of ``axis`` has been reduced to one rank
        (``rank``, which the one tensor need not record)."""
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

    def multicast(self, x: torch.Tensor, held: "RankMesh",
                  like: torch.Tensor) -> torch.Tensor:
        """The root multicast down every level: ``x`` lies on ``held``,
        the mesh collapsed on every reduced axis, and every rank takes the
        result of the switch above it.  A broadcast view: the ranks share
        one copy (cloned, so the level buffers are released), the way
        every rank holds the same bits after the multicast.  ``like``
        gives a rank that holds nothing its shape and dtype (never here)."""
        return x.clone(memory_format=torch.contiguous_format).expand(
            self.shape + tuple(x.shape[self.ndim:]))

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


# ---------------------------------------------------------------------------
# Ranks as processes: the mesh over torch.distributed process groups.
# ---------------------------------------------------------------------------

#: How long a process group waits for its peers before it raises.
TIMEOUT = datetime.timedelta(seconds=300)

#: The paths that do not run on a ``ProcessMesh`` yet, by their ROADMAP
#: Queue 1 item.
UNPORTED = {
    21: "the lossy fabric on processes",
    22: "tenants on processes",
    23: "checkpoint and resume on processes",
    24: "serving on processes",
    25: "the per-packet oracle on processes",
}


def unported(what: str, item: int) -> NotImplementedError:
    """The error of a path that does not run on processes yet, naming the
    ROADMAP item that ports it."""
    return NotImplementedError(
        f"{what} does not run on a ProcessMesh: ROADMAP Queue 1, item "
        f"{item} ({UNPORTED[item]})")


def require_emulated(mesh, what: str, item: int) -> None:
    """Raise :func:`unported` where ``what`` is asked of a
    ``ProcessMesh``."""
    if isinstance(mesh, ProcessMesh):
        raise unported(what, item)


def new_group(store, rank: int, size: int, backend: str,
              timeout: datetime.timedelta = TIMEOUT):
    """A c10d process group of ``size`` ranks over ``store`` (a
    ``PrefixStore`` of its own), this one at ``rank``."""
    import torch.distributed as dist
    if backend == "gloo":
        return dist.ProcessGroupGloo(store, rank, size, timeout)
    if backend == "nccl":
        opts = dist.ProcessGroupNCCL.Options()
        opts._timeout = timeout
        return dist.ProcessGroupNCCL(store, rank, size, opts)
    raise ValueError(f"unknown backend {backend!r}: gloo or nccl")


def _subsets(n: int):
    """Every non-empty set of the ``n`` axes as sorted dims, smallest
    first: the fixed order in which every rank builds its groups."""
    for k in range(1, n + 1):
        yield from itertools.combinations(range(n), k)


@dataclasses.dataclass(frozen=True, eq=False)
class ProcessMesh(_Axes):
    """The mesh with one process a rank, holding only its own tensors.

    ``shape``, ``axes``, ``axis_size`` and ``world_size`` are the global
    mesh's, so the topology and the planes' level plans are those of
    ``RankMesh``; a rank-local tensor leads with ``lead = (1,) * ndim``.
    ``groups`` maps every set of axes (sorted dims) to this rank's group
    over its slice of the mesh, each group's ranks in the flat
    (row-major) order of their coordinates on those axes.  Build it with
    :meth:`create`.

    gloo's collectives take CUDA tensors, but its point-to-point
    ``send`` of one aborts the process (``writev``: Bad address, on an
    H100 with torch 2.11): with ``backend="gloo"`` the mesh stages
    ``ppermute``'s operands through host buffers itself (``_p2p``) and
    copies what arrives back to the operand's device.

    ``collapsed`` lists the ``(axis, switch rank)`` pairs of the tree
    levels reduced so far (``collapse``): the rank still holds data when
    it is the switch of every one of them (``holds``).
    """

    shape: tuple[int, ...]
    axes: tuple[str, ...]
    rank: int
    groups: Any = dataclasses.field(repr=False)
    backend: str = "gloo"
    collapsed: tuple[tuple[str, int], ...] = ()

    @classmethod
    def create(cls, store, rank: int, shape: Sequence[int],
               axes: Sequence[str], *, backend: str = "gloo",
               timeout: datetime.timedelta = TIMEOUT) -> "ProcessMesh":
        """This rank's mesh over ``store``: one group for every slice of
        the mesh along every set of axes that holds this rank, built
        once, in the same order on every rank, each over a
        ``PrefixStore`` named by its axes and its slice."""
        from torch.distributed import PrefixStore
        shape, axes = _check_axes(shape, axes)
        world = math.prod(shape)
        if not 0 <= rank < world:
            raise ValueError(f"rank {rank} is not in a mesh of {world}")
        coords = _unravel(rank, shape)
        groups = {}
        for dims in _subsets(len(shape)):
            others = tuple((k, coords[k]) for k in range(len(shape))
                           if k not in dims)
            sub = tuple(shape[k] for k in dims)
            grank = _ravel(tuple(coords[k] for k in dims), sub)
            name = ".".join(axes[k] for k in dims) + "/" + ",".join(
                f"{axes[k]}={c}" for k, c in others)
            groups[dims] = new_group(PrefixStore(name, store), grank,
                                     math.prod(sub), backend, timeout)
        return cls(shape, axes, rank, groups, backend)

    @property
    def lead(self) -> tuple[int, ...]:
        """The leading shape of a rank-local tensor: one rank's."""
        return (1,) * self.ndim

    @property
    def coords(self) -> tuple[int, ...]:
        """This rank's coordinate on every axis."""
        return _unravel(self.rank, self.shape)

    @property
    def holds(self) -> bool:
        """Whether this rank still holds data: it is the switch of every
        level collapsed so far."""
        return all(self.coords[self.dim(a)] == r for a, r in self.collapsed)

    def own(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's slice of an every-rank tensor ``(*shape, *s)``, as
        ``(*lead, *s)``: a view."""
        return x[self.coords].reshape(self.lead + tuple(x.shape[self.ndim:]))

    def _group(self, axes: str | Sequence[str]):
        return self.groups[tuple(sorted(self.dim(a)
                                        for a in axis_tuple(axes)))]

    def _p2p(self, x: torch.Tensor) -> torch.Tensor:
        """A point-to-point operand as the backend takes it: contiguous,
        and on the host where gloo would be handed a CUDA tensor."""
        x = x.contiguous()
        return x.cpu() if self.backend == "gloo" else x

    def _gather_all(self, x: torch.Tensor, axes) -> torch.Tensor:
        """Every rank's ``x`` of the group over ``axes`` in its order, as
        ``(*lead, P, *s)``, received in place."""
        g = self._group(axes)
        nd = self.ndim
        out = x.new_empty(self.lead + (g.size(),) + tuple(x.shape[nd:]))
        g.allgather([list(out.unbind(nd))], [x.contiguous()]).wait()
        return out

    def axis_index(self, axis: str, device=None) -> torch.Tensor:
        """This rank's index on ``axis``: an int32 tensor of shape
        ``lead`` (``lax.axis_index``)."""
        return torch.full(self.lead, self.coords[self.dim(axis)],
                          dtype=torch.int32, device=device)

    def all_gather(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """``(*lead, *s)`` → ``(*lead, P, *s)``: the stack of the axis
        group, slot ``c`` = child ``c``'s copy, materialised."""
        self._check(x)
        out = self._gather_all(x, axis)
        step_analysis.collective("all-gather", out, out.shape[self.ndim], 1)
        return out

    def group_stack(self, x: torch.Tensor, axis: str,
                    rank: int) -> torch.Tensor | None:
        """The children of the ``axis`` group send ``x`` to the group's
        rank ``rank`` (the level's switch): there the stack ``(1, P,
        *s)``, the one group's; ``None`` on every other child."""
        self._check(x)
        import torch.distributed as dist
        g = self._group(axis)
        xs = x.reshape(x.shape[self.ndim:]).contiguous()
        opts = dist.GatherOptions()
        opts.rootRank = rank
        if self.coords[self.dim(axis)] != rank:
            g.gather([], [xs], opts).wait()
            return None
        out = xs.new_empty((1, g.size()) + tuple(xs.shape))
        g.gather([list(out[0].unbind(0))], [xs], opts).wait()
        step_analysis.collective("all-gather", out, g.size(), 1)
        return out

    def collapse(self, axis: str, rank: int = 0) -> "ProcessMesh":
        """The mesh after the ``axis`` groups are reduced to their rank
        ``rank``: the global shape stays; ``holds`` says whether this
        rank is one of those that hold the data."""
        return dataclasses.replace(
            self, collapsed=self.collapsed + ((axis, int(rank)),))

    def multicast(self, x: torch.Tensor | None, held: "ProcessMesh",
                  like: torch.Tensor) -> torch.Tensor:
        """The root multicast down every level: from the top level down,
        each switch rank broadcasts what it holds within its group, among
        the ranks that held data below that level.  ``x`` is the result
        on the root's ranks (``held.holds``), ``None`` elsewhere; ``like``
        gives its shape and dtype."""
        import torch.distributed as dist
        out = x
        for i in reversed(range(len(held.collapsed))):
            axis, root = held.collapsed[i]
            below = dataclasses.replace(self, collapsed=held.collapsed[:i])
            if not below.holds:
                continue
            buf = (out.contiguous() if out is not None
                   else torch.empty_like(like,
                                         memory_format=torch.contiguous_format))
            opts = dist.BroadcastOptions()
            opts.rootRank = root
            self._group(axis).broadcast([buf], opts).wait()
            out = buf
        return out

    def psum(self, x: torch.Tensor, axes: str | Sequence[str]) -> torch.Tensor:
        """Sum over ``axes`` in rank order, result on every rank: gather,
        then ``RankMesh.psum``'s loop over the ranks in their flat
        (row-major) order."""
        self._check(x)
        ranks = self._gather_all(x, axes).unbind(self.ndim)
        acc = ranks[0]
        for c in range(1, len(ranks)):
            acc = acc + ranks[c]
        step_analysis.collective("all-reduce", acc, len(ranks), 1)
        return acc

    def all_to_all(self, x: torch.Tensor, axis: str, split_axis: int,
                   concat_axis: int, tiled: bool = True) -> torch.Tensor:
        """``lax.all_to_all`` over ``axis`` (``RankMesh.all_to_all``'s
        meaning): chunk ``j`` of the split axis goes to rank ``j``; what
        arrives joins ``concat_axis`` in source-rank order."""
        self._check(x)
        p = self.axis_size(axis)
        local = x.reshape(x.shape[self.ndim:])
        if tiled:
            if local.shape[split_axis] % p:
                raise ValueError(f"all_to_all: split axis of size "
                                 f"{local.shape[split_axis]} is not "
                                 f"divisible by {p}")
            local = local.unflatten(split_axis, (p, -1))
        elif local.shape[split_axis] != p:
            raise ValueError(f"all_to_all: untiled split axis has size "
                             f"{local.shape[split_axis]}, not {p}")
        send = local.movedim(split_axis, 0).contiguous()
        recv = torch.empty_like(send)
        self._group(axis).alltoall_base(recv, send, [], []).wait()
        out = recv.movedim(0, concat_axis)
        if tiled:
            out = out.flatten(concat_axis, concat_axis + 1)
        out = out.reshape(self.lead + tuple(out.shape))
        step_analysis.collective("all-to-all", out, p, 1)
        return out

    def ppermute(self, x: torch.Tensor, axis: str,
                 perm: Sequence[tuple[int, int]]) -> torch.Tensor:
        """``lax.ppermute``: paired sends and receives within the axis
        group; a rank that receives nothing gets 0."""
        self._check(x)
        g = self._group(axis)
        me = self.coords[self.dim(axis)]
        xs = self._p2p(x)
        works, got = [], None
        for s, d in perm:
            if s == me and d != me:
                works.append(g.send([xs], d, 0))
        for s, d in perm:
            if d == me:
                if s == me:
                    got = xs.clone()
                else:
                    got = torch.empty_like(xs)
                    works.append(g.recv([got], s, 0))
        for w in works:
            w.wait()
        step_analysis.collective("collective-permute", x, self.axis_size(axis),
                                 1)
        return torch.zeros_like(x) if got is None else got.to(x.device)


def _unravel(rank: int, shape: Sequence[int]) -> tuple[int, ...]:
    out = []
    for n in reversed(shape):
        out.append(rank % n)
        rank //= n
    return tuple(reversed(out))


def _ravel(coords: Sequence[int], shape: Sequence[int]) -> int:
    r = 0
    for c, n in zip(coords, shape):
        r = r * n + c
    return r


_ACTIVE = threading.local()


def active() -> ProcessMesh | None:
    """The ``ProcessMesh`` this thread has activated, or None."""
    return getattr(_ACTIVE, "mesh", None)


def set_active(mesh: ProcessMesh | None) -> None:
    """Make ``mesh`` this thread's active mesh, which
    ``sharding.rules.MeshCfg.rank_mesh`` returns (``None``: none)."""
    _ACTIVE.mesh = mesh


@contextlib.contextmanager
def activate(mesh: ProcessMesh | None):
    """:func:`set_active` for the ``with`` block (a thread a rank, as
    the tests run them, each activates its own)."""
    before = active()
    set_active(mesh)
    try:
        yield mesh
    finally:
        set_active(before)
