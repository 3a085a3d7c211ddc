"""Reduction trees over the rank mesh (plain Python, no tensors).

The port's copy of the part of ``repro/core/topology.py`` that the
in-network data plane needs: the tree of a nested mesh
(:func:`build_mesh_tree`), its switch levels bound to mesh axes
(:func:`mesh_levels`) and the flat-vs-hierarchical wire policy
(:func:`transport_schedule`).  The levels are the source of truth for
the switch data plane's schedule: level 1 aggregates over the innermost
mesh axis, level 2 over the next axis out, up to the root.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class TreeNode:
    """A node of a reduction tree (a switch, or a host at the leaves)."""

    node_id: int
    level: int                      # 0 = hosts, increasing toward the root
    children: tuple[int, ...]       # node_ids one level down
    parent: int | None              # node_id one level up (None at the root)


@dataclasses.dataclass(frozen=True)
class ReductionTree:
    """A reduction tree over ``num_hosts`` hosts, stored level by level.

    ``level_radices`` is the fan-in of each switch level, leaf first.
    """

    num_hosts: int
    radix: int
    nodes: tuple[TreeNode, ...]
    levels: tuple[tuple[int, ...], ...]   # node_ids per level
    level_radices: tuple[int, ...] = ()   # fan-in per switch level, leaf first

    @property
    def depth(self) -> int:
        return len(self.levels) - 1

    @property
    def leaf_fanin(self) -> int:
        """Children per leaf switch: the inner-axis aggregation factor."""
        if self.depth < 1:
            return 1
        return len(self.nodes[self.levels[1][0]].children)


def _build(num_hosts: int, radix_at) -> tuple[tuple, tuple, tuple]:
    """Build the tree level by level; ``radix_at(level)`` is the fan-in."""
    nodes: list[TreeNode] = []
    levels: list[list[int]] = []
    radices: list[int] = []

    current = list(range(num_hosts))
    for nid in current:
        nodes.append(TreeNode(node_id=nid, level=0, children=(), parent=None))
    levels.append(list(current))

    level = 0
    while len(current) > 1:
        level += 1
        radix = radix_at(level)
        radices.append(radix)
        parents: list[int] = []
        for i in range(0, len(current), radix):
            group = current[i:i + radix]
            pid = len(nodes)
            nodes.append(TreeNode(node_id=pid, level=level,
                                  children=tuple(group), parent=None))
            for cid in group:
                nodes[cid] = dataclasses.replace(nodes[cid], parent=pid)
            parents.append(pid)
        levels.append(parents)
        current = parents

    return (tuple(nodes), tuple(tuple(l) for l in levels), tuple(radices))


def build_mesh_tree(axis_sizes: Sequence[int]) -> ReductionTree:
    """The reduction tree of a nested mesh: one switch level per axis.

    ``axis_sizes`` is outermost-first (``(pods, hosts_per_pod)``).  Level
    1 aggregates over the innermost axis.  Size-1 axes carry no traffic
    and collapse into the level above.
    """
    sizes = [int(s) for s in axis_sizes]
    if not sizes or any(s < 1 for s in sizes):
        raise ValueError(f"axis sizes must be >= 1, got {axis_sizes!r}")
    num_hosts = math.prod(sizes)
    inner_first = [s for s in reversed(sizes) if s > 1]
    if not inner_first:                     # all axes trivial → 1-host mesh
        return ReductionTree(num_hosts=1, radix=2,
                             nodes=(TreeNode(0, 0, (), None),),
                             levels=((0,),), level_radices=())
    nodes, levels, radices = _build(
        num_hosts, lambda lvl: inner_first[min(lvl, len(inner_first)) - 1])
    return ReductionTree(num_hosts=num_hosts, radix=inner_first[0],
                         nodes=nodes, levels=levels, level_radices=radices)


@dataclasses.dataclass(frozen=True)
class MeshLevel:
    """One switch level of the reduction tree, bound to a mesh axis.

    ``switch_rank`` is the rank of each axis group that plays the switch:
    its aggregation buffer survives the up-pass and seeds the multicast.
    """

    level: int
    axis: str
    fanin: int
    switch_rank: int = 0


def mesh_levels(axis_names: Sequence[str],
                axis_sizes: Sequence[int]) -> tuple[MeshLevel, ...]:
    """Map reduction-tree levels onto mesh axes, leaf level first.

    Both sequences are outermost-first.  Size-1 axes are skipped; a mesh
    of one host gives one degenerate level of fan-in 1.
    """
    if len(axis_names) != len(axis_sizes):
        raise ValueError(f"{len(axis_names)} axis names for "
                         f"{len(axis_sizes)} sizes")
    tree = build_mesh_tree(axis_sizes)
    names_inner_first = [n for n, s in zip(reversed(tuple(axis_names)),
                                           reversed(tuple(axis_sizes)))
                         if s > 1]
    if not names_inner_first:               # degenerate 1-host mesh
        return (MeshLevel(level=1, axis=tuple(axis_names)[-1], fanin=1),)
    out = []
    for lvl in range(1, len(tree.levels)):
        fanin = len(tree.nodes[tree.levels[lvl][0]].children)
        out.append(MeshLevel(level=lvl, axis=names_inner_first[lvl - 1],
                             fanin=fanin))
    return tuple(out)


def transport_schedule(tree: ReductionTree) -> str:
    """``"flat"`` vs ``"hierarchical"`` wire schedule from the tree shape:
    hierarchical only when the leaf level aggregates more than 2 ways."""
    if tree.depth < 2:
        return "flat"
    return "hierarchical" if tree.leaf_fanin > 2 else "flat"
