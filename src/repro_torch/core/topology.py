"""Reduction trees over the rank mesh and the Flare network manager (§4).

The port of ``repro/core/topology.py`` (plain Python, no tensors).  The
network manager of the paper, for each allreduce, computes a reduction
tree over the switches (leaves are hosts), statically partitions switch
memory across a predefined maximum of concurrent allreduces, and on a
failed or congested switch recomputes a tree around it, or falls back to
host-based allreduce.  Here:

* trees: :func:`build_tree` (uniform radix) and :func:`build_mesh_tree`
  (one switch level per mesh axis, the tree the switch data plane runs),
  with their levels bound to mesh axes (:func:`mesh_levels`) and the
  flat-vs-hierarchical wire policy (:func:`transport_schedule`);
* rebuilds: :func:`rebuild_excluding` (failed hosts),
  :func:`rebuild_excluding_switch` (a failed switch) and
  :func:`rebuild_avoiding` (the cheapest tree under a congestion map
  over the fabric's physical switch slots, :func:`tree_cost`);
* :class:`NetworkManager`: §4 admission of concurrent allreduces.

The multi-tenant runtime (``runtime/``) is this module's main caller.
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

    @property
    def is_host(self) -> bool:
        return self.level == 0

    @property
    def is_root(self) -> bool:
        return self.parent is None


@dataclasses.dataclass(frozen=True)
class ReductionTree:
    """A radix-``r`` reduction tree over ``num_hosts`` hosts.

    Nodes are stored level by level; level 0 holds the hosts.  Switches are
    shared between levels exactly as in the paper's Figure 1: each switch
    aggregates the packets of its children and forwards one aggregated
    packet to its parent; the root multicasts the result back down.

    ``level_radices`` records the fan-in used at each switch level
    (innermost/leaf first).  For mesh-mapped trees
    (:func:`build_mesh_tree`) the entries are the mesh axis sizes; for
    uniform trees every entry equals ``radix``.
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
    def root(self) -> TreeNode:
        return self.nodes[self.levels[-1][0]]

    @property
    def num_switches(self) -> int:
        return len(self.nodes) - self.num_hosts

    @property
    def leaf_fanin(self) -> int:
        """Children per leaf switch — the inner-axis aggregation factor.

        The hierarchical schedule's inter-level traffic shrinks by exactly
        this factor (each leaf switch forwards ONE aggregated packet for
        ``leaf_fanin`` child packets), so it is the quantity the
        flat-vs-hierarchical policy (:func:`transport_schedule`) keys on.
        """
        if self.depth < 1:
            return 1
        return len(self.nodes[self.levels[1][0]].children)

    def switch_children_counts(self) -> list[int]:
        """Per-switch expected packet count per block (the paper's ``P``)."""
        return [len(self.nodes[i].children)
                for lvl in self.levels[1:] for i in lvl]

    def wire_bytes_per_host(self, z_bytes: int) -> int:
        """Bytes each host puts on the wire for a Z-byte allreduce.

        In-network tree: each host sends its vector once up (Z) and
        receives it once down (Z) — the paper's headline 2x reduction over
        the ring allreduce's ~2Z *sent per host*.
        """
        return z_bytes

    def total_network_bytes(self, z_bytes: int) -> int:
        """Total bytes crossing links, up + down the whole tree."""
        # Every edge of the tree carries Z up and Z down.
        num_edges = sum(1 for n in self.nodes if n.parent is not None)
        return 2 * num_edges * z_bytes


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


def build_tree(num_hosts: int, radix: int) -> ReductionTree:
    """Build a complete radix-``radix`` reduction tree over the hosts."""
    if num_hosts < 1:
        raise ValueError("num_hosts must be >= 1")
    if radix < 2:
        raise ValueError("radix must be >= 2")
    nodes, levels, radices = _build(num_hosts, lambda _lvl: radix)
    return ReductionTree(num_hosts=num_hosts, radix=radix, nodes=nodes,
                         levels=levels, level_radices=radices)


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


def rebuild_excluding(tree: ReductionTree,
                      failed_hosts: Sequence[int]) -> ReductionTree:
    """Elastic re-mesh: recompute the tree excluding failed hosts.

    This is the paper's "the network manager can try to recompute a
    different reduction tree excluding that switch".  Host ids are
    re-numbered densely; the caller is responsible for mapping old ids to
    new ids.
    """
    failed = set(failed_hosts)
    survivors = [h for h in range(tree.num_hosts) if h not in failed]
    if not survivors:
        raise ValueError("all hosts failed; no tree to rebuild")
    return build_tree(len(survivors), tree.radix)


def switch_slot(tree: ReductionTree, switch_id: int) -> tuple[int, int]:
    """The physical ``(level, index)`` slot a switch node occupies.

    Slots name the fabric's switch positions independently of any one
    tree shape: a rebuilt tree binds its (fewer) switches to the same
    slot pool, which is what lets a congestion map outlive a replan.
    """
    node = tree.nodes[switch_id]
    if node.is_host:
        raise ValueError(f"node {switch_id} is a host, not a switch")
    return (node.level, tree.levels[node.level].index(switch_id))


def slot_pools(tree: ReductionTree) -> dict[int, int]:
    """Physical switch slots per level — the fabric a tree runs on."""
    return {lvl: len(tree.levels[lvl]) for lvl in range(1, len(tree.levels))}


def tree_cost(tree: ReductionTree, hotness, pools=None) -> float:
    """Bottleneck service cost of running ``tree`` on a congested fabric.

    ``hotness`` maps ``(level, index)`` slots to added load fractions
    (≥ 0; ``inf`` = unusable, e.g. a failed switch).  Each level binds
    its switches to the coolest available slots, pairing the largest
    fan-in with the coolest slot (the assignment that minimizes the
    bottleneck); the level's cost is the worst ``fanin · (1 + heat)``
    product and the tree's cost is the worst level.  A level needing
    more switches than ``pools`` provides is infeasible → ``inf``.
    """
    pools = slot_pools(tree) if pools is None else pools
    cost = 0.0
    for lvl in range(1, len(tree.levels)):
        k = len(tree.levels[lvl])
        n = pools.get(lvl, 0)
        if k > n:
            return math.inf
        heat = sorted(hotness.get((lvl, i), 0.0) for i in range(n))[:k]
        fanins = sorted((len(tree.nodes[nid].children)
                         for nid in tree.levels[lvl]), reverse=True)
        cost = max(cost, max(f * (1.0 + h) for f, h in zip(fanins, heat)))
    return cost


def rebuild_avoiding(tree: ReductionTree, hotness, *,
                     pools=None) -> ReductionTree | None:
    """The cheapest tree over the same hosts under a congestion map.

    The Canary generalization of the §4 failure path: instead of growing
    the fan-in just enough to exclude one dead switch, enumerate every
    uniform tree shape the physical slot pool can host and pick the one
    with the lowest :func:`tree_cost` under ``hotness`` — failure is the
    special case of an infinitely hot slot.  ``hotness`` keys are
    ``(level, index)`` slots, or ``int`` node ids of ``tree`` (converted
    via :func:`switch_slot`).  ``pools`` defaults to ``tree``'s own
    slots; pass the *original* fabric's pools when ``tree`` is already a
    rebuild.  Returns ``None`` when no candidate is feasible at finite
    cost (every usable shape needs an unusable slot) — the host-based
    fallback.
    """
    pools = slot_pools(tree) if pools is None else dict(pools)
    hot: dict[tuple[int, int], float] = {}
    for key, v in dict(hotness).items():
        slot = switch_slot(tree, key) if isinstance(key, int) else tuple(key)
        hot[slot] = max(hot.get(slot, 0.0), float(v))
    best, best_cost = None, math.inf
    for radix in range(2, tree.num_hosts + 1):
        cand = build_tree(tree.num_hosts, radix)
        cost = tree_cost(cand, hot, pools)
        if cost < best_cost:
            best, best_cost = cand, cost
    return best


def rebuild_excluding_switch(tree: ReductionTree,
                             switch_id: int) -> ReductionTree | None:
    """Recompute a tree over the *same hosts* avoiding a failed switch.

    The paper's §4 failure path: "the network manager can try to
    recompute a different reduction tree excluding that switch".  A
    failed switch means its level must make do with one switch fewer, so
    the fan-in at that level grows until the level fits — the recomputed
    tree spans every host but concentrates traffic on the survivors.
    Implemented as :func:`rebuild_avoiding` with the failed slot pinned
    infinitely hot, which also covers the boundary the old growth loop
    missed: at ``radix >= num_hosts`` a surviving sibling can still
    host the whole level (candidates are enumerated from scratch, not
    grown from the current radix).  Returns ``None`` when the failed
    switch has no usable sibling (nothing to re-route through): the
    caller falls back to host-based allreduce, exactly the paper's
    admission-failure path.
    """
    node = tree.nodes[switch_id]
    if node.is_host:
        raise ValueError(f"node {switch_id} is a host; use rebuild_excluding")
    if len(tree.levels[node.level]) - 1 < 1:
        return None                       # no alternative switch → host-based
    return rebuild_avoiding(tree, {switch_id: math.inf})


# ---------------------------------------------------------------------------
# Network manager: per-switch memory partitioning and admission control (§4).
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AllreduceLease:
    """Resources granted to one live allreduce on the tree."""

    allreduce_id: int
    tree: ReductionTree
    buffers_per_switch: int         # aggregation buffers (working memory)
    packet_bytes: int               # N-element packet payload size


class NetworkManager:
    """Control-plane bookkeeping for concurrent in-network allreduces.

    The paper statically partitions switch memory across a predefined
    maximum number of allreduces and rejects (→ host-based fallback) any
    request beyond that.  This is exactly that admission logic.
    """

    def __init__(self, l1_bytes_per_cluster: int = 1 << 20,
                 clusters: int = 64,
                 max_concurrent: int = 8,
                 packet_bytes: int = 1024):
        self.l1_bytes = l1_bytes_per_cluster * clusters
        self.max_concurrent = max_concurrent
        self.packet_bytes = packet_bytes
        self._active: dict[int, AllreduceLease] = {}
        self._next_id = 0

    @property
    def bytes_per_allreduce(self) -> int:
        return self.l1_bytes // self.max_concurrent

    def request(self, num_hosts: int, radix: int = 16) -> AllreduceLease | None:
        """Admit a new allreduce, or return None → host-based fallback."""
        if len(self._active) >= self.max_concurrent:
            return None
        tree = build_tree(num_hosts, radix)
        lease = AllreduceLease(
            allreduce_id=self._next_id,
            tree=tree,
            buffers_per_switch=self.bytes_per_allreduce // self.packet_bytes,
            packet_bytes=self.packet_bytes,
        )
        self._active[lease.allreduce_id] = lease
        self._next_id += 1
        return lease

    def release(self, allreduce_id: int) -> None:
        self._active.pop(allreduce_id, None)

    def active(self) -> list[AllreduceLease]:
        return list(self._active.values())

    def max_inflight_blocks(self, lease: AllreduceLease,
                            buffers_per_block: int) -> int:
        """Paper §4.3: hosts may keep at most R/M blocks in flight."""
        return max(1, lease.buffers_per_switch // max(1, buffers_per_block))

    def handle_switch_failure(self, lease: AllreduceLease,
                              switch_id: int) -> AllreduceLease | None:
        """§4 failure path: recompute the lease's tree, or host-fallback.

        On success the lease is replaced in place (same id, new tree); on
        ``None`` the lease is released — the caller must run the
        host-based allreduce for this reduction.
        """
        new_tree = rebuild_excluding_switch(lease.tree, switch_id)
        if new_tree is None:
            self.release(lease.allreduce_id)
            return None
        new_lease = dataclasses.replace(lease, tree=new_tree)
        self._active[lease.allreduce_id] = new_lease
        return new_lease


# ---------------------------------------------------------------------------
# Mesh ↔ tree mapping: the switch data plane's schedule.
# ---------------------------------------------------------------------------

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


def mesh_axes_as_tree(axis_sizes: Sequence[int]) -> ReductionTree:
    """Interpret nested mesh axes as a reduction tree.

    ``axis_sizes = (data,)`` → one switch level over the ``data`` axis;
    ``axis_sizes = (pod, data)`` → two levels: per-pod leaf switch over
    the ``data`` axis, a root switch over the ``pod`` axis.  This is
    exactly the shape ``core/collectives.hierarchical_allreduce``
    executes (alias of :func:`build_mesh_tree`).
    """
    return build_mesh_tree(axis_sizes)


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
