"""HPU-cluster partition policies for the multi-tenant switch runtime.

The port of ``repro/runtime/partition.py`` (plain Python).

The Flare switch is explicitly multi-tenant (§3–§4): the PsPIN data
plane is carved into HPU clusters and several allreduce operations from
different applications aggregate concurrently on one switch.  Clusters
are shared-nothing, so a partition is simply a mapping

    session (tenant) → disjoint contiguous slice of the K clusters

and the per-tenant throughput law is the single-job model applied to the
slice (``perfmodel.switch_model.model_shared``).  Three policies:

=================  =========================================================
``static``          the paper's §4 scheme: capacity is split evenly across
                    the *predefined maximum* number of sessions, so an
                    admitted session's share never changes — predictable,
                    but idle shares are wasted.
``weighted_fair``   largest-remainder apportionment of all K clusters by
                    session weight; allocations always sum to exactly K
                    and every session holds at least one cluster.
``greedy``          work-conserving: clusters of sessions with no queued
                    packets are reclaimed and redistributed (weighted
                    fair) among the busy ones — no cluster idles while
                    any session has work (Canary's contention-aware
                    direction, PAPERS.md).
=================  =========================================================

Policies are pure functions of ``(weights, total_clusters[, queue])`` so
the fairness/conservation invariants are directly property-testable
(``tests/test_runtime.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping

POLICIES = ("static", "weighted_fair", "greedy")


@dataclasses.dataclass(frozen=True)
class ClusterSlice:
    """One tenant's contiguous run of HPU clusters."""

    tenant: str
    start: int
    count: int

    @property
    def stop(self) -> int:
        return self.start + self.count


@dataclasses.dataclass(frozen=True)
class Partition:
    """A disjoint assignment of cluster slices to tenants."""

    total_clusters: int
    slices: tuple[ClusterSlice, ...]

    def clusters(self, tenant: str) -> int:
        for s in self.slices:
            if s.tenant == tenant:
                return s.count
        return 0

    def slice_of(self, tenant: str) -> ClusterSlice | None:
        for s in self.slices:
            if s.tenant == tenant:
                return s
        return None

    @property
    def allocated(self) -> int:
        return sum(s.count for s in self.slices)

    @property
    def idle(self) -> int:
        return self.total_clusters - self.allocated

    def validate(self) -> "Partition":
        """Disjointness and bounds — every policy's output obeys these."""
        if self.allocated > self.total_clusters:
            raise ValueError(f"allocated {self.allocated} of "
                             f"{self.total_clusters} clusters")
        end = 0
        for s in self.slices:
            if s.count < 0 or s.start < end:
                raise ValueError(f"overlapping slice {s}")
            end = s.stop
        if end > self.total_clusters:
            raise ValueError("slices run past the cluster array")
        return self


def _layout(alloc: Mapping[str, int], total: int) -> Partition:
    """Lay allocations out as contiguous slices, in mapping order."""
    slices, off = [], 0
    for tenant, count in alloc.items():
        slices.append(ClusterSlice(tenant=tenant, start=off,
                                   count=int(count)))
        off += int(count)
    return Partition(total_clusters=int(total),
                     slices=tuple(slices)).validate()


def static_partition(weights: Mapping[str, float], total_clusters: int,
                     max_sessions: int) -> Partition:
    """§4 static split: ``K // max_sessions`` clusters per admitted
    session, regardless of how many are actually active.  Weights are
    ignored — the predictability *is* the policy."""
    if len(weights) > max_sessions:
        raise ValueError(f"{len(weights)} sessions exceed the static "
                         f"maximum of {max_sessions}")
    per = total_clusters // max(1, max_sessions)
    if per < 1 and weights:
        raise ValueError(f"{total_clusters} clusters cannot serve "
                         f"{max_sessions} static shares")
    return _layout({t: per for t in weights}, total_clusters)


def weighted_fair_partition(weights: Mapping[str, float],
                            total_clusters: int) -> Partition:
    """Largest-remainder apportionment by weight.

    Invariants (property-tested): allocations sum to **exactly**
    ``total_clusters``, and every session holds ≥ 1 cluster (the fix-up
    takes from the largest shares, preserving the sum).
    """
    names = list(weights)
    if not names:
        return Partition(total_clusters=int(total_clusters), slices=())
    if any(weights[t] <= 0 for t in names):
        raise ValueError("session weights must be positive")
    if total_clusters < len(names):
        raise ValueError(f"{total_clusters} clusters cannot give "
                         f"{len(names)} sessions one each")
    w_sum = float(sum(weights[t] for t in names))
    shares = {t: weights[t] / w_sum * total_clusters for t in names}
    alloc = {t: int(math.floor(shares[t])) for t in names}
    # distribute the remainder by largest fractional part (name-tied for
    # determinism)
    rem = total_clusters - sum(alloc.values())
    order = sorted(names, key=lambda t: (-(shares[t] - alloc[t]), t))
    for t in order[:rem]:
        alloc[t] += 1
    # min-1 fix-up: raise zeros, taking from the largest allocations
    for t in names:
        while alloc[t] < 1:
            donor = max(names, key=lambda d: (alloc[d], d))
            if alloc[donor] <= 1:
                raise ValueError("cannot guarantee one cluster each")
            alloc[donor] -= 1
            alloc[t] += 1
    return _layout(alloc, total_clusters)


def greedy_partition(weights: Mapping[str, float], total_clusters: int,
                     queued: Mapping[str, int]) -> Partition:
    """Work-conserving reclamation: idle sessions (no queued packets)
    cede their clusters to the busy ones.

    Invariant (property-tested): while *any* session has queued packets,
    every cluster is allocated to a session that has queued packets — no
    idle cluster coexists with a backlog.  With nothing queued anywhere
    this degrades to ``weighted_fair`` (the next packet finds its fair
    share already in place).
    """
    busy = {t: weights[t] for t in weights if queued.get(t, 0) > 0}
    if not busy:
        return weighted_fair_partition(weights, total_clusters)
    part = weighted_fair_partition(busy, total_clusters)
    # idle tenants keep a 0-cluster slice so the partition still names
    # every session (predictions read 0 → reclaimed)
    alloc = {t: part.clusters(t) for t in busy}
    for t in weights:
        alloc.setdefault(t, 0)
    return _layout({t: alloc[t] for t in weights}, total_clusters)


def make_partition(policy: str, weights: Mapping[str, float],
                   total_clusters: int, *, max_sessions: int | None = None,
                   queued: Mapping[str, int] | None = None) -> Partition:
    """Dispatch on the policy name (the ``SessionManager`` entry point)."""
    if policy == "static":
        if max_sessions is None:
            raise ValueError("static policy needs max_sessions")
        return static_partition(weights, total_clusters, max_sessions)
    if policy == "weighted_fair":
        return weighted_fair_partition(weights, total_clusters)
    if policy == "greedy":
        return greedy_partition(weights, total_clusters, queued or {})
    raise ValueError(f"unknown partition policy {policy!r}; have {POLICIES}")
