"""Failure detection and elastic re-meshing.

The port of ``repro/ft/coordinator.py``.  The paper's network manager
"can try to recompute a different reduction tree excluding that switch"
(§4).  The adaptation: a heartbeat failure detector over hosts plus a
re-mesh planner that, given the surviving hosts, produces the largest
power-of-two (data × model-preserving) mesh, the rank re-numbering, and
the reduction tree (``core.topology``) recomputed for the new mesh: the
same control-plane motion as the paper, executed at job scope.

A step's collectives are fixed for its mesh (DESIGN.md §8), so recovery
is checkpoint-restart onto the new mesh: detect → plan → restore
(``CheckpointManager`` saves global leaves, and
``sharding.rules.shard_params`` lays them out on the new mesh) → build
the step again.  Straggler mitigation below is in-step (bounded skew),
not membership change.
"""
from __future__ import annotations

import dataclasses
import time

from repro_torch.core import topology


@dataclasses.dataclass(frozen=True)
class RemeshPlan:
    """Output of the elastic planner."""

    survivors: tuple[int, ...]          # old host ids, sorted
    new_data: int                       # new data-axis size
    new_pod: int                        # new pod-axis size (1 = single pod)
    model: int                          # model axis preserved
    rank_map: dict[int, int]            # old host id → new rank
    dropped_hosts: tuple[int, ...]      # healthy hosts idled by rounding
    tree: topology.ReductionTree        # recomputed reduction tree

    @property
    def world(self) -> int:
        return self.new_pod * self.new_data


def plan_remesh(total_hosts: int, failed: set[int], *, model: int,
                hosts_per_pod: int | None = None) -> RemeshPlan:
    """Largest power-of-two data axis over the survivors.

    The model axis is preserved (parameter shards must stay complete);
    the data(+pod) axes shrink to the largest power of two ≤ survivors.
    Collectives require power-of-two axis sizes (rhd/fixed-tree), and
    batch re-chunking prefers it too.
    """
    survivors = tuple(sorted(h for h in range(total_hosts)
                             if h not in failed))
    if not survivors:
        raise RuntimeError("no survivors; cannot re-mesh")
    n = 1 << (len(survivors).bit_length() - 1)      # floor pow2
    used = survivors[:n]
    dropped = tuple(survivors[n:])
    if hosts_per_pod and n > hosts_per_pod:
        new_pod = n // hosts_per_pod
        new_data = hosts_per_pod
    else:
        new_pod, new_data = 1, n
    rank_map = {h: i for i, h in enumerate(used)}
    tree = topology.build_tree(n, radix=max(2, new_data))
    return RemeshPlan(survivors=tuple(used), new_data=new_data,
                      new_pod=new_pod, model=model, rank_map=rank_map,
                      dropped_hosts=dropped, tree=tree)


def recover_switch_failure(network: topology.NetworkManager,
                           lease: topology.AllreduceLease,
                           switch_id: int, *, runtime=None):
    """Route a failed *switch* rank through the §4 network-manager path.

    Host failures re-mesh (``plan_remesh``); a failed switch keeps every
    host and instead recomputes the lease's reduction tree around the
    dead switch (``topology.rebuild_excluding_switch`` via
    ``NetworkManager.handle_switch_failure`` — fan-ins grow on the
    survivors).  When a multi-tenant switch runtime
    (``runtime.SessionManager``) rides the lease's tree, its sessions
    are **drained and re-admitted** on the rebuilt tree: counters and
    memory demands are recomputed against the grown fan-ins, and
    sessions that no longer fit are evicted to host-based collectives.
    Returns the new lease, or ``None`` — no sibling switch to reroute
    through, the lease is released and *every* session drains to the
    host-based fallback (the paper's admission-failure path).
    """
    new_lease = network.handle_switch_failure(lease, switch_id)
    if runtime is not None:
        if new_lease is None:
            runtime.drain()
        else:
            runtime.rebind(new_lease.tree)
    return new_lease


def recover_session_failure(runtime, tenant: str | None, *,
                            reason: str = "retry budget exhausted") -> bool:
    """Degrade one *session* to the host-based wire fallback.

    The session-scoped leg of :func:`recover_switch_failure` (DESIGN.md
    §14): when the reliability layer's retry budget cannot recover a
    tenant's packets — lossy fabric, not a dead switch — only that
    tenant drains from the shared runtime (``SessionManager.evict``); the
    switch, its tree, and every other session are untouched.  The caller
    (``transports.SwitchTransport``) then reduces the affected arenas
    over the wire transports.  Idempotent; returns whether a session was
    actually drained.
    """
    if runtime is None or tenant is None:
        return False
    return runtime.evict(tenant, reason=reason)


class Coordinator:
    """Heartbeat failure detector (pluggable clock for tests).

    Detects *host* failures via heartbeats; *switch* failures are
    reported explicitly (there is no switch heartbeat — the paper's
    manager learns of them from the fabric) and routed through
    :func:`recover_switch_failure` when a ``network`` manager is
    attached.
    """

    def __init__(self, hosts: int, *, timeout_s: float = 10.0,
                 clock=time.monotonic,
                 network: topology.NetworkManager | None = None,
                 registry=None):
        self.hosts = hosts
        self.timeout = timeout_s
        self.clock = clock
        self.network = network
        #: optional ``obs.MetricsRegistry``: liveness events
        #: publish under ``ft.host<h>.{heartbeats,missed,stragglers,
        #: recoveries}`` (DESIGN.md §17), making ft state visible to
        #: the flight-recorder exports and the health plane's
        #: ``StragglerDetector``.  ``None`` = uninstrumented.
        self.registry = registry
        t = clock()
        self.last_seen = {h: t for h in range(hosts)}
        self.failed: set[int] = set()
        self.failed_switches: set[int] = set()
        self.failed_sessions: set[str] = set()

    def _count(self, host: int, event: str) -> None:
        if self.registry is not None:
            self.registry.counter(f"ft.host{int(host)}.{event}").inc()

    def switch_failure(self, lease: topology.AllreduceLease,
                       switch_id: int, *, runtime=None):
        """Record and recover from a failed switch rank (see
        :func:`recover_switch_failure`)."""
        if self.network is None:
            raise RuntimeError("no NetworkManager attached; construct the "
                               "Coordinator with network=...")
        self.failed_switches.add(switch_id)
        return recover_switch_failure(self.network, lease, switch_id,
                                      runtime=runtime)

    def heartbeat(self, host: int, *, now=None) -> None:
        """Record a host's liveness (``now`` overrides the instance
        clock for one call — deterministic timeout tests, no sleeps)."""
        if host in self.failed:
            return                      # rejoin requires explicit admit
        self.last_seen[host] = self.clock() if now is None else now
        self._count(host, "heartbeats")

    def admit(self, host: int, *, now=None) -> None:
        """Re-admit a recovered host (next re-mesh will include it)."""
        if host in self.failed:
            self._count(host, "recoveries")
        self.failed.discard(host)
        self.last_seen[host] = self.clock() if now is None else now

    def check(self, *, now=None) -> set[int]:
        """Mark hosts not seen within the timeout as failed."""
        t = self.clock() if now is None else now
        for h, seen in self.last_seen.items():
            if h not in self.failed and t - seen > self.timeout:
                self.failed.add(h)
                self._count(h, "missed")
        return set(self.failed)

    def straggler_report(self, step_starts: dict[int, float], *,
                         factor: float = 2.0, now=None) -> list[int]:
        """Hosts whose *current* step has run ``factor`` × the median
        elapsed time — the clocked wrapper over the pure
        :func:`straggler_report` (``now`` injectable like the heartbeat
        path, so slow-host detection tests run without sleeps)."""
        t = self.clock() if now is None else now
        slow = straggler_report({h: t - s for h, s in step_starts.items()},
                                factor=factor)
        for h in slow:
            self._count(h, "stragglers")
        return slow

    def session_failure(self, runtime, tenant: str, *,
                        reason: str = "retry budget exhausted") -> bool:
        """Record and recover a session whose retry budget is exhausted
        (see :func:`recover_session_failure`)."""
        drained = recover_session_failure(runtime, tenant, reason=reason)
        if drained:
            self.failed_sessions.add(tenant)
        return drained

    def plan(self, *, model: int, hosts_per_pod: int | None = None,
             ) -> RemeshPlan:
        return plan_remesh(self.hosts, self.failed, model=model,
                           hosts_per_pod=hosts_per_pod)


# ---------------------------------------------------------------------------
# Straggler mitigation (in-step).
# ---------------------------------------------------------------------------

def straggler_report(step_times: dict[int, float], *,
                     factor: float = 2.0) -> list[int]:
    """Hosts slower than ``factor`` × median step time.

    The schedule-level mitigation is built into the collectives:
    staggered bucket phases (§5) decorrelate the waiting pattern, and the
    two-level tree bounds how far one slow host's effect propagates (its
    pod absorbs the skew before the inter-pod exchange).  True partial /
    dynamic-membership collectives are not SPMD-expressible (DESIGN.md
    §8); hosts flagged here are candidates for the next re-mesh.
    """
    if not step_times:
        return []
    ts = sorted(step_times.values())
    median = ts[len(ts) // 2]
    return sorted(h for h, t in step_times.items() if t > factor * median)
