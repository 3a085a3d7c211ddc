"""Ingress interleaving and per-tenant accounting for the shared switch.

The port of ``repro/runtime/scheduler.py`` (plain Python).

One physical switch sees ONE packet stream per port; with N concurrent
sessions that stream is an interleave of the tenants' packets.  This
module owns that interleave:

* :func:`interleave` — the deterministic per-level ingress order
  (``round_robin`` cycles one packet per active session, the fair-queue
  shape; ``priority`` drains higher-priority sessions first — strict
  precedence).
* :func:`simulate_shared` — a multi-server FCFS service simulation of
  the interleaved leaf-level ingress: packets arrive back-to-back at
  line rate δ, each tenant's partition slice serves them with ``K_i``
  HPU cores at its own service time ``τ_i``.  The measured per-tenant
  throughput (packets / busy span) is the quantity the analytic
  shared-switch mode predicts (``switch_model.model_shared``:
  ``min(K_i/τ_i, share_i/δ)``) — the runtime's half of the
  emulator ↔ model cross-check.
* per-tenant counters — ingress packets, combines, occupancy — that sum
  to the single-tenant totals (conservation is property-tested): the
  interleave reorders work, it never creates or destroys any.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Mapping, Sequence

from repro_torch.perfmodel import switch_model as sm

ORDERS = ("round_robin", "priority")


@dataclasses.dataclass(frozen=True)
class TenantLoad:
    """One session's demand on the shared switch, control-plane view.

    ``queued`` (optional) is a backlog snapshot: the number of leaf
    packets currently awaiting service.  ``None`` means the steady-state
    view — one full allreduce's worth of ingress.  A tenant with
    ``queued=0`` is idle: the greedy policy may have reclaimed its
    clusters, and the scheduler must not (and does not) schedule
    anything for it.
    """

    tenant: str
    counters: object            # dataplane.SwitchCounters
    clusters: int               # partition slice size
    priority: int = 0
    queued: int | None = None
    #: NACK-driven retransmission packets a lossy fabric adds on top of
    #: the plan's first-transmission ingress (DESIGN.md §14) — extra
    #: service demand the interleave must account, not new combine work
    #: (retransmitted payloads fold at most once via the seen-bitmap).
    retransmit_packets: int = 0
    #: Congestion slowdown on this tenant's service time (DESIGN.md §15):
    #: ``τ_eff = τ · service_scale``.  1.0 = idle fabric; the replan loop
    #: sets ``1 + bound heat`` of the hottest slot the tree binds, so the
    #: measured shared schedule and the analytic prediction see the same
    #: congested operating point.
    service_scale: float = 1.0

    @property
    def leaf_packets(self) -> int:
        """Ingress packets at the leaf level — what the switch schedules
        (the queued backlog or the plan's full ingress, plus any modeled
        retransmissions)."""
        if self.queued is not None:
            return int(self.queued) + int(self.retransmit_packets)
        return (int(self.counters.levels[0].ingress_packets)
                + int(self.retransmit_packets))

    @property
    def combines(self) -> int:
        """Combine ops of one full allreduce (plan totals, §6 P−1 per
        slot) — schedule-independent, unlike the packet backlog."""
        return int(self.counters.total_combines)


def service_tau(counters, params: sm.SwitchParams = sm.SwitchParams(),
                ) -> float:
    """τ for one ingress packet of this session's aggregation design.

    Evaluates the single-job analytic model at the session's own
    operating point (design, block count, leaf fan-in) through the
    counters' ``model_point`` hook.
    """
    data_bytes = int(counters.blocks) * int(counters.packet_bytes)
    return float(counters.model_point(max(1, data_bytes)).tau)


def interleave(packets: Mapping[str, int], order: str = "round_robin",
               priorities: Mapping[str, int] | None = None,
               ) -> tuple[tuple[str, int], ...]:
    """The global ingress sequence: ``((tenant, per-tenant index), ...)``.

    ``round_robin`` takes one packet from each session with work left,
    cycling in mapping order; ``priority`` drains sessions in descending
    ``priorities`` (ties broken by name for determinism).
    """
    if order not in ORDERS:
        raise ValueError(f"unknown schedule order {order!r}; have {ORDERS}")
    names = [t for t in packets if packets[t] > 0]
    if order == "priority":
        pr = priorities or {}
        names.sort(key=lambda t: (-pr.get(t, 0), t))
        return tuple((t, i) for t in names for i in range(packets[t]))
    seq: list[tuple[str, int]] = []
    sent = {t: 0 for t in names}
    remaining = len(names)
    while remaining:
        for t in names:
            if sent[t] < packets[t]:
                seq.append((t, sent[t]))
                sent[t] += 1
                if sent[t] == packets[t]:
                    remaining -= 1
    return tuple(seq)


def ingress_shares(packets: Mapping[str, int], order: str = "round_robin",
                   ) -> dict[str, float]:
    """Each tenant's fraction of line-rate arrivals *during its window*.

    Round-robin is per-round fair, so a tenant's arrival share while it
    still has packets is not its global packet fraction: its last packet
    sits at global position ``Σ_j min(n_j, n_i)`` (every other tenant
    contributes at most one packet per round until round ``n_i``), so
    its window share is ``n_i / Σ_j min(n_j, n_i)``.  Strict priority
    gives each tenant the full line rate during its own drain window —
    share 1.0.  These are the shares the analytic prediction must use
    for the measured (per-window) throughput to be comparable.
    """
    if order == "priority":
        return {t: 1.0 for t in packets}
    ns = {t: max(0, n) for t, n in packets.items()}
    out = {}
    for t, n in ns.items():
        window = sum(min(m, n) for m in ns.values())
        out[t] = n / window if window else 0.0
    return out


@dataclasses.dataclass(frozen=True)
class TenantCounters:
    """Measured per-tenant accounting of one shared schedule."""

    tenant: str
    packets: int                # leaf-level ingress packets scheduled
    combines: int               # total combine ops across tree levels
    occupancy_cycles: float     # service work: packets · τ
    span_cycles: float          # first arrival → last completion
    throughput_pkts: float      # packets / span  [packets per cycle]


@dataclasses.dataclass(frozen=True)
class SharedSchedule:
    """The interleaved ingress plus its per-tenant measurements."""

    order: tuple[tuple[str, int], ...]
    counters: tuple[TenantCounters, ...]

    def tenant(self, name: str) -> TenantCounters:
        for c in self.counters:
            if c.tenant == name:
                return c
        raise KeyError(name)


def simulate_shared(loads: Sequence[TenantLoad], *,
                    order: str = "round_robin",
                    params: sm.SwitchParams = sm.SwitchParams(),
                    ) -> SharedSchedule:
    """Serve the interleaved leaf ingress through the partitioned switch.

    Arrivals: global packet ``j`` lands at ``j·δ`` (back-to-back line
    rate — the adversarial dense burst).  Service: tenant ``i``'s slice
    is a ``K_i``-server FCFS queue with deterministic service time
    ``τ_i``.  A tenant with 0 clusters (reclaimed by the greedy policy)
    must not appear with queued packets — that is the work-conserving
    invariant the partition layer guarantees.
    """
    packets = {l.tenant: l.leaf_packets for l in loads}
    taus = {l.tenant: service_tau(l.counters, params) * l.service_scale
            for l in loads}
    cores = {l.tenant: int(l.clusters) * params.cores_per_cluster
             for l in loads}
    seq = interleave(packets, order,
                     {l.tenant: l.priority for l in loads})
    for t, n in packets.items():
        if n > 0 and cores[t] < 1:
            raise ValueError(
                f"session {t!r} has {n} queued packets but no clusters — "
                "the partition is not work-conserving")

    busy: dict[str, list[float]] = {t: [] for t in packets}   # core frees
    first: dict[str, float] = {}
    last: dict[str, float] = {}
    for j, (t, _i) in enumerate(seq):
        arr = j * params.delta
        first.setdefault(t, arr)
        q = busy[t]
        if len(q) < cores[t]:
            start = arr
        else:
            start = max(arr, heapq.heappop(q))
        fin = start + taus[t]
        heapq.heappush(q, fin)
        last[t] = max(last.get(t, 0.0), fin)

    out = []
    for l in loads:
        t = l.tenant
        n = packets[t]
        span = (last[t] - first[t]) if n else 0.0
        span = max(span, taus.get(t, 1.0))       # ≥ one service time
        out.append(TenantCounters(
            tenant=t, packets=n, combines=l.combines,
            occupancy_cycles=n * taus[t],
            span_cycles=span,
            throughput_pkts=(n / span if n else 0.0)))
    return SharedSchedule(order=seq, counters=tuple(out))
