"""Sessions and admission control for the multi-tenant switch runtime.

The port of ``repro/runtime/sessions.py``: plain Python over the port's
``switch.dataplane`` counters and ``perfmodel``.  Dtypes are named as
the reference names them (``"float32"``, ``"bfloat16"``, ``"int8"``:
``arena.dtype_name``), since the names enter the tenant names, the report
and the seeds of the arrival permutations.  The reference draws a
tenant's permutations once per trace; the port runs eagerly, so every
drawn ``(P, n)`` array is cached per seed, level and shape
(:func:`_perm_draw`).  A ``telemetry`` handle records the session
lifecycle, the static admission counters and the schedule gauges as the
reference does.

The paper's network manager (§4) statically partitions switch memory
across a predefined maximum number of concurrent allreduces and rejects
anything beyond it (→ host-based fallback).  ``SessionManager`` is that
control plane grown to a full runtime over the *emulated* switch
(``repro_torch.switch``): N concurrent allreduce **sessions** — distinct
tenants with their own shapes/dtypes/transport configs — multiplex one
switch, each admitted against

* **HPU clusters** — every active session needs at least one cluster of
  the ``SwitchParams`` capacity (the partition policy decides how many,
  ``runtime.partition``), and
* **aggregation-buffer memory** — the session's working set
  (``M`` buffers per in-flight block, ``switch_model.buffers_per_block``)
  must fit the §4 static memory share ``L1_total / max_sessions``.

Admitted sessions contend on the wire: the scheduler interleaves their
packet streams into one ingress sequence per tree level
(``runtime.scheduler``) and that contention reaches the *functional*
data plane as per-level arrival permutations (``arrival_perms`` →
``dataplane._apply_arrival``).  The correctness anchor: those
permutations are exactly the adversarial schedules the fixed-tree /
child-steered handlers are invariant to, so **every session's result is
bitwise identical to the same session run alone on an idle switch**.

The SPMD emulation cannot change wire topology mid-process, so after a
switch failure the *rebuilt* reduction tree
(``topology.rebuild_excluding_switch``) governs the control plane only:
``rebind`` drains every session and re-admits it with counters recomputed
on the new tree (fan-ins grow, demands grow, some sessions may no longer
fit → evicted to host-based fallback), mirroring the paper's recompute
path.  ``ft.coordinator.recover_switch_failure`` drives this.

``replan`` (DESIGN.md §15) generalizes that failure path into a
*performance* trigger: a congestion map over the fabric's physical
switch slots (``runtime.congestion``) picks the cheapest tree via
``topology.rebuild_avoiding``, and the sessions are drained and
re-admitted on it only when their predicted throughput improves by more
than the hysteresis margin — the Canary-style dynamic-tree loop.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import zlib
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import topology
from repro_torch.core.arena import dtype_name
from repro_torch.obs import report as obs_report
from repro_torch.perfmodel import switch_model as sm
from repro_torch.runtime import partition as pt
from repro_torch.runtime import scheduler as sc
from repro_torch.switch import dataplane


def torch_dtype(dtype) -> torch.dtype:
    """A ``torch.dtype`` from itself or its name (``arena.dtype_name``)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    out = getattr(torch, str(dtype), None)
    if not isinstance(out, torch.dtype):
        raise ValueError(f"unknown dtype {dtype!r}")
    return out


@functools.lru_cache(maxsize=64)
def _perm_draw(base: tuple, level: int, p: int, n: int) -> np.ndarray:
    """One level's ``(P, n)`` per-slot child permutations, drawn as the
    reference draws them (one ``rng.permutation(P)`` a packet slot) and
    cached: the key holds the manager's seed, epoch, tenant mix and
    tenant, so a rebind or a change of mix draws anew.  The arrays are
    shared between callers; never write to them."""
    rng = np.random.default_rng(base + (level,))
    return np.stack([rng.permutation(p) for _ in range(n)], axis=1)


class AdmissionError(RuntimeError):
    """The switch cannot admit this session — fall back to host wires."""


@dataclasses.dataclass(frozen=True)
class ReplanResult:
    """Outcome of one ``SessionManager.replan`` pass (DESIGN.md §15).

    ``replanned`` says whether the manager moved to a new tree;
    ``reason`` is the human-readable why ("below threshold", "no
    cheaper tree", "hysteresis", "replanned").  ``predicted_before`` /
    ``predicted_after`` are per-tenant predicted throughputs
    (pkts/cycle, analytic shared mode) under the observed congestion
    map on the old and candidate trees — what the hysteresis decision
    was made from, and what benchmarks gate on.
    """

    replanned: bool
    reason: str
    tree: topology.ReductionTree
    readmitted: tuple = ()
    evicted: tuple = ()
    predicted_before: dict = dataclasses.field(default_factory=dict)
    predicted_after: dict = dataclasses.field(default_factory=dict)

    @property
    def improvement_x(self) -> float:
        """Aggregate predicted-throughput ratio after/before (1.0 when
        nothing changed or nothing was predicted)."""
        b = sum(self.predicted_before.values())
        a = sum(self.predicted_after.values())
        return (a / b) if b > 0.0 else 1.0


@dataclasses.dataclass(frozen=True)
class Session:
    """One tenant's live allreduce session on the shared switch."""

    tenant: str
    mode: str                    # dense | int8 | sparse (handler family)
    num_buckets: int             # B of the tenant's (B, S) arena
    bucket_elems: int            # S
    dtype: str                   # arena dtype name
    weight: float = 1.0
    priority: int = 0
    reproducible: bool = False
    design: str = "auto"
    k: int | None = None         # sparse list capacity (top-k)
    counters: dataplane.SwitchCounters | None = None
    demand_bytes: int = 0
    #: lossy-fabric plan (``switch.packets.FaultPlan``) this session's
    #: transport runs under, and the static retransmission packets its
    #: per-level fault schedules add to the leaf ingress — extra service
    #: demand the shared scheduler must account (DESIGN.md §14).
    fault_plan: object = None
    retransmit_packets: int = 0

    @property
    def level_counts(self) -> tuple[tuple[int, int], ...]:
        """Per-tree-level ``(fanin, packets per child)`` shapes — the
        operating points ``switch_model.model_lossy`` prices and the
        timeline's lossy lane renders (one source, so the health
        plane's expectation and the modeled track can never disagree
        about the session's geometry)."""
        return tuple((lvl.fanin, lvl.ingress_packets // max(1, lvl.fanin))
                     for lvl in self.counters.levels)

    @property
    def spec(self) -> tuple:
        """The attach-matching key: everything the wire image and the
        admission decision depend on — ``k`` sizes the sparse lists,
        ``reproducible``/``design`` pick the aggregation design and
        hence the memory multiplier M, so a change in any of them is a
        *different* session that must re-run admission."""
        return (self.mode, self.num_buckets, self.bucket_elems, self.dtype,
                self.reproducible, self.design, self.k)


def session_demand_bytes(counters: dataplane.SwitchCounters) -> int:
    """Aggregation-buffer working memory one session pins on the switch.

    Every in-flight reduction block holds ``M`` aggregation buffers of
    one packet each (``switch_model.buffers_per_block`` — the working-
    memory multiplier of the §4.3 Little's-law equation); the busiest
    level bounds the session.
    """
    m = max(l.buffers_per_block for l in counters.levels)
    return int(math.ceil(m * counters.blocks)) * counters.packet_bytes


class SessionManager:
    """Admission, partitioning and scheduling for one shared switch.

    ``axis_names``/``axis_sizes`` are the mesh reduction axes
    (outermost-first) the emulated data plane runs on; the manager's
    reduction tree starts as their nested tree and is replaced wholesale
    by ``rebind`` after a switch failure.  ``policy`` picks the cluster
    partition (``runtime.partition.POLICIES``), ``order`` the ingress
    interleave (``runtime.scheduler.ORDERS``).
    """

    def __init__(self, axis_names: Sequence[str],
                 axis_sizes: Sequence[int], *,
                 params: sm.SwitchParams = sm.SwitchParams(),
                 policy: str = "weighted_fair",
                 order: str = "round_robin",
                 max_sessions: int = 8,
                 fmt=dataplane.DEFAULT_FORMAT,
                 seed: int = 0,
                 telemetry=None):
        if policy not in pt.POLICIES:
            raise ValueError(f"unknown partition policy {policy!r}")
        if order not in sc.ORDERS:
            raise ValueError(f"unknown schedule order {order!r}")
        if policy == "static" and params.clusters < max_sessions:
            # fail fast: otherwise admission would accept sessions whose
            # static share is 0 clusters and every later partition()/
            # report() would raise instead
            raise ValueError(
                f"static policy cannot split {params.clusters} clusters "
                f"into {max_sessions} shares; lower max_sessions")
        self.axis_names = tuple(axis_names)
        self.axis_sizes = tuple(int(s) for s in axis_sizes)
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"{len(self.axis_names)} axis names for "
                             f"{len(self.axis_sizes)} sizes")
        self.params = params
        self.policy = policy
        self.order = order
        self.max_sessions = int(max_sessions)
        self.fmt = fmt
        self.seed = int(seed)
        self.tree = topology.build_mesh_tree(self.axis_sizes)
        #: the *physical* fabric: switch slots per level, frozen at
        #: construction — rebind/replan rebuild the logical tree but the
        #: slots it binds to (and congestion maps over them) are fixed.
        self.fabric_pools = topology.slot_pools(self.tree)
        self._mesh_levels = topology.mesh_levels(self.axis_names,
                                                 self.axis_sizes)
        self._sessions: dict[str, Session] = {}
        self._epoch = 0           # bumped by rebind → fresh arrival perms
        self._next_tenant = 0
        #: audit log of forced closures: ``(tenant, reason)`` per evict.
        self.evictions: list[tuple[str, str]] = []
        #: audit log of replan passes: ``(replanned, reason)`` per call.
        self.replans: list[tuple[bool, str]] = []
        #: total successful admissions (``open``), monotone.
        self.admissions = 0
        #: ``obs.Telemetry``: session-lifecycle events, static admission
        #: counters and schedule gauges publish here (DESIGN.md §16).
        #: ``None`` = uninstrumented.
        self.telemetry = telemetry

    def new_tenant(self) -> str:
        """A fresh unique tenant name (``tenant0``, ``tenant1``, ...)
        for callers that don't name their own (e.g. ``GradReducer``
        without an explicit ``tenant=``)."""
        name = f"tenant{self._next_tenant}"
        self._next_tenant += 1
        return name

    # -- capacity ----------------------------------------------------------
    @property
    def num_levels(self) -> int:
        """Levels the data plane walks (mesh levels, not tree levels —
        the wire topology is fixed even after a control-plane rebind)."""
        return len(self._mesh_levels)

    @property
    def memory_budget_bytes(self) -> int:
        return self.params.l1_bytes_per_cluster * self.params.clusters

    @property
    def bytes_per_session(self) -> int:
        """§4: switch memory statically split across the predefined max."""
        return self.memory_budget_bytes // self.max_sessions

    # -- session lifecycle -------------------------------------------------
    def active(self) -> tuple[Session, ...]:
        return tuple(self._sessions.values())

    def session(self, tenant: str) -> Session:
        return self._sessions[tenant]

    def weights(self) -> dict[str, float]:
        return {s.tenant: s.weight for s in self._sessions.values()}

    def _counters(self, mode: str, num_buckets: int, bucket_elems: int,
                  dtype, design: str, reproducible: bool,
                  k: int | None, tree: topology.ReductionTree | None = None,
                  ) -> dataplane.SwitchCounters:
        """Static ingress counters on a tree (default: the current one),
        per wire image.

        The wire carries what the transport actually frames: the arena
        dtype for dense, int8 payloads (quant-block-padded) for the F1
        transport, and ``2k`` int32 words (idx + bitcast value) per
        bucket for the §7 coordinate lists at the leaf level.
        """
        if mode == "dense":
            wire_dtype, elems = torch_dtype(dtype), bucket_elems
        elif mode == "int8":
            from repro_torch.core.transports import QUANT_BLOCK
            pad = (-bucket_elems) % QUANT_BLOCK
            wire_dtype, elems = torch.int8, bucket_elems + pad
        elif mode == "sparse":
            k = max(1, bucket_elems // 100) if k is None else int(k)
            wire_dtype, elems = torch.int32, 2 * k
        else:
            raise ValueError(f"unknown session mode {mode!r}")
        return dataplane.tree_counters(self.tree if tree is None else tree,
                                       num_buckets, elems,
                                       wire_dtype, fmt=self.fmt,
                                       design=design,
                                       reproducible=reproducible)

    def _session_fault_schedules(self, mode: str, num_buckets: int,
                                 bucket_elems: int, dtype, k: int | None,
                                 fault_plan) -> list:
        """The session's per-level static ``FaultSchedule``s
        (``dataplane.fault_schedules`` on the same level shapes the
        transport pre-checks — the single source of truth, so the
        scheduler's modeled demand matches the plane's traced retry
        counters).  Empty when fault-free."""
        if fault_plan is None:
            return []
        if mode == "sparse" and k is None:
            k = max(1, bucket_elems // 100)      # same default as _counters
        fanins = [max(len(self.tree.nodes[n].children) for n in lvl)
                  for lvl in self.tree.levels[1:]]
        counts = dataplane.level_packet_counts(
            fanins, int(num_buckets), int(bucket_elems), torch_dtype(dtype),
            mode=mode, fmt=self.fmt, k_max=k)
        return dataplane.fault_schedules(fault_plan, counts)

    def open(self, tenant: str, *, mode: str, num_buckets: int,
             bucket_elems: int, dtype, weight: float = 1.0,
             priority: int = 0, reproducible: bool = False,
             design: str = "auto", k: int | None = None,
             fault_plan=None) -> Session:
        """Admit a session, or raise :class:`AdmissionError`.

        Admission is the paper's: a bounded session count (each active
        session needs ≥ 1 HPU cluster of the partition) and a static
        memory share the session's aggregation-buffer working set must
        fit.  The caller owning the rejected reduction falls back to
        host-based collectives — exactly the §4 path.
        """
        tenant = str(tenant)
        if tenant in self._sessions:
            raise ValueError(f"session {tenant!r} already open")
        if len(self._sessions) >= self.max_sessions:
            raise AdmissionError(
                f"switch at its predefined maximum of {self.max_sessions} "
                f"concurrent sessions; {tenant!r} must use host wires")
        if len(self._sessions) + 1 > self.params.clusters:
            raise AdmissionError(
                f"{self.params.clusters} HPU clusters cannot give "
                f"{len(self._sessions) + 1} sessions one each")
        name = dtype_name(dtype)
        counters = self._counters(mode, int(num_buckets), int(bucket_elems),
                                  dtype, design, reproducible, k)
        demand = session_demand_bytes(counters)
        if demand > self.bytes_per_session:
            raise AdmissionError(
                f"session {tenant!r} needs {demand} B of aggregation "
                f"buffers; the static share is {self.bytes_per_session} B "
                f"({self.memory_budget_bytes} B / {self.max_sessions})")
        schedules = self._session_fault_schedules(mode, int(num_buckets),
                                                  int(bucket_elems), dtype,
                                                  k, fault_plan)
        retransmits = sum(s.retransmits for s in schedules if s is not None)
        sess = Session(tenant=tenant, mode=mode, num_buckets=int(num_buckets),
                       bucket_elems=int(bucket_elems), dtype=name,
                       weight=float(weight), priority=int(priority),
                       reproducible=bool(reproducible), design=design,
                       k=k, counters=counters, demand_bytes=demand,
                       fault_plan=fault_plan,
                       retransmit_packets=retransmits)
        self._sessions[tenant] = sess
        self.admissions += 1
        if self.telemetry is not None:
            tm = self.telemetry
            tm.registry.counter("manager.admissions").inc()
            tm.registry.gauge(f"session.{tenant}.demand_bytes").set(demand)
            tm.record_switch_counters(tenant, counters)
            tm.record_fault_schedules(tenant, schedules)
            tm.tracer.instant("session.admit", track=f"session/{tenant}",
                              args={"mode": mode, "demand_bytes": demand,
                                    "retransmit_packets": retransmits})
        return sess

    def attach(self, tenant: str | None, *, mode: str, num_buckets: int,
               bucket_elems: int, dtype, reproducible: bool = False,
               design: str = "auto", k: int | None = None,
               weight: float = 1.0, priority: int = 0,
               axes: Sequence[str] | None = None,
               fault_plan=None) -> Session:
        """Open-or-reuse: the transports' trace-time entry point.

        A session whose spec (wire image + admission-relevant knobs)
        matches an open one is the same tenant re-tracing — return it.
        A changed spec is a re-admission: close and re-open (the new
        shape/design may no longer fit the static share).
        """
        if axes is not None and tuple(axes) != self.axis_names:
            raise ValueError(
                f"transport axes {tuple(axes)!r} do not match this "
                f"manager's switch ({self.axis_names!r})")
        if tenant is None:
            # anonymous sessions would silently collapse distinct jobs
            # with the same wire image into one tenant — the manager
            # would then model NO contention between them
            raise ValueError(
                "attaching to a shared switch needs a tenant name; pass "
                "tenant=... (GradReducer auto-names via new_tenant())")
        tenant = str(tenant)
        existing = self._sessions.get(tenant)
        spec = (mode, int(num_buckets), int(bucket_elems), dtype_name(dtype),
                bool(reproducible), design, k)
        if existing is not None:
            if existing.spec == spec and existing.fault_plan == fault_plan:
                return existing
            self.close(tenant)
        return self.open(tenant, mode=mode, num_buckets=num_buckets,
                         bucket_elems=bucket_elems, dtype=dtype,
                         weight=weight, priority=priority,
                         reproducible=reproducible, design=design, k=k,
                         fault_plan=fault_plan)

    def close(self, tenant: str) -> None:
        closed = self._sessions.pop(str(tenant), None)
        if closed is not None and self.telemetry is not None:
            self.telemetry.tracer.instant("session.close",
                                          track=f"session/{tenant}")

    def evict(self, tenant: str, *, reason: str = "evicted") -> bool:
        """Forcibly drain one session (session-scoped degradation,
        DESIGN.md §14): the tenant falls back to host-based collectives
        while every other session keeps the switch.  The eviction is
        logged — ``(tenant, reason)`` in arrival order — so the control
        plane (``ft.recover_session_failure``) and tests can audit *why*
        a tenant left.  Idempotent; returns whether a session closed."""
        tenant = str(tenant)
        if tenant not in self._sessions:
            return False
        del self._sessions[tenant]
        self.evictions.append((tenant, reason))
        if self.telemetry is not None:
            self.telemetry.registry.counter("manager.evictions").inc()
            self.telemetry.tracer.instant("session.evict",
                                          track=f"session/{tenant}",
                                          args={"reason": reason})
        return True

    def drain(self) -> tuple[str, ...]:
        """Close every session (host-based fallback for all of them)."""
        tenants = tuple(self._sessions)
        self._sessions.clear()
        return tenants

    # -- partition / schedule / prediction ---------------------------------
    def partition(self, queued: dict[str, int] | None = None,
                  ) -> pt.Partition:
        """The current cluster partition under the configured policy.

        ``queued`` (tenant → backlog) feeds the greedy policy's
        reclamation; ``None`` treats every session's full leaf ingress
        as queued — the steady-state view.
        """
        if queued is None:
            queued = {s.tenant: (s.counters.levels[0].ingress_packets
                                 + s.retransmit_packets)
                      for s in self._sessions.values()}
        return pt.make_partition(self.policy, self.weights(),
                                 self.params.clusters,
                                 max_sessions=self.max_sessions,
                                 queued=queued)

    def _loads(self, part: pt.Partition,
               queued: dict[str, int] | None = None,
               service_scale: float = 1.0) -> list[sc.TenantLoad]:
        return [sc.TenantLoad(tenant=s.tenant, counters=s.counters,
                              clusters=part.clusters(s.tenant),
                              priority=s.priority,
                              queued=(None if queued is None
                                      else queued.get(s.tenant, 0)),
                              retransmit_packets=s.retransmit_packets,
                              service_scale=float(service_scale))
                for s in self._sessions.values()]

    def schedule(self, queued: dict[str, int] | None = None, *,
                 service_scale: float = 1.0) -> sc.SharedSchedule:
        """Interleave + simulate the active sessions' leaf ingress.

        With a ``queued`` backlog snapshot, both the partition (greedy
        reclamation) and the simulated packet counts follow it — an
        idle tenant gets 0 clusters *and* 0 scheduled packets, which is
        exactly the work-conserving pairing.  ``service_scale`` slows
        every service time by the congestion factor (DESIGN.md §15) so
        the measured counters reflect a congested fabric.
        """
        sched = sc.simulate_shared(self._loads(self.partition(queued),
                                               queued, service_scale),
                                   order=self.order, params=self.params)
        if self.telemetry is not None:
            self.telemetry.record_shared_schedule(sched, self.params)
        return sched

    def predicted(self, *, service_scale: float = 1.0,
                  ) -> tuple[sm.TenantPoint, ...]:
        """The analytic shared-switch mode at the current partition."""
        part = self.partition()
        packets = {s.tenant: (s.counters.levels[0].ingress_packets
                              + s.retransmit_packets)
                   for s in self._sessions.values()}
        shares = sc.ingress_shares(packets, self.order)
        allocs = [(s.tenant, part.clusters(s.tenant),
                   sc.service_tau(s.counters, self.params)
                   * float(service_scale),
                   shares[s.tenant])
                  for s in self._sessions.values()]
        return sm.model_shared(allocs, self.params)

    # -- contention → the functional data plane ----------------------------
    def arrival_perms(self, tenant: str):
        """Per-level arrival permutations for one tenant, or ``None``.

        Alone on an idle switch there is nothing to contend with: packets
        arrive in canonical child order (``None`` — the data plane's
        unperturbed path), which is what makes the solo run the bitwise
        reference.  Under contention every level gets a deterministic
        per-packet-slot child permutation — seeded by (manager seed,
        rebind epoch, the set of contending sessions, tenant, level), so
        re-traces are stable but any change in the tenant mix re-rolls
        the adversarial schedule.  Returned as ``(P, n) -> ndarray``
        callables because the sparse plane's per-level packet counts are
        only known level by level (``dataplane._apply_arrival``).
        """
        tenant = str(tenant)
        if tenant not in self._sessions:
            raise KeyError(f"no session {tenant!r}")
        if len(self._sessions) < 2:
            return None
        mix = ",".join(
            f"{s.tenant}:{s.counters.levels[0].ingress_packets}"
            for s in sorted(self._sessions.values(), key=lambda s: s.tenant))
        base = (self.seed, self._epoch, zlib.crc32(mix.encode()),
                zlib.crc32(tenant.encode()))

        def perm_for(level):
            def f(p, n):
                return _perm_draw(base, level, int(p), int(n))
            return f

        return [perm_for(lvl) for lvl in range(self.num_levels)]

    # -- failure path ------------------------------------------------------
    def rebind(self, tree: topology.ReductionTree,
               ) -> tuple[tuple[str, ...], tuple[str, ...]]:
        """Drain and re-admit every session on a rebuilt reduction tree.

        The §4 failure path's runtime half: after
        ``rebuild_excluding_switch`` the surviving switches carry larger
        fan-ins, so every session's counters and memory demand are
        recomputed and re-admitted in open order.  Returns
        ``(readmitted, evicted)`` — evicted tenants no longer fit the
        rebuilt switch and fall back to host-based collectives.
        """
        self.tree = tree
        self._epoch += 1
        if self.telemetry is not None:
            self.telemetry.registry.counter("manager.rebinds").inc()
            self.telemetry.tracer.instant("manager.rebind", track="manager",
                                          args={"epoch": self._epoch})
        old = list(self._sessions.values())
        self._sessions.clear()
        readmitted, evicted = [], []
        for s in old:
            try:
                self.open(s.tenant, mode=s.mode, num_buckets=s.num_buckets,
                          bucket_elems=s.bucket_elems, dtype=s.dtype,
                          weight=s.weight, priority=s.priority,
                          reproducible=s.reproducible, design=s.design,
                          k=s.k, fault_plan=s.fault_plan)
                readmitted.append(s.tenant)
            except AdmissionError:
                evicted.append(s.tenant)
                self.evictions.append((s.tenant, "no longer fits rebuilt "
                                                 "tree"))
        return tuple(readmitted), tuple(evicted)

    # -- congestion-aware replanning (DESIGN.md §15) -----------------------
    def congestion_factor(self, hotness,
                          tree: topology.ReductionTree | None = None,
                          ) -> float:
        """The multiplicative slowdown a congestion map imposes on a
        tree's bottleneck: hot cost over cold cost on the physical
        fabric (``topology.tree_cost``).  1.0 = the map doesn't touch
        the tree's critical switch; ``inf`` = the tree is infeasible."""
        tree = self.tree if tree is None else tree
        cold = topology.tree_cost(tree, {}, self.fabric_pools)
        hot = topology.tree_cost(tree, hotness, self.fabric_pools)
        if not math.isfinite(hot) or cold <= 0.0:
            return math.inf
        return hot / cold

    def _predict_under(self, tree: topology.ReductionTree,
                       hotness) -> dict[str, float]:
        """Per-tenant predicted throughput (pkts/cycle) with counters
        recomputed on ``tree`` and τ scaled by its congestion factor."""
        factor = self.congestion_factor(hotness, tree)
        if not math.isfinite(factor):
            return {t: 0.0 for t in self._sessions}
        part = self.partition()
        counters = {
            s.tenant: self._counters(s.mode, s.num_buckets, s.bucket_elems,
                                     s.dtype, s.design, s.reproducible,
                                     s.k, tree=tree)
            for s in self._sessions.values()}
        packets = {s.tenant: (counters[s.tenant].levels[0].ingress_packets
                              + s.retransmit_packets)
                   for s in self._sessions.values()}
        shares = sc.ingress_shares(packets, self.order)
        allocs = [(s.tenant, part.clusters(s.tenant),
                   sc.service_tau(counters[s.tenant], self.params) * factor,
                   shares[s.tenant])
                  for s in self._sessions.values()]
        return {p.tenant: p.bandwidth_pkts
                for p in sm.model_shared(allocs, self.params)}

    def replan(self, monitor=None, *, hotness=None,
               threshold: float = 0.5,
               hysteresis: float = 0.05) -> "ReplanResult":
        """Congestion-triggered drain → rebuild → re-admit.

        The PR 5 failure path generalized to a *performance* trigger
        (Canary, DESIGN.md §15): when the congestion map's hottest slot
        reaches ``threshold``, pick the cheapest feasible tree under the
        map (``topology.rebuild_avoiding`` over the fixed physical
        fabric) and move the sessions onto it — but only those whose
        predicted throughput improves by more than the ``hysteresis``
        margin; the rest are evicted to host-based fallback rather than
        ping-ponged.  A successful replan lands on the cost argmin, so
        re-observing the same (static) map is a no-op — hysteresis makes
        oscillation impossible, property-tested.  Rebinding bumps the
        epoch: arrival permutations re-roll deterministically.

        Pass a ``runtime.congestion.CongestionMonitor`` (observed here),
        or a raw ``hotness`` map keyed by ``(level, index)`` fabric
        slots / node ids of the current tree.
        """
        res = self._replan(monitor, hotness=hotness, threshold=threshold,
                           hysteresis=hysteresis)
        self.replans.append((res.replanned, res.reason))
        if self.telemetry is not None:
            self.telemetry.registry.counter("manager.replans").inc()
            self.telemetry.tracer.instant(
                "manager.replan", track="manager",
                args={"replanned": res.replanned, "reason": res.reason,
                      "improvement_x": res.improvement_x})
        return res

    def _replan(self, monitor=None, *, hotness=None,
                threshold: float = 0.5,
                hysteresis: float = 0.05) -> "ReplanResult":
        if monitor is not None:
            hot = dict(monitor.observe().hotness)
        elif hotness is not None:
            hot = {}
            for key, v in dict(hotness).items():
                slot = (topology.switch_slot(self.tree, key)
                        if isinstance(key, int) else tuple(key))
                hot[slot] = max(hot.get(slot, 0.0), float(v))
        else:
            raise ValueError("replan needs a monitor= or a hotness= map")
        before = self._predict_under(self.tree, hot)
        peak = max(hot.values(), default=0.0)
        if peak < threshold:
            return ReplanResult(False, "below threshold", self.tree,
                                predicted_before=before,
                                predicted_after=before)
        cand = topology.rebuild_avoiding(self.tree, hot,
                                         pools=self.fabric_pools)
        # same node ids can carry different fan-in assignments, so
        # structural equality must compare the children maps, not just
        # the level shapes
        if cand is None or (cand.levels == self.tree.levels
                            and cand.nodes == self.tree.nodes):
            return ReplanResult(False, "no cheaper tree", self.tree,
                                predicted_before=before,
                                predicted_after=before)
        after = self._predict_under(cand, hot)
        improved = {t for t in before
                    if after.get(t, 0.0) > before[t] * (1.0 + hysteresis)}
        if self._sessions and not improved:
            return ReplanResult(False, "hysteresis", self.tree,
                                predicted_before=before,
                                predicted_after=after)
        dropped = tuple(sorted(set(before) - improved))
        for t in dropped:
            self.evict(t, reason="replan: no predicted improvement")
        readmitted, evicted = self.rebind(cand)
        return ReplanResult(True, "replanned", cand,
                            readmitted=readmitted,
                            evicted=dropped + evicted,
                            predicted_before=before,
                            predicted_after=after)

    # -- reporting ---------------------------------------------------------
    def report(self) -> obs_report.ManagerReport:
        """Structured partition/schedule/prediction summary.

        Returns an :class:`repro_torch.obs.ManagerReport`; ``str(report)``
        renders the exact legacy string, and the dataclass additionally
        carries the admission-control audit trail (admissions, evictions
        with reasons, replan outcomes) and per-tenant ingress shares.
        """
        audit = dict(admissions=self.admissions,
                     evictions=tuple(self.evictions),
                     replans=tuple(self.replans))
        if not self._sessions:
            return obs_report.ManagerReport(
                clusters=self.params.clusters,
                max_sessions=self.max_sessions,
                policy=self.policy, order=self.order, **audit)
        part = self.partition()
        sched = self.schedule()
        pred = {p.tenant: p for p in self.predicted()}
        packets = {s.tenant: (s.counters.levels[0].ingress_packets
                              + s.retransmit_packets)
                   for s in self._sessions.values()}
        shares = sc.ingress_shares(packets, self.order)
        tenants = []
        for s in self._sessions.values():
            c = sched.tenant(s.tenant)
            p = pred[s.tenant]
            tenants.append(obs_report.TenantReport(
                tenant=s.tenant, mode=s.mode, num_buckets=s.num_buckets,
                bucket_elems=s.bucket_elems, dtype=s.dtype,
                clusters=part.clusters(s.tenant),
                demand_bytes=s.demand_bytes, packets=c.packets,
                combines=c.combines, measured_pkts=c.throughput_pkts,
                predicted_pkts=p.bandwidth_pkts, bottleneck=p.bottleneck,
                share=shares[s.tenant],
                retransmits=s.retransmit_packets))
        return obs_report.ManagerReport(
            clusters=self.params.clusters, max_sessions=self.max_sessions,
            policy=self.policy, order=self.order, tenants=tuple(tenants),
            **audit)
