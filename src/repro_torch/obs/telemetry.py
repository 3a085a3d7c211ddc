"""The telemetry handle threaded through the engine and the runtime.

The port of ``repro/obs/telemetry.py``.  ``Telemetry`` bundles one
:class:`~repro_torch.obs.metrics.MetricsRegistry` and one
:class:`~repro_torch.obs.tracer.Tracer`: a single object that rides
``FlareConfig(telemetry=)`` (a ``compare=False`` field, so configs stay
hashable and equal with or without it) into ``GradReducer`` →
``transports`` → ``SwitchTransport`` → the data plane, and
``SessionManager(telemetry=)`` on the runtime side.

The reference records the data plane's static counters and phase spans
while ``jit`` traces a step, so once per compiled shape, not once per
step.  The port runs eagerly; a ``GradReducer`` records on its first
call for a given set of gradient shapes (its analogue of a trace) and
its ``attach`` pass records what the reference's registration trace
records, so the exports are the reference's.

The recording helpers here are the shared vocabulary: every integration
point (solo transports, admission control, schedule publication) writes
the same metric names for the same sources, which is what makes the
exported counters integer-equal to ``dataplane.plan_counters`` / static
``FaultSchedule`` / ``scheduler.TenantCounters``.
"""
from __future__ import annotations

import dataclasses

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.tracer import Tracer


def slot_name(level: int, index: int) -> str:
    """The metric-name token of a physical fabric slot: ``l<level>s<i>``
    (dots are hierarchy separators, so slots flatten into one token)."""
    return f"l{int(level)}s{int(index)}"


@dataclasses.dataclass
class Telemetry:
    """One registry + one tracer, created together and exported together."""

    registry: MetricsRegistry
    tracer: Tracer

    @classmethod
    def create(cls, *, clock=None, ring: int | None = None) -> "Telemetry":
        """A fresh telemetry handle.  ``clock`` injects the tracer's
        timebase (``obs.tracer.counting_clock()`` for byte-identical
        exports); ``ring`` bounds the tracer to a flight-recorder window
        of the last N events."""
        return cls(registry=MetricsRegistry(), tracer=Tracer(clock=clock,
                                                             ring=ring))

    # -- shared recording vocabulary ---------------------------------------
    def record_switch_counters(self, session: str, counters) -> None:
        """Static data-plane work (``dataplane.SwitchCounters``) under
        ``switch.<session>.*`` — written once per admission/trace, as
        counters, so the export stays integer-equal to
        ``plan_counters``/``tree_counters``."""
        reg = self.registry
        for i, lvl in enumerate(counters.levels):
            pre = f"switch.{session}.l{i + 1}"
            reg.counter(f"{pre}.ingress_packets").inc(lvl.ingress_packets)
            reg.counter(f"{pre}.egress_packets").inc(lvl.egress_packets)
            reg.counter(f"{pre}.combines").inc(lvl.combines)
        reg.counter(f"switch.{session}.blocks").inc(counters.blocks)
        reg.counter(f"switch.{session}.total_combines").inc(
            counters.total_combines)

    def record_fault_schedules(self, tenant: str, schedules) -> None:
        """The static reliability counters of one session's per-level
        ``FaultSchedule``s (``None`` entries = fault-free levels) under
        ``tenant.<name>.*`` — the same sums ``SessionManager.
        _retransmit_packets`` feeds the scheduler, so ``TenantLoad``
        demand and the export can never disagree."""
        scheds = [s for s in schedules if s is not None]
        if not scheds:
            return
        reg = self.registry
        reg.counter(f"tenant.{tenant}.retransmits").inc(
            sum(s.retransmits for s in scheds))
        reg.counter(f"tenant.{tenant}.retry_rounds").inc(
            sum(max(0, s.rounds - 1) for s in scheds))
        reg.counter(f"tenant.{tenant}.wait_rounds").inc(
            sum(int(round(s.wait_rounds)) for s in scheds))
        reg.counter(f"tenant.{tenant}.duplicates").inc(
            sum(s.duplicates for s in scheds))
        reg.counter(f"tenant.{tenant}.corrupt_rejected").inc(
            sum(s.corrupt_rejected for s in scheds))

    def record_fault_stats(self, tenant: str, stats: dict) -> None:
        """Traced retry counters pulled out of an executed program
        (``dataplane._new_fault_stats`` dict, post-``block_until_ready``)
        under ``plane.<tenant>.*`` — kept distinct from the static
        ``tenant.*`` mirror so the two sources stay cross-checkable."""
        self.registry.observe_tree(f"plane.{tenant}", stats)

    def record_shared_schedule(self, schedule, params) -> None:
        """Measured per-tenant accounting of one shared schedule, plus
        the aggregate occupancy/makespan gauges ``CongestionMonitor``
        consumes instead of re-deriving them (DESIGN.md §16)."""
        reg = self.registry
        occupancy = sum(c.occupancy_cycles for c in schedule.counters)
        makespan = max((c.span_cycles for c in schedule.counters),
                       default=0.0)
        cores = max(1, params.clusters * params.cores_per_cluster)
        reg.gauge("schedule.occupancy_cycles").set(occupancy)
        reg.gauge("schedule.makespan_cycles").set(makespan)
        reg.gauge("schedule.utilization").set(
            occupancy / (makespan * cores) if makespan > 0.0 else 0.0)
        for c in schedule.counters:
            pre = f"tenant.{c.tenant}.sched"
            reg.gauge(f"{pre}.packets").set(c.packets)
            reg.gauge(f"{pre}.combines").set(c.combines)
            reg.gauge(f"{pre}.occupancy_cycles").set(c.occupancy_cycles)
            reg.gauge(f"{pre}.span_cycles").set(c.span_cycles)
            reg.gauge(f"{pre}.throughput_pkts").set(c.throughput_pkts)

    def record_congestion(self, cmap) -> None:
        """Publish an observed ``CongestionMap`` as per-slot gauges
        (``congestion.l<level>s<index>.hotness``)."""
        for (lvl, idx) in sorted(cmap.hotness):
            self.registry.gauge(
                f"congestion.{slot_name(lvl, idx)}.hotness").set(
                    cmap.hotness[(lvl, idx)])

    # -- export ------------------------------------------------------------
    def trace_json(self) -> str:
        """Chrome-trace JSON with the metric snapshot embedded."""
        return self.tracer.to_json(metrics=self.registry.as_dict())

    def metrics_json(self) -> str:
        return self.registry.to_json()

    def export_trace(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.trace_json())

    def export_metrics(self, path: str) -> None:
        self.registry.write(path)
