"""Modeled timeline renderer: analytic predictions as trace tracks.

The port of ``repro/obs/timeline.py``.  The port has three prediction
surfaces: the runtime scheduler's FCFS simulation
(``scheduler.simulate_shared``), the analytic shared-switch model
(``switch_model.model_shared``), and the lossy-fabric expectation
(``switch_model.model_lossy``).  Each renders here into Chrome-trace
complete events on the ``"modeled"`` process, laid alongside the
measured (``"measured"``) and trace-time (``"trace"``) spans in the
same export, so modeled-vs-measured drift is visible per phase in the
Perfetto timeline, not collapsed into one scalar ratio.

Timebase: the simulator and the model speak switch cycles; events land
in trace microseconds via ``SwitchParams.clock_hz`` (1 GHz → 1 cycle =
1e-3 µs).  The lossy tracks speak modeled retry *rounds* and keep their
own lane.
"""
from __future__ import annotations

from repro_torch.perfmodel import switch_model as sm


def _cycles_to_us(params) -> float:
    return 1e6 / float(params.clock_hz)


def fcfs_tracks(tracer, schedule, *,
                params: sm.SwitchParams = sm.SwitchParams(),
                at_us: float = 0.0) -> int:
    """One span per tenant from the FCFS simulation's measured window.

    ``schedule`` is a ``scheduler.SharedSchedule``: each tenant's span
    starts at its first packet's line-rate arrival (global index · δ)
    and lasts its measured ``span_cycles``; the per-tenant counters ride
    as args.  Returns the number of events emitted.
    """
    scale = _cycles_to_us(params)
    first = {}
    for j, (t, _i) in enumerate(schedule.order):
        first.setdefault(t, j * params.delta)
    n = 0
    for c in schedule.counters:
        tracer.span_at(
            "fcfs.window", at_us + first.get(c.tenant, 0.0) * scale,
            c.span_cycles * scale,
            track=f"fcfs/{c.tenant}", process="modeled",
            args={"packets": c.packets, "combines": c.combines,
                  "occupancy_cycles": c.occupancy_cycles,
                  "throughput_pkts": c.throughput_pkts})
        n += 1
    return n


def model_tracks(tracer, points, packets, *,
                 params: sm.SwitchParams = sm.SwitchParams(),
                 at_us: float = 0.0) -> int:
    """One span per tenant from the analytic shared-switch prediction.

    ``points`` are ``switch_model.TenantPoint``s, ``packets`` the
    per-tenant leaf ingress (``TenantLoad.leaf_packets``-style counts).
    Each span's duration is the predicted drain time
    ``packets / bandwidth_pkts`` — directly comparable to the FCFS
    track above it and to any measured span around the same reduction.
    """
    scale = _cycles_to_us(params)
    n = 0
    for p in points:
        pkts = int(packets.get(p.tenant, 0))
        dur = (pkts / p.bandwidth_pkts) if p.bandwidth_pkts > 0 else 0.0
        tracer.span_at(
            "model.drain", at_us, dur * scale,
            track=f"model/{p.tenant}", process="modeled",
            args={"packets": pkts, "tau": p.tau,
                  "clusters": p.clusters,
                  "ingress_share": p.ingress_share,
                  "bandwidth_pkts": p.bandwidth_pkts,
                  "bottleneck": p.bottleneck})
        n += 1
    return n


def lossy_tracks(tracer, tenant, plan, counts, *, at_round: float = 0.0,
                 ) -> int:
    """Per-level expected retry cost of one session's fault plan.

    ``counts`` are the plane's ``(fanin, packets per child)`` level
    shapes (``dataplane.level_packet_counts``); each level the plan
    applies to gets a span of ``retry_rounds + wait_rounds`` modeled
    rounds with the ``model_lossy`` expectation as args.  The lane
    speaks rounds, not cycles — it sits in its own track.
    """
    if plan is None:
        return 0
    n = 0
    for i, (p, npkt) in enumerate(counts):
        if not plan.applies(i):
            continue
        lp = sm.model_lossy(plan.drop, plan.corrupt, p * npkt,
                            max_retries=plan.retry.max_retries,
                            timeout_rounds=plan.retry.timeout_rounds,
                            backoff=plan.retry.backoff)
        tracer.span_at(
            f"lossy.l{i + 1}", at_round, lp.retry_rounds + lp.wait_rounds,
            track=f"lossy/{tenant}", process="modeled",
            args={"q": lp.q, "retransmits": lp.retransmits,
                  "retry_rounds": lp.retry_rounds,
                  "wait_rounds": lp.wait_rounds,
                  "survival": lp.survival})
        n += 1
    return n


def manager_tracks(tracer, manager, *, at_us: float = 0.0) -> int:
    """Render one ``runtime.SessionManager``'s full modeled timeline:
    the FCFS window per tenant, the analytic drain prediction per
    tenant, and each lossy session's expected retry cost.  The one-call
    surface ``launch/train.py --trace-out`` uses after a run."""
    if not manager.active():
        return 0
    n = fcfs_tracks(tracer, manager.schedule(), params=manager.params,
                    at_us=at_us)
    packets = {s.tenant: (s.counters.levels[0].ingress_packets
                          + s.retransmit_packets)
               for s in manager.active()}
    n += model_tracks(tracer, manager.predicted(), packets,
                      params=manager.params, at_us=at_us)
    for s in manager.active():
        if s.fault_plan is None:
            continue
        n += lossy_tracks(tracer, s.tenant, s.fault_plan, s.level_counts)
    return n
