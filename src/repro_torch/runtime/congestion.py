"""Congestion signals for the multi-tenant switch runtime (DESIGN.md §15).

The port of ``repro/runtime/congestion.py`` (plain Python).

The Canary extension of Flare's §4 network manager: reduction trees are
re-planned around *hot* switches, not just failed ones.  This module
owns the signal half of that feedback loop:

* :class:`CongestionMap` — per-switch-slot hotness (added load fraction
  on the ``(level, index)`` slots of the physical fabric,
  ``topology.switch_slot``).  ``0`` = idle, ``inf`` = unusable (a failed
  switch — failure is the limiting case of congestion).
* :class:`CongestionMonitor` — derives a map from what the runtime can
  actually see: the measured utilization of the shared schedule's
  occupancy/span counters (``runtime.scheduler``), plus injectable
  background traffic — either per-slot (``inject``) or per link class
  (``inject_flow``, the ``perfmodel.network_sim.BackgroundFlow`` terms,
  host↔leaf flows heating leaf slots and leaf↔spine flows the upper
  levels).

Every contribution is additive and non-negative, so hotness is monotone
in background traffic (property-tested) and a static load yields a
static map — which is what makes the replan policy's hysteresis a
no-oscillation guarantee (``SessionManager.replan``).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

from repro_torch.perfmodel import network_sim as ns

Slot = tuple[int, int]


@dataclasses.dataclass(frozen=True)
class CongestionMap:
    """Hotness per physical switch slot, ``(level, index)`` → load ≥ 0."""

    hotness: Mapping[Slot, float]

    def of(self, slot: Slot) -> float:
        return float(self.hotness.get(tuple(slot), 0.0))

    def peak(self) -> float:
        """The hottest slot's load — what the replan threshold gates on."""
        return max(self.hotness.values(), default=0.0)

    def hottest(self) -> Slot | None:
        if not self.hotness:
            return None
        return max(self.hotness, key=lambda s: self.hotness[s])


class CongestionMonitor:
    """Derives the congestion map one ``SessionManager``'s fabric sees.

    Measured signal: the shared schedule's per-tenant occupancy/span
    counters give the switch's utilization (busy core-cycles over the
    makespan, normalized by the core count) — every slot of the fabric
    sees it, since all admitted traffic traverses all levels.  Injected
    signal: per-slot hotness (``inject``) and per-link-class background
    flows (``inject_flow``) localize the heat, which is what gives the
    replan policy a *direction* to route around.
    """

    def __init__(self, manager, *, net: ns.FatTree = ns.FatTree(),
                 registry=None):
        self.manager = manager
        self.net = net
        #: optional ``obs.MetricsRegistry``: when set, the measured
        #: utilization is read from the ``schedule.*`` gauges the
        #: manager's telemetry publishes on every ``schedule()`` call
        #: instead of re-simulating the FCFS schedule here (same
        #: counters, same formula, identical maps).
        self.registry = registry
        self._injected: dict[Slot, float] = {}
        self._flows: list[ns.BackgroundFlow] = []
        #: peak hotness of each successive ``observe()``; append-only
        self.history: list[float] = []

    # -- injection ---------------------------------------------------------
    def inject(self, slot: Slot, hotness: float) -> None:
        """Add ``hotness`` load to one physical slot (accumulates)."""
        if hotness < 0:
            raise ValueError(f"hotness must be >= 0, got {hotness}")
        slot = (int(slot[0]), int(slot[1]))
        self._injected[slot] = self._injected.get(slot, 0.0) + float(hotness)

    def inject_flow(self, flow: ns.BackgroundFlow) -> None:
        """Add background cross traffic on one link class: ``host_leaf``
        heats every leaf slot (level 1), ``leaf_spine`` every upper
        level, by the flow's load fraction of the line rate."""
        self._flows.append(flow)

    def clear(self) -> None:
        self._injected.clear()
        self._flows.clear()

    # -- observation -------------------------------------------------------
    def _measured_utilization(self, schedule) -> float:
        """Busy core-cycles per makespan cycle per core, from the shared
        schedule's occupancy/span counters, or, with a ``registry``
        attached, from the ``schedule.*`` gauges the manager's telemetry
        publishes (same counters, so the maps are identical)."""
        if schedule is None and self.registry is not None \
                and "schedule.makespan_cycles" in self.registry:
            occupancy = self.registry.value("schedule.occupancy_cycles", 0.0)
            makespan = self.registry.value("schedule.makespan_cycles", 0.0)
        else:
            if schedule is None:
                if not self.manager.active():
                    return 0.0
                schedule = self.manager.schedule()
            occupancy = sum(c.occupancy_cycles for c in schedule.counters)
            makespan = max((c.span_cycles for c in schedule.counters),
                           default=0.0)
        if makespan <= 0.0:
            return 0.0
        params = self.manager.params
        cores = max(1, params.clusters * params.cores_per_cluster)
        return occupancy / (makespan * cores)

    def observe(self, schedule=None) -> CongestionMap:
        """The current map over the manager's *physical* fabric slots
        (``fabric_pools`` — fixed across rebinds, so maps stay
        comparable before and after a replan)."""
        util = self._measured_utilization(schedule)
        frac = {k: 0.0 for k in ns.LINK_CLASSES}
        for f in self._flows:
            frac[f.link] += f.bytes_per_us / self.net.link_bytes_per_us
        hot: dict[Slot, float] = {}
        for lvl, width in self.manager.fabric_pools.items():
            link = "host_leaf" if lvl == 1 else "leaf_spine"
            for i in range(width):
                hot[(lvl, i)] = (util + frac[link]
                                 + self._injected.get((lvl, i), 0.0))
        cmap = CongestionMap(hot)
        self.history.append(cmap.peak())
        telemetry = getattr(self.manager, "telemetry", None)
        if telemetry is not None:
            telemetry.record_congestion(cmap)
        return cmap
