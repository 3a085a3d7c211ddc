"""Multi-tenant switch runtime (DESIGN.md §13): the port of ``repro.runtime``.

Multiplexes N concurrent allreduce **sessions** — distinct tenants with
different shapes, dtypes and transport configs — over the shared
emulated switch (``repro_torch.switch``):

* ``sessions``  — :class:`Session` handles and the :class:`SessionManager`
  with the paper's §4 admission control (HPU clusters, static
  aggregation-buffer memory shares).
* ``partition`` — HPU-cluster partition policies (``static``,
  ``weighted_fair``, work-conserving ``greedy``).
* ``scheduler`` — the per-level ingress interleave (round-robin /
  priority), the shared-service simulation and per-tenant counters
  that cross-check ``perfmodel.switch_model.model_shared``.
* ``congestion`` — hotness maps over the fabric's physical switch
  slots, the signal half of the congestion replan
  (``SessionManager.replan``, DESIGN.md §15).

Tenants attach through the transport layer:
``transports.from_config(cfg, mesh, dtype, manager=mgr, tenant=...)``
(or ``GradReducer(cfg, mesh, manager=mgr)``) opens a session and runs
the data plane under the manager's contention-derived arrival
permutations.  Every session's fixed-tree result is bitwise its solo run
on an idle switch.
"""
from repro_torch.runtime.partition import (ClusterSlice, Partition, POLICIES,
                                           greedy_partition, make_partition,
                                           static_partition,
                                           weighted_fair_partition)
from repro_torch.runtime.scheduler import (ORDERS, SharedSchedule,
                                           TenantCounters, TenantLoad,
                                           ingress_shares, interleave,
                                           service_tau, simulate_shared)
from repro_torch.runtime.congestion import CongestionMap, CongestionMonitor
from repro_torch.runtime.sessions import (AdmissionError, ReplanResult,
                                          Session, SessionManager,
                                          session_demand_bytes)
from repro_torch.obs.report import ManagerReport, TenantReport  # noqa: F401

__all__ = [
    "AdmissionError", "ClusterSlice", "CongestionMap", "CongestionMonitor",
    "ManagerReport", "ORDERS", "POLICIES", "Partition", "ReplanResult",
    "Session", "SessionManager", "SharedSchedule", "TenantCounters",
    "TenantLoad", "TenantReport", "greedy_partition", "ingress_shares",
    "interleave", "make_partition", "service_tau", "session_demand_bytes",
    "simulate_shared", "static_partition", "weighted_fair_partition",
]
