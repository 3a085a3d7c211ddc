"""Observability for the switch fabric: metrics, tracing, timelines, the
manager report and the health plane.

The flight-recorder layer of DESIGN.md §16, ported from ``repro.obs``.
One :class:`~repro_torch.obs.telemetry.Telemetry` handle (a typed
:class:`~repro_torch.obs.metrics.MetricsRegistry` plus a structured
:class:`~repro_torch.obs.tracer.Tracer`) threads through
``FlareConfig(telemetry=)`` and ``SessionManager(telemetry=)``; the
modeled timeline renderer (``repro_torch.obs.timeline``) lays scheduler
and perfmodel predictions alongside the measured spans in one
Chrome-trace export, and ``python -m repro_torch.obs.report`` summarizes
the artifacts.

DESIGN.md §17 closes the loop on top: a :class:`HealthMonitor`
(``repro_torch.obs.health``) streams typed detectors over the recorder's
exports and static counters, emitting structured :class:`Incident`
records, and an :class:`SLOPolicy` (``repro_torch.obs.slo``) binds them
to the runtime's existing remediation paths.
"""
from repro_torch.obs.health import (HealthMonitor, Incident,   # noqa: F401
                                    SEVERITIES, severity_rank)
from repro_torch.obs.metrics import (Counter, Gauge,             # noqa: F401
                                     Histogram, MetricsRegistry)
from repro_torch.obs.report import (ManagerReport, TenantReport,  # noqa: F401
                                    render_manager_report)
from repro_torch.obs.slo import Remediation, SLOPolicy, SLORule  # noqa: F401
from repro_torch.obs.telemetry import Telemetry, slot_name      # noqa: F401
from repro_torch.obs.tracer import Tracer, counting_clock       # noqa: F401

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "ManagerReport", "TenantReport", "render_manager_report",
           "Telemetry", "Tracer", "counting_clock", "slot_name",
           "HealthMonitor", "Incident", "SEVERITIES", "severity_rank",
           "Remediation", "SLOPolicy", "SLORule"]
