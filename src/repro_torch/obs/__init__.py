"""Observability for the switch fabric: metrics, tracing, timelines and
the manager report.

The flight-recorder layer of DESIGN.md §16, ported from ``repro.obs``.
One :class:`~repro_torch.obs.telemetry.Telemetry` handle (a typed
:class:`~repro_torch.obs.metrics.MetricsRegistry` plus a structured
:class:`~repro_torch.obs.tracer.Tracer`) threads through
``FlareConfig(telemetry=)`` and ``SessionManager(telemetry=)``; the
modeled timeline renderer (``repro_torch.obs.timeline``) lays scheduler
and perfmodel predictions alongside the measured spans in one
Chrome-trace export, and ``python -m repro_torch.obs.report`` summarizes
the artifacts.

The health plane of DESIGN.md §17 (``HealthMonitor``, ``Incident``, the
SLO policy) is ROADMAP queue 1 item 13; only its severity scale is here,
for the report CLI's ``--fail-on``.
"""
from repro_torch.obs.health import SEVERITIES, severity_rank  # noqa: F401
from repro_torch.obs.metrics import (Counter, Gauge,             # noqa: F401
                                     Histogram, MetricsRegistry)
from repro_torch.obs.report import (ManagerReport, TenantReport,  # noqa: F401
                                    render_manager_report)
from repro_torch.obs.telemetry import Telemetry, slot_name      # noqa: F401
from repro_torch.obs.tracer import Tracer, counting_clock       # noqa: F401

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "ManagerReport", "TenantReport", "render_manager_report",
           "Telemetry", "Tracer", "counting_clock", "slot_name",
           "SEVERITIES", "severity_rank"]
