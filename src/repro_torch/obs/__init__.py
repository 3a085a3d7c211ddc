"""Observability: the structured report of the multi-tenant switch.

Only the manager report is ported (``obs.report``); metrics, tracing,
timelines and the health plane are ROADMAP queue 1 item 13.
"""
from repro_torch.obs.report import (ManagerReport, TenantReport,  # noqa: F401
                                    render_manager_report)

__all__ = ["ManagerReport", "TenantReport", "render_manager_report"]
