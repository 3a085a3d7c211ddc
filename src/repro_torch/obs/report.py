"""The structured ``SessionManager`` report.

The port of the report half of ``repro/obs/report.py``:
:class:`ManagerReport` / :class:`TenantReport` are the typed form of
``runtime.SessionManager.report()``.  They carry the partition, each
session's scheduled and predicted throughput and the admission-control
audit trail (admissions, evictions with reasons, replan outcomes);
``str(report)`` renders the manager's report string byte for byte as
the reference does.  The summary CLI over exported telemetry waits for
the rest of the observability layer (ROADMAP queue 1 item 13).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TenantReport:
    """One session's line of the manager report, typed."""

    tenant: str
    mode: str
    num_buckets: int
    bucket_elems: int
    dtype: str
    clusters: int
    demand_bytes: int
    packets: int                # scheduled leaf ingress (incl. retransmits)
    combines: int
    measured_pkts: float        # FCFS-simulated throughput [pkts/cycle]
    predicted_pkts: float       # analytic shared-mode prediction
    bottleneck: str             # "compute" | "line"
    share: float                # ingress share under the interleave
    retransmits: int = 0


@dataclasses.dataclass(frozen=True)
class ManagerReport:
    """Partition/schedule/prediction summary of one shared switch,
    plus the admission-control audit trail."""

    clusters: int
    max_sessions: int
    policy: str
    order: str
    tenants: tuple[TenantReport, ...] = ()
    admissions: int = 0
    evictions: tuple[tuple[str, str], ...] = ()    # (tenant, reason)
    replans: tuple[tuple[bool, str], ...] = ()     # (replanned, reason)

    @property
    def sessions(self) -> int:
        return len(self.tenants)

    @property
    def replan_reasons(self) -> tuple[str, ...]:
        return tuple(r for _moved, r in self.replans)

    def __str__(self) -> str:
        return render_manager_report(self)


def render_manager_report(rep: ManagerReport) -> str:
    """The legacy ``SessionManager.report()`` string, byte-stable."""
    if not rep.tenants:
        return "switch idle: no sessions"
    lines = [f"switch: {rep.clusters} clusters, "
             f"{rep.sessions}/{rep.max_sessions} sessions, "
             f"policy={rep.policy}, order={rep.order}"]
    for t in rep.tenants:
        lines.append(
            f"  {t.tenant}: {t.mode} {t.num_buckets}x{t.bucket_elems} "
            f"{t.dtype} | clusters={t.clusters} "
            f"demand={t.demand_bytes}B | pkts={t.packets} "
            f"combines={t.combines} | measured={t.measured_pkts:.4f} "
            f"predicted={t.predicted_pkts:.4f} pkt/cy "
            f"({t.bottleneck}-bound)")
    return "\n".join(lines)
