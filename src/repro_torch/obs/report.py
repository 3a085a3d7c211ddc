"""Structured manager reports and the telemetry summary CLI.

The port of ``repro/obs/report.py``.  Two halves:

* :class:`ManagerReport` / :class:`TenantReport`: the typed form of
  ``runtime.SessionManager.report()``.  They carry the partition, each
  session's scheduled and predicted throughput and the admission-control
  audit trail (admissions, evictions with reasons, replan outcomes);
  ``str(report)`` renders the manager's report string byte for byte as
  the reference does.

* ``python -m repro_torch.obs.report metrics.json [trace.json]``: a
  summary CLI over exported telemetry artifacts (the launcher's
  ``--metrics-out`` / ``--trace-out``): a per-tenant table (scheduled
  packets/combines, throughput, reliability counters), a per-slot
  congestion table and a histogram percentile table (p50/p95/p99),
  parsed from the DESIGN.md §16 metric name schema.  ``--incidents
  PATH`` renders a health-plane incident log (DESIGN.md §17) and
  ``--fail-on SEVERITY`` turns the CLI into a CI gate: exit 1 when any
  incident reaches that severity.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys


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


# ---------------------------------------------------------------------------
# The summary CLI over exported artifacts.
# ---------------------------------------------------------------------------

#: per-tenant columns: header → the ``tenant.<name>.<suffix>`` metric
#: suffix that fills it (gauges from the schedule publication, counters
#: from the reliability layer).
_TENANT_COLS = (("packets", "sched.packets"),
                ("combines", "sched.combines"),
                ("pkt/cy", "sched.throughput_pkts"),
                ("retrans", "retransmits"),
                ("retry_rounds", "retry_rounds"))


def _metric_value(rec) -> float:
    return rec["value"] if isinstance(rec, dict) else rec


def tenant_table(metrics: dict) -> str:
    """Per-tenant summary from a metrics snapshot (name-schema parse)."""
    tenants: dict[str, dict[str, float]] = {}
    for name, rec in metrics.items():
        if not name.startswith("tenant."):
            continue
        rest = name[len("tenant."):]
        for col, suffix in _TENANT_COLS:
            if rest.endswith("." + suffix):
                tenant = rest[: -len(suffix) - 1]
                tenants.setdefault(tenant, {})[col] = _metric_value(rec)
    if not tenants:
        return "no per-tenant metrics"
    cols = [c for c, _s in _TENANT_COLS]
    width = max(len("tenant"), *(len(t) for t in tenants))
    head = "tenant".ljust(width) + "".join(f"  {c:>12}" for c in cols)
    lines = [head]
    for t in sorted(tenants):
        row = t.ljust(width)
        for c in cols:
            v = tenants[t].get(c)
            if v is None:
                cell = "-"
            elif c == "pkt/cy":
                cell = f"{v:.4f}"
            else:
                cell = f"{v:.0f}"
            row += f"  {cell:>12}"
        lines.append(row)
    return "\n".join(lines)


def slot_table(metrics: dict) -> str:
    """Per-fabric-slot congestion summary (``congestion.<slot>.hotness``)."""
    slots = {}
    for name, rec in metrics.items():
        if name.startswith("congestion.") and name.endswith(".hotness"):
            slots[name[len("congestion."):-len(".hotness")]] = \
                _metric_value(rec)
    if not slots:
        return "no congestion metrics"
    width = max(len("slot"), *(len(s) for s in slots))
    lines = ["slot".ljust(width) + f"  {'hotness':>10}"]
    for s in sorted(slots):
        lines.append(s.ljust(width) + f"  {slots[s]:>10.4f}")
    return "\n".join(lines)


def histogram_table(metrics: dict) -> str:
    """Percentile summary of every registry Histogram in a snapshot
    (count, mean, p50/p95/p99 from the retained-sample record)."""
    hists = {n: r for n, r in metrics.items()
             if isinstance(r, dict) and r.get("type") == "histogram"}
    if not hists:
        return "no histograms"
    cols = ("count", "mean", "p50", "p95", "p99")
    width = max(len("histogram"), *(len(n) for n in hists))
    lines = ["histogram".ljust(width) + "".join(f"  {c:>10}" for c in cols)]
    for n in sorted(hists):
        rec = hists[n]
        count = rec.get("count", 0)
        mean = (rec.get("sum", 0.0) / count) if count else None
        row = n.ljust(width) + f"  {count:>10.0f}"
        for v in (mean, rec.get("p50"), rec.get("p95"), rec.get("p99")):
            cell = "-" if v is None else f"{v:.4f}"
            row += f"  {cell:>10}"
        lines.append(row)
    return "\n".join(lines)


def incident_table(incidents: list) -> str:
    """One line per incident from an exported incident log
    (``HealthMonitor.export_incidents`` / ``train.py --incidents-out``),
    with the evidence names that fired."""
    if not incidents:
        return "no incidents"
    lines = []
    for rec in incidents:
        who = f" tenant={rec['tenant']}" if rec.get("tenant") else ""
        ev = ", ".join(f"{k}={v:g}" for k, v in
                       sorted(rec.get("evidence", {}).items()))
        lines.append(f"[{rec['severity']}] {rec['detector']}{who}: "
                     f"{rec['summary']} (action: {rec['action']})"
                     + (f"\n    evidence: {ev}" if ev else ""))
    return "\n".join(lines)


def _load_metrics(path: str) -> dict:
    """A metrics snapshot from either artifact: the metrics JSON itself,
    or a trace JSON carrying the snapshot under its ``metrics`` key."""
    with open(path) as f:
        doc = json.load(f)
    if "traceEvents" in doc:
        return doc.get("metrics", {})
    return doc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Summarize exported telemetry artifacts "
                    "(launch/train.py --metrics-out/--trace-out).")
    ap.add_argument("metrics", nargs="?", default=None,
                    help="metrics JSON (or a trace JSON with an "
                         "embedded metrics snapshot)")
    ap.add_argument("trace", nargs="?", default=None,
                    help="optional trace JSON for the span tally")
    ap.add_argument("--incidents", default=None, metavar="PATH",
                    help="incident-log JSON (health plane, DESIGN.md "
                         "§17: train.py --incidents-out / "
                         "HealthMonitor.export_incidents) to render")
    ap.add_argument("--fail-on", default=None, metavar="SEVERITY",
                    choices=("info", "warning", "critical"),
                    help="exit nonzero if the incident log holds any "
                         "incident at or above SEVERITY — the CI-gate "
                         "mode (needs --incidents)")
    args = ap.parse_args(argv)
    if args.metrics is None and args.incidents is None:
        ap.error("nothing to report: pass a metrics JSON and/or "
                 "--incidents PATH")
    if args.fail_on and not args.incidents:
        ap.error("--fail-on gates an incident log; pass --incidents PATH")
    if args.metrics is not None:
        metrics = _load_metrics(args.metrics)
        print("== per-tenant ==")
        print(tenant_table(metrics))
        print()
        print("== per-slot congestion ==")
        print(slot_table(metrics))
        if any(isinstance(r, dict) and r.get("type") == "histogram"
               for r in metrics.values()):
            print()
            print("== histograms ==")
            print(histogram_table(metrics))
    if args.trace:
        with open(args.trace) as f:
            trace = json.load(f)
        events = trace.get("traceEvents", [])
        spans = sum(1 for e in events if e.get("ph") == "X")
        tracks = sum(1 for e in events if e.get("name") == "thread_name")
        print()
        print(f"== trace: {spans} spans on {tracks} tracks ==")
    if args.incidents:
        from repro_torch.obs.health import severity_rank
        with open(args.incidents) as f:
            incidents = json.load(f)
        if args.metrics is not None:
            print()
        print("== incidents ==")
        print(incident_table(incidents))
        if args.fail_on:
            floor = severity_rank(args.fail_on)
            worst = [rec for rec in incidents
                     if severity_rank(rec["severity"]) >= floor]
            if worst:
                print(f"FAIL: {len(worst)} incident(s) at or above "
                      f"{args.fail_on!r}", file=sys.stderr)
                return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
