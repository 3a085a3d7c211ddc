"""The fabric health plane: streaming anomaly detectors over the
flight recorder (DESIGN.md §17).

The port of ``repro/obs/health.py``.  The flight recorder
(:class:`~repro_torch.obs.metrics.MetricsRegistry`, the structured
:class:`~repro_torch.obs.tracer.Tracer`, the modeled timeline) makes
every runtime signal visible; this module reads it.  It closes the
telemetry → diagnosis half of the loop (``repro_torch.obs.slo`` closes
diagnosis → action):

* :class:`Incident` — one structured finding: which detector fired, a
  severity, the **evidence** (the exact metric names + values the
  decision was made from — counter-exact, so an incident is auditable
  against the export it was raised from), and a recommended action.
* Four typed detectors, each reading only *exported or static* state
  (registry counters/gauges, recorded tracer events, the analytic
  perfmodel) — never a tensor.  Detection is host-side arithmetic over
  a few hundred names; the registry holds host numbers only (it refuses
  a tensor that is not on the CPU), so a poll never syncs the card.
* :class:`HealthMonitor` — owns the detector set and the incident log.
  ``poll()`` runs every detector once; ``watch()`` is the deterministic
  poll loop (optionally applying an ``slo.SLOPolicy`` after each poll).
  Clocks are injectable: pass ``clock=obs.counting_clock()`` and two
  identical runs export **byte-identical** incident logs, the
  reference's bytes.

Detector inputs, by source:

========================  =================================================
detector                  reads
========================  =================================================
``StragglerDetector``     measured ``train.step`` span dispersion per
                          track (median rule shared with
                          ``ft.coordinator.straggler_report``), plus the
                          ``ft.<host>.*`` counters a registry-attached
                          ``Coordinator`` publishes
``FaultStormDetector``    ``tenant.<t>.{retransmits,retry_rounds,
                          corrupt_rejected,...}`` (static ``FaultSchedule``
                          mirrors) vs the ``model_lossy`` expectation at
                          the session's own level shapes
``CongestionDriftDetector``  ``congestion.l<l>s<i>.hotness`` gauges (or a
                          live ``CongestionMonitor``), trending against
                          the replan threshold/hysteresis
``ModelDivergenceDetector``  the ``fcfs/<t>`` vs ``model/<t>`` spans the
                          timeline renderer lays side-by-side
========================  =================================================
"""
from __future__ import annotations

import dataclasses
import json
import math
import time

from repro_torch.perfmodel import switch_model as sm

#: Severity scale, least to most severe.
SEVERITIES = ("info", "warning", "critical")


def severity_rank(severity: str) -> int:
    """Position on the severity scale; unknown severities are an error
    (a typo'd SLO rule must fail loudly, not silently never match)."""
    try:
        return SEVERITIES.index(severity)
    except ValueError:
        raise ValueError(f"unknown severity {severity!r}; one of "
                         f"{SEVERITIES}") from None


@dataclasses.dataclass(frozen=True)
class Incident:
    """One structured finding of the health plane.

    ``evidence`` is the audit trail: the exact ``(metric name, value)``
    pairs the detector decided from, so every incident can be verified
    against the registry/trace export it was raised over ("counter-
    exact": it equals the static ``FaultSchedule`` sums as integers).
    ``action`` is a recommendation the
    :class:`~repro_torch.obs.slo.SLOPolicy` may bind to a remediation path
    (``"none"`` | ``"replan"`` | ``"recover_session"`` |
    ``"recover_switch"`` | ``"remesh"``).
    """

    detector: str
    severity: str
    summary: str
    action: str = "none"
    tenant: str | None = None
    evidence: tuple[tuple[str, float], ...] = ()
    ts: float = 0.0

    def __post_init__(self):
        severity_rank(self.severity)            # validate eagerly

    def as_dict(self) -> dict:
        """JSON-ready record (evidence as a sorted mapping — the
        byte-stable export shape)."""
        return {"detector": self.detector, "severity": self.severity,
                "summary": self.summary, "action": self.action,
                "tenant": self.tenant,
                "evidence": {k: v for k, v in sorted(self.evidence)},
                "ts": self.ts}


def incidents_json(incidents) -> str:
    """Deterministic incident-log JSON: sorted keys, stable order (the
    log is append-only, so recording order is reproducible whenever the
    poll sequence is)."""
    return json.dumps([i.as_dict() for i in incidents], indent=1,
                      sort_keys=True) + "\n"


def render_incidents(incidents) -> str:
    """Human summary, one line per incident (the ``--incidents`` CLI
    table renders from the JSON shape; this renders live objects)."""
    if not incidents:
        return "health: no incidents"
    lines = []
    for i in incidents:
        who = f" tenant={i.tenant}" if i.tenant else ""
        lines.append(f"[{i.severity}] {i.detector}{who}: {i.summary} "
                     f"(action: {i.action})")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Detectors.  Uniform surface: detect(registry, tracer, now=) -> [Incident].
# ---------------------------------------------------------------------------

class StragglerDetector:
    """Per-tenant step-span dispersion vs the Coordinator's median rule.

    Two signal paths, both host-side:

    * **span dispersion** — measured spans named ``span`` (default
      ``train.step``) are grouped by track; a track whose mean duration
      exceeds ``factor`` × the median of all track means is a straggler.
      The median rule is exactly ``ft.coordinator.straggler_report``
      (imported, not re-derived), so the in-step mitigation and the
      health plane can never disagree on who is slow.
    * **host liveness** — with a ``coordinator`` attached, hosts in its
      ``failed`` set raise critical incidents, and nonzero
      ``ft.host<h>.{missed,stragglers}`` counters (the registry mirror a
      ``Coordinator(registry=)`` publishes) ride as evidence.
    """

    name = "straggler"

    def __init__(self, coordinator=None, *, factor: float = 2.0,
                 span: str = "train.step"):
        self.coordinator = coordinator
        self.factor = float(factor)
        self.span = str(span)

    def detect(self, registry, tracer, *, now: float = 0.0):
        from repro_torch.ft.coordinator import straggler_report
        incidents = []
        durs: dict[str, list[float]] = {}
        for ev in tracer.events:
            if ev["ph"] == "X" and ev["process"] == "measured" \
                    and ev["name"] == self.span:
                durs.setdefault(ev["track"], []).append(ev["dur"])
        means = {t: sum(d) / len(d) for t, d in sorted(durs.items())}
        for track in straggler_report(means, factor=self.factor):
            ordered = sorted(means.values())
            median = ordered[len(ordered) // 2]
            incidents.append(Incident(
                detector=self.name, severity="warning",
                summary=f"track {track!r} mean step span "
                        f"{means[track]:.3f} > {self.factor:g}x median "
                        f"{median:.3f}",
                action="remesh", tenant=track.rpartition("/")[2],
                evidence=((f"trace.{track}.mean_dur", means[track]),
                          ("trace.median_dur", median)),
                ts=now))
        if self.coordinator is not None:
            for h in sorted(self.coordinator.failed):
                ev = [(f"ft.host{h}.missed",
                       float(registry.value(f"ft.host{h}.missed", 0)))]
                hb = registry.value(f"ft.host{h}.heartbeats")
                if hb is not None:
                    ev.append((f"ft.host{h}.heartbeats", float(hb)))
                incidents.append(Incident(
                    detector=self.name, severity="critical",
                    summary=f"host {h} missed its heartbeat timeout "
                            f"({self.coordinator.timeout:g}s)",
                    action="remesh", tenant=f"host{h}",
                    evidence=tuple(ev), ts=now))
        return incidents


class FaultStormDetector:
    """Reliability-counter rates vs the ``model_lossy`` expectation.

    The registry's ``tenant.<t>.*`` counters are the static
    ``FaultSchedule`` mirrors (integer-equal to what the data plane
    pre-checks, DESIGN.md §16) — a nonzero rate is a *fault storm in
    progress*.  With a ``manager`` attached the detector prices the
    storm against ``switch_model.model_lossy`` at the session's own
    level shapes (``Session.level_counts``, the same counts the
    timeline's lossy lane renders): a measured retransmit total beyond
    ``(1 + tolerance)`` × the modeled expectation — or a modeled
    survival below ``min_survival`` — escalates to critical with a
    ``recover_session`` recommendation (the degradation to the wire).
    Evidence is counter-exact: the registry values, verbatim.
    """

    name = "fault_storm"

    def __init__(self, manager=None, *, tolerance: float = 0.5,
                 min_survival: float = 0.5):
        self.manager = manager
        self.tolerance = float(tolerance)
        self.min_survival = float(min_survival)

    def _expectation(self, tenant: str):
        """(expected retransmits, survival) from ``model_lossy`` over
        the session's applicable levels, or ``(None, None)`` when the
        session (or its plan) is invisible to this detector."""
        if self.manager is None:
            return None, None
        sess = {s.tenant: s for s in self.manager.active()}.get(tenant)
        if sess is None or sess.fault_plan is None:
            return None, None
        plan = sess.fault_plan
        exp, surv = 0.0, 1.0
        for i, (p, npkt) in enumerate(sess.level_counts):
            if not plan.applies(i):
                continue
            lp = sm.model_lossy(plan.drop, plan.corrupt, p * npkt,
                                max_retries=plan.retry.max_retries,
                                timeout_rounds=plan.retry.timeout_rounds,
                                backoff=plan.retry.backoff)
            exp += lp.retransmits
            surv *= lp.survival
        return exp, surv

    def detect(self, registry, tracer, *, now: float = 0.0):
        incidents = []
        for name in registry.names("tenant."):
            if not name.endswith(".retransmits"):
                continue
            tenant = name[len("tenant."):-len(".retransmits")]
            evidence = []
            for suffix in ("retransmits", "retry_rounds", "wait_rounds",
                           "duplicates", "corrupt_rejected"):
                v = registry.value(f"tenant.{tenant}.{suffix}")
                if v is not None:
                    evidence.append((f"tenant.{tenant}.{suffix}", float(v)))
            measured = registry.value(name, 0)
            corrupt = registry.value(f"tenant.{tenant}.corrupt_rejected", 0)
            if measured <= 0 and corrupt <= 0:
                continue
            expected, survival = self._expectation(tenant)
            severity, action = "warning", "none"
            if expected is None:
                summary = (f"{measured:.0f} retransmits scheduled "
                           f"(no session model attached)")
            else:
                evidence.append(("model.lossy.expected_retransmits",
                                 expected))
                evidence.append(("model.lossy.survival", survival))
                storm = measured > expected * (1.0 + self.tolerance)
                dying = survival < self.min_survival
                if storm or dying:
                    severity, action = "critical", "recover_session"
                    why = ("beyond the model_lossy expectation"
                           if storm else
                           f"modeled survival {survival:.3f} < "
                           f"{self.min_survival:g}")
                    summary = (f"{measured:.0f} retransmits, {why} "
                               f"(expected {expected:.1f})")
                else:
                    summary = (f"{measured:.0f} retransmits within "
                               f"{1 + self.tolerance:g}x the model_lossy "
                               f"expectation ({expected:.1f})")
            incidents.append(Incident(
                detector=self.name, severity=severity, summary=summary,
                action=action, tenant=tenant,
                evidence=tuple(evidence), ts=now))
        return incidents


class CongestionDriftDetector:
    """Schedule-gauge hotness trending against the replan hysteresis.

    Reads the ``congestion.*.hotness`` gauges (published by every
    ``CongestionMonitor.observe``); with a live ``monitor`` attached it
    triggers a fresh observation first, so the gauges are current.  A
    peak at or above ``threshold`` raises an incident recommending
    ``replan`` — with the *same* threshold/hysteresis defaults as
    ``SessionManager.replan``, so the recommendation and the remediation
    gate on the same number.  Re-fires only when the peak has risen by
    more than the hysteresis margin since the last firing (a static map
    raises exactly one incident per monitor lifetime — the watch loop
    stays deterministic and quiet, mirroring replan's no-oscillation
    property).  An infinite peak (a failed switch — congestion's
    limiting case) is critical.
    """

    name = "congestion_drift"

    def __init__(self, monitor=None, *, threshold: float = 0.5,
                 hysteresis: float = 0.05):
        self.monitor = monitor
        self.threshold = float(threshold)
        self.hysteresis = float(hysteresis)
        self._fired_peak: float | None = None

    def detect(self, registry, tracer, *, now: float = 0.0):
        from repro_torch.obs.telemetry import slot_name
        if self.monitor is not None:
            cmap = self.monitor.observe()
            slots = {slot_name(l, i): v
                     for (l, i), v in cmap.hotness.items()}
        else:
            slots = {}
            for name in registry.names("congestion."):
                if name.endswith(".hotness"):
                    slots[name[len("congestion."):-len(".hotness")]] = \
                        registry.value(name, 0.0)
        if not slots:
            return []
        hottest = max(sorted(slots), key=lambda s: slots[s])
        peak = slots[hottest]
        if peak < self.threshold:
            return []
        if self._fired_peak is not None and (
                math.isinf(self._fired_peak)
                or peak <= self._fired_peak * (1.0 + self.hysteresis)):
            return []                   # not rising beyond hysteresis
        self._fired_peak = peak
        severity = ("critical" if math.isinf(peak)
                    or peak >= 2.0 * self.threshold else "warning")
        what = ("unusable (failed switch)" if math.isinf(peak)
                else f"hot ({peak:.3f} >= threshold {self.threshold:g})")
        return [Incident(
            detector=self.name, severity=severity,
            summary=f"fabric slot {hottest} is {what}",
            action="replan",
            evidence=((f"congestion.{hottest}.hotness", peak),
                      ("congestion.threshold", self.threshold)),
            ts=now)]


class ModelDivergenceDetector:
    """Measured-window vs analytic-drain drift, per tenant.

    The timeline renderer (``repro_torch.obs.timeline``) lays the FCFS
    simulation's measured window (``fcfs/<t>``, what the scheduler
    counts) and the analytic drain prediction (``model/<t>``,
    ``model_shared``) side by side — the same measured/predicted pair
    ``TenantReport`` carries as ``measured_pkts``/``predicted_pkts``.
    This detector reads those spans back and flags tenants whose latest
    measured window falls outside ``band`` × the prediction (the
    calibrated agreement band of the shared-switch checks).  Divergence means
    the *model* no longer describes the fabric — an observe-first
    signal (action ``"none"``): remediation that trusts the model
    (replan hysteresis) should be treated skeptically until it
    converges again.
    """

    name = "model_divergence"

    def __init__(self, *, band: tuple[float, float] = (0.5, 1.8)):
        lo, hi = band
        if not (0.0 < lo < hi):
            raise ValueError(f"band must be 0 < lo < hi, got {band}")
        self.band = (float(lo), float(hi))

    def detect(self, registry, tracer, *, now: float = 0.0):
        fcfs: dict[str, float] = {}
        model: dict[str, float] = {}
        for ev in tracer.events:            # last span per lane wins
            if ev["ph"] != "X" or ev["process"] != "modeled":
                continue
            if ev["name"] == "fcfs.window":
                fcfs[ev["track"].rpartition("/")[2]] = ev["dur"]
            elif ev["name"] == "model.drain":
                model[ev["track"].rpartition("/")[2]] = ev["dur"]
        incidents = []
        lo, hi = self.band
        for tenant in sorted(fcfs.keys() & model.keys()):
            if model[tenant] <= 0.0:
                continue
            ratio = fcfs[tenant] / model[tenant]
            if lo < ratio < hi:
                continue
            incidents.append(Incident(
                detector=self.name, severity="warning",
                summary=f"measured window is {ratio:.2f}x the modeled "
                        f"drain (band {lo:g}..{hi:g})",
                action="none", tenant=tenant,
                evidence=((f"trace.fcfs/{tenant}.dur_us", fcfs[tenant]),
                          (f"trace.model/{tenant}.dur_us", model[tenant]),
                          ("model.divergence_x", ratio)),
                ts=now))
        return incidents


def default_detectors(*, manager=None, monitor=None, coordinator=None,
                      threshold: float = 0.5, hysteresis: float = 0.05):
    """The standard detector set, wired to whatever runtime objects the
    caller has (each detector degrades gracefully without its ref)."""
    return [StragglerDetector(coordinator),
            FaultStormDetector(manager),
            CongestionDriftDetector(monitor, threshold=threshold,
                                    hysteresis=hysteresis),
            ModelDivergenceDetector()]


# ---------------------------------------------------------------------------
# The monitor.
# ---------------------------------------------------------------------------

class HealthMonitor:
    """Streaming anomaly detection over one telemetry handle.

    Owns a detector set and an append-only incident log.  ``poll()``
    runs every detector once against the current registry/trace state
    — host-side reads only, no tensor touched, the recorder's own
    contract.  ``watch()`` is the deterministic
    loop: N polls, optionally handing each poll's fresh incidents to an
    ``slo.SLOPolicy``.  Incidents are mirrored into the registry
    (``health.incidents.<severity>`` counters) and the tracer (one
    ``health.incident`` instant on the ``health`` track each), so the
    health plane audits itself through the same exports it reads.

    ``clock=`` is injectable: inject
    ``obs.counting_clock()`` (and one on the tracer) and two identical
    runs export **byte-identical** incident logs.
    """

    def __init__(self, telemetry, *, manager=None, monitor=None,
                 coordinator=None, clock=None, detectors=None,
                 threshold: float = 0.5, hysteresis: float = 0.05):
        self.telemetry = telemetry
        self.manager = manager
        self.monitor = monitor
        self.coordinator = coordinator
        self.clock = time.monotonic if clock is None else clock
        self.detectors = (list(detectors) if detectors is not None
                          else default_detectors(manager=manager,
                                                 monitor=monitor,
                                                 coordinator=coordinator,
                                                 threshold=threshold,
                                                 hysteresis=hysteresis))
        self.incidents: list[Incident] = []
        self.polls = 0

    def poll(self, *, now=None) -> tuple[Incident, ...]:
        """Run every detector once; record and return the fresh
        incidents (possibly empty)."""
        t = self.clock() if now is None else now
        self.polls += 1
        reg = self.telemetry.registry
        tracer = self.telemetry.tracer
        fresh: list[Incident] = []
        for d in self.detectors:
            fresh.extend(d.detect(reg, tracer, now=t))
        for inc in fresh:
            self.incidents.append(inc)
            reg.counter(f"health.incidents.{inc.severity}").inc()
            tracer.instant("health.incident", track="health",
                           args={"detector": inc.detector,
                                 "severity": inc.severity,
                                 "action": inc.action,
                                 **({"tenant": inc.tenant}
                                    if inc.tenant else {})})
        return tuple(fresh)

    def watch(self, rounds: int, *, policy=None):
        """The deterministic watch loop: ``rounds`` polls, applying
        ``policy`` (an ``slo.SLOPolicy``) to each poll's fresh
        incidents.  Returns ``(incidents, remediations)`` raised/taken
        across the whole loop.  Deterministic because every input is
        static between polls and the clock is injectable — two
        identical loops produce identical logs."""
        raised: list[Incident] = []
        taken: list = []
        for _ in range(int(rounds)):
            fresh = self.poll()
            raised.extend(fresh)
            if policy is not None and fresh:
                taken.extend(policy.apply(fresh))
        return tuple(raised), tuple(taken)

    # -- severity / export -------------------------------------------------
    def worst(self) -> str | None:
        """The most severe incident level on the log, or ``None``."""
        if not self.incidents:
            return None
        return max(self.incidents,
                   key=lambda i: severity_rank(i.severity)).severity

    def incidents_json(self) -> str:
        return incidents_json(self.incidents)

    def export_incidents(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.incidents_json())
