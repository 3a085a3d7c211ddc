"""SLO watchdogs: binding health incidents to remediation (DESIGN.md §17).

The port of ``repro/obs/slo.py``, the action half of the health plane.  :class:`SLOPolicy` maps
:class:`~repro_torch.obs.health.Incident` records onto the remediation paths
the runtime *already has* — it never invents a new mutation:

==================  =====================================================
action              bound call
==================  =====================================================
``replan``          ``SessionManager.replan(monitor, threshold=,
                    hysteresis=)`` — verbatim the manual replan call
``evict``           ``SessionManager.evict(tenant, reason=)``
``recover_session``  ``ft.recover_session_failure(manager, tenant)`` (or
                    ``Coordinator.session_failure`` when a coordinator
                    is attached, so ``failed_sessions`` stays current)
``recover_switch``  ``ft.recover_switch_failure(network, lease,
                    switch_id, runtime=manager)`` — the policy holds the
                    lease and swaps in the recovered one
``remesh``          observe-only here: re-meshing recompiles the world
                    (checkpoint-restart, DESIGN.md §8) — the policy
                    records the recommendation, the job launcher decides
==================  =====================================================

Because each binding *is* the manual call, a detector-triggered
remediation is bitwise-identical in outcome to the same action triggered
by hand: the manual call is the oracle, and the health checks prove it
on real tensors (policy-replanned manager ≡ manually-replanned manager:
same tree, same sessions, same reduction bits).

Rules are matched most-specific-first in declaration order: the first
rule whose detector matches (exact name or ``"*"``) at or above its
severity floor wins.  Every dispatch is recorded as a
:class:`Remediation` — applied or not, with the why — so the watch
loop's actions are as auditable as the incidents that caused them.
"""
from __future__ import annotations

import dataclasses

from repro_torch.obs.health import Incident, severity_rank


@dataclasses.dataclass(frozen=True)
class SLORule:
    """One binding: incidents from ``detector`` (or any, ``"*"``) at or
    above ``min_severity`` trigger ``action``."""

    detector: str
    min_severity: str
    action: str

    def matches(self, incident: Incident) -> bool:
        if self.detector not in ("*", incident.detector):
            return False
        return (severity_rank(incident.severity)
                >= severity_rank(self.min_severity))


#: The default watchdog set: congestion drift re-plans (the congestion
#: loop, closed), critical fault storms degrade the session to the wire,
#: dead hosts are recorded for the next re-mesh.
DEFAULT_RULES = (
    SLORule("congestion_drift", "warning", "replan"),
    SLORule("fault_storm", "critical", "recover_session"),
    SLORule("straggler", "critical", "remesh"),
)


@dataclasses.dataclass(frozen=True)
class Remediation:
    """One dispatch record: what an incident triggered and how it went.

    ``applied`` is False when the rule matched but the binding could
    not run (no monitor to replan from, unknown tenant, ...) — recorded
    rather than raised, so one unservable incident never aborts the
    watch loop.  ``detail`` carries the outcome (replan reason,
    eviction result, ...); ``result`` the bound call's return value
    (e.g. the ``ReplanResult``).
    """

    incident: Incident
    action: str
    applied: bool
    detail: str = ""
    result: object = None


class SLOPolicy:
    """Binds incidents to the existing remediation paths.

    ``threshold``/``hysteresis`` default to the same values as
    ``SessionManager.replan`` — the policy's replan *is* the manual
    replan, argument for argument.  ``network``/``lease`` arm the
    ``recover_switch`` binding (the lease is replaced by the recovered
    one after a successful reroute).
    """

    def __init__(self, manager=None, *, monitor=None, coordinator=None,
                 network=None, lease=None, rules=DEFAULT_RULES,
                 threshold: float = 0.5, hysteresis: float = 0.05):
        self.manager = manager
        self.monitor = monitor
        self.coordinator = coordinator
        self.network = network
        self.lease = lease
        self.rules = tuple(rules)
        for r in self.rules:
            severity_rank(r.min_severity)       # validate eagerly
        self.threshold = float(threshold)
        self.hysteresis = float(hysteresis)
        #: append-only dispatch log, every ``apply`` call.
        self.remediations: list[Remediation] = []

    def rule_for(self, incident: Incident) -> SLORule | None:
        for rule in self.rules:
            if rule.matches(incident):
                return rule
        return None

    # -- bindings ----------------------------------------------------------
    def _replan(self, incident: Incident) -> Remediation:
        if self.manager is None or self.monitor is None:
            return Remediation(incident, "replan", False,
                               "no manager/monitor bound")
        res = self.manager.replan(self.monitor, threshold=self.threshold,
                                  hysteresis=self.hysteresis)
        return Remediation(incident, "replan", True,
                           f"replanned={res.replanned} "
                           f"reason={res.reason!r}", res)

    def _evict(self, incident: Incident) -> Remediation:
        if self.manager is None or incident.tenant is None:
            return Remediation(incident, "evict", False,
                               "no manager/tenant bound")
        ok = self.manager.evict(incident.tenant,
                                reason=f"slo: {incident.detector}")
        return Remediation(incident, "evict", ok,
                           "evicted" if ok else "no such session", ok)

    def _recover_session(self, incident: Incident) -> Remediation:
        from repro_torch.ft.coordinator import recover_session_failure
        if self.manager is None or incident.tenant is None:
            return Remediation(incident, "recover_session", False,
                               "no manager/tenant bound")
        if self.coordinator is not None:
            ok = self.coordinator.session_failure(self.manager,
                                                  incident.tenant)
        else:
            ok = recover_session_failure(self.manager, incident.tenant)
        return Remediation(incident, "recover_session", ok,
                           "drained to host wires" if ok
                           else "no such session", ok)

    def _recover_switch(self, incident: Incident) -> Remediation:
        from repro_torch.ft.coordinator import recover_switch_failure
        switch_id = dict(incident.evidence).get("ft.switch_id")
        if self.network is None or self.lease is None \
                or switch_id is None:
            return Remediation(incident, "recover_switch", False,
                               "no network/lease/switch_id bound")
        if self.coordinator is not None:
            new_lease = self.coordinator.switch_failure(
                self.lease, int(switch_id), runtime=self.manager)
        else:
            new_lease = recover_switch_failure(
                self.network, self.lease, int(switch_id),
                runtime=self.manager)
        self.lease = new_lease
        return Remediation(incident, "recover_switch", True,
                           "rerouted" if new_lease is not None
                           else "no sibling switch; drained",
                           new_lease)

    def _remesh(self, incident: Incident) -> Remediation:
        # re-meshing is checkpoint-restart onto a new mesh (DESIGN.md
        # §8) — a whole-job decision the policy only recommends
        return Remediation(incident, "remesh", False,
                           "recorded for the next re-mesh")

    _BINDINGS = {"replan": _replan, "evict": _evict,
                 "recover_session": _recover_session,
                 "recover_switch": _recover_switch,
                 "remesh": _remesh}

    # -- dispatch ----------------------------------------------------------
    def apply(self, incidents) -> tuple[Remediation, ...]:
        """Dispatch each incident through its first matching rule.

        Incidents recommending an action themselves (``incident.action``
        != ``"none"``) still go through the rules — the policy, not the
        detector, decides what actually runs.  Unmatched incidents are
        skipped silently (observe-only).  Returns (and logs) one
        :class:`Remediation` per dispatched incident.
        """
        out = []
        for inc in incidents:
            rule = self.rule_for(inc)
            if rule is None:
                continue
            binding = self._BINDINGS.get(rule.action)
            if binding is None:
                raise ValueError(f"rule {rule} names unknown action "
                                 f"{rule.action!r}; one of "
                                 f"{sorted(self._BINDINGS)}")
            rem = binding(self, inc)
            self.remediations.append(rem)
            out.append(rem)
        return tuple(out)
