"""The port's fabric health plane against the JAX package's.

Every host test runs one scenario through both packages (``_both``) and
asks for equal outcomes: incidents (``as_dict``), incident-log JSON and
``render_incidents`` byte for byte, remediation records, manager state,
error types and texts.  Tolerance zero: the health plane is plain Python
over equal counters.

* **Host tests**: the counterparts of ``tests/test_health.py``'s 31.
* **The ``health`` group** of ``tests/multidevice_checks.py`` at ``B, S
  = 3, 64`` on ``(2, 4)`` and ``(1, 8)``: a reproducible canary and a
  lossy dense tenant on one shared switch under counting clocks, a hot
  slot injected, ``watch(2)``.  The incident log, the trace and the
  metrics are the reference's bytes (its transports under nested
  ``jax.vmap``); the policy's replan leaves the manager as the manual
  replan does and every tenant's next reduction is the manual twin's
  bits and the reference's; a ``recover_session`` rule drains the lossy
  tenant as the manual recovery does, in bits too.
* **The launcher**: ``--health-policy observe`` on one job and ``auto``
  with ``--tenants 3`` (both over a lossy fabric, so the fault-storm
  detector fires) write the reference launcher's incident log, trace
  and metrics bytes under counting clocks, the reference's side being
  its launcher's recording sequence in one process.  The health pass
  watches a fresh ``CongestionMonitor`` before the modeled tracks are
  rendered, so the ``--congestion-replan`` injection and the modeled
  spans are not seen, in both packages.
"""
import dataclasses
import functools
import json
import sys
import types
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro import runtime as jruntime
from repro.configs import tinyllama_1_1b as jtl
from repro.core import engine as jengine
from repro.core import topology as jtopology
from repro.core import transports as jtransports
from repro.ft import coordinator as jcoord
from repro.models import registry as jregistry
from repro.obs import health as jhealth
from repro.obs import slo as jslo
from repro.obs import timeline as jtimeline
from repro.perfmodel import network_sim as jns
from repro.sharding import rules as jrules
from repro.switch import dataplane as jdp
from repro.switch import packets as jpk
from repro_torch import obs, runtime
from repro_torch.convert import tensor_from_numpy
from repro_torch.core import topology, transports
from repro_torch.core.engine import FlareConfig
from repro_torch.ft import coordinator
from repro_torch.launch import train as launch_train
from repro_torch.mesh import RankMesh
from repro_torch.obs import health, slo, timeline
from repro_torch.perfmodel import network_sim as ns
from repro_torch.switch import dataplane, packets as pk

torch.set_num_threads(1)

AXES = ("pod", "data")
MESHES = [(2, 4), (1, 8)]
_INT = {1: np.int8, 2: np.int16, 4: np.int32}

PORT = types.SimpleNamespace(obs=obs, health=health, slo=slo,
                             ft=coordinator, rt=runtime, dp=dataplane,
                             pk=pk, ns=ns, timeline=timeline,
                             topology=topology, f32=torch.float32,
                             FlareConfig=FlareConfig)
REF = types.SimpleNamespace(obs=jobs, health=jhealth, slo=jslo, ft=jcoord,
                            rt=jruntime, dp=jdp, pk=jpk, ns=jns,
                            timeline=jtimeline, topology=jtopology,
                            f32=jnp.float32, FlareConfig=jengine.FlareConfig)


def _plain(x):
    """A package-neutral, comparable image of a result."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(
            (f.name, _plain(getattr(x, f.name)))
            for f in dataclasses.fields(x))
    if isinstance(x, dict):
        return ("dict",) + tuple(sorted(((_plain(k), _plain(v))
                                         for k, v in x.items()), key=repr))
    if isinstance(x, (list, tuple)):
        return tuple(_plain(v) for v in x)
    return x


def _outcome(fn, pkg):
    try:
        return ("ok", _plain(fn(pkg)))
    except Exception as e:          # the same exception, with its message
        return ("raise", type(e).__name__, str(e))


def _both(fn):
    """Run ``fn(pkg)`` on the port and on the reference; their outcomes
    must be equal.  Returns the port's raw result (raising as it did)."""
    mine, ref = _outcome(fn, PORT), _outcome(fn, REF)
    assert mine == ref
    return fn(PORT)


def _same_raise(fn):
    """``fn(pkg)`` raises the same exception and message in both."""
    mine = _outcome(fn, PORT)
    assert mine[0] == "raise" and mine == _outcome(fn, REF)
    return mine


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.contiguous()
        return a.view({1: torch.int8, 2: torch.int16,
                       4: torch.int32}[a.element_size()]).numpy()
    a = np.asarray(a)
    return a.view(_INT[a.dtype.itemsize])


def _nested(f):
    return jax.jit(jax.vmap(jax.vmap(f, axis_name="data"), axis_name="pod"))


def _mgr(X, **kw):
    return X.rt.SessionManager(AXES, (2, 4), **kw)


def _lossy_plan(X, counts):
    """The check_obs idiom: the first surviving plan that schedules
    retransmissions."""
    for seed in range(200):
        cand = X.pk.FaultPlan(seed=seed, drop=0.05, duplicate=0.2)
        scheds = [s for s in X.dp.fault_schedules(cand, counts)
                  if s is not None]
        if (X.dp.plan_survives(cand, counts)
                and sum(s.retransmits for s in scheds) > 0):
            return cand, scheds
    raise AssertionError(f"no surviving fault seed for {counts}")


def _incs(incidents):
    return [i.as_dict() for i in incidents]


# ---------------------------------------------------------------------------
# Incident records and the severity scale.
# ---------------------------------------------------------------------------

def test_severity_rank_orders_and_rejects_unknown():
    out = _both(lambda X: [X.health.severity_rank(s)
                           for s in X.health.SEVERITIES])
    assert out == [0, 1, 2]
    _same_raise(lambda X: X.health.severity_rank("catastrophic"))
    with pytest.raises(ValueError, match="unknown severity"):
        health.severity_rank("catastrophic")


def test_incident_validates_severity_eagerly():
    _same_raise(lambda X: X.health.Incident(detector="d", severity="sev",
                                            summary="s"))
    with pytest.raises(ValueError, match="unknown severity"):
        health.Incident(detector="d", severity="sev", summary="s")


def test_incident_as_dict_sorts_evidence():
    d = _both(lambda X: X.health.Incident(
        detector="d", severity="warning", summary="s",
        evidence=(("z.late", 2.0), ("a.early", 1.0))).as_dict())
    assert list(d["evidence"]) == ["a.early", "z.late"]
    assert d["action"] == "none" and d["tenant"] is None
    with pytest.raises(dataclasses.FrozenInstanceError):
        health.Incident(detector="d", severity="info", summary="s").ts = 1.0


def test_incidents_json_deterministic_and_rendered():
    def build(X):
        incs = [X.health.Incident(detector="d", severity="critical",
                                  summary="s", tenant="t",
                                  evidence=(("b", 2.0), ("a", 1.0)), ts=3.0),
                X.health.Incident(detector="e", severity="info",
                                  summary="u", action="replan")]
        return (X.health.incidents_json(incs),
                X.health.render_incidents(incs),
                X.health.render_incidents([]))
    text, rendered, quiet = _both(build)
    assert text == build(PORT)[0] and text.endswith("\n")
    rec = json.loads(text)[0]
    assert rec["severity"] == "critical" and rec["ts"] == 3.0
    assert rendered.splitlines()[0] == \
        "[critical] d tenant=t: s (action: none)"
    assert quiet == "health: no incidents"


# ---------------------------------------------------------------------------
# StragglerDetector.
# ---------------------------------------------------------------------------

def test_straggler_detector_span_dispersion():
    def run(X):
        tm = X.obs.Telemetry.create(clock=X.obs.counting_clock())
        for track, dur in (("train/a", 1.0), ("train/b", 1.0),
                           ("train/c", 10.0)):
            tm.tracer.span_at("train.step", 0.0, dur, track=track,
                              process="measured")
        return _incs(X.health.StragglerDetector().detect(
            tm.registry, tm.tracer, now=5.0))
    (inc,) = _both(run)
    assert inc["tenant"] == "c" and inc["severity"] == "warning"
    assert inc["action"] == "remesh" and inc["ts"] == 5.0
    assert inc["evidence"] == {"trace.median_dur": 1.0,
                               "trace.train/c.mean_dur": 10.0}


def test_straggler_detector_ignores_modeled_and_other_spans():
    def run(X):
        tm = X.obs.Telemetry.create(clock=X.obs.counting_clock())
        tm.tracer.span_at("train.step", 0.0, 50.0, track="model/a",
                          process="modeled")
        tm.tracer.span_at("other.step", 0.0, 50.0, track="train/a",
                          process="measured")
        for track in ("train/a", "train/b"):
            tm.tracer.span_at("train.step", 0.0, 1.0, track=track,
                              process="measured")
        return _incs(X.health.StragglerDetector().detect(tm.registry,
                                                         tm.tracer))
    assert _both(run) == []


def test_straggler_detector_coordinator_liveness_path():
    def run(X):
        tm = X.obs.Telemetry.create(clock=X.obs.counting_clock())
        t = [0.0]
        coord = X.ft.Coordinator(4, timeout_s=5, clock=lambda: t[0],
                                 registry=tm.registry)
        for h in range(4):
            coord.heartbeat(h)
        t[0] = 3.0
        for h in (0, 1, 2):
            coord.heartbeat(h)
        t[0] = 7.0
        failed = coord.check()
        return failed, _incs(X.health.StragglerDetector(coord).detect(
            tm.registry, tm.tracer, now=7.0))
    failed, (inc,) = _both(run)
    assert failed == {3}
    assert (inc["severity"], inc["action"], inc["tenant"]) == (
        "critical", "remesh", "host3")
    assert inc["evidence"] == {"ft.host3.heartbeats": 1.0,
                               "ft.host3.missed": 1.0}


def test_coordinator_publishes_ft_registry_counters():
    def run(X):
        reg = X.obs.MetricsRegistry()
        t = [0.0]
        c = X.ft.Coordinator(3, timeout_s=5, clock=lambda: t[0],
                             registry=reg)
        for h in (0, 0, 1, 2):
            c.heartbeat(h)
        t[0] = 20.0
        c.heartbeat(0, now=20.0)
        c.heartbeat(2, now=20.0)
        out = [c.check(), c.check()]
        c.admit(1)
        c.admit(1)
        out.append(c.straggler_report({0: 0.0, 1: 19.0, 2: 19.5},
                                      now=20.0))
        out.append([reg.get(n).kind for n in reg.names("ft.")])
        return out, reg.to_json()
    (checks, regjson) = _both(run)
    assert checks[0] == checks[1] == {1} and checks[2] == [0]
    assert set(checks[3]) == {"counter"}
    got = json.loads(regjson)
    assert got["ft.host0.heartbeats"]["value"] == 3
    assert got["ft.host1.missed"]["value"] == 1
    assert got["ft.host1.recoveries"]["value"] == 1
    assert got["ft.host0.stragglers"]["value"] == 1


def test_coordinator_without_registry_is_uninstrumented():
    def run(X):
        c = X.ft.Coordinator(2, timeout_s=5, clock=lambda: 0.0)
        c.heartbeat(0)
        return c.registry
    assert _both(run) is None


# ---------------------------------------------------------------------------
# FaultStormDetector.
# ---------------------------------------------------------------------------

def test_fault_storm_silent_without_reliability_counters():
    def run(X):
        tm = X.obs.Telemetry.create()
        mgr = _mgr(X, telemetry=tm)
        mgr.open("det", mode="dense", num_buckets=3, bucket_elems=512,
                 dtype=X.f32)
        return _incs(X.health.FaultStormDetector(mgr).detect(tm.registry,
                                                             tm.tracer))
    assert _both(run) == []


def _storm(X, **kw):
    counts = X.dp.level_packet_counts([4, 2], 3, 512, X.f32)
    plan, scheds = _lossy_plan(X, counts)
    tm = X.obs.Telemetry.create(clock=X.obs.counting_clock())
    mgr = _mgr(X, telemetry=tm)
    mgr.open("lossy", mode="dense", num_buckets=3, bucket_elems=512,
             dtype=X.f32, fault_plan=plan)
    return tm, mgr, scheds


def test_fault_storm_counter_exact_evidence():
    def run(X):
        tm, mgr, scheds = _storm(X)
        incs = X.health.FaultStormDetector(mgr).detect(tm.registry,
                                                       tm.tracer)
        return _incs(incs), [(s.retransmits, s.rounds, s.duplicates)
                             for s in scheds]
    (inc,), scheds = _both(run)
    ev = inc["evidence"]
    assert inc["tenant"] == "lossy"
    assert ev["tenant.lossy.retransmits"] == sum(s[0] for s in scheds)
    assert ev["tenant.lossy.retry_rounds"] == sum(max(0, s[1] - 1)
                                                  for s in scheds)
    assert ev["tenant.lossy.duplicates"] == sum(s[2] for s in scheds)
    assert "model.lossy.expected_retransmits" in ev
    assert 0.0 < ev["model.lossy.survival"] <= 1.0


def test_fault_storm_escalates_on_low_survival():
    def run(X):
        tm, mgr, _ = _storm(X)
        crit = X.health.FaultStormDetector(mgr, min_survival=1.0)
        calm = X.health.FaultStormDetector(mgr, tolerance=1e9,
                                           min_survival=0.0)
        return (_incs(crit.detect(tm.registry, tm.tracer)),
                _incs(calm.detect(tm.registry, tm.tracer)))
    (crit,), (calm,) = _both(run)
    assert (crit["severity"], crit["action"]) == ("critical",
                                                  "recover_session")
    assert (calm["severity"], calm["action"]) == ("warning", "none")


def test_fault_storm_without_manager_still_reports():
    def run(X):
        tm = X.obs.Telemetry(registry=X.obs.MetricsRegistry(),
                             tracer=X.obs.Tracer(
                                 clock=X.obs.counting_clock()))
        tm.registry.counter("tenant.t.retransmits").inc(7)
        return _incs(X.health.FaultStormDetector().detect(tm.registry,
                                                          tm.tracer))
    (inc,) = _both(run)
    assert inc["severity"] == "warning"
    assert "no session model" in inc["summary"]
    assert inc["evidence"]["tenant.t.retransmits"] == 7.0


# ---------------------------------------------------------------------------
# CongestionDriftDetector.
# ---------------------------------------------------------------------------

def test_drift_detector_reads_gauges_and_applies_hysteresis():
    def run(X):
        tm = X.obs.Telemetry.create(clock=X.obs.counting_clock())
        hot = f"congestion.{X.obs.slot_name(1, 0)}.hotness"
        tm.registry.gauge(hot).set(0.8)
        tm.registry.gauge(
            f"congestion.{X.obs.slot_name(1, 1)}.hotness").set(0.2)
        det = X.health.CongestionDriftDetector()
        out = [_incs(det.detect(tm.registry, tm.tracer)),
               _incs(det.detect(tm.registry, tm.tracer))]
        tm.registry.gauge(hot).set(0.82)
        out.append(_incs(det.detect(tm.registry, tm.tracer)))
        tm.registry.gauge(hot).set(1.2)
        out.append(_incs(det.detect(tm.registry, tm.tracer)))
        return out
    first, again, within, beyond = _both(run)
    assert [i["severity"] for i in first] == ["warning"]
    assert first[0]["action"] == "replan"
    assert again == within == []
    assert [i["severity"] for i in beyond] == ["critical"]


def test_drift_detector_quiet_below_threshold():
    def run(X):
        tm = X.obs.Telemetry.create()
        tm.registry.gauge(
            f"congestion.{X.obs.slot_name(1, 0)}.hotness").set(0.3)
        return (_incs(X.health.CongestionDriftDetector().detect(
                    tm.registry, tm.tracer)),
                _incs(X.health.CongestionDriftDetector().detect(
                    X.obs.MetricsRegistry(), tm.tracer)))
    assert _both(run) == ([], [])


def test_drift_detector_live_monitor_observes_first():
    def run(X):
        tm = X.obs.Telemetry.create(clock=X.obs.counting_clock())
        mgr = _mgr(X, telemetry=tm)
        mgr.open("a", mode="dense", num_buckets=2, bucket_elems=256,
                 dtype=X.f32)
        mon = X.rt.CongestionMonitor(mgr, registry=tm.registry)
        mon.inject((1, 0), 2.0)
        incs = X.health.CongestionDriftDetector(mon).detect(tm.registry,
                                                            tm.tracer)
        return _incs(incs), list(mon.history), tm.metrics_json()
    (inc,), hist, _ = _both(run)
    assert inc["severity"] == "critical"
    assert hist and hist[-1] >= 2.0


# ---------------------------------------------------------------------------
# ModelDivergenceDetector.
# ---------------------------------------------------------------------------

def _divergence(X, tm, fcfs, model, tenant="t"):
    tm.tracer.span_at("fcfs.window", 0.0, fcfs, track=f"fcfs/{tenant}",
                      process="modeled")
    tm.tracer.span_at("model.drain", 0.0, model, track=f"model/{tenant}",
                      process="modeled")


def test_model_divergence_fires_outside_band():
    def run(X):
        tm = X.obs.Telemetry.create(clock=X.obs.counting_clock())
        _divergence(X, tm, fcfs=20.0, model=10.0)
        return _incs(X.health.ModelDivergenceDetector().detect(tm.registry,
                                                               tm.tracer))
    (inc,) = _both(run)
    assert (inc["tenant"], inc["severity"], inc["action"]) == (
        "t", "warning", "none")
    assert inc["evidence"]["model.divergence_x"] == 2.0


def test_model_divergence_quiet_inside_band_and_on_partial_lanes():
    def run(X):
        tm = X.obs.Telemetry.create(clock=X.obs.counting_clock())
        _divergence(X, tm, fcfs=10.0, model=9.0)
        tm.tracer.span_at("fcfs.window", 0.0, 99.0, track="fcfs/half",
                          process="modeled")
        return _incs(X.health.ModelDivergenceDetector().detect(tm.registry,
                                                               tm.tracer))
    assert _both(run) == []


def test_model_divergence_last_span_wins_and_band_validates():
    def run(X):
        tm = X.obs.Telemetry.create(clock=X.obs.counting_clock())
        _divergence(X, tm, fcfs=20.0, model=10.0)
        _divergence(X, tm, fcfs=10.0, model=10.0)
        return _incs(X.health.ModelDivergenceDetector().detect(tm.registry,
                                                               tm.tracer))
    assert _both(run) == []
    _same_raise(lambda X: X.health.ModelDivergenceDetector(band=(1.8, 0.5)))
    with pytest.raises(ValueError, match="band"):
        health.ModelDivergenceDetector(band=(1.8, 0.5))


# ---------------------------------------------------------------------------
# SLOPolicy: rules and bindings.
# ---------------------------------------------------------------------------

def _inc(X, detector="congestion_drift", severity="warning", tenant=None,
         evidence=()):
    return X.health.Incident(detector=detector, severity=severity,
                             summary="s", tenant=tenant, evidence=evidence)


def test_slo_rule_matching_severity_floor_and_wildcard():
    def run(X):
        rule = X.slo.SLORule("fault_storm", "critical", "recover_session")
        any_rule = X.slo.SLORule("*", "warning", "replan")
        return ([rule.matches(_inc(X, "fault_storm", "critical")),
                 rule.matches(_inc(X, "fault_storm", "warning")),
                 rule.matches(_inc(X, "congestion_drift", "critical")),
                 any_rule.matches(_inc(X, "model_divergence", "critical")),
                 any_rule.matches(_inc(X, "model_divergence", "info"))],
                _outcome(lambda _: X.slo.SLOPolicy(
                    rules=(X.slo.SLORule("d", "sev", "replan"),)), X))
    matches, bad = _both(run)
    assert matches == [True, False, False, True, False]
    assert bad[:2] == ("raise", "ValueError") and "unknown severity" in bad[2]


def test_slo_policy_first_matching_rule_wins_and_unmatched_skip():
    def run(X):
        pol = X.slo.SLOPolicy(rules=(
            X.slo.SLORule("congestion_drift", "critical", "remesh"),
            X.slo.SLORule("*", "warning", "remesh")))
        return (pol.rule_for(_inc(X, severity="critical")),
                pol.rule_for(_inc(X, "model_divergence", "info")),
                pol.apply([_inc(X, "model_divergence", "info")]),
                pol.remediations)
    rule, none, taken, log = _both(run)
    assert rule.action == "remesh" and none is None
    assert taken == () and log == []


def test_slo_policy_unknown_action_fails_loudly():
    def run(X):
        pol = X.slo.SLOPolicy(rules=(X.slo.SLORule("*", "info",
                                                   "reboot_the_planet"),))
        return pol.apply([_inc(X)])
    _same_raise(run)
    with pytest.raises(ValueError, match="unknown action"):
        run(PORT)


def test_slo_policy_unservable_incident_recorded_not_raised():
    def run(X):
        pol = X.slo.SLOPolicy()
        (rem,) = pol.apply([_inc(X)])
        return rem, pol.remediations == [rem]
    rem, logged = _both(run)
    assert rem.action == "replan" and not rem.applied and logged
    assert "no manager/monitor" in rem.detail


def _replan_prepared(X):
    mgr = _mgr(X, seed=11)
    for t in ("a", "b"):
        mgr.open(t, mode="dense", num_buckets=2, bucket_elems=256,
                 dtype=X.f32)
    mon = X.rt.CongestionMonitor(mgr)
    mon.inject((1, 0), 2.0)
    mon.inject_flow(X.ns.BackgroundFlow("leaf_spine", 10.0))
    return mgr, mon


def _manager_state(mgr):
    return (_plain(mgr.tree.nodes), mgr._epoch,
            [s.tenant for s in mgr.active()])


def test_slo_policy_replan_is_the_manual_replan():
    """A policy-dispatched replan and the manual call leave two
    identically prepared managers in the same state, in each package and
    across them."""
    def run(X):
        mgr_man, mon_man = _replan_prepared(X)
        res_man = mgr_man.replan(mon_man, threshold=0.5, hysteresis=0.05)
        mgr_pol, mon_pol = _replan_prepared(X)
        pol = X.slo.SLOPolicy(mgr_pol, monitor=mon_pol)
        (rem,) = pol.apply([_inc(X, "congestion_drift", "warning")])
        (rem2,) = pol.apply([_inc(X, "congestion_drift", "warning")])
        return (res_man, _manager_state(mgr_man), rem,
                _manager_state(mgr_pol), rem2)
    res_man, st_man, rem, st_pol, rem2 = _both(run)
    assert rem.applied and rem.action == "replan"
    assert _plain(rem.result) == _plain(res_man) and st_pol == st_man
    assert rem2.applied and not rem2.result.replanned
    assert rem2.result.reason == "no cheaper tree"


def test_slo_policy_recover_session_is_the_manual_recover():
    def prepared(X):
        mgr = _mgr(X)
        for t in ("lossy", "other"):
            mgr.open(t, mode="dense", num_buckets=2, bucket_elems=256,
                     dtype=X.f32)
        return mgr

    def run(X):
        mgr_man = prepared(X)
        manual = X.ft.recover_session_failure(mgr_man, "lossy")
        mgr_pol = prepared(X)
        (rem,) = X.slo.SLOPolicy(mgr_pol).apply(
            [_inc(X, "fault_storm", "critical", tenant="lossy")])
        mgr_c = prepared(X)
        coord = X.ft.Coordinator(8, clock=lambda: 0.0)
        (rem_c,) = X.slo.SLOPolicy(mgr_c, coordinator=coord).apply(
            [_inc(X, "fault_storm", "critical", tenant="lossy")])
        return (manual, [s.tenant for s in mgr_man.active()], rem,
                [s.tenant for s in mgr_pol.active()], rem_c,
                coord.failed_sessions)
    manual, act_man, rem, act_pol, rem_c, failed = _both(run)
    assert manual and rem.applied and rem.action == "recover_session"
    assert act_pol == act_man == ["other"]
    assert rem_c.applied and failed == {"lossy"}


def test_slo_policy_evict_and_remesh_bindings():
    def run(X):
        mgr = _mgr(X)
        mgr.open("t", mode="dense", num_buckets=2, bucket_elems=256,
                 dtype=X.f32)
        pol = X.slo.SLOPolicy(mgr, rules=(
            X.slo.SLORule("straggler", "critical", "remesh"),
            X.slo.SLORule("*", "info", "evict")))
        (rem,) = pol.apply([_inc(X, "fault_storm", "warning", tenant="t")])
        active = mgr.active()
        (rem2,) = pol.apply([_inc(X, "fault_storm", "warning", tenant="t")])
        (rem3,) = pol.apply([_inc(X, "straggler", "critical",
                                  tenant="host3")])
        return rem, active, rem2, rem3
    rem, active, rem2, rem3 = _both(run)
    assert rem.action == "evict" and rem.applied and active == ()
    assert not rem2.applied
    assert rem3.action == "remesh" and not rem3.applied
    assert "re-mesh" in rem3.detail


def test_slo_policy_recover_switch_binding():
    """The reference's fifth binding: a switch id in the evidence reroutes
    the held lease (``recover_switch_failure``) and the policy swaps in
    the recovered one; without a network it is recorded, not applied."""
    def run(X):
        nm = X.topology.NetworkManager()
        lease = nm.request(8, radix=2)
        mgr = X.rt.SessionManager(AXES, (2, 4))
        mgr.rebind(lease.tree)
        mgr.open("t", mode="dense", num_buckets=2, bucket_elems=256,
                 dtype=X.f32)
        rules = (X.slo.SLORule("*", "critical", "recover_switch"),)
        leaf = lease.tree.levels[1][0]
        inc = _inc(X, "straggler", "critical",
                   evidence=(("ft.switch_id", float(leaf)),))
        (skip,) = X.slo.SLOPolicy(mgr, rules=rules).apply([inc])
        pol = X.slo.SLOPolicy(mgr, network=nm, lease=lease, rules=rules)
        (rem,) = pol.apply([inc])
        return (skip.applied, skip.detail, rem.applied, rem.detail,
                pol.lease is rem.result, pol.lease.tree.radix,
                [s.tenant for s in mgr.active()], mgr._epoch)
    out = _both(run)
    assert out[:4] == (False, "no network/lease/switch_id bound", True,
                       "rerouted")
    assert out[4] and out[6] == ["t"]


# ---------------------------------------------------------------------------
# HealthMonitor: poll, watch, determinism.
# ---------------------------------------------------------------------------

def _storm_and_drift(X):
    tm = X.obs.Telemetry.create(clock=X.obs.counting_clock())
    tm.registry.counter("tenant.t.retransmits").inc(7)
    tm.registry.gauge(f"congestion.{X.obs.slot_name(1, 0)}.hotness").set(0.8)
    return tm


def test_health_monitor_poll_records_and_mirrors():
    def run(X):
        tm = _storm_and_drift(X)
        hm = X.obs.HealthMonitor(tm, clock=X.obs.counting_clock())
        fresh = hm.poll()
        out = [_incs(fresh), hm.incidents == list(fresh), hm.worst()]
        fresh2 = hm.poll()
        out += [_incs(fresh2), hm.polls, tm.metrics_json(), tm.trace_json()]
        return out
    first, logged, worst, second, polls, metrics, trace = _both(run)
    assert sorted(i["detector"] for i in first) == ["congestion_drift",
                                                    "fault_storm"]
    assert logged and worst == "warning"
    assert json.loads(metrics)["health.incidents.warning"]["value"] == 3
    instants = [e for e in json.loads(trace)["traceEvents"]
                if e.get("name") == "health.incident"]
    assert len(instants) == 3
    assert [i["detector"] for i in second] == ["fault_storm"] and polls == 2


def test_health_monitor_worst_none_when_quiet():
    def run(X):
        hm = X.obs.HealthMonitor(X.obs.Telemetry.create(
            clock=X.obs.counting_clock()), clock=X.obs.counting_clock())
        return hm.poll(), hm.worst(), hm.incidents_json()
    fresh, worst, text = _both(run)
    assert fresh == () and worst is None and json.loads(text) == []


def test_health_monitor_byte_identical_logs_under_counting_clock(tmp_path):
    """Two port runs export the same incident log, telemetry and file
    bytes, and they are the reference's."""
    def one_run(X, path):
        tm = _storm_and_drift(X)
        hm = X.obs.HealthMonitor(tm, clock=X.obs.counting_clock())
        hm.watch(3)
        hm.export_incidents(str(path))
        return (hm.incidents_json(), tm.metrics_json(), tm.trace_json(),
                path.read_bytes())
    a = one_run(PORT, tmp_path / "a.json")
    assert a == one_run(PORT, tmp_path / "b.json")
    assert a == one_run(REF, tmp_path / "r.json")


def test_health_monitor_watch_applies_policy_per_poll():
    def run(X):
        tm = _storm_and_drift(X)
        mgr = _mgr(X, seed=11)
        for t in ("a", "b"):
            mgr.open(t, mode="dense", num_buckets=2, bucket_elems=256,
                     dtype=X.f32)
        mon = X.rt.CongestionMonitor(mgr)
        mon.inject((1, 0), 2.0)
        hm = X.obs.HealthMonitor(tm, clock=X.obs.counting_clock())
        pol = X.obs.SLOPolicy(mgr, monitor=mon)
        raised, taken = hm.watch(2, policy=pol)
        return _incs(raised), taken, pol.remediations == list(taken)
    raised, taken, logged = _both(run)
    assert [i["detector"] for i in raised] == [
        "fault_storm", "congestion_drift", "fault_storm"]
    assert [r.action for r in taken] == ["replan"] and taken[0].applied
    assert logged


def test_health_monitor_explicit_now_and_detector_injection():
    def run(X):
        calls = []

        class Probe:
            name = "probe"

            def detect(self, registry, tracer, *, now=0.0):
                calls.append(now)
                return [X.health.Incident(detector=self.name,
                                          severity="info", summary="tick",
                                          ts=now)]

        hm = X.obs.HealthMonitor(X.obs.Telemetry.create(
            clock=X.obs.counting_clock()), detectors=[Probe()],
            clock=X.obs.counting_clock())
        hm.poll(now=42.0)
        hm.poll()
        return calls, [i.ts for i in hm.incidents]
    assert _both(run) == ([42.0, 0], [42.0, 0])


def test_health_poll_refuses_a_tensor_evidence_value():
    """Every value a detector reads is a host number the registry holds;
    the registry refuses a tensor that is not on the CPU (on the card,
    ``float()`` of one would sync it), so no poll can read one."""
    tm = obs.Telemetry.create(clock=obs.counting_clock())
    with pytest.raises(TypeError, match="concrete host scalars"):
        tm.registry.counter("tenant.t.retransmits").inc(
            torch.empty((), dtype=torch.int32, device="meta"))
    assert obs.HealthMonitor(tm, clock=obs.counting_clock()).poll() == ()


# ---------------------------------------------------------------------------
# The health group: a canary and a lossy tenant on one shared switch.
# ---------------------------------------------------------------------------

B, S = 3, 64
#: the group's drift-only rules: the policy dispatches exactly the replan
#: the manual call anchors
DRIFT = "drift"
#: a rule that drains every fault-storm tenant to the wire
STORM = "storm"


def _rules(X, which):
    if which == DRIFT:
        return (X.slo.SLORule("congestion_drift", "warning", "replan"),)
    return (X.slo.SLORule("fault_storm", "warning", "recover_session"),)


def _reduce_tenants(X, mgr, tm, mshape, xs, plan):
    """Each tenant's reduction of ``xs`` on the shared switch, as bits."""
    outs = {}
    for tenant, kw in (("canary", dict(reproducible=True)),
                       ("lossy", dict(fault_plan=plan))):
        cfg = X.FlareConfig(axes=AXES, transport="innetwork", telemetry=tm,
                            **kw)
        if X is PORT:
            t = transports.from_config(cfg, RankMesh(mshape), torch.float32,
                                       manager=mgr, tenant=tenant)
            red, _ = t(tensor_from_numpy(xs, "cpu").clone(), None,
                       torch.zeros(B, dtype=torch.int32), (S,) * B)
            outs[tenant] = _bits(red)
        else:
            def fn(x, cfg=cfg, tenant=tenant):
                t = jtransports.from_config(cfg, jnp.float32, manager=mgr,
                                            tenant=tenant)
                return t(x, None, jnp.zeros((B,), jnp.int32), (S,) * B)[0]
            outs[tenant] = _bits(_nested(fn)(jnp.asarray(xs)))
    return outs


def _health_run(X, mshape, xs, rules):
    """The group's ``one_run``: the tenants reduce, the schedule and the
    modeled tracks are recorded, a hot slot and a leaf-spine flow are
    injected and a monitor (counting clocks) watches 2 polls, under
    ``rules`` or without a policy (``None``)."""
    pod, data = mshape
    fanins = [data, pod] if pod > 1 else [data]
    plan, scheds = _lossy_plan(X, X.dp.level_packet_counts(fanins, B, S,
                                                           X.f32))
    tm = X.obs.Telemetry.create(clock=X.obs.counting_clock())
    mgr = X.rt.SessionManager(AXES, mshape, seed=7, telemetry=tm)
    outs = _reduce_tenants(X, mgr, tm, mshape, xs, plan)
    mgr.schedule()
    X.timeline.manager_tracks(tm.tracer, mgr)
    mon = X.rt.CongestionMonitor(mgr, registry=tm.registry)
    mon.inject((1, 0), 2.0)
    mon.inject_flow(X.ns.BackgroundFlow("leaf_spine", 10.0))
    hm = X.obs.HealthMonitor(tm, manager=mgr, monitor=mon,
                             clock=X.obs.counting_clock())
    pol = (X.obs.SLOPolicy(mgr, monitor=mon, rules=_rules(X, rules))
           if rules else None)
    raised, taken = hm.watch(2, policy=pol)
    return types.SimpleNamespace(tm=tm, mgr=mgr, mon=mon, hm=hm, outs=outs,
                                 raised=raised, taken=taken, plan=plan,
                                 scheds=scheds)


def _xs(mshape):
    rng = np.random.default_rng(101)
    return (rng.normal(size=mshape + (B, S)) * 1e2).astype(np.float32)


@pytest.mark.parametrize("mshape", MESHES)
def test_health_group_matches_jax(mshape):
    xs = _xs(mshape)
    pol = _health_run(PORT, mshape, xs, DRIFT)
    ref = _health_run(REF, mshape, xs, DRIFT)
    # the incident log and the mirrored telemetry are the reference's bytes
    assert pol.hm.incidents_json() == ref.hm.incidents_json()
    assert pol.tm.metrics_json() == ref.tm.metrics_json()
    assert pol.tm.trace_json() == ref.tm.trace_json()
    for t in pol.outs:
        assert np.array_equal(pol.outs[t], ref.outs[t]), t
    # fault storm every poll, counter-exact against the static schedules
    storms = [i for i in pol.raised if i.detector == "fault_storm"]
    assert len(storms) == 2 and all(i.tenant == "lossy" for i in storms)
    ev = dict(storms[0].evidence)
    assert ev["tenant.lossy.retransmits"] == sum(
        s.retransmits for s in pol.scheds)
    assert ev["tenant.lossy.retry_rounds"] == sum(
        max(0, s.rounds - 1) for s in pol.scheds)
    assert ev["tenant.lossy.duplicates"] == sum(
        s.duplicates for s in pol.scheds)
    # drift fires once and dispatches the replan, which is the manual one
    drifts = [i for i in pol.raised if i.detector == "congestion_drift"]
    assert len(drifts) == 1 and drifts[0].action == "replan"
    (rem,) = [r for r in pol.taken if r.action == "replan"]
    assert rem.applied
    man = _health_run(PORT, mshape, xs, None)
    assert man.taken == ()
    res_man = man.mgr.replan(man.mon, threshold=0.5, hysteresis=0.05)
    assert _plain(rem.result) == _plain(res_man)
    assert _manager_state(pol.mgr) == _manager_state(man.mgr) == \
        _manager_state(ref.mgr)
    multi_leaf = pol.mgr.fabric_pools.get(1, 0) >= 2
    assert rem.result.replanned == multi_leaf
    again = man.mgr.replan(man.mon, threshold=0.5, hysteresis=0.05)
    assert not again.replanned and again.reason == "no cheaper tree"
    # every tenant's next reduction: policy == manual == the reference's,
    # and the canary keeps its bits across the replan
    after_pol = _reduce_tenants(PORT, pol.mgr, pol.tm, mshape, xs, pol.plan)
    after_man = _reduce_tenants(PORT, man.mgr, man.tm, mshape, xs, man.plan)
    after_ref = _reduce_tenants(REF, ref.mgr, ref.tm, mshape, xs, ref.plan)
    for t in after_pol:
        assert np.array_equal(after_pol[t], after_man[t]), t
        assert np.array_equal(after_pol[t], after_ref[t]), t
    assert np.array_equal(after_pol["canary"], pol.outs["canary"])
    # determinism: another watched run, the same log
    again_run = _health_run(PORT, mshape, xs, DRIFT)
    assert again_run.hm.incidents_json() == pol.hm.incidents_json()
    # the mirrors agree with the log
    by_sev = {}
    for i in pol.hm.incidents:
        by_sev[i.severity] = by_sev.get(i.severity, 0) + 1
    for sev, n in by_sev.items():
        assert pol.tm.registry.value(f"health.incidents.{sev}") == n
    instants = [e for e in pol.tm.tracer.events
                if e["name"] == "health.incident"]
    assert len(instants) == len(pol.hm.incidents)
    assert all(e["track"] == "health" for e in instants)


@pytest.mark.parametrize("mshape", MESHES)
def test_health_recover_session_matches_jax(mshape):
    """A ``recover_session`` rule drains the lossy tenant: the manager
    and every tenant's next reduction are those of the manually
    recovered twin, and the reference's."""
    xs = _xs(mshape)
    pol = _health_run(PORT, mshape, xs, STORM)
    ref = _health_run(REF, mshape, xs, STORM)
    assert pol.hm.incidents_json() == ref.hm.incidents_json()
    assert [(r.action, r.applied, r.detail) for r in pol.taken] == [
        (r.action, r.applied, r.detail) for r in ref.taken]
    assert [(r.action, r.applied) for r in pol.taken] == [
        ("recover_session", True), ("recover_session", False)]
    man = _health_run(PORT, mshape, xs, None)
    assert coordinator.recover_session_failure(man.mgr, "lossy")
    assert _manager_state(pol.mgr) == _manager_state(man.mgr) == \
        _manager_state(ref.mgr)
    assert [s.tenant for s in pol.mgr.active()] == ["canary"]
    after_pol = _reduce_tenants(PORT, pol.mgr, pol.tm, mshape, xs, pol.plan)
    after_man = _reduce_tenants(PORT, man.mgr, man.tm, mshape, xs, man.plan)
    after_ref = _reduce_tenants(REF, ref.mgr, ref.tm, mshape, xs, ref.plan)
    for t in after_pol:
        assert np.array_equal(after_pol[t], after_man[t]), t
        assert np.array_equal(after_pol[t], after_ref[t]), t
    assert pol.tm.metrics_json() == ref.tm.metrics_json()


# ---------------------------------------------------------------------------
# The launcher's health pass.
# ---------------------------------------------------------------------------

VARIANTS = [dict(reproducible=True), dict(compression="int8"),
            dict(sparse_k_frac=0.01)]


def _counting(X):
    """Patch a package's ``Telemetry.create`` and ``HealthMonitor`` (as
    the launcher imports it from the package) to counting clocks."""
    orig = X.obs.Telemetry.create.__func__
    monitor = X.obs.HealthMonitor
    return (mock.patch.object(
                X.obs.Telemetry, "create",
                classmethod(lambda cls, clock_=None, ring=None: orig(
                    cls, clock=X.obs.counting_clock(), ring=ring))),
            mock.patch.object(X.obs, "HealthMonitor", functools.partial(
                monitor, clock=X.obs.counting_clock())))


def _ref_rep_shapes():
    jmcfg = jrules.MeshCfg(("pod", "data", "model"), (2, 4, 1))
    model = jregistry.get_model(jtl.SMOKE.scaled(dtype=jnp.float32))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    _, _, dims = jrules.param_specs(shapes, jmcfg)
    return [jax.ShapeDtypeStruct((2, 4) + l.shape, l.dtype)
            for l, d in zip(jax.tree.leaves(shapes), jax.tree.leaves(dims))
            if d < 0]


def _ref_launcher_exports(argv, tmp_path):
    """The reference launcher's recording sequence for ``argv`` in one
    process (its ``_step_span``, each job's ``GradReducer`` traced where
    the launcher traces it, the ``--congestion-replan`` pass, ``_health``
    and ``_export``); returns its incident log, trace and metrics."""
    from repro.launch import train as jlaunch
    with mock.patch.object(sys, "argv", ["train", *argv]):
        args = jlaunch._parse()
    args.trace_out = str(tmp_path / "ref_t.json")
    args.metrics_out = str(tmp_path / "ref_m.json")
    args.incidents_out = str(tmp_path / "ref_i.json")
    create, hmon = _counting(REF)
    with create:
        tm = jlaunch._telemetry(args)
    rep = _ref_rep_shapes()
    mgr = None
    plan = jlaunch._fault_plan(args)
    if args.tenants > 1:
        mgr = jruntime.SessionManager(AXES, (2, 4),
                                      policy=args.partition_policy,
                                      order=args.schedule_order,
                                      max_sessions=max(8, 2 * args.tenants),
                                      telemetry=tm)
        cfgs = [jengine.FlareConfig(axes=AXES, transport="innetwork",
                                    fault_plan=plan, telemetry=tm,
                                    **VARIANTS[k % 3])
                for k in range(args.tenants)]
        names = [f"job{k}" for k in range(args.tenants)]
    else:
        cfgs = [jengine.FlareConfig(
            axes=AXES, algorithm=args.algorithm,
            reproducible=args.reproducible, transport=args.transport,
            fault_plan=plan, telemetry=tm)]
        names = [None]

    def trace(cfg, name):
        red = jengine.GradReducer(cfg, manager=mgr, tenant=name)
        jax.eval_shape(_nested(lambda g: red(g, red.init_state(g))), rep)
    if mgr is not None:
        for cfg, name in zip(cfgs, names):
            trace(cfg, name)
    for step in range(args.steps):
        with jlaunch._step_span(tm, step):
            if step == 0:
                for cfg, name in zip(cfgs, names):
                    trace(cfg, name)
    if mgr is not None:
        mgr.report()
        if args.congestion_replan > 0:
            mon = jruntime.CongestionMonitor(mgr, registry=tm.registry)
            mon.inject((1, 0), args.congestion_replan)
            mgr.replan(mon, threshold=0.5, hysteresis=0.05)
            mgr.report()
    with mock.patch("builtins.print"), hmon:
        jlaunch._health(args, tm, mgr)
        jlaunch._export(args, tm, mgr)
    return tuple(open(p).read() for p in (args.incidents_out,
                                          args.trace_out, args.metrics_out))


@pytest.mark.parametrize("flags", [
    ["--transport", "innetwork", "--reproducible", "--fault-rate", "0.02",
     "--steps", "2", "--health-policy", "observe"],
    ["--tenants", "3", "--steps", "2", "--fault-rate", "0.02",
     "--congestion-replan", "0.9", "--health-policy", "auto"]],
    ids=["observe one job", "auto tenants"])
def test_launcher_health_exports_match_jax(flags, tmp_path, capsys):
    argv = ["--smoke", "--mesh", "2x4x1", *flags]
    paths = [tmp_path / n for n in ("i.json", "t.json", "m.json")]
    create, hmon = _counting(PORT)
    with create, hmon:
        losses = launch_train.main([*argv, "--device", "cpu",
                                    "--incidents-out", str(paths[0]),
                                    "--trace-out", str(paths[1]),
                                    "--metrics-out", str(paths[2])])
    assert np.isfinite(losses).all()
    out = capsys.readouterr().out
    assert "== health ==" in out and f"incidents -> {paths[0]}" in out
    want = _ref_launcher_exports(argv, tmp_path)
    for path, text in zip(paths, want):
        assert path.read_text() == text, path.name
    log = json.loads(paths[0].read_text())
    # the fabric's faults are seen; the health pass runs before the
    # modeled tracks exist and on a fresh monitor, so neither the
    # divergence detector nor the replan's injection raises anything
    assert {r["detector"] for r in log} == {"fault_storm"}
    if "auto" in flags:
        assert "  -> " in out
