"""The port's flight recorder against the JAX package's.

Every test runs one scenario through both packages (``_both``) and asks
for equal outcomes: the registry's and the tracer's exports byte for
byte, ``str()`` of the manager reports, the report CLI's output and exit
codes, error types and texts.  Tolerance zero: the recorder is plain
Python over equal counters.

* **Host tests**: the counterparts of ``tests/test_obs.py``'s thirty.
* **The ``obs`` group** of ``tests/multidevice_checks.py`` on ``(2, 4)``
  and ``(1, 8)``: a reproducible and a lossy dense tenant on one shared
  switch, under a counting clock.  Two port runs export the same bytes,
  which are the reference's (its transports under nested ``jax.vmap``,
  traced once, as the group's ``jit`` traces them); the reductions are
  bitwise the same with and without telemetry, and the reference's; the
  counters equal ``tree_counters`` and the static ``FaultSchedule``s.
* **The launcher**: ``--trace-out`` / ``--metrics-out`` on one job and
  with ``--tenants 3`` export the reference launcher's bytes under a
  counting clock.  The reference's side is its launcher's recording
  sequence in one process: its ``_step_span`` and ``_export``, and each
  job's ``GradReducer`` traced where the launcher traces it (once in the
  step-0 span; with ``--tenants``, once more in the registration pass).
"""
import dataclasses
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
from repro.core import transports as jtransports
from repro.models import registry as jregistry
from repro.obs import report as jreport
from repro.obs import timeline as jtimeline
from repro.perfmodel import switch_model as jsm
from repro.sharding import rules as jrules
from repro.switch import dataplane as jdp
from repro.switch import packets as jpk
from repro_torch import obs, runtime
from repro_torch.convert import tensor_from_numpy
from repro_torch.core import transports
from repro_torch.core.engine import FlareConfig
from repro_torch.launch import train as launch_train
from repro_torch.mesh import RankMesh
from repro_torch.obs import report, timeline
from repro_torch.perfmodel import switch_model as sm
from repro_torch.switch import dataplane, packets as pk

torch.set_num_threads(1)

AXES = ("pod", "data")
MESHES = [(2, 4), (1, 8)]
_INT = {1: np.int8, 2: np.int16, 4: np.int32}

PORT = types.SimpleNamespace(obs=obs, report=report, timeline=timeline,
                             rt=runtime, dp=dataplane, pk=pk, sm=sm,
                             f32=torch.float32, FlareConfig=FlareConfig,
                             i32=lambda v: torch.tensor(v, dtype=torch.int32))
REF = types.SimpleNamespace(obs=jobs, report=jreport, timeline=jtimeline,
                            rt=jruntime, dp=jdp, pk=jpk, sm=jsm,
                            f32=jnp.float32, FlareConfig=jengine.FlareConfig,
                            i32=jnp.int32)


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


def _open_two(X, mgr):
    mgr.open("a", mode="dense", num_buckets=2, bucket_elems=256,
             dtype=X.f32)
    mgr.open("b", mode="sparse", num_buckets=2, bucket_elems=512,
             dtype=X.f32, k=16)


def _cli(X, argv, capsys):
    """The report CLI's exit code, stdout and stderr."""
    capsys.readouterr()
    try:
        code = X.report.main(argv)
    except SystemExit as e:
        code = ("exit", e.code)
    out = capsys.readouterr()
    return code, out.out, out.err


# ---------------------------------------------------------------------------
# Registry.
# ---------------------------------------------------------------------------

def test_registry_instruments_and_strict_kinds():
    def run(X):
        reg = X.obs.MetricsRegistry()
        out = [reg.counter("a.pkts").inc(3), reg.counter("a.pkts").inc()]
        reg.gauge("a.level").set(0.5)
        reg.gauge("a.level").set(1.5)
        reg.histogram("a.dur").record(2.0)
        reg.histogram("a.dur").record(4.0)
        h = reg.histogram("a.dur")
        out += [reg.value("a.pkts"), reg.value("a.level"),
                reg.value("a.missing", default=7), "a.pkts" in reg,
                "a.missing" in reg, reg.names("a."),
                (h.count, h.sum, h.min, h.max, h.mean), reg.to_json()]
        out.append(_outcome(lambda _: reg.gauge("a.pkts"), X))
        out.append(_outcome(lambda _: reg.counter("a.pkts").inc(-1), X))
        return out
    out = _both(run)
    assert out[:2] == [3, 4] and out[7] == ["a.dur", "a.level", "a.pkts"]
    assert out[-2][:2] == ("raise", "TypeError") and "is a counter" in \
        out[-2][2]
    assert "cannot decrease" in out[-1][2]


def test_registry_rejects_traced_values():
    """A tensor that is not on the CPU (here a ``meta`` one; on the card a
    CUDA one, whose ``float()`` would sync it) is refused with the
    reference's message for a traced value."""
    reg = obs.MetricsRegistry()
    with pytest.raises(TypeError, match="concrete host scalars"):
        reg.counter("bad").inc(torch.empty((), dtype=torch.int32,
                                           device="meta"))
    with pytest.raises(TypeError, match="concrete host scalars"):
        reg.gauge("bad.g").set(torch.empty((), device="meta"))
    jreg = jobs.MetricsRegistry()

    def leak(x):
        jreg.counter("bad").inc(x)
        return x
    with pytest.raises(TypeError, match="concrete host scalars"):
        jax.make_jaxpr(leak)(jnp.int32(1))
    # a tensor on the CPU is a host scalar
    assert reg.counter("ok").inc(torch.tensor(3, dtype=torch.int32)) == 3
    assert "bad" not in jreg.as_dict() or jreg.value("bad") == 0


def test_registry_export_deterministic():
    def build(X):
        reg = X.obs.MetricsRegistry()
        reg.counter("z.late").inc(2)
        reg.gauge("a.early").set(1.0)
        reg.observe_tree("plane.t", {"retransmits": X.i32(5),
                                     "delivered": 9})
        return reg
    a = _both(lambda X: build(X).to_json())
    assert a == build(PORT).to_json()
    reg = build(PORT)
    assert list(reg.as_dict()) == sorted(reg.as_dict())
    assert reg.value("plane.t.retransmits") == 5
    assert reg.value("plane.t.delivered") == 9


# ---------------------------------------------------------------------------
# Tracer.
# ---------------------------------------------------------------------------

def _trace_build(X):
    tr = X.obs.Tracer(clock=X.obs.counting_clock())
    with tr.span("plane.l1", track="plane/t", process="trace",
                 args={"fanin": 4}):
        tr.instant("plane.retry.l1", track="plane/t", process="trace",
                   args={"rounds": 2})
    tr.span_at("model.drain", 0.0, 12.5, track="model/t",
               args={"packets": 64})
    return tr


def test_tracer_chrome_export_byte_stable():
    metrics = {"m": {"type": "counter", "value": 1}}
    text = _both(lambda X: _trace_build(X).to_json(metrics=metrics))
    assert _trace_build(PORT).to_json() == _trace_build(PORT).to_json()
    doc = json.loads(text)
    evs = doc["traceEvents"]
    assert doc["metrics"] == metrics
    procs = {e["args"]["name"] for e in evs
             if e.get("ph") == "M" and e["name"] == "process_name"}
    assert {"trace", "modeled"} <= procs
    x = [e for e in evs if e["ph"] == "X" and e["name"] == "plane.l1"][0]
    assert x["args"] == {"fanin": 4} and x["dur"] > 0


def test_tracer_ring_keeps_last_events():
    def run(X):
        tr = X.obs.Tracer(clock=X.obs.counting_clock(), ring=2)
        for i in range(5):
            tr.instant(f"e{i}")
        return tr.to_json()
    names = [e["name"] for e in json.loads(_both(run))["traceEvents"]
             if e.get("ph") == "i"]
    assert names == ["e3", "e4"]


def test_tracer_end_without_begin_raises():
    def run(X):
        X.obs.Tracer(clock=X.obs.counting_clock()).end()
    with pytest.raises(RuntimeError, match="without a matching begin"):
        _both(run)


# ---------------------------------------------------------------------------
# ManagerReport.
# ---------------------------------------------------------------------------

def test_manager_report_idle_string_pinned():
    rep = _both(lambda X: str(_mgr(X).report()))
    assert rep == "switch idle: no sessions"
    assert isinstance(_mgr(PORT).report(), obs.ManagerReport)


def test_manager_report_fields_pinned():
    def run(X):
        mgr = _mgr(X, max_sessions=4)
        _open_two(X, mgr)
        mgr.open("c", mode="int8", num_buckets=1, bucket_elems=256,
                 dtype=X.f32)
        assert mgr.evict("c", reason="testing the audit trail")
        res = mgr.replan(X.rt.CongestionMonitor(mgr), threshold=0.5,
                         hysteresis=0.05)
        return mgr.report(), res
    rep, res = _both(run)
    assert rep.admissions == 3
    assert rep.evictions == (("c", "testing the audit trail"),)
    assert rep.replans == ((res.replanned, res.reason),)
    assert [t.tenant for t in rep.tenants] == ["a", "b"]
    assert sum(t.share for t in rep.tenants) == pytest.approx(1.0)


def test_manager_report_string_matches_legacy_format():
    def run(X):
        mgr = _mgr(X)
        _open_two(X, mgr)
        return str(mgr.report())
    rep = _both(run)
    head, *rows = rep.splitlines()
    assert head.startswith("switch: ") and "2/8 sessions" in head
    assert len(rows) == 2 and all("pkt/cy" in r for r in rows)


def test_lossy_session_report_carries_retransmits():
    def run(X):
        mgr = _mgr(X)
        mgr.open("t", mode="dense", num_buckets=4, bucket_elems=256,
                 dtype=X.f32, fault_plan=X.pk.FaultPlan(seed=1, drop=0.2))
        return mgr.report(), mgr.session("t").retransmit_packets
    rep, retrans = _both(run)
    assert rep.tenants[0].retransmits == retrans > 0


# ---------------------------------------------------------------------------
# Congestion: registry gauges == raw schedules.
# ---------------------------------------------------------------------------

def test_congestion_monitor_registry_equals_raw():
    def run(X):
        tm = X.obs.Telemetry.create(clock=X.obs.counting_clock())
        mgr = _mgr(X, telemetry=tm)
        _open_two(X, mgr)
        mgr.schedule()
        raw = X.rt.CongestionMonitor(mgr)
        fed = X.rt.CongestionMonitor(mgr, registry=tm.registry)
        for mon in (raw, fed):
            mon.inject((1, 0), 2.0)
        out = (fed.observe().hotness, raw.observe().hotness,
               fed.observe().peak(), raw.observe().peak())
        return out, tm.metrics_json(), tm.trace_json()
    (fed, raw, pf, pr), metrics, _ = _both(run)
    assert fed == raw and pf == pr
    assert json.loads(metrics)[f"congestion.{obs.slot_name(1, 0)}.hotness"][
        "value"] == raw[(1, 0)]


def test_congestion_monitor_registry_idle_manager():
    def run(X):
        mgr = _mgr(X)
        _open_two(X, mgr)
        fed = X.rt.CongestionMonitor(mgr, registry=X.obs.MetricsRegistry())
        return fed.observe().hotness, X.rt.CongestionMonitor(
            mgr).observe().hotness
    fed, raw = _both(run)
    assert fed == raw


# ---------------------------------------------------------------------------
# Counters integer-equal to the static sources.
# ---------------------------------------------------------------------------

def test_switch_counters_integer_equal_to_plan_counters():
    def run(X):
        tm = X.obs.Telemetry.create()
        pc = X.dp.plan_counters(("data",), (8,), 3, 2048, X.f32)
        tm.record_switch_counters("t", pc)
        return tm.metrics_json(), pc
    text, pc = _both(run)
    reg = json.loads(text)
    for i, lvl in enumerate(pc.levels):
        pre = f"switch.t.l{i + 1}"
        assert reg[f"{pre}.ingress_packets"] == {
            "type": "counter", "value": lvl.ingress_packets}
        assert reg[f"{pre}.combines"]["value"] == lvl.combines
    assert reg["switch.t.blocks"]["value"] == pc.blocks
    assert reg["switch.t.total_combines"]["value"] == pc.total_combines


def test_fault_schedule_counters_integer_equal():
    def run(X):
        plan = X.pk.FaultPlan(seed=1, drop=0.05, duplicate=0.2)
        counts = X.dp.level_packet_counts([4, 2], 3, 512, X.f32)
        scheds = [s for s in X.dp.fault_schedules(plan, counts)
                  if s is not None]
        tm = X.obs.Telemetry.create()
        tm.record_fault_schedules("t", X.dp.fault_schedules(plan, counts))
        tm2 = X.obs.Telemetry.create()
        tm2.record_fault_schedules("t", [None, None])
        return (tm.metrics_json(), sum(s.retransmits for s in scheds),
                tm2.registry.names())
    text, retrans, empty = _both(run)
    assert json.loads(text)["tenant.t.retransmits"]["value"] == retrans
    assert empty == []


def test_admission_records_once_per_session():
    def run(X):
        tm = X.obs.Telemetry.create(clock=X.obs.counting_clock())
        mgr = _mgr(X, telemetry=tm)
        _open_two(X, mgr)
        once = tm.registry.value("switch.a.l1.ingress_packets")
        again = mgr.attach("a", mode="dense", num_buckets=2,
                           bucket_elems=256, dtype=X.f32)
        assert again is mgr.session("a")
        return (once, tm.registry.value("switch.a.l1.ingress_packets"),
                tm.registry.value("manager.admissions"), tm.trace_json())
    once, after, admissions, _ = _both(run)
    assert once == after and admissions == 2


# ---------------------------------------------------------------------------
# Export and the summary CLI.
# ---------------------------------------------------------------------------

def _exported(X, tmp_path):
    tm = X.obs.Telemetry.create(clock=X.obs.counting_clock())
    mgr = _mgr(X, telemetry=tm)
    _open_two(X, mgr)
    mgr.schedule()
    X.rt.CongestionMonitor(mgr, registry=tm.registry).observe()
    tag = "port" if X is PORT else "ref"
    mpath = str(tmp_path / f"m_{tag}.json")
    tpath = str(tmp_path / f"t_{tag}.json")
    tm.export_metrics(mpath)
    tm.export_trace(tpath)
    return mpath, tpath


def test_export_artifacts_are_valid_json(tmp_path):
    (mp, tp), (mr, tr) = _exported(PORT, tmp_path), _exported(REF, tmp_path)
    for a, b in ((mp, mr), (tp, tr)):
        assert open(a).read() == open(b).read()
    metrics, trace = json.load(open(mp)), json.load(open(tp))
    assert any(n.startswith("tenant.a.sched.") for n in metrics)
    assert any(n.startswith("congestion.") for n in metrics)
    assert trace["metrics"] == metrics
    assert any(e.get("name") == "session.admit"
               for e in trace["traceEvents"])


def test_report_cli_renders_tables(tmp_path, capsys):
    mine = _cli(PORT, list(_exported(PORT, tmp_path)), capsys)
    assert mine == _cli(REF, list(_exported(REF, tmp_path)), capsys)
    code, out, _ = mine
    assert code == 0
    assert "== per-tenant ==" in out and "== per-slot congestion ==" in out
    for tenant in ("a", "b"):
        assert f"\n{tenant}" in out
    assert obs.slot_name(1, 0) in out
    assert "spans on" in out and "tracks ==" in out


def test_report_cli_reads_metrics_from_trace(tmp_path, capsys):
    mine = _cli(PORT, [_exported(PORT, tmp_path)[1]], capsys)
    assert mine == _cli(REF, [_exported(REF, tmp_path)[1]], capsys)
    assert mine[0] == 0 and "no per-tenant metrics" not in mine[1]


# ---------------------------------------------------------------------------
# Histogram percentiles.
# ---------------------------------------------------------------------------

def test_histogram_percentiles_nearest_rank():
    def run(X):
        h = X.obs.MetricsRegistry().histogram("h")
        for v in range(1, 101):
            h.record(float(v))
        return ([h.percentile(p) for p in (50.0, 95.0, 99.0, 0.0, 100.0)],
                h.snapshot(), _outcome(lambda _: h.percentile(101.0), X))
    pcts, snap, err = _both(run)
    assert pcts == [50.0, 95.0, 99.0, 1.0, 100.0]
    assert (snap["p50"], snap["p95"], snap["p99"]) == (50.0, 95.0, 99.0)
    assert err[1] == "ValueError" and "[0, 100]" in err[2]


def test_histogram_percentiles_empty_and_order_insensitive():
    def run(X):
        h = X.obs.MetricsRegistry().histogram("h")
        out = [h.percentile(50.0), h.snapshot()["p99"]]
        for v in (9.0, 1.0, 5.0):
            h.record(v)
        return out + [h.percentile(50.0)]
    assert _both(run) == [None, None, 5.0]


def test_histogram_sample_cap_keeps_first_window():
    def run(X):
        h = X.obs.MetricsRegistry().histogram("h")
        h.SAMPLE_CAP = 4
        for v in range(10):
            h.record(float(v))
        return h.samples, (h.count, h.sum, h.max), h.percentile(99.0)
    samples, stream, p99 = _both(run)
    assert samples == [0.0, 1.0, 2.0, 3.0]
    assert stream == (10, 45.0, 9.0) and p99 == 3.0


# ---------------------------------------------------------------------------
# Timeline edge cases.
# ---------------------------------------------------------------------------

def test_timeline_idle_manager_renders_nothing():
    def run(X):
        tm = X.obs.Telemetry.create(clock=X.obs.counting_clock())
        return (X.timeline.manager_tracks(tm.tracer, _mgr(X, telemetry=tm)),
                tm.tracer.events)
    assert _both(run) == (0, ())


def _surviving_plan(X):
    counts = X.dp.level_packet_counts([4, 2], 3, 512, X.f32)
    for seed in range(200):
        cand = X.pk.FaultPlan(seed=seed, drop=0.05, duplicate=0.2)
        if X.dp.plan_survives(cand, counts):
            return cand
    raise AssertionError("no surviving plan")


def test_timeline_lossy_only_manager():
    def run(X):
        plan = _surviving_plan(X)
        tm = X.obs.Telemetry.create(clock=X.obs.counting_clock())
        mgr = _mgr(X, telemetry=tm)
        mgr.open("lossy", mode="dense", num_buckets=3, bucket_elems=512,
                 dtype=X.f32, fault_plan=plan)
        n = X.timeline.manager_tracks(tm.tracer, mgr)
        return n, tm.tracer.events, tm.trace_json()
    n, events, _ = _both(run)
    tracks = {e["track"] for e in events}
    assert {"fcfs/lossy", "model/lossy", "lossy/lossy"} <= tracks
    lossy = [e for e in events if e["track"] == "lossy/lossy"]
    assert n == 2 + len(lossy) and lossy


def test_timeline_on_ring_truncated_tracer_still_exports():
    def run(X):
        tm = X.obs.Telemetry(registry=X.obs.MetricsRegistry(),
                             tracer=X.obs.Tracer(
                                 clock=X.obs.counting_clock(), ring=3))
        mgr = _mgr(X, telemetry=tm)
        _open_two(X, mgr)
        n = X.timeline.manager_tracks(tm.tracer, mgr)
        return n, tm.tracer.to_json(metrics=tm.registry.as_dict())
    n, text = _both(run)
    doc = json.loads(text)
    assert n > 3
    assert "thread_name" in {e["name"] for e in doc["traceEvents"]}
    kept = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    assert len(kept) == 3 and all(e["dur"] >= 0.0 for e in kept)


# ---------------------------------------------------------------------------
# Report CLI: histograms, incidents, --fail-on.
# ---------------------------------------------------------------------------

def test_report_cli_renders_histogram_section(tmp_path, capsys):
    def path(X):
        tm = X.obs.Telemetry.create(clock=X.obs.counting_clock())
        mgr = _mgr(X, telemetry=tm)
        _open_two(X, mgr)
        for v in (1.0, 2.0, 3.0, 100.0):
            tm.registry.histogram("step.dur_us").record(v)
        p = str(tmp_path / f"m_{'port' if X is PORT else 'ref'}.json")
        tm.export_metrics(p)
        return p
    mine = _cli(PORT, [path(PORT)], capsys)
    assert mine == _cli(REF, [path(REF)], capsys)
    code, out, _ = mine
    assert code == 0 and "== histograms ==" in out
    assert "step.dur_us" in out and "p95" in out and "100.0000" in out


def _incident_log(tmp_path, worst="warning"):
    """An incident log written by the reference's health plane (the
    port's writes the same bytes: ``tests/test_torch_health.py``), which
    both CLIs render."""
    tm = jobs.Telemetry.create(clock=jobs.counting_clock())
    tm.registry.counter("tenant.t.retransmits").inc(7)
    if worst == "critical":
        tm.registry.gauge("congestion.l1s0.hotness").set(1.5)
    hm = jobs.HealthMonitor(tm, clock=jobs.counting_clock())
    hm.poll()
    path = str(tmp_path / f"incidents_{worst}.json")
    hm.export_incidents(path)
    return path


def test_report_cli_renders_incident_log(tmp_path, capsys):
    argv = ["--incidents", _incident_log(tmp_path)]
    mine = _cli(PORT, argv, capsys)
    assert mine == _cli(REF, argv, capsys)
    code, out, _ = mine
    assert code == 0 and "== incidents ==" in out
    assert "[warning] fault_storm tenant=t:" in out
    assert "evidence: tenant.t.retransmits=7" in out


def test_report_cli_fail_on_gates_exit_code(tmp_path, capsys):
    hot = _incident_log(tmp_path, worst="critical")
    calm = _incident_log(tmp_path)
    for argv, code in ((["--incidents", hot, "--fail-on", "warning"], 1),
                       (["--incidents", hot, "--fail-on", "critical"], 1),
                       (["--incidents", calm, "--fail-on", "critical"], 0)):
        mine = _cli(PORT, argv, capsys)
        assert mine == _cli(REF, argv, capsys)
        assert mine[0] == code
        if code:
            assert "FAIL:" in mine[2]


def test_report_cli_argument_validation(tmp_path, capsys):
    for argv in ([], [str(tmp_path / "m.json"), "--fail-on", "warning"],
                 ["--incidents", "x.json", "--fail-on", "fatal"]):
        mine = _cli(PORT, argv, capsys)
        ref = _cli(REF, argv, capsys)
        assert mine[0] == ref[0] == ("exit", 2)
        # the error line, which names each package's own module
        assert mine[2].splitlines()[-1].replace("repro_torch.", "repro.") \
            == ref[2].splitlines()[-1]
    assert obs.severity_rank("critical") == jobs.severity_rank("critical")
    assert obs.SEVERITIES == jobs.SEVERITIES
    with pytest.raises(ValueError, match="unknown severity"):
        obs.severity_rank("fatal")


def test_report_cli_metrics_and_incidents_together(tmp_path, capsys):
    ipath = _incident_log(tmp_path)
    mine = _cli(PORT, [_exported(PORT, tmp_path)[0], "--incidents", ipath],
                capsys)
    ref = _cli(REF, [_exported(REF, tmp_path)[0], "--incidents", ipath],
               capsys)
    assert mine == ref
    assert "== per-tenant ==" in mine[1] and "== incidents ==" in mine[1]


# ---------------------------------------------------------------------------
# Config neutrality and the package surface.
# ---------------------------------------------------------------------------

def test_flare_config_telemetry_is_not_a_cache_key():
    bare = FlareConfig(axes=("data",))
    wired = FlareConfig(axes=("data",), telemetry=obs.Telemetry.create())
    assert bare == wired
    assert hash(bare) == hash(wired)
    assert "telemetry" not in repr(wired)
    t = transports.from_config(wired, RankMesh((1, 8)), torch.float32)
    assert t.telemetry is wired.telemetry
    assert t == transports.from_config(bare, RankMesh((1, 8)),
                                       torch.float32)
    # the port has the reference's whole surface, the health plane's
    # (ROADMAP queue 1 item 13) included
    assert set(obs.__all__) <= set(jobs.__all__)
    assert sorted(set(jobs.__all__) - set(obs.__all__)) == []


# ---------------------------------------------------------------------------
# The obs group: two tenants on a shared switch, on both meshes.
# ---------------------------------------------------------------------------

B, S = 3, 64


def _obs_plan(X, fanins):
    counts = X.dp.level_packet_counts(fanins, B, S, X.f32)
    for seed in range(200):
        cand = X.pk.FaultPlan(seed=seed, drop=0.05, duplicate=0.2)
        scheds = [s for s in X.dp.fault_schedules(cand, counts)
                  if s is not None]
        if (X.dp.plan_survives(cand, counts)
                and sum(s.retransmits for s in scheds) > 0):
            return cand, scheds
    raise AssertionError(f"no surviving fault seed for {counts}")


def _obs_run(X, mshape, xs, telemetry=True):
    """The group's ``one_run``: returns the telemetry, the manager and
    each tenant's reduction (``(*mesh, B, S)`` bits)."""
    pod, data = mshape
    fanins = [data, pod] if pod > 1 else [data]
    plan, _ = _obs_plan(X, fanins)
    tenants = [("det", dict(reproducible=True)),
               ("lossy", dict(fault_plan=plan))]
    tm = (X.obs.Telemetry.create(clock=X.obs.counting_clock())
          if telemetry else None)
    mgr = X.rt.SessionManager(AXES, mshape, seed=7, telemetry=tm)
    outs = {}
    for tenant, kw in tenants:
        cfg = X.FlareConfig(axes=AXES, transport="innetwork",
                            telemetry=tm, **kw)
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
                ef = jnp.zeros_like(x) if t.needs_state else None
                return t(x, ef, jnp.zeros((B,), jnp.int32), (S,) * B)[0]
            outs[tenant] = _bits(_nested(fn)(jnp.asarray(xs)))
    if tm is not None:
        mgr.schedule()
        X.timeline.manager_tracks(tm.tracer, mgr)
    return tm, mgr, outs


@pytest.mark.parametrize("mshape", MESHES)
def test_obs_group_matches_jax(mshape):
    rng = np.random.default_rng(97)
    xs = (rng.normal(size=mshape + (B, S)) * 1e2).astype(np.float32)
    tm1, mgr1, out1 = _obs_run(PORT, mshape, xs)
    tm2, _, out2 = _obs_run(PORT, mshape, xs)
    # determinism: two runs export the same bytes...
    assert tm1.trace_json() == tm2.trace_json()
    assert tm1.metrics_json() == tm2.metrics_json()
    # ...which are the reference's
    jtm, _, jout = _obs_run(REF, mshape, xs)
    assert tm1.trace_json() == jtm.trace_json()
    assert tm1.metrics_json() == jtm.metrics_json()
    # neutrality: the same bits with and without telemetry, and the
    # reference's
    _, _, bare = _obs_run(PORT, mshape, xs, telemetry=False)
    for t in out1:
        assert np.array_equal(out1[t], out2[t])
        assert np.array_equal(out1[t], bare[t])
        assert np.array_equal(out1[t], jout[t])
    # the counters: tree_counters, session demand, the static schedules
    reg = tm1.registry
    for tenant, repro_ in (("det", True), ("lossy", False)):
        want = dataplane.tree_counters(mgr1.tree, B, S, torch.float32,
                                       reproducible=repro_)
        for i, lvl in enumerate(want.levels):
            pre = f"switch.{tenant}.l{i + 1}"
            assert (reg.value(f"{pre}.ingress_packets"),
                    reg.value(f"{pre}.egress_packets"),
                    reg.value(f"{pre}.combines")) == (
                lvl.ingress_packets, lvl.egress_packets, lvl.combines)
        assert reg.value(f"switch.{tenant}.total_combines") == \
            want.total_combines
        assert reg.value(f"session.{tenant}.demand_bytes") == \
            runtime.session_demand_bytes(want)
    pod, data = mshape
    _, scheds = _obs_plan(PORT, [data, pod] if pod > 1 else [data])
    assert reg.value("tenant.lossy.retransmits") == \
        sum(s.retransmits for s in scheds)
    assert "tenant.det.retransmits" not in reg
    doc = json.loads(tm1.trace_json())
    evs = doc["traceEvents"]
    tracks = {e["args"]["name"] for e in evs
              if e.get("ph") == "M" and e["name"] == "thread_name"}
    for tenant in ("det", "lossy"):
        assert {f"plane/{tenant}", f"fcfs/{tenant}",
                f"model/{tenant}"} <= tracks
    retry = [e for e in evs if e.get("ph") == "i"
             and e["name"].startswith("plane.retry.")]
    assert sum(e["args"]["retransmits"] for e in retry) == \
        sum(s.retransmits for s in scheds)
    assert doc["metrics"] == reg.as_dict()


def test_grad_reducer_records_once_and_attach_records_the_registration():
    """The port's analogue of a trace: a reducer records its plane's
    spans and a solo transport's counters on its first call for a set of
    gradient shapes only, and a tenant's ``attach`` records what the
    reference's registration trace records."""
    from repro_torch.core.engine import GradReducer
    mesh = RankMesh((2, 4))
    tm = obs.Telemetry.create(clock=obs.counting_clock())
    red = GradReducer(FlareConfig(axes=AXES, transport="innetwork",
                                  reproducible=True, telemetry=tm), mesh)
    g = {"w": torch.ones(2, 4, 300)}
    red(g)
    first = (tm.trace_json(), tm.metrics_json())
    red(g)
    assert (tm.trace_json(), tm.metrics_json()) == first
    red({"w": torch.ones(2, 4, 600)})          # a new shape: a new trace
    assert len(tm.tracer) == 6
    # attach: the session's admission, then the plane's empty spans
    tm = obs.Telemetry.create(clock=obs.counting_clock())
    mgr = runtime.SessionManager(AXES, (2, 4), telemetry=tm)
    red = GradReducer(FlareConfig(axes=AXES, transport="innetwork",
                                  compression="int8", telemetry=tm), mesh,
                      manager=mgr, tenant="job")
    red.attach(g)
    assert [e["name"] for e in tm.tracer.events] == [
        "session.admit", "plane.l1", "plane.l2", "plane.multicast"]


# ---------------------------------------------------------------------------
# The launcher's exports.
# ---------------------------------------------------------------------------

VARIANTS = [dict(reproducible=True), dict(compression="int8"),
            dict(sparse_k_frac=0.01)]


def _counting(telemetry_cls, clock):
    """Patch a package's ``Telemetry.create`` to a counting clock."""
    orig = telemetry_cls.create.__func__
    return mock.patch.object(
        telemetry_cls, "create",
        classmethod(lambda cls, clock_=None, ring=None: orig(
            cls, clock=clock(), ring=ring)))


def _ref_rep_shapes():
    """The smoke model's replicated gradient leaves on ``(2, 4)``: what
    the reference's step hands its ``GradReducer``."""
    jmcfg = jrules.MeshCfg(("pod", "data", "model"), (2, 4, 1))
    model = jregistry.get_model(jtl.SMOKE.scaled(dtype=jnp.float32))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    _, _, dims = jrules.param_specs(shapes, jmcfg)
    return [jax.ShapeDtypeStruct((2, 4) + l.shape, l.dtype)
            for l, d in zip(jax.tree.leaves(shapes), jax.tree.leaves(dims))
            if d < 0]


def _ref_launcher_exports(argv, tmp_path):
    """The reference launcher's recording sequence for ``argv``, in one
    process (see the module docstring); returns its trace and metrics
    JSON."""
    from repro.launch import train as jlaunch
    with mock.patch.object(sys, "argv", ["train", *argv]):
        args = jlaunch._parse()
    args.trace_out = str(tmp_path / "ref_t.json")
    args.metrics_out = str(tmp_path / "ref_m.json")
    with _counting(jobs.Telemetry, jobs.counting_clock):
        tm = jlaunch._telemetry(args)
    rep = _ref_rep_shapes()
    mgr = None
    if args.tenants > 1:
        mgr = jruntime.SessionManager(AXES, (2, 4),
                                      policy=args.partition_policy,
                                      order=args.schedule_order,
                                      max_sessions=max(8, 2 * args.tenants),
                                      telemetry=tm)
        cfgs = [jengine.FlareConfig(axes=AXES, transport="innetwork",
                                    telemetry=tm, **VARIANTS[k % 3])
                for k in range(args.tenants)]
        names = [f"job{k}" for k in range(args.tenants)]
    else:
        cfgs = [jengine.FlareConfig(
            axes=AXES, algorithm=args.algorithm,
            reproducible=args.reproducible, transport=args.transport,
            telemetry=tm)]
        names = [None]

    def trace(cfg, name):
        red = jengine.GradReducer(cfg, manager=mgr, tenant=name)
        jax.eval_shape(_nested(lambda g: red(g, red.init_state(g))), rep)
    if mgr is not None:                       # the registration pass
        for cfg, name in zip(cfgs, names):
            trace(cfg, name)
    for step in range(args.steps):
        with jlaunch._step_span(tm, step):
            if step == 0:                     # the real build's trace
                for cfg, name in zip(cfgs, names):
                    trace(cfg, name)
    if mgr is not None:
        mgr.report()
    with mock.patch("builtins.print"):
        jlaunch._export(args, tm, mgr)
    return (open(args.trace_out).read(), open(args.metrics_out).read())


@pytest.mark.parametrize("flags", [
    ["--transport", "innetwork", "--reproducible", "--steps", "3"],
    ["--tenants", "3", "--steps", "2"]], ids=["one job", "tenants"])
def test_launcher_exports_match_jax(flags, tmp_path, capsys):
    argv = ["--smoke", "--mesh", "2x4x1", *flags]
    tpath, mpath = tmp_path / "t.json", tmp_path / "m.json"
    with _counting(obs.Telemetry, obs.counting_clock):
        losses = launch_train.main([*argv, "--device", "cpu", "--trace-out",
                                    str(tpath), "--metrics-out",
                                    str(mpath)])
    assert np.isfinite(losses).all()
    out = capsys.readouterr().out
    assert f"trace -> {tpath}" in out and f"metrics -> {mpath}" in out
    want_t, want_m = _ref_launcher_exports(argv, tmp_path)
    assert tpath.read_text() == want_t
    assert mpath.read_text() == want_m
    # and the report CLI renders them
    assert report.main([str(mpath), str(tpath)]) == 0
    assert "spans on" in capsys.readouterr().out
