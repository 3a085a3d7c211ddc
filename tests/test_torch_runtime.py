"""The port's multi-tenant switch runtime against the JAX package's.

Every test runs one scenario through both packages and asks for equal
outcomes (tolerance zero: the runtime is plain Python over equal counters):

* **Control plane** — the counterpart of ``tests/test_runtime.py``:
  partitions, interleaves, ``simulate_shared`` counters, admission
  decisions and their error texts, ``attach`` reuse and re-admission,
  ``rebind``, ``replan`` and its hysteresis, the congestion monitor and
  ``str(report)``; each scenario's outcome (values, or the exception's
  type and message) is the reference's.
* **Arrival permutations** — ``arrival_perms(t)[level](P, n)`` gives the
  reference's arrays for the same mix, epoch and seed (dtype names enter
  the seed), drawn once and cached.
* **Tensors** — the ``runtime`` and ``canary`` groups of
  ``tests/multidevice_checks.py`` on ``(2, 4)`` and ``(1, 8)``: three
  tenants (dense reproducible, int8, sparse) shared == solo == the
  manager-less plane == the reference's planes under nested ``jax.vmap``;
  an arrival-order tenant under contention bitwise the reference's;
  ``GradReducer`` tenants; the replan keeps the canary's bits.
* **Training** — the launcher's ``--tenants 3`` report against the
  reference manager's after the reference's own registration trace, and
  three jobs' train steps with ``reduce_manager=``.
"""
import dataclasses
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro import runtime as jruntime
from repro.configs import tinyllama_1_1b as jtl
from repro.core import engine as jengine
from repro.core import topology as jtopo
from repro.core import transports as jtransports
from repro.data import pipeline as jpipeline
from repro.models import registry as jregistry
from repro.perfmodel import network_sim as jns
from repro.perfmodel import switch_model as jsm
from repro.runtime import scheduler as jscheduler
from repro.sharding import rules as jrules
from repro.switch import dataplane as jdp
from repro.switch import packets as jpk
from repro.train import trainer as jtrainer
from repro_torch import runtime, tree
from repro_torch.configs import tinyllama_1_1b as tl
from repro_torch.convert import params_from_jax, tensor_from_numpy
from repro_torch.core import topology, transports
from repro_torch.core.engine import FlareConfig, GradReducer
from repro_torch.launch import train as launch_train
from repro_torch.mesh import RankMesh
from repro_torch.models.registry import get_model
from repro_torch.perfmodel import network_sim as ns
from repro_torch.perfmodel import switch_model as sm
from repro_torch.runtime import scheduler, sessions
from repro_torch.sharding import rules
from repro_torch.switch import dataplane, packets as pk
from repro_torch.train import trainer

torch.set_num_threads(1)

pytestmark = pytest.mark.runtime

AXES = ("pod", "data")
MESHES = [(2, 4), (1, 8)]
_INT = {1: np.int8, 2: np.int16, 4: np.int32}

#: the two packages behind one set of names
PORT = types.SimpleNamespace(rt=runtime, sc=scheduler, sm=sm, dp=dataplane,
                             topo=topology, pk=pk, ns=ns, f32=torch.float32,
                             bf16=torch.bfloat16, i32=torch.int32)
REF = types.SimpleNamespace(rt=jruntime, sc=jscheduler, sm=jsm, dp=jdp,
                            topo=jtopo, pk=jpk, ns=jns, f32=jnp.float32,
                            bf16=jnp.bfloat16, i32=jnp.int32)


def _plain(x):
    """A package-neutral, comparable image of a result."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(
            (f.name, _plain(getattr(x, f.name)))
            for f in dataclasses.fields(x))
    if isinstance(x, np.ndarray):
        return ("ndarray", x.dtype.str, x.shape, x.tobytes())
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
    kw.setdefault("max_sessions", 4)
    return X.rt.SessionManager(AXES, (2, 4), **kw)


# ---------------------------------------------------------------------------
# Partition policies.
# ---------------------------------------------------------------------------

_weights = st.dictionaries(
    st.sampled_from([f"t{i}" for i in range(8)]),
    st.floats(0.1, 10.0, allow_nan=False), min_size=1, max_size=8)


@given(_weights, st.integers(8, 128))
@settings(max_examples=40, deadline=None)
def test_weighted_fair_matches_jax(weights, clusters):
    part = _both(lambda X: X.rt.weighted_fair_partition(weights, clusters))
    assert part.allocated == clusters
    assert all(part.clusters(t) >= 1 for t in weights)


@given(_weights, st.integers(8, 64), st.data())
@settings(max_examples=40, deadline=None)
def test_greedy_matches_jax(weights, clusters, data):
    queued = {t: data.draw(st.integers(0, 5), label=f"queued[{t}]")
              for t in weights}
    part = _both(lambda X: X.rt.greedy_partition(weights, clusters, queued))
    if any(queued.values()):
        assert sum(part.clusters(t) for t in weights if queued[t]) == clusters


@given(_weights, st.integers(16, 128), st.integers(8, 16))
@settings(max_examples=30, deadline=None)
def test_static_partition_matches_jax(weights, clusters, max_sessions):
    part = _both(lambda X: X.rt.static_partition(weights, clusters,
                                                 max_sessions))
    assert all(part.clusters(t) == clusters // max_sessions for t in weights)


@pytest.mark.parametrize("call", [
    lambda X: X.rt.make_partition("fifo", {"a": 1.0}, 8),
    lambda X: X.rt.make_partition("static", {"a": 1.0}, 8),
    lambda X: X.rt.weighted_fair_partition({"a": 1.0, "b": 1.0, "c": 1.0}, 2),
    lambda X: X.rt.weighted_fair_partition({"a": 0.0}, 8),
    lambda X: X.rt.static_partition({f"t{i}": 1.0 for i in range(3)}, 16,
                                    max_sessions=2),
    lambda X: X.rt.static_partition({"a": 1.0}, 3, max_sessions=4),
    lambda X: X.rt.make_partition("greedy", {"a": 1.0, "b": 2.0}, 8),
    lambda X: X.rt.make_partition("static", {"a": 1.0}, 8, max_sessions=2),
    lambda X: X.rt.Partition(8, (X.rt.ClusterSlice("a", 0, 4),
                                 X.rt.ClusterSlice("b", 2, 4))).validate()])
def test_partition_dispatch_and_errors_match_jax(call):
    assert _outcome(call, PORT) == _outcome(call, REF)


# ---------------------------------------------------------------------------
# Scheduler.
# ---------------------------------------------------------------------------

@given(st.dictionaries(st.sampled_from(["a", "b", "c", "d"]),
                       st.integers(0, 40), min_size=1, max_size=4),
       st.sampled_from(["round_robin", "priority"]))
@settings(max_examples=40, deadline=None)
def test_interleave_and_shares_match_jax(packets, order):
    pr = {t: i % 3 for i, t in enumerate(packets)}
    seq = _both(lambda X: X.rt.interleave(packets, order, pr))
    _both(lambda X: X.rt.ingress_shares(packets, order))
    assert len(seq) == sum(packets.values())
    seen = {t: 0 for t in packets}
    for t, i in seq:
        assert i == seen[t]
        seen[t] += 1


def test_priority_interleave_and_errors_match_jax():
    seq = _both(lambda X: X.rt.interleave(
        {"lo": 3, "hi": 2, "mid": 1}, "priority",
        priorities={"lo": 0, "hi": 9, "mid": 5}))
    assert [t for t, _ in seq] == ["hi", "hi", "mid", "lo", "lo", "lo"]
    _both(lambda X: X.rt.ingress_shares({"a": 4096, "b": 512}))
    with pytest.raises(ValueError, match="unknown schedule order"):
        _both(lambda X: X.rt.interleave({"a": 1}, "lifo"))


def _load(X, tenant, *, b=2, s=2048, clusters=8, priority=0):
    counters = X.dp.tree_counters(X.topo.build_mesh_tree((8,)), b, s, X.f32)
    return X.rt.TenantLoad(tenant=tenant, counters=counters,
                           clusters=clusters, priority=priority)


@given(st.integers(1, 4), st.integers(0, 2**31 - 1),
       st.sampled_from(["round_robin", "priority"]))
@settings(max_examples=15, deadline=None)
def test_shared_counters_conserve_and_match_jax(n_tenants, seed, order):
    rng = np.random.default_rng(seed)
    shapes = [(int(rng.integers(1, 4)), int(rng.integers(1, 9)) * 512,
               int(rng.integers(0, 3))) for _ in range(n_tenants)]

    def run(X):
        loads = [_load(X, f"t{i}", b=b, s=s, priority=p)
                 for i, (b, s, p) in enumerate(shapes)]
        return (X.rt.simulate_shared(loads, order=order),
                [X.rt.simulate_shared([l]) for l in loads],
                [X.rt.service_tau(l.counters) for l in loads])
    shared, solos, _ = _both(run)
    for solo in solos:
        c = solo.counters[0]
        assert shared.tenant(c.tenant).combines == c.combines
        assert shared.tenant(c.tenant).packets == c.packets
    assert sum(c.packets for c in shared.counters) == len(shared.order)


def test_simulate_shared_rejects_non_work_conserving_like_jax():
    with pytest.raises(ValueError, match="work-conserving"):
        _both(lambda X: X.rt.simulate_shared([_load(X, "busy",
                                                     clusters=0)]))


def test_schedule_with_partial_backlog_under_greedy_matches_jax():
    def run(X):
        mgr = _mgr(X, policy="greedy")
        for t in ("a", "b"):
            mgr.open(t, mode="dense", num_buckets=2, bucket_elems=256,
                     dtype=X.f32)
        return mgr.schedule(queued={"a": 0, "b": 10})
    sched = _both(run)
    assert sched.tenant("a").packets == 0
    assert all(t == "b" for t, _ in sched.order)


# ---------------------------------------------------------------------------
# Admission control.
# ---------------------------------------------------------------------------

def _admission_script(X):
    """Opens and closes against every admission limit; what each did."""
    out = []

    def step(f):
        try:
            out.append(("ok", _plain(f())))
        except Exception as e:
            out.append(("raise", type(e).__name__, str(e)))
    one = dict(num_buckets=1, bucket_elems=256, dtype=X.f32)
    mgr = _mgr(X, max_sessions=2)
    step(lambda: mgr.open("a", mode="dense", **one))
    step(lambda: mgr.open("b", mode="int8", **one))
    step(lambda: mgr.open("c", mode="dense", **one))        # max sessions
    mgr.close("a")
    step(lambda: mgr.open("c", mode="dense", **one))
    step(lambda: mgr.open("c", mode="dense", **one))        # already open
    step(lambda: mgr.open("d", mode="bogus", **one))
    big = _mgr(X, params=X.sm.SwitchParams(clusters=2,
                                           l1_bytes_per_cluster=64 << 10))
    step(lambda: big.open("big", mode="dense", num_buckets=64,
                          bucket_elems=4096, dtype=X.f32))  # memory share
    step(lambda: big.open("small", mode="dense", **one))
    floor = _mgr(X, params=X.sm.SwitchParams(clusters=1), max_sessions=8)
    step(lambda: floor.open("a", mode="dense", **one))
    step(lambda: floor.open("b", mode="dense", **one))      # cluster floor
    step(lambda: _mgr(X, params=X.sm.SwitchParams(clusters=4),
                      policy="static", max_sessions=8))
    step(lambda: _mgr(X, policy="lottery"))
    step(lambda: _mgr(X, order="lifo"))
    step(lambda: X.rt.SessionManager(AXES, (8,)))
    ok = _mgr(X, params=X.sm.SwitchParams(clusters=8), policy="static")
    step(lambda: ok.open("a", mode="dense", **one))
    step(lambda: ok.partition())
    step(lambda: (mgr.bytes_per_session, mgr.memory_budget_bytes,
                  mgr.num_levels, mgr.fabric_pools, mgr.admissions,
                  mgr.weights(), [s.tenant for s in mgr.active()]))
    return out


def test_admission_control_matches_jax():
    out = _both(_admission_script)
    kinds = [o[0] for o in out]
    assert kinds == ["ok", "ok", "raise", "ok", "raise", "raise", "raise",
                     "ok", "ok", "raise", "raise", "raise", "raise", "raise",
                     "ok", "ok", "ok"]
    assert "predefined maximum" in out[2][2]
    assert "aggregation" in out[6][2] and "HPU clusters" in out[9][2]
    assert out[2][1] == out[6][1] == out[9][1] == "AdmissionError"


def test_session_demand_bytes_matches_jax_and_the_model():
    def run(X):
        mgr = _mgr(X)
        s = mgr.open("small", mode="dense", num_buckets=3, bucket_elems=4096,
                     dtype=X.bf16, reproducible=True)
        return s, X.rt.session_demand_bytes(s.counters), s.level_counts
    small, demand, _ = _both(run)
    c = small.counters
    m = max(l.buffers_per_block for l in c.levels)
    assert demand == int(np.ceil(m * c.blocks)) * c.packet_bytes
    assert small.dtype == "bfloat16" and small.counters.design == "tree"


def _attach_script(X):
    out = []
    mgr = _mgr(X)
    kw = dict(mode="dense", num_buckets=2, bucket_elems=256, dtype=X.f32)
    s1 = mgr.attach("t", **kw)
    s2 = mgr.attach("t", **kw)
    out.append(s1 is s2)                           # re-trace → same session
    s3 = mgr.attach("t", **dict(kw, num_buckets=4, bucket_elems=512))
    out += [s3, len(mgr.active())]
    for bad in (dict(tenant=None, mode="int8"), dict(tenant="t",
                                                     axes=("data",))):
        try:
            mgr.attach(**dict(dict(kw, tenant="t"), **bad))
        except ValueError as e:
            out.append(str(e))
    out += [mgr.new_tenant(), mgr.new_tenant()]
    sp1 = mgr.attach("sp", mode="sparse", num_buckets=2, bucket_elems=4096,
                     dtype=X.f32, k=16)
    sp2 = mgr.attach("sp", mode="sparse", num_buckets=2, bucket_elems=4096,
                     dtype=X.f32, k=1024)
    d1 = mgr.attach("d", mode="dense", num_buckets=1, bucket_elems=256,
                    dtype=X.f32)
    d2 = mgr.attach("d", mode="dense", num_buckets=1, bucket_elems=256,
                    dtype=X.f32, reproducible=True)
    out += [sp1, sp2, sp2 is not sp1, d1, d2, d2 is not d1,
            [s.tenant for s in mgr.active()], mgr.admissions]
    return out


def test_attach_reuse_and_readmission_match_jax():
    out = _both(_attach_script)
    assert out[0] and out[2] == 1
    assert "tenant name" in out[3] and "axes" in out[4]
    assert out[5] != out[6]
    assert out[9] and out[8].demand_bytes > out[7].demand_bytes
    assert out[12] and out[11].counters.design == "tree"


# ---------------------------------------------------------------------------
# Arrival permutations.
# ---------------------------------------------------------------------------

def _perm_script(X, seed):
    """Every tenant's permutation arrays, at several (P, n), through a
    change of mix and a rebind.  Sessions of every mode and of bf16 and
    int32 arenas, whose dtype names enter the tenant mix."""
    mgr = _mgr(X, seed=seed, max_sessions=8)
    out = []

    def draw():
        return [[[f(p, n) for p, n in ((4, 5), (2, 7), (8, 3))]
                 for f in mgr.arrival_perms(s.tenant)]
                for s in mgr.active()]
    mgr.open("a", mode="dense", num_buckets=2, bucket_elems=256, dtype=X.f32)
    out.append(mgr.arrival_perms("a"))                       # idle: None
    mgr.open("job0/bfloat16", mode="dense", num_buckets=3, bucket_elems=300,
             dtype=X.bf16, reproducible=True)
    out.append(draw())
    mgr.open("c", mode="int8", num_buckets=1, bucket_elems=1000, dtype=X.f32)
    mgr.open("d", mode="sparse", num_buckets=2, bucket_elems=512,
             dtype=X.f32, k=16)
    mgr.open("e", mode="dense", num_buckets=1, bucket_elems=64, dtype=X.i32)
    out.append(draw())
    mgr.rebind(mgr.tree)
    out.append(draw())
    mgr.close("c")
    out.append(draw())
    try:
        mgr.arrival_perms("nope")
    except KeyError as e:
        out.append(str(e))
    return out


@pytest.mark.parametrize("seed", [0, 3])
def test_arrival_perms_match_jax(seed):
    out = _both(lambda X: _perm_script(X, seed))
    assert out[0] is None
    p = out[1][0][0][0]
    assert p.shape == (4, 5)
    assert all(sorted(col) == [0, 1, 2, 3] for col in p.T)
    # the mix, the epoch and the tenant each re-roll the draw
    assert not np.array_equal(out[1][0][0][0], out[2][0][0][0])
    assert not np.array_equal(out[2][0][0][0], out[3][0][0][0])
    assert not np.array_equal(out[2][0][0][0], out[2][1][0][0])


def test_arrival_perms_are_drawn_once():
    mgr = _mgr(PORT, seed=5)
    for t in ("a", "b"):
        mgr.open(t, mode="dense", num_buckets=2, bucket_elems=256,
                 dtype=torch.float32)
    sessions._perm_draw.cache_clear()
    f = mgr.arrival_perms("a")[1]
    first = f(4, 300)
    assert sessions._perm_draw.cache_info().misses == 1
    assert f(4, 300) is first and mgr.arrival_perms("a")[1](4, 300) is first
    assert sessions._perm_draw.cache_info().hits == 2
    jf = _mgr(REF, seed=5)
    for t in ("a", "b"):
        jf.open(t, mode="dense", num_buckets=2, bucket_elems=256,
                dtype=jnp.float32)
    assert np.array_equal(first, jf.arrival_perms("a")[1](4, 300))


# ---------------------------------------------------------------------------
# Model ↔ scheduler, counters, report.
# ---------------------------------------------------------------------------

def _three(X, mgr, big=True):
    n, s = (8, 1 << 15) if big else (1, 512)
    mgr.open("dense", mode="dense", num_buckets=n, bucket_elems=s,
             dtype=X.f32, priority=2, reproducible=True)
    mgr.open("int8", mode="int8", num_buckets=n, bucket_elems=s,
             dtype=X.f32, priority=1)
    mgr.open("sparse", mode="sparse", num_buckets=n, bucket_elems=s,
             dtype=X.f32, k=2048 if big else 16)
    return mgr


@pytest.mark.parametrize("order", ["round_robin", "priority"])
@pytest.mark.parametrize("policy", ["weighted_fair", "static", "greedy"])
def test_shared_model_matches_scheduler_and_jax(order, policy):
    def run(X):
        mgr = _three(X, X.rt.SessionManager(AXES, (2, 4), policy=policy,
                                            order=order))
        return mgr.schedule(), mgr.predicted(), mgr.partition()
    sched, pred, _ = _both(run)
    pred = {p.tenant: p for p in pred}
    for c in sched.counters:
        p = pred[c.tenant]
        assert 0.5 * p.bandwidth_pkts < c.throughput_pkts \
            < 1.8 * p.bandwidth_pkts


def test_model_shared_bottleneck_split_matches_jax():
    pts = _both(lambda X: X.sm.model_shared([("fat", 32, 1024.0, 0.1),
                                             ("thin", 1, 1024.0, 0.9),
                                             ("idle", 0, 1024.0, 0.0)]))
    assert [p.bottleneck for p in pts[:2]] == ["line", "compute"]
    assert pts[2].bandwidth_pkts == 0.0


@pytest.mark.parametrize("sizes", [(8,), (2, 4), (4, 2)])
def test_tree_counters_match_plan_counters_and_jax(sizes):
    names = AXES[-len(sizes):]
    a, b = _both(lambda X: (
        X.dp.plan_counters(names, sizes, 3, 2048, X.f32),
        X.dp.tree_counters(X.topo.build_mesh_tree(sizes), 3, 2048, X.f32)))
    assert [(l.fanin, l.ingress_packets, l.combines) for l in a.levels] == \
        [(l.fanin, l.ingress_packets, l.combines) for l in b.levels]


def _report_script(X):
    mgr = _mgr(X)
    out = [str(mgr.report()), mgr.report()]
    mgr.open("a", mode="dense", num_buckets=1, bucket_elems=256, dtype=X.f32)
    mgr.open("b", mode="sparse", num_buckets=1, bucket_elems=512,
             dtype=X.f32, k=8)
    mgr.open("c", mode="int8", num_buckets=2, bucket_elems=300,
             dtype=X.bf16, fault_plan=X.pk.FaultPlan(seed=1, drop=0.2))
    mgr.evict("b", reason="test")
    mgr.replan(hotness={(1, 0): 2.0})
    out += [str(mgr.report()), mgr.report(), mgr.report().sessions,
            mgr.report().replan_reasons]
    return out


def test_report_matches_jax_byte_for_byte():
    out = _both(_report_script)
    assert out[0] == "switch idle: no sessions"
    assert "a:" in out[2] and "c:" in out[2] and "predicted" in out[2]
    assert out[3].evictions[0] == ("b", "test")


# ---------------------------------------------------------------------------
# Lossy sessions.
# ---------------------------------------------------------------------------

def _lossy_script(X):
    kw = dict(mode="dense", num_buckets=4, bucket_elems=256, dtype=X.f32)
    plan = X.pk.FaultPlan(seed=1, drop=0.2)
    clean, lossy = _mgr(X), _mgr(X)
    clean.open("t", **kw)
    lossy.open("t", **kw, fault_plan=plan)
    out = [lossy.session("t").retransmit_packets, clean.schedule(),
           lossy.schedule(), lossy.schedule(queued={"t": 5}),
           lossy.predicted(), lossy.partition()]
    mgr = _mgr(X)
    a = mgr.attach("t", **kw)
    b = mgr.attach("t", **kw, fault_plan=plan)
    out += [a.retransmit_packets, b.retransmit_packets,
            mgr.attach("t", **kw, fault_plan=X.pk.FaultPlan(seed=1,
                                                            drop=0.2)) is b]
    out.append(mgr.rebind(X.topo.build_tree(8, 4)))
    out.append(mgr.session("t"))
    sp = _mgr(X)
    sp.open("s", mode="sparse", num_buckets=2, bucket_elems=4096,
            dtype=X.f32, fault_plan=plan)
    out.append(sp.session("s"))
    return out


def test_lossy_sessions_match_jax():
    out = _both(_lossy_script)
    assert out[0] > 0
    assert out[2].tenant("t").packets == out[1].tenant("t").packets + out[0]
    assert out[3].tenant("t").packets == 5 + out[0]
    assert out[6] == 0 and out[7] > 0 and out[8]
    assert out[9] == (("t",), ()) and out[10].retransmit_packets > 0


# ---------------------------------------------------------------------------
# Congestion-aware replanning.
# ---------------------------------------------------------------------------

def _open_two(X, mgr):
    mgr.open("a", mode="dense", num_buckets=2, bucket_elems=256,
             dtype=X.f32, reproducible=True)
    mgr.open("b", mode="sparse", num_buckets=2, bucket_elems=512,
             dtype=X.f32, k=16)
    return mgr


def _replan_outcome(mgr, res):
    return (res, mgr._epoch, mgr.tree, [s.tenant for s in mgr.active()],
            mgr.replans, mgr.evictions, res.improvement_x)


@pytest.mark.parametrize("hot,kw", [
    ({(1, 0): 0.3}, {}),                              # below threshold
    ({(1, 0): 2.0}, {}),                              # routes around
    ({(1, 0): 2.0}, dict(hysteresis=1e9)),            # hysteresis
    ({(1, 1): 0.9}, dict(threshold=0.5, hysteresis=0.05)),
    ({(2, 0): 3.0}, {}),                              # no cheaper tree
    ("node", {})])                                    # node-id key
def test_replan_matches_jax(hot, kw):
    def run(X):
        mgr = _open_two(X, _mgr(X))
        h = {mgr.tree.levels[1][0]: 2.0} if hot == "node" else hot
        first = _replan_outcome(mgr, mgr.replan(hotness=h, **kw))
        again = _replan_outcome(mgr, mgr.replan(hotness=h, **kw))
        return first, again, str(mgr.report())
    first, again, _ = _both(run)
    assert not again[0].replanned              # never twice on one map
    if hot == {(1, 0): 2.0} and not kw:
        assert first[0].replanned and first[1] == 1
        assert sorted((len(first[2].nodes[n].children)
                       for n in first[2].levels[1]), reverse=True) == [6, 2]


def test_replan_needs_a_map_like_jax():
    with pytest.raises(ValueError, match="monitor= or a hotness="):
        _both(lambda X: _open_two(X, _mgr(X)).replan())


def _monitor_script(X):
    mgr = _mgr(X)
    mon = X.rt.CongestionMonitor(mgr)
    out = [mon.observe()]
    _open_two(X, mgr)
    out.append(mon.observe())
    mon.inject((1, 1), 1.5)
    mon.inject_flow(X.ns.BackgroundFlow("leaf_spine", 10.0))
    m = mon.observe()
    out += [m, m.hottest(), m.peak(), m.of((1, 1)), mon.history]
    try:
        mon.inject((1, 0), -1.0)
    except ValueError as e:
        out.append(str(e))
    res = mgr.replan(mon, threshold=0.5, hysteresis=0.05)
    out += [_replan_outcome(mgr, res), mon.observe()]
    mon.clear()
    out.append(mon.observe())
    return out


def test_congestion_monitor_matches_jax():
    out = _both(_monitor_script)
    assert out[0].peak() == 0.0 and out[3] == (1, 1)
    assert ">= 0" in out[7]


def _scale_script(X):
    mgr = _open_two(X, _mgr(X))
    inf = float("inf")
    all_hot = {(lvl, i): inf for lvl, n in mgr.fabric_pools.items()
               for i in range(n)}
    return (mgr.schedule(), mgr.schedule(service_scale=3.0),
            mgr.predicted(), mgr.predicted(service_scale=3.0),
            mgr.congestion_factor({}), mgr.congestion_factor({(1, 0): 2.0}),
            mgr.congestion_factor(all_hot))


def test_service_scale_and_congestion_factor_match_jax():
    base, slow, pb, ps, f0, f1, finf = _both(_scale_script)
    for c in base.counters:
        assert slow.tenant(c.tenant).throughput_pkts < c.throughput_pkts
    assert f0 == 1.0 and f1 > 1.0 and finf == math.inf


@given(st.lists(st.tuples(st.integers(0, 2), st.floats(0.0, 5.0)),
                min_size=1, max_size=6),
       st.lists(st.sampled_from(["host_leaf", "leaf_spine"]), max_size=3))
@settings(max_examples=25, deadline=None)
def test_hotness_monotone_and_matches_jax(injections, flow_links):
    def run(X):
        mgr = _mgr(X)
        mon = X.rt.CongestionMonitor(mgr)
        slots = [(lvl, i) for lvl, n in mgr.fabric_pools.items()
                 for i in range(n)]
        maps = [mon.observe()]
        for idx, h in injections:
            mon.inject(slots[idx % len(slots)], h)
            maps.append(mon.observe())
        for link in flow_links:
            mon.inject_flow(X.ns.BackgroundFlow(link, 25.0))
            maps.append(mon.observe())
        return slots, maps
    slots, maps = _both(run)
    for prev, cur in zip(maps, maps[1:]):
        assert all(cur.of(s) >= prev.of(s) for s in slots)


@given(st.floats(0.6, 4.0), st.integers(0, 1), st.integers(1, 3),
       st.integers(0, 2**31 - 1))
@settings(max_examples=15, deadline=None)
def test_replan_fixed_point_and_conservation_match_jax(heat, slot_idx,
                                                       n_tenants, seed):
    rng = np.random.default_rng(seed)
    shapes = [(int(rng.integers(1, 4)), int(rng.integers(1, 9)) * 512)
              for _ in range(n_tenants)]

    def run(X):
        mgr = _mgr(X)
        for i, (b, s) in enumerate(shapes):
            mgr.open(f"t{i}", mode="dense", num_buckets=b, bucket_elems=s,
                     dtype=X.f32)
        hot = {(1, slot_idx): heat}
        outs = [_replan_outcome(mgr, mgr.replan(hotness=hot))
                for _ in range(3)]
        shared = mgr.schedule()
        solos = [X.rt.simulate_shared([X.rt.TenantLoad(
            s.tenant, s.counters, mgr.params.clusters)]) for s in
            mgr.active()]
        return outs, shared, solos
    outs, shared, solos = _both(run)
    assert not any(o[0].replanned for o in outs[1:])
    for solo in solos:
        c = solo.counters[0]
        assert shared.tenant(c.tenant).combines == c.combines


def test_manager_and_monitor_refuse_telemetry_naming_item_13():
    """Telemetry is ported: the manager and the monitor take it, and a
    run with it gives the reports and maps of the run without (the name
    stays from when they refused it)."""
    from repro_torch.obs import Telemetry

    def script(tm):
        mgr = runtime.SessionManager(AXES, (2, 4), telemetry=tm)
        _open_two(PORT, mgr)
        mon = runtime.CongestionMonitor(
            mgr, registry=None if tm is None else tm.registry)
        mgr.schedule()
        mon.inject((1, 0), 0.9)
        res = mgr.replan(mon, threshold=0.5, hysteresis=0.05)
        return str(mgr.report()), mon.history, _plain(res), mgr.admissions
    tm = Telemetry.create()
    wired = script(tm)
    assert wired == script(None)
    assert tm.registry.value("manager.admissions") == wired[-1] > 2
    assert sorted(runtime.__all__) == sorted(jruntime.__all__)


# ---------------------------------------------------------------------------
# Tensors: the runtime and canary groups on both meshes.
# ---------------------------------------------------------------------------

#: the multidevice ``runtime`` group's tenants: (B, S) and config fields
SHAPES = {"dense": (2, 96), "int8": (1, 512), "sparse": (2, 192)}
KW = {"dense": dict(reproducible=True), "int8": dict(compression="int8"),
      "sparse": dict(sparse_k_frac=0.1)}


def _inputs(seed, shapes, mshape):
    rng = np.random.default_rng(seed)
    return {n: (rng.normal(size=mshape + (b, s)) * 1e2).astype(np.float32)
            for n, (b, s) in shapes.items()}


def _port_reduce(cfg, x, mesh, mgr, tenant, batched=True):
    """One reduction of ``x`` (its own copy: lossy transports consume
    it) through the port's transport for ``cfg``."""
    b, s = x.shape[-2:]
    t = transports.from_config(cfg, mesh, torch.float32, batched=batched,
                               manager=mgr, tenant=tenant)
    red, _ = t(tensor_from_numpy(x, "cpu").clone(), None,
               torch.zeros(b, dtype=torch.int32), (s,) * b)
    return red


def _ref_reduce(cfg, x, mgr, tenant, batched=True):
    """The same through the reference's transport under nested vmap."""
    b, s = x.shape[-2:]

    def fn(a):
        t = jtransports.from_config(cfg, jnp.float32, batched=batched,
                                    manager=mgr, tenant=tenant)
        ef = jnp.zeros_like(a) if t.needs_state else None
        return t(a, ef, jnp.zeros((b,), jnp.int32), (s,) * b)[0]
    return _nested(fn)(jnp.asarray(x))


def _cfgs(name):
    base = dict(axes=AXES, transport="innetwork", **KW[name])
    return FlareConfig(**base), jengine.FlareConfig(**base)


def _open_all(mgr, dtype, shapes=SHAPES):
    for name, (b, s) in shapes.items():
        mgr.open(name, mode=name, num_buckets=b, bucket_elems=s,
                 dtype=dtype, reproducible=(name == "dense"))


@pytest.mark.parametrize("mshape", MESHES)
def test_runtime_group_matches_jax(mshape):
    """Three tenants on one switch: each shared run (two adversarial
    seeds; batched and per-packet) is bitwise its solo run, the solo run
    under a manager is the manager-less plane, and each is the
    reference's."""
    xs = _inputs(51, SHAPES, mshape)
    mesh = RankMesh(mshape)
    solo = {}
    for name, x in xs.items():
        cfg, jcfg = _cfgs(name)
        solo[name] = _port_reduce(
            cfg, x, mesh, runtime.SessionManager(AXES, mshape, seed=7), name)
        plain = _port_reduce(cfg, x, mesh, None, None)
        assert np.array_equal(_bits(solo[name]), _bits(plain)), name
        want = _ref_reduce(jcfg, x, jruntime.SessionManager(
            AXES, mshape, seed=7), name)
        assert np.array_equal(_bits(solo[name]), _bits(want)), name
    for seed in (7, 8):
        mgr = runtime.SessionManager(AXES, mshape, seed=seed)
        jmgr = jruntime.SessionManager(AXES, mshape, seed=seed)
        _open_all(mgr, torch.float32)
        _open_all(jmgr, jnp.float32)
        for name, x in xs.items():
            cfg, jcfg = _cfgs(name)
            assert mgr.arrival_perms(name) is not None, "no contention?"
            got = _port_reduce(cfg, x, mesh, mgr, name)
            want = _ref_reduce(jcfg, x, jmgr, name)
            assert np.array_equal(_bits(got), _bits(solo[name])), (name, seed)
            assert np.array_equal(_bits(got), _bits(want)), (name, seed)
            packet = _port_reduce(cfg, x, mesh, mgr, name, batched=False)
            assert np.array_equal(_bits(packet), _bits(solo[name])), name
        assert str(mgr.report()) == str(jmgr.report())


@pytest.mark.parametrize("mshape", MESHES)
def test_arrival_order_tenant_matches_jax_under_contention(mshape):
    """A dense tenant whose handler folds in arrival order (``dense_sum``
    at the ``single`` design): under contention its bits follow the
    manager's permutations, and they are the reference's, in the batched
    and the per-packet plane."""
    x = _inputs(61, {"d": (3, 300)}, mshape)["d"]
    mesh = RankMesh(mshape)
    kw = dict(mode="dense", design="single")
    for batched in (True, False):
        mgr = runtime.SessionManager(AXES, mshape, seed=4)
        jmgr = jruntime.SessionManager(AXES, mshape, seed=4)
        _open_all(mgr, torch.float32)
        _open_all(jmgr, jnp.float32)
        t = transports.SwitchTransport(mesh, AXES, batched=batched,
                                       manager=mgr, tenant="arrival", **kw)
        got, _ = t(tensor_from_numpy(x, "cpu").clone(), None,
                   torch.zeros(3, dtype=torch.int32), (300,) * 3)

        def fn(a):
            jt = jtransports.SwitchTransport(AXES, batched=batched,
                                             manager=jmgr, tenant="arrival",
                                             **kw)
            return jt(a, None, jnp.zeros((3,), jnp.int32), (300,) * 3)[0]
        want = _nested(fn)(jnp.asarray(x))
        assert mgr.arrival_perms("arrival") is not None
        assert np.array_equal(_bits(got), _bits(want)), batched


@pytest.mark.parametrize("mshape", MESHES)
def test_canary_group_matches_jax(mshape):
    """A reproducible canary and a sparse bystander: the monitor sees a
    hot leaf slot and leaf↔spine traffic, the replan moves (on the
    two-level mesh) or not (flat), exactly as the reference's; the
    canary's bits survive it."""
    shapes = {"canary": (2, 96), "bg": (2, 192)}
    xs = _inputs(83, shapes, mshape)
    mesh = RankMesh(mshape)
    cfgs = {"canary": KW["dense"], "bg": KW["sparse"]}

    def cfg(name, F):
        return F(axes=AXES, transport="innetwork", **cfgs[name])
    mgr = runtime.SessionManager(AXES, mshape, seed=11)
    jmgr = jruntime.SessionManager(AXES, mshape, seed=11)
    before = {n: _port_reduce(cfg(n, FlareConfig), x, mesh, mgr, n)
              for n, x in xs.items()}
    for n, x in xs.items():
        _ref_reduce(cfg(n, jengine.FlareConfig), x, jmgr, n)
    outs = []
    for X, m in ((PORT, mgr), (REF, jmgr)):
        mon = X.rt.CongestionMonitor(m)
        mon.inject((1, 0), 2.0)
        mon.inject_flow(X.ns.BackgroundFlow("leaf_spine", 10.0))
        res = m.replan(mon, threshold=0.5, hysteresis=0.05)
        res2 = m.replan(mon, threshold=0.5, hysteresis=0.05)
        outs.append(_plain((res, res2, m.tree, m._epoch, str(m.report()))))
    assert outs[0] == outs[1]
    res = mgr.replans
    multi_leaf = mgr.fabric_pools.get(1, 0) >= 2
    assert res[0] == ((True, "replanned") if multi_leaf
                      else (False, "no cheaper tree"))
    assert res[1] == (False, "no cheaper tree")
    for n, x in xs.items():
        after = _port_reduce(cfg(n, FlareConfig), x, mesh, mgr, n)
        want = _ref_reduce(cfg(n, jengine.FlareConfig), x, jmgr, n)
        assert np.array_equal(_bits(after), _bits(before[n])), n
        assert np.array_equal(_bits(after), _bits(want)), n


def _grads(rng, mshape):
    return {"a": rng.normal(size=mshape + (100,)).astype(np.float32),
            "b": rng.normal(size=mshape + (8, 8)).astype(np.float32),
            "c": rng.normal(size=mshape + (28,)).astype(np.float32)}


@pytest.mark.parametrize("mshape", MESHES)
def test_grad_reducer_tenants_match_solo_and_jax(mshape):
    """Two ``GradReducer`` tenants share one manager: each is bitwise its
    solo reduction and the reference's tenant, state included."""
    g = _grads(np.random.default_rng(70), mshape)
    mesh = RankMesh(mshape)
    jobs = {"jobA": dict(reproducible=True), "jobB": dict(sparse_k_frac=0.5)}
    base = dict(axes=AXES, bucket_bytes=256, transport="innetwork")
    mgr = runtime.SessionManager(AXES, mshape, seed=9, max_sessions=8)
    jmgr = jruntime.SessionManager(AXES, mshape, seed=9, max_sessions=8)
    reds = {k: GradReducer(FlareConfig(**base, **kw), mesh, manager=mgr,
                           tenant=k) for k, kw in jobs.items()}
    for r in reds.values():
        r.attach(params_from_jax(g, "cpu"))
    jreds = {k: jengine.GradReducer(jengine.FlareConfig(**base, **kw),
                                    manager=jmgr, tenant=k)
             for k, kw in jobs.items()}

    def both(t):
        return {k: r(t, r.init_state(t)) for k, r in jreds.items()}
    want = _nested(both)(g)
    assert sorted(s.tenant for s in mgr.active()) == sorted(
        s.tenant for s in jmgr.active()) == ["jobA/float32", "jobB/float32"]
    for k, kw in jobs.items():
        got = reds[k](params_from_jax(g, "cpu"))
        solo = GradReducer(FlareConfig(**base, **kw), mesh)(
            params_from_jax(g, "cpu"))
        for leaf in g:
            for i in (0, 1):
                if got[i] is None:
                    assert solo[i] is None
                    continue
                assert np.array_equal(_bits(got[i][leaf]),
                                      _bits(solo[i][leaf])), (k, leaf)
                assert np.array_equal(_bits(got[i][leaf]),
                                      _bits(want[k][i][leaf])), (k, leaf)
    assert str(mgr.report()) == str(jmgr.report())


def _wiring_script(X, transports_mod, engine_mod, make):
    out = []
    mgr = X.rt.SessionManager(AXES, (2, 4), max_sessions=8)
    for cfg in (dict(axes=AXES), dict(axes=AXES, sparse_k_frac=0.1)):
        try:
            make(transports_mod, engine_mod, engine_mod.FlareConfig(**cfg),
                 mgr)
        except ValueError as e:
            out.append(str(e))
    red = make(None, engine_mod, engine_mod.FlareConfig(
        axes=AXES, transport="innetwork"), mgr)
    out += [red.tenant, mgr.new_tenant()]
    return out


def test_manager_wiring_errors_and_names_match_jax():
    mesh = RankMesh((2, 4))

    def port_make(tm, em, cfg, mgr):
        if tm is not None:
            return tm.from_config(cfg, mesh, torch.float32, manager=mgr)
        return em.GradReducer(cfg, mesh, manager=mgr)

    def ref_make(tm, em, cfg, mgr):
        if tm is not None:
            return tm.from_config(cfg, jnp.float32, manager=mgr)
        return em.GradReducer(cfg, manager=mgr)
    from repro_torch.core import engine
    got = _wiring_script(PORT, transports, engine, port_make)
    assert got == _wiring_script(REF, jtransports, jengine, ref_make)
    assert got[-2:] == ["tenant0", "tenant1"]
    with pytest.raises(ValueError, match="innetwork"):
        GradReducer(FlareConfig(axes=AXES), mesh,
                    manager=runtime.SessionManager(AXES, (2, 4)))


def test_admission_error_reaches_the_caller_like_jax():
    """A tenant past its static share raises ``AdmissionError`` out of the
    reduction (the host-fallback signal), with the reference's message."""
    mshape, b, s = (2, 4), 64, 4096
    x = _inputs(5, {"big": (b, s)}, mshape)["big"]
    params = dict(clusters=2, l1_bytes_per_cluster=64 << 10)
    cfg, jcfg = _cfgs("dense")
    mgr = runtime.SessionManager(AXES, mshape, params=sm.SwitchParams(
        **params), max_sessions=4)
    jmgr = jruntime.SessionManager(AXES, mshape, params=jsm.SwitchParams(
        **params), max_sessions=4)
    with pytest.raises(runtime.AdmissionError) as mine:
        _port_reduce(cfg, x, RankMesh(mshape), mgr, "big")
    with pytest.raises(jruntime.AdmissionError) as ref:
        _ref_reduce(jcfg, x, jmgr, "big")
    assert str(mine.value) == str(ref.value)
    assert not mgr.active()


@pytest.mark.parametrize("name", ["dense", "int8"])
def test_doomed_plan_drains_only_its_session_like_jax(name):
    """A fault plan past the retry budget evicts only that tenant (reason
    logged) and reduces on the wire; the other tenants keep the switch."""
    mshape = (2, 4)
    xs = _inputs(90, SHAPES, mshape)
    doomed = dict(seed=0, drop=0.9)
    outs = []
    for X, F in ((PORT, FlareConfig), (REF, jengine.FlareConfig)):
        mgr = X.rt.SessionManager(AXES, mshape, seed=2)
        _open_all(mgr, X.f32)
        outs.append((mgr, F(axes=AXES, transport="innetwork",
                            fault_plan=X.pk.FaultPlan(
                                **doomed, retry=X.pk.RetryPolicy(
                                    max_retries=0)), **KW[name])))
    (mgr, cfg), (jmgr, jcfg) = outs
    got = _port_reduce(cfg, xs[name], RankMesh(mshape), mgr, name)
    want = _ref_reduce(jcfg, xs[name], jmgr, name)
    assert np.array_equal(_bits(got), _bits(want))
    assert mgr.evictions == jmgr.evictions == [(name,
                                                "retry budget exhausted")]
    assert _plain(mgr.active()) == _plain(jmgr.active())
    assert name not in [s.tenant for s in mgr.active()]


# ---------------------------------------------------------------------------
# Training: the launcher and three jobs' train steps.
# ---------------------------------------------------------------------------

#: job k's transport, as the launchers cycle them
VARIANTS = [dict(reproducible=True), dict(compression="int8"),
            dict(sparse_k_frac=0.01)]


def _ref_tenant_manager(flags):
    """The reference launcher's ``--tenants`` manager after its
    registration pass, in process: each job's ``GradReducer`` traced once
    (``eval_shape`` under nested vmap) on the smoke model's replicated
    gradient leaves, as its ``jit_train_step`` traces it."""
    from repro.launch import train as jlaunch
    import sys
    from unittest import mock
    with mock.patch.object(sys, "argv", ["train", *flags]):
        args = jlaunch._parse()
    jmcfg = jrules.MeshCfg(("pod", "data", "model"), (2, 4, 1))
    reduce_sizes = tuple(s for a, s in zip(jmcfg.axes, jmcfg.shape)
                         if a in jmcfg.reduce_axes)
    jmgr = jruntime.SessionManager(jmcfg.reduce_axes, reduce_sizes,
                                   policy=args.partition_policy,
                                   order=args.schedule_order,
                                   max_sessions=max(8, 2 * args.tenants))
    model = jregistry.get_model(jtl.SMOKE.scaled(dtype=jnp.float32))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    _, _, dims = jrules.param_specs(shapes, jmcfg)
    rep = [jax.ShapeDtypeStruct((2, 4) + l.shape, l.dtype)
           for l, d in zip(jax.tree.leaves(shapes), jax.tree.leaves(dims))
           if d < 0]
    for k in range(args.tenants):
        kw = dict(VARIANTS[k % 3])
        if "sparse_k_frac" in kw:
            kw["sparse_k_frac"] = max(args.sparse_k, 0.01)
        red = jengine.GradReducer(jengine.FlareConfig(
            axes=jmcfg.reduce_axes, transport="innetwork",
            fault_plan=jlaunch._fault_plan(args), **kw),
            manager=jmgr, tenant=f"job{k}")
        jax.eval_shape(_nested(lambda g, r=red: r(g, r.init_state(g))), rep)
    return args, jmgr


@pytest.mark.parametrize("flags", [
    [], ["--congestion-replan", "0.9"],
    ["--partition-policy", "greedy", "--schedule-order", "priority"],
    ["--fault-rate", "0.01", "--partition-policy", "static"]])
def test_launcher_tenants_report_matches_jax(flags, capsys):
    """``--tenants 3`` at ``--smoke`` on the CPU: every loss finite, and
    the manager's report (and the replan's line and report) byte for
    byte the reference manager's for the same flags."""
    argv = ["--smoke", "--mesh", "2x4x1", "--tenants", "3", "--steps", "2",
            *flags]
    losses = launch_train.main([*argv, "--device", "cpu"])
    assert len(losses) == 2 and all(len(r) == 3 for r in losses)
    assert np.isfinite(losses).all()
    out = capsys.readouterr().out.splitlines()
    assert [l.split(" | ")[1].split()[0] for l in out[:2]] == [
        "job0(reproducible)"] * 2
    first = next(i for i, l in enumerate(out) if l.startswith("switch:"))
    args, jmgr = _ref_tenant_manager(argv)
    want = [str(jmgr.report())]
    if args.congestion_replan > 0:
        mon = jruntime.CongestionMonitor(jmgr)
        mon.inject((1, 0), args.congestion_replan)
        res = jmgr.replan(mon, threshold=0.5, hysteresis=0.05)
        fanins = [sorted((len(jmgr.tree.nodes[n].children) for n in lvl),
                         reverse=True) for lvl in jmgr.tree.levels[1:]]
        want += [f"congestion replan: replanned={res.replanned} "
                 f"reason={res.reason!r} "
                 f"improvement_x={res.improvement_x:.3f} "
                 f"readmitted={list(res.readmitted)} "
                 f"evicted={list(res.evicted)} fanins={fanins}",
                 str(jmgr.report())]
    assert "\n".join(out[first:]) == "\n".join(want)
    assert "3/8 sessions" in want[0]


def test_launcher_tenants_setup_registers_every_job_first():
    shared = launch_train.setup_tenants(["--smoke", "--mesh", "2x4x1",
                                         "--tenants", "3", "--device",
                                         "cpu"])
    assert [s.tenant for s in shared.manager.active()] == [
        f"job{k}/float32" for k in range(3)]
    assert [kind for _, kind, _ in shared.jobs] == [
        "reproducible", "compression", "sparse_k_frac"]
    with pytest.raises(ValueError, match="setup_tenants"):
        launch_train.setup(["--smoke", "--tenants", "2", "--device", "cpu"])
    with pytest.raises(SystemExit, match="needs --tenants > 1"):
        launch_train.main(["--smoke", "--device", "cpu",
                           "--congestion-replan", "0.9"])


WIDE = dict(d_model=256, n_heads=4, n_kv_heads=2, head_dim=64, d_ff=512,
            vocab=512, n_layers=2)


def _per_rank_jax(jp, jmcfg):
    """Each rank's shard of every leaf, as the reference's specs place
    them (``tests/test_torch_train.py``)."""
    _, manual, _ = jrules.param_specs(jp, jmcfg)

    def f(a, spec):
        for i, ax in enumerate(spec):
            if ax == "data":
                blocks = np.stack(np.split(a, 4, axis=i))
                return np.broadcast_to(blocks, (2,) + blocks.shape).copy()
        return np.broadcast_to(a, (2, 4) + a.shape).copy()
    return jax.tree.map(f, jp, manual,
                        is_leaf=lambda x: isinstance(x, np.ndarray))


def test_tenant_train_steps_match_jax():
    """Three jobs (dense reproducible, int8, sparse) on one switch, from
    the reference's parameters and batch: every job's step-1 loss and
    gradient norm within ``tests/test_torch_train.py``'s 1e-5, the two
    managers' reports equal; fed the reference's per-rank gradients, each
    tenant's reduced norm leaves and state are the reference tenant's
    bits."""
    jcfg = jtl.SMOKE.scaled(dtype=jnp.float32, **WIDE)
    cfg = tl.SMOKE.scaled(dtype=torch.float32, **WIDE)
    jmcfg = jrules.MeshCfg(("pod", "data", "model"), (2, 4, 1))
    mcfg = rules.MeshCfg(("pod", "data", "model"), (2, 4, 1))
    jmodel = jregistry.get_model(jcfg)
    jp = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    mgr = runtime.SessionManager(AXES, (2, 4), max_sessions=8)
    jmgr = jruntime.SessionManager(AXES, (2, 4), max_sessions=8)
    flare = [dict(axes=AXES, transport="innetwork", **kw) for kw in VARIANTS]
    steps, jsteps = [], []
    for k, kw in enumerate(flare):
        full = params_from_jax(jp, "cpu")
        steps.append(trainer.make_train_step(
            get_model(cfg), mcfg, trainer.TrainConfig(
                lr=1e-3, flare=FlareConfig(**kw)), full,
            reduce_manager=mgr, tenant=f"job{k}"))
        jsteps.append(jtrainer.make_train_step(
            jmodel, jmcfg, jtrainer.TrainConfig(
                lr=1e-3, flare=jengine.FlareConfig(**kw)), jp,
            reduce_manager=jmgr, tenant=f"job{k}"))
    params0 = rules.shard_params(params_from_jax(jp, "cpu"), mcfg)
    jparams = _per_rank_jax(jp, jmcfg)
    batch = {k: np.asarray(v) for k, v in next(
        jpipeline.synthetic_batches(jcfg, 8, 64, seed=1,
                                    prefetch=False)).items()}
    jbatch = {k: v.reshape(2, 4, 1, 64) for k, v in batch.items()}
    jopts = [jax.vmap(jax.vmap(js[4]))(jparams) for js in jsteps]
    # registration on both sides before any step
    for st_ in steps:
        st_.attach(params0)
    for js, jo in zip(jsteps, jopts):
        jax.eval_shape(_nested(js[0]), jparams, jo, jbatch)
    assert str(mgr.report()) == str(jmgr.report())
    for st_, js, jo in zip(steps, jsteps, jopts):
        params = tree.map_leaves(torch.clone, params0)
        _, _, m = st_(params, st_.init_opt_state(params),
                      rules.split_batch(params_from_jax(batch, "cpu"), mcfg))
        _, _, jm = _nested(js[0])(jparams, jo, jbatch)
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[key]),
                                       float(np.asarray(jm[key])[0, 0]),
                                       rtol=1e-5)
    assert str(mgr.report()) == str(jmgr.report())

    # the reduced norm leaves, bitwise, from the reference's gradients
    grads = _nested(lambda b: jax.grad(
        lambda p: jmodel.loss(p, b) / 8)(jp))(jbatch)
    _, _, dims = jrules.param_specs(jp, jmcfg)
    rep = [np.asarray(g) for g, d in zip(jax.tree.leaves(grads),
                                         jax.tree.leaves(dims)) if d < 0]
    assert len(rep) == 5
    for k, (st_, kw) in enumerate(zip(steps, flare)):
        jred = jengine.GradReducer(jengine.FlareConfig(**kw), manager=jmgr,
                                   tenant=f"job{k}")
        want = _nested(lambda gs, r=jred: r(gs, r.init_state(gs)))(rep)
        got = st_.reducer([tensor_from_numpy(g, "cpu") for g in rep])
        for i in (0, 1):
            if got[i] is None:
                assert want[i] is None
                continue
            for a, b in zip(got[i], want[i]):
                assert np.array_equal(_bits(a), _bits(b)), (k, i)
