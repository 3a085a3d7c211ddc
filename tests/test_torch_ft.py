"""The port's fault tolerance against the JAX package's.

* **Coordinator and re-mesh**: the counterparts of ``tests/test_ft.py``'s
  coordinator, re-mesh and switch-failure tests and of the coordinator
  tests of ``tests/test_chaos.py``; each scenario runs through both
  packages (``_both``) and the outcomes (values, or the exception's type
  and message) are equal: the plans field by field, trees included.
* **Checkpoints**: the counterparts of ``tests/test_ft.py``'s checkpoint
  tests, and compatibility across the packages: for the same state the
  two ``manifest.json`` files are byte-identical, and each package
  restores the other's checkpoint, bf16 leaves included.  The snapshot is
  a copy (the port's optimizer updates in place while the write runs).
* **The launcher**: ``--ckpt-dir --ckpt-every``, then ``--resume`` on the
  same mesh and on ``1x4x1`` (an elastic restart onto
  ``plan_remesh(8, {7})``'s world of 4), against the reference launcher's
  losses for the same flags.  The reference's side runs its launcher's
  steps in one process: its ``step_body`` under nested ``jax.vmap`` from
  its own initial parameters and data stream, its ``CheckpointManager``
  saving and restoring the global state.  Where the reference's
  semantics are odd the port follows them and a test pins them: the
  checkpoint keeps rank 0's error-feedback residual; a resumed run draws
  batch 0 of its stream again.
* **Switch failure on a shared switch**: the manager re-admits the
  tenants the reference's manager re-admits, each reducing bitwise as
  before the failure.
"""
import dataclasses
import glob
import json
import os
import threading
import types
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro import ft as jft
from repro import runtime as jruntime
from repro.configs import tinyllama_1_1b as jtl
from repro.core import engine as jengine
from repro.core import topology as jtopo
from repro.data import pipeline as jpipeline
from repro.ft import coordinator as jcoord
from repro.models import registry as jregistry
from repro.obs import MetricsRegistry as JMetricsRegistry
from repro.perfmodel import switch_model as jsm
from repro.runtime import scheduler as jsc
from repro.sharding import rules as jrules
from repro.train import trainer as jtrainer
from repro_torch import ft, runtime, tree
from repro_torch.convert import params_from_jax, tensor_from_numpy
from repro_torch.core import sparse, topology, transports
from repro_torch.core.engine import FlareConfig
from repro_torch.ft import checkpoint, coordinator
from repro_torch.launch import train as launch_train
from repro_torch.mesh import RankMesh
from repro_torch.models import registry
from repro_torch.obs import MetricsRegistry
from repro_torch.perfmodel import switch_model as sm
from repro_torch.runtime import scheduler as sc

torch.set_num_threads(1)

AXES = ("pod", "data")
_INT = {1: np.int8, 2: np.int16, 4: np.int32}

PORT = types.SimpleNamespace(ft=ft, coord=coordinator, topo=topology,
                             rt=runtime, sm=sm, sc=sc, f32=torch.float32,
                             Registry=MetricsRegistry)
REF = types.SimpleNamespace(ft=jft, coord=jcoord, topo=jtopo, rt=jruntime,
                            sm=jsm, sc=jsc, f32=jnp.float32,
                            Registry=JMetricsRegistry)


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
    if isinstance(x, (set, frozenset)):
        return ("set",) + tuple(sorted(x, key=repr))
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
        a = a.detach().contiguous()
        return a.view({1: torch.int8, 2: torch.int16,
                       4: torch.int32}[a.element_size()]).numpy()
    a = np.asarray(a)
    return a.view(_INT[a.dtype.itemsize])


def _nested(f):
    return jax.jit(jax.vmap(jax.vmap(f, axis_name="data"), axis_name="pod"))


# ---------------------------------------------------------------------------
# Checkpoints.
# ---------------------------------------------------------------------------

def _state(seed=0):
    """One state in both packages' leaves: fp32, bf16, an int32 scalar,
    a list with a ``None`` and a tuple, from seeded numpy."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(3, 4)).astype(np.float32)
    h = rng.normal(size=(5,)).astype(np.float32)
    hb = jnp.asarray(h, jnp.bfloat16)
    mine = {"w": torch.from_numpy(w.copy()),
            "opt": {"m": tensor_from_numpy(np.asarray(hb), "cpu"),
                    "step": torch.tensor(7, dtype=torch.int32)},
            "ef": [torch.from_numpy(w[0].copy()), None,
                   (torch.ones(2, 2),)]}
    ref = {"w": jnp.asarray(w),
           "opt": {"m": hb, "step": jnp.int32(7)},
           "ef": [jnp.asarray(w[0]), None, (jnp.ones((2, 2)),)]}
    return mine, ref


def _same_tree(a, b) -> bool:
    la, lb = tree.flatten(a)[0], jax.tree.leaves(b)
    return len(la) == len(lb) and all(
        tuple(x.shape) == np.asarray(y).shape
        and np.array_equal(_bits(x), np.asarray(y).view(_INT[
            np.asarray(y).dtype.itemsize])) for x, y in zip(la, lb))


def test_checkpoint_roundtrip(tmp_path):
    cm = ft.CheckpointManager(str(tmp_path), keep=3, async_save=False)
    t, _ = _state()
    cm.save(10, t)
    out = cm.restore(10, t)
    for a, b in zip(tree.flatten(out)[0], tree.flatten(t)[0]):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(_bits(a), _bits(b))
    assert out["ef"][1] is None and isinstance(out["ef"][2], tuple)


def test_checkpoint_manifest_is_the_references_byte_for_byte(tmp_path):
    mine, ref = _state()
    ft.CheckpointManager(str(tmp_path / "p"), async_save=False).save(3, mine)
    jft.CheckpointManager(str(tmp_path / "r"), async_save=False).save(3, ref)
    a = (tmp_path / "p" / "step_000003" / "manifest.json").read_text()
    b = (tmp_path / "r" / "step_000003" / "manifest.json").read_text()
    assert a == b
    assert json.loads(a)["dtypes"] == ["float32", "float32", "bfloat16",
                                       "int32", "float32"]


def test_checkpoints_restore_across_the_packages(tmp_path):
    mine, ref = _state()
    ft.CheckpointManager(str(tmp_path / "p"), async_save=False).save(1, mine)
    jft.CheckpointManager(str(tmp_path / "r"), async_save=False).save(1, ref)
    # the reference's checkpoint into the port: every leaf's bits, on the
    # target's device and in its dtype
    got = ft.CheckpointManager(str(tmp_path / "r")).restore(1, mine)
    assert _same_tree(got, ref)
    assert got["opt"]["m"].dtype == torch.bfloat16
    # the port's into the reference (a bfloat16 leaf comes back as the
    # 2-byte void both write, as from the reference's own checkpoint)
    back = jft.CheckpointManager(str(tmp_path / "p")).restore(1, ref)
    own = jft.CheckpointManager(str(tmp_path / "r")).restore(1, ref)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(own)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_checkpoint_keep_n_gc(tmp_path):
    def run(X):
        d = str(tmp_path / X.f32.__class__.__name__)
        cm = X.ft.CheckpointManager(d, keep=2, async_save=True)
        t = ({"w": torch.ones(3)} if X is PORT else {"w": jnp.ones(3)})
        for s in (10, 20, 30, 40):
            cm.save(s, t)
        cm.wait()
        return cm.all_steps(), cm.latest_step()
    assert _both(run) == ([30, 40], 40)


def test_checkpoint_write_error_reaches_wait(tmp_path):
    """A failed asynchronous write is raised by ``wait`` (and by the next
    ``save``, which waits), not lost on the thread; nothing is committed."""
    cm = ft.CheckpointManager(str(tmp_path), async_save=True)
    t, _ = _state()
    with mock.patch.object(np, "savez", side_effect=OSError("disk full")):
        cm.save(1, t)
        with pytest.raises(OSError, match="disk full"):
            cm.wait()
    assert cm.all_steps() == []
    cm.wait()                                  # the error is raised once
    cm.save(2, t)
    cm.wait()
    assert cm.all_steps() == [2]


def test_checkpoint_crc_detects_corruption(tmp_path):
    cm = ft.CheckpointManager(str(tmp_path), keep=1, async_save=False)
    t, _ = _state()
    cm.save(5, t)
    f = glob.glob(os.path.join(str(tmp_path), "step_000005", "*.npz"))[0]
    data = bytearray(open(f, "rb").read())
    for off in range(len(data) // 2, len(data) - 1, 16):
        data[off] ^= 0xFF
    open(f, "wb").write(bytes(data))
    with pytest.raises(Exception):
        cm.restore(5, t)
    # a flipped payload byte is caught by the leaf's CRC, named as the
    # reference names it
    cm.save(6, t)
    f = os.path.join(str(tmp_path), "step_000006", "shard_h000.npz")
    arrays = dict(np.load(f))
    arrays["a0"] = arrays["a0"] + 1
    np.savez(f, **arrays)
    with pytest.raises(IOError, match=r"leaf \['ef'\]\[0\] CRC mismatch"):
        cm.restore(6, t)


def test_checkpoint_structure_mismatch(tmp_path):
    def run(X):
        d = str(tmp_path / ("p" if X is PORT else "r"))
        cm = X.ft.CheckpointManager(d, async_save=False)
        t = _state()[0 if X is PORT else 1]
        cm.save(1, t)
        other = ({"different": torch.zeros(3)} if X is PORT
                 else {"different": jnp.zeros(3)})
        return cm.restore(1, other)
    with pytest.raises(ValueError, match="structure mismatch"):
        _both(run)


def test_checkpoint_atomic_commit(tmp_path):
    def run(X):
        d = tmp_path / ("p" if X is PORT else "r")
        cm = X.ft.CheckpointManager(str(d), async_save=False)
        os.makedirs(d / "step_000099.tmp", exist_ok=True)
        return cm.all_steps(), cm.latest_step()
    assert _both(run) == ([], None)


def test_checkpoint_snapshot_is_a_copy(tmp_path):
    """Save asynchronously, step (the optimizer updates the parameters in
    place), then let the write run: the checkpoint holds the state at the
    save.  Without the copy in ``save`` it would hold the next step's."""
    run = launch_train.setup(["--smoke", "--device", "cpu", "--mesh",
                              "2x4x1", "--lr", "1e-2"])
    run.train_step()
    at_save = tree.map_leaves(torch.clone, run.state())
    gate = threading.Event()
    write = checkpoint.CheckpointManager._write

    def held(self, *args):
        gate.wait()
        write(self, *args)
    cm = ft.CheckpointManager(str(tmp_path))
    with mock.patch.object(checkpoint.CheckpointManager, "_write", held):
        cm.save(1, run.state())
        run.train_step()
        gate.set()
        cm.wait()
    after = run.state()
    assert not torch.equal(after["p"]["embed"], at_save["p"]["embed"])
    got = cm.restore(1, after)
    for a, b in zip(tree.flatten(got)[0], tree.flatten(at_save)[0]):
        assert np.array_equal(_bits(a), _bits(b))


# ---------------------------------------------------------------------------
# The coordinator and the re-mesh planner.
# ---------------------------------------------------------------------------

def test_coordinator_failure_detection():
    def run(X):
        t = [0.0]
        c = X.ft.Coordinator(8, timeout_s=5, clock=lambda: t[0])
        t[0] = 8.0
        for h in range(8):
            if h != 3:
                c.heartbeat(h)
        t[0] = 12.0
        out = [c.check()]
        c.heartbeat(3)
        out.append(c.check())
        c.admit(3)
        out.append(c.check())
        return out
    assert _both(run) == [{3}, {3}, set()]


def _plan_image(p):
    return (p.survivors, p.new_data, p.new_pod, p.model, p.rank_map,
            p.dropped_hosts, p.world, _plain(p.tree))


@given(st.integers(2, 1024), st.sets(st.integers(0, 1023), max_size=32),
       st.sampled_from([None, 4, 16]))
@settings(max_examples=30, deadline=None)
def test_remesh_plan_properties(hosts, failed, per_pod):
    failed = {f for f in failed if f < hosts}
    if len(failed) >= hosts:
        return
    plan = coordinator.plan_remesh(hosts, failed, model=16,
                                   hosts_per_pod=per_pod)
    want = jcoord.plan_remesh(hosts, failed, model=16,
                              hosts_per_pod=per_pod)
    assert _plan_image(plan) == _plan_image(want)
    assert plan.world & (plan.world - 1) == 0
    assert not (set(plan.survivors) & failed)
    assert sorted(plan.rank_map.values()) == list(range(plan.world))
    assert plan.world <= hosts - len(failed) < plan.world * 2


def test_remesh_pod_structure_and_no_survivors():
    plan = _both(lambda X: _plan_image(X.coord.plan_remesh(
        64, {5}, model=16, hosts_per_pod=16)))
    assert plan[1:3] == (16, 2) and plan[6] == 32
    # the elastic restart of the launcher: 8 hosts, host 7 lost
    small = _both(lambda X: _plan_image(X.coord.plan_remesh(
        8, {7}, model=1, hosts_per_pod=4)))
    assert small[6] == 4 and small[0] == (0, 1, 2, 3)
    with pytest.raises(RuntimeError, match="no survivors"):
        _both(lambda X: X.coord.plan_remesh(2, {0, 1}, model=1))


def test_straggler_report():
    def run(X):
        times = {i: 1.0 for i in range(8)}
        times[6] = 5.0
        return X.coord.straggler_report(times), X.coord.straggler_report({})
    assert _both(run) == ([6], [])


def test_heartbeat_expiry_to_eviction_to_remesh():
    def run(X):
        c = X.ft.Coordinator(8, timeout_s=5, clock=lambda: 0.0)
        for h in range(6):
            c.heartbeat(h, now=8.0)
        out = [c.check(now=4.0), c.check(now=12.0), c.clock()]
        out.append(_plan_image(c.plan(model=4)))
        c.admit(6, now=12.0)
        out.append(c.check(now=12.0))
        return out
    out = _both(run)
    assert out[:3] == [set(), {6, 7}, 0.0]
    assert out[3][0] == (0, 1, 2, 3) and out[3][5] == (4, 5)
    assert out[4] == {7}


def test_straggler_report_edge_cases():
    cases = [({}, 2.0), ({0: 100.0}, 2.0), ({h: 42.0 for h in range(6)}, 2.0),
             ({0: 1.0, 1: 9.0, 2: 9.0, 3: 9.0}, 2.0),
             ({0: 0.0, 1: 0.0, 2: 0.5}, 2.0),
             ({0: 1.0, 1: 1.0, 2: 2.5}, 2.0),
             ({0: 1.0, 1: 1.0, 2: 2.5}, 3.0)]
    out = _both(lambda X: [X.coord.straggler_report(t, factor=f)
                           for t, f in cases])
    assert out == [[], [], [], [], [2], [2], []]


def test_coordinator_straggler_report_injectable_clock():
    def run(X):
        c = X.ft.Coordinator(4, clock=lambda: 0.0)
        starts = {0: 10.0, 1: 10.0, 2: 10.0, 3: 2.0}
        return (c.straggler_report(starts, now=11.0),
                c.straggler_report(starts, now=11.0, factor=10.0),
                c.straggler_report({}, now=11.0))
    assert _both(run) == ([3], [], [])


def test_coordinator_publishes_liveness_into_a_registry():
    """``Coordinator(registry=)``: the ``ft.host<h>.*`` counters, the
    reference's export byte for byte."""
    def run(X):
        reg = X.Registry()
        c = X.ft.Coordinator(4, timeout_s=5, clock=lambda: 0.0,
                             registry=reg)
        for h in (0, 1, 2):
            c.heartbeat(h, now=3.0)
        c.check(now=7.0)
        c.admit(3, now=7.0)
        c.straggler_report({0: 0.0, 1: 0.0, 2: 6.0}, now=7.0)
        return reg.to_json()
    text = _both(run)
    assert json.loads(text)["ft.host3.missed"]["value"] == 1
    assert json.loads(text)["ft.host3.recoveries"]["value"] == 1


# ---------------------------------------------------------------------------
# Switch failure → network-manager reroute → runtime drain/re-admit (§4).
# ---------------------------------------------------------------------------

def _switch_runtime(X):
    mgr = X.rt.SessionManager(AXES, (2, 4), max_sessions=4)
    mgr.open("a", mode="dense", num_buckets=2, bucket_elems=256,
             dtype=X.f32, reproducible=True)
    mgr.open("b", mode="int8", num_buckets=1, bucket_elems=512,
             dtype=X.f32)
    return mgr


def test_switch_failure_rebuilds_tree_and_readmits_sessions():
    def run(X):
        nm = X.topo.NetworkManager()
        lease = nm.request(8, radix=2)
        mgr = _switch_runtime(X)
        old_fanin = mgr.session("a").counters.levels[0].fanin
        old_epoch = mgr._epoch
        coord = X.ft.Coordinator(8, network=nm)
        failed = lease.tree.levels[1][0]
        new = coord.switch_failure(lease, failed, runtime=mgr)
        return (new, lease, coord.failed_switches, nm.active() == [new],
                sorted(s.tenant for s in mgr.active()), mgr.tree is new.tree,
                mgr._epoch - old_epoch, old_fanin,
                mgr.session("a").counters, str(mgr.report()))
    (new, lease, failed, active, tenants, bound, epochs, old_fanin,
     counters, _) = _both(run)
    assert new.allreduce_id == lease.allreduce_id
    assert new.tree.num_hosts == lease.tree.num_hosts
    assert new.tree.radix > lease.tree.radix
    assert failed == {lease.tree.levels[1][0]} and active and bound
    assert tenants == ["a", "b"] and epochs == 1
    assert counters.levels[0].fanin == new.tree.radix != old_fanin


def test_switch_failure_without_sibling_drains_to_host_fallback():
    def run(X):
        nm = X.topo.NetworkManager()
        lease = nm.request(4, radix=4)
        mgr = _switch_runtime(X)
        out = X.coord.recover_switch_failure(nm, lease,
                                             lease.tree.root.node_id,
                                             runtime=mgr)
        return out, nm.active(), mgr.active()
    assert _both(run) == (None, [], ())


def test_switch_failure_evicts_sessions_that_no_longer_fit():
    def run(X):
        params = X.sm.SwitchParams(clusters=4,
                                   l1_bytes_per_cluster=40 << 10)
        nm = X.topo.NetworkManager(l1_bytes_per_cluster=40 << 10,
                                   clusters=4)
        lease = nm.request(8, radix=2)
        mgr = X.rt.SessionManager(("data",), (8,), params=params,
                                  max_sessions=2)
        mgr.rebind(lease.tree)
        mgr.open("small", mode="dense", num_buckets=1, bucket_elems=256,
                 dtype=X.f32, reproducible=True)
        big = mgr.open("big", mode="dense", num_buckets=8, bucket_elems=2048,
                       dtype=X.f32, reproducible=True)
        fits = big.demand_bytes <= mgr.bytes_per_session
        new = nm.handle_switch_failure(lease, lease.tree.levels[1][0])
        return (fits, mgr.rebind(new.tree),
                sorted(s.tenant for s in mgr.active()), mgr.evictions,
                str(mgr.report()))
    fits, (readmitted, evicted), active, evictions, _ = _both(run)
    assert fits and readmitted == ("small",) and evicted == ("big",)
    assert active == ["small"]
    assert evictions == [("big", "no longer fits rebuilt tree")]


#: the shared switch's tenants of the chip's phase 15 on (2, 4): name,
#: (B, S), FlareConfig fields (the switch-failure drill rides them)
DRILL = (("dense", (16, 1 << 16), {"reproducible": True}),
         ("int8", (6, 1 << 20), {"compression": "int8"}),
         ("sparse", (64, 1 << 20), {"sparse_k_frac": 0.01}))


def _drill(X, shapes):
    """Phase 15's tenants on a manager riding a radix-2 lease; a leaf
    switch fails.  Returns what the manager decides."""
    nm = X.topo.NetworkManager()
    lease = nm.request(8, radix=2)
    mgr = X.rt.SessionManager(AXES, (2, 4))
    mgr.rebind(lease.tree)
    for name, (b, s), kw in shapes:
        k = sparse.sparse_k(kw["sparse_k_frac"], s) if name == "sparse" \
            else None
        mgr.open(name, mode=name, num_buckets=b, bucket_elems=s,
                 dtype=X.f32, reproducible=name == "dense", k=k)
    before = str(mgr.report())
    coord = X.ft.Coordinator(8, network=nm)
    new = coord.switch_failure(lease, lease.tree.levels[1][0], runtime=mgr)
    return (before, new.tree, mgr.evictions,
            sorted(s.tenant for s in mgr.active()), str(mgr.report()))


def test_switch_failure_drill_at_the_chips_shapes_matches_jax():
    """The control plane of ``chip_smoke.py``'s drill at its full arenas:
    the re-admissions and evictions are the reference manager's."""
    _, _, evictions, active, report = _both(lambda X: _drill(X, DRILL))
    assert evictions == [] and active == ["dense", "int8", "sparse"]
    assert "3/8 sessions" in report


def test_readmitted_tenants_reduce_as_before_the_failure():
    """At a small size: every tenant reduces bitwise the same before and
    after the switch fails (the epoch's new arrival permutations change
    no bits: every handler steers by child rank), and the reference's."""
    small = (("dense", (2, 96), {"reproducible": True}),
             ("int8", (1, 512), {"compression": "int8"}),
             ("sparse", (2, 192), {"sparse_k_frac": 0.1}))
    rng = np.random.default_rng(5)
    xs = {n: (rng.normal(size=(2, 4) + bs) * 1e2).astype(np.float32)
          for n, bs, _ in small}
    nm = topology.NetworkManager()
    lease = nm.request(8, radix=2)
    mgr = runtime.SessionManager(AXES, (2, 4))
    mgr.rebind(lease.tree)
    mesh = RankMesh((2, 4))

    def reduce_all():
        out = {}
        for name, (b, s), kw in small:
            t = transports.from_config(
                FlareConfig(axes=AXES, transport="innetwork", **kw), mesh,
                torch.float32, manager=mgr, tenant=name)
            red, _ = t(tensor_from_numpy(xs[name], "cpu").clone(), None,
                       torch.zeros(b, dtype=torch.int32), (s,) * b)
            out[name] = _bits(red)
        return out
    before = reduce_all()
    perms = mgr.arrival_perms("dense")[0](4, 3)
    new = ft.Coordinator(8, network=nm).switch_failure(
        lease, lease.tree.levels[1][0], runtime=mgr)
    assert new is not None and mgr.tree is new.tree
    assert not np.array_equal(mgr.arrival_perms("dense")[0](4, 3), perms)
    after = reduce_all()
    for name in before:
        assert np.array_equal(before[name], after[name]), name
    from repro.core import transports as jtransports
    for name, (b, s), kw in small:
        def fn(x, kw=kw, b=b, s=s):
            t = jtransports.from_config(jengine.FlareConfig(
                axes=AXES, transport="innetwork", **kw), jnp.float32)
            ef = jnp.zeros_like(x) if t.needs_state else None
            return t(x, ef, jnp.zeros((b,), jnp.int32), (s,) * b)[0]
        want = _nested(fn)(jnp.asarray(xs[name]))
        if name == "int8":       # the reference's int8 has no single answer
            continue
        assert np.array_equal(after[name], _bits(want)), name


# ---------------------------------------------------------------------------
# Session failure (the coordinator tests of tests/test_chaos.py).
# ---------------------------------------------------------------------------

def _manager(X):
    m = X.rt.SessionManager(("data",), (8,), seed=0)
    m.open("a", mode="dense", num_buckets=2, bucket_elems=256,
           dtype=X.f32, reproducible=True)
    m.open("b", mode="int8", num_buckets=2, bucket_elems=256, dtype=X.f32)
    return m


def test_evict_is_scoped_logged_and_idempotent():
    def run(X):
        m = _manager(X)
        out = [m.evict("a", reason="retry budget exhausted"),
               [s.tenant for s in m.active()], list(m.evictions),
               m.evict("a"), m.evict("ghost"), len(m.evictions)]
        return out
    assert _both(run) == [True, ["b"], [("a", "retry budget exhausted")],
                          False, False, 1]


def test_recover_session_failure_none_safe():
    def run(X):
        m = _manager(X)
        return (X.coord.recover_session_failure(None, "a"),
                X.coord.recover_session_failure(_manager(X), None),
                X.coord.recover_session_failure(m, "b"), m.evictions)
    assert _both(run) == (False, False, True,
                          [("b", "retry budget exhausted")])


def test_coordinator_session_failure_records():
    def run(X):
        c = X.ft.Coordinator(4, clock=lambda: 0.0)
        m = _manager(X)
        return (c.session_failure(m, "a"), set(c.failed_sessions),
                c.session_failure(m, "a"), set(c.failed_sessions),
                c.failed, c.failed_switches)
    assert _both(run) == (True, {"a"}, False, {"a"}, set(), set())


def test_ft_package_surface_is_the_references():
    assert ft.__all__ == jft.__all__
    assert "item 12" not in (ft.__doc__ or "")


# ---------------------------------------------------------------------------
# The launcher: checkpoint, resume, elastic resume.
# ---------------------------------------------------------------------------

JSMOKE = jtl.SMOKE.scaled(dtype=jnp.float32)


def _jparams():
    return jax.tree.map(np.asarray, jregistry.get_model(JSMOKE).init(
        jax.random.PRNGKey(0)))


def _with_reference_init(jp):
    """The port's launcher, its model initialized to the reference's
    parameters (the two packages draw different random weights)."""
    orig = registry.get_model

    def get_model(cfg):
        m = orig(cfg)
        return dataclasses.replace(
            m, init=lambda gen: params_from_jax(jp, str(gen.device)))
    return mock.patch.object(registry, "get_model", get_model)


def _ref_launcher(jp, ranks, steps, tmp, *, start_state=None, start=0,
                  every=0):
    """The reference launcher's steps ``start .. steps - 1`` on a
    ``(pod, data)`` mesh of ``ranks`` (its model axis 1): its per-rank
    ``step_body`` under nested ``vmap``, from ``jp`` or from a restored
    global state, on a fresh ``seed=1`` stream; saves the global state
    every ``every`` steps with its ``CheckpointManager``.  Returns the
    losses and the manager."""
    jmcfg = jrules.MeshCfg(("pod", "data", "model"), (*ranks, 1))
    model = jregistry.get_model(JSMOKE)
    body, _, _, _, init = jtrainer.make_train_step(
        model, jmcfg, jtrainer.TrainConfig(
            lr=1e-3, gather_algorithm="rhd",
            flare=jengine.FlareConfig(axes=AXES)), jp)
    # the smoke model's leaves are all replicated: every rank holds all
    rep = lambda a: np.broadcast_to(a, ranks + np.shape(a)).copy()  # noqa
    state = start_state or {"p": jp, "o": init(jp)}
    params = jax.tree.map(rep, state["p"])
    opt = jax.tree.map(rep, state["o"])
    step = _nested(body)
    stream = jpipeline.synthetic_batches(JSMOKE, 8, 128, seed=1,
                                         prefetch=False)
    cm = jft.CheckpointManager(str(tmp))
    losses = []
    for i in range(start, steps):
        batch = {k: np.asarray(v).reshape(*ranks, -1, 128)
                 for k, v in next(stream).items()}
        params, opt, m = step(params, opt, batch)
        losses.append(float(np.asarray(m["loss"])[0, 0]))
        if every and (i + 1) % every == 0:
            first = lambda a: np.asarray(a)[0, 0]       # noqa: E731
            cm.save(i + 1, {"p": jax.tree.map(first, params),
                            "o": jax.tree.map(first, opt)})
    cm.wait()
    return losses, cm


def test_launcher_resume_and_elastic_resume_match_jax(tmp_path, capsys):
    """``--steps 4 --ckpt-every 2``, then ``--resume --steps 5`` on
    ``2x4x1`` and on ``1x4x1``: the port's losses are the reference
    launcher's within ``tests/test_torch_train.py``'s 1e-5, its
    checkpoints restore into the reference's state tree, and the resumed
    step draws batch 0 of the stream, as the reference's does."""
    jp = _jparams()
    flags = ["--smoke", "--device", "cpu", "--mesh", "2x4x1"]
    ck = str(tmp_path / "ck")
    with _with_reference_init(jp):
        saved = launch_train.main([*flags, "--steps", "4", "--ckpt-dir", ck,
                                   "--ckpt-every", "2"])
        resumed = launch_train.main([*flags, "--steps", "5", "--ckpt-dir",
                                     ck, "--resume"])
        elastic = launch_train.main(["--smoke", "--device", "cpu", "--mesh",
                                     "1x4x1", "--steps", "5", "--ckpt-dir",
                                     ck, "--resume"])
    out = capsys.readouterr().out
    assert out.count("resumed from step 4") == 2
    assert ft.CheckpointManager(ck).all_steps() == [2, 4]
    want, jcm = _ref_launcher(jp, (2, 4), 4, tmp_path / "jck", every=2)
    np.testing.assert_allclose(saved, want, rtol=1e-5)
    # the port's checkpoint, read by the reference into its own state
    # tree: the manifests name the same leaves, shapes and dtypes
    mine = json.load(open(os.path.join(ck, "step_000004", "manifest.json")))
    ref = json.load(open(str(tmp_path / "jck" / "step_000004" /
                             "manifest.json")))
    assert {k: mine[k] for k in ("names", "shapes", "dtypes")} == \
        {k: ref[k] for k in ("names", "shapes", "dtypes")}
    target = {"p": jp, "o": {"m": jp, "v": jp, "step": np.int32(0)}}
    jstate = jcm.restore(4, target)
    from_port = jft.CheckpointManager(ck).restore(4, target)
    assert int(from_port["o"]["step"]) == int(jstate["o"]["step"]) == 4
    # the states after four steps: tests/test_torch_train.py's bounds
    # (Adam's ill-conditioned first step moves a few elements by 1e-4)
    for a, b in zip(jax.tree.leaves(from_port), jax.tree.leaves(jstate)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-4)
    for ranks, got in (((2, 4), resumed), ((1, 4), elastic)):
        want, _ = _ref_launcher(jp, ranks, 5, tmp_path / f"j{ranks}",
                                start_state=jstate, start=4)
        np.testing.assert_allclose(got, want, rtol=1e-5)
    # resume replays the stream from its start: step 4 of the resumed
    # run is not step 4 of the uninterrupted one
    with _with_reference_init(jp):
        straight = launch_train.main([*flags, "--steps", "5"])
    assert straight[:4] == pytest.approx(saved, rel=1e-6)
    assert abs(straight[4] - resumed[0]) > 1e-4


def test_checkpoint_keeps_rank_0s_error_feedback_residual(tmp_path):
    """The reference's lossy state ``opt["ef"]`` has out-spec ``P()``
    although every rank's residual differs; its ``device_get`` saves rank
    0's, and ``device_put`` of the restored copy gives it to every rank.
    The port follows: ``Run.state`` keeps rank 0's residual, and
    ``load_state`` broadcasts it."""
    run = launch_train.setup(["--smoke", "--device", "cpu", "--mesh",
                              "2x4x1", "--compression", "int8"])
    run.train_step()
    ef = run.opt["ef"]
    assert any(not torch.equal(e[0, 0], e[1, 3]) for e in ef)
    cm = ft.CheckpointManager(str(tmp_path), async_save=False)
    cm.save(1, run.state())
    names = json.load(open(tmp_path / "step_000001" / "manifest.json"))[
        "names"]
    assert "['o']['ef'][0]" in names
    got = cm.restore(1, run.state())
    for e, g in zip(ef, got["o"]["ef"]):
        assert np.array_equal(_bits(e[0, 0]), _bits(g))
    run.load_state(got)
    for e, g in zip(run.opt["ef"], got["o"]["ef"]):
        for r in np.ndindex(2, 4):
            assert np.array_equal(_bits(e[r]), _bits(g))
