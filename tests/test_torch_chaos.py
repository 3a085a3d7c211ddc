"""The port's lossy-fabric reliability layer against the JAX package's.

* **Fault plans** — ``FaultPlan.schedule`` gives the same masks, permutations
  and counters in both packages over a grid of shapes, rates and seeds
  (the same ``default_rng([seed, level, P, n])`` draws); the shape keys
  (``level_packet_counts``), ``fault_schedules`` and ``plan_survives`` agree.
* **Planes** — the dense, int8 and sparse planes under a surviving plan that
  drops, corrupts, duplicates and reorders, on ``(2, 4)`` and ``(1, 8)``,
  batched and per-packet, with and without arrival permutations: bitwise
  the JAX plane under nested ``jax.vmap`` with axis names and bitwise the
  port's fault-free plane, with fault counters equal rank by rank.
* **Engine** — ``GradReducer`` and ``SwitchTransport`` under a plan give the
  reference's bits; a doomed plan degrades to the wire transport the
  reference degrades to; ``FlareConfig`` and the launcher's ``_fault_plan``
  behave as the reference's.

Tolerance zero throughout: admission never changes what is folded.
"""
import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import engine as jengine
from repro.core import transports as jtransports
from repro.launch import train as jtrain
from repro.perfmodel import switch_model as jsm
from repro.switch import dataplane as jdp
from repro.switch import handlers as jhd
from repro.switch import packets as jpk
from repro_torch.convert import params_from_jax, tensor_from_numpy
from repro_torch.core import transports
from repro_torch.core.engine import FlareConfig, GradReducer
from repro_torch.launch import train
from repro_torch.mesh import RankMesh
from repro_torch.perfmodel import switch_model as sm
from repro_torch.switch import dataplane, handlers as hd, packets as pk

torch.set_num_threads(1)

pytestmark = pytest.mark.chaos

AXES = ("pod", "data")
MESHES = [(2, 4), (1, 8)]
_INT = {1: np.int8, 2: np.int16, 4: np.int32}
#: the plan shape of the reference's chaos group
RATES = dict(drop=0.05, duplicate=0.3, reorder=0.5, corrupt=0.02)
FIELDS = ("retransmits", "duplicates_dropped", "corrupt_rejected",
          "delivered", "wait_rounds")


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.contiguous()
        return a.view({1: torch.int8, 2: torch.int16,
                       4: torch.int32}[a.element_size()]).numpy()
    a = np.asarray(a)
    return a.view(_INT[a.dtype.itemsize])


def _nested(f):
    return jax.jit(jax.vmap(jax.vmap(f, axis_name="data"), axis_name="pod"))


def _fanins(mshape):
    return [mshape[1], mshape[0]] if mshape[0] > 1 else [mshape[1]]


def _plans(counts, **rates):
    """The first seed whose plan survives on these level shapes and makes
    every kind of fault happen: a retransmission, a duplicate, a corrupted
    delivery and a reordered round.  Returns the port's plan and the
    reference's."""
    for seed in range(400):
        plan = pk.FaultPlan(seed=seed, **rates)
        scheds = [s for s in dataplane.fault_schedules(plan, counts)
                  if s is not None]
        perms = [s.perms[r] for s in scheds for r in range(s.rounds)]
        if (dataplane.plan_survives(plan, counts)
                and sum(s.retransmits for s in scheds) > 0
                and sum(s.duplicates for s in scheds) > 0
                and sum(s.corrupt_rejected for s in scheds) > 0
                and any(not np.array_equal(q, np.sort(q)) for q in perms)):
            return plan, jpk.FaultPlan(seed=seed, **rates)
    raise AssertionError(f"no surviving seed exercises every fault on "
                         f"{counts}")


def _perms(rng, counts):
    """One adversarial per-slot ``(P, n)`` arrival order per level."""
    return [np.stack([rng.permutation(p) for _ in range(n)], axis=1)
            for p, n in counts]


def _same_stats(got: dict, want: dict) -> bool:
    return all(np.array_equal(got[k].numpy(), np.asarray(want[k]))
               for k in FIELDS)


# ---------------------------------------------------------------------------
# Fault plans and schedules.
# ---------------------------------------------------------------------------

def _same_schedule(a, b) -> bool:
    return (all(np.array_equal(getattr(a, f), getattr(b, f))
                for f in ("arrives", "corrupt", "perms"))
            and (a.survives, a.retransmits, a.duplicates, a.corrupt_rejected,
                 a.wait_rounds) == (b.survives, b.retransmits, b.duplicates,
                                    b.corrupt_rejected, b.wait_rounds))


@given(st.integers(2, 10), st.integers(1, 200), st.floats(0.0, 0.3),
       st.floats(0.0, 0.3), st.integers(0, 2**31 - 1), st.integers(0, 2))
@settings(max_examples=25, deadline=None)
def test_fault_schedule_matches_jax(p, n, drop, corrupt, seed, level):
    kw = dict(seed=seed, drop=drop, corrupt=corrupt, duplicate=0.2,
              reorder=0.5)
    mine = pk.FaultPlan(**kw).schedule(level, p, n)
    assert _same_schedule(mine, jpk.FaultPlan(**kw).schedule(level, p, n))
    assert mine.rounds <= pk.RetryPolicy().max_retries + 1


def test_fault_plan_validation_and_retry_policy_match_jax():
    for bad in (dict(drop=-0.1), dict(drop=1.5), dict(duplicate=2.0),
                dict(reorder=-1.0), dict(corrupt=1.01)):
        with pytest.raises(ValueError) as mine:
            pk.FaultPlan(**bad)
        with pytest.raises(ValueError) as ref:
            jpk.FaultPlan(**bad)
        assert str(mine.value) == str(ref.value)
    plan = pk.FaultPlan(drop=0.5, levels=[1])
    assert plan.levels == (1,) and not plan.applies(0) and plan.applies(1)
    rp, jrp = pk.RetryPolicy(5, 2, 3.0), jpk.RetryPolicy(5, 2, 3.0)
    assert [rp.wait_rounds(r) for r in range(4)] == [
        jrp.wait_rounds(r) for r in range(4)]
    clean = pk.FaultPlan().schedule(0, 4, 16)
    assert clean.rounds == 1 and clean.arrives.all() and clean.survives
    assert hash(pk.FaultPlan(seed=3, drop=0.1)) == hash(
        pk.FaultPlan(seed=3, drop=0.1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16", "int32",
                                   "int8"])
def test_corruption_and_admission_match_jax(dtype):
    rng = np.random.default_rng(len(dtype))
    if dtype.startswith("int"):
        info = np.iinfo(dtype)
        x = rng.integers(info.min, info.max, size=(3, 5, 7), dtype=dtype)
    else:
        x = np.asarray(jnp.asarray(rng.normal(size=(3, 5, 7)).astype(
            np.float32)).astype(dtype))
    mask = rng.random((3, 5)) < 0.5
    t = tensor_from_numpy(x, "cpu")
    got = pk.corrupt_first_elem(t, torch.from_numpy(mask))
    want = jpk.corrupt_first_elem(jnp.asarray(x), jnp.asarray(mask))
    assert np.array_equal(_bits(got), _bits(want))
    # every corrupted packet fails its checksum, every clean one passes
    assert np.array_equal((pk.payload_checksum(got)
                           != pk.payload_checksum(t)).numpy(), mask)
    arrives, ok, seen = (rng.random((3, 5)) < 0.7 for _ in range(3))
    acc = rng.normal(size=(3, 5, 4)).astype(np.float32)
    upd = rng.normal(size=(3, 5, 4)).astype(np.float32)
    accept = hd.accept_mask(*(torch.from_numpy(a) for a in (arrives, ok,
                                                            seen)))
    jaccept = jhd.accept_mask(*(jnp.asarray(a) for a in (arrives, ok, seen)))
    assert np.array_equal(accept.numpy(), np.asarray(jaccept))
    # the port's stacks lead with the level's switch axis G; one (P, n)
    # mask serves every switch
    folded = hd.fold_once(torch.from_numpy(acc)[None],
                          torch.from_numpy(upd)[None], accept)
    want = jhd.fold_once(jnp.asarray(acc), jnp.asarray(upd), jaccept)
    assert np.array_equal(folded[0].numpy(), np.asarray(want))


@pytest.mark.parametrize("case", [
    dict(fanins=[4, 2], b=4, s=2048),
    dict(fanins=[8], b=3, s=300, dtype="bfloat16"),
    dict(fanins=[4], b=4, s=1000, mode="int8", block=256),
    dict(fanins=[4, 2], b=2, s=4096, mode="sparse", k_max=64,
         density_threshold=1.1),
    dict(fanins=[4, 2], b=2, s=512, mode="sparse", k_max=16),
    dict(fanins=[8], b=2, s=512, mode="sparse", k_max=16)])
def test_level_packet_counts_match_jax(case):
    case = dict(case)
    fanins, b, s = case.pop("fanins"), case.pop("b"), case.pop("s")
    dtype = case.pop("dtype", "float32")
    got = dataplane.level_packet_counts(fanins, b, s, getattr(torch, dtype),
                                        **case)
    assert got == jdp.level_packet_counts(fanins, b, s, getattr(jnp, dtype),
                                          **case)
    for plan, jplan in ((pk.FaultPlan(seed=1, **RATES),
                         jpk.FaultPlan(seed=1, **RATES)),
                        (pk.FaultPlan(seed=2, drop=0.9, levels=(1,)),
                         jpk.FaultPlan(seed=2, drop=0.9, levels=(1,)))):
        mine = dataplane.fault_schedules(plan, got)
        ref = jdp.fault_schedules(jplan, got)
        assert [m is None for m in mine] == [r is None for r in ref]
        assert all(_same_schedule(m, r) for m, r in zip(mine, ref)
                   if m is not None)
        assert (dataplane.plan_survives(plan, got)
                == jdp.plan_survives(jplan, got))
    with pytest.raises(ValueError, match="k_max"):
        dataplane.level_packet_counts([4], 2, 64, torch.float32,
                                      mode="sparse")


def test_plan_survives_is_static_and_cached():
    counts = dataplane.level_packet_counts([8], 4, 2048, torch.float32)
    assert dataplane.plan_survives(None, counts)
    assert dataplane.plan_survives(pk.FaultPlan(), counts)
    doomed = pk.FaultPlan(drop=0.9, retry=pk.RetryPolicy(max_retries=0))
    assert not dataplane.plan_survives(doomed, counts)
    patient = pk.FaultPlan(drop=0.9, retry=pk.RetryPolicy(max_retries=64))
    assert dataplane.plan_survives(patient, counts)
    # the schedules are drawn once per (plan, shapes) and shared
    a = dataplane.fault_schedules(patient, counts)
    assert dataplane.fault_schedules(patient, list(counts))[0] is a[0]
    # a plane never runs a plan it cannot recover
    x = torch.zeros(1, 8, 4, 2048)
    for batched in (True, False):
        with pytest.raises(dataplane.FaultBudgetExceeded):
            dataplane.switch_allreduce_dense(x, RankMesh((1, 8)), AXES,
                                             fault_plan=doomed,
                                             batched=batched)


@pytest.mark.parametrize("drop,corrupt", [(0.02, 0.0), (0.05, 0.01)])
def test_model_lossy_matches_measured_schedule_counters(drop, corrupt):
    """The port's analytic loss terms agree with its schedules' measured
    retry counters, as the reference's do (``tests/test_chaos.py``)."""
    p, n = 8, 512
    plan0 = pk.FaultPlan(drop=drop, corrupt=corrupt)
    pt = sm.model_lossy(drop, corrupt, p * n)
    assert dataclasses.astuple(pt) == dataclasses.astuple(
        jsm.model_lossy(drop, corrupt, p * n))
    seeds = range(8)
    scheds = [pk.FaultPlan(seed=s, drop=drop, corrupt=corrupt)
              .schedule(0, p, n) for s in seeds]
    retrans = sum(s.retransmits for s in scheds) / len(seeds)
    assert 0.5 * pt.retransmits < retrans < 1.8 * pt.retransmits
    if corrupt:
        expect = corrupt * (p * n + pt.retransmits)
        got = sum(s.corrupt_rejected for s in scheds) / len(seeds)
        assert 0.5 * expect < got < 1.8 * expect
    assert sum(s.wait_rounds for s in scheds) / len(seeds) <= sum(
        plan0.retry.wait_rounds(r)
        for r in range(1, plan0.retry.max_retries + 1))
    assert sum(s.survives for s in scheds) / len(seeds) >= pt.survival - 0.25


# ---------------------------------------------------------------------------
# The three planes under a surviving plan.
# ---------------------------------------------------------------------------

def _port_runs(plane, t, mesh, plan, perms, **kw):
    """The port's plane batched and per-packet, with and without the
    arrival permutations, each with its fault counters."""
    return {(bt, pm is not None): plane(t, mesh, AXES, fault_plan=plan,
                                        with_fault_stats=True,
                                        arrival_perms=pm, batched=bt, **kw)
            for bt in (True, False) for pm in (None, perms)}


@pytest.mark.parametrize("reproducible", [True, False])
@pytest.mark.parametrize("mshape", MESHES)
def test_dense_plane_under_faults_matches_jax(mshape, reproducible):
    rng = np.random.default_rng(10 * MESHES.index(mshape) + reproducible)
    b, s = 3, 300
    x = (rng.normal(size=mshape + (b, s)) * 1e3).astype(np.float32)
    counts = dataplane.level_packet_counts(_fanins(mshape), b, s,
                                           torch.float32)
    plan, jplan = _plans(counts, **RATES)
    perms = _perms(rng, counts)
    kw = dict(reproducible=reproducible,
              design="auto" if reproducible else "single")
    want, wstats = _nested(lambda a: jdp.switch_allreduce_dense(
        a, AXES, fault_plan=jplan, with_fault_stats=True,
        arrival_perms=perms, **kw))(jnp.asarray(x))
    # the reference's faulted run in canonical arrival order
    want0 = _nested(lambda a: jdp.switch_allreduce_dense(
        a, AXES, fault_plan=jplan, **kw))(jnp.asarray(x))
    t, mesh = tensor_from_numpy(x, "cpu"), RankMesh(mshape)
    clean = dataplane.switch_allreduce_dense(t, mesh, AXES, **kw)
    for (bt, permuted), (got, stats) in _port_runs(
            dataplane.switch_allreduce_dense, t, mesh, plan, perms,
            **kw).items():
        # the fixed tree steers by child rank: arrival order cannot matter
        ref = _bits(want) if permuted or reproducible else _bits(clean)
        assert np.array_equal(_bits(got), ref), (bt, permuted)
        if not permuted:
            assert np.array_equal(_bits(got), _bits(want0)), bt
        assert _same_stats(stats, wstats), (bt, permuted)
    if reproducible:
        assert np.array_equal(_bits(clean), _bits(want))
    scheds = dataplane.fault_schedules(plan, counts)
    assert int(stats["retransmits"][0, 0]) == sum(s.retransmits
                                                  for s in scheds)
    assert int(stats["delivered"][0, 0]) == sum(p * n for p, n in counts)


def test_per_packet_dense_plane_under_faults_matches_jax_per_packet():
    """The reference's own per-packet replay (checksums, steering, seen
    bitmaps on the packets) under faults and arrival permutations."""
    mshape = (2, 4)
    rng = np.random.default_rng(3)
    x = rng.normal(size=mshape + (2, 200)).astype(np.float32)
    counts = dataplane.level_packet_counts(_fanins(mshape), 2, 200,
                                           torch.float32)
    plan, jplan = _plans(counts, **RATES)
    perms = _perms(rng, counts)
    want, wstats = _nested(lambda a: jdp.switch_allreduce_dense(
        a, AXES, design="single", fault_plan=jplan, with_fault_stats=True,
        arrival_perms=perms, batched=False))(jnp.asarray(x))
    got, stats = dataplane.switch_allreduce_dense(
        tensor_from_numpy(x, "cpu"), RankMesh(mshape), AXES, design="single",
        fault_plan=plan, with_fault_stats=True, arrival_perms=perms,
        batched=False)
    assert np.array_equal(_bits(got), _bits(want))
    assert _same_stats(stats, wstats)


@pytest.mark.parametrize("mshape", MESHES)
def test_int8_plane_under_faults_matches_jax(mshape):
    """At the ``single`` design, where the reference has one answer (its
    int8 ``tree`` design does not: ROADMAP queue 3)."""
    rng = np.random.default_rng(20 + MESHES.index(mshape))
    b, s, block = 3, 200, 64
    x = (rng.normal(size=mshape + (b, s)) * 3).astype(np.float32)
    counts = dataplane.level_packet_counts(_fanins(mshape), b, s,
                                           torch.float32, mode="int8",
                                           block=block)
    plan, jplan = _plans(counts, **RATES)
    perms = _perms(rng, counts)
    want, wstats = _nested(lambda a: jdp.switch_allreduce_int8(
        a, AXES, block=block, design="single", fault_plan=jplan,
        with_fault_stats=True))(jnp.asarray(x))
    t, mesh = tensor_from_numpy(x, "cpu"), RankMesh(mshape)
    clean = dataplane.switch_allreduce_int8(t, mesh, AXES, block=block,
                                            design="single")
    assert np.array_equal(_bits(clean), _bits(want))
    for key, (got, stats) in _port_runs(
            dataplane.switch_allreduce_int8, t, mesh, plan, perms,
            block=block, design="single").items():
        assert np.array_equal(_bits(got), _bits(want)), key
        assert _same_stats(stats, wstats), key


@pytest.mark.parametrize("mshape,k,threshold", [
    ((2, 4), 16, 1.1),      # lists up to the root
    ((2, 4), 16, 0.25),     # densified between the levels
    ((1, 8), 16, 0.25)])    # densified before the leaf level
def test_sparse_plane_under_faults_matches_jax(mshape, k, threshold):
    rng = np.random.default_rng(30 + k + int(threshold * 10))
    b, s = 2, 512
    x = rng.normal(size=mshape + (b, s)).astype(np.float32)
    counts = dataplane.level_packet_counts(
        _fanins(mshape), b, s, torch.float32, mode="sparse", k_max=k,
        density_threshold=threshold)
    plan, jplan = _plans(counts, **RATES)
    perms = _perms(rng, counts)
    kw = dict(density_threshold=threshold, with_stats=True)
    want, _, wcoll, wstats = _nested(lambda a: jdp.switch_allreduce_sparse(
        a, AXES, k, fault_plan=jplan, with_fault_stats=True, **kw))(
        jnp.asarray(x))
    t, mesh = tensor_from_numpy(x, "cpu"), RankMesh(mshape)
    clean = dataplane.switch_allreduce_sparse(t, mesh, AXES, k, **kw)
    assert np.array_equal(_bits(clean[0]), _bits(want))
    for key, (got, sent, coll, stats) in _port_runs(
            lambda *a, **kws: dataplane.switch_allreduce_sparse(
                *a[:3], k, **kws), t, mesh, plan, perms, **kw).items():
        assert np.array_equal(_bits(got), _bits(want)), key
        assert torch.equal(sent[1], clean[1][1]), key
        assert np.array_equal(coll["collisions"].numpy(),
                              np.asarray(wcoll["collisions"])), key
        assert _same_stats(stats, wstats), key


def test_planes_return_counters_on_one_rank():
    one = torch.ones(1, 1, 2, 64)
    for plane in (dataplane.switch_allreduce_dense,
                  dataplane.switch_allreduce_int8):
        out, stats = plane(one, RankMesh((1, 1)), AXES,
                           fault_plan=pk.FaultPlan(drop=0.5),
                           with_fault_stats=True)
        assert out is one and all(int(v.sum()) == 0 for v in stats.values())
    *_, stats = dataplane.switch_allreduce_sparse(
        one, RankMesh((1, 1)), AXES, 4, with_fault_stats=True)
    assert sorted(stats) == sorted(FIELDS)


# ---------------------------------------------------------------------------
# GradReducer, SwitchTransport and the degradation to the wire.
# ---------------------------------------------------------------------------

def _grads(rng, mshape):
    return {"a": rng.normal(size=mshape + (100,)).astype(np.float32),
            "b": rng.normal(size=mshape + (8, 8)).astype(np.float32),
            "c": rng.normal(size=mshape + (28,)).astype(np.float32)}


#: a retry budget that makes survival certain at any seed, under every
#: kind of fault
GENTLE = dict(seed=3, drop=0.03, duplicate=0.3, reorder=0.5, corrupt=0.02)


@pytest.mark.parametrize("mshape,kw", [
    ((2, 4), dict(reproducible=True)),
    ((2, 4), dict(compression="int8")),
    ((1, 8), dict(sparse_k_frac=0.1))])
def test_grad_reducer_under_faults_matches_jax(mshape, kw):
    rng = np.random.default_rng(40)
    g = _grads(rng, mshape)
    base = dict(axes=AXES, bucket_bytes=256, transport="innetwork", **kw)
    jred = jengine.GradReducer(jengine.FlareConfig(
        fault_plan=jpk.FaultPlan(**GENTLE, retry=jpk.RetryPolicy(8)),
        **base))
    want = _nested(lambda t: jred(t))(g)
    plan = pk.FaultPlan(**GENTLE, retry=pk.RetryPolicy(8))
    red = GradReducer(FlareConfig(fault_plan=plan, **base), RankMesh(mshape))
    got, state = red(params_from_jax(g, "cpu"))
    clean, clean_state = GradReducer(FlareConfig(**base), RankMesh(mshape))(
        params_from_jax(g, "cpu"))
    for k in g:
        assert np.array_equal(_bits(got[k]), _bits(want[0][k])), k
        assert np.array_equal(_bits(got[k]), _bits(clean[k])), k
        if state is not None:
            assert np.array_equal(_bits(state[k]), _bits(want[1][k])), k
            assert torch.equal(state[k], clean_state[k]), k


@pytest.mark.parametrize("kw", [dict(reproducible=True),
                                dict(compression="int8"),
                                dict(sparse_k_frac=0.1)])
def test_doomed_plan_degrades_to_the_references_wire(kw):
    """A plan past the retry budget hands the arena to the wire transport
    the reference degrades to; for the fixed tree that is bitwise the
    in-network fault-free result (F3)."""
    mshape, b, s = (2, 4), 3, 2048
    rng = np.random.default_rng(50)
    x = rng.normal(size=mshape + (b, s)).astype(np.float32)
    doomed = dict(seed=0, drop=0.9)
    cfg = dict(axes=AXES, transport="innetwork", **kw)
    jt = jtransports.from_config(jengine.FlareConfig(
        fault_plan=jpk.FaultPlan(**doomed, retry=jpk.RetryPolicy(
            max_retries=0)), **cfg), jnp.float32)
    want = _nested(lambda a: jt(a, None, jnp.zeros((b,), jnp.int32),
                                (s,) * b))(jnp.asarray(x))
    mesh = RankMesh(mshape)
    plan = pk.FaultPlan(**doomed, retry=pk.RetryPolicy(max_retries=0))
    t = transports.from_config(FlareConfig(fault_plan=plan, **cfg), mesh,
                               torch.float32)
    assert isinstance(t, transports.SwitchTransport)
    assert t.fault_plan is plan
    staggers = torch.zeros(b, dtype=torch.int32)
    # the lossy transports consume their input: each call gets a copy
    got = t(tensor_from_numpy(x, "cpu").clone(), None, staggers, (s,) * b)
    wire = t._degrade()
    assert not isinstance(wire, transports.SwitchTransport)
    direct = wire(tensor_from_numpy(x, "cpu").clone(), None, staggers,
                  (s,) * b)
    for g, d, w in zip(got, direct, want):
        if g is None:
            assert w is None
            continue
        assert np.array_equal(_bits(g), _bits(w))
        assert torch.equal(g, d)
    if kw.get("reproducible"):
        clean = dataplane.switch_allreduce_dense(
            tensor_from_numpy(x, "cpu"), mesh, AXES, reproducible=True)
        assert torch.equal(got[0], clean)


def test_flare_config_takes_a_fault_plan_like_jax():
    plan, jplan = pk.FaultPlan(drop=0.01), jpk.FaultPlan(drop=0.01)
    with pytest.raises(ValueError) as mine:
        FlareConfig(axes=("data",), fault_plan=plan)
    with pytest.raises(ValueError) as ref:
        jengine.FlareConfig(axes=("data",), fault_plan=jplan)
    assert str(mine.value) == str(ref.value)
    cfg = FlareConfig(axes=("data",), transport="innetwork", fault_plan=plan)
    assert cfg.fault_plan is plan
    hash(cfg)


def test_train_cli_fault_plan_helper_matches_jax():
    def ns(**kw):
        return argparse.Namespace(**dict(dict(
            fault_rate=0.0, fault_seed=0, transport="auto", tenants=1), **kw))
    assert train._fault_plan(ns()) is None is jtrain._fault_plan(ns())
    args = ns(fault_rate=0.02, fault_seed=5, transport="innetwork")
    plan, jplan = train._fault_plan(args), jtrain._fault_plan(args)
    assert plan == pk.FaultPlan(seed=5, drop=0.02)
    assert dataclasses.asdict(plan) == dataclasses.asdict(jplan)
    for helper in (train._fault_plan, jtrain._fault_plan):
        with pytest.raises(SystemExit):
            helper(ns(fault_rate=0.02))
    parsed = train._parse(["--fault-rate", "0.01", "--fault-seed", "1",
                           "--transport", "innetwork"])
    assert train._fault_plan(parsed) == pk.FaultPlan(seed=1, drop=0.01)
