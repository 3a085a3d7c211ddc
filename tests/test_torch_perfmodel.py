"""The port's perf models against the JAX package's, and the paper's claims.

``repro_torch.perfmodel`` keeps its own copies of the reference's analytic
switch model, discrete-event switch simulator and fat-tree simulator (the
port imports nothing of ``repro``).  For every public function, the same
arguments give equal outputs in both packages (dataclasses field by
field, floats exactly); the discrete-event simulator draws from
``default_rng(seed)``, so it gives an equal ``SimResult`` too.  The
reference tests' claims (``tests/test_perfmodel.py``) are carried over on
the port's copies, the simulator at the reference tests' sizes or
smaller.
"""
import dataclasses
import inspect

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import repro.perfmodel as jperf
from repro.perfmodel import network_sim as jns
from repro.perfmodel import switch_model as jsm
from repro.perfmodel import switch_sim as jss
import repro_torch.perfmodel as perf
from repro_torch.perfmodel import network_sim as ns
from repro_torch.perfmodel import switch_model as sm
from repro_torch.perfmodel import switch_sim as ss


def _plain(x):
    """A model output as plain data: dataclasses by class name and fields,
    containers element by element."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(
            _plain(getattr(x, f.name)) for f in dataclasses.fields(x))
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    if isinstance(x, np.generic):
        return x.item()
    return x


def _same(mine, ref) -> bool:
    return _plain(mine) == _plain(ref)


@pytest.mark.parametrize("name", ["switch_model", "switch_sim",
                                  "network_sim"])
def test_port_has_every_public_name(name):
    ref, mine = getattr(jperf, name), getattr(perf, name)
    public = {n for n, v in vars(ref).items() if not n.startswith("_")
              and (inspect.isfunction(v) or inspect.isclass(v)
                   or isinstance(v, (int, float, dict, tuple)))
              and getattr(v, "__module__", ref.__name__) == ref.__name__}
    missing = sorted(n for n in public if not hasattr(mine, n))
    assert not missing
    assert sorted(perf.__all__) == sorted(jperf.__all__)
    for n in public:
        v = getattr(ref, n)
        if isinstance(v, (int, float, dict, tuple)):
            assert getattr(mine, n) == v, n


# ---------------------------------------------------------------------------
# Equal outputs for equal arguments.
# ---------------------------------------------------------------------------

PARAMS = [dict(), dict(packet_bytes=256), dict(clusters=16, ports=32,
                                               port_gbps=400.0)]


@pytest.mark.parametrize("pkw", PARAMS)
def test_switch_model_matches_jax(pkw):
    p, jp = sm.SwitchParams(**pkw), jsm.SwitchParams(**pkw)
    for attr in ("cores", "packet_cycles", "delta"):
        assert getattr(p, attr) == getattr(jp, attr)
    L, C = p.packet_cycles, p.cores_per_cluster
    for S in (1, 2, 8):
        for dc in (0.0, 0.5 * L, 2 * L, p.delta):
            assert sm.tau_single(L, C, S, dc) == jsm.tau_single(L, C, S, dc)
            for B, P in ((1, 2), (4, 8), (2, 64)):
                assert sm.tau_multi(L, C, S, dc, B, P) == jsm.tau_multi(
                    L, C, S, dc, B, P)
            dk = sm.delta_k(S, dc, p.cores, p.delta)
            assert dk == jsm.delta_k(S, dc, p.cores, p.delta)
            for P in (2, 8, 64):
                tau = sm.tau_tree(L, P, p.dma_cycles)
                assert tau == jsm.tau_tree(L, P, p.dma_cycles)
                q = sm.queue_len(P, S, dk, tau)
                assert q == jsm.queue_len(P, S, dk, tau)
                assert sm.input_buffer_pkts(P, p.cores, S, dk, tau) == \
                    jsm.input_buffer_pkts(P, p.cores, S, dk, tau)
                lat = sm.block_latency(P, dc, q, tau)
                assert lat == jsm.block_latency(P, dc, q, tau)
                bw = sm.bandwidth_pkts_per_cycle(p.cores, tau, p.delta)
                assert bw == jsm.bandwidth_pkts_per_cycle(p.cores, tau,
                                                          p.delta)
                assert sm.bandwidth_tbps(p, tau) == jsm.bandwidth_tbps(jp,
                                                                       tau)
                for design, B in (("single", 1), ("multi", 4), ("tree", 1)):
                    m = sm.buffers_per_block(design, P, B)
                    assert m == jsm.buffers_per_block(design, P, B)
                    assert sm.working_memory_buffers(m, bw, P, lat) == \
                        jsm.working_memory_buffers(m, bw, P, lat)
    with pytest.raises(ValueError):
        sm.buffers_per_block("bogus", 4)
    for z in (1 << 10, 64 << 10, 200 << 10, 400 << 10, 4 << 20):
        assert sm.select_design(z) == jsm.select_design(z)
        assert sm.staggered_delta_c(p, z) == jsm.staggered_delta_c(jp, z)
        for design, B in (("single", 1), ("multi", 2), ("multi", 4),
                          ("tree", 1)):
            for kw in (dict(), dict(P=8, S=4), dict(staggered=False)):
                assert _same(sm.model_design(design, z, p, B=B, **kw),
                             jsm.model_design(design, z, jp, B=B, **kw))
    allocs = [("a", 16, 1024.0, 0.5), ("b", 48, 96.0, 0.25),
              ("c", 0, 300.0, 0.25)]
    assert _same(sm.model_shared(allocs, p), jsm.model_shared(allocs, jp))


def test_sparse_hash_and_lossy_terms_match_jax():
    p, jp = sm.SwitchParams(), jsm.SwitchParams()
    for storage in ("hash", "array"):
        for d in (0.001, 0.01, 0.2, 1.0):
            for P in (None, 8):
                assert sm.tau_sparse(storage, p, d, P) == jsm.tau_sparse(
                    storage, jp, d, P)
            assert sm.sparse_bandwidth_tbps(storage, d) == \
                jsm.sparse_bandwidth_tbps(storage, d)
    with pytest.raises(ValueError):
        sm.tau_sparse("bogus", p, 0.1)
    for n, m in ((0, 10), (10, 1000), (5000, 4096), (1e6, 1.0)):
        assert sm.expected_hash_collisions(n, m) == \
            jsm.expected_hash_collisions(n, m)
        assert sm.expected_hash_spill_bytes(n, m, 2) == \
            jsm.expected_hash_spill_bytes(n, m, 2)
    for drop, corrupt in ((0.0, 0.0), (0.01, 0.002), (0.05, 0.01),
                          (0.3, 0.1)):
        q = sm.loss_probability(drop, corrupt)
        assert q == jsm.loss_probability(drop, corrupt)
        for r in (0, 1, 3, 8):
            assert sm.expected_retransmits_per_packet(q, r) == \
                jsm.expected_retransmits_per_packet(q, r)
            assert sm.delivery_probability(q, r) == \
                jsm.delivery_probability(q, r)
            for n in (1, 512, 4_816_896):
                assert sm.expected_retry_rounds(q, r, n) == \
                    jsm.expected_retry_rounds(q, r, n)
        for kw in (dict(), dict(max_retries=0), dict(max_retries=8,
                                                     timeout_rounds=2,
                                                     backoff=1.5)):
            assert _same(sm.model_lossy(drop, corrupt, 4096, **kw),
                         jsm.model_lossy(drop, corrupt, 4096, **kw))


@pytest.mark.parametrize("kw", [
    dict(design="tree", data_bytes=64 << 10, P=64),
    dict(design="multi", data_bytes=64 << 10, B=4, P=64, seed=1),
    dict(design="single", data_bytes=128 << 10, P=16, staggered=False),
    dict(design="single", data_bytes=64 << 10, P=64, sparse_density=0.05,
         sparse_storage="array"),
    dict(design="single", data_bytes=32 << 10, P=8,
         cycles_per_byte=0.25)])
def test_switch_sim_matches_jax(kw):
    assert _same(ss.simulate(**kw), jss.simulate(**kw))


def test_bandwidth_sweep_and_network_sim_match_jax():
    sizes = [16 << 10, 64 << 10]
    assert _same(ss.bandwidth_vs_size("tree", sizes, dtype="int8"),
                 jss.bandwidth_vs_size("tree", sizes, dtype="int8"))
    for net, jnet in ((ns.FatTree(), jns.FatTree()),
                      (ns.FatTree(hosts=128, link_gbps=400.0),
                       jns.FatTree(hosts=128, link_gbps=400.0))):
        assert (net.leaves, net.link_bytes_per_us) == (
            jnet.leaves, jnet.link_bytes_per_us)
        for flows in ((), (("host_leaf", 50.0), ("leaf_spine", 20.0))):
            bg = [ns.BackgroundFlow(*f) for f in flows]
            jbg = [jns.BackgroundFlow(*f) for f in flows]
            assert ns.effective_link_rates(net, bg) == \
                jns.effective_link_rates(jnet, jbg)
            for z in (1 << 20, 100 << 20):
                assert _same(ns.host_ring(z, net, background_flows=bg),
                             jns.host_ring(z, jnet, background_flows=jbg))
                assert _same(ns.innet_dense(z, net, background_flows=bg),
                             jns.innet_dense(z, jnet, background_flows=jbg))
                for d in (1 / 512, 0.05):
                    assert _same(
                        ns.sparcml(z, d, net=net, background_flows=bg),
                        jns.sparcml(z, d, net=jnet, background_flows=jbg))
                    assert _same(
                        ns.flare_sparse(z, d, net=net, spill_fraction=0.1,
                                        background_flows=bg),
                        jns.flare_sparse(z, d, net=jnet, spill_fraction=0.1,
                                         background_flows=jbg))
            assert _same(ns.figure15(net=net, background_flows=bg),
                         jns.figure15(net=jnet, background_flows=jbg))
    with pytest.raises(ValueError) as mine:
        ns.BackgroundFlow("backbone", 1.0)
    with pytest.raises(ValueError) as ref:
        jns.BackgroundFlow("backbone", 1.0)
    assert str(mine.value) == str(ref.value)


# ---------------------------------------------------------------------------
# The paper's claims, on the port's copies.
# ---------------------------------------------------------------------------

def test_design_selection_and_fig10_orderings():
    assert sm.select_design(64 << 10) == ("tree", 1)
    assert sm.select_design(200 << 10) == ("multi", 2)
    assert sm.select_design(400 << 10) == ("multi", 4)
    assert sm.select_design(1 << 20) == ("single", 1)
    small = {d: sm.model_design(d, 16 << 10, B=b).bandwidth_tbps
             for d, b in [("tree", 1), ("single", 1), ("multi", 4)]}
    assert small["tree"] > small["single"] and small["tree"] > small["multi"]
    big = {d: sm.model_design(d, 4 << 20, B=b).bandwidth_tbps
           for d, b in [("tree", 1), ("single", 1), ("multi", 4)]}
    assert big["single"] >= big["multi"] * 0.95
    assert big["single"] >= big["tree"] * 0.95
    assert big["single"] > ss.SHARP_TBPS
    assert small["tree"] > ss.SWITCHML_TBPS


def test_eq1_queue_and_contention_model():
    p = sm.SwitchParams()
    K, tau = p.cores, p.packet_cycles
    qs = [sm.input_buffer_pkts(64, K, s, sm.delta_k(s, p.delta, K, p.delta),
                               tau) for s in (1, 2, 4, 8)]
    assert all(a >= b - 1e-9 for a, b in zip(qs, qs[1:]))
    qd = [sm.input_buffer_pkts(64, K, 8, sm.delta_k(8, dc, K, p.delta), tau)
          for dc in (p.delta, 4 * p.delta, 64 * p.delta)]
    assert all(a >= b - 1e-9 for a, b in zip(qd, qd[1:]))
    L, C = 1024.0, 8
    assert sm.tau_single(L, C, 1, 0.0) == L
    assert sm.tau_single(L, C, 8, 2 * L) == L
    assert sm.tau_single(L, C, 8, 0.5 * L) == L * (C + 1) / 2


@given(st.integers(2, 64), st.integers(1, 8))
@settings(max_examples=20, deadline=None)
def test_tree_tau_bounds(p_, b):
    assert sm.tau_tree(1024.0, p_) <= 1024.0 + 64.0
    assert sm.buffers_per_block("tree", p_) >= 1.0
    assert sm.buffers_per_block("multi", p_, b) == b


def test_sparse_storage_model():
    dense = sm.bandwidth_tbps(sm.SwitchParams(), 1024.0)
    h = [sm.sparse_bandwidth_tbps("hash", d) for d in (0.001, 0.01, 0.2)]
    a = [sm.sparse_bandwidth_tbps("array", d) for d in (0.001, 0.01, 0.2)]
    assert max(h) - min(h) < 1e-6
    assert a[0] < h[0] < dense
    assert a[-1] > h[-1]


def test_des_claims():
    """Fig. 11 and 14 on the port's simulator: small messages order tree >
    multi > single; large ones let the single buffer catch up with the
    least working memory; smaller dtypes aggregate more elements a
    second; hash spill grows with density; every block completes once."""
    for seed in (0, 1):
        bw = {d: ss.simulate(d, 64 << 10, B=b, P=64,
                             seed=seed).bandwidth_tbps
              for d, b in [("single", 1), ("multi", 4), ("tree", 1)]}
        assert bw["tree"] > bw["multi"] > bw["single"]
        assert bw["tree"] > ss.SWITCHML_TBPS
    r = {d: ss.simulate(d, 1 << 20, P=64) for d in ("single", "tree")}
    assert r["single"].bandwidth_tbps > 3.0
    assert r["single"].bandwidth_tbps > 0.8 * r["tree"].bandwidth_tbps
    assert r["single"].max_working_memory_bytes <= \
        r["tree"].max_working_memory_bytes
    z = 256 << 10
    elems = {dt: ss.simulate("single", z, P=64,
                             cycles_per_byte=ss.CYCLES_PER_BYTE[dt]
                             ).bandwidth_tbps / 8 / eb
             for dt, eb in [("int32", 4), ("int16", 2), ("int8", 1)]}
    assert elems["int8"] > elems["int16"] > elems["int32"]
    lo = ss.simulate("single", z, P=64, sparse_density=0.01)
    hi = ss.simulate("single", z, P=64, sparse_density=0.2)
    assert hi.extra_traffic_bytes > lo.extra_traffic_bytes
    assert lo.blocks_completed > 0
    assert ss.simulate("tree", z, P=64).blocks_completed == z // 1024


def test_fig15_claims():
    out = ns.figure15()
    t = {k: v.time_us for k, v in out.items()}
    assert t["flare_sparse"] < t["sparcml"] < t["innet_dense"] \
        < t["host_ring"]
    ring, dense = out["host_ring"], out["innet_dense"]
    assert 1.8 < ring.time_us / dense.time_us < 2.5
    assert 1.7 < ring.network_bytes / dense.network_bytes < 2.3
    f, s = out["flare_sparse"], out["sparcml"]
    assert f.time_us < s.time_us and f.network_bytes < s.network_bytes
    assert 8 < dense.network_bytes / f.network_bytes < 25
    ds = [ns._union_density(0.002, n, 0.15) for n in (1, 8, 64)]
    assert ds[0] < ds[1] < ds[2]


def test_link_rates_and_background_flows():
    assert ns.FatTree(link_gbps=1000.0).link_bytes_per_us == 1.25e5
    net = ns.FatTree()
    rates = ns.effective_link_rates(net)
    assert set(rates) == set(ns.LINK_CLASSES)
    assert all(r == net.link_bytes_per_us for r in rates.values())
    assert ns.BackgroundFlow("host_leaf", 8.0).bytes_per_us == 1e3
    bg = [ns.BackgroundFlow("host_leaf", 50.0),
          ns.BackgroundFlow("leaf_spine", 50.0)]
    idle, busy = ns.figure15(), ns.figure15(background_flows=bg)
    for name in idle:
        assert busy[name].time_us > idle[name].time_us, name
        assert busy[name].network_bytes == idle[name].network_bytes, name
