"""The port's reduction trees and network manager against the JAX package.

The counterpart of ``tests/test_topology.py``: every tree the port builds
or rebuilds (``build_tree``, ``rebuild_excluding``,
``rebuild_excluding_switch``, ``rebuild_avoiding``, ``mesh_axes_as_tree``)
is equal node for node to the reference's; ``switch_slot``,
``slot_pools``, ``tree_cost``, the tree's byte counts and
``NetworkManager``'s leases agree, and errors carry the reference's
messages.  Plain Python on both sides: no tensors.
"""
import dataclasses
import math

import pytest
from hypothesis import given, settings, strategies as st

from repro.core import topology as jtopo
from repro_torch.core import topology


def _tree(t):
    """Everything a tree holds, as plain tuples."""
    if t is None:
        return None
    return (t.num_hosts, t.radix, t.levels, t.level_radices,
            tuple(dataclasses.astuple(n) for n in t.nodes))


def _props(t):
    """The derived quantities of a tree."""
    z = 100 << 20
    return (t.depth, t.leaf_fanin, _node(t.root), t.num_switches,
            t.switch_children_counts(), t.wire_bytes_per_host(z),
            t.total_network_bytes(z),
            tuple((n.is_host, n.is_root) for n in t.nodes))


def _node(n):
    return dataclasses.astuple(n)


def _same(mine, ref):
    assert _tree(mine) == _tree(ref)
    if mine is not None:
        assert _props(mine) == _props(ref)


def _raises_alike(f, jf):
    with pytest.raises(Exception) as mine:
        f()
    with pytest.raises(Exception) as ref:
        jf()
    assert type(mine.value).__name__ == type(ref.value).__name__
    assert str(mine.value) == str(ref.value)


@given(st.integers(1, 500), st.integers(2, 32))
@settings(max_examples=40, deadline=None)
def test_tree_structure_matches_jax(hosts, radix):
    t = topology.build_tree(hosts, radix)
    _same(t, jtopo.build_tree(hosts, radix))
    assert t.root.is_root and len(t.levels[0]) == hosts
    seen, stack = set(), [t.root.node_id]
    while stack:
        nid = stack.pop()
        seen.add(nid)
        stack.extend(t.nodes[nid].children)
    assert set(range(hosts)) <= seen


def test_build_tree_errors_and_traffic_match_jax():
    for args in ((0, 4), (4, 1)):
        _raises_alike(lambda: topology.build_tree(*args),
                      lambda: jtopo.build_tree(*args))
    t = topology.build_tree(64, 16)
    z = 100 << 20
    assert t.wire_bytes_per_host(z) == z
    assert 2 * z * 63 / 64 / t.wire_bytes_per_host(z) > 1.9


@given(st.integers(3, 300), st.integers(2, 16), st.integers(1, 5))
@settings(max_examples=40, deadline=None)
def test_rebuild_excluding_matches_jax(hosts, radix, stride):
    t, jt = topology.build_tree(hosts, radix), jtopo.build_tree(hosts, radix)
    failed = list(range(0, hosts, stride))[:hosts - 1]
    t2 = topology.rebuild_excluding(t, failed)
    _same(t2, jtopo.rebuild_excluding(jt, failed))
    assert t2.num_hosts == hosts - len(failed) and t2.radix == radix
    _raises_alike(lambda: topology.rebuild_excluding(t, range(hosts)),
                  lambda: jtopo.rebuild_excluding(jt, range(hosts)))


@pytest.mark.parametrize("hosts,radix,which", [
    (16, 4, "leaf0"), (13, 4, "leaf1"), (4, 4, "root"), (16, 4, "root"),
    (64, 4, "leaf0"), (64, 4, "mid0"), (27, 3, "leaf2"), (8, 2, "mid1"),
    (4, 2, "maximal")])
def test_rebuild_excluding_switch_matches_jax(hosts, radix, which):
    t, jt = topology.build_tree(hosts, radix), jtopo.build_tree(hosts, radix)
    if which == "maximal":
        # a 2-switch leaf level labelled radix-4 over 4 hosts
        t = dataclasses.replace(t, radix=4)
        jt = dataclasses.replace(jt, radix=4)
        which = "leaf0"
    if which == "root":
        sw = t.root.node_id
    else:
        lvl = 1 if which.startswith("leaf") else 2
        sw = t.levels[lvl][int(which[-1])]
    got = topology.rebuild_excluding_switch(t, sw)
    _same(got, jtopo.rebuild_excluding_switch(jt, sw))
    if got is not None:
        assert got.num_hosts == hosts
    _raises_alike(lambda: topology.rebuild_excluding_switch(t, 0),
                  lambda: jtopo.rebuild_excluding_switch(jt, 0))


def test_switch_slot_pools_and_tree_cost_match_jax():
    for hosts, radix in ((16, 4), (8, 4), (13, 3), (64, 4)):
        t, jt = topology.build_tree(hosts, radix), jtopo.build_tree(hosts,
                                                                    radix)
        assert topology.slot_pools(t) == jtopo.slot_pools(jt)
        for lvl in t.levels[1:]:
            for sw in lvl:
                assert topology.switch_slot(t, sw) == jtopo.switch_slot(jt,
                                                                       sw)
        _raises_alike(lambda: topology.switch_slot(t, 0),
                      lambda: jtopo.switch_slot(jt, 0))
    t, jt = topology.build_tree(8, 4), jtopo.build_tree(8, 4)
    for hot, pools in (({}, None), ({(1, 0): 2.0}, None),
                       ({(2, 0): 0.5}, None), ({(1, 2): 9.0}, {1: 3, 2: 1}),
                       ({}, {1: 1, 2: 1}), ({(1, 1): math.inf}, None)):
        assert topology.tree_cost(t, hot, pools) == jtopo.tree_cost(
            jt, hot, pools)
    assert topology.tree_cost(t, {(1, 0): 2.0}) == 12.0


_heat = st.one_of(st.floats(0.0, 8.0), st.just(math.inf))


@given(st.sampled_from([(2, 4), (1, 8), (4, 2), (2, 2, 2), (3, 3)]),
       st.data())
@settings(max_examples=40, deadline=None)
def test_rebuild_avoiding_matches_jax(sizes, data):
    t, jt = topology.build_mesh_tree(sizes), jtopo.build_mesh_tree(sizes)
    _same(t, jt)
    slots = [(lvl, i) for lvl, n in topology.slot_pools(t).items()
             for i in range(n)]
    hot = data.draw(st.dictionaries(st.sampled_from(slots), _heat,
                                    max_size=len(slots)), label="hot")
    _same(topology.rebuild_avoiding(t, hot), jtopo.rebuild_avoiding(jt, hot))
    # node-id keys resolve through the tree's slots
    sw = t.levels[1][0]
    _same(topology.rebuild_avoiding(t, {sw: 2.0}),
          jtopo.rebuild_avoiding(jt, {sw: 2.0}))


def test_rebuild_avoiding_routes_around_and_falls_back_like_jax():
    t, jt = topology.build_mesh_tree((2, 4)), jtopo.build_mesh_tree((2, 4))
    best = topology.rebuild_avoiding(t, {(1, 0): 2.0})
    _same(best, jtopo.rebuild_avoiding(jt, {(1, 0): 2.0}))
    assert sorted((len(best.nodes[n].children) for n in best.levels[1]),
                  reverse=True) == [6, 2]
    all_hot = {(lvl, i): math.inf for lvl, n in topology.slot_pools(
        t).items() for i in range(n)}
    assert topology.rebuild_avoiding(t, all_hot) is None
    assert jtopo.rebuild_avoiding(jt, all_hot) is None


def _lease(lease):
    if lease is None:
        return None
    return (lease.allreduce_id, _tree(lease.tree), lease.buffers_per_switch,
            lease.packet_bytes)


def _manager_script(topo):
    """One sequence of requests, failures and releases; what it saw."""
    out = []
    nm = topo.NetworkManager(max_concurrent=2)
    a, b = nm.request(64, radix=4), nm.request(64)
    out += [_lease(a), _lease(b), _lease(nm.request(64))]
    out.append((nm.bytes_per_allreduce, nm.l1_bytes, nm.max_concurrent))
    out.append(nm.max_inflight_blocks(a, buffers_per_block=4))
    a2 = nm.handle_switch_failure(a, a.tree.levels[1][0])
    out += [_lease(a2), [_lease(x) for x in nm.active()]]
    out.append(_lease(nm.handle_switch_failure(a2, a2.tree.root.node_id)))
    nm.release(b.allreduce_id)
    out += [[_lease(x) for x in nm.active()], _lease(nm.request(16, 2))]
    return out


def test_network_manager_matches_jax():
    got = _manager_script(topology)
    assert got == _manager_script(jtopo)
    assert got[2] is None                  # rejected → host-based fallback
    assert got[5][0] == got[0][0]          # a failure keeps the lease id
    assert got[7] is None                  # root failure → host fallback


@pytest.mark.parametrize("sizes", [(2, 16), (8,), (1, 8), (2, 4), (1, 1)])
def test_mesh_axes_as_tree_matches_jax(sizes):
    _same(topology.mesh_axes_as_tree(sizes), jtopo.mesh_axes_as_tree(sizes))
