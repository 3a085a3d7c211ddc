"""The port's switch data plane against the JAX package's, bitwise.

* **Framing** — ``FramePlan`` and ``packetize``/``depacketize`` equal the
  JAX package's on NaN-free payloads; with NaN payloads the port keeps
  every bit, checked against the numpy bits (the JAX framing quietens
  bf16 signalling NaNs on the CPU, a known deviation of the reference).
* **Data plane** — ``switch_allreduce_dense`` on both meshes, batched and
  per-packet, reproducible or not, with and without adversarial per-slot
  arrival permutations, equals JAX's run under nested ``jax.vmap``.
* **F3** — the in-network fixed tree equals the wire fixed tree.
* **Counters** — ``plan_counters``, ``tree_counters``, ``model_point`` and
  ``combines_per_packet_slot`` equal the reference's.

Every combine is the same add in the same order: tolerance zero.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import collectives as jcoll
from repro.switch import dataplane as jdp
from repro.switch import packets as jpk
from repro_torch.convert import tensor_from_numpy
from repro_torch.core import collectives as coll
from repro_torch.kernels import ops
from repro_torch.mesh import RankMesh
from repro_torch.switch import dataplane, packets as pk

torch.set_num_threads(1)

AXES = ("pod", "data")
_INT = {1: np.int8, 2: np.int16, 4: np.int32}


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.contiguous()
        return a.view({1: torch.int8, 2: torch.int16,
                       4: torch.int32}[a.element_size()]).numpy()
    a = np.asarray(a)
    return a.view(_INT[a.dtype.itemsize])


def _nested(f):
    return jax.jit(jax.vmap(jax.vmap(f, axis_name="data"), axis_name="pod"))


def _values(rng, shape, dtype) -> np.ndarray:
    """NaN-free seeded values in ``dtype``."""
    if dtype in ("int32", "int8"):
        info = np.iinfo(dtype)
        return rng.integers(info.min, info.max, size=shape, dtype=dtype)
    x = (rng.normal(size=shape) * 10).astype(np.float32)
    return np.asarray(jnp.asarray(x).astype(dtype))


# ---------------------------------------------------------------------------
# Framing.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16", "int32",
                                   "int8"])
def test_framing_matches_jax(dtype):
    rng = np.random.default_rng(len(dtype))
    b, s = 3, 37
    fmt, jfmt = pk.PacketFormat(mtu_bytes=64), jpk.PacketFormat(mtu_bytes=64)
    arena = _values(rng, (b, s), dtype)
    t = tensor_from_numpy(arena, "cpu")

    plan, jplan = pk.FramePlan(b, s, t.dtype, fmt), jpk.FramePlan(
        b, s, arena.dtype, jfmt)
    assert (plan.num_packets, plan.pad) == (jplan.num_packets, jplan.pad)
    packed = plan.pack(t)
    assert np.array_equal(_bits(packed), _bits(jplan.pack(jnp.asarray(arena))))
    assert np.array_equal(plan.child_headers(3), jplan.child_headers(3))
    assert np.array_equal(_bits(plan.unpack(packed)), _bits(arena))

    stream = pk.packetize(t, fmt, child_rank=3)
    jstream = jpk.packetize(jnp.asarray(arena), jfmt, child_rank=3)
    assert np.array_equal(stream.headers.numpy(), np.asarray(jstream.headers))
    assert np.array_equal(_bits(stream.payload), _bits(jstream.payload))
    perm = torch.from_numpy(rng.permutation(stream.num_packets))
    shuffled = pk.PacketStream(stream.headers[perm], stream.payload[perm])
    assert np.array_equal(_bits(pk.depacketize(shuffled, fmt, b, s)),
                          _bits(arena))

    # the rank axes ride in front; each rank stamps its own child id
    mesh = RankMesh((2, 4))
    lead = tensor_from_numpy(_values(rng, (2, 4, b, s), dtype), "cpu")
    ranked = pk.packetize(lead, fmt, child_rank=mesh.axis_index("data"))
    assert torch.equal(ranked.headers[..., pk.HDR_CHILD],
                       mesh.axis_index("data").unsqueeze(-1).expand(
                           2, 4, plan.num_packets))
    assert torch.equal(pk.depacketize(ranked, fmt, b, s), lead)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_framing_keeps_nan_bits(dtype):
    """Any bit pattern survives framing, signalling NaNs included: element
    32 (the ragged tail at MTU 64) holds bf16 0x7fbf / f16 0x7d01."""
    rng = np.random.default_rng(0)
    b, s = 2, 33
    raw = rng.integers(0, 1 << 16, size=(b, s), dtype=np.uint16)
    raw[:, 32] = 0x7FBF if dtype == "bfloat16" else 0x7D01
    t = torch.from_numpy(raw.view(np.int16)).view(getattr(torch, dtype))
    fmt = pk.PacketFormat(mtu_bytes=64)
    plan = pk.FramePlan(b, s, t.dtype, fmt)
    assert np.array_equal(_bits(plan.unpack(plan.pack(t))), raw.view(np.int16))
    stream = pk.packetize(t, fmt)
    assert np.array_equal(_bits(pk.depacketize(stream, fmt, b, s)),
                          raw.view(np.int16))


# ---------------------------------------------------------------------------
# The dense data plane.
# ---------------------------------------------------------------------------

MESHES = [(1, 8), (2, 4)]
#: (reproducible, design, dtype)
VARIANTS = [(True, "auto", "float32"), (True, "auto", "bfloat16"),
            (True, "auto", "int32"), (False, "single", "float32"),
            (False, "multi", "bfloat16")]


def _arrival(rng, mshape, b, s, dtype):
    """One adversarial per-slot ``(P, n)`` arrival order per tree level."""
    levels = dataplane._levels(RankMesh(mshape), AXES)
    n = pk.FramePlan(b, s, getattr(torch, dtype),
                     pk.DEFAULT_FORMAT).num_packets
    return [np.stack([rng.permutation(l.fanin) for _ in range(n)], axis=1)
            for l in levels]


def _run(mshape, x, *, perms, batched_jax=True, **kw):
    mesh = RankMesh(mshape)
    t = tensor_from_numpy(x, "cpu")
    want = _nested(lambda a: jdp.switch_allreduce_dense(
        a, AXES, arrival_perms=perms, batched=batched_jax, **kw))(
        jnp.asarray(x))
    got = [dataplane.switch_allreduce_dense(t, mesh, AXES,
                                            arrival_perms=perms,
                                            batched=b, **kw)
           for b in (True, False)]
    return _bits(want), [_bits(g) for g in got], t, mesh


@pytest.mark.parametrize("with_perms", [False, True])
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("mshape", MESHES)
def test_switch_allreduce_dense_matches_jax(mshape, variant, with_perms):
    reproducible, design, dtype = variant
    rng = np.random.default_rng(10 * MESHES.index(mshape)
                                + VARIANTS.index(variant))
    b, s = 3, 300
    x = _values(rng, mshape + (b, s), dtype)
    perms = _arrival(rng, mshape, b, s, dtype) if with_perms else None
    want, (batched, slots), t, mesh = _run(
        mshape, x, perms=perms, reproducible=reproducible, design=design)
    assert np.array_equal(batched, want), "batched plane != JAX"
    assert np.array_equal(slots, want), "per-packet plane != JAX"
    if reproducible and dtype != "int32":
        # F3: bitwise arrival-invariant and equal to the wire fixed tree
        # (the wire's reproducible mode sums int32 in fp32 too, the switch
        # natively, in both packages)
        wire = coll.allreduce(t, mesh, AXES, algorithm="fixed_tree",
                              reproducible=True)
        assert np.array_equal(_bits(wire), want)


@pytest.mark.parametrize("mshape,variant", [((2, 4), VARIANTS[1]),
                                                ((1, 8), VARIANTS[3])])
def test_per_packet_plane_matches_jax_per_packet_plane(mshape, variant):
    """The slot-loop oracle against JAX's own slot loop (``batched=False``)
    under per-slot arrival permutations."""
    reproducible, design, dtype = variant
    rng = np.random.default_rng(7)
    b, s = 2, 300
    x = _values(rng, mshape + (b, s), dtype)
    perms = _arrival(rng, mshape, b, s, dtype)
    want, (batched, slots), _, _ = _run(
        mshape, x, perms=perms, batched_jax=False,
        reproducible=reproducible, design=design)
    assert np.array_equal(slots, want)
    assert np.array_equal(batched, want)


@pytest.mark.parametrize("mshape,folds", [((1, 8), [(1, 8)]),
                                           ((2, 4), [(2, 4), (1, 2)])])
def test_batched_plane_folds_only_ranks_that_hold_data(mshape, folds,
                                                       monkeypatch):
    """One stack per switch that holds data, ``(G, P)`` per level: above
    the leaf level only the lower switches' ranks carry data, so the pod
    level of the ``(2, 4)`` mesh folds one stack of two, not four."""
    seen = []
    fold = ops.tree_reduce_slots

    def recording(x):
        seen.append(tuple(x.shape[:2]))
        return fold(x)

    monkeypatch.setattr(ops, "tree_reduce_slots", recording)
    x = _values(np.random.default_rng(5), mshape + (2, 300), "float32")
    out = dataplane.switch_allreduce_dense(
        tensor_from_numpy(x, "cpu"), RankMesh(mshape), AXES,
        reproducible=True)
    assert seen == folds
    assert tuple(out.shape) == x.shape


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mshape", MESHES)
def test_wire_fixed_tree_matches_jax(mshape, dtype):
    rng = np.random.default_rng(3)
    x = _values(rng, mshape + (2, 64), dtype)
    want = _nested(lambda a: jcoll.allreduce(
        a, AXES, algorithm="fixed_tree", reproducible=True))(jnp.asarray(x))
    got = coll.allreduce(tensor_from_numpy(x, "cpu"), RankMesh(mshape),
                         AXES, algorithm="fixed_tree", reproducible=True)
    assert np.array_equal(_bits(got), _bits(want))
    psum = coll.allreduce_psum(tensor_from_numpy(x, "cpu"),
                               RankMesh(mshape), AXES)
    assert psum.shape == x.shape
    # the wire ring, ported, gives the reference's bits
    want = _nested(lambda a: jcoll.allreduce(a, AXES, algorithm="ring"))(
        jnp.asarray(x))
    got = coll.allreduce(tensor_from_numpy(x, "cpu"), RankMesh(mshape),
                         AXES, algorithm="ring")
    assert np.array_equal(_bits(got), _bits(want))


# ---------------------------------------------------------------------------
# Static counters: the analytic model's inputs.
# ---------------------------------------------------------------------------

def _plain(x):
    """A counters dataclass as plain nested tuples (class name first)."""
    import dataclasses
    if dataclasses.is_dataclass(x):
        return (type(x).__name__,) + tuple(
            _plain(getattr(x, f.name)) for f in dataclasses.fields(x))
    if isinstance(x, tuple):
        return tuple(_plain(v) for v in x)
    return x


@pytest.mark.parametrize("kw", [dict(), dict(reproducible=True),
                                dict(design="single"),
                                dict(design="multi", batched=False),
                                dict(fmt="small")])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_plan_and_tree_counters_match_jax(dtype, kw):
    """``plan_counters`` on both meshes, ``tree_counters`` on the meshes'
    reduction trees, ``model_point`` at the plane's operating point and
    ``combines_per_packet_slot`` for every design equal the reference's
    (``tests/test_switch.py``), and batching changes none of them."""
    from repro.core import topology as jtopology
    from repro.switch import handlers as jhd
    from repro_torch.core import topology
    from repro_torch.switch import handlers as hd
    kw, jkw = dict(kw), dict(kw)
    if kw.pop("fmt", None):
        kw["fmt"], jkw["fmt"] = (pk.PacketFormat(mtu_bytes=256),
                                 jpk.PacketFormat(mtu_bytes=256))
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    for sizes in ((2, 4), (1, 8), (2, 3)):
        for b, s in ((3, 2048), (1, 1 << 20), (2, 37)):
            c = dataplane.plan_counters(AXES, sizes, b, s, tdt, **kw)
            want = jdp.plan_counters(AXES, sizes, b, s, jdt, **jkw)
            assert _plain(c) == _plain(want)
            assert c.total_combines == want.total_combines
            assert _plain(c.model_point(b * s * tdt.itemsize)) == _plain(
                want.model_point(b * s * tdt.itemsize))
            assert c == dataplane.plan_counters(
                AXES, sizes, b, s, tdt, **dict(kw, batched=False))
            tree = topology.build_mesh_tree(sizes)
            jtree = jtopology.build_mesh_tree(sizes)
            assert _plain(dataplane.tree_counters(tree, b, s, tdt, **kw)) \
                == _plain(jdp.tree_counters(jtree, b, s, jdt, **jkw))
    one = topology.build_mesh_tree((1,))
    assert _plain(dataplane.tree_counters(one, 2, 64, tdt)) == _plain(
        jdp.tree_counters(jtopology.build_mesh_tree((1,)), 2, 64, jdt))
    for design in hd.DESIGNS:
        for p in (1, 2, 4, 8, 64):
            assert hd.combines_per_packet_slot(p, design) == \
                jhd.combines_per_packet_slot(p, design) == p - 1
    with pytest.raises(ValueError, match="unknown aggregation design"):
        hd.combines_per_packet_slot(4, "bogus")
