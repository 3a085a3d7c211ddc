"""The port's wire dense reduction against the JAX package's, bitwise.

The same seeded numpy inputs go through the JAX function under nested
``jax.vmap`` over ``("pod", "data")`` and through its port on the
rank-axis layout, on the meshes ``(2, 4)``, ``(1, 8)`` and ``(2, 3)``
(a fan-in that is not a power of two, where the ring takes over):

* the ring reduce-scatter, all-gather and allreduce at staggers 0, 5, -1
  and one a bucket (``arange(B)``), f32 and bf16, with a length that
  needs padding; the bucketed ring, the two-level schedule (every inner
  × outer pair), the hierarchical schedule and its bucketed form, with
  and without the fixed tree, and ``allreduce`` for every algorithm;
* the FSDP pair on the ring, ordered or not; ``wire_bytes_per_rank``,
  ``reproducible`` and ``combine_order``; the bucket plan and its
  pack / unpack;
* ``transports.from_config`` on the wire, batched and per bucket, and
  ``GradReducer`` with ``arena`` True and False.

Every combine is the same IEEE operation in the same order: tolerance
zero.  The one exception is ``psum``, whose order XLA leaves unspecified:
it is held at 1e-6.  Where the reference raises (rhd and the fixed tree
need power-of-two axes), the port raises the same ``ValueError``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bucketing as jbucketing
from repro.core import collectives as jcoll
from repro.core import engine as jengine
from repro.core import reproducible as jrepro
from repro.core import transports as jtransports
from repro_torch import tree
from repro_torch.convert import params_from_jax, tensor_from_numpy
from repro_torch.core import bucketing, reproducible, transports
from repro_torch.core import collectives as coll
from repro_torch.core.engine import FlareConfig, GradReducer
from repro_torch.mesh import RankMesh

torch.set_num_threads(1)

AXES = ("pod", "data")
MESHES = [(2, 4), (1, 8), (2, 3)]
_INT = {1: np.int8, 2: np.int16, 4: np.int32}
#: a vector length divisible by every inner fan-in (3, 4, 8), one that
#: needs padding, and the buckets of an arena
N, RAGGED, B = 24, 22, 3
STAGGERS = (0, 5, -1)


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.contiguous()
        return a.view({1: torch.int8, 2: torch.int16,
                       4: torch.int32}[a.element_size()]).numpy()
    a = np.asarray(a)
    return a.view(_INT[a.dtype.itemsize])


def _nested(f):
    return jax.jit(jax.vmap(jax.vmap(f, axis_name="data"), axis_name="pod"))


def _rand(rng, shape, dtype="f32") -> np.ndarray:
    x = rng.normal(size=shape).astype(np.float32)
    return np.array(jnp.asarray(x, jnp.bfloat16)) if dtype == "bf16" else x


def _check(got, want, name="", exact=True):
    assert tuple(got.shape) == np.shape(want), name
    if exact:
        assert np.array_equal(_bits(got), _bits(want)), name
    else:
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=1e-6, atol=1e-6, err_msg=name)


def _refused(jf, tf, inputs) -> bool:
    """Whether the port refuses ``tf`` with ``ValueError``; if it does,
    the reference must refuse ``jf`` with the same message (while
    tracing, before any compile)."""
    try:
        tf(*[tensor_from_numpy(a, "cpu") for a in inputs])
    except ValueError as e:
        with pytest.raises(ValueError) as ref:
            _nested(jf)(*inputs)
        assert str(ref.value) == str(e)
        return True
    return False


def _bucketed(f):
    """The reference's ``f(x, stagger)`` over a ``(B, ...)`` arena a
    rank, one stagger a bucket (its ``vmap``), jitted under the ranks'
    nested ``vmap``; the staggers come in broadcast over the ranks."""
    return _nested(lambda a, s: jax.vmap(f)(a, s))


def _staggers(mshape, values) -> np.ndarray:
    return np.broadcast_to(np.asarray(values, np.int32),
                           mshape + (len(values),)).copy()


# ---------------------------------------------------------------------------
# The ring.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("mshape", MESHES)
def test_ring_matches_jax(mshape, dtype):
    """Staggers 0, 5 and -1 on one vector (Python ints on the port's
    side), and ``arange(B)`` on an arena of B buckets (one int tensor);
    the allreduce on a length that needs padding.  The reference runs
    both in one call: the vector repeated over B buckets at staggers 0,
    5, -1, then the arena."""
    rng = np.random.default_rng(1)
    mesh, p = RankMesh(mshape), mshape[1]
    t = lambda a: tensor_from_numpy(a, "cpu")
    fns = [(jcoll.ring_reduce_scatter, coll.ring_reduce_scatter, N),
           (jcoll.ring_all_gather, coll.ring_all_gather, N // p),
           (jcoll.allreduce_ring, coll.allreduce_ring, RAGGED)]
    vecs = [_rand(rng, mshape + (n, 2), dtype) for _, _, n in fns]
    arenas = [_rand(rng, mshape + (B, n, 2), dtype) for _, _, n in fns]
    both = [np.concatenate([np.repeat(v[..., None, :, :], B, axis=-3), a],
                           axis=-3) for v, a in zip(vecs, arenas)]
    flat = _rand(rng, mshape + (B, N), dtype)

    def ref(x0, x1, x2, fl, s):
        out = [jax.vmap(lambda y, q, f=f: f(y, "data", stagger=q))(x, s)
               for (f, _, _), x in zip(fns, (x0, x1, x2))]
        return out + [jcoll.ring_allreduce_bucketed(fl, "data",
                                                    staggers=s[B:])]
    want = _nested(ref)(*both, flat,
                        _staggers(mshape, STAGGERS + tuple(range(B))))
    for (_, tf, _), v, a, w in zip(fns, vecs, arenas, want):
        for b, s in enumerate(STAGGERS):
            _check(tf(t(v), mesh, "data", stagger=s), w[..., b, :, :],
                   f"{tf.__name__} {s}")
        _check(tf(t(a), mesh, "data", stagger=torch.arange(B)),
               w[..., B:, :, :], f"{tf.__name__} arange")
    _check(coll.ring_allreduce_bucketed(t(flat), mesh, "data",
                                        staggers=torch.arange(B)), want[3],
           "bucketed")


def test_ring_rejects_a_length_the_axis_does_not_divide():
    x = torch.zeros(2, 4, 6)
    with pytest.raises(ValueError, match="len 6 % 4"):
        coll.ring_reduce_scatter(x, RankMesh((2, 4)), "data")
    with pytest.raises(ValueError, match="S 6 % 4"):
        coll.ring_allreduce_bucketed(x.reshape(2, 4, 1, 6), RankMesh((2, 4)),
                                     "data")


# ---------------------------------------------------------------------------
# The other schedules and the dispatch.
# ---------------------------------------------------------------------------

TWO_LEVEL_CASES = (
    [((2, 4), "f32", i, o) for i in ("ring", "rhd")
     for o in ("rhd", "ring", "fixed_tree", "psum")]
    + [((2, 4), "bf16", "ring", "rhd"), ((2, 4), "bf16", "rhd", "ring")]
    + [(m, "f32", i, "rhd") for m in ((1, 8), (2, 3))
       for i in ("ring", "rhd")]
    + [((2, 3), "bf16", "ring", "ring")])


@pytest.mark.parametrize("mshape,dtype,inner,outer", TWO_LEVEL_CASES)
def test_two_level_matches_jax(mshape, dtype, inner, outer):
    """Every inner × outer pair on ``(2, 4)``, the inner algorithms on
    the other meshes, f32 and bf16; one stagger a bucket, and an int on
    one vector."""
    rng = np.random.default_rng(2)
    mesh = RankMesh(mshape)
    arena = _rand(rng, mshape + (B, RAGGED, 2), dtype)
    st = (2, -1, 5)
    kw = dict(inner=inner, outer=outer)
    jf = lambda x, s: jcoll.allreduce_two_level(x, "data", "pod", stagger=s,
                                                **kw)
    tf = lambda x, s: coll.allreduce_two_level(x, mesh, "data", "pod",
                                               stagger=s, **kw)
    if _refused(lambda a: jf(a, 0), lambda a: tf(a, 0), [arena]):
        assert inner == "rhd" and mshape[1] == 3
        return
    want = _bucketed(jf)(arena, _staggers(mshape, st))
    exact = outer != "psum"
    t = tensor_from_numpy(arena, "cpu")
    _check(tf(t, torch.tensor(st)), want, "bucketed", exact)
    _check(tf(t[..., 0, :, :], st[0]), want[..., 0, :, :], "vector", exact)
    with pytest.raises(ValueError, match="unknown inner"):
        coll.allreduce_two_level(t, mesh, "data", "pod", inner="tree")
    with pytest.raises(ValueError, match="unknown outer"):
        coll.allreduce_two_level(t, mesh, "data", "pod", outer="tree")


@pytest.mark.parametrize("fixed", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("mshape", MESHES)
def test_hierarchical_matches_jax(mshape, dtype, fixed):
    """The bucketed form with staggers ``arange(B)`` and with none, and
    the vector form with an int stagger."""
    rng = np.random.default_rng(3)
    mesh = RankMesh(mshape)
    arena = _rand(rng, mshape + (B, RAGGED, 2), dtype)
    t = tensor_from_numpy(arena, "cpu")
    if _refused(lambda a: jcoll.hierarchical_allreduce(a, AXES,
                                                       fixed_tree=fixed),
                lambda a: coll.hierarchical_allreduce(a, mesh, AXES,
                                                      fixed_tree=fixed),
                [arena]):
        assert fixed and mshape[1] == 3
        return
    prog = _nested(lambda a, s: jcoll.hierarchical_allreduce_bucketed(
        a, AXES, staggers=s, fixed_tree=fixed))
    want = prog(arena, _staggers(mshape, range(B)))
    _check(coll.hierarchical_allreduce_bucketed(
        t, mesh, AXES, staggers=torch.arange(B), fixed_tree=fixed), want,
        "bucketed")
    _check(coll.hierarchical_allreduce(t[..., 1, :, :], mesh, AXES,
                                       stagger=1, fixed_tree=fixed),
           want[..., 1, :, :], "vector")
    _check(coll.hierarchical_allreduce_bucketed(t, mesh, AXES,
                                                fixed_tree=fixed),
           prog(arena, np.zeros(mshape + (B,), np.int32)), "no staggers")
# ---------------------------------------------------------------------------
# The FSDP pair on the ring.
# ---------------------------------------------------------------------------

ALGORITHMS = ["auto", "ring", "rhd", "fixed_tree", "two_level",
              "hierarchical", "psum"]
#: above the ring threshold in f32 (two_level on two axes, the ring on
#: one), between the thresholds in bf16 (rhd)
BIG = 140_000


DISPATCH_CASES = ([((2, 4), a) for a in ALGORITHMS]
                  + [(m, a) for m in ((1, 8), (2, 3))
                     for a in ("auto", "ring", "two_level", "hierarchical")])


@pytest.mark.parametrize("mshape,alg", DISPATCH_CASES)
def test_allreduce_dispatch_matches_jax(mshape, alg):
    """Every algorithm on ``(2, 4)``, the ring's and the tree's on the
    other meshes; one and two axes, f32 and bf16, below the tree
    threshold and (for ``auto``) above the others, with and without
    ``reproducible``."""
    rng = np.random.default_rng(4)
    mesh = RankMesh(mshape)
    cases = [(AXES, "f32", RAGGED, False)]
    if alg in ("auto", "fixed_tree", "hierarchical"):
        cases.append((AXES, "bf16", RAGGED, True))
    if alg in ("ring", "two_level", "psum"):
        cases.append((("data",), "bf16", RAGGED, False))
    if alg == "auto":
        cases += [(AXES, "f32", BIG, False), (("data",), "f32", BIG, False),
                  (AXES, "bf16", BIG, False)]
    ran = 0
    for axes, dtype, n, rep in cases:
        x = _rand(rng, mshape + (n,), dtype)
        kw = dict(algorithm=alg, reproducible=rep, stagger=3)
        jf = lambda a: jcoll.allreduce(a, axes, **kw)
        tf = lambda a: coll.allreduce(a, mesh, axes, **kw)
        if _refused(jf, tf, [x]):
            continue
        _check(tf(tensor_from_numpy(x, "cpu")), _nested(jf)(x),
               f"{axes} {dtype} {n} {rep}", alg != "psum")
        ran += 1
    assert ran > 0


def test_allreduce_refuses_what_the_reference_refuses():
    mesh, x = RankMesh((2, 4)), torch.zeros(2, 4, 8)
    for alg in ("ring", "rhd", "two_level", "psum"):
        with pytest.raises(ValueError, match="reproducible mode requires"):
            coll.allreduce(x, mesh, AXES, algorithm=alg, reproducible=True)
    for axes in (AXES, ("data",)):
        with pytest.raises(ValueError, match="unknown algorithm"):
            coll.allreduce(x, mesh, axes, algorithm="tree")


# ---------------------------------------------------------------------------
# The FSDP pair on the ring.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ordered", [False, True])
@pytest.mark.parametrize("mshape", MESHES)
def test_fsdp_ring_pair_matches_jax(mshape, ordered):
    """The reduce-scatter (ring over ``data``, then rhd over ``pod``) and
    the all-gather, in f32 unordered and in bf16 ordered."""
    rng = np.random.default_rng(5)
    mesh, p = RankMesh(mshape), mshape[1]
    dtype = "bf16" if ordered else "f32"
    x = _rand(rng, mshape + (N, 3), dtype)
    seg = _rand(rng, mshape + (N // p, 3), dtype)
    kw = dict(algorithm="ring", ordered=ordered, stagger=2)
    want = _nested(lambda a, s: (jcoll.reduce_scatter(a, AXES, **kw),
                                 jcoll.all_gather(s, AXES, **kw)))(x, seg)
    t = lambda a: tensor_from_numpy(a, "cpu")
    _check(coll.reduce_scatter(t(x), mesh, AXES, **kw), want[0], "rs")
    _check(coll.all_gather(t(seg), mesh, AXES, **kw), want[1], "ag")


# ---------------------------------------------------------------------------
# Pure functions: wire bytes, the reproducible module, combine order.
# ---------------------------------------------------------------------------

def test_wire_bytes_per_rank_matches_jax():
    n = 0
    for nbytes in (0, 1, 1000, 4 << 20, 1_229_004_800):
        for p_in in (1, 2, 3, 4, 8):
            for p_out in (1, 2, 3, 4):
                for alg in ("ring", "rhd", "fixed_tree", "two_level",
                            "hierarchical", "psum"):
                    assert (coll.wire_bytes_per_rank(
                        nbytes, p_in, p_out, algorithm=alg)
                        == jcoll.wire_bytes_per_rank(
                            nbytes, p_in, p_out, algorithm=alg))
                    n += 1
    assert n == 600
    with pytest.raises(ValueError):
        coll.wire_bytes_per_rank(8, 4, algorithm="tree")


@pytest.mark.parametrize("mshape", MESHES)
def test_reproducible_matches_jax(mshape):
    """Both modes on an f32 and a bf16 vector, and the reduce-scatter;
    the ``(2, 3)`` mesh is refused, its fan-in not a power of two."""
    rng = np.random.default_rng(6)
    mesh = RankMesh(mshape)
    x32 = _rand(rng, mshape + (RAGGED, 2))
    x16 = _rand(rng, mshape + (RAGGED, 2), "bf16")
    t = lambda a: tensor_from_numpy(a, "cpu")
    if _refused(lambda a: jrepro.reproducible_allreduce(a, AXES),
                lambda a: reproducible.reproducible_allreduce(a, mesh, AXES),
                [x32]):
        assert mshape[1] == 3
        return
    want = _nested(lambda a, b: [
        jrepro.reproducible_allreduce(a, AXES),
        jrepro.reproducible_allreduce(a, AXES, hierarchical=True),
        jrepro.reproducible_allreduce(b, AXES, hierarchical=True),
        jrepro.reproducible_reduce_scatter(a[:16], AXES)])(x32, x16)
    got = [reproducible.reproducible_allreduce(t(x32), mesh, AXES),
           reproducible.reproducible_allreduce(t(x32), mesh, AXES,
                                               hierarchical=True),
           reproducible.reproducible_allreduce(t(x16), mesh, AXES,
                                               hierarchical=True),
           reproducible.reproducible_reduce_scatter(t(x32[..., :16, :]), mesh,
                                                    AXES)]
    for i, (g, w) in enumerate(zip(got, want)):
        _check(g, w, str(i))


def test_combine_order_matches_jax():
    for p in range(1, 33):
        assert reproducible.combine_order(p) == jrepro.combine_order(p)


# ---------------------------------------------------------------------------
# The bucket plan.
# ---------------------------------------------------------------------------

LEAVES = [((3, 5), "float32"), ((), "float32"), ((7,), "bfloat16"),
          ((2, 2, 2), "int32"), ((40,), "float32"), ((9, 3), "bfloat16"),
          ((300,), "float32"), ((1,), "int32")]


def _leaf_arrays(rng, mshape):
    out = []
    for shape, dt in LEAVES:
        if dt == "int32":
            out.append(rng.integers(-99, 99, size=mshape + shape,
                                    dtype=np.int32))
        else:
            out.append(_rand(rng, mshape + shape,
                             "bf16" if dt == "bfloat16" else "f32"))
    return out


@pytest.mark.parametrize("stagger", [True, False])
@pytest.mark.parametrize("bucket_bytes", [1, 64, 1000, 4 << 20])
def test_build_buckets_matches_jax(bucket_bytes, stagger):
    rng = np.random.default_rng(7)
    arrays = _leaf_arrays(rng, (2, 4))
    want = jbucketing.build_buckets([a[0, 0] for a in arrays], bucket_bytes,
                                    stagger)
    got = bucketing.build_buckets([tensor_from_numpy(a, "cpu")
                                   for a in arrays], bucket_bytes, stagger,
                                  lead_dims=2)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.leaf_ids == w.leaf_ids and g.sizes == w.sizes
        assert str(g.dtype).removeprefix("torch.") == w.dtype.name
        assert (g.stagger, g.num_elements, g.nbytes) == (
            w.stagger, w.num_elements, w.nbytes)


def test_pack_unpack_bucket_round_trip_bitwise():
    rng = np.random.default_rng(8)
    arrays = _leaf_arrays(rng, (2, 4))
    leaves = [tensor_from_numpy(a, "cpu") for a in arrays]
    for b in bucketing.build_buckets(leaves, 200, lead_dims=2):
        flat = bucketing.pack_bucket(leaves, b, 2)
        want = np.stack([np.stack([np.asarray(jbucketing.pack_bucket(
            [a[i, j] for a in arrays], b)) for j in range(4)])
            for i in range(2)])
        assert np.array_equal(_bits(flat), _bits(want))
        pieces = bucketing.unpack_bucket(flat, leaves, b, 2)
        assert [i for i, _ in pieces] == list(b.leaf_ids)
        for i, piece in pieces:
            assert piece.shape == leaves[i].shape
            assert np.array_equal(_bits(piece), _bits(leaves[i]))


# ---------------------------------------------------------------------------
# Transports and the GradReducer on the wire.
# ---------------------------------------------------------------------------

WIRE_CONFIGS = {
    "auto": {}, "ring": dict(algorithm="ring"), "rhd": dict(algorithm="rhd"),
    "fixed_tree": dict(algorithm="fixed_tree"),
    "two_level": dict(algorithm="two_level"),
    "hierarchical": dict(algorithm="hierarchical"),
    "psum": dict(algorithm="psum"), "reproducible": dict(reproducible=True),
    "flat": dict(hierarchical=False), "forced": dict(hierarchical=True),
    "mean": dict(mean=True, algorithm="ring"),
}


#: the algorithms alone are the GradReducer test's; here the schedule
#: knobs, ``mean`` and ``psum``, and the per-bucket oracle on each mesh
TRANSPORT_CASES = (
    [((2, 4), True, c) for c in ("auto", "flat", "forced", "mean", "psum",
                                 "reproducible")]
    + [((2, 4), False, c) for c in ("auto", "ring", "reproducible")]
    + [(m, b, "auto") for m in ((1, 8), (2, 3)) for b in (True, False)]
    + [(m, False, "ring") for m in ((1, 8), (2, 3))])


@pytest.mark.parametrize("mshape,batched,config", TRANSPORT_CASES)
def test_dense_transport_matches_jax(mshape, batched, config):
    """``from_config`` on an f32 arena of three buckets (bf16 for
    ``auto``), the last one ragged, staggers ``arange(B)``."""
    rng = np.random.default_rng(9)
    mesh = RankMesh(mshape)
    s = 4 * mshape[0] * mshape[1]
    extents = (s, s, s - 5)
    bf16 = config == "auto"
    a = _rand(rng, mshape + (B, s), "bf16" if bf16 else "f32")
    a[..., -1, s - 5:] = 0
    cfg = dict(axes=AXES, **WIRE_CONFIGS[config])
    jt = jtransports.from_config(jengine.FlareConfig(**cfg),
                                 jnp.bfloat16 if bf16 else jnp.float32,
                                 batched=batched)
    tt = transports.from_config(FlareConfig(**cfg), mesh,
                                torch.bfloat16 if bf16 else torch.float32,
                                batched=batched)
    assert isinstance(tt, transports.DenseTransport)
    assert tt.batched is batched
    st = torch.arange(B, dtype=torch.int32)
    if _refused(lambda x: jt(x, None, jnp.arange(B), extents)[0],
                lambda x: tt(x, None, st, extents)[0], [a]):
        assert mshape[1] == 3 and config == "reproducible"
        return
    want = _nested(lambda x, sj: jt(x, None, sj, extents)[0])(
        a, _staggers(mshape, range(B)))
    got, ef = tt(tensor_from_numpy(a, "cpu"), torch.ones(a.shape), st,
                 extents)
    _check(got, want, config, config != "psum")
    assert torch.equal(ef, torch.zeros(a.shape))


def test_switch_transport_takes_batched():
    mesh = RankMesh((2, 4))
    for b in (True, False):
        for kw in ({}, dict(compression="int8"), dict(sparse_k_frac=0.1)):
            t = transports.from_config(
                FlareConfig(axes=AXES, transport="innetwork", **kw), mesh,
                torch.float32, batched=b)
            assert isinstance(t, transports.SwitchTransport)
            assert t.batched is b
    # the wire int8 transport's per-bucket oracle gives the reference's
    # bits
    t = transports.from_config(FlareConfig(axes=AXES, compression="int8"),
                               mesh, torch.float32, batched=False)
    assert isinstance(t, transports.Int8Transport) and t.batched is False
    jt = jtransports.from_config(jengine.FlareConfig(axes=AXES,
                                                     compression="int8"),
                                 jnp.float32, batched=False)
    a = _rand(np.random.default_rng(13), (2, 4, B, 300))
    want = _nested(lambda x: jt(x, jnp.zeros_like(x), jnp.arange(B),
                                (300,) * B))(a)
    got = t(tensor_from_numpy(a, "cpu").clone(), None,
            torch.arange(B, dtype=torch.int32), (300,) * B)
    for g, w in zip(got, want):
        _check(g, w, "int8 per bucket")


REDUCER_CONFIGS = {k: WIRE_CONFIGS[k] for k in (
    "auto", "ring", "rhd", "fixed_tree", "two_level", "hierarchical",
    "reproducible")}


def _reducer_grads(rng, mshape, big=False):
    """A mixed f32 / bf16 / int32 tree; ``big`` makes its f32 arena 1.2 MB
    a rank, above the ring threshold in buckets of 1 MiB."""
    return {"w": _rand(rng, mshape + ((300, 1000) if big else (30, 40))),
            "b": [_rand(rng, mshape + (77,)), _rand(rng, mshape + (5, 3))],
            "h": _rand(rng, mshape + (33, 3), "bf16"),
            "n": rng.integers(-99, 99, size=mshape + (6,), dtype=np.int32)}


REDUCER_CASES = (
    [((2, 4), c, a) for c in sorted(REDUCER_CONFIGS) for a in (True, False)]
    + [((1, 8), "auto", a) for a in (True, False)])


@pytest.mark.parametrize("mshape,config,arena", REDUCER_CASES)
def test_grad_reducer_wire_matches_jax(mshape, config, arena):
    """Several buckets of 2 KiB a dtype (1 MiB for ``auto`` on ``(1,
    8)``, where each resolves to the ring)."""
    big = mshape == (1, 8) and config == "auto"
    grads = _reducer_grads(np.random.default_rng(10), mshape, big)
    cfg = dict(axes=AXES, arena=arena,
               bucket_bytes=(1 << 20) if big else 2048,
               **REDUCER_CONFIGS[config])
    jred = jengine.GradReducer(jengine.FlareConfig(**cfg))
    want = _nested(lambda g: jred(g)[0])(grads)
    got, state = GradReducer(FlareConfig(**cfg), RankMesh(mshape))(
        params_from_jax(grads, "cpu"))
    assert state is None
    for a, b in zip(tree.flatten(got)[0], jax.tree.leaves(want)):
        _check(a, b, config)


@pytest.mark.parametrize("mshape", [(2, 4), (1, 8)])
def test_arena_and_per_bucket_paths_agree(mshape):
    """Where the combine is elementwise (the fixed trees, rhd) the arena
    and the per-bucket loop give the same bits; the in-network
    per-bucket path matches the reference's."""
    grads = _reducer_grads(np.random.default_rng(11), mshape)
    mesh = RankMesh(mshape)
    for kw in (dict(reproducible=True), dict(algorithm="fixed_tree"),
               dict(algorithm="rhd")):
        outs = [GradReducer(FlareConfig(axes=AXES, arena=a, bucket_bytes=2048,
                                        **kw), mesh)(
                                            params_from_jax(grads, "cpu"))[0]
                for a in (True, False)]
        for a, b in zip(*(tree.flatten(o)[0] for o in outs)):
            _check(a, b, str(kw))
    if mshape != (2, 4):
        return
    cfg = dict(axes=AXES, transport="innetwork", reproducible=True,
               arena=False)
    grads = {"w": grads["w"], "h": grads["h"]}
    jred = jengine.GradReducer(jengine.FlareConfig(**cfg))
    want = _nested(lambda g: jred(g)[0])(grads)
    got, _ = GradReducer(FlareConfig(**cfg), mesh)(
        params_from_jax(grads, "cpu"))
    for a, b in zip(tree.flatten(got)[0], jax.tree.leaves(want)):
        _check(a, b, "innetwork")
