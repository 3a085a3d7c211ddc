"""The port's lossy wire reductions against the JAX package's, bitwise.

The same seeded numpy inputs go through the JAX function under nested
``jax.vmap`` over ``("pod", "data")`` and through its port on the
rank-axis layout, on the meshes ``(2, 4)``, ``(1, 8)`` and ``(2, 3)``:

* ``RankMesh.all_to_all`` against ``lax.all_to_all``;
* the int8 wire protocol (every ``quantized_*`` function, flat and
  batched, f32 and bf16, a length that needs padding, ``mean`` True and
  False) and the wire order of its accumulation against the jitted
  ``jnp.sum`` leg;
* the sparse recursive-doubling schedules (``sparse_allreduce``, its
  two-level and hierarchical forms, flat and batched, ragged ``ks``)
  at thresholds that keep the lists sparse, densify mid-tree and
  densify before the first hop; ``expected_sparse_wire_bytes``;
* ``transports.from_config`` for the wire int8 and sparse transports,
  batched and per bucket, result and error-feedback state;
  ``GradReducer`` with ``arena`` True and False over two steps; the
  launcher with ``--compression int8`` and ``--sparse-k``.

Every result is held bitwise (tolerance zero).  Where the reference
refuses a mesh (the recursive doubling needs power-of-two axes), the
port raises the same ``ValueError``.
"""
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.core import compression as jcomp
from repro.core import engine as jengine
from repro.core import sparse as jsparse
from repro.core import transports as jtransports
from repro.kernels import ops as jops
from repro_torch import tree
from repro_torch.convert import params_from_jax, tensor_from_numpy
from repro_torch.core import compression, sparse, transports
from repro_torch.core.engine import FlareConfig, GradReducer
from repro_torch.kernels import ops
from repro_torch.launch import train as launch_train
from repro_torch.mesh import RankMesh

torch.set_num_threads(1)

AXES = ("pod", "data")
MESHES = [(2, 4), (1, 8), (2, 3)]
_INT = {1: np.int8, 2: np.int16, 4: np.int32}


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.contiguous()
        return a.view({1: torch.int8, 2: torch.int16,
                       4: torch.int32}[a.element_size()]).numpy()
    a = np.asarray(a)
    return a.view(_INT[a.dtype.itemsize])


def _same(got, want, what=""):
    assert tuple(got.shape) == np.shape(want), what
    assert np.array_equal(_bits(got), _bits(want)), what


def _nested(f):
    return jax.jit(jax.vmap(jax.vmap(f, axis_name="data"), axis_name="pod"))


def _rand(rng, shape, dtype="f32") -> np.ndarray:
    x = rng.normal(size=shape).astype(np.float32)
    return np.array(jnp.asarray(x, jnp.bfloat16)) if dtype == "bf16" else x


def _t(a) -> torch.Tensor:
    return tensor_from_numpy(np.asarray(a), "cpu")


# ---------------------------------------------------------------------------
# all_to_all.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.int8, np.float32])
@pytest.mark.parametrize("mshape", MESHES)
def test_all_to_all_matches_lax(mshape, dtype):
    """Tiled with ``split_axis``/``concat_axis`` 0 and 1 in every pair,
    and untiled, over the ``data`` axis; rank r's chunk j is rank j's
    chunk r."""
    p = mshape[1]
    rng = np.random.default_rng(p)
    x = rng.integers(-100, 100, size=mshape + (2 * p, 3 * p)).astype(dtype)
    u = rng.integers(-100, 100, size=mshape + (p, 5)).astype(dtype)
    pairs = [(0, 0), (0, 1), (1, 0), (1, 1)]

    def jf(a, b):
        tiled = [lax.all_to_all(a, "data", s, c, tiled=True)
                 for s, c in pairs]
        untiled = [lax.all_to_all(b, "data", 0, c) for c in (0, 1)]
        return tiled + untiled
    want = _nested(jf)(x, u)
    mesh = RankMesh(mshape)
    got = ([mesh.all_to_all(_t(x), "data", s, c) for s, c in pairs]
           + [mesh.all_to_all(_t(u), "data", 0, c, tiled=False)
              for c in (0, 1)])
    for g, w, what in zip(got, want, pairs + ["untiled 0", "untiled 1"]):
        _same(g, w, str(what))
    with pytest.raises(ValueError, match="divisible"):
        mesh.all_to_all(_t(x)[..., :1, :], "data", 0, 0)


# ---------------------------------------------------------------------------
# The int8 wire protocol.
# ---------------------------------------------------------------------------

#: a per-rank length that needs padding on every mesh, and the buckets
Z, B = 1000, 3


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("mshape", MESHES)
def test_quantized_protocol_matches_jax(mshape, dtype):
    """Every ``quantized_*`` function and its batched form, ``mean`` True
    and False: one jitted reference call computes them all."""
    rng = np.random.default_rng(sum(mshape))
    x = _rand(rng, mshape + (B, Z), dtype)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32

    def jf(a):
        red, n = jcomp.quantized_reduce_scatter(a[0], "data")
        redb, nb = jcomp.quantized_reduce_scatter_batched(a, "data")
        out = [red, redb,
               jcomp.quantized_all_gather(red, "data", dtype=jdt, n=n),
               jcomp.quantized_all_gather_batched(redb, "data", dtype=jdt,
                                                  n=nb)]
        for mean in (False, True):
            out += [jcomp.quantized_allreduce(a[1], "data", mean=mean),
                    jcomp.quantized_allreduce_batched(a, "data", mean=mean),
                    jcomp.quantized_allreduce_hier(a[2], "data", "pod",
                                                   mean=mean),
                    jcomp.quantized_allreduce_hier_batched(
                        a, "data", ("pod",), mean=mean)]
        return out
    want = _nested(jf)(x)
    mesh, xt = RankMesh(mshape), _t(x)
    dt = xt.dtype
    red, n = compression.quantized_reduce_scatter(xt[..., 0, :], mesh, "data")
    redb, nb = compression.quantized_reduce_scatter_batched(xt, mesh, "data")
    assert n == nb == Z
    got = [red, redb,
           compression.quantized_all_gather(red, mesh, "data", dtype=dt, n=n),
           compression.quantized_all_gather_batched(redb, mesh, "data",
                                                    dtype=dt, n=nb)]
    for mean in (False, True):
        got += [compression.quantized_allreduce(xt[..., 1, :], mesh, "data",
                                                mean=mean),
                compression.quantized_allreduce_batched(xt, mesh, "data",
                                                        mean=mean),
                compression.quantized_allreduce_hier(
                    xt[..., 2, :], mesh, "data", "pod", mean=mean),
                compression.quantized_allreduce_hier_batched(
                    xt, mesh, "data", ("pod",), mean=mean)]
    names = ["rs", "rs batched", "ag", "ag batched"] + [
        f"{f} mean={m}" for m in (False, True)
        for f in ("allreduce", "batched", "hier", "hier batched")]
    for g, w, what in zip(got, want, names):
        _same(g, w, what)


def _wire_leg(p: int, batched: bool):
    """The reference's accumulation of the reduce-scatter leg, jitted as
    the protocol writes it (``compression.py``'s ``jnp.sum``)."""
    if batched:
        return jax.jit(lambda q, s: jnp.sum(
            q.astype(jnp.float32).reshape(2, p, -1, 256) * s[..., None],
            axis=1).reshape(2, -1))
    return jax.jit(lambda q, s: jnp.sum(
        q.astype(jnp.float32).reshape(p, -1, 256) * s[..., None],
        axis=0).reshape(-1))


@pytest.mark.parametrize("p", [2, 3, 4, 8])
def test_wire_order_accumulation_matches_the_jitted_sum(p):
    """The plain ``dequant_accum`` with ``wire_order`` is the reference's
    jitted ``jnp.sum`` leg, flat and batched, bit for bit; the default
    order stays the Pallas kernel's (interpret mode)."""
    rng = np.random.default_rng(40 + p)
    q = rng.integers(-127, 128, size=(2, p, 16 * 256), dtype=np.int8)
    s = (rng.random((2, p, 16)) * np.exp2(rng.integers(-8, 8, (2, p, 16)))
         ).astype(np.float32)
    flat = ops.dequant_accum(_t(q[0]), _t(s[0]), wire_order=True)
    _same(flat, _wire_leg(p, False)(q[0], s[0]), "flat")
    slots = ops.dequant_accum_slots(_t(q).reshape(2, p, 16, 256),
                                    _t(s).reshape(2, p, 16, 1),
                                    wire_order=True)
    _same(slots.reshape(2, -1), _wire_leg(p, True)(q, s), "batched")
    _same(ops.dequant_accum(_t(q[0]), _t(s[0])),
          jops.dequant_accum(q[0], s[0]), "switch order")


# ---------------------------------------------------------------------------
# The sparse schedules.
# ---------------------------------------------------------------------------

#: per-rank length, list capacity and ragged per-bucket ks
S, K, KS = 200, 7, (7, 5, 3)
#: thresholds: lists all the way, densify at the pod hop (mid-tree on
#: (2, 4)), densify before the first hop
THRESHOLDS = {"sparse": 0.5, "mid": 0.25, "first": 0.05}


def _sparse_calls(mod, x, mesh, thr, mean):
    """Every schedule on ``x`` (``(B, S)`` a rank): the reference's when
    ``mesh`` is None, the port's otherwise (with its mesh argument)."""
    m = () if mesh is None else (mesh,)
    kw = dict(density_threshold=thr, mean=mean)
    row = (lambda i: x[i]) if mesh is None else (lambda i: x[..., i, :])
    return [
        mod.sparse_allreduce(row(0), *m, "data", K, **kw),
        mod.sparse_allreduce(row(1), *m, "data", K, k_eff=5, **kw),
        mod.sparse_allreduce_batched(x, *m, "data", KS, **kw),
        mod.sparse_allreduce_two_level(row(2), *m, "data", "pod", K,
                                       k_eff=3, **kw),
        mod.sparse_allreduce_two_level_batched(x, *m, "data", "pod", KS,
                                               **kw),
        mod.sparse_allreduce_hier(row(0), *m, "data", ("pod",), K, k_eff=6,
                                  **kw),
        mod.sparse_allreduce_hier_batched(x, *m, "data", "pod", KS, **kw)]


SPARSE_CASES = ([((2, 4), t, "f32", False) for t in sorted(THRESHOLDS)]
                + [((2, 4), "mid", "bf16", True), ((1, 8), "sparse", "f32",
                                                   True)])


@pytest.mark.parametrize("mshape,thr,dtype,mean", SPARSE_CASES)
def test_sparse_schedules_match_jax(mshape, thr, dtype, mean):
    """Each schedule's result and its rank's contribution (the lists it
    sent, scattered as the reference returns them)."""
    rng = np.random.default_rng(7 * mshape[1] + len(thr))
    mesh = RankMesh(mshape)
    if True:
        x = _rand(rng, mshape + (3, S), dtype)
        want = _nested(lambda a: _sparse_calls(
            jsparse, a, None, THRESHOLDS[thr], mean))(x)
        got = _sparse_calls(sparse, _t(x), mesh, THRESHOLDS[thr], mean)
        for i, ((g, (val, idx)), (w, wm)) in enumerate(zip(got, want)):
            _same(g, w, f"schedule {i} {dtype}")
            _same(sparse.scatter_dense(val, idx, S), wm,
                  f"contribution {i} {dtype}")


def test_sparse_two_level_rings_across_a_pod_count_not_a_power_of_two():
    mesh, rng = RankMesh((3, 2)), np.random.default_rng(8)
    x = _rand(rng, (3, 2, 3, S))
    want = _nested(lambda a: jsparse.sparse_allreduce_two_level_batched(
        a, "data", "pod", KS)[0])(x)
    _same(sparse.sparse_allreduce_two_level_batched(_t(x), mesh, "data",
                                                    "pod", KS)[0], want)


@pytest.mark.parametrize("mshape", [(2, 3), (1, 6)])
def test_sparse_schedules_refuse_a_fan_in_not_a_power_of_two(mshape):
    mesh = RankMesh(mshape)
    x = np.zeros(mshape + (3, S), np.float32)
    for jf, tf in (
            (lambda a: jsparse.sparse_allreduce(a[0], "data", K),
             lambda t: sparse.sparse_allreduce(t[..., 0, :], mesh, "data",
                                               K)),
            (lambda a: jsparse.sparse_allreduce_batched(a, "data", KS),
             lambda t: sparse.sparse_allreduce_batched(t, mesh, "data", KS)),
            (lambda a: jsparse.sparse_allreduce_hier_batched(
                a, "data", "pod", KS),
             lambda t: sparse.sparse_allreduce_hier_batched(
                 t, mesh, "data", "pod", KS))):
        with pytest.raises(ValueError, match="power-of-two") as got:
            tf(_t(x))
        with pytest.raises(ValueError) as ref:
            _nested(jf)(x)
        assert str(ref.value) == str(got.value)
    # a GradReducer on the wire refuses such a mesh when it is built; a
    # dense one builds
    with pytest.raises(ValueError, match="power-of-two inner axis"):
        GradReducer(FlareConfig(axes=AXES, sparse_k_frac=0.1), mesh)
    GradReducer(FlareConfig(axes=AXES), mesh)
    GradReducer(FlareConfig(axes=AXES, sparse_k_frac=0.1,
                            transport="innetwork"), mesh)


def test_hierarchical_sparse_reducer_refuses_an_outer_axis_not_a_power_of_two():
    with pytest.raises(ValueError, match="power-of-two outer axes"):
        GradReducer(FlareConfig(axes=AXES, sparse_k_frac=0.1,
                                hierarchical=True), RankMesh((3, 2)))


def test_expected_sparse_wire_bytes_matches_jax():
    for z in (100, 1000, 1 << 20):
        for k in (1, 10, 300):
            for p in (1, 2, 8, 64):
                for thr in (0.01, 0.25, 1.0):
                    for eb in (2, 4):
                        kw = dict(density_threshold=thr, elem_bytes=eb)
                        assert sparse.expected_sparse_wire_bytes(
                            z, k, p, **kw) == \
                            jsparse.expected_sparse_wire_bytes(z, k, p, **kw)


# ---------------------------------------------------------------------------
# The transports, the reducer and the launcher.
# ---------------------------------------------------------------------------

#: the reference's transport check: B buckets of S_T, a ragged last one
B_T, S_T = 4, 64
EXTENTS = (S_T, S_T, S_T, 40)
TRANSPORTS = {"int8": dict(compression="int8"),
              "sparse": dict(sparse_k_frac=0.1),
              "densify": dict(sparse_k_frac=0.45, density_threshold=0.5)}


@pytest.mark.parametrize("axes", [("data",), AXES])
@pytest.mark.parametrize("config", sorted(TRANSPORTS))
def test_lossy_wire_transports_match_jax(config, axes):
    """``from_config`` on the wire, batched and per bucket, staggers
    ``arange(B)``: the result and the new error-feedback state bitwise,
    from a non-zero state, on ``(2, 4)``."""
    rng = np.random.default_rng(21)
    x = _rand(rng, (2, 4, B_T, S_T))
    ef = _rand(rng, (2, 4, B_T, S_T)) * 0.01
    mesh = RankMesh((2, 4))

    def jf(a, e):
        out = []
        for batched in (True, False):
            t = jtransports.from_config(
                jengine.FlareConfig(axes=axes, **TRANSPORTS[config]),
                jnp.float32, batched=batched)
            out += list(t(a, e, jnp.arange(B_T), EXTENTS))
        return out
    want = _nested(jf)(x, ef)
    for i, batched in enumerate((True, False)):
        t = transports.from_config(FlareConfig(axes=axes,
                                               **TRANSPORTS[config]),
                                   mesh, torch.float32, batched=batched)
        assert isinstance(t, transports.Int8Transport if config == "int8"
                          else transports.SparseTransport)
        # the transport consumes its arena: give it a copy
        red, new_ef = t(_t(x).clone(), _t(ef), torch.arange(B_T), EXTENTS)
        _same(red, want[2 * i], f"result batched={batched}")
        _same(new_ef, want[2 * i + 1], f"state batched={batched}")


@pytest.mark.parametrize("config", ["int8", "sparse"])
def test_batched_transports_issue_as_many_collectives_for_any_b(config):
    """The batched transports' collectives (ppermute, all_to_all,
    all_gather) carry every bucket: their count on ``(2, 4)`` is the
    same for 4 buckets as for 8; the per-bucket oracle's grows."""
    mesh = RankMesh((2, 4))
    counts = {}
    for batched in (True, False):
        for b in (4, 8):
            seen = {"ppermute": 0, "all_to_all": 0, "all_gather": 0}

            def counting(name):
                real = getattr(RankMesh, name)

                def wrapper(self, *a, **kw):
                    seen[name] += 1
                    return real(self, *a, **kw)
                return mock.patch.object(RankMesh, name, wrapper)
            t = transports.from_config(FlareConfig(axes=AXES,
                                                   **TRANSPORTS[config]),
                                       mesh, torch.float32, batched=batched)
            with counting("ppermute"), counting("all_to_all"), \
                    counting("all_gather"):
                t(torch.randn(2, 4, b, 1024), None, torch.arange(b),
                  (1024,) * b)
            counts[batched, b] = seen
    assert counts[True, 4] == counts[True, 8]
    assert sum(counts[True, 4].values()) > 0
    assert sum(counts[False, 8].values()) == 2 * sum(
        counts[False, 4].values())
    if config == "int8":     # hierarchical: a pair a leg and level
        assert counts[True, 4] == {"ppermute": 0, "all_to_all": 4,
                                   "all_gather": 4}


def _reducer_grads(rng, mshape, with_bf16):
    g = {"w": _rand(rng, mshape + (30, 40)),
         "b": [_rand(rng, mshape + (77,)), _rand(rng, mshape + (5, 3))],
         "n": rng.integers(-99, 99, size=mshape + (6,), dtype=np.int32)}
    if with_bf16:
        g["h"] = _rand(rng, mshape + (33, 3), "bf16")
    return g


REDUCER_CASES = [((2, 4), c, a) for c in ("int8", "sparse")
                 for a in (True, False)] + [
    ((1, 8), c, True) for c in ("int8", "sparse")]


@pytest.mark.parametrize("mshape,config,arena", REDUCER_CASES)
def test_grad_reducer_lossy_wire_matches_jax(mshape, config, arena):
    """Two steps with the error-feedback state carried, buckets of 2 KiB
    a dtype; int32 leaves ride the dense path.  The sparse tree holds a
    bf16 leaf too (its error feedback is bitwise; the int8 one's is not,
    ROADMAP queue 3)."""
    rng = np.random.default_rng(30)
    g1, g2 = (_reducer_grads(rng, mshape, config == "sparse")
              for _ in range(2))
    cfg = dict(axes=AXES, arena=arena, bucket_bytes=2048,
               **TRANSPORTS[config])
    jred = jengine.GradReducer(jengine.FlareConfig(**cfg))

    def two_steps(a, b):
        r1, s1 = jred(a, jred.init_state(a))
        r2, s2 = jred(b, s1)
        return r1, s1, r2, s2
    want = _nested(two_steps)(g1, g2)
    red = GradReducer(FlareConfig(**cfg), RankMesh(mshape))
    r1, s1 = red(params_from_jax(g1, "cpu"))
    s1_bits = [_bits(t).copy() for t in tree.flatten(s1)[0]]
    r2, s2 = red(params_from_jax(g2, "cpu"), s1)
    for got, w in zip((r1, s1_bits, r2, s2), want):
        leaves = got if isinstance(got, list) else tree.flatten(got)[0]
        for a, b in zip(leaves, jax.tree.leaves(w)):
            assert np.array_equal(_bits(a), _bits(b))


@pytest.mark.parametrize("flags", [
    ["--mesh", "2x4x1", "--compression", "int8"],
    ["--mesh", "2x4x1", "--sparse-k", "0.1"],
    ["--mesh", "8x1", "--compression", "int8"],
    ["--mesh", "8x1", "--sparse-k", "0.1"]])
def test_launcher_runs_the_lossy_wire_transports_on_cpu(flags, capsys):
    """No ``--transport``: the wire int8 and sparse transports, their
    state in ``opt["ef"]``; ``main`` runs the same job."""
    runs = []
    real_setup = launch_train.setup

    def setup(argv):
        runs.append(real_setup(argv))
        return runs[-1]
    with mock.patch.object(launch_train, "setup", setup):
        losses = launch_train.main(["--smoke", "--steps", "2", "--device",
                                    "cpu", *flags])
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert losses[1] < losses[0]
    assert capsys.readouterr().out.count(" loss ") == 2
    t = runs[0].step.reducer._transport(torch.float32, batched=True)
    assert isinstance(t, transports.Int8Transport if "int8" in flags
                      else transports.SparseTransport)
    ef = tree.flatten(runs[0].opt["ef"])[0]
    assert ef and any(bool(e.ne(0).any()) for e in ef)


@pytest.mark.parametrize("kw", [{}, dict(transport="innetwork"),
                                dict(algorithm="ring"),
                                dict(compression="int8")])
def test_mean_over_six_ranks_matches_jax(kw):
    """``mean`` on a world that is not a power of two: XLA divides by a
    constant as a product with its reciprocal, and so does the port."""
    g = {"w": _rand(np.random.default_rng(15), (2, 3, 50))}
    jred = jengine.GradReducer(jengine.FlareConfig(axes=AXES, mean=True,
                                                   **kw))
    want = _nested(lambda a: jred(a)[0])(g)
    got = GradReducer(FlareConfig(axes=AXES, mean=True, **kw),
                      RankMesh((2, 3)))(params_from_jax(g, "cpu"))[0]
    _same(got["w"], want["w"])
