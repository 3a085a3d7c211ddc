"""The port's int8 in-network reduction (F1) against the JAX package's.

The same seeded numpy inputs go through the jitted JAX functions (kernels
in interpret mode through ``repro.kernels.ops``, the data plane and the
reducer under nested ``jax.vmap`` over ``("pod", "data")``) and through
``repro_torch`` on the CPU, where every kernel wrapper runs its plain
version.

Under ``jit`` XLA contracts the quantization arithmetic: the scale is
``max|x| * fl32(1/127)``, the dequant-accumulate fold is ``fma(q0, s0,
q1·s1)`` then ``fma(qi, si, acc)``, and the fp32 error-feedback residual
is ``fma(-q, s, v)``.  The port computes exactly that, so the tolerance
is zero, except where the reference itself has no single answer:

* the ``tree`` design dequantizes and then folds, and the reference's
  own batched and per-packet planes differ there by an ulp: ``tree``
  results are held to one int8 step of the output block (its root
  scale), the handler to ``rtol = atol = 1e-6``;
* with bf16 leaves the reference keeps ``grad + ef`` in fp32 where the
  port rounds it to bf16: the second step's result is held to one int8
  step, the state stays bitwise.

The port's own planes, batched and per-packet, agree bit for bit in every
design.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as jcomp
from repro.core import engine as jengine
from repro.core import transports as jtransports
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.switch import dataplane as jdp
from repro.switch import handlers as jhd
from repro_torch import tree
from repro_torch.convert import params_from_jax, tensor_from_numpy
from repro_torch.core import arena as arena_mod, compression, transports
from repro_torch.core.engine import FlareConfig, GradReducer
from repro_torch.kernels import ops, quant, ref
from repro_torch.mesh import RankMesh
from repro_torch.switch import dataplane, handlers as hd
from repro_torch.switch import packets as pk

torch.set_num_threads(1)

AXES = ("pod", "data")
MESHES = [(1, 8), (2, 4)]
_INT = {1: np.int8, 2: np.int16, 4: np.int32}


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.contiguous()
        return a.view({1: torch.int8, 2: torch.int16,
                       4: torch.int32}[a.element_size()]).numpy()
    a = np.asarray(a)
    return a.view(_INT[a.dtype.itemsize])


def _t(a) -> torch.Tensor:
    return tensor_from_numpy(np.asarray(a), "cpu")


def _nested(f):
    return jax.jit(jax.vmap(jax.vmap(f, axis_name="data"), axis_name="pod"))


def _in_dtype(x: np.ndarray, dtype: str) -> np.ndarray:
    return np.asarray(jnp.asarray(x).astype(dtype))


def _edge_blocks(rng, rows: int, qblock: int) -> np.ndarray:
    """Rows of blocks: random magnitudes, an all-zero block, a block whose
    extremes are exact ±127 steps, and one of exact half steps
    ``k + ½`` (its scale is exactly 1.0), which round half to even."""
    nb = 6
    x = rng.normal(size=(rows, nb, qblock)) * rng.uniform(
        1e-3, 1e3, size=(rows, nb, 1))
    x[:, 1] = 0.0
    x[:, 2] = rng.uniform(-250, 250, size=(rows, qblock))
    x[:, 2, 0], x[:, 2, 1] = 254.0, -254.0
    halves = rng.integers(-126, 126, size=(rows, qblock)) + 0.5
    halves[:, 0] = 127.0
    x[:, 3] = halves
    return x.reshape(rows, nb * qblock).astype(np.float32)


# ---------------------------------------------------------------------------
# The kernels' plain versions.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_quantize_matches_jax(dtype):
    rng = np.random.default_rng(len(dtype))
    x = _in_dtype(_edge_blocks(rng, 4, 256), dtype)
    lead = x.reshape(2, 2, -1)
    wq, ws = jax.jit(jcomp.quantize_int8)(lead)
    pq, ps = jops.quantize(x.reshape(-1))              # the Pallas body
    assert np.array_equal(_bits(pq), _bits(wq).reshape(-1))
    assert np.array_equal(_bits(ps), _bits(ws).reshape(-1))

    q, s = compression.quantize_int8(_t(lead))
    assert q.dtype == torch.int8 and tuple(s.shape) == (2, 2, 6)
    assert np.array_equal(_bits(q), _bits(wq))
    assert np.array_equal(_bits(s), _bits(ws))
    fq, fs = ops.quantize(_t(x.reshape(-1)))
    assert np.array_equal(_bits(fq), _bits(pq))
    assert np.array_equal(_bits(fs), _bits(ps))
    # the edge blocks: a zero block has the floor scale, ties go to even
    assert (s[..., 1] == np.float32(1e-30)).all()
    assert (q.reshape(2, 2, 6, 256)[..., 2, :2] == torch.tensor(
        [127, -127], dtype=torch.int8)).all()
    assert (s[..., 3] == 1.0).all()


def test_quantize_pads_ragged_length_like_jax():
    x = np.random.default_rng(2).normal(size=300).astype(np.float32)
    wq, ws = jops.quantize(x)
    q, s = ops.quantize(_t(x))
    assert q.shape == (512,) and np.array_equal(_bits(q), _bits(wq))
    assert np.array_equal(_bits(s), _bits(ws))
    with pytest.raises(ValueError, match="% 256"):
        compression.quantize_int8(_t(x))


def test_quantize_nan_and_inf_blocks_agree_on_scales():
    """A NaN or an inf in a block makes its scale NaN or inf in both
    packages.  Converting NaN to int8 is undefined in both frameworks, so
    only the scales are compared."""
    x = np.random.default_rng(3).normal(size=(4, 256)).astype(np.float32)
    x[0, 5], x[1, 9], x[2, 0] = np.nan, np.inf, -np.inf
    _, ws = jax.jit(jcomp.quantize_int8)(x)
    _, s = compression.quantize_int8(_t(x))
    ws = np.asarray(ws)
    assert np.array_equal(np.isnan(s.numpy()), np.isnan(ws))
    assert np.array_equal(s.numpy()[1:], ws[1:])
    assert np.isnan(ws[0]) and np.isinf(ws[1:3]).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_dequantize_and_residual_match_jax(dtype):
    rng = np.random.default_rng(4)
    v = _in_dtype(_edge_blocks(rng, 3, 256), dtype)
    wq, ws = jax.jit(jcomp.quantize_int8)(v)
    out_dtype = getattr(jnp, dtype)
    want = jops.dequantize(np.asarray(wq).reshape(-1),
                           np.asarray(ws).reshape(-1), out_dtype=out_dtype)
    q, s = _t(wq), _t(ws)
    got = ops.dequantize(q, s, out_dtype=getattr(torch, dtype))
    assert np.array_equal(_bits(got).reshape(-1), _bits(want))
    assert np.array_equal(
        _bits(compression.dequantize_int8(q, s, dtype=got.dtype)),
        _bits(jax.jit(lambda a, b: jcomp.dequantize_int8(
            a, b, dtype=out_dtype))(wq, ws)))
    # the error-feedback residual v - roundtrip(v), fused
    want_res = jax.jit(lambda a: a - jcomp.quantize_roundtrip(a))(v)
    tv = _t(v)
    assert compression.roundtrip_residual_(tv) is tv       # in place
    assert np.array_equal(_bits(tv), _bits(want_res))
    ragged = _t(v[:, :300])                 # padded to a block, then cut
    compression.roundtrip_residual_(ragged)
    assert np.array_equal(_bits(ragged), _bits(jax.jit(
        lambda a: a - jcomp.quantize_roundtrip(a))(v[:, :300])))
    assert np.array_equal(_bits(compression.quantize_roundtrip(_t(v))),
                          _bits(jax.jit(jcomp.quantize_roundtrip)(v)))


def _int8_stack(rng, shape, qblock=256):
    p, s, e = shape[-3:]
    q = rng.integers(-127, 128, size=shape).astype(np.int8)
    scales = (rng.uniform(1e-4, 10, size=shape[:-1] + (e // qblock,))
              * np.exp2(rng.integers(-8, 8, size=shape[:-1] + (e // qblock,)))
              ).astype(np.float32)
    return q, scales


@pytest.mark.parametrize("p", [1, 2, 3, 4, 8])
def test_dequant_accum_slots_matches_jax(p):
    rng = np.random.default_rng(p)
    q, s = _int8_stack(rng, (p, 16, 512))
    want = _bits(jops.dequant_accum_slots(q, s))       # the Pallas body
    assert np.array_equal(_bits(jax.jit(jref.dequant_accum_slots)(q, s)),
                          want)
    got = ops.dequant_accum_slots(_t(q), _t(s))
    assert got.dtype == torch.float32
    assert np.array_equal(_bits(got), want)
    # the flat form is the same fold with one block a slot
    wflat = jops.dequant_accum(q.reshape(p, -1), s.reshape(p, -1))
    flat = ops.dequant_accum(_t(q.reshape(p, -1)), _t(s.reshape(p, -1)))
    assert np.array_equal(_bits(flat), _bits(wflat))
    assert np.array_equal(_bits(flat).reshape(16, 512), want)


def test_dequant_accum_slots_groups_and_strided_children():
    """G switches at once, and a strided child axis (the ``multi``
    design's ``q[j::n_bufs]``): each group folds as its own stack."""
    rng = np.random.default_rng(9)
    q, s = _int8_stack(rng, (3, 8, 4, 256))
    tq, ts = _t(q), _t(s)
    got = ops.dequant_accum_slots(tq[:, 1::2], ts[:, 1::2])
    for g in range(3):
        want = jops.dequant_accum_slots(q[g, 1::2], s[g, 1::2])
        assert np.array_equal(_bits(got[g]), _bits(want))
    stack = tq.movedim(0, 1)                    # (G=8, P=3) view
    got = ops.dequant_accum_slots(stack, ts.movedim(0, 1))
    for g in range(8):
        assert torch.equal(got[g], ref.dequant_accum_slots(tq[:, g],
                                                           ts[:, g]))


def test_wrappers_check_their_arguments():
    """The same ``ValueError``s as the JAX wrappers; the kernel entries
    themselves launch or raise, never fall back to the plain version."""
    q = torch.zeros(2, 3, 100, dtype=torch.int8)
    with pytest.raises(ValueError, match="E=100 % qblock=256"):
        ops.dequant_accum_slots(q, torch.zeros(2, 3, 1))
    with pytest.raises(ValueError, match="n=300 % qblock=256"):
        ops.dequant_accum(q.reshape(2, 300)[:, :300], torch.zeros(2, 1))
    with pytest.raises(ValueError, match="CUDA"):
        quant.quantize(torch.zeros(1, 256))
    with pytest.raises(ValueError, match="CUDA"):
        quant.dequant_accum_slots(torch.zeros(1, 1, 1, 256, dtype=torch.int8),
                                  torch.zeros(1, 1, 1, 1))
    assert quant.dequant_accum_bytes(torch.zeros(2, 4, 3, 1024), 256) == \
        2 * 4 * 3 * 1024 + 4 * 2 * 4 * 3 * 4 + 4 * 2 * 3 * 1024
    assert quant.quantize_bytes(torch.zeros(512), 256) == 512 * 4 + 512 + 8


# ---------------------------------------------------------------------------
# The int8_dequant handler.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("design,n_bufs", [("single", 1), ("multi", 2),
                                           ("multi", 4), ("tree", 1)])
def test_int8_handler_matches_jax(design, n_bufs):
    rng = np.random.default_rng(n_bufs)
    p, n, e = 5, 6, 512
    q, s = _int8_stack(rng, (p, n, e))
    plan = pk.FramePlan(1, n * e, torch.int8, pk.PacketFormat(mtu_bytes=e))
    headers = plan.child_headers(p)
    perm = np.stack([rng.permutation(p) for _ in range(n)], axis=1)
    take = lambda a: np.take_along_axis(a, perm.reshape(
        perm.shape + (1,) * (a.ndim - 2)), axis=0)
    payload = {"q": take(q), "scale": take(s)}
    want = jax.jit(lambda pl, h: jhd.run(
        jhd.get_handler("int8_dequant"), pl, h, design=design,
        n_bufs=n_bufs, ctx={"qblock": 256})[0])(payload, take(headers))
    got, _ = hd.run(hd.get_handler("int8_dequant"),
                    {k: _t(v)[None] for k, v in payload.items()},
                    _t(take(headers))[None], design=design, n_bufs=n_bufs,
                    ctx={"qblock": 256})
    assert tuple(got.shape) == (1, n, e)
    if design == "tree":
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)
    else:
        assert np.array_equal(_bits(got[0]), _bits(want))


def test_int8_handler_folds_payloads_narrower_than_a_block():
    """A 128-element payload under 256-element blocks folds its slots
    flattened (``dequant_accum``), group by group."""
    rng = np.random.default_rng(6)
    q, s = _int8_stack(rng, (3, 4, 512))
    q, s = q.reshape(3, 16, 128), s.reshape(3, 8)
    want, _ = jhd.get_handler("int8_dequant").payload_handler(
        {"q": jnp.asarray(q), "scale": jnp.asarray(s)}, None, "single", 1,
        {"qblock": 256})
    both = {"q": _t(np.stack([q, q])), "scale": _t(np.stack([s, s]))}
    got, _ = hd.get_handler("int8_dequant").payload_handler(
        both, None, "single", 1, {"qblock": 256})
    assert np.array_equal(_bits(got[0]), _bits(want))
    assert torch.equal(got[0], got[1])


# ---------------------------------------------------------------------------
# The int8 data plane.
# ---------------------------------------------------------------------------

def _root_step(mshape, x, block=256) -> np.ndarray:
    """One int8 step of each output element's block: the root's scale,
    bounded by the sum over ranks of the inputs' block maxima / 127 (the
    root aggregate never exceeds it), with a little fp32 slack."""
    x = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, (-x.shape[-1]) % block)])
    xb = np.abs(x.astype(np.float64)).reshape(x.shape[:-1] + (-1, block))
    step = xb.max(-1).sum((0, 1)) / 127 * (1 + 1e-5)
    return np.repeat(step, block, axis=-1)


def _arrival(rng, mshape, b, s):
    levels = dataplane._levels(RankMesh(mshape), AXES)
    n = pk.FramePlan(b, s, torch.int8, pk.DEFAULT_FORMAT).num_packets
    return [np.stack([rng.permutation(l.fanin) for _ in range(n)], axis=1)
            for l in levels]


def _port_planes(mshape, x, design, perms):
    """The port's batched and per-packet planes, with and without the
    arrival permutations: four runs that must agree bit for bit (the
    int8 handler steers by child rank, so arrival order cannot matter)."""
    mesh, t = RankMesh(mshape), _t(x)
    runs = [dataplane.switch_allreduce_int8(t, mesh, AXES, design=design,
                                            arrival_perms=p, batched=bt)
            for bt in (True, False) for p in (None, perms)]
    for r in runs[1:]:
        assert np.array_equal(_bits(r), _bits(runs[0])), \
            "port planes disagree"
    return runs[0]


@pytest.mark.parametrize("design", ["single", "multi", "tree"])
@pytest.mark.parametrize("mshape", MESHES)
def test_switch_allreduce_int8_matches_jax(mshape, design):
    rng = np.random.default_rng(MESHES.index(mshape) * 7 + len(design))
    b, s = 2, 2000                               # S pads to 2048
    x = (rng.normal(size=mshape + (b, s)) * 3).astype(np.float32)
    got = _port_planes(mshape, x, design, _arrival(rng, mshape, b, 2048))
    want = _nested(lambda a: jdp.switch_allreduce_int8(
        a, AXES, design=design))(jnp.asarray(x))
    if design == "tree":
        step = _root_step(mshape, x)[..., :s]
        assert (np.abs(got.numpy() - np.asarray(want)) <= step).all()
    else:
        assert np.array_equal(_bits(got), _bits(want))


def test_per_packet_plane_matches_jax_per_packet_plane():
    """The reference's own per-packet plane, under the same per-slot
    arrival permutations."""
    mshape = (2, 4)
    rng = np.random.default_rng(13)
    x = (rng.normal(size=mshape + (2, 1024)) * 3).astype(np.float32)
    perms = _arrival(rng, mshape, 2, 1024)
    got = _port_planes(mshape, x, "single", perms)
    want = _nested(lambda a: jdp.switch_allreduce_int8(
        a, AXES, design="single", arrival_perms=perms, batched=False))(
        jnp.asarray(x))
    assert np.array_equal(_bits(got), _bits(want))


def test_switch_allreduce_int8_options():
    """``mean``, a bf16 arena, the MTU/block contract, the one-rank
    shortcut and the lossy fabric (a surviving plan gives the fault-free
    bits)."""
    rng = np.random.default_rng(8)
    x = _in_dtype(rng.normal(size=(2, 4, 2, 512)).astype(np.float32),
                  "bfloat16")
    want = _nested(lambda a: jdp.switch_allreduce_int8(a, AXES, mean=True))(
        jnp.asarray(x))
    got = dataplane.switch_allreduce_int8(_t(x), RankMesh((2, 4)), AXES,
                                          mean=True)
    assert got.dtype == torch.bfloat16
    assert np.array_equal(_bits(got), _bits(want))
    with pytest.raises(ValueError, match="whole quantization blocks"):
        dataplane.switch_allreduce_int8(_t(x), RankMesh((2, 4)), AXES,
                                        fmt=pk.PacketFormat(mtu_bytes=384))
    one = _t(x[:1, :1])
    assert dataplane.switch_allreduce_int8(one, RankMesh((1, 1)), AXES) is one
    plan = pk.FaultPlan(seed=2, drop=0.3, duplicate=0.3, reorder=0.5,
                        corrupt=0.1, retry=pk.RetryPolicy(max_retries=8))
    clean = dataplane.switch_allreduce_int8(_t(x), RankMesh((2, 4)), AXES)
    for batched in (True, False):
        lossy, stats = dataplane.switch_allreduce_int8(
            _t(x), RankMesh((2, 4)), AXES, fault_plan=plan,
            with_fault_stats=True, batched=batched)
        assert np.array_equal(_bits(lossy), _bits(clean))
        assert int(stats["retransmits"][0, 0]) > 0


# ---------------------------------------------------------------------------
# GradReducer with error feedback, two steps.
# ---------------------------------------------------------------------------

INT8_INNET = dict(axes=AXES, transport="innetwork", compression="int8")


def _two_steps(mshape, g1, g2):
    jred = jengine.GradReducer(jengine.FlareConfig(**INT8_INNET))
    step = _nested(lambda g, s: jred(g, s))
    r1, st1 = step(g1, jax.tree.map(jnp.zeros_like, g1))
    r2, st2 = step(g2, st1)
    red = GradReducer(FlareConfig(**INT8_INNET), RankMesh(mshape))
    assert red.needs_state
    p1, pst1 = red(params_from_jax(g1, "cpu"),
                   red.init_state(params_from_jax(g1, "cpu")))
    # the state crosses from JAX to the port as any other tree does
    p2, pst2 = red(params_from_jax(g2, "cpu"),
                   params_from_jax(jax.tree.map(np.asarray, st1), "cpu"))
    return ([jax.tree.leaves(a) for a in (r1, st1, r2, st2)],
            [tree.flatten(a)[0] for a in (p1, pst1, p2, pst2)])


def test_grad_reducer_int8_matches_jax_bitwise_at_single_design():
    """600,064 elements a bucket: 586 KiB of int8, over the §6.4 line of
    512 KiB, so every level takes the ``single`` design."""
    mshape = (2, 4)
    rng = np.random.default_rng(11)
    shapes = {"w": (600, 1000), "b": (64,)}
    mk = lambda: {k: rng.normal(size=mshape + v).astype(np.float32)
                  for k, v in shapes.items()}
    g1, g2 = mk(), mk()
    plan_s = dataplane.resolve_design(600_064, "auto")
    assert plan_s == ("single", 1)
    want, got = _two_steps(mshape, g1, g2)
    for w_leaves, g_leaves in zip(want, got):
        for w, g in zip(w_leaves, g_leaves):
            assert tuple(g.shape) == w.shape
            assert np.array_equal(_bits(g), _bits(w))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grad_reducer_int8_small_tree_matches_jax(dtype):
    """A small ragged tree: every level takes the ``tree`` design, held to
    one int8 step of the result; the state is bitwise.  With bf16 leaves
    the reference keeps ``grad + ef`` in fp32 before it quantizes, where
    the port rounds to bf16: the second step's result is held to one
    int8 step, its state stays bitwise."""
    mshape = (2, 4)
    rng = np.random.default_rng(12)
    shapes = {"w": (5, 7), "b": (33,), "c": (300,)}
    mk = lambda: {k: _in_dtype(rng.normal(size=mshape + v).astype(
        np.float32), dtype) for k, v in shapes.items()}
    g1, g2 = mk(), mk()
    want, got = _two_steps(mshape, g1, g2)
    for i in (1, 3):                                  # the states
        for w, g in zip(want[i], got[i]):
            assert g.dtype == getattr(torch, dtype)
            assert np.array_equal(_bits(g), _bits(w))
    for i, g_in in ((0, g1), (2, g2)):                # the results
        # the reference's v: grad + state in fp32 (the state is zero on
        # step 1), laid out as the arena the plane quantizes
        v = [np.asarray(x, np.float32) + (0 if i == 0 else np.asarray(
            e, np.float32)) for x, e in zip(jax.tree.leaves(g_in), want[1])]
        plan = arena_mod.build_plan(
            [torch.from_numpy(x) for x in v], pad_multiple=2048,
            lead_dims=2)
        arena = plan.groups[0].pack([torch.from_numpy(x) for x in v])
        step = torch.from_numpy(_root_step(mshape, arena.numpy()))
        steps = plan.unpack([step.expand(arena.shape)])
        for w, g, st in zip(want[i], got[i], steps):
            err = np.abs(g.float().numpy() - np.asarray(w, np.float32))
            assert (err <= st.numpy()).all()


def test_from_config_routes_int8_innetwork_to_the_switch():
    mesh = RankMesh((2, 4))
    t = transports.from_config(FlareConfig(**INT8_INNET), mesh,
                               torch.float32)
    assert isinstance(t, transports.SwitchTransport) and t.mode == "int8"
    assert t.block == transports.QUANT_BLOCK
    # integers ride the dense switch; without transport="innetwork" the
    # same fields build the wire int8 and wire sparse transports, which
    # give the reference's bits
    dense = transports.from_config(FlareConfig(**INT8_INNET), mesh,
                                   torch.int32)
    assert dense.mode == "dense"
    x = np.random.default_rng(12).normal(size=(2, 4, 2, 512)).astype(
        np.float32)
    for kw, kind in ((dict(compression="int8"), transports.Int8Transport),
                     (dict(sparse_k_frac=0.1), transports.SparseTransport)):
        t = transports.from_config(FlareConfig(axes=AXES, **kw), mesh,
                                   torch.float32)
        assert isinstance(t, kind)
        jt = jtransports.from_config(jengine.FlareConfig(axes=AXES, **kw),
                                     jnp.float32)
        want = _nested(lambda a: jt(a, jnp.zeros_like(a), jnp.arange(2),
                                    (512, 300)))(x)
        got = t(_t(x).clone(), None, torch.arange(2), (512, 300))
        for g, w in zip(got, want):
            assert np.array_equal(_bits(g), _bits(w)), kind
    assert GradReducer(FlareConfig(axes=AXES, transport="innetwork",
                                   reproducible=True), mesh).init_state(
        {"w": torch.ones(2, 4, 3)}) is None
