"""The port with one process a rank (``mesh.ProcessMesh``) against the
emulated ranks (``mesh.RankMesh``) and against the JAX package.

Eight ranks run on eight threads of this process, each with its own
``ProcessGroupGloo`` groups over one ``HashStore`` (``_ranks``); one torch
thread a rank.  Every group and every join has a 60 s limit, so a
deadlock fails its test.  Each rank's result must be, bit for bit, its
slice of what ``RankMesh`` gives on the stacked input:

* every primitive on ``(2, 4)``, ``(1, 8)`` and ``(2, 3)``;
* ``GradReducer`` in reproducible mode (in the network, and on the wire
  ``fixed_tree``) on the ``tinyllama_1_1b.SMOKE`` gradient tree and a
  mixed f32 / bf16 / int32 tree, which is also the JAX reducer's under
  nested ``vmap``, bitwise; the wire's ring, rhd, hierarchical schedule
  and ``psum``, bitwise the emulated port's and within
  ``test_torch_wire.py``'s tolerance of the reference's (zero, ``psum``
  1e-6);
* two train steps of TinyLlama's widened SMOKE config on ``2x4`` with
  FSDP, in the network: losses, gradient norms and parameters within
  ``test_two_train_steps_match_jax``'s tolerances of the reference's
  ``step_body`` under nested ``vmap``, and bitwise the emulated port's;
* the paths that do not run on processes yet raise, naming their
  ROADMAP item (the int8 and sparse planes, which run there, are
  ``tests/test_torch_procs_planes.py``'s).

One test starts real processes: ``launch.train --ranks processes`` on
the CPU through ``procs.spawn``, over a ``FileStore`` under ``tmp_path``.
"""
import datetime
import itertools
import math
import threading
import traceback

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed import HashStore, PrefixStore

from repro.configs import tinyllama_1_1b as jtl
from repro.core import engine as jengine
from repro.data import pipeline as jpipeline
from repro.models import registry as jregistry
from repro.models import transformer as jtransformer
from repro.sharding import rules as jrules
from repro.train import trainer as jtrainer
from repro_torch import mesh as mesh_mod
from repro_torch import tree
from repro_torch.configs import tinyllama_1_1b as tl
from repro_torch.convert import params_from_jax
from repro_torch.core import transports
from repro_torch.core.engine import FlareConfig, GradReducer
from repro_torch.launch import procs
from repro_torch.launch import train as launch_train
from repro_torch.mesh import ProcessMesh, RankMesh
from repro_torch.models.registry import get_model
from repro_torch.sharding import rules
from repro_torch.switch import dataplane
from repro_torch.train import trainer

torch.set_num_threads(1)

AXES = ("pod", "data")
MESHES = [(2, 4), (1, 8), (2, 3)]
LIMIT = datetime.timedelta(seconds=60)
_INT = {1: np.int8, 2: np.int16, 4: np.int32}
_COUNT = itertools.count()


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().contiguous()
        return a.view({1: torch.int8, 2: torch.int16,
                       4: torch.int32}[a.element_size()]).numpy()
    a = np.asarray(a)
    return a.view(_INT[a.dtype.itemsize])


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (tuple(a.shape) == tuple(b.shape) and a.dtype == b.dtype
            and np.array_equal(_bits(a), _bits(b)))


def _ranks(shape, fn, axes=AXES):
    """``fn(mesh)`` on a thread a rank, each rank's ``ProcessMesh``
    active in its thread; the results in rank order.  A rank that raises
    fails the call with its traceback; one still running after 60 s
    fails it as a deadlock."""
    store = PrefixStore(f"run{next(_COUNT)}", HashStore())
    world = math.prod(shape)
    out, errors = [None] * world, []

    def body(r):
        try:
            pm = ProcessMesh.create(store, r, shape, axes, timeout=LIMIT)
            with mesh_mod.activate(pm):
                out[r] = fn(pm)
        except BaseException:
            errors.append(f"rank {r}:\n{traceback.format_exc()}")

    threads = [threading.Thread(target=body, args=(r,), daemon=True)
               for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(LIMIT.total_seconds())
    assert not errors, "\n".join(errors)
    assert not any(t.is_alive() for t in threads), "a rank did not finish"
    return out


def _own(x: torch.Tensor, shape, r: int) -> torch.Tensor:
    """Rank ``r``'s slice of an every-rank tensor, ``(1, 1, *s)``."""
    coords = np.unravel_index(r, shape)
    return x[tuple(int(c) for c in coords)].reshape(
        (1,) * len(shape) + tuple(x.shape[len(shape):]))


# ---------------------------------------------------------------------------
# The primitives.
# ---------------------------------------------------------------------------

def _primitives(m, x, y, z):
    """Every primitive of ``m`` on the every-rank tensors (``x``, ``y``
    and ``z``, one an axis, shaped for the tiled and untiled
    ``all_to_all``), each rank's input its own slice (``m.own``)."""
    xs, ys = m.own(x), m.own(y)
    out = {}
    for a in m.axes:
        p = m.axis_size(a)
        out[f"index {a}"] = m.axis_index(a) + torch.zeros(m.lead,
                                                          dtype=torch.int32)
        out[f"gather {a}"] = m.all_gather(xs, a)
        out[f"psum {a}"] = m.psum(xs, a)
        out[f"ring {a}"] = m.ppermute(xs, a, [(i, (i + 1) % p)
                                              for i in range(p)])
        out[f"partial {a}"] = m.ppermute(xs, a, [(0, p - 1)])
        out[f"a2a tiled {a}"] = m.all_to_all(ys, a, 0, 1)
        out[f"a2a untiled {a}"] = m.all_to_all(m.own(z[m.dim(a)]), a, 0, 1,
                                               tiled=False)
        out[f"mean {a}"] = m.mean(xs, a)
    out["psum both"] = m.psum(xs, m.axes)
    out["psum both reversed"] = m.psum(xs, tuple(reversed(m.axes)))
    return out


@pytest.mark.parametrize("shape", MESHES)
def test_primitives_match_rank_mesh(shape):
    rng = np.random.default_rng(sum(shape))
    w = math.lcm(*shape) * 2
    x = torch.from_numpy(rng.normal(size=shape + (3, 5)).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=shape + (w, 3)).astype(np.float32))
    # the untiled split axis has the axis's size: one input an axis
    z = [torch.from_numpy(rng.normal(size=shape + (n, 3, 2)).astype(
        np.float32)) for n in shape]
    want = _primitives(RankMesh(shape, AXES), x, y, z)
    got = _ranks(shape, lambda m: _primitives(m, x, y, z))
    for r, rank_out in enumerate(got):
        assert rank_out.keys() == want.keys()
        for name, g in rank_out.items():
            assert _same(g, _own(want[name], shape, r)), (shape, r, name)


def test_primitives_in_bf16_and_on_three_axes():
    """bf16 operands, and a ``(pod, data, model)`` mesh, whose groups
    over two of three axes run in the flat order of their ranks."""
    shape, axes = (2, 2, 2), ("pod", "data", "model")
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=shape + (4, 3)).astype(
        np.float32)).bfloat16()
    rm = RankMesh(shape, axes)

    def run(m):
        xs = m.own(x)
        return [m.psum(xs, ("pod", "data")), m.psum(xs, ("data", "model")),
                m.psum(xs, axes), m.all_gather(xs, "model"),
                m.ppermute(xs, "data", [(0, 1), (1, 0)])]
    want = run(rm)
    for r, outs in enumerate(_ranks(shape, run, axes)):
        for i, (g, w) in enumerate(zip(outs, want)):
            assert _same(g, _own(w, shape, r)), (r, i)


def test_switch_traffic_and_multicast():
    """The dense plane's level traffic on ``(2, 4)``: only the switch
    ranks get a stack (``group_stack``), the others drop out of the
    upper levels (``collapse``, ``holds``), and the multicast brings
    the root's arena back to every rank."""
    def run(m):
        x = torch.full(m.lead + (2, 3), float(m.rank))
        st = m.group_stack(x, "data", 0)
        up = m.collapse("data", 0)
        top = up.collapse("pod", 0)
        root = torch.full(m.lead + (2, 3), 7.0) if top.holds else None
        return (None if st is None else st[0, :, 0, 0].tolist(), up.holds,
                top.holds, m.multicast(root, top, x))
    outs = _ranks((2, 4), run)
    for r, (st, up, top, mc) in enumerate(outs):
        pod, data = divmod(r, 4)
        assert st == ([float(4 * pod + c) for c in range(4)] if data == 0
                      else None)
        assert (up, top) == (data == 0, r == 0)
        assert torch.equal(mc, torch.full((1, 1, 2, 3), 7.0))


# ---------------------------------------------------------------------------
# The GradReducer, a rank a thread.
# ---------------------------------------------------------------------------

def _smoke_and_mixed(mshape, seed):
    """The ``tinyllama_1_1b.SMOKE`` gradient tree and the mixed f32 /
    bf16 / int32 tree, one tree of two."""
    shapes = jax.eval_shape(lambda: jtransformer.init_params(
        jtl.SMOKE, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)
    smoke = jax.tree.map(lambda s: rng.normal(size=mshape + s.shape).astype(
        np.float32), shapes)
    mixed = {
        "w": rng.normal(size=mshape + (5, 7)).astype(np.float32),
        "b": np.asarray(jnp.asarray(rng.normal(size=mshape + (33,)),
                                    jnp.bfloat16)),
        "count": rng.integers(-1000, 1000, size=mshape + (3,),
                              dtype=np.int32),
        "scale": rng.normal(size=mshape).astype(np.float32),
    }
    return {"smoke": smoke, "mixed": mixed}


def _nested(f):
    return jax.jit(jax.vmap(jax.vmap(f, axis_name="data"), axis_name="pod"))


def _reduce_on_ranks(config: dict, grads_np):
    grads = params_from_jax(grads_np, "cpu")

    def run(m):
        out, state = GradReducer(FlareConfig(**config), m)(
            tree.map_leaves(m.own, grads))
        assert state is None
        return tree.flatten(out)[0]
    return run


REPRODUCIBLE = {
    "innetwork": dict(axes=AXES, transport="innetwork", reproducible=True),
    "wire_fixed_tree": dict(axes=AXES, algorithm="fixed_tree",
                            reproducible=True),
}


@pytest.mark.parametrize("config", sorted(REPRODUCIBLE))
@pytest.mark.parametrize("mshape", [(2, 4), (1, 8)])
def test_grad_reducer_on_ranks_matches_jax(mshape, config):
    grads = _smoke_and_mixed(mshape, seed=len(config))
    cfg = REPRODUCIBLE[config]
    jred = jengine.GradReducer(jengine.FlareConfig(**cfg))
    want = jax.tree.leaves(_nested(lambda g: jred(g)[0])(grads))
    emulated = tree.flatten(GradReducer(FlareConfig(**cfg), RankMesh(
        mshape))(params_from_jax(grads, "cpu"))[0])[0]
    got = _ranks(mshape, _reduce_on_ranks(cfg, grads))
    for r, leaves in enumerate(got):
        assert len(leaves) == len(want)
        for g, w, e in zip(leaves, want, emulated):
            w = params_from_jax(np.asarray(w), "cpu")
            assert _same(g, _own(w, mshape, r))
            assert _same(g, _own(e, mshape, r))


WIRE = {"ring": dict(algorithm="ring"), "rhd": dict(algorithm="rhd"),
        "hierarchical": dict(algorithm="hierarchical"),
        "psum": dict(algorithm="psum")}


@pytest.mark.parametrize("config", sorted(WIRE))
def test_grad_reducer_wire_on_ranks(config):
    """Buckets of 2 KiB a dtype, staggered, on ``(2, 4)``: bitwise the
    emulated port; the reference's bits too, except ``psum`` (1e-6)."""
    mshape = (2, 4)
    grads = _smoke_and_mixed(mshape, seed=3)["mixed"]
    grads["big"] = np.random.default_rng(4).normal(
        size=mshape + (40, 30)).astype(np.float32)
    cfg = dict(axes=AXES, bucket_bytes=2048, **WIRE[config])
    jred = jengine.GradReducer(jengine.FlareConfig(**cfg))
    want = jax.tree.leaves(_nested(lambda g: jred(g)[0])(grads))
    emulated = tree.flatten(GradReducer(FlareConfig(**cfg), RankMesh(
        mshape))(params_from_jax(grads, "cpu"))[0])[0]
    for r, leaves in enumerate(_ranks(mshape, _reduce_on_ranks(cfg,
                                                                grads))):
        for g, w, e in zip(leaves, want, emulated):
            assert _same(g, _own(e, mshape, r)), config
            w = _own(params_from_jax(np.asarray(w), "cpu"), mshape, r)
            if config == "psum":
                np.testing.assert_allclose(g.float().numpy(),
                                           w.float().numpy(), rtol=1e-6,
                                           atol=1e-6)
            else:
                assert _same(g, w), config


# ---------------------------------------------------------------------------
# Two train steps, a rank a thread.
# ---------------------------------------------------------------------------

WIDE = dict(d_model=256, n_heads=4, n_kv_heads=2, head_dim=64, d_ff=512,
            vocab=512, n_layers=2)
JCFG = jtl.SMOKE.scaled(dtype=jnp.float32, **WIDE)
CFG = tl.SMOKE.scaled(dtype=torch.float32, **WIDE)
MESH_AXES = ("pod", "data", "model")


def _per_rank_jax(jp, jmcfg):
    _, manual, _ = jrules.param_specs(jp, jmcfg)
    ranks = jmcfg.shape[:-1]

    def f(a, spec):
        for i, ax in enumerate(spec):
            if ax == "data":
                blocks = np.stack(np.split(a, ranks[-1], axis=i))
                return np.broadcast_to(blocks, ranks[:-1] + blocks.shape
                                       ).copy()
        return np.broadcast_to(a, ranks + a.shape).copy()
    return jax.tree.map(f, jp, manual,
                        is_leaf=lambda x: isinstance(x, np.ndarray))


def _port_steps(full, batches, flare: dict):
    """Two port train steps on the active mesh (every rank, or this
    thread's): the metrics a step, then the parameters."""
    mcfg = rules.MeshCfg(MESH_AXES, (2, 4, 1))
    step = trainer.make_train_step(
        get_model(CFG), mcfg, trainer.TrainConfig(
            lr=1e-3, gather_algorithm="fixed_tree",
            flare=FlareConfig(**flare)), full)
    params = rules.shard_params(full, mcfg)
    opt = step.init_opt_state(params)
    metrics = []
    for b in batches:
        params, opt, m = step(params, opt, rules.split_batch(b, mcfg))
        metrics.append((m["loss"].clone(), m["grad_norm"].clone()))
    return metrics, params


def test_two_train_steps_on_ranks_match_jax_and_emulation():
    flare = dict(axes=AXES, transport="innetwork", reproducible=True)
    jmcfg = jrules.MeshCfg(MESH_AXES, (2, 4, 1))
    jp = jax.tree.map(np.asarray, jregistry.get_model(JCFG).init(
        jax.random.PRNGKey(0)))
    jstep_body, _, _, _, jinit = jtrainer.make_train_step(
        jregistry.get_model(JCFG), jmcfg, jtrainer.TrainConfig(
            lr=1e-3, gather_algorithm="fixed_tree",
            flare=jengine.FlareConfig(**flare)), jp)
    jstep = _nested(jstep_body)
    jparams = _per_rank_jax(jp, jmcfg)
    jopt = jax.vmap(jax.vmap(jinit))(jparams)
    stream = jpipeline.synthetic_batches(JCFG, 8, 64, seed=1, prefetch=False)
    batches, jm = [], []
    for _ in range(2):
        b = {k: np.asarray(v) for k, v in next(stream).items()}
        batches.append(params_from_jax(b, "cpu"))
        jparams, jopt, m = jstep(jparams, jopt, {
            k: v.reshape(2, 4, -1, 64) for k, v in b.items()})
        jm.append(m)
        if len(jm) == 1:
            m1 = jax.tree.leaves(jax.tree.map(np.asarray, jopt["m"]))

    full = params_from_jax(jp, "cpu")
    emu_metrics, emu_params = _port_steps(full, batches, flare)
    got = _ranks((2, 4), lambda m: _port_steps(full, batches, flare))

    for r, (metrics, params) in enumerate(got):
        at = np.unravel_index(r, (2, 4))
        for (loss, gn), (eloss, egn), j in zip(metrics, emu_metrics, jm):
            assert _same(loss, eloss) and _same(gn, egn)
            for v, k in ((loss, "loss"), (gn, "grad_norm")):
                np.testing.assert_allclose(float(v), float(j[k][0, 0]),
                                           rtol=1e-5)
        # parameters as test_two_train_steps_match_jax holds them: 1e-5,
        # or 1e-4 where Adam's first moment is under 1e-8
        for p, e, jw, mm in zip(tree.flatten(params)[0],
                                tree.flatten(emu_params)[0],
                                jax.tree.leaves(jparams), m1):
            assert _same(p, _own(e, (2, 4), r))
            a = p.detach().numpy()[0, 0]
            b = np.asarray(jw)[at]
            well = np.abs(mm[at]) >= 1e-8
            np.testing.assert_allclose(a[well], b[well], rtol=1e-5,
                                       atol=1e-5)
            np.testing.assert_allclose(a[~well], b[~well], rtol=0,
                                       atol=1e-4)


# ---------------------------------------------------------------------------
# What does not run on processes yet.
# ---------------------------------------------------------------------------

def test_unported_paths_raise_naming_their_roadmap_item():
    def run(m):
        seen = []

        def expect(fn, item):
            with pytest.raises(NotImplementedError,
                               match=f"ROADMAP Queue 1, item {item} "):
                fn()
            seen.append(item)
        arena = torch.zeros(m.lead + (1, 64))
        st = torch.zeros(1, dtype=torch.int32)
        from repro_torch.switch import packets as pk
        plan = pk.FaultPlan(seed=1, drop=0.05)
        grads = {"w": torch.zeros(m.lead + (64,))}
        expect(lambda: GradReducer(FlareConfig(
            axes=AXES, transport="innetwork", fault_plan=plan), m)(grads),
            21)
        expect(lambda: dataplane.switch_allreduce_dense(
            arena, m, AXES, fault_plan=plan), 21)
        expect(lambda: dataplane.switch_allreduce_int8(
            arena, m, AXES, fault_plan=plan), 21)
        expect(lambda: dataplane.switch_allreduce_sparse(
            arena, m, AXES, (4,), fault_plan=plan), 21)
        from repro_torch.runtime import SessionManager
        mgr = SessionManager(AXES, m.shape)
        expect(lambda: GradReducer(FlareConfig(
            axes=AXES, transport="innetwork"), m, manager=mgr)(grads), 22)
        expect(lambda: transports.from_config(
            FlareConfig(axes=AXES, transport="innetwork"), m,
            torch.float32, batched=False)(arena, None, st, (64,)), 25)
        expect(lambda: dataplane.switch_allreduce_dense(
            arena, m, AXES, batched=False), 25)
        expect(lambda: dataplane.switch_allreduce_int8(
            arena, m, AXES, batched=False), 25)
        expect(lambda: dataplane.switch_allreduce_sparse(
            arena, m, AXES, (4,), batched=False), 25)
        expect(lambda: GradReducer(FlareConfig(
            axes=AXES, transport="innetwork", arena=False), m)(grads), 25)
        mcfg = rules.MeshCfg(MESH_AXES, (2, 4, 1))
        expect(lambda: rules.unshard_params({"w": torch.zeros(1, 1, 3)},
                                            mcfg, {"w": -1}), 23)
        from repro_torch.serve.engine import make_serve_fns
        expect(lambda: make_serve_fns(get_model(CFG), mcfg, cache_batch=8,
                                      cache_len=16, device="cpu"), 24)
        return seen
    for seen in _ranks((2, 4), run):
        assert sorted(set(seen)) == [21, 22, 23, 24, 25]
    for argv, item in ((["--tenants", "2"], 22), (["--ckpt-dir", "x"], 23),
                       (["--transport", "innetwork", "--fault-rate", "0.1"],
                        21)):
        with pytest.raises(NotImplementedError,
                           match=f"ROADMAP Queue 1, item {item} "):
            launch_train.main(["--smoke", "--device", "cpu", "--mesh",
                               "2x4x1", "--ranks", "processes", *argv])
    # no torchrun environment: the launcher on processes says so
    with pytest.raises(RuntimeError, match="torchrun"):
        launch_train.main(["--smoke", "--device", "cpu", "--mesh", "2x4x1",
                           "--ranks", "processes"])
    # NCCL refuses two ranks on one card; the CPU takes gloo alone
    with pytest.raises((RuntimeError, ValueError)):
        procs.device_for("nccl", "cuda", 1, 2)
    with pytest.raises(ValueError, match="gloo"):
        procs.device_for("nccl", "cpu", 0, 1)


def test_launcher_on_processes_matches_emulated_launcher(tmp_path):
    """``launch.train --ranks processes`` in 8 processes of its own
    (``procs.spawn``, a ``FileStore`` under ``tmp_path``): every rank's
    losses are the emulated launcher's."""
    argv = ["--smoke", "--steps", "2", "--mesh", "2x4x1", "--batch", "8",
            "--seq", "32", "--device", "cpu", "--transport", "innetwork",
            "--reproducible"]
    want = launch_train.main(argv)
    got = procs.spawn(launch_train.main, 8, "gloo",
                      str(tmp_path / "store"),
                      (argv + ["--ranks", "processes"],), timeout=120)
    assert got == [want] * 8
