"""Tensor and expert parallelism over ``model``: the port's ``2x2x2`` train
step against its own ``model`` = 1 step, and against the JAX package's.

The port partitions explicitly (``repro_torch.core.tp``: a rank's heads,
FFN columns, SSD heads, experts and vocabulary rows, the conjugate
operators between the replicated and the rank-local regions); the
reference leaves ``model`` to XLA, whose step computes the function of
the ``model`` = 1 one.  So every arch's SMOKE step at ``2x2x2`` is held
to the port's ``2x2x1`` step on the same weights and batches
(``test_two_train_steps_match_jax`` holds that one to the reference),
TinyLlama's also to the reference's ``step_body`` at ``model`` = 1 under
nested ``vmap``, and to the reference's own ``jit_train_step`` on a
``(2, 2, 2)`` mesh of 8 fake CPU devices in a subprocess.

Bounds: losses and gradient norms within 1e-5 relative (fp32 sums taken
in another order: a head's or a vocabulary block's partial sums added
over ``model``), the step-1 gradients within 1e-5 of each leaf's
largest, the parameters within 1e-5 where the step-1 gradient is well
conditioned and 1e-4 where it is under 1e-8 (Adam's first step moves a
parameter by lr·g/(|g| + eps)).  The MoE's parameters, and those of the
SSD stacks, are held within ``tests/test_torch_models.py``'s MoE bound:
every element within lr / 2 = 5e-4, all but 0.01 % of them within the
Adam bounds.  Where a step-1 gradient is a sum that nearly cancels, its
last digits follow the summation order, and Adam divides it by its own
magnitude: found, zamba2 widened, 2 elements of ``out_proj`` (of
655068) off by up to 1.3e-5, their step-1 gradients 2.8e-7 and 1.0e-6
apart in the fourth digit.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import engine as jengine
from repro.models import get_model as jget_model
from repro.sharding import rules as jrules
from repro.train import trainer as jtrainer
from repro_torch import configs, tree
from repro_torch.convert import params_from_jax
from repro_torch.core import tp
from repro_torch.core.engine import FlareConfig
from repro_torch.data import pipeline
from repro_torch.launch import train as launch_train
from repro_torch.models import base
from repro_torch.models.registry import get_model
from repro_torch.sharding import rules
from repro_torch.train import trainer

torch.set_num_threads(1)

AXES3 = ("pod", "data", "model")
TP_MESH, DP_MESH = (2, 2, 2), (2, 2, 1)
REPRO = dict(transport="innetwork", reproducible=True)
TL = "tinyllama-1.1b"

#: every arch's SMOKE, and widened configs whose projections, experts and
#: embeddings are FSDP-sharded over ``data`` and split over ``model``
#: (``rules.MIN_FSDP_SIZE`` is 64 Ki elements)
CASES = {
    **{a: {} for a in configs.ALIASES},
    "tinyllama-wide": dict(d_model=256, d_ff=512, vocab=512),
    "deepseek-wide": dict(d_model=256, d_ff=512, vocab=512, moe_d_ff=256),
    "zamba2-wide": dict(d_model=256, d_ff=512, vocab=512),
}
_BASE = {"tinyllama-wide": TL, "deepseek-wide": "deepseek-v2-lite-16b",
         "zamba2-wide": "zamba2-1.2b"}


def _cfg(case: str):
    return configs.load(_BASE.get(case, case)).SMOKE.scaled(
        dtype=torch.float32, **CASES[case])


@functools.cache
def _full(case: str):
    """The global fp32 parameters of ``case``, drawn once."""
    return get_model(_cfg(case)).init(torch.Generator().manual_seed(0))


def _run(case: str, shape, steps: int = 2, flare: dict = REPRO,
         gather: str = "fixed_tree", params=None, seq: int = 32):
    """``steps`` train steps of ``case`` on ``shape``; returns (metrics,
    the unsharded step-1 first moments, the unsharded parameters, the
    step, the rank-local state)."""
    cfg = _cfg(case)
    m = get_model(cfg)
    full = _full(case) if params is None else params
    mc = rules.MeshCfg(AXES3, shape)
    step = trainer.make_train_step(m, mc, trainer.TrainConfig(
        lr=1e-3, gather_algorithm=gather,
        flare=FlareConfig(axes=mc.reduce_axes, **flare)), full)
    p = rules.shard_params(full, mc)
    opt = step.init_opt_state(p)
    stream = pipeline.synthetic_batches(cfg, 8, seq, seed=1, device="cpu")
    metrics, m1 = [], None
    for _ in range(steps):
        p, opt, met = step(p, opt, rules.split_batch(next(stream), mc))
        metrics.append((float(met["loss"]), float(met["grad_norm"])))
        if m1 is None:                  # a copy: the step updates in place
            m1 = tree.map_leaves(torch.clone, rules.unshard_params(
                opt["m"], mc, step.dims, step.tp_dims))
    return (metrics, m1, rules.unshard_params(p, mc, step.dims,
                                               step.tp_dims), step,
            (p, opt))


def _close_rel(got, want, rtol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= rtol * float(np.abs(want).max()), err


def _hold_params(got, want, m1, moe: bool):
    """The parameters after two steps: the Adam bounds of the module doc
    (``moe``: the MoE's looser one)."""
    for a, b, mm in zip(tree.flatten(got)[0], tree.flatten(want)[0],
                        tree.flatten(m1)[0]):
        a, b, mm = a.numpy(), b.numpy(), mm.numpy()
        well = np.abs(mm) >= 1e-8
        if moe:
            d = np.abs(a - b)
            assert float(d.max()) <= 5e-4
            off = d > np.where(well, 1e-5 + 1e-5 * np.abs(b), 1e-4)
            assert off.sum() <= max(1e-4 * d.size, 1), (off.sum(), d.size)
            continue
        np.testing.assert_allclose(a[well], b[well], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(a[~well], b[~well], rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# The conjugate operators and the layout.
# ---------------------------------------------------------------------------

def _op_case(case: str):
    """(the block at ``model`` = 1, the block at ``model`` = 2 over a
    leading ``model`` axis, which of ``x, w1, w2, b`` it splits: ``w1`` by
    columns, ``w2`` by rows, ``b`` where a rank takes its block)."""
    if case == "copy_reduce":        # a column- then row-parallel MLP
        def full(x, w1, w2, b):
            return torch.tanh(x @ w1) @ w2

        def par(x, w1, w2, b):
            h = torch.tanh(base.mm(tp.copy_to_model(x, 0), w1))
            return tp.reduce_from_model(base.mm(h, w2), 0)
    elif case == "gather":           # a column-parallel product gathered
        def full(x, w1, w2, b):
            return (x @ w1) @ w2

        def par(x, w1, w2, b):
            y = tp.gather_from_model(
                base.mm(tp.copy_to_model(x, 0), w1), 0)
            return base.mm(y, w2)
    elif case == "allreduce":        # RMSNorm over a split dim
        def full(x, w1, w2, b):
            return base.rmsnorm(x @ w1, b) @ w2

        def par(x, w1, w2, b):
            h = base.mm(tp.copy_to_model(x, 0), w1)
            h = base.rmsnorm(h, tp.local_slice(b, 0), split_dim=0)
            return tp.reduce_from_model(base.mm(h, w2), 0)
    else:                            # a replicated bias, a block a rank
        def full(x, w1, w2, b):
            return torch.tanh(x @ w1 + b) @ w2

        def par(x, w1, w2, b):
            h = base.mm(tp.copy_to_model(x, 0), w1) \
                + tp.local_slice(b, 0)[:, None, None]
            return tp.reduce_from_model(base.mm(torch.tanh(h), w2), 0)
    w2_split = case != "gather"
    return full, par, (False, True, w2_split, False)


def _blocks(t: torch.Tensor, dim: int | None) -> torch.Tensor:
    """Two ranks' copies (``dim`` ``None``) or blocks on ``dim``."""
    if dim is None:
        return t.expand(2, *t.shape)
    return torch.stack(t.chunk(2, dim))


@pytest.mark.parametrize("case", ["copy_reduce", "gather", "allreduce",
                                  "local_slice"])
def test_conjugate_operators_match_autograd(case):
    """Each operator pair in a small block at ``model`` = 2, every rank
    holding its own leaves (copies of a replicated one, blocks of a split
    one) and differentiating its own copy of the loss (``loss.sum()``
    over the ``model`` axis, as the trainer does), against autograd of
    the block at ``model`` = 1: the value on every rank, and every rank's
    gradients, a replicated leaf's whole (not ``tp`` times) and a split
    leaf's its block."""
    rng = np.random.default_rng(0)
    d, f = 8, 12
    args = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
            for s in ((3, 5, d), (d, f), (f, d), (f,))]
    g = torch.from_numpy(rng.normal(size=(3, 5, d)).astype(np.float32))
    full, par, split = _op_case(case)
    a1 = [t.clone().requires_grad_() for t in args]
    want = full(*a1)
    (want * g).sum().backward()
    dims = [(-1 if i == 1 else -2) if sp else None
            for i, sp in enumerate(split)]
    a2 = [_blocks(t, dm).clone().requires_grad_()
          for t, dm in zip(args, dims)]
    got = par(*a2)
    assert got.shape == (2, 3, 5, 8)
    for m in range(2):
        _close_rel(got[m].detach(), want.detach(), 1e-6)
    (got * g).sum().backward()
    for x, y, dm in zip(a2, a1, dims):
        if y.grad is None:                  # a leaf the block does not use
            assert x.grad is None
            continue
        _close_rel(x.grad, _blocks(y.grad, dm), 1e-5)


def test_the_model_size_reaches_another_thread():
    """``tp.parallel``'s size is the process's: on the card autograd runs
    the backward (and a remat recompute) on a thread of its own."""
    import threading
    seen = []
    with tp.parallel(2):
        t = threading.Thread(target=lambda: seen.append(tp.size()))
        t.start()
        t.join()
    assert seen == [2] and tp.size() == 1


def test_psum_is_rank_ordered_and_one_tensor():
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, 3, 4)).astype(np.float32)) * 1e3
    s = tp.psum(x, 1)
    want = (x[:, 0] + x[:, 1]) + x[:, 2]
    for m in range(3):
        assert torch.equal(s[:, m], want)
    assert s.stride(1) == 0


@pytest.mark.parametrize("case", ["tinyllama-wide", "zamba2-wide",
                                  "deepseek-wide"])
def test_layout_at_model_2(case):
    """``rank_mesh`` puts ``model`` last; ``shard_params`` splits the TP
    dims over it and ``unshard_params`` joins them back bitwise;
    ``shard_fsdp_leaves`` gives the same local shapes; ``split_batch``
    gives every ``model`` rank of a ``(pod, data)`` rank its rows; at
    ``model`` = 1 the layout has no ``model`` axis."""
    full = _full(case)
    mc = rules.MeshCfg(AXES3, TP_MESH)
    assert mc.rank_mesh().axes == AXES3 and mc.rank_mesh().shape == TP_MESH
    assert rules.MeshCfg(AXES3, DP_MESH).rank_mesh().axes == ("pod", "data")
    dims, tpd = rules.param_specs(full, mc), rules.tp_specs(full, mc)
    sh = rules.shard_params(full, mc)
    meta = rules.shard_fsdp_leaves(full, mc)
    for a, b in zip(tree.flatten(sh)[0], tree.flatten(meta)[0]):
        assert tuple(a.shape) == TP_MESH + tuple(b.shape)
    back = rules.unshard_params(sh, mc, dims, tpd)
    for a, b in zip(tree.flatten(back)[0], tree.flatten(full)[0]):
        assert torch.equal(a, b)
    split = {p[-1] for p, t, d in zip(tree.paths(tpd), tree.flatten(tpd)[0],
                                      tree.flatten(dims)[0]) if t >= 0}
    both = {p[-1] for p, t, d in zip(tree.paths(tpd), tree.flatten(tpd)[0],
                                     tree.flatten(dims)[0])
            if t >= 0 and d >= 0}
    assert {"embed", "lm_head"} <= both
    assert split.isdisjoint({"router", "wb", "wc", "wdt", "A_log", "D",
                             "final_norm", "ln1", "ln2", "w_kr"})
    # the reference's TP dims: where its full specs name ``model``
    shapes = tree.map_leaves(lambda t: jax.ShapeDtypeStruct(
        tuple(t.shape), jnp.float32), full)
    jfull, _, _ = jrules.param_specs(shapes, jrules.MeshCfg(AXES3, TP_MESH))
    specs = jax.tree.leaves(jfull, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))
    for path, t, spec in zip(tree.paths(tpd), tree.flatten(tpd)[0], specs):
        off = int(path[0] in rules.STACKED_ROOTS)
        want = list(spec).index("model") - off if "model" in spec else -1
        assert t == want, path
    rules.make_gather(mc, "rhd", full)          # an unambiguous lookup
    toks = torch.arange(8 * 3).reshape(8, 3)
    b = rules.split_batch({"tokens": toks}, mc)["tokens"]
    assert b.shape == (2, 2, 2, 2, 3)
    assert torch.equal(b[1, 0, 0], b[1, 0, 1])
    assert torch.equal(b[1, 0, 1], toks[4:6])


# ---------------------------------------------------------------------------
# The 2x2x2 train steps against the model = 1 ones.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(CASES))
def test_tp_train_steps_match_model_1(case):
    """Two reproducible in-network steps at ``2x2x2`` against the port's
    ``2x2x1`` steps from the same weights on the same batches: the
    module doc's bounds."""
    got = _run(case, TP_MESH)
    want = _run(case, DP_MESH)
    for (l1, g1), (l2, g2) in zip(got[0], want[0]):
        np.testing.assert_allclose(l1, l2, rtol=1e-5)
        np.testing.assert_allclose(g1, g2, rtol=1e-5)
    assert got[0][1][0] < got[0][0][0]
    for a, b in zip(tree.flatten(got[1])[0], tree.flatten(want[1])[0]):
        _close_rel(a, b)
    cfg = _cfg(case)
    _hold_params(got[2], want[2], want[1], cfg.is_moe or cfg.ssm_state > 0)


def test_tp_rank_at_a_time_loss_is_the_whole_chunks_loss():
    """``chunked_ce``'s rank-at-a-time path (taken where the whole chunks'
    logits would not fit the card) at ``2x2x2``: each ``(pod, data)``
    rank's ``model`` ranks together, vocab-parallel, the same losses,
    norms and parameters as the whole chunks'."""
    from unittest import mock

    from repro_torch.models import transformer
    want = _run(TL, TP_MESH)
    with mock.patch.object(transformer, "_ce_fits", lambda *a: False):
        got = _run(TL, TP_MESH)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    for a, b in zip(tree.flatten(got[2])[0], tree.flatten(want[2])[0]):
        _close_rel(a, b, 1e-6)


def test_tp_replay_is_bitwise():
    """F3 at ``2x2x2``: the same two steps twice give the same bits."""
    a = _run("zamba2-wide", TP_MESH)
    b = _run("zamba2-wide", TP_MESH)
    assert a[0] == b[0]
    for x, y in zip(tree.flatten(a[2])[0], tree.flatten(b[2])[0]):
        assert torch.equal(x, y)


#: every transport option the launcher takes, at 2x2x2: (flare, gather)
TRANSPORTS = {
    "wire": (dict(), "rhd"),
    "wire-ring": (dict(algorithm="ring"), "ring"),
    "innetwork": (dict(transport="innetwork"), "rhd"),
    "wire-int8": (dict(compression="int8"), "rhd"),
    "innetwork-int8": (dict(transport="innetwork", compression="int8"),
                       "rhd"),
    "wire-sparse": (dict(sparse_k_frac=0.1), "rhd"),
    "innetwork-sparse": (dict(transport="innetwork", sparse_k_frac=0.1),
                         "rhd"),
}


@pytest.mark.parametrize("case", sorted(TRANSPORTS))
def test_every_transport_at_2x2x2(case):
    """Each transport at ``2x2x2`` against the same transport at
    ``2x2x1``: the lossless ones within the module's bounds.  The lossy
    ones reduce each ``model`` rank's shard as a group of its own, so
    their int8 blocks and top-k sets are the shard's, not the whole
    leaf's: step 1's loss (before any reduction) within 1e-5, step 2's
    within 1e-3, and the error-feedback state carries the ``model``
    axis."""
    flare, gather = TRANSPORTS[case]
    got = _run("tinyllama-wide", TP_MESH, flare=flare, gather=gather)
    want = _run("tinyllama-wide", DP_MESH, flare=flare, gather=gather)
    lossy = "compression" in flare or "sparse_k_frac" in flare
    np.testing.assert_allclose(got[0][0][0], want[0][0][0], rtol=1e-5)
    np.testing.assert_allclose(got[0][1][0], want[0][1][0],
                               rtol=1e-3 if lossy else 1e-5)
    assert got[0][1][0] < got[0][0][0]
    ef = got[4][1].get("ef")
    assert (ef is not None) == lossy
    if lossy:
        assert all(tuple(e.shape[:3]) == TP_MESH for e in ef)
    else:
        _hold_params(got[2], want[2], want[1], False)


def test_tp_checkpoint_round_trip(tmp_path, capsys):
    """``launch.train --mesh 2x2x2 --ckpt-dir D --ckpt-every 2`` saves the
    global state (the ``model`` blocks joined); ``--resume`` restores it
    on ``2x2x2`` and on ``2x2x1`` (an elastic restart off ``model``), and
    the resumed steps agree within 1e-5."""
    common = ["--smoke", "--device", "cpu", "--seq", "32",
              "--ckpt-dir", str(tmp_path), "--transport", "innetwork",
              "--reproducible"]
    launch_train.main(common + ["--mesh", "2x2x2", "--steps", "2",
                                "--ckpt-every", "2"])
    runs = {}
    for mesh in ("2x2x2", "2x2x1"):
        runs[mesh] = launch_train.main(common + ["--mesh", mesh, "--steps",
                                                 "3", "--resume"])
    out = capsys.readouterr().out
    assert out.count("resumed from step 2") == 2
    assert len(runs["2x2x2"]) == 1
    np.testing.assert_allclose(runs["2x2x2"], runs["2x2x1"], rtol=1e-5)
    run = launch_train.setup(["--smoke", "--device", "cpu", "--mesh",
                              "2x2x2", "--compression", "int8"])
    run.train_step()
    state = run.state()
    assert [tuple(e.shape) for e in state["o"]["ef"]] == [
        tuple(t.shape) for t, d in zip(tree.flatten(state["p"])[0],
                                       tree.flatten(run.step.dims)[0])
        if d < 0]
    run.load_state(state)
    again = run.state()
    for a, b in zip(tree.flatten(again)[0], tree.flatten(state)[0]):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))


def test_launcher_at_2x2x2(capsys):
    """``launch.train --mesh 2x2x2`` on the CPU: the losses of
    ``--mesh 2x2x1``'s run within 1e-5, falling."""
    args = ["--smoke", "--device", "cpu", "--steps", "2", "--seq", "32"]
    tp2 = launch_train.main(args + ["--mesh", "2x2x2"])
    tp1 = launch_train.main(args + ["--mesh", "2x2x1"])
    assert "'model': 2" in capsys.readouterr().out
    np.testing.assert_allclose(tp2, tp1, rtol=1e-5)
    assert tp2[1] < tp2[0]


# ---------------------------------------------------------------------------
# Against the JAX package.
# ---------------------------------------------------------------------------

def _nested(f):
    return jax.jit(jax.vmap(jax.vmap(f, axis_name="data"), axis_name="pod"))


def test_tinyllama_2x2x2_matches_reference_model_1_step():
    """TinyLlama's SMOKE at ``2x2x2`` from the reference's parameters
    against the reference's ``step_body`` at ``model`` = 1 (nested
    ``vmap`` over ``(pod, data)``, ``2x2x1``) on its ``seed=1`` stream:
    losses and gradient norms within 1e-5, the parameters within the
    Adam bounds."""
    jcfg = jconfigs.load(TL).SMOKE.scaled(dtype=jnp.float32)
    jp = jax.tree.map(np.asarray, jget_model(jcfg).init(
        jax.random.PRNGKey(0)))
    jmcfg = jrules.MeshCfg(AXES3, DP_MESH)
    body, _, _, _, jinit = jtrainer.make_train_step(
        jget_model(jcfg), jmcfg, jtrainer.TrainConfig(
            lr=1e-3, gather_algorithm="fixed_tree",
            flare=jengine.FlareConfig(axes=("pod", "data"), **REPRO)), jp)
    jparams = jax.tree.map(lambda a: np.broadcast_to(a, (2, 2) + a.shape
                                                     ).copy(), jp)
    jopt = jax.vmap(jax.vmap(jinit))(jparams)
    jstep = _nested(body)
    from repro.data import pipeline as jpipeline
    stream = jpipeline.synthetic_batches(jcfg, 8, 32, seed=1,
                                         prefetch=False)
    want = []
    m1 = None
    for _ in range(2):
        batch = {k: np.asarray(v).reshape(2, 2, -1, *v.shape[1:])
                 for k, v in next(stream).items()}
        jparams, jopt, jm = jstep(jparams, jopt, batch)
        want.append((float(np.asarray(jm["loss"])[0, 0]),
                     float(np.asarray(jm["grad_norm"])[0, 0])))
        if m1 is None:
            m1 = jax.tree.map(lambda a: torch.from_numpy(
                np.asarray(a)[0, 0].copy()), jopt["m"])
    full = params_from_jax(jp, "cpu")
    got = _run(TL, TP_MESH, params=full)
    np.testing.assert_allclose(got[0], want, rtol=1e-5)
    jfinal = params_from_jax(jax.tree.map(lambda a: np.asarray(a)[0, 0],
                                          jparams), "cpu")
    _hold_params(got[2], jfinal, m1, False)


_REFERENCE_MESH_STEP = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
from repro import compat, configs
from repro.core.engine import FlareConfig
from repro.models import get_model
from repro.sharding import rules
from repro.train import trainer
mesh = compat.make_mesh((2, 2, 2), ("pod", "data", "model"))
mcfg = rules.MeshCfg(("pod", "data", "model"), (2, 2, 2))
cfg = configs.load("tinyllama-1.1b").SMOKE.scaled(dtype=jnp.float32)
m = get_model(cfg)
key = jax.random.PRNGKey(0)
rng = np.random.default_rng(5)
batch = {k: rng.integers(0, cfg.vocab, (8, 16)).astype(np.int32)
         for k in ("tokens", "labels")}
tcfg = trainer.TrainConfig(lr=1e-2, flare=FlareConfig(axes=("pod", "data")))
with compat.set_mesh(mesh):
    fn, param_sh, opt_sh, batch_sh, init_opt = trainer.jit_train_step(
        m, mesh, mcfg, tcfg, jax.eval_shape(m.init, key), batch,
        donate=False)
    params = jax.device_put(m.init(key), param_sh)
    opt = jax.device_put(init_opt(params), opt_sh)
    bd = {k: jax.device_put(v, batch_sh[k]) for k, v in batch.items()}
    losses = []
    for _ in range(3):
        params, opt, metrics = fn(params, opt, bd)
        losses.append(float(metrics["loss"]))
print("LOSSES", json.dumps(losses))
"""


def test_tinyllama_2x2x2_matches_reference_jit_step_on_8_devices():
    """The reference's own ``jit_train_step`` on a ``(2, 2, 2)`` mesh of 8
    fake CPU devices (XLA partitions ``model``), as
    ``tests/multidevice_checks.py``'s trainer group runs it, in a
    subprocess; the port at ``2x2x2`` from the same parameters on the
    same batch, three steps at lr 1e-2: the losses within 1e-5."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src"),
         env.get("PYTHONPATH", "")])
    r = subprocess.run([sys.executable, "-c", _REFERENCE_MESH_STEP],
                       capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0, r.stderr[-4000:]
    want = json.loads(r.stdout.split("LOSSES", 1)[1])

    jcfg = jconfigs.load(TL).SMOKE.scaled(dtype=jnp.float32)
    full = params_from_jax(jax.tree.map(np.asarray, jget_model(jcfg).init(
        jax.random.PRNGKey(0))), "cpu")
    cfg = configs.load(TL).SMOKE.scaled(dtype=torch.float32)
    mc = rules.MeshCfg(AXES3, TP_MESH)
    step = trainer.make_train_step(
        get_model(cfg), mc, trainer.TrainConfig(
            lr=1e-2, flare=FlareConfig(axes=("pod", "data"))), full)
    p = rules.shard_params(full, mc)
    opt = step.init_opt_state(p)
    rng = np.random.default_rng(5)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (8, 16)).astype(
        np.int32)) for k in ("tokens", "labels")}
    got = []
    for _ in range(3):
        p, opt, met = step(p, opt, rules.split_batch(batch, mc))
        got.append(float(met["loss"]))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0]


_REFERENCE_HEAD_SPLIT = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
from repro import compat, configs
from repro.core.engine import FlareConfig
from repro.models import get_model
from repro.sharding import rules
from repro.train import trainer
mesh = compat.make_mesh((1, 8), ("data", "model"))
mcfg = rules.MeshCfg(("data", "model"), (1, 8))
out = {}
for arch in ("tinyllama-1.1b", "gemma2-2b"):
    cfg = configs.load(arch).SMOKE.scaled(dtype=jnp.float32)
    m = get_model(cfg)
    key = jax.random.PRNGKey(0)
    rng = np.random.default_rng(5)
    batch = {k: rng.integers(0, cfg.vocab, (8, 16)).astype(np.int32)
             for k in ("tokens", "labels")}
    tcfg = trainer.TrainConfig(lr=1e-2, flare=FlareConfig(axes=("data",)))
    with compat.set_mesh(mesh):
        fn, param_sh, opt_sh, batch_sh, init_opt = trainer.jit_train_step(
            m, mesh, mcfg, tcfg, jax.eval_shape(m.init, key), batch,
            donate=False)
        params = jax.device_put(m.init(key), param_sh)
        opt = jax.device_put(init_opt(params), opt_sh)
        bd = {k: jax.device_put(v, batch_sh[k]) for k, v in batch.items()}
        for i in range(2):
            params, opt, met = fn(params, opt, bd)
            out[f"{arch}/loss{i}"] = np.asarray(met["loss"])
            out[f"{arch}/norm{i}"] = np.asarray(met["grad_norm"])
            if i == 0:
                for j, leaf in enumerate(jax.tree.leaves(opt["m"])):
                    out[f"{arch}/m1/{j}"] = np.asarray(leaf)
np.savez(sys.argv[1], **out)
"""


def test_head_split_over_model_matches_reference_jit_step_on_8_devices(
        tmp_path):
    """A query head split over ``model``: TinyLlama's SMOKE (4 heads of 16)
    and gemma2-2b's (4 heads, 2 KV heads, window 8) at ``("data",
    "model")`` = ``(1, 8)``, where XLA partitions inside a head, against
    the reference's own ``jit_train_step`` on 8 fake CPU devices in a
    subprocess, from the same parameters on the same batch: fp32 losses
    of two steps and step 1's gradient norm within 1e-5 relative, and
    every step-1 gradient (Adam's first moment, ``(1 - b1)`` times the
    clipped gradient) within 1e-5 of its leaf's largest.  Step 2's
    gradient norm follows Adam's first update, which moves a weight whose
    gradient nearly cancels by about lr whatever its last digits (module
    doc): found, gemma2's is 2.4e-5 from the reference's at ``(1, 1)`` as
    well, so it is held to the port's own ``(1, 1)`` step instead."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src"),
         env.get("PYTHONPATH", "")])
    path = tmp_path / "ref.npz"
    r = subprocess.run([sys.executable, "-c", _REFERENCE_HEAD_SPLIT,
                        str(path)], capture_output=True, text=True,
                       timeout=600, env=env)
    assert r.returncode == 0, r.stderr[-4000:]
    want = np.load(path)
    for arch in ("tinyllama-1.1b", "gemma2-2b"):
        jcfg = jconfigs.load(arch).SMOKE.scaled(dtype=jnp.float32)
        jp = jax.tree.map(np.asarray, jget_model(jcfg).init(
            jax.random.PRNGKey(0)))
        cfg = configs.load(arch).SMOKE.scaled(dtype=torch.float32)
        rng = np.random.default_rng(5)
        batch = {k: torch.from_numpy(rng.integers(
            0, cfg.vocab, (8, 16)).astype(np.int32))
            for k in ("tokens", "labels")}
        got = {}
        for shape in ((1, 8), (1, 1)):
            mc = rules.MeshCfg(("data", "model"), shape)
            full = params_from_jax(jp, "cpu")
            step = trainer.make_train_step(
                get_model(cfg), mc, trainer.TrainConfig(
                    lr=1e-2, flare=FlareConfig(axes=("data",))), full)
            p = rules.shard_params(full, mc)
            opt = step.init_opt_state(p)
            mets = []
            for i in range(2):
                p, opt, met = step(p, opt, rules.split_batch(batch, mc))
                mets.append((float(met["loss"]), float(met["grad_norm"])))
                if i == 0 and shape == (1, 8):
                    m1 = rules.unshard_params(opt["m"], mc, step.dims,
                                              step.tp_dims)
            got[shape] = mets
        split = got[(1, 8)]
        np.testing.assert_allclose(
            [split[0][0], split[1][0], split[0][1]],
            [float(want[f"{arch}/{k}"]) for k in ("loss0", "loss1",
                                                  "norm0")],
            rtol=1e-5, err_msg=arch)
        np.testing.assert_allclose(split[1][1], got[(1, 1)][1][1],
                                   rtol=1e-5, err_msg=arch)
        jm = [want[f"{arch}/m1/{j}"] for j in range(len(jax.tree.leaves(jp)))]
        jm1 = params_from_jax(jax.tree.unflatten(jax.tree.structure(jp), jm),
                              "cpu")
        for a, b in zip(tree.flatten(m1)[0], tree.flatten(jm1)[0]):
            _close_rel(a.numpy(), b.numpy())
