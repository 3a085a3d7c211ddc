"""The port's zamba2-1.2b (the hybrid family: a shared attention block
over the mamba2 stack) against the JAX package's.

zamba2's SMOKE config (5 mamba layers, the shared block after every 2:
two groups and a tail of one) runs through both packages on the same
seeded numpy inputs, the reference's parameters carried across with
``convert.params_from_jax``; the reference's functions are jitted.  The
SMOKE chunk is 8: a prompt of a multiple of 8 takes the chunked SSD,
every decode step the recurrent one.  The train steps run the
reference's ``step_body`` under nested ``jax.vmap`` over ``("pod",
"data")``.

Tolerances: fp32 results within 1e-5 of their largest magnitude
(summation order); the slot servers' greedy tokens equal.  bf16: the
loss within 2e-2.  zamba2's bf16 floor is wider than 2e-2 in both
packages: against the fp32 reference on the same (bf16-rounded) weights
the reference's own bf16 prefill logits are 3.1 % off and its gradients
up to 6.6 % (``layers/conv_cb``), the port's 3.5 % and 7.7 %
(``layers/A_log``; mamba2's 5-layer SMOKE shows the reference 7.5 % off
there).  So every other bf16 tensor of the port is held to the fp32
reference within the larger of 2e-2 and 1.5 times the reference's own
bf16 error (for the gradients, its largest over the leaves): as close
to the exact function as the reference's bf16 is (ROADMAP queue 3).
"""
import dataclasses
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import engine as jengine
from repro.data import pipeline as jpipeline
from repro.models import get_model as jget_model
from repro.serve import BatchedServer as JServer
from repro.sharding import rules as jrules
from repro.train import trainer as jtrainer
from repro_torch import configs, tree
from repro_torch.convert import params_from_jax
from repro_torch.core.engine import FlareConfig
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import registry, zamba2
from repro_torch.models.registry import get_model
from repro_torch.serve import BatchedServer
from repro_torch.sharding import rules
from repro_torch.train import trainer

torch.set_num_threads(1)

ARCH = "zamba2-1.2b"
DTYPES = ["float32", "bfloat16"]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
AXES = ("pod", "data")


def _np(a):
    if isinstance(a, torch.Tensor):
        a = a.detach().float()
    return np.asarray(a, np.float32)


def _close(got, want, dtype="float32"):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= TOL[dtype] * float(np.abs(want).max()), err
    return err


def _close_bf16(got, want, f32):
    """``got`` (the port's bf16) within the module's bf16 floor: against
    the fp32 reference ``f32``, within the larger of 2e-2 and 1.5 times
    the error of the reference's bf16 ``want``."""
    got, want, f32 = _np(got), _np(want), _np(f32)
    scale = float(np.abs(f32).max())
    ref = float(np.abs(want - f32).max()) / scale
    err = float(np.abs(got - f32).max()) / scale
    assert err <= max(2e-2, 1.5 * ref), (err, ref)


def _cfgs(dtype="float32", **kw):
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    return (jconfigs.load(ARCH).SMOKE.scaled(dtype=jd, **kw),
            configs.load(ARCH).SMOKE.scaled(dtype=td, **kw))


@functools.cache
def _models(dtype="float32"):
    """(reference model, its params, port model, the same params), the
    parameters cast as ``rules.cast_params`` casts them."""
    jcfg, cfg = _cfgs(dtype)
    jm, m = jget_model(jcfg), get_model(cfg)
    jp = jax.tree.map(np.asarray, jrules.cast_params(
        jm.init(jax.random.PRNGKey(0)), jcfg.dtype))
    return jm, jp, m, params_from_jax(jp, "cpu")


def _tokens(vocab, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


# ---------------------------------------------------------------------------
# The config, the parameters, loss and gradients.
# ---------------------------------------------------------------------------

def test_config_is_the_references():
    j, t = jconfigs.load(ARCH), configs.load(ARCH)
    for name in ("CONFIG", "SMOKE"):
        jc, tc = getattr(j, name), getattr(t, name)
        want = {f.name: getattr(jc, f.name)
                for f in dataclasses.fields(jc) if f.name != "dtype"}
        assert {k: getattr(tc, k) for k in want} == want
    assert [dataclasses.astuple(s) for s in t.SHAPES] == \
        [dataclasses.astuple(s) for s in j.SHAPES]
    assert configs.load("zamba2_1_2b") is t
    assert zamba2._groups(t.CONFIG) == (6, 2)
    assert zamba2._groups(t.SMOKE) == (2, 1)
    assert get_model(t.SMOKE).cfg.family == "hybrid"


def test_init_params_has_the_references_leaves():
    """mamba2's leaves and one unstacked ``shared_block``, a transformer
    layer without MoE; ``init_params(cast=)`` equal to the cast of the
    fp32 draw, ``KEEP_F32`` leaves fp32."""
    jm, jp, m, _ = _models()
    p = m.init(torch.Generator().manual_seed(0))
    assert tree.paths(p) == [tuple(k.key for k in path) for path, _ in
                             jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert [tuple(t.shape) for t in tree.flatten(p)[0]] == \
        [a.shape for a in jax.tree.leaves(jp)]
    assert p["shared_block"]["attn"]["wq"].shape == (64, 64)
    cfg = m.cfg.scaled(dtype=torch.bfloat16)
    cast = functools.partial(rules.cast_params, dtype=cfg.dtype)
    got = get_model(cfg).init(torch.Generator().manual_seed(0), cast=cast)
    for path, a, b in zip(tree.paths(got), tree.flatten(got)[0],
                          tree.flatten(p)[0]):
        assert torch.equal(a, b.to(a.dtype))
        assert a.dtype == (torch.float32 if path[-1] in rules.KEEP_F32
                           else torch.bfloat16)


def _f32_reference(jp):
    """The fp32 reference model and the (bf16-rounded) weights in fp32."""
    jm32 = jget_model(_cfgs()[0])
    return jm32, jax.tree.map(lambda a: np.asarray(a, np.float32), jp)


@pytest.mark.parametrize("dtype", DTYPES)
def test_loss_and_gradients_match_jax(dtype):
    """fp32: the loss within 1e-5 and every gradient within 1e-5 of its
    leaf's largest; bf16 (the compute-dtype parameters the trainer's
    gather hands the model): the loss within 2e-2, the gradients within
    the module's bf16 floor."""
    jm, jp, m, _ = _models(dtype)
    toks = _tokens(m.cfg.vocab, 2, 24)
    batch = {"tokens": toks, "labels": _tokens(m.cfg.vocab, 2, 24, seed=1)}
    jl, jg = jax.jit(jax.value_and_grad(lambda q: jm.loss(q, batch)))(jp)
    p = tree.map_leaves(lambda t: t.requires_grad_(),
                        params_from_jax(jp, "cpu"))
    loss = m.loss(p, params_from_jax(batch, "cpu"))
    np.testing.assert_allclose(float(loss.detach()), float(jl),
                               rtol=TOL[dtype])
    loss.backward()
    jg = [_np(w) for w in jax.tree.leaves(jg)]
    if dtype == "float32":
        for path, g, w in zip(tree.paths(p), tree.flatten(p)[0], jg):
            _close(g.grad, w)
        return
    jm32, jp32 = _f32_reference(jp)
    exact = [_np(w) for w in jax.tree.leaves(jax.jit(jax.grad(
        lambda q: jm32.loss(q, batch)))(jp32))]
    floor = max(float(np.abs(w - e).max() / np.abs(e).max())
                for w, e in zip(jg, exact))
    for path, g, e in zip(tree.paths(p), tree.flatten(p)[0], exact):
        assert g.grad.dtype == g.dtype
        err = float(np.abs(_np(g.grad) - e).max() / np.abs(e).max())
        assert err <= max(2e-2, 1.5 * floor), (path, err, floor)


def test_shared_block_gradient_sums_its_uses():
    """The shared block's gradient is the sum of its two uses' (its
    ``wq`` cut off the stream at one use moves the gradient), equal to
    the reference's; the block is one leaf a parameter in the trainer's
    autograd view."""
    jm, jp, m, p = _models()
    toks = _tokens(m.cfg.vocab, 2, 16, seed=4)
    batch = {"tokens": toks, "labels": _tokens(m.cfg.vocab, 2, 16, seed=5)}
    jg = jax.jit(jax.grad(lambda q: jm.loss(q, batch)))(jp)
    q = tree.map_leaves(lambda t: t.clone().requires_grad_(), p)
    m.loss(q, params_from_jax(batch, "cpu")).backward()
    for path, g, w in zip(tree.paths(q["shared_block"]),
                          tree.flatten(q["shared_block"])[0],
                          jax.tree.leaves(jg["shared_block"])):
        _close(g.grad, w)
    # one use alone: the other use's weights detached
    calls = []
    orig = zamba2.tf._self_layer

    def once(cfg, lp, x, **kw):
        calls.append(1)
        if len(calls) == 2:
            lp = tree.map_leaves(lambda t: t.detach(), lp)
        return orig(cfg, lp, x, **kw)
    r = tree.map_leaves(lambda t: t.clone().requires_grad_(), p)
    with mock.patch.object(zamba2.tf, "_self_layer", once):
        m.loss(r, params_from_jax(batch, "cpu")).backward()
    assert len(calls) == 2
    wq, one = q["shared_block"]["attn"]["wq"].grad, \
        r["shared_block"]["attn"]["wq"].grad
    assert float((wq - one).abs().max()) > 1e-3 * float(wq.abs().max())
    view = trainer._autograd_view(p, tree.map_leaves(torch.zeros_like, p), 0)
    assert isinstance(view["shared_block"]["attn"]["wq"], torch.Tensor)
    assert len(view["layers"]) == m.cfg.n_layers


# ---------------------------------------------------------------------------
# Serving: init_cache, prefill, decode, the slot server.
# ---------------------------------------------------------------------------

def test_init_cache_matches_jax():
    jm, _, m, _ = _models()
    jc, c = jm.init_cache(3, 24), m.init_cache(3, 24)
    assert c["pos"] == int(jc["pos"]) == 23
    assert set(c) == set(jc) == {"mamba", "attn", "pos"}
    for name in ("mamba", "attn"):
        assert set(c[name]) == set(jc[name])
        for k in jc[name]:
            assert tuple(c[name][k].shape) == jc[name][k].shape
            assert str(c[name][k].dtype).split(".")[1] == \
                jc[name][k].dtype.name
            assert not c[name][k].any()


def _port_cache(jc):
    c = {k: params_from_jax(jax.tree.map(np.asarray, v), "cpu")
         for k, v in jc.items() if k != "pos"}
    c["pos"] = int(jc["pos"])
    return c


def _check(got, want, exact, dtype):
    """fp32: ``got`` within 1e-5 of ``want``; bf16: within the floor of
    the fp32 reference's ``exact``."""
    if dtype == "float32":
        _close(got, want)
    else:
        _close_bf16(got, want, exact)


def _assert_cache(got, want, dtype, exact=None):
    assert set(got) == set(want) and got["pos"] == int(want["pos"])
    for name in ("mamba", "attn"):
        assert set(got[name]) == set(want[name])
        for k in want[name]:
            assert str(got[name][k].dtype).split(".")[1] == \
                want[name][k].dtype.name
            _check(got[name][k], want[name][k],
                   None if exact is None else exact[name][k], dtype)


def _grow(jc, n):
    """The prefill's cache grown by ``n`` positions: the shared block's
    K/V only (the mamba state has no sequence axis)."""
    pad = lambda a: jnp.concatenate(                           # noqa: E731
        [a, jnp.zeros(a.shape[:2] + (n,) + a.shape[3:], a.dtype)], 2)
    return dict(jc, attn={k: pad(v) for k, v in jc["attn"].items()})


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_and_decode_match_jax(dtype):
    """A prefill of 16 (the chunked SSD), the K/V grown by 4, then a step
    of one token and one of two (the recurrent SSD): the same logits and
    both parts of the cache, the port's cache written in place."""
    jm, jp, m, p = _models(dtype)
    jm32, jp32 = _f32_reference(jp)
    toks = _tokens(m.cfg.vocab, 2, 19, seed=3)
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": toks[:, :16]})
    el, ec = jax.jit(jm32.prefill)(jp32, {"tokens": toks[:, :16]})
    with torch.inference_mode():
        l, c = m.prefill(p, {"tokens": torch.from_numpy(toks[:, :16])})
    assert l.dtype == getattr(torch, dtype) and l.shape == (2, 1, 256)
    _check(l, jl, el, dtype)
    _assert_cache(c, jc, dtype, ec)
    assert c["attn"]["k"].shape == (2, 2, 16, 4, 16)
    jc, ec = _grow(jc, 4), _grow(ec, 4)
    c = _port_cache(jc)
    for t0, t1 in ((16, 17), (17, 19)):
        tok = jnp.asarray(toks[:, t0:t1])
        jl, jc = jax.jit(jm.decode)(jp, tok, jc)
        el, ec = jax.jit(jm32.decode)(jp32, tok, ec)
        with torch.inference_mode():
            l, c2 = m.decode(p, torch.from_numpy(toks[:, t0:t1]), c)
        assert all(a is b for a, b in zip(tree.flatten(c2)[0][:-1],
                                          tree.flatten(c)[0][:-1]))
        c = c2
        assert l.shape == (2, t1 - t0, 256)
        _check(l, jl, el, dtype)
        _assert_cache(c, jc, dtype, ec)


def test_decode_from_init_cache_clamps_as_jax():
    """Two tokens from ``init_cache``'s ``pos`` (23 of 24 entries): the
    K/V write clamps to 22, as ``dynamic_update_slice`` clamps it."""
    jm, jp, m, p = _models()
    jc, c = jm.init_cache(2, 24), m.init_cache(2, 24)
    toks = _tokens(m.cfg.vocab, 2, 2, seed=5)
    jl, jc = jax.jit(jm.decode)(jp, jnp.asarray(toks), jc)
    with torch.inference_mode():
        l, c = m.decode(p, torch.from_numpy(toks), c)
    _close(l, jl)
    _assert_cache(c, jc, "float32")
    assert c["pos"] == 25


def test_chunked_prefill_equals_recurrent_feed():
    """The chunked prefill of 16 against the same tokens fed one at a
    time through ``decode_step``: the last logits within 2e-3 of
    max|logit|, ``tests/test_models.py``'s bound."""
    _, _, m, p = _models()
    toks = torch.from_numpy(_tokens(m.cfg.vocab, 2, 16, seed=7))
    with torch.inference_mode():
        lp, cp = m.prefill(p, {"tokens": toks})
        c = m.init_cache(2, 16)
        c["pos"] = 0
        for t in range(16):
            ld, c = m.decode(p, toks[:, t:t + 1], c)
    rel = float((lp[:, -1] - ld[:, -1]).abs().max() / lp.abs().max())
    assert rel < 2e-3, rel
    for k in cp["mamba"]:
        _close(c["mamba"][k], cp["mamba"][k])
    _close(c["attn"]["k"], cp["attn"]["k"])


def _serve(jm, jp, m, p, prompts, budgets):
    js = JServer(jm, jp, slots=2, max_len=24)
    srv = BatchedServer(m, p, slots=2, max_len=24)
    jr = [js.submit(x, max_new=n) for x, n in zip(prompts, budgets)]
    r = [srv.submit(x, max_new=n) for x, n in zip(prompts, budgets)]
    assert srv.run(max_steps=200) == js.run(max_steps=200)
    assert [x.out for x in r] == [x.out for x in jr]
    return [x.out for x in r]


def test_batched_server_matches_jax_lockstep_deviation_included():
    """The reference's slot server and the port's (fp32), one request and
    then two: every request's tokens and the step count equal.  Every
    lane's mamba state steps in lockstep and the K/V are written at the
    first active slot's position, so the second request changes the first
    one's tokens in both packages (ROADMAP queue 3)."""
    jm, jp, m, p = _models()
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, m.cfg.vocab, size=n) for n in (4, 3)]
    alone = _serve(jm, jp, m, p, prompts[:1], [8])
    both = _serve(jm, jp, m, p, prompts, [8, 6])
    assert both[0] != alone[0]


# ---------------------------------------------------------------------------
# Sharding rules, train steps and the launchers.
# ---------------------------------------------------------------------------

WIDE = dict(d_model=256, d_ff=512, vocab=512)


@functools.cache
def _wide_params(seed=0):
    jcfg, _ = _cfgs(**WIDE)
    return jax.tree.map(np.asarray, jget_model(jcfg).init(
        jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("mesh", [(("pod", "data", "model"), (2, 4, 1)),
                                  (("data", "model"), (8, 1)),
                                  (("pod", "data", "model"), (2, 2, 2))])
def test_param_specs_match_jax(mesh):
    """The FSDP dims (and at ``model`` = 2 the TP dims) of the widened
    config are the reference's: the shared block's projections and MLP
    sharded like a transformer layer's, its norms replicated."""
    jp = _wide_params()
    full, _, jdims = jrules.param_specs(jp, jrules.MeshCfg(*mesh))
    mc = rules.MeshCfg(*mesh)
    dims = rules.param_specs(jp, mc)
    assert tree.flatten(dims)[0] == jax.tree.leaves(jdims)
    sharded = {"/".join(p) for p, d in zip(tree.paths(dims),
                                           tree.flatten(dims)[0]) if d >= 0}
    assert {"shared_block/ffn/w_up", "shared_block/ffn/w_down",
            "layers/wz", "layers/out_proj", "embed"} <= sharded
    assert not any(s.endswith(("ln1", "ln2", "gate_norm", "A_log"))
                   for s in sharded)
    tpd = rules.tp_specs(jp, mc)
    specs = jax.tree.leaves(full, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))
    for path, t, spec in zip(tree.paths(tpd), tree.flatten(tpd)[0], specs):
        off = int(path[0] in rules.STACKED_ROOTS)
        want = list(spec).index("model") - off if "model" in spec else -1
        assert t == (want if mc.tp > 1 else -1), path


def _nested(f):
    return jax.jit(jax.vmap(jax.vmap(f, axis_name="data"), axis_name="pod"))


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


def test_two_train_steps_match_jax():
    """Two train steps on ``(2, 4)``, in the network and reproducible, the
    widened config, so that the shared block is gathered at each of its
    uses and its gradient is the sum of the uses' reduce-scatters:
    losses and gradient norms within 1e-5, the step-1 gradients (Adam's
    first moments) within 1e-5 of each leaf's largest.

    The parameters are held as ``tests/test_torch_models.py`` holds the
    MoE's: all but 0.01 % of each leaf's elements within 1e-5 where the
    step-1 gradient is well conditioned (|m1| >= 1e-8) and 1e-4 where it
    is not, and each element outside those bounds accounted for by the
    readings: its step-2 gradient within 1e-4 of its leaf's largest, and
    its difference within what Adam's updates make of the two packages'
    moments, lr · Σ_t |Δ(m̂_t / (√v̂_t + eps))|, plus 1e-5.  Adam divides
    a gradient by its own magnitude, and the shared block's and the SSD
    stack's gradients hold sums that nearly cancel.  Found: 4 elements of
    ``embed`` (rows no step-1 token names; step-2 gradients 7e-9 and
    -4e-9 in the two packages) off by up to 1.2e-3, and elements of
    ``out_proj``, ``wx``, ``wz`` and the shared block's ``wv``,
    ``w_gate`` and ``w_up`` (step-1 gradients near 1e-7 agreeing to 4
    digits, step-2 ones to 2) by up to 2.5e-4."""
    jcfg, cfg = _cfgs(**WIDE)
    mesh = (("pod", "data", "model"), (2, 4, 1))
    jmcfg, mcfg = jrules.MeshCfg(*mesh), rules.MeshCfg(*mesh)
    flare = dict(axes=AXES, transport="innetwork", reproducible=True)
    jp = _wide_params()
    body, _, _, _, jinit = jtrainer.make_train_step(
        jget_model(jcfg), jmcfg, jtrainer.TrainConfig(
            lr=1e-3, gather_algorithm="fixed_tree",
            flare=jengine.FlareConfig(**flare)), jp)
    jstep = _nested(body)
    jparams = _per_rank_jax(jp, jmcfg)
    jopt = jax.vmap(jax.vmap(jinit))(jparams)
    full = params_from_jax(jp, "cpu")
    step = trainer.make_train_step(get_model(cfg), mcfg, trainer.TrainConfig(
        lr=1e-3, gather_algorithm="fixed_tree", flare=FlareConfig(**flare)),
        full)
    params = rules.shard_params(full, mcfg)
    opt = step.init_opt_state(params)
    stream = jpipeline.synthetic_batches(jcfg, 8, 32, seed=1,
                                         prefetch=False)
    moments = []                 # each step's (m, v): port's, reference's
    for _ in range(2):
        batch = {k: np.asarray(v) for k, v in next(stream).items()}
        jparams, jopt, jm = jstep(jparams, jopt, {
            k: v.reshape(2, 4, -1, *v.shape[1:]) for k, v in batch.items()})
        params, opt, m = step(params, opt, rules.split_batch(
            params_from_jax(batch, "cpu"), mcfg))
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[k]),
                                       float(np.asarray(jm[k])[0, 0]),
                                       rtol=1e-5)
        moments.append([[(t.numpy().copy(), np.asarray(j)) for t, j in zip(
            tree.flatten(opt[k])[0], jax.tree.leaves(jopt[k]))]
            for k in ("m", "v")])
    for a, b in moments[0][0]:
        _close(a, b)                 # step 1's first moments: its gradients
    for i, (a, b) in enumerate(zip(tree.flatten(params)[0],
                                   jax.tree.leaves(jparams))):
        a, b = a.numpy(), np.asarray(b)
        d = np.abs(a - b)
        well = np.abs(moments[0][0][i][1]) >= 1e-8
        off = d > np.where(well, 1e-5 + 1e-5 * np.abs(b), 1e-4)
        assert off.sum() <= 1e-4 * d.size, (off.sum(), d.size)
        (pm, jmm), (nm, jnm) = moments[0][0][i], moments[1][0][i]
        g2, jg2 = (nm - 0.9 * pm) / 0.1, (jnm - 0.9 * jmm) / 0.1
        assert np.abs(g2 - jg2)[off].max(initial=0) <= \
            1e-4 * np.abs(jg2).max()
        adam = 0.0
        for t, ((pm, jmm), (pv, jv)) in enumerate(
                ((mt[i], vt[i]) for mt, vt in moments), start=1):
            u = [(x / (1 - 0.9**t)) / (np.sqrt(y / (1 - 0.95**t)) + 1e-8)
                 for x, y in ((pm, pv), (jmm, jv))]
            adam = adam + 1e-3 * np.abs(u[0] - u[1])
        assert (d <= adam + 1e-5 + 1e-5 * np.abs(b))[off].all()


def _with_reference_init(jp):
    orig = registry.get_model

    def get(cfg):
        m = orig(cfg)
        return dataclasses.replace(
            m, init=lambda gen: params_from_jax(jp, str(gen.device)))
    return mock.patch.object(registry, "get_model", get)


def test_launcher_train_steps_match_jax(capsys):
    """``launch.train --arch zamba2-1.2b --smoke --mesh 2x4x1 --transport
    innetwork --reproducible`` from the reference's init against the
    reference launcher's per-rank ``step_body`` under nested ``vmap`` on
    its ``seed=1`` stream: losses within 1e-5, falling; then the serving
    launcher on the CPU."""
    jcfg = jconfigs.load(ARCH).SMOKE.scaled(dtype=jnp.float32)
    jp = jax.tree.map(np.asarray, jget_model(jcfg).init(
        jax.random.PRNGKey(0)))
    with _with_reference_init(jp):
        losses = launch_train.main([
            "--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "2",
            "--mesh", "2x4x1", "--transport", "innetwork", "--reproducible",
            "--seq", "32"])
    jmcfg = jrules.MeshCfg(("pod", "data", "model"), (2, 4, 1))
    body, _, _, _, init = jtrainer.make_train_step(
        jget_model(jcfg), jmcfg, jtrainer.TrainConfig(
            lr=1e-3, gather_algorithm="fixed_tree",
            flare=jengine.FlareConfig(axes=AXES, transport="innetwork",
                                      reproducible=True)), jp)
    params = _per_rank_jax(jp, jmcfg)
    opt = jax.vmap(jax.vmap(init))(params)
    step = _nested(body)
    stream = jpipeline.synthetic_batches(jcfg, 8, 32, seed=1,
                                         prefetch=False)
    want = []
    for _ in range(2):
        batch = {k: np.asarray(v).reshape(2, 4, -1, *v.shape[1:])
                 for k, v in next(stream).items()}
        params, opt, m = step(params, opt, batch)
        want.append(float(np.asarray(m["loss"])[0, 0]))
    np.testing.assert_allclose(losses, want, rtol=1e-5)
    assert losses[1] < losses[0]
    reqs = launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                              "--requests", "3", "--max-new", "4",
                              "--slots", "2", "--max-len", "24"])
    assert all(r.done and len(r.out) == 4 for r in reqs)
    out = capsys.readouterr().out
    assert out.count(" loss ") == 2 and "served 3 requests" in out
