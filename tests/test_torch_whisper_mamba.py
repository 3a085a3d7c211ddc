"""The port's whisper-medium (the encoder-decoder) and mamba2-370m (the
chunked SSD) against the JAX package's.

Each arch's SMOKE config runs through both packages on the same seeded
numpy inputs, the reference's parameters carried across with
``convert.params_from_jax``; the reference's functions are jitted (its
models have no Pallas call).  Whisper's batches carry the data
pipeline's fp32 ``enc_frames`` ``(B, 16, 64)``.  mamba2's SMOKE chunk is
8: a sequence of a multiple of 8 takes the chunked SSD, any other length
(and every decode step) the recurrent one.  The train steps run the
reference's ``step_body`` under nested ``jax.vmap`` over ``("pod",
"data")``.

Tolerances: fp32 results within 1e-5 of their largest magnitude
(summation order), bf16 within 2e-2 (``tests/test_torch_serve.py``'s:
XLA and PyTorch round bf16 products and sums at other points); the
slot servers' greedy tokens equal.  bf16 parameters are cast as
``rules.cast_params`` casts them, mamba2's ``A_log``, ``D`` and
``dt_bias`` kept fp32.
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
from repro.models import base as jbase
from repro.models import get_model as jget_model
from repro.models import mamba2 as jmamba2
from repro.serve import BatchedServer as JServer
from repro.sharding import rules as jrules
from repro.train import trainer as jtrainer
from repro_torch import configs, tree
from repro_torch.convert import params_from_jax
from repro_torch.core.engine import FlareConfig
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import base, mamba2, registry
from repro_torch.models.registry import get_model
from repro_torch.serve import BatchedServer
from repro_torch.sharding import rules
from repro_torch.train import trainer

torch.set_num_threads(1)

WHISPER, MAMBA = "whisper-medium", "mamba2-370m"
ARCHS = [WHISPER, MAMBA]
DTYPES = ["float32", "bfloat16"]
#: relative tolerance of every compared tensor, by dtype (module doc)
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


def _cfgs(arch, dtype="float32", **kw):
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    return (jconfigs.load(arch).SMOKE.scaled(dtype=jd, **kw),
            configs.load(arch).SMOKE.scaled(dtype=td, **kw))


@functools.cache
def _models(arch, dtype="float32", **kw):
    """(reference model, its params, port model, the same params), the
    parameters cast as ``rules.cast_params`` casts them."""
    jcfg, cfg = _cfgs(arch, dtype, **kw)
    jm, m = jget_model(jcfg), get_model(cfg)
    jp = jax.tree.map(np.asarray, jrules.cast_params(
        jm.init(jax.random.PRNGKey(0)), jcfg.dtype))
    return jm, jp, m, params_from_jax(jp, "cpu")


def _tokens(vocab, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _batch(cfg, toks, **more):
    """``{"tokens": toks, **more}``, with whisper's fp32 frames ``(B,
    encoder_tokens, D)`` as the data pipeline makes them."""
    batch = {"tokens": toks, **more}
    if cfg.family == "audio":
        batch["enc_frames"] = np.random.default_rng(9).standard_normal(
            (toks.shape[0], cfg.encoder_tokens, cfg.d_model)).astype(
                np.float32) * 0.1
    return batch


# ---------------------------------------------------------------------------
# Configs, parameters, the layer library, loss and gradients.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_the_references(arch):
    j, t = jconfigs.load(arch), configs.load(arch)
    for name in ("CONFIG", "SMOKE"):
        jc, tc = getattr(j, name), getattr(t, name)
        want = {f.name: getattr(jc, f.name)
                for f in dataclasses.fields(jc) if f.name != "dtype"}
        assert {k: getattr(tc, k) for k in want} == want
    assert [dataclasses.astuple(s) for s in t.SHAPES] == \
        [dataclasses.astuple(s) for s in j.SHAPES]
    assert configs.load(arch.replace("-", "_").replace(".", "_")) is t


def test_shape_lists_are_the_references():
    assert dataclasses.astuple(configs.LONG_500K) == \
        dataclasses.astuple(jconfigs.LONG_500K)
    assert [dataclasses.astuple(s) for s in configs.SUBQUADRATIC_SHAPES] == \
        [dataclasses.astuple(s) for s in jconfigs.SUBQUADRATIC_SHAPES]


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_has_the_references_leaves(arch):
    jm, jp, m, _ = _models(arch)
    p = m.init(torch.Generator().manual_seed(0))
    assert tree.paths(p) == [tuple(k.key for k in path) for path, _ in
                             jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert [tuple(t.shape) for t in tree.flatten(p)[0]] == \
        [a.shape for a in jax.tree.leaves(jp)]


@pytest.mark.parametrize("arch", ARCHS)
def test_layerwise_cast_draw_keeps_the_fp32_leaves(arch):
    """``init_params(cast=)``, ``launch.serve``'s draw: each layer cast as
    it is drawn, equal to the fp32 draw of the same seed cast, in the
    compute dtype but mamba2's ``KEEP_F32`` leaves."""
    cfg = configs.load(arch).SMOKE
    m = get_model(cfg)
    whole = m.init(torch.Generator().manual_seed(0))
    cast = functools.partial(rules.cast_params, dtype=cfg.dtype)
    got = m.init(torch.Generator().manual_seed(0), cast=cast)
    assert tree.paths(got) == tree.paths(whole)
    for path, a, b in zip(tree.paths(got), tree.flatten(got)[0],
                          tree.flatten(whole)[0]):
        assert torch.equal(a, b.to(a.dtype))
        assert a.dtype == (torch.float32 if path[-1] in rules.KEEP_F32
                           else torch.bfloat16)
    stack = got["dec_layers" if arch == WHISPER else "layers"]
    w = stack["mlp"]["w_up"] if arch == WHISPER else stack["wz"]
    assert not torch.equal(w[0], w[1])


def _layer_inputs(seed=0, shape=(2, 3, 12, 64)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_layernorm_matches_jax():
    """``base.layernorm`` with weight and bias, fp32 out of fp32 and bf16
    out of bf16, and on rank axes (a ``(2, 64)`` weight over ``(2, 3, 12,
    64)`` rows) each rank its own weight."""
    rng = np.random.default_rng(1)
    x = _layer_inputs() * 3 + 1
    w, b = (rng.normal(size=(2, 64)).astype(np.float32) for _ in range(2))
    for r in range(2):
        want = jbase.layernorm(jnp.asarray(x[r]), w[r], b[r])
        got = base.layernorm(torch.from_numpy(x), torch.from_numpy(w),
                             torch.from_numpy(b))[r]
        _close(got, want)
    xb = np.asarray(jnp.asarray(x[0], jnp.bfloat16))
    want = jax.jit(jbase.layernorm)(xb, w[0], b[0])
    got = base.layernorm(params_from_jax(xb, "cpu"), torch.from_numpy(w[0]),
                         torch.from_numpy(b[0]))
    assert got.dtype == torch.bfloat16
    _close(got, want, "bfloat16")


def test_gelu_mlp_matches_jax():
    """``base.gelu_mlp``: ``jax.nn.gelu``'s tanh approximation and the two
    biases, its output and gradients in fp32, on two ranks' weights."""
    rng = np.random.default_rng(2)
    p = {"w_up": rng.normal(size=(2, 64, 128)).astype(np.float32) * 0.2,
         "b_up": rng.normal(size=(2, 128)).astype(np.float32),
         "w_down": rng.normal(size=(2, 128, 64)).astype(np.float32) * 0.1,
         "b_down": rng.normal(size=(2, 64)).astype(np.float32)}
    x = _layer_inputs()
    g = rng.normal(size=x.shape).astype(np.float32)
    f = jax.vmap(jbase.gelu_mlp)                  # one rank a weight
    jout, jg = f(p, x), jax.grad(lambda p: jnp.sum(f(p, x) * g))(p)
    tp = tree.map_leaves(lambda t: t.requires_grad_(),
                         params_from_jax(p, "cpu"))
    out = base.gelu_mlp(tp, torch.from_numpy(x))
    _close(out, jout)
    (out * torch.from_numpy(g)).sum().backward()
    for k in sorted(p):
        _close(tp[k].grad, jg[k])


def test_gqa_attention_kv_override_matches_jax():
    """``gqa_attention(kv_override=)``: precomputed K/V ``(B, T, KV,
    hd)``, no rope on the queries or the keys, the q/k norm on the
    queries alone, non-causal, ``T != S``; qwen3's SMOKE layer (q/k norms,
    GQA 2), its q norm drawn away from 0."""
    jcfg, cfg = _cfgs("qwen3-moe-235b-a22b")
    rng = np.random.default_rng(3)
    h, kv, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_model
    p = {"wq": rng.normal(size=(d, h * hd)).astype(np.float32) * 0.2,
         "wk": np.zeros((d, kv * hd), np.float32),
         "wv": np.zeros((d, kv * hd), np.float32),
         "wo": rng.normal(size=(h * hd, d)).astype(np.float32) * 0.1,
         "q_norm": rng.normal(size=(hd,)).astype(np.float32),
         "k_norm": rng.normal(size=(hd,)).astype(np.float32)}
    x = rng.normal(size=(2, 12, d)).astype(np.float32)
    kk, vv = (rng.normal(size=(2, 20, kv, hd)).astype(np.float32)
              for _ in range(2))
    want, (jk, jv) = jax.jit(lambda p, x, k, v: jbase.gqa_attention(
        jcfg, p, x, kv_override=(k, v)))(p, x, kk, vv)
    tp = params_from_jax(p, "cpu")
    got, (k2, v2) = base.gqa_attention(
        cfg, tp, torch.from_numpy(x),
        kv_override=(torch.from_numpy(kk), torch.from_numpy(vv)))
    _close(got, want)
    assert np.array_equal(k2.numpy(), np.asarray(jk))
    assert np.array_equal(v2.numpy(), np.asarray(jv))
    causal = jbase.attend(
        jbase.rmsnorm((jnp.asarray(x) @ p["wq"]).reshape(2, 12, h, hd),
                      p["q_norm"]), kk, vv, causal=True)
    moved = np.abs(np.asarray(causal.reshape(2, 12, -1) @ p["wo"])
                   - np.asarray(want)).max()
    assert moved > 1e-3 * np.abs(np.asarray(want)).max()


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax(arch):
    jm, jp, m, _ = _models(arch)
    toks = _tokens(m.cfg.vocab, 2, 24)
    labels = _tokens(m.cfg.vocab, 2, 24, seed=1)
    batch = _batch(m.cfg, toks, labels=labels)
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jm.loss(p, batch)))(jp)
    p = tree.map_leaves(lambda t: t.requires_grad_(),
                        params_from_jax(jp, "cpu"))
    loss = m.loss(p, params_from_jax(batch, "cpu"))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    loss.backward()
    for g, w in zip(tree.flatten(p)[0], jax.tree.leaves(jg)):
        _close(g.grad, w)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_loss_and_gradients_match_jax(arch):
    """The compute-dtype parameters the trainer's gather hands the model
    (``KEEP_F32`` leaves fp32) with the pipeline's fp32 ``enc_frames``:
    the loss within bf16's tolerance, the gradients within 5e-2 of each
    leaf's largest (bf16 through the layers and the loss, as
    ``tests/test_torch_models.py`` holds the VLM's)."""
    jm, jp, m, _ = _models(arch, "bfloat16")
    toks = _tokens(m.cfg.vocab, 2, 24)
    batch = _batch(m.cfg, toks, labels=_tokens(m.cfg.vocab, 2, 24, seed=1))
    jl, jg = jax.jit(jax.value_and_grad(lambda q: jm.loss(q, batch)))(jp)
    p = tree.map_leaves(lambda t: t.requires_grad_(),
                        params_from_jax(jp, "cpu"))
    loss = m.loss(p, params_from_jax(batch, "cpu"))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=2e-2)
    loss.backward()
    for path, g, w in zip(tree.paths(p), tree.flatten(p)[0],
                          jax.tree.leaves(jg)):
        assert g.grad.dtype == g.dtype
        err = float(np.abs(_np(g.grad) - _np(w)).max())
        assert err <= 5e-2 * float(np.abs(_np(w)).max()), (path, err)


# ---------------------------------------------------------------------------
# Serving: init_cache, prefill, decode.
# ---------------------------------------------------------------------------

def _port_cache(jc):
    c = {k: params_from_jax(jax.tree.map(np.asarray, v), "cpu")
         for k, v in jc.items() if k != "pos"}
    c["pos"] = int(jc["pos"])
    return c


def _assert_cache(got, want, dtype):
    assert set(got) == set(want) and got["pos"] == int(want["pos"])
    for name in set(want) - {"pos"}:
        assert set(got[name]) == set(want[name])
        for kv in want[name]:
            assert str(got[name][kv].dtype).split(".")[1] == \
                want[name][kv].dtype.name
            _close(got[name][kv], want[name][kv], dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_jax(arch):
    jm, _, m, _ = _models(arch)
    jc, c = jm.init_cache(3, 24), m.init_cache(3, 24)
    assert c["pos"] == int(jc["pos"]) == {WHISPER: 23, MAMBA: 0}[arch]
    assert set(c) == set(jc)
    for name in set(jc) - {"pos"}:
        assert set(c[name]) == set(jc[name])
        for kv in jc[name]:
            assert tuple(c[name][kv].shape) == jc[name][kv].shape
            assert str(c[name][kv].dtype).split(".")[1] == \
                jc[name][kv].dtype.name
            assert not c[name][kv].any()


def _grow(jc, n):
    """The prefill's cache grown by ``n`` positions: whisper's self K/V
    only (the cross K/V keep their encoder length); a mamba2 state has no
    sequence axis."""
    if "dec" not in jc:
        return jc
    pad = lambda a: jnp.concatenate(                           # noqa: E731
        [a, jnp.zeros(a.shape[:2] + (n,) + a.shape[3:], a.dtype)], 2)
    dec = {k: (pad(v) if k in ("k", "v") else v) for k, v in jc["dec"].items()}
    return dict(jc, dec=dec)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch, dtype):
    """A prefill of 16 (mamba2's chunked SSD), the cache grown by 4, then
    a step of one token and one of two (the recurrent SSD): the same
    logits and caches, the port's cache written in place."""
    jm, jp, m, p = _models(arch, dtype)
    toks = _tokens(m.cfg.vocab, 2, 19, seed=3)
    batch = _batch(m.cfg, toks[:, :16])
    jl, jc = jax.jit(jm.prefill)(jp, batch)
    with torch.inference_mode():
        l, c = m.prefill(p, params_from_jax(batch, "cpu"))
    assert l.dtype == getattr(torch, dtype) and l.shape == (2, 1, m.cfg.vocab)
    _close(l, jl, dtype)
    _assert_cache(c, jc, dtype)
    jc = _grow(jc, 4)
    c = _port_cache(jc)
    for t0, t1 in ((16, 17), (17, 19)):
        jl, jc = jax.jit(jm.decode)(jp, jnp.asarray(toks[:, t0:t1]), jc)
        with torch.inference_mode():
            l, c2 = m.decode(p, torch.from_numpy(toks[:, t0:t1]), c)
        assert all(a is b for a, b in zip(tree.flatten(c2)[0][:-1],
                                          tree.flatten(c)[0][:-1]))
        c = c2
        assert l.shape == (2, t1 - t0, m.cfg.vocab)
        _close(l, jl, dtype)
        _assert_cache(c, jc, dtype)


@pytest.mark.parametrize("start", [23, 63])
def test_whisper_decode_at_the_ends_clamps_as_jax(start):
    """Two tokens a row from ``init_cache``'s ``pos``: at 23 of a 24-entry
    cache the self K/V write clamps to 22 (``dynamic_update_slice``); at
    63, the end of SMOKE's 64 decoder positions, so does the position
    table's read (``dynamic_slice``)."""
    jm, jp, m, p = _models(WHISPER)
    jc = jm.init_cache(2, start + 1)
    c = m.init_cache(2, start + 1)
    toks = _tokens(m.cfg.vocab, 2, 2, seed=5)
    jl, jc = jax.jit(jm.decode)(jp, jnp.asarray(toks), jc)
    with torch.inference_mode():
        l, c = m.decode(p, torch.from_numpy(toks), c)
    _close(l, jl)
    _assert_cache(c, jc, "float32")
    assert c["pos"] == start + 2


def test_whisper_cross_cache_is_the_frames():
    """The prefill's cross K/V are the encoder output's: other frames
    move the last logits and every layer's cross K/V, and not the first
    layer's self K/V (which no frame reaches)."""
    _, _, m, p = _models(WHISPER)
    toks = torch.from_numpy(_tokens(m.cfg.vocab, 2, 8, seed=6))
    b1 = params_from_jax(_batch(m.cfg, toks.numpy()), "cpu")
    b2 = dict(b1, enc_frames=b1["enc_frames"].flip(1))
    with torch.inference_mode():
        l1, c1 = m.prefill(p, b1)
        l2, c2 = m.prefill(p, b2)
    assert not torch.allclose(l1, l2, atol=1e-4)
    assert torch.equal(c1["dec"]["k"][0], c2["dec"]["k"][0])
    assert not torch.allclose(c1["dec"]["xk"], c2["dec"]["xk"], atol=1e-4)


# ---------------------------------------------------------------------------
# mamba2's two SSD paths.
# ---------------------------------------------------------------------------

def test_mamba_chunked_equals_recurrent():
    """The port's chunked prefill of 16 against the same tokens fed one
    at a time through ``decode_step`` (the recurrent path): the last
    logits within 1e-3 of max|logit|, as
    ``tests/test_models.py::test_mamba_chunked_equals_recurrent`` holds
    the reference, and the states within 1e-5."""
    _, _, m, p = _models(MAMBA)
    toks = torch.from_numpy(_tokens(m.cfg.vocab, 2, 16, seed=7))
    with torch.inference_mode():
        lp, cp = m.prefill(p, {"tokens": toks})
        c = m.init_cache(2, 16)
        for t in range(16):
            ld, c = m.decode(p, toks[:, t:t + 1], c)
    rel = float((lp[:, -1] - ld[:, -1]).abs().max() / lp.abs().max())
    assert rel < 1e-3, rel
    assert cp["pos"] == c["pos"] == 16
    for k in cp["layers"]:
        _close(c["layers"][k], cp["layers"][k])


@pytest.mark.parametrize("s", [13, 24])
def test_ssd_paths_match_jax_from_a_state(s):
    """``ssd_chunked`` (chunk 8 at ``s = 24``) and the recurrent path (at
    ``s = 13``, through ``mamba_block``: the reference's ``lax.scan``
    step) from a nonzero initial state against the reference's: outputs
    and final states within 1e-5."""
    rng = np.random.default_rng(8)
    b, h, pd, n = 2, 4, 8, 16
    xdt = rng.normal(size=(b, s, h, pd)).astype(np.float32)
    a_bar = -rng.uniform(0.01, 0.5, (b, s, h)).astype(np.float32)
    bb, cc = (rng.normal(size=(b, s, n)).astype(np.float32) for _ in range(2))
    h0 = rng.normal(size=(b, h, pd, n)).astype(np.float32)
    args = [torch.from_numpy(a) for a in (xdt, a_bar, bb, cc)]
    if s % 8 == 0:
        want = jax.jit(jmamba2.ssd_chunked, static_argnums=4)(
            xdt, a_bar, bb, cc, 8, h0)
        got = mamba2.ssd_chunked(*args, 8, torch.from_numpy(h0))
    else:
        jcfg, cfg = _cfgs(MAMBA)
        jp = _models(MAMBA)[1]
        lp = jax.tree.map(lambda a: a[0], jp["layers"])
        x = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
        cache = {"conv_x": rng.normal(size=(b, 3, cfg.d_inner)),
                 "conv_b": rng.normal(size=(b, 3, cfg.ssm_state)),
                 "conv_c": rng.normal(size=(b, 3, cfg.ssm_state)),
                 "ssm": rng.normal(size=(b, cfg.ssm_heads, cfg.ssm_headdim,
                                         cfg.ssm_state))}
        cache = {k: v.astype(np.float32) for k, v in cache.items()}
        want = jax.jit(lambda p, x, c: jmamba2.mamba_block(
            jcfg, p, x, cache=c))(lp, x, cache)
        want = (want[0], want[1]["ssm"])
        got = mamba2.mamba_block(cfg, params_from_jax(lp, "cpu"),
                                 torch.from_numpy(x),
                                 cache=params_from_jax(cache, "cpu"))
        got = (got[0], got[1]["ssm"])
    for a, w in zip(got, want):
        _close(a, w)


# ---------------------------------------------------------------------------
# Sharding rules and train steps.
# ---------------------------------------------------------------------------

#: widened SMOKE configs whose large leaves are FSDP-sharded over
#: ``data`` (``rules.MIN_FSDP_SIZE`` is 64 Ki elements): whisper's
#: projections, MLPs and tied embedding (its biases, norms and position
#: tables replicated); mamba2's ``wz``, ``wx``, ``out_proj``, embedding and
#: head (its conv taps, ``wb``/``wc``/``wdt``, ``A_log``, ``D``,
#: ``dt_bias`` and norms replicated)
WIDE = {WHISPER: dict(d_model=256, d_ff=512, vocab=512),
        MAMBA: dict(d_model=256, vocab=512)}


@functools.cache
def _wide_params(arch, seed=0):
    jcfg, _ = _cfgs(arch, **WIDE[arch])
    return jax.tree.map(np.asarray, jget_model(jcfg).init(
        jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", [(("pod", "data", "model"), (2, 4, 1)),
                                  (("data", "model"), (8, 1))])
def test_param_specs_fsdp_dims_match_jax(arch, mesh):
    jp = _wide_params(arch)
    _, _, jdims = jrules.param_specs(jp, jrules.MeshCfg(*mesh))
    dims = rules.param_specs(jp, rules.MeshCfg(*mesh))
    assert tree.flatten(dims)[0] == jax.tree.leaves(jdims)
    sharded = {"/".join(p) for p, d in zip(tree.paths(dims),
                                           tree.flatten(dims)[0]) if d >= 0}
    want = {WHISPER: {"embed", "enc_layers/attn/wq", "dec_layers/xattn/wo",
                      "enc_layers/mlp/w_up", "dec_layers/mlp/w_down"},
            MAMBA: {"embed", "lm_head", "layers/wz", "layers/wx",
                    "layers/out_proj"}}[arch]
    assert want <= sharded
    assert not any(s.split("/")[-1] in (
        "b", "w", "bq", "bv", "bo", "b_up", "b_down", "dec_pos", "enc_pos",
        "conv_xw", "conv_bw", "conv_cw", "A_log", "D", "dt_bias", "ln",
        "gate_norm", "final_norm") for s in sharded)


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


@pytest.mark.parametrize("arch", ARCHS)
def test_two_train_steps_match_jax(arch):
    """Two train steps on ``(2, 4)``, in the network and reproducible, the
    widened configs so that the layers' projections are gathered inside
    the layer body and reduce-scattered in its backward (whisper's
    encoder and decoder stacks each split a layer a leaf; its frames
    split by rows): losses and gradient norms within 1e-5, the step-1
    gradients (Adam's first moments) within 1e-5 of each leaf's largest,
    the parameters within 1e-5 where the step-1 gradient is well
    conditioned and within 1e-4 where it is under 1e-8 (Adam's first
    step, lr / eps per unit of gradient), as the dense steps of
    ``tests/test_torch_models.py`` are held."""
    jcfg, cfg = _cfgs(arch, **WIDE[arch])
    mesh = (("pod", "data", "model"), (2, 4, 1))
    jmcfg, mcfg = jrules.MeshCfg(*mesh), rules.MeshCfg(*mesh)
    flare = dict(axes=AXES, transport="innetwork", reproducible=True)
    jp = _wide_params(arch)
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
    first = None
    for _ in range(2):
        batch = {k: np.asarray(v) for k, v in next(stream).items()}
        assert (arch == WHISPER) == ("enc_frames" in batch)
        jparams, jopt, jm = jstep(jparams, jopt, {
            k: v.reshape(2, 4, -1, *v.shape[1:]) for k, v in batch.items()})
        params, opt, m = step(params, opt, rules.split_batch(
            params_from_jax(batch, "cpu"), mcfg))
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[k]),
                                       float(np.asarray(jm[k])[0, 0]),
                                       rtol=1e-5)
        if first is None:
            first = [np.asarray(j) for j in jax.tree.leaves(jopt["m"])]
            for a, b in zip(tree.flatten(opt["m"])[0], first):
                _close(a, b)
    for a, b, mm in zip(tree.flatten(params)[0], jax.tree.leaves(jparams),
                        first):
        a, b = a.numpy(), np.asarray(b)
        well = np.abs(mm) >= 1e-8
        np.testing.assert_allclose(a[well], b[well], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(a[~well], b[~well], rtol=0, atol=1e-4)


def _with_reference_init(jp):
    """The port's launcher, its model initialized to the reference's
    parameters (the two packages draw different random weights)."""
    orig = registry.get_model

    def get(cfg):
        m = orig(cfg)
        return dataclasses.replace(
            m, init=lambda gen: params_from_jax(jp, str(gen.device)))
    return mock.patch.object(registry, "get_model", get)


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_train_steps_match_jax(arch, capsys):
    """``launch.train --arch ARCH --smoke --mesh 2x4x1 --transport
    innetwork --reproducible --seq 32`` (whisper's SMOKE table has 64
    decoder positions) from the reference's init against the reference
    launcher's per-rank ``step_body`` under nested ``vmap`` on its
    ``seed=1`` stream: losses within 1e-5, falling."""
    jcfg = jconfigs.load(arch).SMOKE.scaled(dtype=jnp.float32)
    jp = jax.tree.map(np.asarray, jget_model(jcfg).init(
        jax.random.PRNGKey(0)))
    with _with_reference_init(jp):
        losses = launch_train.main([
            "--arch", arch, "--smoke", "--device", "cpu", "--steps", "2",
            "--mesh", "2x4x1", "--transport", "innetwork", "--reproducible",
            "--seq", "32"])
    assert capsys.readouterr().out.count(" loss ") == 2
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


@pytest.mark.parametrize("arch", ARCHS)
def test_launchers_take_the_arch_on_cpu(arch, capsys):
    losses = launch_train.main(["--arch", arch, "--smoke", "--device", "cpu",
                                "--steps", "2", "--mesh", "8x1",
                                "--seq", "32"])
    assert len(losses) == 2 and np.isfinite(losses).all()
    reqs = launch_serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                              "--requests", "3", "--max-new", "4",
                              "--slots", "2", "--max-len", "24"])
    assert all(r.done and len(r.out) == 4 for r in reqs)
    out = capsys.readouterr().out
    assert out.count(" loss ") == 2 and "served 3 requests" in out


# ---------------------------------------------------------------------------
# The slot server.
# ---------------------------------------------------------------------------

def _serve(jm, jp, m, p, prompts, budgets):
    js = JServer(jm, jp, slots=2, max_len=24)
    srv = BatchedServer(m, p, slots=2, max_len=24)
    jr = [js.submit(x, max_new=n) for x, n in zip(prompts, budgets)]
    r = [srv.submit(x, max_new=n) for x, n in zip(prompts, budgets)]
    assert srv.run(max_steps=200) == js.run(max_steps=200)
    assert [x.out for x in r] == [x.out for x in jr]
    return [x.out for x in r], srv


@pytest.mark.parametrize("arch", ARCHS)
def test_batched_server_matches_jax_lockstep_deviation_included(arch):
    """The reference's slot server and the port's (fp32), one request and
    then two: every request's tokens and the step count equal.  Whisper
    decodes against ``init_cache``'s zero cross K/V (the server passes no
    frames), which stay zero.  The server steps every lane at one shared
    position, and mamba2's lanes all step their state in lockstep, so the
    second request changes the first one's tokens in both packages
    (ROADMAP queue 3 pins this deviation of the reference)."""
    jm, jp, m, p = _models(arch)
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, m.cfg.vocab, size=n) for n in (4, 3)]
    alone, _ = _serve(jm, jp, m, p, prompts[:1], [8])
    both, srv = _serve(jm, jp, m, p, prompts, [8, 6])
    assert both[0] != alone[0]
    if arch == WHISPER:
        assert not srv.cache["dec"]["xk"].any()
        assert not srv.cache["dec"]["xv"].any()
