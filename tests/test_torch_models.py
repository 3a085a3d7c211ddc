"""The port's decoder-only variants against the JAX package's: gemma2's
local/global pairs (window, attention and final-logit softcaps, sandwich
norms, tied head), granite's MQA and qwen3's q/k norms and MoE block.

Each arch's SMOKE config runs through both packages on the same seeded
numpy inputs, the reference's parameters carried across with
``convert.params_from_jax``; the reference's functions are jitted (its
model has no Pallas call: ``base.attend`` is plain ``jnp``).  Sequences
are longer than gemma2's SMOKE window of 8, so its local layers hide
keys.  The train steps run the reference's ``step_body`` under nested
``jax.vmap`` over ``("pod", "data")``.

Tolerances: fp32 results within 1e-5 of their largest magnitude
(summation order; the largest error found is 2.0e-6 of it), bf16 within
2e-2 (``tests/test_torch_serve.py``'s: XLA and PyTorch round bf16
products and sums at other points; the MoE block's bf16 output is within
6.2e-3 of its largest magnitude, its gradients within 9.5e-3); integer
routing, ``lax.top_k``'s ties, the dispatch scatter and the dispatch's
custom backward bitwise.
"""
import dataclasses
import functools
import pathlib
import re
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
from repro.serve import BatchedServer as JServer
from repro.sharding import rules as jrules
from repro.train import trainer as jtrainer
from repro_torch import configs, tree
from repro_torch.convert import params_from_jax
from repro_torch.core.engine import FlareConfig
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import base, registry, transformer
from repro_torch.models.registry import get_model
from repro_torch.serve import BatchedServer
from repro_torch.sharding import rules
from repro_torch.train import trainer

torch.set_num_threads(1)

ARCHS = ["gemma2-2b", "gemma2-27b", "granite-20b", "qwen3-moe-235b-a22b",
         "deepseek-v2-lite-16b", "llama-3.2-vision-90b"]
DTYPES = ["float32", "bfloat16"]
#: relative tolerance of every compared tensor, by dtype (module doc)
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
AXES = ("pod", "data")
MOE = "qwen3-moe-235b-a22b"
MLA = "deepseek-v2-lite-16b"
VLM = "llama-3.2-vision-90b"


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


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().contiguous()
        return a.view({2: torch.int16, 4: torch.int32}[a.element_size()]
                      ).numpy()
    a = np.asarray(a)
    return a.view({2: np.int16, 4: np.int32}[a.dtype.itemsize])


def _cfgs(arch, dtype="float32", **kw):
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    return (jconfigs.load(arch).SMOKE.scaled(dtype=jd, **kw),
            configs.load(arch).SMOKE.scaled(dtype=td, **kw))


def _open_gates(jp, seed=0):
    """The VLM's cross-layer tanh gates drawn away from their init of 0
    (where the cross layers add nothing and get no weight gradient)."""
    if "cross_layers" not in jp:
        return jp
    rng = np.random.default_rng(seed)
    cross = dict(jp["cross_layers"])
    for k in ("gate_attn", "gate_mlp"):
        cross[k] = rng.uniform(0.3, 1.0, cross[k].shape).astype(
            cross[k].dtype)
    return dict(jp, cross_layers=cross)


@functools.cache
def _models(arch, dtype="float32", **kw):
    """(reference model, its params, port model, the same params); the
    parameters cast to ``dtype`` on both sides, as ``launch.serve``'s
    tests hold them (the VLM's gates opened, ``_open_gates``)."""
    jcfg, cfg = _cfgs(arch, dtype, **kw)
    jm, m = jget_model(jcfg), get_model(cfg)
    jp = jax.tree.map(lambda a: np.asarray(a.astype(jcfg.dtype)),
                      _open_gates(jm.init(jax.random.PRNGKey(0))))
    return jm, jp, m, params_from_jax(jp, "cpu")


def _tokens(vocab, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _batch(cfg, toks, **more):
    """``{"tokens": toks, **more}``, with the VLM's fp32 vision embeddings
    ``(B, vision_tokens, D)`` as the data pipeline makes them."""
    batch = {"tokens": toks, **more}
    if cfg.family == "vlm":
        batch["vision_embeds"] = np.random.default_rng(9).standard_normal(
            (toks.shape[0], cfg.vision_tokens, cfg.d_model)).astype(
                np.float32) * 0.1
    return batch


# ---------------------------------------------------------------------------
# Configs, parameters, loss and gradients.
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


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_has_the_references_leaves(arch):
    jm, jp, m, _ = _models(arch)
    p = m.init(torch.Generator().manual_seed(0))
    assert tree.paths(p) == [tuple(k.key for k in path) for path, _ in
                             jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert [tuple(t.shape) for t in tree.flatten(p)[0]] == \
        [a.shape for a in jax.tree.leaves(jp)]


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


def test_gemma2_window_hides_keys_and_chunked_attention_matches():
    """The local layers' window matters at this length (the loss moves
    when it is opened), and ``attn_chunk`` (the chunked online softmax,
    window inside) gives the reference's chunked loss."""
    jm, jp, m, p = _models("gemma2-2b")
    toks = _tokens(m.cfg.vocab, 2, 32, seed=2)
    batch = {"tokens": toks, "labels": toks}
    tb = params_from_jax(batch, "cpu")
    loss = float(m.loss(p, tb))
    wide = float(get_model(m.cfg.scaled(window=64)).loss(p, tb))
    assert abs(wide - loss) > 1e-4
    jcfg, cfg = _cfgs("gemma2-2b", attn_chunk=8)
    jl = jax.jit(lambda q: jget_model(jcfg).loss(q, batch))(jp)
    np.testing.assert_allclose(float(get_model(cfg).loss(p, tb)), float(jl),
                               rtol=1e-5)


def test_unported_variants_and_families_name_their_item():
    """What is left of ROADMAP queue 1 after items 14 and 16: nothing of
    either.  Every family is taken (zamba2's hybrid one too, its config
    under both ids), and tensor parallelism over ``model`` runs in the
    train step and the launcher; no port source names item 14 or 16."""
    cfg = configs.load("tinyllama-1.1b").SMOKE
    gen = torch.Generator().manual_seed(0)
    for arch in ("zamba2-1.2b", "zamba2_1_2b"):
        assert configs.load(arch).SMOKE.family == "hybrid"
    for family in ("vlm", "audio", "ssm", "hybrid"):
        assert get_model(cfg.scaled(family=family)).cfg.family == family
    assert "shared_block" in get_model(cfg.scaled(
        family="hybrid", hybrid_attn_every=2, ssm_state=16,
        ssm_headdim=16)).init(gen)
    assert transformer.init_params(cfg.scaled(family="hybrid"), gen)
    mcfg = rules.MeshCfg(("data", "model"), (4, 2))
    step = trainer.make_train_step(get_model(cfg), mcfg, trainer.TrainConfig(),
                                   get_model(cfg).init(gen))
    assert step.mesh.axes == ("data", "model")
    run = launch_train.setup(["--smoke", "--device", "cpu", "--mesh", "4x2"])
    assert run.step.mesh.shape == (4, 2)
    root = pathlib.Path(transformer.__file__).parents[1]
    named = [str(f) for f in sorted(root.rglob("*.py"))
             if re.search(r"item 1[46]\b", f.read_text())]
    assert named == []


# ---------------------------------------------------------------------------
# Serving: init_cache, prefill, decode.
# ---------------------------------------------------------------------------

def _port_cache(jc):
    c = {k: params_from_jax(jax.tree.map(np.asarray, v), "cpu")
         for k, v in jc.items() if k != "pos"}
    c["pos"] = int(jc["pos"])
    return c


def _assert_cache(got, want, dtype):
    """Every entry's tensors (``k``/``v``, MLA's ``c_kv``/``k_rope``, the
    VLM's ``self`` and ``cross``) in the reference's shapes and dtypes,
    within the dtype's tolerance."""
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
    assert c["pos"] == int(jc["pos"]) == 23
    assert set(c) == set(jc)
    for name in set(jc) - {"pos"}:
        assert set(c[name]) == set(jc[name])
        for kv in jc[name]:
            assert tuple(c[name][kv].shape) == jc[name][kv].shape
            assert str(c[name][kv].dtype).split(".")[1] == \
                jc[name][kv].dtype.name
            assert not c[name][kv].any()


def _grow(jc, n):
    """The prefill's cache grown by ``n`` positions (the cross entry's
    vision K/V keep their length)."""
    pad = lambda a: jnp.concatenate(                           # noqa: E731
        [a, jnp.zeros(a.shape[:2] + (n,) + a.shape[3:], a.dtype)], 2)
    return {k: (v if k in ("pos", "cross") else jax.tree.map(pad, v))
            for k, v in jc.items()}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch, dtype):
    """A prefill of 12 (past gemma2's window of 8) grown by 4, then two
    decode steps, the second of two tokens a row: the same logits and
    caches, the port's cache written in place."""
    jm, jp, m, p = _models(arch, dtype)
    toks = _tokens(m.cfg.vocab, 2, 15, seed=3)
    batch = _batch(m.cfg, toks[:, :12])
    jl, jc = jax.jit(jm.prefill)(jp, batch)
    with torch.inference_mode():
        l, c = m.prefill(p, params_from_jax(batch, "cpu"))
    assert l.dtype == getattr(torch, dtype) and l.shape == (2, 1, m.cfg.vocab)
    _close(l, jl, dtype)
    _assert_cache(c, jc, dtype)
    jc = _grow(jc, 4)
    c = _port_cache(jc)
    for t0, t1 in ((12, 13), (13, 15)):
        jl, jc = jax.jit(jm.decode)(jp, jnp.asarray(toks[:, t0:t1]), jc)
        with torch.inference_mode():
            l, c = m.decode(p, torch.from_numpy(toks[:, t0:t1]), c)
        assert l.shape == (2, t1 - t0, m.cfg.vocab)
        _close(l, jl, dtype)
        _assert_cache(c, jc, dtype)


def test_gemma2_decode_past_the_window_matches_jax():
    """Decode steps at positions 20-23 of a 24-entry cache: the local
    layers see only the last 8 keys, the global ones all of them."""
    jm, jp, m, p = _models("gemma2-2b")
    toks = _tokens(m.cfg.vocab, 2, 24, seed=4)
    _, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks[:, :20])})
    jc = _grow(jc, 4)
    c = _port_cache(jc)
    for t in range(20, 24):
        jl, jc = jax.jit(jm.decode)(jp, jnp.asarray(toks[:, t:t + 1]), jc)
        with torch.inference_mode():
            l, c = m.decode(p, torch.from_numpy(toks[:, t:t + 1]), c)
        _close(l, jl)
    _assert_cache(c, jc, "float32")


def _decode_steps(jm, jp, m, p, toks, n0=12):
    """A prefill of ``n0`` grown by 4, then a step of one token and one
    of two, through both packages: each step's logits (reference's,
    port's) and the final caches."""
    batch = _batch(m.cfg, toks[:, :n0])
    _, jc = jax.jit(jm.prefill)(jp, batch)
    jc = _grow(jc, 4)
    c = _port_cache(jc)
    out = []
    for t0, t1 in ((n0, n0 + 1), (n0 + 1, n0 + 3)):
        jl, jc = jax.jit(jm.decode)(jp, jnp.asarray(toks[:, t0:t1]), jc)
        with torch.inference_mode():
            l, c = m.decode(p, torch.from_numpy(toks[:, t0:t1]), c)
        out.append((jl, l))
    return out, jc, c


@pytest.mark.parametrize("dtype", DTYPES)
def test_mla_absorbed_decode_matches_jax(dtype):
    """``mla_absorbed``: the decode attends in the latent space with fp32
    products over the compressed cache, as the reference's absorbed
    decode does (the prefill, uncached, is the expanded one)."""
    jm, jp, m, p = _models(MLA, dtype, mla_absorbed=True)
    assert m.cfg.mla_absorbed
    toks = _tokens(m.cfg.vocab, 2, 15, seed=3)
    steps, jc, c = _decode_steps(jm, jp, m, p, toks)
    for jl, l in steps:
        _close(l, jl, dtype)
    _assert_cache(c, jc, dtype)


def test_mla_absorbed_decode_matches_the_expanded_one():
    """The two MLA decodes compute one function: on the same parameters
    and the same prefilled cache, the logits and the caches they write
    within fp32's tolerance."""
    _, _, m, p = _models(MLA)
    toks = torch.from_numpy(_tokens(m.cfg.vocab, 2, 16, seed=7))
    absorbed = get_model(m.cfg.scaled(mla_absorbed=True))
    out = []
    for model in (m, absorbed):
        with torch.inference_mode():
            _, c = model.prefill(p, {"tokens": toks[:, :12]})
            for name in ("dense", "moe"):
                c[name] = {k: torch.cat([v, v.new_zeros(
                    v.shape[:2] + (4,) + v.shape[3:])], 2)
                    for k, v in c[name].items()}
            logits = []
            for t0, t1 in ((12, 13), (13, 16)):
                lo, c = model.decode(p, toks[:, t0:t1], c)
                logits.append(lo)
        out.append((logits, c))
    for a, b in zip(out[0][0], out[1][0]):
        _close(b, a)
    assert out[0][1]["pos"] == out[1][1]["pos"] == 16
    for a, b in zip(tree.flatten(out[0][1])[0][:-1],
                    tree.flatten(out[1][1])[0][:-1]):
        _close(b, a)


def test_vlm_bf16_with_fp32_vision_embeds_matches_jax():
    """The VLM in bf16 (the compute-dtype parameters the trainer's gather
    and ``launch.serve`` hand it) with the pipeline's fp32
    ``vision_embeds``: the cross layers' K/V are fp32, their queries bf16
    (``attend`` upcasts them, scaled by the bf16-rounded scale), and the
    loss, its gradients and the prefill's fp32 cross cache match the
    reference's within bf16's tolerance.

    A gate's gradient is one sum over every (row, position, feature) of
    the gated output times the gradient arriving there, and it cancels
    (found: the terms' magnitudes sum to tens of times the result), so
    bf16's rounding of the terms, which the two packages place
    differently, moves it by more than 2e-2 of itself: each gate's is
    held within 2e-2 of the sum of its terms' magnitudes, taken from the
    port's backward.  The other gradients, bf16 through four layers and
    the loss (``TOL`` is the forward's), within 5e-2 of each leaf's
    largest (found: 2.7e-2, the self layers' ``wk``)."""
    jm, jp, m, _ = _models(VLM, "bfloat16")
    toks = _tokens(m.cfg.vocab, 2, 24)
    batch = _batch(m.cfg, toks, labels=_tokens(m.cfg.vocab, 2, 24, seed=1))
    assert batch["vision_embeds"].dtype == np.float32
    jl, jg = jax.jit(jax.value_and_grad(lambda q: jm.loss(q, batch)))(jp)
    p = tree.map_leaves(lambda t: t.requires_grad_(),
                        params_from_jax(jp, "cpu"))
    terms: dict = {}
    real = transformer._gated

    def gated(gate, y):
        key = (len(terms) // 2, ("gate_attn", "gate_mlp")[len(terms) % 2])
        terms[key] = None
        out = real(gate, y)
        th = 1 - torch.tanh(gate.detach().float()) ** 2

        def hook(g):
            terms[key] = float((g.float() * y.detach().float() * th)
                               .abs().sum())
        out.register_hook(hook)
        return out
    with mock.patch.object(transformer, "_gated", gated):
        loss = m.loss(p, params_from_jax(batch, "cpu"))
        np.testing.assert_allclose(float(loss.detach()), float(jl),
                                   rtol=2e-2)
        loss.backward()
    assert len(terms) == 4 and None not in terms.values()
    for path, g, w in zip(tree.paths(p), tree.flatten(p)[0],
                          jax.tree.leaves(jg)):
        assert g.grad.dtype == torch.bfloat16
        if path[-1].startswith("gate_"):
            for j in range(g.shape[0]):
                err = abs(float(g.grad[j, 0]) - float(np.float32(w[j, 0])))
                assert err <= 2e-2 * terms[(j, path[-1])]
            continue
        err = float(np.abs(_np(g.grad) - _np(w)).max())
        assert err <= 5e-2 * float(np.abs(_np(w)).max()), (path, err)
    with torch.inference_mode():
        _, c = m.prefill(p, params_from_jax(batch, "cpu"))
    assert c["cross"]["k"].dtype == torch.float32
    assert c["self"]["k"].dtype == torch.bfloat16


def test_attend_bf16_queries_over_fp32_kv_as_the_jitted_reference():
    """A bf16 query over fp32 K/V (the VLM's cross layers): the jitted
    reference multiplies ``fl32(q)`` by the scale rounded to bf16 and
    returns bf16; ``base.attend`` and ``ops.attention`` (which upcasts the
    query, as it does on the card before the fp32 kernel) agree within
    one bf16 ulp, non-causal with ``Sq != Sk`` and GQA 4."""
    from repro_torch.kernels import ops
    rng = np.random.default_rng(11)
    q = np.asarray(jnp.asarray(rng.normal(size=(2, 24, 8, 128)) * 4,
                               jnp.bfloat16))
    k, v = (rng.normal(size=(2, 40, 2, 128)).astype(np.float32)
            for _ in range(2))
    want = np.asarray(jax.jit(functools.partial(jbase.attend, causal=False))(
        q, k, v).astype(jnp.float32))
    assert jax.eval_shape(functools.partial(jbase.attend, causal=False),
                          q, k, v).dtype == jnp.bfloat16
    tq, tk, tv = (params_from_jax(x, "cpu") for x in (q, k, v))
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    for got in (base.attend(tq, tk, tv, causal=False),
                ops.attention(tq, tk, tv, causal=False,
                              scale=base._scale(tq, None))):
        assert got.dtype == torch.bfloat16
        assert np.all(np.abs(got.float().numpy() - want) <= ulp)


# ---------------------------------------------------------------------------
# The MoE block.
# ---------------------------------------------------------------------------

def _moe_inputs(dtype, combine, t=128, seed=1):
    """Layer 0's FFN of qwen3's SMOKE (the router kept fp32, as
    ``cast_params`` keeps it) and a ``(2, t, 64)`` input; at ``t = 128``
    and capacity factor 0.5 the 512 choices overflow the 8 experts' 32
    slots each, so at least half are dropped."""
    jcfg, cfg = _cfgs(MOE, dtype, capacity_factor=0.5, moe_combine=combine)
    jp = _models(MOE)[1]
    lp = {k: (v[0] if k == "router" else v[0].astype(jcfg.dtype))
          for k, v in jp["layers"]["ffn"].items()}
    x = np.random.default_rng(seed).normal(size=(2, t, 64)).astype(
        np.float32)
    x = np.asarray(jnp.asarray(x, jcfg.dtype))
    return jcfg, cfg, lp, x


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("combine", ["gather", "scatter_ar"])
def test_moe_block_matches_jax_with_drops(combine, dtype):
    jcfg, cfg, lp, x = _moe_inputs(dtype, combine)
    assert 2 * x.shape[1] * cfg.experts_per_token > cfg.n_experts * 32
    f = lambda p, x: jbase.moe_block(jcfg, p, x)               # noqa: E731
    want = jax.jit(f)(lp, x)
    g = np.random.default_rng(2).normal(size=want.shape).astype(np.float32)
    jg = jax.jit(jax.grad(lambda p, x: jnp.sum(
        f(p, x).astype(jnp.float32) * g), argnums=(0, 1)))(lp, x)
    p = tree.map_leaves(lambda t: t.requires_grad_(),
                        params_from_jax(lp, "cpu"))
    tx = params_from_jax(x, "cpu").requires_grad_()
    out = base.moe_block(cfg, p, tx)
    assert out.dtype == getattr(torch, dtype)
    _close(out, want, dtype)
    (out.float() * torch.from_numpy(g)).sum().backward()
    _close(tx.grad, jg[1], dtype)
    for k in sorted(p):
        _close(p[k].grad, jg[0][k], dtype)


def test_moe_combines_agree():
    """``scatter_ar`` against ``gather`` through the whole model, as
    ``tests/test_perf_knobs.py::test_moe_scatter_ar_matches_gather`` holds
    the reference's (loss within 1e-5, gradients within 2e-4), with
    drops (capacity factor 0.5)."""
    _, jp, _, p = _models(MOE)
    toks = _tokens(256, 4, 64, seed=5)
    batch = params_from_jax({"tokens": toks, "labels": toks}, "cpu")
    out = {}
    for combine in ("gather", "scatter_ar"):
        cfg = _cfgs(MOE, capacity_factor=0.5, moe_combine=combine)[1]
        q = tree.map_leaves(lambda t: t.clone().requires_grad_(), p)
        loss = get_model(cfg).loss(q, batch)
        loss.backward()
        out[combine] = (float(loss.detach()),
                        [t.grad for t in tree.flatten(q)[0]])
    assert abs(out["gather"][0] - out["scatter_ar"][0]) < 1e-5
    for a, b in zip(out["gather"][1], out["scatter_ar"][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-4)


def test_moe_tied_router_probabilities_route_as_jax():
    """Experts 2k and 2k+1 share router columns, so every token's
    probabilities tie in pairs: ``lax.top_k`` takes the lower index
    first, and so does the port (bitwise indices, fp32 output within
    1e-5)."""
    jcfg, cfg, lp, x = _moe_inputs("float32", "gather", t=48)
    r = lp["router"].copy()
    r[:, 1::2] = r[:, 0::2]
    lp = dict(lp, router=r)
    probs = jax.nn.softmax(jnp.asarray(x).reshape(-1, 64) @ r, axis=-1)
    jv, ji = jax.lax.top_k(probs, 2)
    tv, ti = base._top_k(torch.tensor(np.asarray(probs)), 2)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert np.array_equal(_bits(tv), _bits(jv))
    assert (np.asarray(jv)[:, 0] == np.asarray(jv)[:, 1]).all()
    want = jax.jit(lambda p, x: jbase.moe_block(jcfg, p, x))(lp, x)
    _close(base.moe_block(cfg, params_from_jax(lp, "cpu"),
                          params_from_jax(x, "cpu")), want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_moe_dispatch_scatter_is_the_references(dtype):
    """The dispatch adds every choice's row at its (expert, clipped slot),
    the dropped ones' zero rows included, bitwise the reference's
    ``.at[flat_e, flat_c].add(mode="drop", unique_indices=True)``: a kept
    ``-0.0`` lands as ``+0.0``."""
    rng = np.random.default_rng(6)
    e, cap, d, tk = 4, 3, 8, 16
    flat_e = rng.integers(0, e, tk)
    pos = np.zeros(tk, np.int64)
    seen = np.zeros(e, np.int64)
    for i, x in enumerate(flat_e):
        pos[i], seen[x] = seen[x], seen[x] + 1
    keep = pos < cap
    flat_c = np.clip(pos, 0, cap - 1)
    src = rng.normal(size=(tk, d)).astype(np.float32)
    src[0, :3] = -0.0
    src[~keep] = 0.0
    src = np.asarray(jnp.asarray(src, getattr(jnp, dtype)))
    want = jnp.zeros((e, cap, d), src.dtype).at[flat_e, flat_c].add(
        src, mode="drop", unique_indices=True)
    got = base._dispatch(params_from_jax(src, "cpu")[None],
                         torch.from_numpy(flat_e * cap + flat_c)[None],
                         e * cap)
    assert np.array_equal(_bits(got.reshape(e, cap, d)), _bits(want))


def test_ep_dispatch_backward_is_the_references_custom_vjp():
    """``_EPDispatch``'s backward, the f32 scatter through
    ``slot_to_row``, bitwise ``_ep_dispatch``'s custom VJP (bf16 rows)."""
    rng = np.random.default_rng(7)
    e, cap, d, t, k = 4, 5, 8, 9, 2
    tk = t * k
    flat_e = rng.integers(0, e, tk)
    pos = np.zeros(tk, np.int64)
    seen = np.zeros(e, np.int64)
    for i, x in enumerate(flat_e):
        pos[i], seen[x] = seen[x], seen[x] + 1
    keep = pos < cap
    flat_c = np.clip(pos, 0, cap - 1)
    kept_c = np.where(keep, flat_c, cap)
    s2r = np.full((e, cap), tk, np.int32)
    for i in range(tk):
        if keep[i]:
            s2r[flat_e[i], kept_c[i]] = min(s2r[flat_e[i], kept_c[i]], i)
    assert (~keep).any() and (s2r == tk).any()
    src = np.asarray(jnp.asarray(rng.normal(size=(tk, d)), jnp.bfloat16))
    g = np.asarray(jnp.asarray(rng.normal(size=(e, cap, d)), jnp.bfloat16))
    fwd, vjp = jax.vjp(lambda s: jbase._ep_dispatch(
        s, jnp.asarray(flat_e), jnp.asarray(flat_c), jnp.asarray(s2r), e,
        cap, tk), jnp.asarray(src))
    (want,) = vjp(jnp.asarray(g))
    ts = params_from_jax(src, "cpu")[None].requires_grad_()
    out = base._EPDispatch.apply(
        ts, torch.from_numpy(flat_e * cap + flat_c)[None],
        torch.from_numpy(s2r.astype(np.int64)).reshape(1, -1), e * cap)
    assert np.array_equal(_bits(out.reshape(e, cap, d)), _bits(fwd))
    out.backward(params_from_jax(g, "cpu").reshape(1, e * cap, d))
    assert np.array_equal(_bits(ts.grad[0]), _bits(want))


# ---------------------------------------------------------------------------
# Sharding rules and train steps.
# ---------------------------------------------------------------------------

#: widened SMOKE configs whose new leaves are FSDP-sharded over ``data``
#: (``rules.MIN_FSDP_SIZE`` is 64 Ki elements): gemma2's pair stacks and
#: tied embedding, qwen3's (E, D, F) experts (the router, 2 Ki elements,
#: replicated), deepseek's MLA leaves (``w_dkv``, ``w_kr``, ``w_ukv``),
#: dense first layer and shared experts, the VLM's cross layers' FFN (its
#: gates and norms replicated)
WIDE = {"gemma2-2b": dict(d_model=256, d_ff=512, vocab=512),
        "qwen3-moe-235b-a22b": dict(d_model=256, moe_d_ff=256, vocab=512,
                                    n_experts=8),
        MLA: dict(d_model=512, d_ff=128, moe_d_ff=128, vocab=512,
                  mla_kv_lora=128, mla_qk_nope=64, mla_qk_rope=128,
                  mla_v_dim=64),
        VLM: dict(d_model=256, d_ff=512, vocab=512)}


def _wide(arch, dtype="float32", **kw):
    return _cfgs(arch, dtype, **WIDE[arch], **kw)


@functools.cache
def _wide_params(arch, seed=0):
    jcfg, _ = _wide(arch)
    return jax.tree.map(np.asarray, _open_gates(jget_model(jcfg).init(
        jax.random.PRNGKey(seed))))


@pytest.mark.parametrize("arch", sorted(WIDE))
@pytest.mark.parametrize("mesh", [(("pod", "data", "model"), (2, 4, 1)),
                                  (("data", "model"), (8, 1))])
def test_param_specs_fsdp_dims_match_jax(arch, mesh):
    jp = _wide_params(arch)
    _, _, jdims = jrules.param_specs(jp, jrules.MeshCfg(*mesh))
    dims = rules.param_specs(jp, rules.MeshCfg(*mesh))
    assert tree.flatten(dims)[0] == jax.tree.leaves(jdims)
    sharded = {"/".join(p) for p, d in zip(tree.paths(dims),
                                           tree.flatten(dims)[0]) if d >= 0}
    want = {MOE: {"layers/ffn/w_gate", "layers/ffn/w_up",
                  "layers/ffn/w_down"},
            MLA: {"layers/attn/w_dkv", "layers/attn/w_kr",
                  "layers/attn/w_ukv", "dense_layers/attn/w_ukv",
                  "dense_layers/ffn/w_up", "layers/ffn/shared/w_up",
                  "layers/ffn/w_gate"},
            VLM: {"embed", "cross_layers/ffn/w_up", "layers/ffn/w_down"}
            }.get(arch, {"embed", "local_layers/ffn/w_up",
                         "global_layers/ffn/w_down"})
    assert want <= sharded
    assert not any(s.endswith(("norm", "ln1b", "ln2b", "router", "gate_attn",
                               "gate_mlp")) for s in sharded)


def test_cast_params_keeps_the_router_in_fp32():
    p = get_model(_cfgs(MOE)[1]).init(torch.Generator().manual_seed(0))
    cast = rules.cast_params(p, torch.bfloat16)
    assert cast["layers"]["ffn"]["router"].dtype == torch.float32
    assert cast["layers"]["ffn"]["w_up"].dtype == torch.bfloat16
    assert cast["layers"]["attn"]["q_norm"].dtype == torch.bfloat16


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


@pytest.mark.parametrize("arch,combine,seed", [
    ("gemma2-2b", "gather", 0), (MOE, "gather", 0), (MOE, "scatter_ar", 0),
    (MOE, "gather", 1), (MLA, "scatter_ar", 0), (VLM, "gather", 0)],
    ids=["gemma2-2b-gather", f"{MOE}-gather", f"{MOE}-scatter_ar",
         f"{MOE}-gather-seed1", f"{MLA}-scatter_ar", f"{VLM}-gather"])
def test_two_train_steps_match_jax(arch, combine, seed):
    """Two train steps on ``(2, 4)``, in the network and reproducible,
    the widened configs so that the pair stacks' and the experts' leaves
    are gathered inside the layer (pair) body and reduce-scattered in its
    backward: losses and gradient norms within 1e-5, the step-1
    gradients (from Adam's first moments) within 1e-5 of each leaf's
    largest, the parameters as ``tests/test_torch_train.py``'s
    Adam bounds say: within 1e-5 where the step-1 gradient is well
    conditioned, and within 1e-4 where it is under 10·eps (Adam's first
    step, lr / eps per unit of gradient).

    The MoE's router softmax carries the fp32 sums' order into the
    gradients' last bits, and Adam divides a gradient by its own
    magnitude, so where a step's gradient is tiny or its moments nearly
    cancel, the update may move by a share of lr.  There every element is
    held within lr / 2 = 5e-4, all but 0.01 % of them within the Adam
    bounds, and each one outside them must be accounted for by the
    readings: its step-2 gradient within 1e-4 of its leaf's largest
    (step 2 runs at parameters that differ already), and its difference
    within what Adam's updates make of the two packages' moments, lr ·
    Σ_t |Δ(m̂_t / (√v̂_t + eps))|, plus the ordinary 1e-5.  Found, seed 0,
    gather: 22 elements (8 of ``attn/wo`` off by 1.4e-4, step-1 gradients
    4.0e-9 against 1.7e-9; 14 of the experts' by up to 2.5e-5, step-2
    gradients near 1e-7 differing by 1e-8); scatter_ar: more of the
    same kinds (``attn/wo`` by 2.7e-4); seed 1: 2 of ``embed`` (step-1
    gradients 1.9e-8 against 2.5e-8)."""
    jcfg, cfg = _wide(arch, moe_combine=combine)
    mesh = (("pod", "data", "model"), (2, 4, 1))
    jmcfg, mcfg = jrules.MeshCfg(*mesh), rules.MeshCfg(*mesh)
    flare = dict(axes=AXES, transport="innetwork", reproducible=True)
    jp = _wide_params(arch, seed)
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
    stream = jpipeline.synthetic_batches(jcfg, 8, 32, seed=1 + seed,
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
    m1 = [b for _, b in moments[0][0]]
    for i, (a, b, mm) in enumerate(zip(tree.flatten(params)[0],
                                       jax.tree.leaves(jparams), m1)):
        a, b = a.numpy(), np.asarray(b)
        well = np.abs(mm) >= 1e-8
        if jcfg.is_moe:
            d = np.abs(a - b)
            assert float(d.max()) <= 5e-4
            off = d > np.where(well, 1e-5 + 1e-5 * np.abs(b), 1e-4)
            assert off.sum() <= 1e-4 * d.size, (off.sum(), d.size)
            # at each element off the bounds above: step 2's gradient
            # (from m_2 = 0.9·m_1 + 0.1·g_2, taken at parameters that
            # differ already) within 1e-4 of the leaf's largest, and the
            # parameter's difference what Adam's normalized updates make
            # of both steps' gradients (lr · Σ_t |Δu_t|, u_t = m̂_t /
            # (√v̂_t + eps))
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
            continue
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


def _ref_launcher(arch, jp, steps):
    """The reference launcher's ``--smoke --mesh 2x4x1 --transport
    innetwork --reproducible`` steps: its per-rank ``step_body`` under
    nested ``vmap`` on its ``seed=1`` stream (batch 8, seq 128)."""
    jcfg = jconfigs.load(arch).SMOKE.scaled(dtype=jnp.float32)
    jmcfg = jrules.MeshCfg(("pod", "data", "model"), (2, 4, 1))
    body, _, _, _, init = jtrainer.make_train_step(
        jget_model(jcfg), jmcfg, jtrainer.TrainConfig(
            lr=1e-3, gather_algorithm="fixed_tree",
            flare=jengine.FlareConfig(axes=AXES, transport="innetwork",
                                      reproducible=True)), jp)
    params = _per_rank_jax(jp, jmcfg)
    opt = jax.vmap(jax.vmap(init))(params)
    step = _nested(body)
    stream = jpipeline.synthetic_batches(jcfg, 8, 128, seed=1,
                                         prefetch=False)
    losses = []
    for _ in range(steps):
        batch = {k: np.asarray(v).reshape(2, 4, -1, *v.shape[1:])
                 for k, v in next(stream).items()}
        params, opt, m = step(params, opt, batch)
        losses.append(float(np.asarray(m["loss"])[0, 0]))
    return losses


@pytest.mark.parametrize("arch", ["gemma2-2b", MOE, MLA, VLM])
def test_launcher_train_steps_match_jax(arch, capsys):
    jp = jax.tree.map(np.asarray, jget_model(jconfigs.load(arch).SMOKE.scaled(
        dtype=jnp.float32)).init(jax.random.PRNGKey(0)))
    with _with_reference_init(jp):
        losses = launch_train.main([
            "--arch", arch, "--smoke", "--device", "cpu", "--steps", "2",
            "--mesh", "2x4x1", "--transport", "innetwork",
            "--reproducible"])
    assert capsys.readouterr().out.count(" loss ") == 2
    np.testing.assert_allclose(losses, _ref_launcher(arch, jp, 2), rtol=1e-5)
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


@pytest.mark.parametrize("arch", [MLA, VLM, MOE])
def test_layerwise_cast_draw_has_the_references_leaves(arch):
    """``init_params(cast=)``, ``launch.serve``'s draw: each layer cast
    as it is drawn, stacked into the same leaves and shapes as the fp32
    draw, in the compute dtype but the ``KEEP_F32`` router, and equal to
    the fp32 draw of the same seed cast (one draw order, with or without
    ``cast``), each layer its own."""
    cfg = configs.load(arch).SMOKE
    m = get_model(cfg)
    whole = m.init(torch.Generator().manual_seed(0))
    cast = functools.partial(rules.cast_params, dtype=cfg.dtype)
    got = m.init(torch.Generator().manual_seed(0), cast=cast)
    again = m.init(torch.Generator().manual_seed(0), cast=cast)
    assert tree.paths(got) == tree.paths(whole)
    for path, a, b, c in zip(tree.paths(got), tree.flatten(got)[0],
                             tree.flatten(whole)[0], tree.flatten(again)[0]):
        assert a.shape == b.shape and torch.equal(a, c)
        assert torch.equal(a, b.to(a.dtype))
        assert a.dtype == (torch.float32 if path[-1] == "router"
                           else torch.bfloat16)
    w = got["layers"]["ffn"]["w_up"]
    assert not torch.equal(w[0], w[1])


def test_serving_keeps_the_router_in_fp32():
    """``launch.serve`` holds the parameters in the compute dtype except
    the ``KEEP_F32`` leaves (``rules.cast_params``), as the trainer's
    gather casts them."""
    seen = []
    real = BatchedServer.__init__

    def spy(self, model, params, **kw):
        seen.append(params)
        real(self, model, params, **kw)
    with mock.patch.object(BatchedServer, "__init__", spy):
        launch_serve.main(["--arch", MOE, "--smoke", "--device", "cpu",
                           "--requests", "1", "--max-new", "2"])
    ffn = seen[0]["layers"]["ffn"]
    assert ffn["router"].dtype == torch.float32


# ---------------------------------------------------------------------------
# The slot server.
# ---------------------------------------------------------------------------

def test_batched_server_on_gemma2_matches_jax():
    """The reference's server and the port's on gemma2's SMOKE (fp32):
    prompts and generations run past the window of 8, the shared decode
    position included (``tests/test_torch_serve.py`` pins it); every
    request's tokens and the step count."""
    jm, jp, m, p = _models("gemma2-2b")
    rng = np.random.default_rng(8)
    lens, budgets = [3, 9, 5, 12, 2], [10, 6, 14, 4, 9]
    prompts = [rng.integers(0, m.cfg.vocab, size=n) for n in lens]
    js = JServer(jm, jp, slots=3, max_len=32)
    srv = BatchedServer(m, p, slots=3, max_len=32)
    jr = [js.submit(x, max_new=n) for x, n in zip(prompts, budgets)]
    r = [srv.submit(x, max_new=n) for x, n in zip(prompts, budgets)]
    assert srv.run(max_steps=500) == js.run(max_steps=500)
    assert [x.out for x in r] == [x.out for x in jr]
    assert set(srv.cache) == {"local", "global", "pos"}


@pytest.mark.parametrize("arch,entries", [
    (MLA, {"dense", "moe", "pos"}), (VLM, {"self", "cross", "pos"})])
def test_batched_server_on_mla_and_vlm_matches_jax(arch, entries):
    """The reference's server and the port's on deepseek's SMOKE (the MLA
    cache) and the VLM's (fp32): the VLM decodes against the zero cross
    cache of ``init_cache``, as the reference's server does (it passes
    no vision embeddings), and its cross entry stays zero; every
    request's tokens and the step count."""
    jm, jp, m, p = _models(arch)
    rng = np.random.default_rng(12)
    lens, budgets = [3, 6, 2, 5], [7, 4, 9, 5]
    prompts = [rng.integers(0, m.cfg.vocab, size=n) for n in lens]
    js = JServer(jm, jp, slots=3, max_len=24)
    srv = BatchedServer(m, p, slots=3, max_len=24)
    jr = [js.submit(x, max_new=n) for x, n in zip(prompts, budgets)]
    r = [srv.submit(x, max_new=n) for x, n in zip(prompts, budgets)]
    assert srv.run(max_steps=500) == js.run(max_steps=500)
    assert [x.out for x in r] == [x.out for x in jr]
    assert set(srv.cache) == entries
    if arch == VLM:
        assert not any(t.any() for t in srv.cache["cross"].values())


def test_flash_bytes_count_the_window():
    """``flash_attn.bytes_moved`` counts the keys some row can see: a
    decode query at 6143 with window 4096 reads keys 2048..6143 only; a
    prefill's first row sees key 0, so the window hides none."""
    from repro_torch.kernels import flash_attn as fa
    q = torch.zeros((2, 1, 8, 256), dtype=torch.bfloat16)
    k = torch.zeros((2, 8192, 4, 256), dtype=torch.bfloat16)
    per_key = 2 * 2 * 4 * 256 * 2                   # k and v, both rows
    rest = q.numel() * 2 + 2 * 8 * 256 * 2 + 4 * 2 * 8
    assert fa.bytes_moved(q, k, k, 6144, window=4096, q_offset=6143) == \
        rest + 4096 * per_key
    assert fa.bytes_moved(q, k, k, 6144) == rest + 6144 * per_key
    qp = torch.zeros((2, 8192, 8, 256), dtype=torch.bfloat16)
    assert fa.bytes_moved(qp, k, k, window=4096) == fa.bytes_moved(qp, k, k)


@pytest.mark.parametrize("cap", [0.0, 30.0])
def test_chunked_ce_recompute_is_the_whole_chunks_loss(cap):
    """``chunked_ce`` takes a chunk over all ranks at once where its
    logits fit and one rank at a time under ``checkpoint`` where they do
    not (``_ce_fits``): the loss per rank and the gradients of both
    paths are the same bits."""
    cfg = _cfgs("gemma2-2b")[1].scaled(logit_softcap=cap)
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.standard_normal((2, 4, 2, 24, 16)),
                     dtype=torch.float32)
    head = torch.tensor(rng.standard_normal((2, 4, 16, 64)),
                        dtype=torch.float32)
    labels = torch.tensor(rng.integers(0, 64, (2, 4, 2, 24)))
    out = []
    for fits in (True, False):
        xx, hh = (t.clone().requires_grad_() for t in (x, head))
        with mock.patch.object(transformer, "_ce_fits",
                               lambda *a, fits=fits: fits):
            loss = transformer.chunked_ce(cfg, xx, hh, labels, 8,
                                          rank_dims=2)
        loss.sum().backward()
        out.append((loss.detach(), xx.grad, hh.grad))
    assert out[0][0].shape == (2, 4)
    for a, b in zip(*out):
        assert np.array_equal(_bits(a), _bits(b))
