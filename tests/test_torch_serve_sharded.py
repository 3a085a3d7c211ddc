"""Sharded serving: the port's ``make_serve_fns``, ``batch_spec`` and
``cache_specs`` against the JAX package's.

* The specs: for every serve cell on both production meshes and on
  ``("data", "model")`` = ``(2, 4)`` and ``(4, 2)``, the port's
  ``cache_specs`` and ``batch_spec`` (of ``meta`` shapes) name the same
  dims as the reference's (of ``jax.eval_shape`` shapes).
* The steps: the reference's own ``make_serve_fns`` on 8 fake CPU
  devices in a subprocess (as ``tests/test_torch_tp.py`` runs its
  ``jit_train_step``), at ``(2, 4)`` for every config (TinyLlama,
  granite, gemma2-2b, qwen3-moe and the VLM split their caches over the
  sequence there; whisper, zamba2's attention and mamba2's state over
  heads and features) and at ``(4, 2)`` for TinyLlama (KV heads over
  ``model``): the prefill's logits and cache, then three decode steps
  at a position where the last ``model`` rank holds no visible key,
  from the same parameters and tokens, fp32, each within 1e-5 of its
  largest element.  The port's partial attention and ``lse_combine``
  sum in another order than XLA's partitioned softmax.
* The plain partial attention over shards with ``lse_combine`` equals
  the plain whole attention within 1e-6 (fp32).
* At ``1x1x1`` ``make_serve_fns`` is the unsharded steps, bit for bit.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.data import pipeline as jpipeline
from repro.models import get_model as jget_model
from repro.sharding import rules as jrules
from repro_torch import configs, tree
from repro_torch import mesh as mesh_mod
from repro_torch.convert import params_from_jax
from repro_torch.core import tp
from repro_torch.data import pipeline
from repro_torch.kernels import ops, ref
from repro_torch.models import base
from repro_torch.models.registry import get_model
from repro_torch.serve.engine import make_serve_fns
from repro_torch.sharding import rules

torch.set_num_threads(1)

DM = ("data", "model")
MESHES = {"16x16": mesh_mod.mesh_cfg(),
          "2x16x16": mesh_mod.mesh_cfg(multi_pod=True),
          "2x4": rules.MeshCfg(DM, (2, 4)), "4x2": rules.MeshCfg(DM, (4, 2))}
SERVE_CELLS = [(a, c) for a, c in configs.all_cells() if c.kind != "train"]

#: the SMOKE steps: global batch, prompt, cache length, decode steps
B, S, L, STEPS = 4, 16, 32, 3
#: the configs held to the reference's steps: (arch, overrides, mesh)
STEP_CASES = {
    "tinyllama": ("tinyllama-1.1b", {}, (2, 4)),
    "tinyllama-heads": ("tinyllama-1.1b", {}, (4, 2)),
    "granite": ("granite-20b", {}, (2, 4)),
    "gemma2": ("gemma2-2b", {}, (2, 4)),
    "qwen3": ("qwen3-moe-235b-a22b", {}, (2, 4)),
    "deepseek": ("deepseek-v2-lite-16b", {}, (2, 4)),
    "deepseek-absorbed": ("deepseek-v2-lite-16b", {"mla_absorbed": True},
                          (2, 4)),
    "vlm": ("llama-3.2-vision-90b", {}, (2, 4)),
    "whisper": ("whisper-medium", {}, (2, 4)),
    "mamba2": ("mamba2-370m", {}, (2, 4)),
    "zamba2": ("zamba2-1.2b", {}, (2, 4)),
}


def _entries(dims) -> tuple:
    """Spec entries as tuples of axis names (``None`` → ``()``)."""
    return tuple(() if e is None else (e,) if isinstance(e, str)
                 else tuple(e) for e in dims)


@pytest.mark.parametrize("arch,cell", SERVE_CELLS,
                         ids=[f"{a}-{c.name}" for a, c in SERVE_CELLS])
def test_cache_and_batch_specs_equal_the_reference(arch, cell):
    jcfg = jconfigs.load(arch).CONFIG
    jm = jget_model(jcfg)
    jcache = jax.eval_shape(lambda: jm.init_cache(cell.global_batch,
                                                  cell.seq_len))
    jbatch = jpipeline.batch_structs(jcfg, cell)
    cfg = configs.load(arch).CONFIG
    cache = get_model(cfg).init_cache(cell.global_batch, cell.seq_len,
                                      device="meta")
    batch = pipeline.batch_structs(cfg, cell)
    assert [p for p, _ in jax.tree_util.tree_leaves_with_path(jcache)] \
        and len(tree.flatten(cache)[0]) == len(jax.tree.leaves(jcache))
    is_p = lambda x: isinstance(x, P)                     # noqa: E731
    for name, mc in MESHES.items():
        jmc = jrules.MeshCfg(mc.axes, mc.shape)
        for want, got in ((jrules.cache_specs(jcache, jmc),
                           rules.cache_specs(cache, mc)),
                          (jrules.batch_spec(jbatch, jmc),
                           rules.batch_spec(batch, mc))):
            w = [_entries(tuple(p)) for p in jax.tree.leaves(want,
                                                             is_leaf=is_p)]
            g = [_entries(s.dims) for s in tree.flatten(got)[0]]
            assert g == w, (name, g, w)


def test_placement_round_trips_and_split_batch_follows_batch_spec():
    """``shard_cache`` / ``unshard_cache`` and ``split_batch`` on meshes
    with and without pods and ``model``: a cache's global view comes
    back whole, each rank's block is the one its spec names, and a batch
    that divides by neither data axis goes whole to every rank."""
    g = torch.Generator().manual_seed(0)
    cache = {"layers": {"k": torch.randn(2, 8, 16, 2, 4, generator=g),
                        "v": torch.randn(2, 8, 16, 4, 4, generator=g)},
             "pos": 5}
    for axes, shape in ((("pod", "data", "model"), (2, 2, 2)),
                        (DM, (2, 4)), (DM, (4, 2)), (DM, (1, 1)),
                        (("pod", "data", "model"), (2, 4, 1))):
        mc = rules.MeshCfg(axes, shape)
        specs = rules.cache_specs(cache, mc)
        sc = rules.shard_cache(cache, mc, specs)
        un = rules.unshard_cache(sc, mc, specs)
        assert un["pos"] == 5
        for k in ("k", "v"):
            assert torch.equal(un["layers"][k], cache["layers"][k])
            assert sc["layers"][k].is_contiguous()
        rm = mc.rank_mesh().shape
        k = sc["layers"]["k"]
        if mc.tp > 1 and specs["layers"]["k"].dim_of("model") == 2:
            sl = 16 // mc.tp
            last = (rm[0] - 1, mc.tp - 1) if len(rm) == 2 else \
                (rm[0] - 1, rm[1] - 1, mc.tp - 1)
            b_r = 8 // mc.data_world
            assert torch.equal(k[last], cache["layers"]["k"][
                :, 8 - b_r:, 16 - sl:])
        for b in (8, 2, 1, 3):
            batch = {"tokens": torch.arange(b * 3).reshape(b, 3)}
            sp = rules.batch_spec(batch, mc)["tokens"]
            st = rules.split_batch(batch, mc)["tokens"]
            assert st.shape[:len(rm)] == rm
            assert torch.equal(rules._unplace(st, sp, mc), batch["tokens"])
            if b % mc.fsdp:
                assert all(torch.equal(r, batch["tokens"])
                           for r in st.reshape(-1, b, 3))


_PARTIAL = [  # Sq, q_offset, kv_len, causal, cap, window
    (1, 13, 14, True, 0.0, 0), (3, 20, 23, True, 30.0, 5),
    (2, 0, 19, False, 0.0, 0), (1, 3, 4, True, 0.0, 0),
    (4, 9, 13, True, 50.0, 6), (1, 31, 32, True, 0.0, 3)]


@pytest.mark.parametrize("case", _PARTIAL, ids=[str(c) for c in _PARTIAL])
def test_plain_partial_attention_combines_to_the_whole(case):
    """2 data ranks × 4 ``model`` ranks × 3 rows over a sequence of 32
    split in 4 blocks of 8: ``ops.attention_partial`` (the plain version
    on the CPU) then ``tp.lse_combine`` equals the whole attention
    (``ref.flash_attention_bshd``) within 1e-6, fp32, GQA 4/2: keyless
    blocks (past ``kv_len``, past the causal edge, before the window),
    the window and the cap across block boundaries, Sq > 1.  A keyless
    block's rows are ``o = 0``, ``lse = -inf``."""
    sq, off, kvl, causal, cap, win = case
    dn, tpn, b, h, kv, hd, s = 2, 4, 3, 4, 2, 16, 32
    g = torch.Generator().manual_seed(1)
    q = torch.randn(dn, b, sq, h, hd, generator=g)
    k = torch.randn(dn, b, s, kv, hd, generator=g)
    v = torch.randn(dn, b, s, kv, hd, generator=g)
    blocks = lambda t: t.reshape(dn, b, tpn, s // tpn, kv, hd).movedim(  # noqa
        2, 1)                                       # (dn, tp, b, s/tp, ..)
    kw = dict(causal=causal, attn_cap=cap, window=win, q_offset=off,
              kv_len=kvl, scale=hd ** -0.5)
    qr = q.unsqueeze(1).expand(dn, tpn, *q.shape[1:])
    o, lse = ops.attention_partial(qr.flatten(0, 1), blocks(k).flatten(0, 1),
                                   blocks(v).flatten(0, 1), shards=tpn, **kw)
    keyless = torch.isinf(lse)
    assert bool(keyless.any())
    assert not bool(o.movedim(-2, -3)[keyless].any())
    with tp.parallel(tpn):
        got = tp.lse_combine(o.reshape(dn, tpn, b, sq, h, hd),
                             lse.reshape(dn, tpn, b, h, sq).transpose(-1, -2),
                             1)
    assert all(torch.equal(got[:, m], got[:, 0]) for m in range(tpn))
    want, _ = ref.flash_attention_bshd(q.flatten(0, 1), k.flatten(0, 1),
                                       v.flatten(0, 1), **kw)
    assert float((got[:, 0].flatten(0, 1) - want).abs().max()) <= 1e-6


def test_sequence_split_write_lands_on_the_rank_that_holds_it():
    """``base.write_cache`` into a cache split over its sequence on 4
    ``model`` ranks: rows 6..9 of a sequence of 16 go to ranks 1 and 2,
    the start clamped to ``Smax - S`` as ``dynamic_update_slice``
    clamps it."""
    cache = torch.zeros(2, 4, 3, 4, 1)
    new = torch.arange(4.0).reshape(1, 1, 1, 4, 1).expand(2, 4, 3, 4, 1)
    base.write_cache(cache, new, 6, dim=3, md=1)
    full = torch.cat(cache.unbind(1), 2)
    assert torch.equal(full[0, 0, 6:10, 0], torch.arange(4.0))
    assert not bool(full[:, :, :6].any()) and not bool(full[:, :, 10:].any())
    base.write_cache(cache, new + 10, 15, dim=3, md=1)     # clamped to 12
    full = torch.cat(cache.unbind(1), 2)
    assert torch.equal(full[1, 2, 12:16, 0], torch.arange(10.0, 14.0))


_REFERENCE_SERVE = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
from repro import compat, configs
from repro.models import get_model
from repro.serve.engine import make_serve_fns
from repro.sharding import rules
cases = json.loads(sys.argv[2])
B, S, L, STEPS = (int(x) for x in sys.argv[3:7])
out = {}
for name, (arch, over, shape) in cases.items():
    cfg = configs.load(arch).SMOKE.scaled(dtype=jnp.float32, **over)
    m = get_model(cfg)
    mesh = compat.make_mesh(tuple(shape), ("data", "model"))
    mcfg = rules.MeshCfg(("data", "model"), tuple(shape))
    params = jax.tree.map(np.asarray, m.init(jax.random.PRNGKey(0)))
    if "cross_layers" in params:
        rng = np.random.default_rng(0)
        for k in ("gate_attn", "gate_mlp"):
            params["cross_layers"][k] = rng.uniform(
                0.3, 1.0, params["cross_layers"][k].shape).astype(np.float32)
    rng = np.random.default_rng(7)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["vision_embeds"] = (rng.standard_normal(
            (B, cfg.vision_tokens, cfg.d_model)) * 0.1).astype(np.float32)
    if cfg.family == "audio":
        batch["enc_frames"] = (rng.standard_normal(
            (B, cfg.encoder_tokens, cfg.d_model)) * 0.1).astype(np.float32)
    toks = rng.integers(0, cfg.vocab, (STEPS, B, 1)).astype(np.int32)
    with compat.set_mesh(mesh):
        prefill, decode, sh = make_serve_fns(m, mesh, mcfg, cache_batch=B,
                                             cache_len=L)
        p = jax.device_put(params, sh["params"])
        logits, cache = prefill(p, batch)
        out[name + "/prefill"] = np.asarray(logits)
        flat, struct = jax.tree_util.tree_flatten(cache)
        big = jax.tree_util.tree_leaves(jax.eval_shape(
            lambda: m.init_cache(B, L)))
        grown = []
        for j, (a, z) in enumerate(zip(flat, big)):
            a = np.asarray(a)
            out[f"{name}/cache/{j}"] = a
            if a.shape != z.shape:
                pad = [(0, 0)] * a.ndim
                pad[2] = (0, z.shape[2] - a.shape[2])
                a = np.pad(a, pad)
            grown.append(a)
        cache = jax.tree_util.tree_unflatten(struct, grown)
        cache["pos"] = jnp.int32(S)
        cache = jax.device_put(cache, sh["cache"])
        for i in range(STEPS):
            logits, cache = decode(p, toks[i], cache)
            out[f"{name}/decode{i}"] = np.asarray(logits)
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def reference_steps(tmp_path_factory):
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src"),
         env.get("PYTHONPATH", "")])
    path = tmp_path_factory.mktemp("serve") / "ref.npz"
    r = subprocess.run(
        [sys.executable, "-c", _REFERENCE_SERVE, str(path),
         json.dumps(STEP_CASES), str(B), str(S), str(L), str(STEPS)],
        capture_output=True, text=True, timeout=900, env=env)
    assert r.returncode == 0, r.stderr[-4000:]
    return dict(np.load(path))


def _close(got, want, tol=1e-5):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= tol * max(
        float(np.abs(want).max()), 1e-30)


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_sharded_steps_match_the_reference_make_serve_fns(name,
                                                         reference_steps):
    """The port's ``make_serve_fns`` against the reference's on 8 fake
    devices: the same SMOKE parameters (``params_from_jax``; the VLM's
    gates opened as the reference's run opens them), prompts and
    teacher-forced tokens.  The decode starts at position 16 of a cache
    of 32: over 4 ``model`` ranks (8 positions each) the last holds no
    visible key on every step."""
    arch, over, shape = STEP_CASES[name]
    want = reference_steps
    jcfg = jconfigs.load(arch).SMOKE.scaled(dtype=jnp.float32, **over)
    jp = jax.tree.map(np.asarray, jget_model(jcfg).init(
        jax.random.PRNGKey(0)))
    if "cross_layers" in jp:
        rng = np.random.default_rng(0)
        for k in ("gate_attn", "gate_mlp"):
            jp["cross_layers"][k] = rng.uniform(
                0.3, 1.0, jp["cross_layers"][k].shape).astype(np.float32)
    cfg = configs.load(arch).SMOKE.scaled(dtype=torch.float32, **over)
    model = get_model(cfg)
    rng = np.random.default_rng(7)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["vision_embeds"] = (rng.standard_normal(
            (B, cfg.vision_tokens, cfg.d_model)) * 0.1).astype(np.float32)
    if cfg.family == "audio":
        batch["enc_frames"] = (rng.standard_normal(
            (B, cfg.encoder_tokens, cfg.d_model)) * 0.1).astype(np.float32)
    toks = rng.integers(0, cfg.vocab, (STEPS, B, 1)).astype(np.int32)
    prefill, decode, layout = make_serve_fns(
        model, rules.MeshCfg(DM, shape), cache_batch=B, cache_len=L,
        device="cpu")
    params = layout.shard_params(params_from_jax(jp, "cpu"))
    logits, cache = prefill(params, {k: torch.from_numpy(v)
                                     for k, v in batch.items()})
    _close(logits, want[name + "/prefill"])
    got = tree.flatten(layout.unshard_cache(cache))[0]
    big = tree.flatten(model.init_cache(B, L))[0]
    grown = []
    for j, (a, z) in enumerate(zip(got, big)):
        if not isinstance(a, torch.Tensor):
            grown.append(a)
            continue
        _close(a, want[f"{name}/cache/{j}"])
        if a.shape != z.shape:
            z = z.to(a.dtype)
            z[:, :, :a.shape[2]] = a
            a = z
        grown.append(a)
    g = tree.unflatten(tree.flatten(cache)[1], grown)
    g["pos"] = S
    cache = layout.shard_cache(g)
    for i in range(STEPS):
        logits, cache = decode(params, torch.from_numpy(toks[i]), cache)
        _close(logits, want[f"{name}/decode{i}"])
    assert cache["pos"] == S + STEPS


@pytest.mark.parametrize("arch", sorted(configs.ALIASES))
def test_make_serve_fns_at_1x1x1_is_the_unsharded_steps_bitwise(arch):
    """At ``(pod, data, model)`` = ``(1, 1, 1)`` the layout's single rank
    runs the unsharded ``prefill`` and ``decode_step``: the same logits
    and cache, bit for bit (SMOKE, fp32, a prefill of 16 and two decode
    steps in a cache of 32)."""
    cfg = configs.load(arch).SMOKE.scaled(dtype=torch.float32)
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(3)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (2, S)).astype(np.int32))}
    for key, n, fam in (("enc_frames", cfg.encoder_tokens, "audio"),
                        ("vision_embeds", cfg.vision_tokens, "vlm")):
        if cfg.family == fam:
            batch[key] = torch.from_numpy(rng.standard_normal(
                (2, n, cfg.d_model)).astype(np.float32) * 0.1)
    mc = rules.MeshCfg(("pod", "data", "model"), (1, 1, 1))
    prefill, decode, layout = make_serve_fns(model, mc, cache_batch=2,
                                             cache_len=L, device="cpu")
    sp = layout.shard_params(params)
    got, gcache = prefill(sp, batch)
    with torch.no_grad():
        want, wcache = model.prefill(params, batch)
    assert torch.equal(got, want)
    for a, b in zip(tree.flatten(layout.unshard_cache(gcache))[0],
                    tree.flatten(wcache)[0]):
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                else a == b)
    full = model.init_cache(2, L)
    full = tree.unflatten(tree.flatten(full)[1], [
        w if not isinstance(z, torch.Tensor) or w.shape == z.shape
        else torch.cat([w, z[:, :, w.shape[2]:]], 2)
        for w, z in zip(tree.flatten(wcache)[0], tree.flatten(full)[0])])
    scache = layout.shard_cache(full)
    for i in range(2):
        tok = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 1)).astype(
            np.int32))
        got, scache = decode(sp, tok, scache)
        with torch.no_grad():
            want, full = model.decode(params, tok, full)
        assert torch.equal(got, want)
    for a, b in zip(tree.flatten(layout.unshard_cache(scache))[0],
                    tree.flatten(full)[0]):
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                else a == b)


@pytest.mark.parametrize("name,shape", [
    (n, sh) for n in sorted(STEP_CASES) if n != "tinyllama-heads"
    for sh in ((2, 4), (4, 2), (1, 1))])
def test_the_layout_alone_says_which_cache_lies_split_over_its_sequence(
        name, shape):
    """``rules.seq_split_entries`` of the port's specs, which
    ``make_serve_fns`` hands the layers (``base.serving``), names the
    cache entries whose K/V the reference's ``cache_specs`` split over
    their sequence on ``model`` (none at ``model`` = 1); the layers ask
    nothing else (SMOKE)."""
    arch, over, _ = STEP_CASES[name]
    jcfg = jconfigs.load(arch).SMOKE
    jcache = jax.eval_shape(lambda: jget_model(jcfg).init_cache(B, L))
    jmc = jrules.MeshCfg(DM, shape)
    want = set()
    for path, spec in jax.tree_util.tree_leaves_with_path(
            jrules.cache_specs(jcache, jmc),
            is_leaf=lambda x: isinstance(x, P)):
        keys = [getattr(k, "key", None) for k in path]
        if shape[1] > 1 and keys[-1] in rules._CACHE_SEQ_DIM \
                and len(spec) > 2 and spec[2] == "model":
            want.add(keys[0])
    cfg = configs.load(arch).SMOKE.scaled(**over)
    _, _, layout = make_serve_fns(get_model(cfg), rules.MeshCfg(DM, shape),
                                  cache_batch=B, cache_len=L, device="cpu")
    assert layout.seq_split == want
    with base.serving((), layout.seq_split):
        assert all(base.seq_split(e) == (e in want) for e in
                   ("layers", "local", "global", "dense", "moe", "self",
                    "cross", "dec", "attn"))
    assert not base.seq_split("layers")


def test_serving_moe_buffer_holds_a_ranks_own_slots(monkeypatch):
    """A sharded MoE decode keeps and drops choices by the global batch's
    capacity but dispatches into ``min(capacity, T·k)`` slots an expert,
    a rank's own choices (qwen3-moe SMOKE at ``(2, 4)``, global batch 4:
    2 tokens a rank); its logits equal those with the old buffer of the
    global capacity (test above: the reference's steps)."""
    cfg = configs.load("qwen3-moe-235b-a22b").SMOKE.scaled(
        dtype=torch.float32)
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    mc = rules.MeshCfg(DM, (2, 4))
    _, decode, layout = make_serve_fns(model, mc, cache_batch=B,
                                       cache_len=L, device="cpu")
    sizes = []
    real = base._dispatch
    monkeypatch.setattr(base, "_dispatch", lambda src, slot, n: (
        sizes.append(n), real(src, slot, n))[1])
    cache = model.init_cache(B, L)
    cache["pos"] = S
    logits, _ = decode(layout.shard_params(params),
                       torch.zeros((B, 1), dtype=torch.int32),
                       layout.shard_cache(cache))
    t, k, e = B // 2, cfg.experts_per_token, cfg.n_experts
    el = e // mc.tp if e % mc.tp == 0 else e
    cap = max(int(cfg.capacity_factor * B * k / e), min(B * k, 32))
    assert sizes and set(sizes) == {el * min(cap, t * k)}
    assert min(cap, t * k) < cap
    assert bool(torch.isfinite(logits).all())


def test_make_serve_fns_refuses_a_cache_left_whole_over_model():
    """A K/V cache whose heads and length both fail to divide by
    ``model`` would sit whole on every ``model`` rank: refused, as is a
    card that is not there."""
    model = get_model(configs.load("tinyllama-1.1b").SMOKE)
    with pytest.raises(NotImplementedError, match="whole over 4 model"):
        make_serve_fns(model, rules.MeshCfg(DM, (2, 4)), cache_batch=4,
                       cache_len=30, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_serve_fns(model, rules.MeshCfg(DM, (2, 4)), cache_batch=4,
                           cache_len=32)
