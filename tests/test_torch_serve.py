"""The port's serving path against the JAX package's: ``init_cache``,
``prefill``, ``decode_step`` (after a prefill grown by one, and at the
cache's end, where ``dynamic_update_slice`` clamps its start), masked
``attend`` and its flash plain version, the slot server and
``launch.serve``.

The model is TinyLlama's SMOKE config with the reference's parameters
carried across (``convert.params_from_jax``), in fp32 and in bf16 (the
parameters cast to bf16 on both sides, as ``launch.serve`` holds them).
The reference's steps are jitted, as its server runs them.

Tolerances: fp32 logits and caches within 1e-5 of their largest
magnitude (summation order; the largest error found is 7.5e-7 of it),
greedy tokens equal; bf16 logits and caches within 2e-2 of their
largest magnitude (XLA and PyTorch round bf16 products and sums at other
points, a few bf16 ulps; the largest error found is 1.49e-2 of it, in
the prefill and decode tests here).  The server's tokens are compared in
fp32.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import base as jbase
from repro.models import get_model as jget_model
from repro.serve import BatchedServer as JServer
from repro_torch import configs, tree
from repro_torch.convert import params_from_jax
from repro_torch.kernels import flash_attn as fa
from repro_torch.kernels import ref
from repro_torch.launch import serve as launch_serve
from repro_torch.models import base
from repro_torch.models.registry import get_model
from repro_torch.serve import BatchedServer, Request

torch.set_num_threads(1)

#: relative tolerance of logits and caches, by dtype
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _np(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a,
                      np.float32)


def _close(got, want, dtype):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= TOL[dtype] * float(np.abs(want).max()), err
    return err


@functools.cache
def _models(dtype):
    """(reference model, its params, port model, the same params)."""
    jcfg = jconfigs.load("tinyllama-1.1b").SMOKE
    cfg = configs.load("tinyllama-1.1b").SMOKE
    if dtype == "float32":
        jcfg, cfg = jcfg.scaled(dtype=jnp.float32), cfg.scaled(
            dtype=torch.float32)
    jm, m = jget_model(jcfg), get_model(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    jp = jax.tree.map(lambda a: a.astype(jcfg.dtype), jp)
    p = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, m, p


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)


def _port_cache(jc):
    """A reference cache carried into the port (``pos`` a host int)."""
    return {"layers": params_from_jax(jax.tree.map(np.asarray, jc["layers"]),
                                      "cpu"),
            "pos": int(jc["pos"])}


def _assert_cache(got, want, dtype):
    assert got["pos"] == int(want["pos"])
    for name in ("k", "v"):
        _close(got["layers"][name], want["layers"][name], dtype)


DTYPES = ["float32", "bfloat16"]


@pytest.mark.parametrize("dtype", DTYPES)
def test_init_cache_matches_jax(dtype):
    jm, _, m, _ = _models(dtype)
    jc = jm.init_cache(3, 24)
    c = m.init_cache(3, 24)
    assert c["pos"] == int(jc["pos"]) == 23 and isinstance(c["pos"], int)
    for name in ("k", "v"):
        assert tuple(c["layers"][name].shape) == jc["layers"][name].shape
        assert str(c["layers"][name].dtype).split(".")[1] == \
            jc["layers"][name].dtype.name
        assert not c["layers"][name].any()
    assert set(c) == set(jc) and set(c["layers"]) == set(jc["layers"])


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_matches_jax(dtype):
    jm, jp, m, p = _models(dtype)
    toks = _tokens(m.cfg, 2, 9)
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        l, c = m.prefill(p, {"tokens": torch.from_numpy(toks)})
    assert l.dtype == getattr(torch, dtype) and l.shape == (2, 1, m.cfg.vocab)
    _close(l, jl, dtype)
    _assert_cache(c, jc, dtype)


def _grow(jc, n):
    pad = lambda a: jnp.concatenate(
        [a, jnp.zeros(a.shape[:2] + (n,) + a.shape[3:], a.dtype)], 2)
    return {"layers": jax.tree.map(pad, jc["layers"]), "pos": jc["pos"]}


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_step_after_prefill_matches_jax(dtype):
    """A prefill of 8 grown by 4, then two decode steps, the second of
    two tokens a row: the same logits and caches, the port's cache
    written in place."""
    jm, jp, m, p = _models(dtype)
    toks = _tokens(m.cfg, 2, 11, seed=1)
    _, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks[:, :8])})
    jc = _grow(jc, 4)
    c = _port_cache(jc)
    k_before = c["layers"]["k"]
    for t0, t1 in ((8, 9), (9, 11)):
        jl, jc = jax.jit(jm.decode)(jp, jnp.asarray(toks[:, t0:t1]), jc)
        with torch.inference_mode():
            l, c = m.decode(p, torch.from_numpy(toks[:, t0:t1]), c)
        assert l.shape == (2, t1 - t0, m.cfg.vocab)
        _close(l, jl, dtype)
        _assert_cache(c, jc, dtype)
    assert c["layers"]["k"] is k_before          # consumed, in place


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("pos,s", [(15, 1), (15, 2), (19, 1), (14, 3)])
def test_decode_step_clamps_like_dynamic_update_slice(dtype, pos, s):
    """At ``pos = Smax - 1`` (``init_cache``'s) and past ``Smax - s``,
    the reference's write moves to ``Smax - s`` while the queries keep
    their positions ``pos + arange(s)`` and see ``pos + s`` entries; the
    port clamps the same way."""
    jm, jp, m, p = _models(dtype)
    rng = np.random.default_rng(pos * 10 + s)
    jc = jm.init_cache(2, 16)
    jc = {"layers": jax.tree.map(
        lambda a: jnp.asarray(rng.normal(size=a.shape), a.dtype),
        jc["layers"]), "pos": jnp.int32(pos)}
    c = _port_cache(jc)
    toks = _tokens(m.cfg, 2, s, seed=pos)
    jl, jc2 = jax.jit(jm.decode)(jp, jnp.asarray(toks), jc)
    with torch.inference_mode():
        l, c2 = m.decode(p, torch.from_numpy(toks), c)
    _close(l, jl, dtype)
    _assert_cache(c2, jc2, dtype)
    assert c2["pos"] == pos + s


def test_decode_refuses_a_tensor_position():
    _, _, m, p = _models("float32")
    c = m.init_cache(1, 8)
    c["pos"] = torch.tensor(3)
    with pytest.raises(TypeError, match="host int"):
        m.decode(p, torch.zeros((1, 1), dtype=torch.int64), c)
    c["pos"] = np.int32(3)                      # a numpy int is a host int
    _, c = m.decode(p, torch.zeros((1, 1), dtype=torch.int64), c)
    assert c["pos"] == 4


def test_prefill_vs_decode_consistency():
    """decode(prefill(t[:-1]), t[-1]) ≡ prefill(t)'s last logits, the
    reference's own check and bound (``tests/test_models.py``)."""
    _, _, m, p = _models("float32")
    b, s = 2, 16
    toks = torch.from_numpy(_tokens(m.cfg, b, s, seed=2))
    with torch.inference_mode():
        _, cache = m.prefill(p, {"tokens": toks[:, :-1]})
        cache["layers"] = {k: torch.cat([v, torch.zeros_like(v[:, :, :1])], 2)
                           for k, v in cache["layers"].items()}
        logits_d, _ = m.decode(p, toks[:, -1:], cache)
        logits_p, _ = m.prefill(p, {"tokens": toks})
    rel = float((logits_p - logits_d).abs().max() / logits_p.abs().max())
    assert rel < 2e-3


@pytest.mark.parametrize("dtype", DTYPES)
def test_masked_attend_matches_jax(dtype):
    """``attend`` with ``q_pos`` (a tensor, or the first position as an
    int) and ``kv_len``, and the flash plain version with ``q_offset`` /
    ``kv_len``, against the reference's jitted ``attend``: GQA 4/2, Sq 1
    and 5, caches ragged against the 64-key tile; bf16 within one bf16
    ulp (the dense branch, as the jitted reference scales queries) and
    two for the plain version's tiled online softmax, fp32 within 3e-6."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    rng = np.random.default_rng(5)
    for sq, sk, pos in ((1, 70, 40), (5, 100, 60), (1, 130, 129),
                        (5, 64, 59)):
        q = (rng.normal(size=(2, sq, 4, 32)) * 3).astype(np.float32)
        k, v = (rng.normal(size=(2, sk, 2, 32)).astype(np.float32)
                for _ in range(2))
        want = np.asarray(jax.jit(functools.partial(
            jbase.attend, causal=True))(
                *(jnp.asarray(x, jdt) for x in (q, k, v)),
                q_pos=pos + jnp.arange(sq), kv_len=jnp.int32(pos + sq)),
            np.float32)
        tq, tk, tv = (torch.from_numpy(x).to(tdt) for x in (q, k, v))
        ulp = (np.ldexp(1.0, np.frexp(np.abs(want))[1] - 8)
               if dtype == "bfloat16" else 3e-6)
        for q_pos in (pos + torch.arange(sq), pos):
            got = base.attend(tq, tk, tv, causal=True, q_pos=q_pos,
                              kv_len=pos + sq)
            assert np.all(np.abs(_np(got) - want) <= ulp)
        scale = torch.tensor(32 ** -0.5, dtype=tdt).item()
        plain, _ = ref.flash_attention_bshd(tq, tk, tv, causal=True,
                                            scale=scale, kv_tile=64,
                                            q_offset=pos, kv_len=pos + sq)
        assert np.all(np.abs(_np(plain) - want) <= 2 * ulp)


def test_flash_plain_masks_match_its_mask_free_slice():
    """``kv_len`` and ``q_offset`` in the plain version equal attention
    over the visible slice of keys at the shifted positions."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn((2, 6, 4, 16), generator=g)
    k, v = (torch.randn((2, 90, 2, 16), generator=g) for _ in range(2))
    o, _ = ref.flash_attention_bshd(q, k, v, causal=True, q_offset=50,
                                    kv_len=56, kv_tile=32)
    sl, _ = ref.flash_attention_bshd(torch.cat([torch.zeros((2, 50, 4, 16)),
                                                q], 1),
                                     k[:, :56], v[:, :56], causal=True)
    assert torch.allclose(o, sl[:, 50:], atol=1e-6)


def test_flash_rows_see_a_key_and_flops_count_the_mask():
    see = functools.partial(fa.rows_see_a_key, 4, 64, causal=True)
    assert see(window=0, q_offset=0, kv_len=2)
    assert not see(window=2, q_offset=0, kv_len=2)
    assert not see(window=16, q_offset=40, kv_len=8)
    assert fa.rows_see_a_key(3, 8, causal=False, window=0, q_offset=9,
                             kv_len=1)
    # one row at position 1087 over 1088 of 2048 keys: 1088 pairs
    assert fa.flops(16, 32, 1, 2048, 64, causal=True, q_offset=1087,
                    kv_len=1088) == 2 * 128 * 1088 * 16 * 32
    q = torch.empty((16, 1, 32, 64), dtype=torch.bfloat16, device="meta")
    k = torch.empty((16, 2048, 4, 64), dtype=torch.bfloat16, device="meta")
    assert fa.bytes_moved(q, k, k, kv_len=1088) == (
        16 * 32 * 64 * 2 * 2 + 2 * 16 * 1088 * 4 * 64 * 2 + 4 * 16 * 32)


def _serve_both(prompts, *, slots, max_len, max_new, eos=-1):
    jm, jp, m, p = _models("float32")
    js = JServer(jm, jp, slots=slots, max_len=max_len, eos=eos)
    srv = BatchedServer(m, p, slots=slots, max_len=max_len, eos=eos)
    jr = [js.submit(x, max_new=n) for x, n in zip(prompts, max_new)]
    r = [srv.submit(x, max_new=n) for x, n in zip(prompts, max_new)]
    jsteps, steps = js.run(max_steps=500), srv.run(max_steps=500)
    return jr, r, jsteps, steps


def test_batched_server_matches_jax():
    """The request stream of ``tests/test_hlo_and_infra.py``'s server
    test: every request's tokens and the step count."""
    rng = np.random.default_rng(0)
    cfg = _models("float32")[2].cfg
    prompts = [rng.integers(0, cfg.vocab, size=3) for _ in range(6)]
    jr, r, jsteps, steps = _serve_both(prompts, slots=4, max_len=32,
                                       max_new=[5] * 6)
    assert steps == jsteps
    assert [x.out for x in r] == [x.out for x in jr]
    assert all(x.done and len(x.out) == 5 for x in r)
    assert isinstance(r[0], Request)


def test_batched_server_mixed_prompts_pin_the_shared_position():
    """Mixed prompt lengths, budgets, the ``max_len`` retirement and an
    end token: lanes at different positions share one decode position
    (the first active slot's), and the port gives the reference's tokens
    and step count all the same."""
    rng = np.random.default_rng(3)
    cfg = _models("float32")[2].cfg
    lens = [1, 6, 2, 7, 3, 5, 4, 1]
    prompts = [rng.integers(0, cfg.vocab, size=n) for n in lens]
    budgets = [4, 9, 2, 12, 6, 3, 8, 5]
    jr, r, jsteps, steps = _serve_both(prompts, slots=3, max_len=14,
                                       max_new=budgets)
    assert steps == jsteps and [x.out for x in r] == [x.out for x in jr]
    # some request stopped at max_len - 1 before its budget
    assert any(len(x.out) < n for x, n in zip(r, budgets))
    eos = r[1].out[1]
    jr, r, jsteps, steps = _serve_both(prompts, slots=3, max_len=14,
                                       max_new=budgets, eos=eos)
    assert steps == jsteps and [x.out for x in r] == [x.out for x in jr]
    assert r[1].out[-1] == eos and len(r[1].out) == 2


def test_batched_server_keeps_positions_on_the_host():
    _, _, m, p = _models("float32")
    srv = BatchedServer(m, p, slots=2, max_len=16)
    srv.submit(np.array([3, 4, 5]), max_new=2)
    srv.step()
    assert isinstance(srv.cache["pos"], int) and srv.pos.tolist() == [4, 0]
    assert srv.cache["layers"]["k"].device.type == "cpu"
    assert not srv.cache["layers"]["k"].requires_grad


def test_launch_serve_runs_on_cpu(capsys):
    reqs = launch_serve.main(["--smoke", "--device", "cpu", "--requests",
                              "5", "--max-new", "4", "--slots", "2",
                              "--max-len", "24", "--seed", "1"])
    out = capsys.readouterr().out.splitlines()
    assert len(reqs) == 5 and all(r.done and len(r.out) == 4 for r in reqs)
    head = out[0].split()
    assert head[:2] == ["served", "5"] and head[3:5] == ["20", "tokens,"]
    assert out[0].endswith(" tok/s")
    assert len(out) == 5 and out[1].startswith("  req 0: prompt=[")
    assert out[1].endswith("...")
    again = launch_serve.main(["--smoke", "--device", "cpu", "--requests",
                               "5", "--max-new", "4", "--slots", "2",
                               "--max-len", "24", "--seed", "1"])
    assert [r.out for r in again] == [r.out for r in reqs]


def test_launch_serve_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_serve.main(["--smoke"])


def test_serving_holds_parameters_in_the_compute_dtype():
    """``launch.serve`` casts the parameters to the model's compute dtype
    (bf16 at full width): the reference's fp32 parameters under a bf16
    model fail its scan carry, and the port's matmuls refuse the mix."""
    m = get_model(configs.load("tinyllama-1.1b").SMOKE)
    p = m.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError):
        m.prefill(p, {"tokens": torch.zeros((1, 4), dtype=torch.int64)})
    p = tree.map_leaves(lambda t: t.to(m.cfg.dtype), p)
    logits, cache = m.prefill(p, {"tokens": torch.zeros((1, 4),
                                                        dtype=torch.int64)})
    assert logits.dtype == cache["layers"]["k"].dtype == torch.bfloat16
