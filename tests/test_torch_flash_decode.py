"""The flash decode kernel's plain version, plan and routing on the CPU.

* ``ref.flash_attention_split`` (the decode kernel's launch: the visible
  keys cut into ``flash_attn.decode_plan``'s splits, each split's
  ``flash_attention_bshd`` joined by log-sum-exp in split order) against
  the JAX package's jitted ``attend`` on numpy inputs from a seed
  (``q_pos = pos + arange(Sq)``, ``kv_len``): fp32 within 3e-6, bf16
  within one bf16 ulp of the reference (hd 64: the scale 1/8 is exact in
  bf16, so the reference's bf16 ``q·scale`` rounds nothing);
* against ``ref.flash_attention_bshd`` within 1e-6 in fp32 (the same
  arithmetic, summed in another order), at the plan's splits and at one
  key a split; with ``shards=`` against ``flash_attention_partial`` and,
  joined over the shards by ``core.tp.lse_combine``, against the whole;
  keyless rows ``o = 0``, ``lse = -inf`` exactly;
* the plan on the decode shapes of ``chip_smoke.py``'s
  ``FLASH_MODEL_CASES`` and of its sharded serving: whole tiles of the
  visible range only, at least ``2·SMS`` blocks wherever the launch has
  that many tiles, the ring within the shared memory;
* the routing predicate: every ``Sq = 1`` case and every partial launch
  decodes, no training or prefill case does.
"""
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import base as jbase
from repro_torch.core import tp
from repro_torch.kernels import flash_attn as fa
from repro_torch.kernels import ref

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

#: G (query heads a KV head, 2 KV heads), Sq, Sk, pos (the first query's
#: position), kv_len, cap, window: a ragged ``kv_len``, Sq 4, the cap, the
#: window inside the cache and past it, a full cache
CASES = ((1, 1, 300, 250, 251, 0.0, 0), (2, 4, 300, 190, 194, 50.0, 0),
         (8, 1, 300, 280, 281, 0.0, 64), (16, 4, 300, 60, 64, 0.0, 1000),
         (8, 4, 120, 116, 120, 50.0, 32))
IDS = [f"G{c[0]}-Sq{c[1]}-cap{c[5]:g}-win{c[6]}" for c in CASES]


def _inputs(case, hd=64, b=2, seed=0):
    g, sq, sk = case[:3]
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, s, h, hd)).astype(np.float32)
               for s, h in ((sq, 2 * g), (sk, 2), (sk, 2)))
    return q, k, v


def _plan(q, k, v, *, shards=None, **kw):
    """``decode_plan`` for tensors shaped as the kernel takes them."""
    n, b = (q.shape[0], q.shape[1]) if q.dim() == 5 else (1, q.shape[0])
    sq, h, hd = q.shape[-3:]
    sk, kv = k.shape[-3], k.shape[-2]
    kvl = kw.get("kv_len") or sk * (shards or 1)
    return fa.decode_plan(n, b, h, kv, sq, sk, hd, v.shape[-1], q.dtype,
                          causal=kw["causal"], window=kw["window"],
                          q_offset=kw["q_offset"], kv_len=kvl, shards=shards)


def _fine(plan):
    """One key a tile and a split, over the plan's widest range: every
    split a key, so that rows see none of most splits."""
    keys = plan.tiles * plan.tile
    return fa.DecodePlan(1, keys, keys)


@functools.cache
def _jax_attend(causal, window, cap, scale):
    return jax.jit(functools.partial(jbase.attend, causal=causal,
                                     window=window, attn_cap=cap,
                                     scale=scale))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_split_matches_jax_attend(dtype, case):
    g, sq, sk, pos, kvl, cap, win = case
    q, k, v = _inputs(case)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(_jax_attend(True, win, cap, 0.125)(
        *(jnp.asarray(x, jdt) for x in (q, k, v)),
        q_pos=pos + jnp.arange(sq), kv_len=jnp.int32(kvl)), np.float32)
    tq, tk, tv = (torch.from_numpy(x).to(tdt) for x in (q, k, v))
    kw = dict(causal=True, scale=0.125, attn_cap=cap, window=win,
              q_offset=pos, kv_len=kvl)
    plan = _plan(tq, tk, tv, **kw)
    got, lse = ref.flash_attention_split(tq, tk, tv, **plan._asdict(), **kw)
    assert got.dtype == tdt and got.shape == (2, sq, 2 * g, 64)
    assert lse.shape == (2, 2 * g, sq) and bool(torch.isfinite(lse).all())
    tol = (np.ldexp(1.0, np.frexp(np.abs(want))[1] - 8)
           if dtype == "bfloat16" else 3e-6)
    assert np.all(np.abs(got.float().numpy() - want) <= tol)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_split_matches_the_whole_attention(case):
    g, sq, sk, pos, kvl, cap, win = case
    tq, tk, tv = (torch.from_numpy(x) for x in _inputs(case, seed=1))
    kw = dict(causal=True, scale=0.125, attn_cap=cap, window=win,
              q_offset=pos, kv_len=kvl)
    want, wlse = ref.flash_attention_bshd(tq, tk, tv, **kw)
    plan = _plan(tq, tk, tv, **kw)
    for p in (plan, _fine(plan)):
        got, lse = ref.flash_attention_split(tq, tk, tv, **p._asdict(), **kw)
        assert float((got - want).abs().max()) <= 1e-6
        assert float((lse - wlse).abs().max()) <= 1e-6 * float(
            wlse.abs().max().clamp_min(1.0))


def test_split_of_a_cross_launch_matches_the_whole_attention():
    """Not causal (a cross launch over encoder keys), one split and many,
    G 8, Sq 1, and an outer rank dim of 3."""
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               for s in ((3, 2, 1, 16, 64), (3, 2, 1500, 2, 64),
                         (3, 2, 1500, 2, 64)))
    kw = dict(causal=False, scale=0.125, attn_cap=0.0, window=0,
              q_offset=0, kv_len=None)
    want, wlse = ref.flash_attention_bshd(
        *(t.flatten(0, 1) for t in (q, k, v)), **kw)
    plan = _plan(q, k, v, **kw)
    assert plan.splits > 1
    for p in (plan, fa.DecodePlan(plan.tile, plan.tiles, 1)):
        got, lse = ref.flash_attention_split(q, k, v, **p._asdict(), **kw)
        assert got.shape == (3, 2, 1, 16, 64)
        assert float((got.flatten(0, 1) - want).abs().max()) <= 1e-6
        assert float((lse.flatten(0, 1) - wlse).abs().max()) <= 1e-5


#: partial launches over 4 shards of 75 keys: Sq, q_offset, kv_len,
#: causal, cap, window (shards past kv_len, before the window and past
#: the causal edge see no key)
PARTIAL = ((1, 130, 131, True, 0.0, 0), (3, 200, 203, True, 0.0, 64),
           (1, 299, 300, True, 30.0, 0), (4, 0, 160, False, 0.0, 0),
           (1, 10, 11, True, 30.0, 8))


@pytest.mark.parametrize("case", PARTIAL, ids=[str(c) for c in PARTIAL])
def test_split_of_a_partial_launch_combines_to_the_whole(case):
    """2 data ranks × 4 ``model`` ranks × 2 rows, G 8 over 2 KV heads:
    the split plain version with ``shards=`` equals
    ``flash_attention_partial`` (keyless rows exactly ``o = 0``, ``lse =
    -inf`` in both), and ``lse_combine`` over the shards equals the whole
    attention within 1e-6; splits with no visible key of a shard."""
    sq, off, kvl, causal, cap, win = case
    dn, tpn, b, h, kv, hd, s = 2, 4, 2, 16, 2, 32, 300
    g = torch.Generator().manual_seed(3)
    q = torch.randn(dn, b, sq, h, hd, generator=g)
    k = torch.randn(dn, b, s, kv, hd, generator=g)
    v = torch.randn(dn, b, s, kv, hd, generator=g)
    blocks = lambda t: t.reshape(dn, b, tpn, s // tpn, kv, hd).movedim(  # noqa
        2, 1).flatten(0, 1)                       # (dn·tp, b, s/tp, ...)
    qr = q.unsqueeze(1).expand(dn, tpn, *q.shape[1:]).flatten(0, 1)
    kw = dict(causal=causal, scale=hd ** -0.5, attn_cap=cap, window=win,
              q_offset=off, kv_len=kvl, shards=tpn)
    kb, vb = blocks(k), blocks(v)
    po, plse = ref.flash_attention_partial(qr, kb, vb, **kw)
    keyless = torch.isinf(plse)
    assert bool(keyless.any()) == (off != 299)
    plan = _plan(qr, kb, vb, **kw)
    empty = 0
    for p in (plan, _fine(plan)):
        o, lse = ref.flash_attention_split(qr, kb, vb, **p._asdict(), **kw)
        assert torch.equal(torch.isinf(lse), keyless)
        assert bool((lse[keyless] < 0).all())
        assert not bool(o.movedim(-2, -3)[keyless].any())
        assert float((o - po).abs().max()) <= 1e-6
        assert float((lse[~keyless] - plse[~keyless]).abs().max()) <= 1e-5
        for m in range(tpn):
            lo, hi = ref.visible_keys(sq, s // tpn, causal=causal,
                                      window=win, q_offset=off, kv_len=kvl,
                                      base=m * (s // tpn))
            empty += sum(a == e for a, e in (
                ref.split_keys(lo, hi, i, tile=p.tile, tiles=p.tiles,
                               splits=p.splits) for i in range(p.splits)))
        with tp.parallel(tpn):
            got = tp.lse_combine(
                o.reshape(dn, tpn, b, sq, h, hd),
                lse.reshape(dn, tpn, b, h, sq).transpose(-1, -2), 1)
        want, _ = ref.flash_attention_bshd(
            q.flatten(0, 1), k.flatten(0, 1), v.flatten(0, 1),
            **{x: y for x, y in kw.items() if x != "shards"})
        assert float((got[:, 0].flatten(0, 1) - want).abs().max()) <= 1e-6
    assert empty > 0


def test_keyless_rows_of_a_split_are_exact_in_bf16():
    """bf16, G 16 over one KV head, Sq 4 at one key a split: the rows of
    a shard past ``kv_len`` are exactly 0 with ``lse = -inf``, and the
    others one bf16 ulp from ``flash_attention_partial``."""
    g = torch.Generator().manual_seed(4)
    q = torch.randn(4, 1, 4, 16, 64, generator=g).bfloat16()
    k, v = (torch.randn(4, 1, 40, 1, 64, generator=g).bfloat16()
            for _ in range(2))
    kw = dict(causal=True, scale=0.125, attn_cap=0.0, window=0,
              q_offset=66, kv_len=70, shards=4)
    po, plse = ref.flash_attention_partial(q, k, v, **kw)
    o, lse = ref.flash_attention_split(q, k, v, **_fine(_plan(q, k, v, **kw))
                                       ._asdict(), **kw)
    keyless = torch.isinf(plse)
    assert keyless[2:].all() and not keyless[:2].any()
    assert torch.equal(torch.isinf(lse), keyless)
    assert not bool(o[2:].any())
    ulp = torch.ldexp(torch.ones_like(po, dtype=torch.float32),
                      torch.frexp(po.float().abs())[1] - 8)
    assert bool(((o.float() - po.float()).abs() <= ulp).all())


@functools.cache
def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _launches():
    """Every flash launch shape of the chip's paths: ``FLASH_MODEL_CASES``
    (name → (n, b, sq, sk, h, kv, hd, vd, dtype, causal, window,
    q_offset, kv_len, shards)) and the sharded decodes of phases 35 and
    36 (TinyLlama on ``1x2x8``, gemma2-2b on ``1x1x8``, each at its last
    step)."""
    cs = _chip_smoke()
    out = {}
    for name, c in cs.FLASH_MODEL_CASES.items():
        out[name] = (1, c["b"], c["sq"], c["sk"], c["h"], c["kv"], c["hd"],
                     c["vd"], getattr(torch, c["dtype"]), c["causal"],
                     c["window"], c["q_offset"], c["kv_len"] or c["sk"], None)
    for name, (b, pos, cache, steps, mesh, heads) in {
            "tinyllama partial": (cs.SHARD_B, cs.SHARD_POS, cs.SHARD_CACHE,
                                  cs.SHARD_STEPS, cs.SHARD_MESHES[0],
                                  (32, 4, 64, 0)),
            "gemma2 partial local": (cs.GEMMA_SHARD_B, cs.GEMMA_SHARD_POS,
                                     cs.GEMMA_SHARD_CACHE,
                                     cs.GEMMA_SHARD_STEPS,
                                     cs.GEMMA_SHARD_MESH, (8, 4, 256, 4096)),
            "gemma2 partial global": (cs.GEMMA_SHARD_B, cs.GEMMA_SHARD_POS,
                                      cs.GEMMA_SHARD_CACHE,
                                      cs.GEMMA_SHARD_STEPS,
                                      cs.GEMMA_SHARD_MESH, (8, 4, 256, 0))
    }.items():
        ranks, model = mesh[0] * mesh[1] * mesh[2], mesh[2]
        h, kv, hd, win = heads
        last = pos + steps - 1
        out[name] = (ranks, b // (mesh[0] * mesh[1]), 1, cache // model, h, kv,
                     hd, hd, torch.bfloat16, True, win, last, last + 1, model)
    return out


def test_every_decode_launch_and_no_other_takes_the_decode_kernel():
    launches = _launches()
    decode = {n for n, c in launches.items() if c[2] == 1}
    assert {"tinyllama decode", "gemma2 decode global", "gemma2 decode local",
            "vlm cross decode fp32", "whisper decode cross",
            "tinyllama partial", "gemma2 partial local",
            "gemma2 partial global"} <= decode
    for name, (_, _, sq, _, h, kv, *_rest) in launches.items():
        assert fa.decodes(h, kv, sq) == (sq == 1), name
        if "train" in name or "prefill" in name or sq > 1:
            assert not fa.decodes(h, kv, sq), name


def test_the_plan_covers_the_visible_keys_in_whole_tiles():
    """On every decode launch of the chip's paths: the splits cut the
    visible range of each shard into contiguous runs of whole tiles (the
    last cut at its end), none past it; the grid has at least 264 blocks
    (two an SM) wherever the launch has that many tiles; the ring fits
    the block's shared memory."""
    for name, (n, b, sq, sk, h, kv, hd, vd, dt, causal, win, off, kvl,
               shards) in _launches().items():
        if not fa.decodes(h, kv, sq):
            continue
        plan = fa.decode_plan(n, b, h, kv, sq, sk, hd, vd, dt,
                              causal=causal, window=win, q_offset=off,
                              kv_len=kvl, shards=shards)
        esize = torch.empty((), dtype=dt).element_size()
        assert plan.tile == fa.decode_tile(hd, vd, esize, h // kv * sq)
        assert 3 * plan.tile * (hd + vd) * esize <= 232448, name
        blocks = n * b * kv
        assert 1 <= plan.splits <= plan.tiles, name
        assert blocks * plan.splits >= min(2 * fa.SMS, blocks * plan.tiles), (
            name, plan)
        spans = []
        for m in range(shards or 1):
            lo, hi = ref.visible_keys(sq, sk, causal=causal, window=win,
                                      q_offset=off, kv_len=kvl, base=m * sk)
            spans.append(hi - lo)
            cuts = [ref.split_keys(lo, hi, s, tile=plan.tile,
                                   tiles=plan.tiles, splits=plan.splits)
                    for s in range(plan.splits)]
            at = lo
            for a, e in cuts:
                assert at <= a <= e <= hi, (name, cuts)
                if e > a:
                    assert a == at and (a - lo) % plan.tile == 0
                    assert e == hi or (e - lo) % plan.tile == 0
                at = e
            assert sum(e - a for a, e in cuts) == hi - lo, (name, cuts)
        assert (plan.tiles - 1) * plan.tile < max(spans) <= (
            plan.tiles * plan.tile), (name, plan, spans)
    plan = fa.decode_plan(1, 2, 8, 4, 1, 6176, 256, 256, torch.bfloat16,
                          causal=True, window=4096, q_offset=5999,
                          kv_len=6000)
    assert plan.tiles * plan.tile - 4096 < plan.tile  # the window's keys only


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_tiles_are_whole_batches_that_fit(dtype):
    """For every (hd, vd) and every row count up to ``DECODE_ROWS``: the
    lanes of a key divide a warp and the head dims, a tile is a whole
    number of batches (``DECODE_KB`` keys of each of a warp's lane
    groups), about ``DECODE_TILE_BYTES`` of K and V, the row chunks fit
    the block's warps, and three stages fit the block's shared memory."""
    esize = torch.empty((), dtype=getattr(torch, dtype)).element_size()
    for hd, vd in fa.TC_DIMS:
        for rows in range(1, fa.DECODE_ROWS + 1):
            lanes = fa.decode_lanes(hd, rows)
            assert 32 % lanes == 0 and hd % lanes == 0 and vd % lanes == 0
            tile = fa.decode_tile(hd, vd, esize, rows)
            chunks = 1
            while chunks * (2 if rows <= 16 else 8) < rows:
                chunks *= 2
            assert chunks <= fa.DECODE_WARPS
            batch = 32 // lanes * fa.DECODE_KB
            assert tile % batch == 0
            assert tile == batch or tile * (hd + vd) * esize <= (
                fa.DECODE_TILE_BYTES)
            assert 3 * tile * (hd + vd) * esize <= 232448
