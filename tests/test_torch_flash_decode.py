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
import math
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


def _fp32_splits(blocks, tiles, rows):
    """The fp32 decode plan's split count, written out apart from the
    port: at least ``2·SMS`` blocks where the tiles allow,
    then up to four times that, the fewest waves of tile times."""
    least = min(tiles, -(-2 * fa.SMS // blocks), fa.DECODE_SPLITS)
    slots = fa.SMS * (2 if rows <= 16 else 1)
    cost = {s: (-(-blocks * s // slots) * (-(-tiles // s) + 1), s)
            for s in range(least, min(tiles, 4 * least, fa.DECODE_SPLITS)
                           + 1)}
    return min(cost, key=cost.get)


def _plan_of(c, dt):
    n, b, sq, sk, h, kv, hd, vd, _, causal, win, off, kvl, shards = c
    return fa.decode_plan(n, b, h, kv, sq, sk, hd, vd, dt, causal=causal,
                          window=win, q_offset=off, kv_len=kvl, shards=shards)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_plan_covers_the_visible_keys_in_whole_tiles(dtype):
    """On every decode launch of the chip's paths, in both dtypes: the
    splits cut the visible range of each shard into contiguous runs of
    whole tiles (the last cut at its end), none past it, never more
    splits than tiles.  bf16: the fewest splits that give every SM a
    block unless a block would keep fewer tiles than the ring's stages
    or the grid would outgrow one wave of the blocks the SMs hold; where
    the blocks that see keys outnumber those already, the fewest waves ×
    tile times; at most ``DECODE_CLUSTER`` where the cluster join is
    taken, and the ring within the shared memory of the blocks an SM
    holds.  fp32: its own plan (``_fp32_splits``), unchanged
    (at least 264 blocks, two an SM, wherever the launch has that many
    tiles)."""
    dt = getattr(torch, dtype)
    esize = torch.empty((), dtype=dt).element_size()
    for name, c in _launches().items():
        n, b, sq, sk, h, kv, hd, vd, _, causal, win, off, kvl, shards = c
        if not fa.decodes(h, kv, sq):
            continue
        plan = _plan_of(c, dt)
        rows, blocks = h // kv * sq, n * b * kv
        assert plan.tile == fa.decode_tile(hd, vd, esize, rows)
        assert 1 <= plan.splits <= plan.tiles, name
        if dt == torch.bfloat16:
            per_sm = fa.decode_blocks_per_sm(hd, vd)
            ring = fa.DECODE_STAGES * plan.tile * 2 * (max(hd, 64)
                                                       + max(vd, 64))
            assert ring <= 232448 // per_sm - 2048, name
            fill = max(1, plan.tiles // fa.DECODE_STAGES)
            wave = max(1, fa.SMS * per_sm // blocks)
            seen = blocks * sum(hi > lo for lo, hi in (
                ref.visible_keys(sq, sk, causal=causal, window=win,
                                 q_offset=off, kv_len=kvl, base=m * sk)
                for m in range(shards or 1))) // (shards or 1)
            if seen > fa.SMS * per_sm:   # several waves: their tile times
                waves = {x: -(-seen * x // (fa.SMS * per_sm)) * (
                    -(-plan.tiles // x) + fa.DECODE_BLOCK_TILES)
                    for x in range(1, fill + 1)}
                assert waves[plan.splits] == min(waves.values()), name
                assert all(waves[x] > waves[plan.splits]
                           for x in range(1, plan.splits)), name
            else:
                assert plan.splits == min(-(-fa.SMS // blocks), fill,
                                          wave), (name, plan)
                assert blocks * plan.splits <= max(blocks, fa.SMS * per_sm)
                assert blocks * plan.splits >= min(fa.SMS, blocks * fill,
                                                   blocks * wave)
            if fa.decode_cluster(plan.splits, hd, vd, blocks):
                assert plan.splits <= fa.DECODE_CLUSTER, name
                assert plan.splits <= 2 or (
                    4 * blocks * plan.splits <= 3 * fa.SMS * per_sm), name
        else:
            assert 3 * plan.tile * (hd + vd) * esize <= 232448, name
            assert blocks * plan.splits >= min(2 * fa.SMS,
                                               blocks * plan.tiles), name
            assert plan.splits == _fp32_splits(blocks, plan.tiles, rows)
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
    plan = fa.decode_plan(1, 2, 8, 4, 1, 6176, 256, 256, dt,
                          causal=True, window=4096, q_offset=5999,
                          kv_len=6000)
    assert plan.tiles * plan.tile - 4096 < plan.tile  # the window's keys only


def test_the_cluster_join_takes_the_model_launches_that_fit_a_cluster():
    """bf16: which join each decode launch of the chip's paths takes.
    The qwen3, TinyLlama and whisper decodes and the VLM's self decode
    join their splits in a cluster (one launch); the VLM server's cross
    decode (32 blocks a split, 4 splits, at one block an SM) fills the
    card and gemma2-2b's 6176-key decodes at B = 2 (8 blocks a split)
    want 16 splits: both take the scratch join."""
    plans = {name: _plan_of(c, torch.bfloat16)
             for name, c in _launches().items() if c[2] == 1}
    for name in ("qwen3 decode", "vlm server cross decode bf16",
                 "tinyllama decode", "whisper decode cross",
                 "vlm self decode", "whisper decode self"):
        c = _launches()[name]
        if name != "vlm server cross decode bf16":
            assert fa.decode_cluster(plans[name].splits, c[6], c[7],
                                     c[0] * c[1] * c[5]), name
    assert plans["gemma2 decode global"].splits > fa.DECODE_CLUSTER
    assert not fa.decode_cluster(plans["gemma2 decode global"].splits,
                                 256, 256, 8)
    # the VLM server's 32 blocks at 4 splits fill the card at hd 128's one
    # block an SM: its splits join through scratch
    assert not fa.decode_cluster(
        plans["vlm server cross decode bf16"].splits, 128, 128, 32)
    assert {p.splits > 1 for p in plans.values()} == {True, False}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_tiles_are_whole_batches_that_fit(dtype):
    """For every (hd, vd) and every row count up to ``DECODE_ROWS``.
    fp32: the lanes of a key divide a warp and the head dims, a tile is a
    whole number of batches (``DECODE_KB`` keys of each of a warp's lane
    groups), about ``DECODE_TILE_BYTES`` of K and V, the row chunks fit
    the block's warps, and three stages fit the block's shared memory.
    bf16: a tile is 32 keys where a key's K and V (each row padded to a
    64-wide box) take at most 512 bytes, else 16, whatever the rows; the
    rows' m16 tiles divide the consumer warps; the ring (two stages a
    warp) holds the warps' outputs at the end, and as many rings as the
    SM holds blocks (two, one at hd 128 and 256) fit its shared
    memory."""
    esize = torch.empty((), dtype=getattr(torch, dtype)).element_size()
    for hd, vd in fa.TC_DIMS:
        for rows in range(1, fa.DECODE_ROWS + 1):
            tile = fa.decode_tile(hd, vd, esize, rows)
            if esize == 2:
                padded = 2 * (max(hd, 64) + max(vd, 64))
                mt = fa.decode_row_tiles(rows)
                assert 16 * mt >= rows and fa.DECODE_CONSUMERS % mt == 0
                assert tile == (32 if padded <= 512 else 16)
                ring = fa.DECODE_STAGES * tile * padded
                assert ring == fa.decode_ring_bytes(hd, vd)
                assert fa.DECODE_STAGES % fa.DECODE_CONSUMERS == 0
                assert 4 * fa.DECODE_CONSUMERS * 16 * vd <= ring
                per_sm = fa.decode_blocks_per_sm(hd, vd)
                assert per_sm * (ring + 2048) <= 232448
                assert per_sm == (1 if (hd, vd) in ((128, 128), (256, 256))
                                  else 2)
                continue
            lanes = fa.decode_lanes(hd, rows)
            assert 32 % lanes == 0 and hd % lanes == 0 and vd % lanes == 0
            chunks = 1
            while chunks * (2 if rows <= 16 else 8) < rows:
                chunks *= 2
            assert chunks <= fa.DECODE_WARPS
            batch = 32 // lanes * fa.DECODE_KB
            assert tile % batch == 0
            assert tile == batch or tile * (hd + vd) * esize <= (
                fa.DECODE_TILE_BYTES)
            assert 3 * tile * (hd + vd) * esize <= 232448


def _bf16(x):
    """fp32 ``x`` rounded to bf16 (to nearest even), back in fp32."""
    return x.to(torch.bfloat16).float()


def _fl32_sum(acc, a, b):
    """``acc + a @ b`` with the product's terms summed exactly (fp64: 16
    bf16 products) and one fp32 rounding, as an mma step adds its k
    chunk of 16 into its fp32 accumulator."""
    return (acc.double() + a.double() @ b.double()).float()


def _mma_kernel_emulation(q, k, v, *, plan, causal, scale, cap, window,
                          q_offset, kv_len, shards=None):
    """``csrc/flash_attn.cu``'s bf16 decode kernel (``dmma``) in fp32 on
    the CPU: ``(o bf16, lse fp32, o fp32 before its rounding)``.

    ``q`` ``(N, B, Sq, H, hd)``, ``k`` ``(N, B, Sk, KV, hd)``, ``v``
    ``(N, B, Sk, KV, vd)``, bf16.  For each (n, b, KV head): the group's
    ``G·Sq`` rows (row ``g·Sq + i``); each split of the plan
    (``ref.split_keys``) walks its tiles of ``plan.tile`` keys, tile
    ``it`` on key slice ``it mod (DECODE_CONSUMERS / row tiles)``; a
    tile's scores summed over 16-wide k chunks in fp32, scaled (capped
    first) into log2 units, −inf where a row does not see the key; the
    slice's online softmax (max, 2^(s − m), the sum, the output rescaled);
    P split as P_hi = bf16(p) and P_lo = bf16(p − P_hi), two products a
    16-key chunk into the fp32 output.  The slices join in slice order,
    then the splits in split order (O = Σ O_s 2^(m_s − M), L likewise),
    o = O / max(L, 1e-30), lse = M ln 2 + log L; a row that saw no key
    gets o = 0, lse = −inf."""
    n, b, sq, h, hd = q.shape
    sk, kvh, vd = k.shape[2], k.shape[3], v.shape[-1]
    g = h // kvh
    rows = g * sq
    slices = fa.DECODE_CONSUMERS // fa.decode_row_tiles(rows)
    log2e = torch.tensor(math.log2(math.e), dtype=torch.float32)
    c_scale = torch.tensor(scale, dtype=torch.float32) * log2e
    kt = plan.tile
    o_all = torch.zeros((n, b, sq, h, vd))
    lse_all = torch.full((n, b, h, sq), -torch.inf)
    for nn in range(n):
        base = (nn % shards) * sk if shards else 0
        lo, hi = ref.visible_keys(sq, sk, causal=causal, window=window,
                                  q_offset=q_offset, kv_len=kv_len,
                                  base=base)
        pos = (q_offset - base + torch.arange(sq)).repeat(g)  # row g·Sq + i
        for bb in range(b):
            for j in range(kvh):
                qr = q[nn, bb, :, j * g:(j + 1) * g].float()     # (Sq, G, hd)
                qr = qr.transpose(0, 1).reshape(rows, hd)
                kk, vv = k[nn, bb, :, j].float(), v[nn, bb, :, j].float()
                parts = []
                for s in range(plan.splits):
                    a, e = ref.split_keys(lo, hi, s, tile=kt,
                                          tiles=plan.tiles,
                                          splits=plan.splits)
                    states = []
                    for sl in range(slices):
                        m = torch.full((rows,), -torch.inf)
                        ll = torch.zeros(rows)
                        acc = torch.zeros((rows, vd))
                        ntiles = -(-(e - a) // kt) if e > a else 0
                        for it in range(sl, ntiles, slices):
                            t0 = a + it * kt
                            keys = torch.arange(t0, t0 + kt)
                            kin = keys.clamp(max=sk - 1)
                            kb = torch.where((keys < sk)[:, None], kk[kin], 0)
                            vb = torch.where((keys < e)[:, None], vv[kin], 0)
                            x = torch.zeros((rows, kt))
                            for c0 in range(0, hd, 16):
                                x = _fl32_sum(x, qr[:, c0:c0 + 16],
                                              kb[:, c0:c0 + 16].T)
                            if cap:
                                x = torch.tanh(x * scale / cap) * cap * log2e
                            else:
                                x = x * c_scale
                            seen = (keys < e)[None].expand(rows, kt)
                            if causal:
                                seen = seen & (keys[None] <= pos[:, None])
                                if window:
                                    seen = seen & (keys[None]
                                                   > pos[:, None] - window)
                            x = torch.where(seen, x, -torch.inf)
                            mx = torch.maximum(m, x.amax(-1))
                            bm = torch.where(torch.isinf(mx), 0.0, mx)
                            al = torch.exp2(m - bm)
                            p = torch.exp2(x - bm[:, None])
                            ll = ll * al + p.sum(-1)
                            m = mx
                            acc = acc * al[:, None]
                            for c0 in range(0, kt, 16):
                                ph = _bf16(p[:, c0:c0 + 16])
                                pl = _bf16(p[:, c0:c0 + 16] - ph)
                                acc = _fl32_sum(acc, ph, vb[c0:c0 + 16])
                                acc = _fl32_sum(acc, pl, vb[c0:c0 + 16])
                        states.append((m, ll, acc))
                    parts.append(_join(states))
                m, ll, acc = _join(parts)
                none = torch.isinf(m)
                out = torch.where(none[:, None], 0.0,
                                  acc / ll.clamp(min=1e-30)[:, None])
                lse = torch.where(none, -torch.inf,
                                  m * math.log(2) + torch.log(ll))
                out = out.reshape(g, sq, vd).transpose(0, 1)
                o_all[nn, bb, :, j * g:(j + 1) * g] = out
                lse_all[nn, bb, j * g:(j + 1) * g] = lse.reshape(g, sq)
    return o_all.bfloat16(), lse_all, o_all


def _join(states):
    """(m, l, O) states joined in their order: M = max m, w = 2^(m − M)
    (0 for an empty state), O = Σ O w and L = Σ l w summed in order."""
    m = torch.stack([s[0] for s in states]).amax(0)
    bm = torch.where(torch.isinf(m), 0.0, m)
    ll = torch.zeros_like(m)
    acc = torch.zeros_like(states[0][2])
    for sm, sl, so in states:
        w = torch.exp2(sm - bm)
        acc = acc + so * w[:, None]
        ll = ll + sl * w
    return m, ll, acc


#: the models' bf16 decode launches, cut to a CPU's size: name → (N, B,
#: G, KV, Sq, Sk, hd, vd, causal, cap, window, q_offset, kv_len, shards,
#: the width v is a view of (MLA's strided v) or 0)
MMA_CASES = {
    "hd 64 G 8": (1, 2, 8, 2, 1, 1100, 64, 64, True, 0.0, 0, 1087, 1088,
                  None, 0),
    "hd 128 G 16": (1, 2, 16, 2, 1, 600, 128, 128, True, 0.0, 0, 590, 591,
                    None, 0),
    "vlm cross hd 128 G 8": (1, 1, 8, 2, 1, 800, 128, 128, False, 0.0, 0, 0,
                             800, None, 0),
    "hd 256 cap 50 window 4096": (1, 1, 2, 2, 1, 4200, 256, 256, True, 50.0,
                                  4096, 4150, 4151, None, 0),
    "(192, 128) strided v": (1, 2, 1, 4, 1, 300, 192, 128, True, 0.0, 0,
                             250, 251, None, 256),
    "shards keyless G 16 Sq 4": (4, 1, 16, 1, 4, 40, 64, 64, True, 0.0, 0,
                                 66, 70, 4, 0),
}


@pytest.mark.parametrize("name", list(MMA_CASES))
def test_mma_kernel_emulation_matches_jax_attend(name):
    """The bf16 decode kernel's arithmetic (``_mma_kernel_emulation``, at
    ``decode_plan``'s plan) against the jitted reference ``attend`` on
    the same bf16 inputs, held to the card's bound (``chip_smoke.py``'s
    ``flash_err``): every output within one bf16 ulp of the reference's
    bf16 output plus 2^-17 of max|v|.  The margin: the output before its
    rounding is within that 2^-17 of max|v| alone of the reference's fp32
    arithmetic on the same inputs.  With ``shards``: against
    ``ref.flash_attention_partial`` the same way, keyless rows ``o = 0``,
    ``lse = -inf`` exactly."""
    (n, b, g, kvh, sq, sk, hd, vd, causal, cap, win, off, kvl, shards,
     v_in) = MMA_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    h = g * kvh
    qn = rng.normal(size=(n, b, sq, h, hd)).astype(np.float32)
    kn = rng.normal(size=(n, b, sk, kvh, hd)).astype(np.float32)
    vn = rng.normal(size=(n, b, sk, kvh, v_in or vd)).astype(np.float32)
    tq, tk = (torch.from_numpy(x).bfloat16() for x in (qn, kn))
    tv = torch.from_numpy(vn).bfloat16()[..., -vd:]
    scale = 2.0 ** -3                  # exact in bf16: q·scale rounds nothing
    kw = dict(causal=causal, scale=scale, attn_cap=cap, window=win,
              q_offset=off, kv_len=kvl)
    plan = _plan(tq, tk, tv, shards=shards, **kw)
    got, lse, got32 = _mma_kernel_emulation(
        tq, tk, tv, plan=plan, causal=causal, scale=scale, cap=cap,
        window=win, q_offset=off, kv_len=kvl, shards=shards)
    assert plan.splits > 1 or shards    # every other case joins splits
    if shards:
        want, wl = ref.flash_attention_partial(tq, tk, tv, shards=shards,
                                               **kw)
        want32, _ = ref.flash_attention_partial(
            *(x.float() for x in (tq, tk, tv)), shards=shards, **kw)
        keyless = torch.isinf(wl)
        assert bool(keyless.any()) and torch.equal(torch.isinf(lse), keyless)
        assert not bool(got.movedim(-2, -3)[keyless].any())
        want, want32 = want.float().numpy(), want32.numpy()
    else:
        sel = dict(q_pos=off + jnp.arange(sq), kv_len=jnp.int32(kvl))
        args = [jnp.asarray(x.float().numpy()[0]) for x in (tq, tk, tv)]
        fn = _jax_attend(causal, win, cap, scale)
        want = np.asarray(fn(*(x.astype(jnp.bfloat16) for x in args), **sel),
                          np.float32)[None]
        want32 = np.asarray(fn(*args, **sel), np.float32)[None]
    floor = 2.0 ** -17 * float(tv.float().abs().max())
    assert float(np.abs(got32.numpy() - want32).max()) <= floor, name
    ulp = np.ldexp(1.0, np.frexp(np.abs(want))[1] - 8)
    assert np.all(np.abs(got.float().numpy() - want) <= ulp + floor), name


def test_mma_kernel_emulation_splits_join_in_order():
    """The emulation's split join: at the plan's splits, at one split and
    at as many splits as tiles, the outputs before their rounding agree
    within 1e-6 of max|v| (the join reorders fp32 sums only), and two
    calls give the same bits."""
    rng = np.random.default_rng(7)
    tq, tk, tv = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                  .bfloat16() for s in ((1, 2, 1, 16, 64), (1, 2, 700, 2, 64),
                                        (1, 2, 700, 2, 64)))
    kw = dict(causal=True, scale=0.125, cap=0.0, window=0, q_offset=650,
              kv_len=651)
    plan = _plan(tq, tk, tv, attn_cap=0.0, **{x: y for x, y in kw.items()
                                                if x != "cap"})
    outs = [_mma_kernel_emulation(tq, tk, tv, plan=p, **kw)[2] for p in (
        plan, plan._replace(splits=1), plan._replace(splits=plan.tiles))]
    assert plan.splits not in (1, plan.tiles)
    for o in outs[1:]:
        assert float((o - outs[0]).abs().max()) <= 1e-6 * 4.5
    again = _mma_kernel_emulation(tq, tk, tv, plan=plan, **kw)[2]
    assert torch.equal(again, outs[0])
