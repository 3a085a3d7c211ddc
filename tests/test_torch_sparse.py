"""The port's sparse in-network reduction (§7) against the JAX package's.

The same seeded numpy inputs go through the jitted JAX functions (kernels
through ``repro.kernels.ops``, in interpret mode or through their plain
reference; the data plane and the reducer under nested ``jax.vmap`` over
``("pod", "data")``) and through ``repro_torch`` on the CPU, where every
kernel wrapper runs its plain version.  Tolerance zero, except:

* ``sparse_accum`` adds duplicate indices in list order, as the
  reference's scatter (``repro.kernels.ref``) does; its one-hot Pallas
  kernel sums them in its dot's order, so against it only unique
  indices are compared;
* NaN payloads are not compared, only where NaNs lie (``inf · 0`` is a
  different NaN on each machine);
* the sign of a selected zero in ``topk_compact`` follows the reference
  where XLA's dot starts its sums from ``+0.0``; where it does not
  (fewer than 8 outputs past the last whole group of 8, in a tile of 8
  blocks) the reference gives ``-0.0`` and the port ``+0.0``, pinned by
  ``test_topk_compact_signed_zero_deviation`` (ROADMAP queue 3).

The port's own planes, batched and per-packet, agree bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import engine as jengine
from repro.core import sparse as jsparse
from repro.core import transports as jtransports
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.switch import dataplane as jdp
from repro.switch import handlers as jhd
from repro_torch import tree
from repro_torch.convert import params_from_jax, tensor_from_numpy
from repro_torch.core import sparse, transports
from repro_torch.core.engine import FlareConfig, GradReducer
from repro_torch.kernels import ops, ref
from repro_torch.kernels import sparse_accum as sa
from repro_torch.kernels import topk_compact as tk
from repro_torch.mesh import RankMesh
from repro_torch.switch import dataplane, handlers as hd
from repro_torch.switch import packets as pk

torch.set_num_threads(1)

AXES = ("pod", "data")
MESHES = [(1, 8), (2, 4)]
SENT = np.iinfo(np.int32).max
_INT = {1: np.int8, 2: np.int16, 4: np.int32}


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.contiguous()
        return a.view({1: torch.int8, 2: torch.int16,
                       4: torch.int32}[a.element_size()]).numpy()
    a = np.asarray(a)
    return a.view(_INT[a.dtype.itemsize])


def _same(got, want) -> bool:
    """Bitwise, except that a NaN matches any NaN."""
    g = got.float().numpy() if isinstance(got, torch.Tensor) else None
    w = np.asarray(want)
    nan = np.isnan(np.asarray(w, np.float32))
    if not np.array_equal(nan, np.isnan(g)):
        return False
    gb, wb = _bits(got).copy(), _bits(w).copy()
    gb[nan], wb[nan] = 0, 0
    return np.array_equal(gb, wb)


def _t(a) -> torch.Tensor:
    return tensor_from_numpy(np.asarray(a), "cpu")


def _nested(f):
    return jax.jit(jax.vmap(jax.vmap(f, axis_name="data"), axis_name="pod"))


def _in_dtype(x: np.ndarray, dtype: str) -> np.ndarray:
    return np.array(jnp.asarray(x).astype(dtype))


def _tied(rng, shape) -> np.ndarray:
    """Values on a coarse grid (many ties of magnitude, ±), zeros and
    -0.0 among them."""
    x = rng.integers(-4, 5, size=shape).astype(np.float32) / 2
    x[rng.random(shape) < 0.1] = -0.0
    return x


# ---------------------------------------------------------------------------
# core/sparse.py
# ---------------------------------------------------------------------------

def test_sparse_k_and_densify_step_match_jax():
    for frac in (0.0, 0.01, 0.05, 0.3, 1.0, 2.0):
        for extent in (0, 1, 7, 1000, 1_045_088):
            assert sparse.sparse_k(frac, extent) == jsparse.sparse_k(
                frac, extent)
    for cap, size, thr in ((10, 100, 0.25), (25, 100, 0.25), (99, 100, 1.1),
                           (100, 100, 1.1), (33, 64, 0.5)):
        assert sparse.densify_step(cap, size, thr) == jsparse.densify_step(
            cap, size, thr)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_topk_sparsify_matches_jax(dtype):
    """Ties of magnitude (the lower index wins), ``k_eff < k`` per bucket,
    an all-zero bucket and one of -0.0 only."""
    rng = np.random.default_rng(1)
    x = _in_dtype(_tied(rng, (6, 96)), dtype)
    x[2] = 0.0
    x[3] = -0.0
    k, keff = 12, np.array([12, 5, 12, 3, 1, 12], np.int32)
    wv, wi = jax.jit(jax.vmap(lambda v, ke: jsparse.topk_sparsify(
        v, k, ke)))(x, keff)
    v, i = sparse.topk_sparsify(_t(x), k, torch.from_numpy(keff))
    assert i.dtype == torch.int32 and v.dtype == getattr(torch, dtype)
    assert np.array_equal(i.numpy(), np.asarray(wi))
    assert np.array_equal(_bits(v), _bits(wv))
    # without k_eff, and with leading (rank, bucket) axes
    wv, wi = jax.jit(jax.vmap(lambda a: jsparse.topk_sparsify(a, k)))(x)
    v, i = sparse.topk_sparsify(_t(x).reshape(2, 3, 96), k)
    assert np.array_equal(i.reshape(6, k).numpy(), np.asarray(wi))
    assert np.array_equal(_bits(v.reshape(6, k)), _bits(wv))
    with pytest.raises(ValueError, match="k=97"):
        sparse.topk_sparsify(_t(x), 97)


def test_scatter_dense_and_residual_match_jax():
    """Sentinels drop; ``residual_`` writes ``v − scatter_dense`` in place,
    ``-0.0`` kept where the list holds ``-0.0``."""
    rng = np.random.default_rng(2)
    for dtype in ("float32", "bfloat16"):
        v = _in_dtype(_tied(rng, (3, 64)), dtype)
        val, idx = jax.jit(jax.vmap(lambda a, ke: jsparse.topk_sparsify(
            a, 20, ke)))(v, np.array([20, 7, 20], np.int32))
        want = jax.jit(jax.vmap(lambda a, i: jsparse.scatter_dense(
            a, i, 64)))(val, idx)
        got = sparse.scatter_dense(_t(val), _t(idx), 64)
        assert np.array_equal(_bits(got), _bits(want))
        res = jax.jit(lambda a, m: a - m)(v, want)
        tv = _t(v)
        assert sparse.residual_(tv, _t(val), _t(idx)) is tv
        assert np.array_equal(_bits(tv), _bits(res))
        assert (np.signbit(np.asarray(res, np.float32))
                & (np.asarray(val, np.float32) == 0).any()).any()


@pytest.mark.parametrize("bucketed", [False, True])
def test_merge_coordinate_lists_matches_jax(bucketed):
    """Sorted unique lists with shared indices, sentinel tails and ±0.0
    values (a merged -0.0 becomes +0.0, as the reference's add makes it)."""
    rng = np.random.default_rng(3 + bucketed)

    def lists(n, cap):
        idx = np.full((n, cap), SENT, np.int32)
        val = np.zeros((n, cap), np.float32)
        for r in range(n):
            m = rng.integers(0, cap + 1)
            idx[r, :m] = np.sort(rng.choice(3 * cap, m, replace=False))
            val[r, :m] = _tied(rng, (m,))
        return idx, val

    a, b = lists(4, 10), lists(4, 7)
    if bucketed:
        want = jax.jit(jsparse.merge_coordinate_lists)(*a, *b)
        got = sparse.merge_coordinate_lists(*map(_t, a), *map(_t, b))
        pairs = [(got, want)]
    else:
        pairs = [(sparse.merge_coordinate_lists(
            _t(a[0][r]), _t(a[1][r]), _t(b[0][r]), _t(b[1][r])),
            jax.jit(jsparse.merge_coordinate_lists)(a[0][r], a[1][r],
                                                    b[0][r], b[1][r]))
            for r in range(4)]
    for (gi, gv), (wi, wv) in pairs:
        assert np.array_equal(gi.numpy(), np.asarray(wi))
        assert np.array_equal(_bits(gv), _bits(wv))


# ---------------------------------------------------------------------------
# The sparse_merge handler.
# ---------------------------------------------------------------------------

def test_sparse_handler_counts_collisions_like_the_reference():
    """``tests/test_switch.py``'s case, and random lists of 4 children in
    2 groups (G, P, B, cap)."""
    idx = np.asarray([[[0, 2, 4, SENT]], [[2, 3, SENT, SENT]],
                      [[0, 2, 5, 6]]], np.int32)
    val = np.where(idx != SENT, 1.0, 0.0).astype(np.float32)
    h = hd.get_handler("sparse_merge")
    merged, stats = hd.run(h, {"idx": _t(idx)[None], "val": _t(val)[None]},
                           None, design="single")
    dense = sparse.scatter_dense(merged["val"][0, 0], merged["idx"][0, 0], 8)
    assert dense.tolist() == [2, 0, 3, 1, 1, 1, 1, 0]
    assert stats["collisions"].tolist() == [3]

    rng = np.random.default_rng(5)
    idxs = np.full((2, 4, 3, 12), SENT, np.int32)
    vals = np.zeros((2, 4, 3, 12), np.float32)
    for g, p, b in np.ndindex(2, 4, 3):
        m = rng.integers(0, 13)
        idxs[g, p, b, :m] = np.sort(rng.choice(30, m, replace=False))
        vals[g, p, b, :m] = _tied(rng, (m,))
    got, gstats = hd.get_handler("sparse_merge").payload_handler(
        {"idx": _t(idxs), "val": _t(vals)}, None, "single", 1, {})
    want, wstats = jax.jit(jax.vmap(
        lambda i, v: jhd.get_handler("sparse_merge").payload_handler(
            {"idx": i, "val": v}, None, "single", 1, {})))(idxs, vals)
    assert np.array_equal(got["idx"].numpy(), np.asarray(want["idx"]))
    assert np.array_equal(_bits(got["val"]), _bits(want["val"]))
    assert np.array_equal(gstats["collisions"].numpy(),
                          np.asarray(wstats["collisions"]))
    assert (gstats["collisions"] > 0).all()


# ---------------------------------------------------------------------------
# The kernels' plain versions.
# ---------------------------------------------------------------------------

def test_sparse_accum_matches_jax():
    """Unique indices with -1 and out-of-range entries against the Pallas
    body and the reference's scatter; order-dependent duplicates (three
    and more of one index) against the scatter, which adds in list
    order."""
    rng = np.random.default_rng(7)
    size, e = 4096, 512
    idx = rng.permutation(size + 200)[:e].astype(np.int32)
    idx[::17] = -1
    val = (rng.normal(size=e) * 10).astype(np.float32)
    val[5] = -0.0
    want = np.asarray(jops.sparse_accum(idx, val, size))      # the one-hot
    assert np.array_equal(_bits(want), _bits(jref.sparse_accum(idx, val,
                                                               size)))
    got = ops.sparse_accum(_t(idx), _t(val), size)
    assert got.dtype == torch.float32
    assert np.array_equal(_bits(got), _bits(want))
    # order matters: 1e8 + 1 - 1e8 is 0 in this order and 1 in another
    dup = np.array([5, 5, 5, 1, 7, 7, 7, 7, -1, 9], np.int32)
    dv = np.array([1e8, 1.0, -1e8, 2.0, 1.0, 3e7, 1.0, -3e7, 4.0, 5.0],
                  np.float32)
    want = jref.sparse_accum(jnp.asarray(dup), jnp.asarray(dv), 8)
    got = ops.sparse_accum(_t(dup), _t(dv), 8)
    assert np.array_equal(_bits(got), _bits(want))
    assert got[5] == 0.0 and got[7] == 0.0 and got.sum() == 2.0
    # slots: (B, E) and leading group axes, bf16 values into fp32
    i2 = rng.integers(-1, 300, size=(3, 2, 64)).astype(np.int32)
    v2 = _in_dtype(rng.normal(size=(3, 2, 64)).astype(np.float32),
                   "bfloat16")
    got = ops.sparse_accum_slots(_t(i2), _t(v2), 256)
    assert got.shape == (3, 2, 256) and got.dtype == torch.float32
    for g in range(3):
        want = jax.jit(lambda i, v: jref.sparse_accum_slots(i, v, 256))(
            i2[g], v2[g])
        assert np.array_equal(_bits(got[g]), _bits(want))
        assert np.array_equal(_bits(got[g]), _bits(jops.sparse_accum_slots(
            i2[g], v2[g], 256)))


@pytest.mark.parametrize("k,dtype", [(1, "float32"), (8, "float32"),
                                     (64, "float32"), (8, "bfloat16")])
def test_topk_compact_matches_jax(k, dtype):
    """Eight blocks of 512 (the Pallas tile of 8): random, coarse ties,
    a zero block, +0/-0 mixed, one inf, a NaN, -inf with an inf, a
    sparse block; against the reference's plain version, and at k=8
    against the Pallas body, a ragged length padded too."""
    rng = np.random.default_rng(k)
    x = rng.normal(size=(8, 512)).astype(np.float32)
    x[1] = _tied(rng, (512,))
    x[2] = 0.0
    x[3, ::2] = -0.0
    x[3, 1::2] = 0.0
    x[4, 17] = np.inf
    x[5, 3] = np.nan
    x[6, 100], x[6, 200] = -np.inf, np.inf
    x[7] = 0.0
    x[7, [5, 300, 301]] = [2.0, -2.0, 0.5]
    x = _in_dtype(x.reshape(-1), dtype)
    wv, wi = jax.jit(jref.topk_compact, static_argnums=1)(x, k)
    v, i = ops.topk_compact(_t(x), k)
    assert v.dtype == getattr(torch, dtype) and i.dtype == torch.int32
    assert np.array_equal(i.numpy(), np.asarray(wi))
    assert _same(v, wv)
    assert not torch.isfinite(v[4]).any() and torch.isnan(v[5]).all()
    if k == 8:
        wv, wi = jops.topk_compact(x, k)
        assert np.array_equal(i.numpy(), np.asarray(wi)) and _same(v, wv)
        wv, wi = jops.topk_compact(x[:1000], k)          # pads to 1024
        v, i = ops.topk_compact(_t(x[:1000]), k)
        assert v.shape == (2, k)
        assert np.array_equal(i.numpy(), np.asarray(wi)) and _same(v, wv)


def test_topk_compact_order_is_the_references():
    """The strictly-above entries come first and the threshold ties after
    them, so the output is not index-sorted: on 512 normal draws with the
    small ones zeroed, the last index (a tie at the threshold) is 247."""
    x = np.random.default_rng(0).normal(size=512).astype(np.float32)
    x[np.abs(x) < 0.5] = 0
    want = [219, 238, 270, 284, 303, 413, 478, 247]
    assert np.asarray(jops.topk_compact(jnp.asarray(x), 8)[1])[0].tolist() \
        == want
    v, i = ops.topk_compact(_t(x), 8)
    assert i[0].tolist() == want
    assert (v[0] == _t(x)[i[0].long()]).all()


def test_topk_compact_signed_zero_deviation():
    """A recorded deviation of the reference (ROADMAP queue 3).  Its
    one-hot product runs on XLA's CPU dot, which starts each sum from
    +0.0 for whole groups of 8 outputs but from the first product for
    the outputs past them in a tile of 8 blocks.  So a block of -0.0
    only gives -0.0 at k=3 and +0.0 at k=8.  The port gives 0 + Σ, +0.0,
    at every k."""
    x = np.full(8 * 512, -0.0, np.float32)
    for k, ref_sign in ((3, True), (8, False)):
        wv, wi = jops.topk_compact(jnp.asarray(x), k)
        v, i = ops.topk_compact(_t(x), k)
        assert np.array_equal(i.numpy(), np.asarray(wi))
        assert (np.signbit(np.asarray(wv)) == ref_sign).all()
        assert not torch.signbit(v).any()


# The CUDA kernel's own arithmetic, emulated: v_k by its radix select,
# then the bisection on scalars, then its compaction.

_U32 = np.uint32(0xFFFFFFFF)


def _bitonic_descending(c: np.ndarray) -> np.ndarray:
    """The warp's bitonic sort of 32 keys, one a lane, largest first: at
    each stage lane ``l`` keeps the max or the min of itself and lane
    ``l ^ stride``."""
    lane = np.arange(32)
    size = 2
    while size <= 32:
        stride = size // 2
        while stride:
            o = c[lane ^ stride]
            keep_max = ((lane & stride) == 0) == ((lane & size) == 0)
            c = np.where(keep_max, np.maximum(c, o), np.minimum(c, o))
            stride //= 2
        size *= 2
    return c


def _radix_kth_largest(u: np.ndarray, k: int) -> np.uint32:
    """``warp_kth_largest``: the k-th largest of the 31-bit magnitude
    patterns ``u``, passes over 6-bit digits from the top (bits 25-30,
    19-24, ..., 1-6, then bit 0) until at most 32 candidates are left,
    which a warp bitonic sort orders."""
    prefix, above, want = np.uint32(0), np.uint32(0), k
    for shift in (25, 19, 13, 7, 1, 0):
        cand = u[(u & above) == prefix]
        hist = np.bincount((cand >> np.uint32(shift)) % 64, minlength=64)
        from_top = np.append(np.cumsum(hist[::-1])[::-1][1:], 0)
        hit = np.flatnonzero((from_top < want) & (want <= from_top + hist))
        assert hit.size == 1
        d = int(hit[0])
        want -= int(from_top[d])
        prefix |= np.uint32(d << shift)
        above = _U32 << np.uint32(shift)
        if hist[d] <= 32:
            c = np.zeros(32, np.uint32)                 # one a lane
            c[:hist[d]] = u[(u & above) == prefix]
            return _bitonic_descending(c)[want - 1]
    return prefix                                   # the candidates all equal it


def _kernel_threshold(x: np.ndarray, k: int, n_iter: int = 24) -> np.float32:
    """``topk_kernel``'s ``lo`` for one fp32 block: ``v_k``, then ``n_iter``
    steps of ``v_k >= mid`` on the scalars."""
    ax = np.abs(x)
    amax = np.float32(np.nan) if np.isnan(ax).any() else ax.max()
    vk = amax
    if k > 1:                       # unused where a NaN makes hi NaN
        vk = _radix_kth_largest(ax.view(np.uint32), k).view(np.float32)
    lo, hi = np.float32(0), amax + np.float32(1e-30)
    for _ in range(n_iter):
        mid = np.float32(0.5) * (lo + hi)
        if vk >= mid:
            lo = mid
        else:
            hi = mid
    return lo


def _kernel_compact(x: np.ndarray, lo: np.float32, k: int):
    """The kernel's compaction of one fp32 block: strictly above ``lo`` in
    index order, then ties, ``k`` in all; ``inf · 0`` NaN, ``0 + x``."""
    ax = np.abs(x)
    gt = ax > lo
    eq = ~gt & (ax >= lo)
    sel = np.flatnonzero(gt)[:k].tolist()
    sel += np.flatnonzero(eq)[:k - len(sel)].tolist()
    bad = ~np.isfinite(x)
    vals = np.zeros(k, np.float32)
    idx = np.full(k, -1, np.int32)
    for pos, j in enumerate(sel):
        vals[pos] = np.nan if bad.sum() - bad[j] > 0 else np.float32(0) + x[j]
        idx[pos] = j
    return vals, idx


_KINDS = ("normal", "ties", "zeros", "signed_zeros", "subnormal", "inf",
          "nan", "inf_pair", "cluster", "spread", "three_ones", "all_nan",
          "all_inf")


def _block(rng, kind: str, block: int) -> np.ndarray:
    """One block of ``kind``: ties, zeros, ±0.0, subnormals, inf, NaN, the
    cluster (one 1e6, the rest in [1, 1.0001], a spread under ``max ·
    2^-24``, so more than ``k`` lie strictly above ``lo``)."""
    x = rng.normal(size=block).astype(np.float32)
    if kind == "ties":
        x = _tied(rng, (block,))
    elif kind == "zeros":
        x[:] = 0.0
    elif kind == "signed_zeros":
        x[:] = np.where(rng.random(block) < 0.5, -0.0, 0.0)
    elif kind == "subnormal":
        x = (x * np.float32(1e-39)).astype(np.float32)
    elif kind == "inf":
        x[rng.integers(block)] = np.inf
    elif kind == "nan":
        x[rng.integers(block)] = np.nan
    elif kind == "inf_pair":
        x[rng.choice(block, 2, replace=False)] = [-np.inf, np.inf]
    elif kind == "cluster":
        x = (rng.uniform(1, 1.0001, block)
             * rng.choice([-1, 1], block)).astype(np.float32)
        x[rng.integers(block)] = 1e6
    elif kind == "spread":
        x = (x * np.exp2(rng.integers(-20, 21, block))).astype(np.float32)
    elif kind == "three_ones":
        x[:] = 0.0
        x[rng.choice(block, 3, replace=False)] = 1.0
    elif kind == "all_nan":
        x[:] = np.nan
    elif kind == "all_inf":
        x[:] = np.where(rng.random(block) < 0.5, -np.inf, np.inf)
    return x


@settings(max_examples=150, deadline=None)
@given(block=st.sampled_from([32, 64, 512]),
       kk=st.sampled_from([1, 2, 8, -1, 0]),
       dtype=st.sampled_from(["float32", "bfloat16", "float16"]),
       kinds=st.lists(st.sampled_from(_KINDS), min_size=1, max_size=4),
       seed=st.integers(0, 2**31 - 1))
def test_topk_kernel_arithmetic_is_the_references(block, kk, dtype, kinds,
                                                  seed):
    """The CUDA kernel's threshold (``v_k`` by its radix select, then the
    bisection on scalars) has the bits of the reference's counting
    bisection, and its compaction gives ``ref.topk_compact``'s outputs:
    ``k`` in {1, 2, 8, block - 1, block}, fp32, bf16 and fp16."""
    k = {-1: block - 1, 0: block}.get(kk, kk)
    rng = np.random.default_rng(seed)
    xb = torch.from_numpy(np.stack([_block(rng, kind, block)
                                    for kind in kinds])).to(
        getattr(torch, dtype))
    x32 = xb.float().numpy()
    want_lo = ref.topk_threshold(xb, k).numpy()[:, 0]
    want_v, want_i = ref.topk_compact(xb, k)
    for r in range(len(kinds)):
        lo = _kernel_threshold(x32[r], k)
        assert lo.view(np.int32) == want_lo[r].view(np.int32), (kinds[r], k)
        v, i = _kernel_compact(x32[r], lo, k)
        assert np.array_equal(i, want_i[r].numpy()), (kinds[r], k)
        got_v = torch.from_numpy(v).to(xb.dtype)
        nan = torch.isnan(got_v)
        assert torch.equal(nan, torch.isnan(want_v[r])), (kinds[r], k)
        assert np.array_equal(_bits(got_v[~nan]), _bits(want_v[r][~nan])), \
            (kinds[r], k)


@pytest.mark.parametrize("k,dtype", [(1, "float32"), (8, "float32"),
                                     (64, "float32"), (511, "float32"),
                                     (8, "bfloat16")])
def test_topk_compact_cluster_matches_jax(k, dtype):
    """Eight cluster blocks (one 1e6, the rest of either sign in [1,
    1.0001]): every entry lies strictly above the threshold, and the cap
    by index order decides.  The port against the Pallas body (interpret
    mode) and against the kernel's arithmetic, emulated."""
    rng = np.random.default_rng(k)
    x = _in_dtype(np.concatenate([_block(rng, "cluster", 512)
                                  for _ in range(8)]), dtype)
    wv, wi = jops.topk_compact(x, k)
    v, i = ops.topk_compact(_t(x), k)
    assert np.array_equal(i.numpy(), np.asarray(wi)) and _same(v, wv)
    x32 = np.asarray(x, np.float32).reshape(8, 512)
    for r in range(8):
        lo = _kernel_threshold(x32[r], k)
        if dtype == "float32" and k > 1:
            assert (np.abs(x32[r]) > lo).sum() > k
        ev, ei = _kernel_compact(x32[r], lo, k)
        assert np.array_equal(ei, i[r].numpy())


def test_blockwise_sparsify_round_trip_matches_jax():
    """Zero-valued tie fills drop to -1; the round trip into the flat
    ``sparse_accum`` keeps exactly the selected entries."""
    rng = np.random.default_rng(9)
    x = rng.normal(size=8 * 512).astype(np.float32)
    x[512:1024] = 0.0
    x[600] = 3.0
    for k in (1,):
        wv, wg = jops.blockwise_sparsify(jnp.asarray(x), k)
        v, g = ops.blockwise_sparsify(_t(x), k)
        assert np.array_equal(g.numpy(), np.asarray(wg))
        assert np.array_equal(_bits(v), _bits(wv))
        dense = ops.sparse_accum(g, v, x.shape[0])
        assert np.array_equal(_bits(dense), _bits(
            jops.sparse_accum(wg, wv, x.shape[0])))
        assert int((dense != 0).sum()) == int((g >= 0).sum())


def test_kernel_entries_raise_on_cpu_tensors():
    """The wrappers launch the kernel or raise; they never fall back."""
    with pytest.raises(ValueError, match="CUDA"):
        sa.sparse_accum_slots(torch.zeros(1, 1, 4, dtype=torch.int32),
                              torch.zeros(1, 1, 4), 8)
    with pytest.raises(ValueError, match="CUDA"):
        tk.topk_compact(torch.zeros(512), 4)
    with pytest.raises(ValueError, match="k=600 > block=512"):
        ops.topk_compact(torch.zeros(512), 600)
    idx = torch.tensor([[0, 3, -1, 9]], dtype=torch.int32)
    assert sa.sparse_accum_bytes(idx, torch.zeros(1, 4), 8) == 2 * 8 + 32
    assert tk.topk_bytes(torch.zeros(1024), 4, 512) == 4096 + 2 * 4 * 8


# ---------------------------------------------------------------------------
# The sparse data plane.
# ---------------------------------------------------------------------------

B, S, K = 2, 128, 8


def _thresholds(mshape):
    """The three crossover points, as ``tests/multidevice_checks.py``'s
    ``check_sparse_densify`` sets them: densify before level 1, mid-tree
    (two-level meshes), and at the root; S = 128 (twice that check's)
    so that eight merged lists of 8 still fit at the root."""
    data = mshape[1]
    out = {"leaf": 0.01, "root": 1.1}
    if mshape[0] > 1:
        out["mid"] = (K * data + 1) / S
    return out


def _perms(seed):
    """Per-slot arrival permutations, one callable a level."""
    def perm(p, n, _s=seed):
        r = np.random.default_rng(_s + 31 * n)
        return np.stack([r.permutation(p) for _ in range(n)], axis=1)
    return [perm, lambda p, n: perm(p, n, seed + 1)]


CASES = [(m, c) for m in MESHES for c in _thresholds(m)]


@pytest.mark.parametrize("mshape,cross", CASES)
def test_switch_allreduce_sparse_matches_jax(mshape, cross):
    thr = _thresholds(mshape)[cross]
    rng = np.random.default_rng(MESHES.index(mshape) * 5 + len(cross))
    x = (rng.normal(size=mshape + (B, S)) * 1e2).astype(np.float32)
    x[..., 0, :5] = 0.0                                   # ties at zero
    ks = (K, 5)
    want = _nested(lambda a: jdp.switch_allreduce_sparse(
        a, AXES, ks, density_threshold=thr, with_stats=True))(jnp.asarray(x))
    mesh, tx = RankMesh(mshape), _t(x)
    runs = [dataplane.switch_allreduce_sparse(
        tx, mesh, AXES, ks, density_threshold=thr, with_stats=True,
        batched=bt, arrival_perms=p)
        for bt in (True, False) for p in (None, _perms(len(cross)))]
    red, (val, idx), stats = runs[0]
    assert np.array_equal(_bits(red), _bits(want[0]))
    mine = sparse.scatter_dense(val, idx, S)
    assert np.array_equal(_bits(mine), _bits(want[1]))
    assert np.array_equal(stats["collisions"].numpy(),
                          np.asarray(want[2]["collisions"]))
    assert np.array_equal(stats["spill_bytes"].numpy(),
                          np.asarray(want[2]["spill_bytes"]))
    if cross == "root":
        assert int(stats["collisions"].max()) > 0
    for r in runs[1:]:                                # the port's planes
        assert np.array_equal(_bits(r[0]), _bits(red))
        assert torch.equal(r[2]["collisions"], stats["collisions"])


def test_per_packet_plane_and_mean_match_jax():
    """The reference's own per-packet plane under the same arrival
    permutations, mid-tree densify, ``mean`` on a bf16 arena, and the
    lossy fabric (a surviving plan gives the fault-free bits)."""
    mshape, thr = (2, 4), _thresholds((2, 4))["mid"]
    rng = np.random.default_rng(21)
    x = (rng.normal(size=mshape + (B, S)) * 1e2).astype(np.float32)
    perms = _perms(3)
    want = _nested(lambda a: jdp.switch_allreduce_sparse(
        a, AXES, K, density_threshold=thr, arrival_perms=perms,
        batched=False)[0])(jnp.asarray(x))
    got = dataplane.switch_allreduce_sparse(
        _t(x), RankMesh(mshape), AXES, K, density_threshold=thr,
        arrival_perms=perms, batched=False)[0]
    assert np.array_equal(_bits(got), _bits(want))
    xb = _in_dtype(x, "bfloat16")
    want = _nested(lambda a: jdp.switch_allreduce_sparse(
        a, AXES, K, mean=True)[0])(jnp.asarray(xb))
    got = dataplane.switch_allreduce_sparse(_t(xb), RankMesh(mshape), AXES,
                                            K, mean=True)[0]
    assert got.dtype == torch.bfloat16
    assert np.array_equal(_bits(got), _bits(want))
    one = _t(x[:1, :1])
    red, sent = dataplane.switch_allreduce_sparse(one, RankMesh((1, 1)),
                                                  AXES, K)
    assert np.array_equal(_bits(red), _bits(sparse.scatter_dense(*sent, S)))
    # the lossy fabric is ported: a surviving plan gives the fault-free bits
    plan = pk.FaultPlan(seed=4, drop=0.05, duplicate=0.3, reorder=0.5,
                        corrupt=0.02, retry=pk.RetryPolicy(max_retries=8))
    clean = dataplane.switch_allreduce_sparse(_t(x), RankMesh(mshape), AXES,
                                              K, density_threshold=thr)[0]
    for batched in (True, False):
        lossy = dataplane.switch_allreduce_sparse(
            _t(x), RankMesh(mshape), AXES, K, density_threshold=thr,
            fault_plan=plan, batched=batched)[0]
        assert np.array_equal(_bits(lossy), _bits(clean))


# ---------------------------------------------------------------------------
# GradReducer with error feedback, two steps.
# ---------------------------------------------------------------------------

def _sparse_cfg(frac):
    return dict(axes=AXES, transport="innetwork", sparse_k_frac=frac)


def _two_steps(mshape, frac, g1, g2):
    jred = jengine.GradReducer(jengine.FlareConfig(**_sparse_cfg(frac)))
    step = _nested(lambda g, s: jred(g, s))
    r1, st1 = step(g1, jax.tree.map(jnp.zeros_like, g1))
    r2, st2 = step(g2, st1)
    red = GradReducer(FlareConfig(**_sparse_cfg(frac)), RankMesh(mshape))
    assert red.needs_state
    p1, pst1 = red(params_from_jax(g1, "cpu"),
                   red.init_state(params_from_jax(g1, "cpu")))
    # the state crosses from JAX to the port as any other tree does
    p2, pst2 = red(params_from_jax(g2, "cpu"),
                   params_from_jax(jax.tree.map(np.asarray, st1), "cpu"))
    return ([jax.tree.leaves(a) for a in (r1, st1, r2, st2)],
            [tree.flatten(a)[0] for a in (p1, pst1, p2, pst2)])


@pytest.mark.parametrize("frac", [0.05, 0.3])
def test_grad_reducer_sparse_matches_jax(frac):
    """A small ragged fp32 tree, two steps with the state carried: lists
    reach the root at 0.05 and densify before level 1 at 0.3."""
    mshape = (2, 4)
    rng = np.random.default_rng(int(frac * 100))
    shapes = {"w": (6, 50), "b": (33,), "c": (300,)}
    mk = lambda: {k: _tied(rng, mshape + v) * rng.uniform(
        0.5, 2, size=mshape + v).astype(np.float32) for k, v in shapes.items()}
    want, got = _two_steps(mshape, frac, mk(), mk())
    for w_leaves, g_leaves in zip(want, got):
        for w, g in zip(w_leaves, g_leaves):
            assert tuple(g.shape) == w.shape
            assert np.array_equal(_bits(g), _bits(w))


def test_grad_reducer_sparse_bf16_matches_jax():
    """bf16 leaves on the flat mesh, two steps: bitwise, result and
    state."""
    mshape = (1, 8)
    rng = np.random.default_rng(4)
    shapes = {"w": (5, 7), "b": (90,)}
    mk = lambda: {k: _in_dtype(rng.normal(size=mshape + v).astype(
        np.float32), "bfloat16") for k, v in shapes.items()}
    want, got = _two_steps(mshape, 0.1, mk(), mk())
    for w_leaves, g_leaves in zip(want, got):
        for w, g in zip(w_leaves, g_leaves):
            assert g.dtype == torch.bfloat16
            assert np.array_equal(_bits(g), _bits(w))


def test_from_config_routes_sparse_innetwork_to_the_switch():
    mesh = RankMesh((2, 4))
    cfg = FlareConfig(**_sparse_cfg(0.05), density_threshold=0.5)
    t = transports.from_config(cfg, mesh, torch.float32)
    assert isinstance(t, transports.SwitchTransport) and t.mode == "sparse"
    assert (t.k_frac, t.density_threshold) == (0.05, 0.5)
    # sparse before int8, as in the reference; integers ride dense
    both = FlareConfig(**_sparse_cfg(0.05), compression="int8")
    assert transports.from_config(both, mesh, torch.bfloat16).mode == "sparse"
    assert transports.from_config(cfg, mesh, torch.int32).mode == "dense"
    # without transport="innetwork" the wire sparse transport, which gives
    # the reference's bits
    t = transports.from_config(FlareConfig(axes=AXES, sparse_k_frac=0.1),
                               mesh, torch.float32)
    assert isinstance(t, transports.SparseTransport)
    jt = jtransports.from_config(jengine.FlareConfig(axes=AXES,
                                                     sparse_k_frac=0.1),
                                 jnp.float32)
    x = np.random.default_rng(14).normal(size=(2, 4, 2, 300)).astype(
        np.float32)
    want = _nested(lambda a: jt(a, jnp.zeros_like(a), jnp.arange(2),
                                (300, 200)))(x)
    got = t(torch.from_numpy(x.copy()), None, torch.arange(2), (300, 200))
    for g, w in zip(got, want):
        assert np.array_equal(_bits(g), _bits(w))
