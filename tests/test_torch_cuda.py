"""The port on the card: the CUDA kernels against their plain versions,
the whole reduction on the GPU against the same reduction on the CPU
(the reproducible dense path, the int8 path and the sparse path, the
last two with their state, in the network and on the wire; the
in-network planes over a lossy fabric), and the train step on the GPU
against the same step on the CPU.

Every test here needs an NVIDIA GPU and skips without one.  The file
imports no JAX, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance is zero throughout: each kernel computes in the plain version's
order and rounds the same way.  Two exceptions, both stated where they
apply: NaN payloads are not compared, and ``sparse_accum_slots`` on
unsorted lists adds three or more duplicates of an index in the
hardware's order (``rtol = atol = 1e-5``, the reference's own tolerance).
The flash attention kernels sum in another order than their plain
version: fp32 outputs (the 3xTF32 kernel, the decode kernel) are held
at ``atol = 3e-5`` (the reference's own tolerance for it), bf16 outputs
(the tensor-core kernel, the decode kernel) to one bf16 ulp of the plain
version computed from the same bf16 inputs, plus the fp32 sums' rounding
floor where an output nearly cancels.  The backward kernel rounds its
probabilities and their gradients to bf16 as product operands: its bf16
gradients are held within 2e-2 of each one's largest, its fp32 ones (three
TF32 products a product) within 1e-4.
"""
from unittest import mock

import pytest
import torch

from repro_torch import tree
from repro_torch.configs import tinyllama_1_1b as tl
from repro_torch.core.engine import FlareConfig, GradReducer
from repro_torch.kernels import flash_attn as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels import quant as qt
from repro_torch.kernels import sparse_accum as sa
from repro_torch.kernels import topk_compact as tk
from repro_torch.kernels import tree_reduce as tr
from repro_torch.mesh import AXES, FLAT, TWO_LEVEL, RankMesh
from repro_torch.models import transformer

torch.set_num_threads(1)

_INT = {1: torch.int8, 2: torch.int16, 4: torch.int32}


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.view(_INT[a.element_size()]).cpu(),
                            b.view(_INT[b.element_size()]).cpu()))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16",
                                   "int32"])
def test_kernel_matches_plain_on_cuda(cuda, dtype):
    """Every P up to 64 (3 padded), G > 1, ragged rows (the scalar path),
    a stack strided over the rank axes, and -0.0 rows."""
    dt = getattr(torch, dtype)
    for p in (1, 2, 3, 4, 8, 64):
        for s, e in ((5, 256), (3, 100)):
            if dt == torch.int32:
                x = torch.randint(-2**31, 2**31 - 1, (3, p, s, e),
                                  generator=cuda, device="cuda", dtype=dt)
            else:
                x = torch.randn((3, p, s, e), generator=cuda,
                                device="cuda").to(dt)
                x[0, :, 0, :4] = -0.0
            got = ops.tree_reduce_slots(x)
            torch.cuda.synchronize()
            assert _same_bits(got, ops.tree_reduce_slots_plain(x)), (p, s, e)
    strided = torch.randint(-9, 9, (2, 4, 6, 256), generator=cuda,
                            device="cuda").to(dt).movedim(0, 1)
    assert _same_bits(ops.tree_reduce_slots(strided),
                      ops.tree_reduce_slots_plain(strided))


@pytest.mark.cuda
@pytest.mark.parametrize("mshape", [FLAT, TWO_LEVEL])
def test_grad_reducer_on_cuda_matches_cpu(cuda, mshape):
    """GradReducer on the GPU launches the kernel and gives the bits the
    plain fold gives on the CPU, on the SMOKE model's gradient tree."""
    params = transformer.init_params(tl.SMOKE, cuda)
    grads = tree.map_leaves(lambda p: torch.randn(
        (*mshape, *p.shape), generator=cuda, device="cuda"), params)
    red = GradReducer(FlareConfig(axes=AXES, transport="innetwork",
                                  reproducible=True), RankMesh(mshape))
    tr.launches = 0
    out, _ = red(grads)
    torch.cuda.synchronize()
    assert tr.launches == (1 if mshape == FLAT else 2)
    want, _ = red(tree.map_leaves(lambda g: g.cpu(), grads))
    for g, w in zip(tree.flatten(out)[0], tree.flatten(want)[0]):
        assert _same_bits(g.contiguous(), w.contiguous())


def _same_or_both_nan(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise, except that a NaN matches any NaN (scales of NaN blocks)."""
    a, b = a.cpu(), b.cpu()
    nan = torch.isnan(a)
    return (torch.equal(nan, torch.isnan(b))
            and _same_bits(torch.where(nan, 0.0, a), torch.where(nan, 0.0, b)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_quantize_and_dequantize_kernels_match_plain_on_cuda(cuda, dtype):
    """Quantize over every built block size, with zero, tie, NaN and inf
    blocks (scales only where a block holds NaN or inf), a row-strided
    view, and dequantize with and without the residual, in place too."""
    dt = getattr(torch, dtype)
    for qblock in qt.QBLOCKS:
        x = (torch.randn((6, 4 * qblock), generator=cuda, device="cuda")
             * 50).to(dt)
        x[0, :qblock] = 0.0
        x[1, :qblock] = torch.arange(qblock, device="cuda").to(dt) % 7 - 3.5
        x[1, 0] = 127.0
        x[2, 5], x[3, qblock + 1] = float("nan"), float("inf")
        q, s = ops.quantize(x, qblock)
        pq, ps = ops.quantize_plain(x, qblock)
        torch.cuda.synchronize()
        assert _same_or_both_nan(s, ps), qblock
        assert _same_bits(q[4:], pq[4:]) and _same_bits(q[:2], pq[:2])
        for out_dtype in (torch.float32, torch.bfloat16, torch.float16):
            assert _same_bits(ops.dequantize(q[4:], s[4:], qblock, out_dtype),
                              ops.dequantize_plain(q[4:], s[4:], qblock,
                                                   out_dtype))
        v = x[4:].contiguous()
        want = ops.dequantize_plain(q[4:], s[4:], qblock, minuend=v)
        assert _same_bits(ops.dequantize(q[4:], s[4:], qblock, minuend=v),
                          want)
        assert ops.dequantize(q[4:], s[4:], qblock, minuend=v, out=v) is v
        assert _same_bits(v, want)
    wide = torch.randn((3, 2048 + 512), generator=cuda, device="cuda").to(dt)
    rows = wide[:, 256:2304]                        # rows a stride apart
    for a, b in zip(ops.quantize(rows), ops.quantize_plain(rows)):
        assert _same_bits(a, b)


@pytest.mark.cuda
def test_dequant_accum_kernel_matches_plain_on_cuda(cuda):
    """Every fan-in P = 1..8 in a runtime loop, G = 3, strided G and P
    (the multi design's round-robin views), and the flat form."""
    for p in (1, 2, 3, 4, 5, 8):
        q = torch.randint(-127, 128, (3, p, 5, 1024), generator=cuda,
                          device="cuda", dtype=torch.int8)
        s = torch.rand((3, p, 5, 4), generator=cuda, device="cuda") * 4
        assert _same_bits(ops.dequant_accum_slots(q, s),
                          ops.dequant_accum_slots_plain(q, s)), p
        assert _same_bits(ops.dequant_accum_slots(q[:, ::2], s[:, ::2]),
                          ops.dequant_accum_slots_plain(q[:, ::2], s[:, ::2]))
        qt_, st_ = q.movedim(0, 1), s.movedim(0, 1)     # (G=p, P=3) view
        assert _same_bits(ops.dequant_accum_slots(qt_, st_),
                          ops.dequant_accum_slots_plain(qt_, st_))
        flat, fs = q[0].reshape(p, -1), s[0].reshape(p, -1)
        assert _same_bits(ops.dequant_accum(flat, fs),
                          ops.dequant_accum_plain(flat, fs))


@pytest.mark.cuda
@pytest.mark.parametrize("tree_name", ["smoke", "wide"])
@pytest.mark.parametrize("mshape", [FLAT, TWO_LEVEL])
def test_int8_grad_reducer_on_cuda_matches_cpu(cuda, mshape, tree_name):
    """Two steps of the int8 in-network reduction with the state carried:
    the card launches the int8 kernels and gives the CPU's bits.  The
    SMOKE model's small tree takes the ``tree`` design (dequantize, then
    the fixed-tree fold); a 600,000-element tree takes ``single``, the
    main path's design (the ``dequant_accum_slots`` fold)."""
    if tree_name == "smoke":
        params = transformer.init_params(tl.SMOKE, cuda)
        fold = lambda: tr.launches
    else:
        params = {"w": torch.zeros(600, 1000), "b": torch.zeros(64)}
        fold = lambda: qt.launches["dequant_accum_slots"]
    mk = lambda: tree.map_leaves(lambda p: torch.randn(
        (*mshape, *p.shape), generator=cuda, device="cuda"), params)
    g1, g2 = mk(), mk()
    red = GradReducer(FlareConfig(axes=AXES, transport="innetwork",
                                  compression="int8"), RankMesh(mshape))
    for k in qt.launches:
        qt.launches[k] = 0
    tr.launches = 0
    r1, st = red(g1)
    r2, st = red(g2, st)
    torch.cuda.synchronize()
    assert qt.launches["quantize"] > 0 and qt.launches["dequantize"] > 0
    assert fold() > 0
    cpu = lambda t: tree.map_leaves(lambda a: a.cpu(), t)
    w1, wst = red(cpu(g1))
    w2, wst = red(cpu(g2), wst)
    for got, want in ((r1, w1), (r2, w2), (st, wst)):
        for g, w in zip(tree.flatten(got)[0], tree.flatten(want)[0]):
            assert _same_bits(g.contiguous(), w.contiguous())


def _sorted_lists(gen, rows, e, size, fill):
    """The sparse data plane's list form: ascending as unsigned integers,
    ``fill·e`` distinct indices (some at and past ``size``) then a ``-1``
    tail; entries 1 and 2 of each row share an index."""
    idx = torch.full((rows, e), -1, dtype=torch.int32, device="cuda")
    m = int(fill * e)
    for r in range(rows):
        pick = torch.randperm(size + 50, generator=gen, device="cuda")[:m]
        idx[r, :m] = pick.sort().values.int()
    idx[:, 1] = idx[:, 2]
    return idx


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_sparse_accum_kernel_matches_plain_on_cuda(cuda, dtype):
    """Sorted lists (bitwise, duplicates too) with -1 tails and entries at
    and past ``size``, B = 1, 3 and a strided (G, B) stack, a ragged size;
    unsorted lists bitwise with pairs of duplicates and within the
    reference's tolerance with more."""
    dt = getattr(torch, dtype)
    for b, e, size in ((1, 700, 9000), (3, 5000, 20_000), (3, 64, 100)):
        idx = _sorted_lists(cuda, b, e, size, 0.8)
        val = torch.randn((b, e), generator=cuda, device="cuda").to(dt)
        got = ops.sparse_accum_slots(idx, val, size, indices_sorted=True)
        torch.cuda.synchronize()
        assert _same_bits(got, ops.sparse_accum_slots_plain(idx, val, size))
        mixed = idx.flip(1).contiguous()           # unsorted, pairs only
        assert _same_bits(ops.sparse_accum_slots(mixed, val.flip(1)
                                                 .contiguous(), size),
                          ops.sparse_accum_slots_plain(mixed, val.flip(1),
                                                       size))
    lists = torch.randint(0, 50, (4, 2, 300), generator=cuda, device="cuda",
                          dtype=torch.int32)         # many duplicates
    vals = torch.randn((4, 2, 300), generator=cuda, device="cuda").to(dt)
    got = ops.sparse_accum_slots(lists.movedim(0, 1), vals.movedim(0, 1), 64)
    want = ops.sparse_accum_slots_plain(lists.movedim(0, 1),
                                        vals.movedim(0, 1), 64)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    flat = ops.sparse_accum(lists[0, 0], vals[0, 0], 64)
    torch.testing.assert_close(flat, want[0, 0], rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_topk_compact_kernel_matches_plain_on_cuda(cuda, dtype):
    """k = 1, 2, 8, 64, block - 1 and block, every block size: ties,
    zero blocks, ±0.0, inf and NaN blocks, the cluster (one 1e6, the rest
    in [1, 1.0001]: the cap by index order decides), all-NaN and all-inf
    blocks (NaN payloads not compared), a ragged length."""
    dt = getattr(torch, dtype)
    for block in tk.BLOCKS:
        for k in sorted({1, 2, 8, 64, block - 1, block}):
            if not 1 <= k <= block:
                continue
            x = torch.randn((12, block), generator=cuda, device="cuda")
            x[1] = torch.randint(-3, 4, (block,), generator=cuda,
                                 device="cuda") / 2
            x[2] = 0.0
            x[3, ::2] = -0.0
            x[4, 0], x[5, block - 1] = float("inf"), float("nan")
            x[6, 1], x[6, 2] = float("-inf"), float("inf")
            x[8] = 1 + 1e-4 * torch.rand(block, generator=cuda,
                                         device="cuda")
            x[8, block // 3] = 1e6
            x[9] = float("nan")
            x[10] = float("inf")
            x[10, ::3] = float("-inf")
            x = x.to(dt).reshape(-1)[:-3]             # ragged: padded
            v, i = ops.topk_compact(x, k, block)
            pv, pi = ops.topk_compact_plain(
                torch.cat([x, x.new_zeros(3)]), k, block)
            torch.cuda.synchronize()
            assert torch.equal(i, pi), (block, k)
            assert _same_or_both_nan(v.float(), pv.float()), (block, k)
    x = torch.randn(8 * 512, generator=cuda, device="cuda").to(dt)
    v, g = ops.blockwise_sparsify(x, 1)
    assert (g >= 0).sum() == 8
    dense = ops.sparse_accum(g, v, x.numel())
    assert _same_bits(dense, ops.sparse_accum_slots_plain(
        g[None], v[None], x.numel())[0])


@pytest.mark.cuda
@pytest.mark.parametrize("mshape", [FLAT, TWO_LEVEL])
@pytest.mark.parametrize("frac", [0.01, 0.3])
def test_sparse_grad_reducer_on_cuda_matches_cpu(cuda, mshape, frac):
    """Two steps of the sparse in-network reduction with the state
    carried, on the SMOKE model's tree: the card launches the densify
    kernel and gives the CPU's bits, lists to the root at 0.01 and a
    densify before level 1 at 0.3."""
    params = transformer.init_params(tl.SMOKE, cuda)
    mk = lambda: tree.map_leaves(lambda p: torch.randn(
        (*mshape, *p.shape), generator=cuda, device="cuda"), params)
    g1, g2 = mk(), mk()
    red = GradReducer(FlareConfig(axes=AXES, transport="innetwork",
                                  sparse_k_frac=frac), RankMesh(mshape))
    sa.launches["sparse_accum_slots"] = 0
    r1, st = red(g1, red.init_state(g1))
    r2, st = red(g2, st)
    torch.cuda.synchronize()
    assert sa.launches["sparse_accum_slots"] > 0
    cpu = lambda t: tree.map_leaves(lambda a: a.cpu(), t)
    w1, wst = red(cpu(g1), red.init_state(cpu(g1)))
    w2, wst = red(cpu(g2), wst)
    for got, want in ((r1, w1), (r2, w2), (st, wst)):
        for g, w in zip(tree.flatten(got)[0], tree.flatten(want)[0]):
            assert _same_bits(g.contiguous(), w.contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["dense", "int8", "sparse"])
def test_lossy_fabric_on_cuda_matches_cpu(cuda, mode):
    """The in-network planes over a lossy fabric on the card: under a plan
    that drops, corrupts, duplicates and reorders, the per-packet plane
    (checksums, corruption, seen-bitmaps on the card) under arrival
    permutations gives the batched plane's bits, the fault-free bits and
    the CPU's, with equal fault counters, and the fold kernels launch."""
    from repro_torch.switch import dataplane, packets as pk
    mesh = RankMesh(TWO_LEVEL)
    x = torch.randn((*mesh.shape, 3, 5000), generator=cuda, device="cuda")
    k = 64
    counts = dataplane.level_packet_counts(
        [4, 2], 3, 5000, torch.float32, mode=mode, k_max=k)
    plan = next(p for p in (pk.FaultPlan(seed=s, drop=0.05, corrupt=0.02,
                                         duplicate=0.3, reorder=0.5)
                            for s in range(200))
                if dataplane.plan_survives(p, counts)
                and any(sc.corrupt_rejected and sc.retransmits
                        for sc in dataplane.fault_schedules(p, counts)))

    def plane(a, **kw):
        if mode == "dense":
            return dataplane.switch_allreduce_dense(a, mesh, AXES,
                                                    reproducible=True, **kw)
        if mode == "int8":
            return dataplane.switch_allreduce_int8(a, mesh, AXES,
                                                   design="single", **kw)
        out = dataplane.switch_allreduce_sparse(a, mesh, AXES, k, **kw)
        return (out[0], out[-1]) if kw.get("with_fault_stats") else out[0]
    perms = [lambda p, n: torch.randperm(
        p * n, generator=torch.Generator().manual_seed(p)).reshape(n, p)
        .argsort(dim=1).T.numpy()] * 2
    tr.launches = qt.launches["dequant_accum_slots"] = 0
    sa.launches["sparse_accum_slots"] = 0
    batched, stats = plane(x, fault_plan=plan, with_fault_stats=True)
    torch.cuda.synchronize()
    assert {"dense": tr.launches,
            "int8": qt.launches["dequant_accum_slots"],
            "sparse": sa.launches["sparse_accum_slots"]}[mode] > 0
    slots, sstats = plane(x, fault_plan=plan, with_fault_stats=True,
                          batched=False, arrival_perms=perms)
    cpu, cstats = plane(x.cpu(), fault_plan=plan, with_fault_stats=True)
    assert _same_bits(batched, slots) and _same_bits(batched, plane(x))
    assert _same_bits(batched, cpu)
    for key in stats:
        assert torch.equal(stats[key].cpu(), sstats[key].cpu())
        assert torch.equal(stats[key].cpu(), cstats[key])


@pytest.mark.cuda
def test_dequant_accum_wire_order_matches_plain_on_cuda(cuda):
    """The wire protocol's order of the fold, ``q0·s0`` then ``fma(qi,
    si, acc)``, on the kernel and on its plain version."""
    before = qt.wire_launches
    for p in (1, 2, 3, 4, 8):
        q = torch.randint(-127, 128, (3, p, 5, 512), generator=cuda,
                          device="cuda", dtype=torch.int8)
        s = torch.rand((3, p, 5, 2), generator=cuda, device="cuda") * 4
        assert _same_bits(ops.dequant_accum_slots(q, s, wire_order=True),
                          ops.dequant_accum_slots_plain(q, s,
                                                        wire_order=True)), p
        flat, fs = q[0].reshape(p, -1), s[0].reshape(p, -1)
        assert _same_bits(ops.dequant_accum(flat, fs, wire_order=True),
                          ops.dequant_accum_plain(flat, fs, wire_order=True))
    assert qt.wire_launches == before + 10


@pytest.mark.cuda
def test_scatter_dense_launches_the_kernel_on_cuda(cuda):
    """``sparse.scatter_dense`` of sorted unique lists with a SENTINEL
    tail and -0.0 values: the kernel on the card, the CPU's bits, into
    fp32 and bf16."""
    from repro_torch.core import sparse
    idx = torch.rand((4, 20_050), generator=cuda, device="cuda").argsort(
        dim=1)[:, :900].sort(dim=1).values.int()
    idx = torch.cat([idx, torch.full((4, 100), sparse.SENTINEL,
                                     dtype=torch.int32, device="cuda")], 1)
    for dtype in (torch.float32, torch.bfloat16):
        val = torch.randn((4, 1000), generator=cuda, device="cuda").to(dtype)
        val[:, ::4] = -0.0
        before = sa.launches["sparse_accum_slots"]
        got = sparse.scatter_dense(val, idx, 20_000, dtype)
        assert sa.launches["sparse_accum_slots"] == before + 1
        assert _same_bits(got, sparse.scatter_dense(val.cpu(), idx.cpu(),
                                                    20_000, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("mshape", [FLAT, TWO_LEVEL])
@pytest.mark.parametrize("kw", [dict(compression="int8"),
                                dict(sparse_k_frac=0.01),
                                dict(sparse_k_frac=0.3)])
def test_lossy_wire_grad_reducer_on_cuda_matches_cpu(cuda, mshape, kw):
    """Two steps of the wire int8 and sparse reductions with the state
    carried, on the SMOKE model's tree: the card launches the kernels
    and gives the CPU's bits."""
    params = transformer.init_params(tl.SMOKE, cuda)
    mk = lambda: tree.map_leaves(lambda p: torch.randn(
        (*mshape, *p.shape), generator=cuda, device="cuda"), params)
    g1, g2 = mk(), mk()
    red = GradReducer(FlareConfig(axes=AXES, **kw), RankMesh(mshape))
    qt.wire_launches = sa.launches["sparse_accum_slots"] = 0
    r1, st = red(g1)
    r2, st = red(g2, st)
    torch.cuda.synchronize()
    assert (qt.wire_launches if "compression" in kw
            else sa.launches["sparse_accum_slots"]) > 0
    cpu = lambda t: tree.map_leaves(lambda a: a.cpu(), t)
    w1, wst = red(cpu(g1))
    w2, wst = red(cpu(g2), wst)
    for got, want in ((r1, w1), (r2, w2), (st, wst)):
        for g, w in zip(tree.flatten(got)[0], tree.flatten(want)[0]):
            assert _same_bits(g.contiguous(), w.contiguous())


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each value (8 significant bits)."""
    _, e = torch.frexp(x.float().abs().clamp_min(1e-30))
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def _assert_flash_close(got, want, v):
    """fp32: 3e-5.  bf16: one bf16 ulp of the plain output plus the fp32
    sums' rounding floor, 2^-17 · max|v| (both sum in fp32, in different
    orders; where an output nearly cancels, that rounding exceeds a bf16
    ulp of the tiny result)."""
    diff = (got.float() - want.float()).abs()
    if got.dtype == torch.float32:
        assert float(diff.max()) <= 3e-5
    else:
        floor = 2.0**-17 * float(v.float().abs().max())
        assert float((diff - _bf16_ulp(want)).max()) <= floor


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_matches_plain_on_cuda(cuda, dtype):
    """Causal and not, cap 0 and 30, window 0 and 64, GQA 1 and 4, head
    dims 16 and 64, ragged Sq and Sk (not multiples of the tiles)."""
    dt = getattr(torch, dtype)
    cases = 0
    for hd in (16, 64):
        for h, kv in ((4, 4), (4, 1)):
            for sq, sk, causal in ((200, 200, True), (100, 300, False),
                                   (77, 77, True)):
                for cap, win in ((0.0, 0), (30.0, 64)):
                    q = torch.randn((2, sq, h, hd), generator=cuda,
                                    device="cuda").to(dt)
                    k, v = (torch.randn((2, sk, kv, hd), generator=cuda,
                                        device="cuda").to(dt)
                            for _ in range(2))
                    w = win if causal else 0
                    got = ops.attention(q, k, v, causal=causal,
                                        attn_cap=cap, window=w)
                    want, _ = ref.flash_attention_bshd(
                        q, k, v, causal=causal, attn_cap=cap, window=w,
                        scale=hd ** -0.5)
                    torch.cuda.synchronize()
                    _assert_flash_close(got, want, v)
                    cases += 1
    assert cases == 24


@pytest.mark.cuda
@pytest.mark.parametrize("hd,vd", [(16, 16), (32, 32), (64, 64), (128, 128),
                                   (256, 256), (192, 128)])
def test_flash_tensor_core_kernel_matches_plain_on_cuda(cuda, hd, vd):
    """bf16 on the tensor cores at every (hd, vd) the kernel takes:
    causal and not, cap 0 and 30, window 0 and 64, GQA 4/4 and 4/1,
    ragged Sq and Sk, Sq > Sk (with the window, rows past Sk + 63 see no
    key and average every value); every launch is the tensor-core
    kernel's."""
    cases = 0
    for h, kv in ((4, 4), (4, 1)):
        for sq, sk, causal in ((200, 200, True), (100, 300, False),
                               (77, 77, True), (260, 130, True)):
            for cap, win in ((0.0, 0), (30.0, 64)):
                q = torch.randn((2, sq, h, hd), generator=cuda,
                                device="cuda").bfloat16()
                k = torch.randn((2, sk, kv, hd), generator=cuda,
                                device="cuda").bfloat16()
                v = torch.randn((2, sk, kv, vd), generator=cuda,
                                device="cuda").bfloat16()
                w = win if causal else 0
                before = fa.tc_launches
                got = ops.attention(q, k, v, causal=causal, attn_cap=cap,
                                    window=w)
                assert fa.tc_launches == before + 1
                want, _ = ref.flash_attention_bshd(
                    q, k, v, causal=causal, attn_cap=cap, window=w,
                    scale=hd ** -0.5)
                torch.cuda.synchronize()
                assert got.shape == (2, sq, h, vd)
                _assert_flash_close(got, want, v)
                cases += 1
    assert cases == 16


@pytest.mark.cuda
def test_flash_tensor_core_kernel_takes_strided_views_on_cuda(cuda):
    """Views whose strides TMA can read (multiples of 8 elements) go to
    the kernel as they are: q a slice of wider heads, k and v two halves
    of one packed tensor."""
    q = torch.randn((2, 150, 4, 128), generator=cuda,
                    device="cuda").bfloat16()[..., :64]
    kv = torch.randn((2, 150, 2, 2, 64), generator=cuda,
                     device="cuda").bfloat16()
    k, v = kv[:, :, 0], kv[:, :, 1]
    assert not (q.is_contiguous() or k.is_contiguous())
    before = fa.tc_launches
    got = ops.attention(q, k, v, causal=True, attn_cap=30.0, window=64)
    assert fa.tc_launches == before + 1
    want, _ = ref.flash_attention_bshd(q, k, v, causal=True, attn_cap=30.0,
                                       window=64)
    torch.cuda.synchronize()
    _assert_flash_close(got, want, v)


@pytest.mark.cuda
def test_flash_kernel_routes_by_dtype_on_cuda(cuda):
    """Past 64 query rows a KV group bf16 goes to the wgmma kernel, fp32
    to the 3xTF32 one (``fp32_launches``); at 64 rows both go to the
    decode kernel."""
    for sq, dec in ((65, 0), (64, 1)):
        q = torch.randn((1, sq, 2, 64), generator=cuda, device="cuda")
        before = (fa.launches, fa.tc_launches, fa.decode_launches,
                  fa.fp32_launches)
        fa.attention_fwd(q.bfloat16(), q.bfloat16(), q.bfloat16(),
                         causal=True, scale=0.125, attn_cap=0.0, window=0)
        assert (fa.launches, fa.tc_launches, fa.decode_launches,
                fa.fp32_launches) == (
            before[0] + 1, before[1] + 1 - dec, before[2] + dec, before[3])
        fa.attention_fwd(q, q, q, causal=True, scale=0.125, attn_cap=0.0,
                         window=0)
        assert (fa.launches, fa.tc_launches, fa.decode_launches,
                fa.fp32_launches) == (
            before[0] + 2, before[1] + 1 - dec, before[2] + 2 * dec,
            before[3] + 1 - dec)


@pytest.mark.cuda
def test_flash_kernel_raises_on_what_neither_kernel_takes_on_cuda(cuda):
    """A head dim no kernel has (in either dtype), another dtype, mixed
    dtypes at the kernel's entry (only ``ops.attention`` upcasts a bf16
    query over fp32 K/V) and strides TMA cannot read raise, and launch
    nothing (65 query rows a KV group: not a decode launch); fp32 at
    (256, 256), which no fp32 kernel took before the 3xTF32 one, launches
    and holds the plain version."""
    def qkv(hd, vd, dtype, pad=0):
        q = torch.randn((1, 65, 2, hd + pad), generator=cuda,
                        device="cuda").to(dtype)[..., :hd]
        v = torch.randn((1, 65, 2, vd), generator=cuda,
                        device="cuda").to(dtype)
        return q, q, v
    before, fp32 = fa.launches, fa.fp32_launches
    q, k, v = qkv(128, 128, torch.float32)
    with pytest.raises(ValueError, match="dtypes"):
        fa.attention_fwd(q.bfloat16(), k, v, causal=True, scale=0.125,
                         attn_cap=0.0, window=0)
    with pytest.raises(ValueError, match="dtypes"):
        ops.attention(q.half(), k, v, causal=True)
    for hd, vd, dtype, pad, what in (
            (48, 48, torch.float32, 0, "not in"),
            (48, 48, torch.bfloat16, 0, "not in"),
            (128, 64, torch.bfloat16, 0, "not in"),
            (64, 64, torch.float16, 0, "dtypes"),
            (64, 64, torch.bfloat16, 4, "TMA")):
        with pytest.raises(ValueError, match=what):
            fa.attention_fwd(*qkv(hd, vd, dtype, pad), causal=True,
                             scale=0.125, attn_cap=0.0, window=0)
    assert fa.launches == before
    q, k, v = qkv(256, 256, torch.float32)
    got, lse = fa.attention_fwd(q, k, v, causal=True, scale=0.0625,
                                attn_cap=50.0, window=0)
    assert (fa.launches, fa.fp32_launches - fp32) == (before + 1, 1)
    want, plse = ref.flash_attention_bshd(q, k, v, causal=True, scale=0.0625,
                                          attn_cap=50.0)
    torch.cuda.synchronize()
    _assert_flash_close(got, want, v)
    assert float((lse - plse).abs().max()) <= 3e-5


@pytest.mark.cuda
def test_flash_kernel_lse_and_public_signature_on_cuda(cuda):
    q, k, v = (torch.randn((6, 300, 64), generator=cuda, device="cuda")
               for _ in range(3))
    before = fa.launches
    got = ops.flash_attention(q, k, v, causal=True, attn_cap=30.0,
                              window=100)
    assert fa.launches == before + 1
    want = ref.flash_attention(q, k, v, causal=True, attn_cap=30.0,
                               window=100)
    assert float((got - want).abs().max()) <= 3e-5
    o, lse = fa.attention_fwd(q.unsqueeze(2), k.unsqueeze(2), v.unsqueeze(2),
                              causal=True, scale=0.125, attn_cap=30.0,
                              window=100)
    _, plse = ref.flash_attention_bshd(q.unsqueeze(2), k.unsqueeze(2),
                                       v.unsqueeze(2), causal=True,
                                       scale=0.125, attn_cap=30.0,
                                       window=100)
    assert fa.launches == before + 2
    assert float((lse - plse).abs().max()) <= 3e-5


@pytest.mark.cuda
def test_flash_function_gradient_matches_plain_autograd_on_cuda(cuda):
    """The kernel's autograd Function (the backward kernel,
    ``csrc/flash_bwd.cu``, one launch a backward) against autograd
    through the plain forward, fp32, GQA 4/2."""
    for causal, cap, win in ((True, 0.0, 0), (True, 30.0, 50),
                             (False, 0.0, 0)):
        before = fa.bwd_launches
        q = torch.randn((2, 300, 4, 64), generator=cuda, device="cuda")
        k, v = (torch.randn((2, 300, 2, 64), generator=cuda, device="cuda")
                for _ in range(2))
        do = torch.randn((2, 300, 4, 64), generator=cuda, device="cuda")
        ins = [t.clone().requires_grad_() for t in (q, k, v)]
        out = ops.attention(*ins, causal=causal, attn_cap=cap, window=win)
        got = torch.autograd.grad(out, ins, do)
        pins = [t.clone().requires_grad_() for t in (q, k, v)]
        pout, _ = ref.flash_attention_bshd(*pins, causal=causal,
                                           attn_cap=cap, window=win)
        want = torch.autograd.grad(pout, pins, do)
        assert fa.bwd_launches == before + 1
        for g, w in zip(got, want):
            assert float((g - w).abs().max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("sq,sk,h,kv,dtype", [
    (300, 1500, 4, 2, "float32"), (1500, 300, 4, 2, "float32"),
    (300, 1500, 16, 16, "bfloat16")])
def test_flash_function_gradient_at_sq_ne_sk_matches_plain_autograd_on_cuda(
        cuda, sq, sk, h, kv, dtype):
    """Non-causal attention with ``Sq != Sk`` under training, as
    whisper's cross-attention runs it (its decoder queries over 1500
    encoder keys): the kernel's autograd Function (the backward kernel)
    against autograd through the plain forward.  Neither 300
    nor 1500 is a multiple of the kernel's 128-row query block or its key
    tile, so both ragged tails are live.  fp32 at GQA 4/2 within 1e-4 (the
    sibling's bound); bf16 on the tensor-core kernel at whisper's 16
    heads, hd 64, each gradient within 2e-2 of its largest (bf16)."""
    dt = getattr(torch, dtype)
    q = torch.randn((2, sq, h, 64), generator=cuda, device="cuda").to(dt)
    k, v = (torch.randn((2, sk, kv, 64), generator=cuda, device="cuda")
            .to(dt) for _ in range(2))
    do = torch.randn((2, sq, h, 64), generator=cuda, device="cuda").to(dt)
    before = (fa.launches, fa.tc_launches, fa.bwd_launches)
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ops.attention(*ins, causal=False)
    got = torch.autograd.grad(out, ins, do)
    assert (fa.launches - before[0], fa.tc_launches - before[1],
            fa.bwd_launches - before[2]) == (1, int(dt == torch.bfloat16), 1)
    pins = [t.clone().requires_grad_() for t in (q, k, v)]
    pout, _ = ref.flash_attention_bshd(*pins, causal=False)
    want = torch.autograd.grad(pout, pins, do)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == dt
        err = float((g.float() - w.float()).abs().max())
        if dt == torch.float32:
            assert err <= 1e-4
        else:
            assert err <= 2e-2 * float(w.float().abs().max())


@pytest.mark.cuda
def test_flash_fp32_kernel_at_hd_128_matches_plain_on_cuda(cuda):
    """The fp32 kernel at (128, 128), the VLM's cross width: causal and
    not, ``Sq != Sk``, GQA 8/8 and 8/1, cap 0 and 30, window 0 and 64,
    ragged lengths; one launch of the 3xTF32 kernel each, within 3e-5,
    and its log-sum-exp too."""
    cases = 0
    for h, kv in ((8, 8), (8, 1)):
        for sq, sk, causal in ((300, 300, True), (100, 333, False),
                               (77, 1600, False), (129, 129, True)):
            for cap, win in ((0.0, 0), (30.0, 64)):
                q = torch.randn((2, sq, h, 128), generator=cuda,
                                device="cuda")
                k, v = (torch.randn((2, sk, kv, 128), generator=cuda,
                                    device="cuda") for _ in range(2))
                w = win if causal else 0
                before = (fa.launches, fa.tc_launches, fa.fp32_launches)
                got, lse = fa.attention_fwd(q, k, v, causal=causal,
                                            scale=128 ** -0.5, attn_cap=cap,
                                            window=w)
                assert (fa.launches, fa.tc_launches, fa.fp32_launches) == (
                    before[0] + 1, before[1], before[2] + 1)
                want, plse = ref.flash_attention_bshd(
                    q, k, v, causal=causal, attn_cap=cap, window=w,
                    scale=128 ** -0.5)
                torch.cuda.synchronize()
                _assert_flash_close(got, want, v)
                assert float((lse - plse).abs().max()) <= 3e-5
                cases += 1
    assert cases == 16


@pytest.mark.cuda
@pytest.mark.parametrize("dims", fa.TC_DIMS)
def test_flash_tf32_kernel_matches_plain_at_every_dim_pair_on_cuda(cuda,
                                                                   dims):
    """The fp32 kernel (three TF32 products on the tensor cores) at every
    (hd, vd): causal, the window with the cap at 50, not causal over
    ``Sq != Sk``, lengths off the 64- and 32-key tiles and the 128- and
    64-row blocks, GQA 8/1 and 4/4; a partial launch (``shards=``) over an
    ``(N, B)`` cache's strided layer slice, keyless rows and all; the
    VLM's cross case (GQA 8, 1600 keys, not causal) with K and V 4 bytes
    off 16 (the 4-byte copies).  Each launch on the 3xTF32 kernel, twice
    with the same bits, ``o`` and ``lse`` within 3e-5 of the plain
    version."""
    hd, vd = dims

    def launch(q, k, v, **kw):
        before = (fa.launches, fa.fp32_launches, fa.tc_launches,
                  fa.decode_launches)
        got = fa.attention_fwd(q, k, v, **kw)
        again = fa.attention_fwd(q, k, v, **kw)
        assert (fa.launches, fa.fp32_launches, fa.tc_launches,
                fa.decode_launches) == (before[0] + 2, before[1] + 2,
                                        before[2], before[3])
        assert _same_bits(got[0], again[0]) and _same_bits(got[1], again[1])
        return got

    def randn(*shape):
        return torch.randn(shape, generator=cuda, device="cuda")
    for h, kv in ((8, 1), (4, 4)):
        for sq, sk, causal, cap, win in ((300, 300, True, 0.0, 0),
                                         (129, 333, True, 50.0, 100),
                                         (200, 77, False, 30.0, 0)):
            q, k, v = randn(2, sq, h, hd), randn(2, sk, kv, hd), randn(
                2, sk, kv, vd)
            kw = dict(causal=causal, scale=hd ** -0.5, attn_cap=cap,
                      window=win)
            o, lse = launch(q, k, v, **kw)
            want, plse = ref.flash_attention_bshd(q, k, v, **kw)
            torch.cuda.synchronize()
            _assert_flash_close(o, want, v)
            assert float((lse - plse).abs().max()) <= 3e-5
    # partial: 2 data ranks x 4 shards of 75 keys, one layer of a
    # (ranks, L, B, Sk, KV, d) cache
    n, b, sk = 8, 2, 75
    k = randn(n, 2, b, sk, 2, hd)[:, 1]
    v = randn(n, 2, b, sk, 2, vd)[:, 1]
    q = randn(n, b, 128, 8, hd)
    kw = dict(shards=4, causal=True, attn_cap=50.0, window=64, q_offset=72,
              kv_len=200, scale=hd ** -0.5)
    got = launch(q, k, v, **kw)
    want = ref.flash_attention_partial(q, k, v, **kw)
    torch.cuda.synchronize()
    assert bool(torch.isinf(want[1]).any())
    _assert_partial_close(got, want, v)
    # the VLM's cross layer, K and V off 16 bytes
    q = randn(2, 100, 16, hd)
    k, v = (randn(2, 1600, 2, d + 1)[..., 1:] for d in (hd, vd))
    assert k.data_ptr() % 16 and v.data_ptr() % 16
    kw = dict(causal=False, scale=hd ** -0.5, attn_cap=0.0, window=0)
    o, lse = launch(q, k, v, **kw)
    want, plse = ref.flash_attention_bshd(q, k, v, **kw)
    torch.cuda.synchronize()
    _assert_flash_close(o, want, v)
    assert float((lse - plse).abs().max()) <= 3e-5


@pytest.mark.cuda
def test_flash_bf16_query_over_fp32_kv_takes_the_fp32_kernel_on_cuda(cuda):
    """The VLM's cross layers: bf16 queries over fp32 K/V (non-causal,
    1600 keys, GQA 8) through ``base.attend`` and ``ops.attention`` go to
    the fp32 kernel (no tensor-core launch), bf16 out, within one bf16
    ulp of the CPU's dense ``attend`` on the same inputs (the scale
    rounded to bf16 in both); masked decode over them as well."""
    from repro_torch.models import base
    q = (torch.randn((2, 64, 16, 128), generator=cuda, device="cuda")
         * 4).bfloat16()
    k, v = (torch.randn((2, 1600, 2, 128), generator=cuda, device="cuda")
            for _ in range(2))
    before = (fa.launches, fa.tc_launches)
    got = base.attend(q, k, v, causal=False)
    assert (fa.launches, fa.tc_launches) == (before[0] + 1, before[1])
    assert got.dtype == torch.bfloat16
    want = base.attend(q.cpu(), k.cpu(), v.cpu(), causal=False)
    _assert_flash_close(got.cpu(), want, v.cpu())
    dec = fa.decode_launches
    got = ops.attention(q[:, :1], k, v, causal=True, q_offset=900,
                        kv_len=901)
    want, _ = ref.flash_attention_bshd(q[:, :1], k, v, causal=True,
                                       q_offset=900, kv_len=901)
    torch.cuda.synchronize()
    assert (fa.launches, fa.tc_launches) == (before[0] + 2, before[1])
    assert fa.decode_launches == dec + 1
    _assert_flash_close(got, want, v)


def _mla_qkv(gen, b, s, h=16, nope=128, rope=64, vd=128):
    """MLA's expanded attention inputs as ``transformer._mla_layer`` makes
    them: q and k concatenated (contiguous), v a strided view of the
    up-projection (head stride nope + vd, base 128 elements in)."""
    ukv = torch.randn((b, s, h, nope + vd), generator=gen,
                      device="cuda").bfloat16()
    k_r = torch.randn((b, s, 1, rope), generator=gen, device="cuda"
                      ).bfloat16()
    k = torch.cat([ukv[..., :nope], k_r.expand(b, s, h, rope)], -1)
    q = torch.randn((b, s, h, nope + rope), generator=gen,
                    device="cuda").bfloat16()
    return q, k, ukv[..., nope:]


@pytest.mark.cuda
def test_flash_mla_strided_value_view_on_cuda(cuda):
    """(192, 128) with MLA's ``v`` a view of the up-projection: its base
    256 bytes in, head stride 256 and sequence stride 4096 elements, all
    TMA can read, so it goes to the tensor-core kernel uncopied."""
    q, k, v = _mla_qkv(cuda, 2, 300)
    assert not v.is_contiguous() and v.stride()[1:] == (4096, 256, 1)
    assert (v.data_ptr() - v._base.data_ptr()) == 256
    before = fa.tc_launches
    got = ops.attention(q, k, v, causal=True, scale=192 ** -0.5)
    assert fa.tc_launches == before + 1
    want, _ = ref.flash_attention_bshd(q, k, v, causal=True,
                                       scale=192 ** -0.5)
    torch.cuda.synchronize()
    _assert_flash_close(got, want, v)


@pytest.mark.cuda
def test_flash_function_gradient_at_mla_dims_on_cuda(cuda):
    """``FlashAttention`` at (192, 128), MLA's strided ``v`` and the rope
    key broadcast over the heads: the gradients of q, the up-projection
    and the shared rope key (summed over the 16 heads), through the
    forward and backward kernels (``v`` read where it lies), against
    autograd through the plain forward from the same bf16 inputs, within
    2e-2 of each one's largest (the kernel's forward is within a bf16 ulp
    of the plain one, its backward rounds P and dS to bf16, and the
    gradients reach the fp32 leaves through bf16)."""
    q, k, v = _mla_qkv(cuda, 2, 256)
    do = torch.randn((2, 256, 16, 128), generator=cuda, device="cuda"
                     ).bfloat16()
    grads = []
    for fn in (lambda q, k, v: ops.attention(q, k, v, causal=True,
                                             scale=192 ** -0.5),
               lambda q, k, v: ref.flash_attention_bshd(
                   q, k, v, causal=True, scale=192 ** -0.5)[0]):
        ukv = torch.cat([k[..., :128], v], -1).float().requires_grad_()
        k_r = k[:, :, :1, 128:].float().requires_grad_()
        qq = q.float().requires_grad_()
        ub = ukv.bfloat16()
        kk = torch.cat([ub[..., :128],
                        k_r.bfloat16().expand(2, 256, 16, 64)], -1)
        out = fn(qq.bfloat16(), kk, ub[..., 128:])
        grads.append(torch.autograd.grad(out, (qq, ukv, k_r), do))
    for g, w in zip(*grads):
        assert float((g - w).abs().max()) <= 2e-2 * float(w.abs().max())


#: the backward kernels' cases: B, Sq, Sk, H, KV, causal, cap, window,
#: and the values before ``v`` in each head of the tensor it is a view of
#: (0: ``v`` contiguous; MLA's ``v`` is such a strided view); lengths ragged
#: against every tile (``flash_attn.BWD_TILES``: the bf16 dK/dV kernel's
#: 64 or 128 keys a block, 64 keys a consumer and 32 or 64 query rows a
#: stage, its dQ kernel's 128 rows a block, 64 a consumer and 32-128
#: keys a stage; ``flash_attn.BWD_TF32_TILES``: the fp32 dK/dV kernel's 64
#: keys a block and 32 query rows a stage (16 at hd 128), whole for one
#: of two consumers in turn (half for each at hd 128),
#: its dQ kernel's 128 rows a block (64 at hd 128) and 32 keys a stage (16
#: at hd 128); at the wide pairs 64 keys a dK/dV block and 16 query rows a
#: stage, 64 rows a dQ block and 16 keys a stage), GQA 8/8, 8/4, 8/2 and
#: 8/1, a block of many query tiles under a window; gemma2's cap 50 with a
#: window over GQA 8/4 and deepseek's 16 heads with ``v`` 128 values into
#: each head of its tensor
_BWD_CASES = ((2, 300, 300, 8, 8, True, 0.0, 0, 0),
              (1, 300, 300, 8, 2, True, 30.0, 100, 0),
              (2, 200, 333, 8, 2, False, 0.0, 0, 0),
              (1, 333, 200, 8, 8, False, 50.0, 0, 0),
              (1, 257, 257, 8, 2, True, 0.0, 64, 0),
              (1, 130, 130, 8, 1, True, 0.0, 0, 0),
              (2, 97, 161, 8, 1, False, 30.0, 0, 64),
              (1, 700, 700, 4, 4, True, 0.0, 300, 64),
              (1, 300, 300, 8, 4, True, 50.0, 200, 0),
              (1, 260, 260, 16, 16, True, 0.0, 0, 128))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dims", fa.TC_DIMS, ids=str)
def test_flash_backward_kernel_matches_plain_on_cuda(cuda, dtype, dims):
    """The backward kernels (``csrc/flash_bwd.cu``: bf16 on ``wgmma``,
    fp32 in three TF32 products on ``wgmma``, counted by
    ``bwd_tf32_launches`` at every pair, the wide ones included) at every
    ``TC_DIMS`` pair against their plain version
    ``ref.flash_attention_bwd`` on the same inputs and the
    forward kernel's ``o`` and log-sum-exp: causal and not, cap and
    window, GQA 8/8, 8/2 and 8/1, ragged ``Sq`` and ``Sk``, ``Sq != Sk``,
    a strided ``v``.  fp32 within 1e-4, bf16 each gradient within 2e-2 of its
    largest (the bounds of the gradient tests above).  Each launch twice
    with the same bits, ``bwd_launches`` up by one a launch, the plain
    version never called; and through the autograd Function the same
    bits again, one launch a backward."""
    hd, vd = dims
    dt = getattr(torch, dtype)
    for b, sq, sk, h, kv, causal, cap, win, v_in in _BWD_CASES:
        q = torch.randn((b, sq, h, hd), generator=cuda, device="cuda").to(dt)
        k = torch.randn((b, sk, kv, hd), generator=cuda, device="cuda").to(dt)
        v = torch.randn((b, sk, kv, v_in + vd), generator=cuda,
                        device="cuda").to(dt)[..., v_in:]
        do = torch.randn((b, sq, h, vd), generator=cuda, device="cuda").to(dt)
        kw = dict(causal=causal, scale=hd ** -0.5, attn_cap=cap, window=win)
        o, lse = fa.attention_fwd(q, k, v, **kw)
        before, tf32_before = fa.bwd_launches, fa.bwd_tf32_launches
        with mock.patch.object(ref, "flash_attention_bwd",
                               side_effect=AssertionError("plain called")):
            got = fa.attention_bwd(q, k, v, o, lse, do, **kw)
            again = fa.attention_bwd(q, k, v, o, lse, do, **kw)
            ins = [t.clone().requires_grad_() for t in (q, k, v)]
            out = fa.FlashAttention.apply(*ins, causal, kw["scale"], cap, win)
            viaf = torch.autograd.grad(out, ins, do)
        torch.cuda.synchronize()
        assert fa.bwd_launches == before + 3
        assert fa.bwd_tf32_launches - tf32_before == 3 * (
            dt == torch.float32)
        assert dims in fa.BWD_TF32_TILES
        for g, a, f in zip(got, again, viaf):
            assert _same_bits(g, a) and _same_bits(g, f)
        want = ref.flash_attention_bwd(q, k, v, lse, do, **kw)
        label = (dtype, dims, b, sq, sk, h, kv, causal, cap, win, v_in)
        for g, w, t in zip(got, want, (q, k, v)):
            assert g.shape == t.shape and g.dtype == w.dtype == dt, label
            err = float((g.float() - w.float()).abs().max())
            if dt == torch.float32:
                assert err <= 1e-4, (label, err)
            else:
                assert err <= 2e-2 * float(w.float().abs().max()), (label,
                                                                     err)


@pytest.mark.cuda
def test_flash_backward_kernel_refuses_what_it_cannot_take(cuda):
    """A row without a key under the window, a masked launch's gradient
    and a head-dim pair outside ``TC_DIMS`` raise, naming the shape;
    nothing falls back to the plain version."""
    q = torch.randn((1, 300, 2, 64), generator=cuda, device="cuda")
    kv = torch.randn((1, 100, 2, 64), generator=cuda, device="cuda")
    o = torch.zeros_like(q)
    lse = torch.zeros((1, 2, 300), device="cuda")
    with pytest.raises(ValueError, match="without a key"):
        fa.attention_bwd(q, kv, kv, o, lse, o, causal=True, scale=0.125,
                         attn_cap=0.0, window=50)
    q48 = torch.randn((1, 64, 2, 48), generator=cuda, device="cuda")
    with pytest.raises(ValueError, match="not in"):
        fa.attention_bwd(q48, q48, q48, q48, lse[..., :64], q48, causal=True,
                         scale=0.125, attn_cap=0.0, window=0)
    with pytest.raises(ValueError, match="forward-only"):
        ops.attention(q.requires_grad_(), kv, kv, causal=True, q_offset=4,
                      kv_len=100)


#: masked decode cases: (Sq, q_offset, kv_len) over a cache of 300 keys,
#: kv_len ragged against the kernel's 64-key tile; the last is the clamp
#: (a step past the cache's end: every key visible)
_DECODE_CASES = ((1, 0, 1), (1, 62, 63), (1, 64, 65), (1, 199, 200),
                 (7, 58, 65), (7, 293, 300), (128, 0, 128), (128, 72, 200),
                 (1, 300, 301))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,dims", [
    *(("float32", d) for d in fa.TC_DIMS),
    *(("bfloat16", d) for d in fa.TC_DIMS)])
def test_flash_masked_decode_matches_plain_on_cuda(cuda, dtype, dims):
    """Masked decode (``q_offset``, ``kv_len``) at every (hd, vd) each
    kernel takes, Sq 1, 7 and 128, GQA 8/1 and 4/4, with the window and
    the cap once: one launch each, of the kernel the shape and the dtype
    pick (the decode kernel at ``G·Sq <= 64``), held to the plain version
    at the unmasked tolerances."""
    dt = getattr(torch, dtype)
    hd, vd = dims
    cases = 0
    for h, kv in ((8, 1), (4, 4)):
        for sq, off, kvl in _DECODE_CASES:
            for cap, win in ((0.0, 0), (30.0, 64)):
                if win and (h, kv) == (4, 4):
                    continue
                q = torch.randn((2, sq, h, hd), generator=cuda,
                                device="cuda").to(dt)
                k = torch.randn((2, 300, kv, hd), generator=cuda,
                                device="cuda").to(dt)
                v = torch.randn((2, 300, kv, vd), generator=cuda,
                                device="cuda").to(dt)
                kw = dict(causal=True, attn_cap=cap, window=win,
                          q_offset=off, kv_len=kvl)
                dec = fa.decodes(h, kv, sq)
                before = (fa.launches, fa.tc_launches, fa.decode_launches)
                got = ops.attention(q, k, v, **kw)
                assert (fa.launches, fa.tc_launches, fa.decode_launches) == (
                    before[0] + 1,
                    before[1] + (dt == torch.bfloat16 and not dec),
                    before[2] + dec)
                want, _ = ref.flash_attention_bshd(q, k, v, scale=hd ** -0.5,
                                                   **kw)
                torch.cuda.synchronize()
                assert got.shape == (2, sq, h, vd)
                _assert_flash_close(got, want, v)
                cases += 1
    assert cases == 27


@pytest.mark.cuda
def test_flash_masked_decode_refuses_a_row_without_a_key_on_cuda(cuda):
    """A mask that leaves some row no key (the reference would average
    every value there), a negative offset and a tensor position raise
    and launch nothing; base.attend on the card takes host ints only,
    and the masked form has no backward on the card."""
    from repro_torch.models import base
    q = torch.randn((1, 4, 2, 64), generator=cuda, device="cuda").bfloat16()
    k = torch.randn((1, 64, 2, 64), generator=cuda, device="cuda").bfloat16()
    before = fa.launches
    for off, kvl, win in ((0, 2, 2), (-1, 8, 0), (40, 8, 16)):
        with pytest.raises(ValueError, match="without a key"):
            fa.attention_fwd(q, k, k, causal=True, scale=0.125,
                             attn_cap=0.0, window=win, q_offset=off,
                             kv_len=kvl)
    with pytest.raises(TypeError, match="host ints"):
        fa.attention_fwd(q, k, k, causal=True, scale=0.125, attn_cap=0.0,
                         window=0, q_offset=torch.tensor(3), kv_len=8)
    with pytest.raises(TypeError, match="host ints"):
        base.attend(q, k, k, causal=True,
                    q_pos=torch.arange(4, device="cuda"), kv_len=8)
    with pytest.raises(ValueError, match="forward-only"):
        ops.attention(q.clone().requires_grad_(), k, k, q_offset=4,
                      kv_len=8)
    assert fa.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_on_cuda_matches_cpu(cuda, dtype):
    """A prefill grown by 8 and 8 decode steps of a narrow TinyLlama (hd
    64, GQA 8/2) on the card against the same steps on the CPU, from the
    same parameters: one flash launch a layer a step (masked decode on
    the card from the second), the same final position, and the logits
    within 1e-4 of max|logit| in fp32 and 4e-2 in bf16 (the card's and
    the CPU's bf16 matmuls round their outputs at other points, a few
    bf16 ulps of drift over three layers)."""
    from repro_torch.models.registry import get_model
    dt = getattr(torch, dtype)
    cfg = tl.SMOKE.scaled(dtype=dt, d_model=256, n_heads=8, n_kv_heads=2,
                          head_dim=64, d_ff=512, vocab=512, n_layers=3)
    model = get_model(cfg)
    full = tree.map_leaves(lambda t: t.to(dt),
                           model.init(torch.Generator().manual_seed(0)))
    toks = torch.randint(0, cfg.vocab, (4, 40), generator=torch.Generator()
                         .manual_seed(1))
    runs = {}
    for dev in ("cuda", "cpu"):
        p = tree.map_leaves(lambda t: t.to(dev), full)
        fa.launches = 0
        with torch.inference_mode():
            logits, cache = model.prefill(p, {"tokens": toks[:, :32].to(dev)})
            cache["layers"] = {k: torch.cat([v, torch.zeros_like(v[:, :, :8])],
                                            2)
                               for k, v in cache["layers"].items()}
            outs = [logits]
            for t in range(32, 40):
                logits, cache = model.decode(p, toks[:, t:t + 1].to(dev),
                                             cache)
                outs.append(logits)
        runs[dev] = (torch.cat(outs, 1).float().cpu(), fa.launches,
                     cache["pos"])
    assert runs["cuda"][1] == cfg.n_layers * 9 and runs["cpu"][1] == 0
    assert runs["cuda"][2] == runs["cpu"][2] == 40
    got, want = runs["cuda"][0], runs["cpu"][0]
    tol = (1e-4 if dt == torch.float32 else 4e-2) * float(want.abs().max())
    assert float((got - want).abs().max()) <= tol


#: partial launches over 4 shards of 75 keys (a sequence of 300):
#: Sq, q_offset, kv_len, causal, cap, window.  Shards past kv_len, before
#: the window and past the causal edge see no key; at Sq 128 some rows of
#: one block see keys of a shard and others none.
_PARTIAL_CASES = ((1, 130, 131, True, 0.0, 0), (3, 200, 203, True, 0.0, 64),
                  (1, 299, 300, True, 30.0, 0), (5, 0, 160, False, 0.0, 0),
                  (128, 72, 200, True, 0.0, 0), (1, 10, 11, True, 30.0, 8))


def _assert_partial_close(got, want, v):
    """The kernel's ``(o, lse)`` against the plain version's: a row the
    plain version leaves without a key is ``o = 0``, ``lse = -inf`` in
    both, bit for bit; the others at the flash tolerances (lse 3e-5, as
    the unmasked kernel's)."""
    (o, lse), (po, plse) = got, want
    none = torch.isinf(plse)
    assert torch.equal(torch.isinf(lse), none)
    assert bool((lse[none] < 0).all())
    assert not bool(o.movedim(-2, -3)[none].any())
    _assert_flash_close(o, po, v)
    assert float((lse[~none] - plse[~none]).abs().max()) <= 3e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,dims", [
    *(("float32", d) for d in fa.TC_DIMS),
    *(("bfloat16", d) for d in fa.TC_DIMS)])
def test_flash_partial_matches_plain_on_cuda(cuda, dtype, dims):
    """Partial attention over a sequence split across 4 shards
    (``shards=``), at every (hd, vd) each kernel takes: 2 data ranks × 4
    ``model`` ranks × 2 rows, the keys one layer's strided slice of a
    ``(ranks, L, B, Sk, KV, d)`` cache, GQA 8/2, the cases above (keyless
    shards, the window and the cap across shard boundaries, Sq > 1):
    one partial launch each, of the kernel the shape and the dtype pick
    (the decode kernel at ``G·Sq <= 64``), held to
    ``ref.flash_attention_partial``."""
    dt = getattr(torch, dtype)
    hd, vd = dims
    n, b, sk, h, kv = 8, 2, 75, 8, 2
    k = torch.randn((n, 2, b, sk, kv, hd), generator=cuda,
                    device="cuda").to(dt)[:, 1]
    v = torch.randn((n, 2, b, sk, kv, vd), generator=cuda,
                    device="cuda").to(dt)[:, 1]
    for sq, off, kvl, causal, cap, win in _PARTIAL_CASES:
        q = torch.randn((n, b, sq, h, hd), generator=cuda,
                        device="cuda").to(dt)
        kw = dict(shards=4, causal=causal, attn_cap=cap, window=win,
                  q_offset=off, kv_len=kvl, scale=hd ** -0.5)
        dec = fa.decodes(h, kv, sq)
        before = (fa.launches, fa.tc_launches, fa.partial_launches,
                  fa.decode_launches)
        got = ops.attention_partial(q, k, v, **kw)
        assert (fa.launches, fa.tc_launches, fa.partial_launches,
                fa.decode_launches) == (
            before[0] + 1, before[1] + (dt == torch.bfloat16 and not dec),
            before[2] + 1, before[3] + dec)
        want = ref.flash_attention_partial(q, k, v, **kw)
        torch.cuda.synchronize()
        assert got[0].shape == (n, b, sq, h, vd)
        assert got[1].shape == (n, b, h, sq)
        assert bool(torch.isinf(want[1]).any()) == (
            (sq, off) != (1, 299)), (sq, off)
        _assert_partial_close(got, want, v)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_over_rank_axes_reads_a_strided_cache_on_cuda(cuda, dtype):
    """``ops.attention`` of ``(N, B, …)`` tensors (the heads split's
    decode over a cache laid out ``(ranks, L, B, S, KV, hd)``): one launch
    over one layer's strided slice, equal to the 4-D launch over the
    folded copy, bit for bit."""
    dt = getattr(torch, dtype)
    k, v = (torch.randn((4, 3, 2, 200, 2, 64), generator=cuda,
                        device="cuda").to(dt)[:, 2] for _ in range(2))
    q = torch.randn((4, 2, 1, 8, 64), generator=cuda, device="cuda").to(dt)
    kw = dict(causal=True, q_offset=150, kv_len=151)
    before = fa.launches
    got = ops.attention(q, k, v, **kw)
    assert fa.launches == before + 1 and got.shape == (4, 2, 1, 8, 64)
    want = ops.attention(q.reshape(8, 1, 8, 64), k.reshape(8, 200, 2, 64),
                         v.reshape(8, 200, 2, 64), **kw)
    assert _same_bits(got.reshape(8, 1, 8, 64), want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 4), (4, 2)])
def test_sharded_serving_on_cuda_matches_cpu(cuda, shape):
    """``make_serve_fns`` on the card against the same steps on the CPU
    (TinyLlama's SMOKE, fp32, ``("data", "model")`` = ``shape``): a
    prefill of 16 and three decode steps from position 16 of a cache of
    32, logits within 1e-4 of max|logit|.  At ``(2, 4)`` the cache splits
    over its sequence: one partial launch a layer a step; at ``(4, 2)``
    over its KV heads: none."""
    from repro_torch.models.registry import get_model
    from repro_torch.serve.engine import make_serve_fns
    from repro_torch.sharding import rules
    cfg = tl.SMOKE.scaled(dtype=torch.float32)
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    prompts = torch.randint(0, cfg.vocab, (4, 16), generator=g)
    toks = torch.randint(0, cfg.vocab, (4, 3), generator=g)
    mc = rules.MeshCfg(("data", "model"), shape)
    runs = {}
    for dev in ("cuda", "cpu"):
        prefill, decode, layout = make_serve_fns(
            model, mc, cache_batch=4, cache_len=32, device=dev)
        sp = layout.shard_params(params)
        logits, cache = prefill(sp, {"tokens": prompts})
        full = model.init_cache(4, 32)
        for name in ("k", "v"):
            full["layers"][name][:, :, :16] = layout.unshard_cache(cache)[
                "layers"][name].cpu()
        full["pos"] = 16
        cache = layout.shard_cache(full)
        fa.launches = fa.partial_launches = 0
        out = [logits.cpu()]
        for i in range(3):
            logits, cache = decode(sp, toks[:, i:i + 1], cache)
            out.append(logits.cpu())
        runs[dev] = (out, fa.launches, fa.partial_launches)
    got, want = runs["cuda"][0], runs["cpu"][0]
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
    seq = shape == (2, 4)
    assert runs["cuda"][1:] == (3 * cfg.n_layers, 3 * cfg.n_layers * seq)
    assert runs["cpu"][1:] == (0, 0)


def test_flash_kernel_wrapper_refuses_what_it_does_not_take():
    """Checked before anything is built, so this runs without a card."""
    q = torch.zeros((1, 8, 2, 64))
    with pytest.raises(ValueError, match="CUDA"):
        fa.attention_fwd(q, q, q, causal=True, scale=0.125, attn_cap=0.0,
                         window=0)


@pytest.mark.cuda
def test_train_step_on_cuda_matches_cpu(cuda):
    """Two steps of the Flare train step (innetwork, reproducible, the
    (2, 4) mesh, a widened SMOKE model in fp32) on the card and on the
    CPU: the card launches the flash kernel twice a layer a step (the
    forward and its recompute) and gives the same losses within fp32
    summation-order noise."""
    from repro_torch.data import pipeline
    from repro_torch.models.registry import get_model
    from repro_torch.sharding import rules
    from repro_torch.train import trainer

    cfg = tl.SMOKE.scaled(dtype=torch.float32, d_model=256, n_heads=4,
                          n_kv_heads=2, head_dim=64, d_ff=512, vocab=512)
    mcfg = rules.MeshCfg(("pod", "data", "model"), (2, 4, 1))
    tcfg = trainer.TrainConfig(lr=1e-3, gather_algorithm="fixed_tree",
                               flare=FlareConfig(axes=AXES,
                                                 transport="innetwork",
                                                 reproducible=True))
    model = get_model(cfg)
    full = model.init(torch.Generator().manual_seed(0))
    runs = {}
    for dev in ("cuda", "cpu"):
        f = tree.map_leaves(lambda t: t.to(dev), full)
        step = trainer.make_train_step(model, mcfg, tcfg, f)
        params = rules.shard_params(f, mcfg)
        opt = step.init_opt_state(params)
        stream = pipeline.synthetic_batches(cfg, 8, 64, seed=1, device=dev)
        fa.launches = 0
        losses = []
        for _ in range(2):
            params, opt, m = step(params, opt,
                                  rules.split_batch(next(stream), mcfg))
            losses.append(float(m["loss"]))
        runs[dev] = (losses, fa.launches)
    assert runs["cuda"][1] == 2 * 2 * cfg.n_layers
    assert runs["cpu"][1] == 0
    for a, b in zip(runs["cuda"][0], runs["cpu"][0]):
        assert abs(a - b) <= 1e-4 * abs(b)


#: the model paths' flash launches (``chip_smoke.py`` phase 7's new
#: cases, cut in length): q heads, kv heads, hd, Sq = Sk, cap, window
_MODEL_CASES = {"gemma2 hd 256 window cap": (8, 4, 256, 1024, 50.0, 256),
                "granite MQA G 48": (48, 1, 128, 512, 0.0, 0),
                "qwen3 G 16": (64, 4, 128, 256, 0.0, 0)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(_MODEL_CASES))
def test_flash_model_paths_match_plain_on_cuda(cuda, case):
    """bf16 causal attention at the new models' head layouts, one
    tensor-core launch each: gemma2's hd 256 with the attention cap and a
    window shorter than the sequence (it hides keys: the plain version
    without it differs), granite's 48 query heads on one KV head, qwen3's
    16-way groups."""
    h, kv, hd, s, cap, win = _MODEL_CASES[case]
    q = torch.randn((1, s, h, hd), generator=cuda, device="cuda").bfloat16()
    k, v = (torch.randn((1, s, kv, hd), generator=cuda,
                        device="cuda").bfloat16() for _ in range(2))
    before = fa.tc_launches
    got = ops.attention(q, k, v, causal=True, attn_cap=cap, window=win)
    assert fa.tc_launches == before + 1
    want, _ = ref.flash_attention_bshd(q, k, v, causal=True, attn_cap=cap,
                                       window=win, scale=hd ** -0.5)
    torch.cuda.synchronize()
    _assert_flash_close(got, want, v)
    if win:
        open_, _ = ref.flash_attention_bshd(q, k, v, causal=True,
                                            attn_cap=cap, scale=hd ** -0.5)
        assert not torch.equal(open_, want)


@pytest.mark.cuda
@pytest.mark.parametrize("sq", [1, 4])
def test_flash_windowed_masked_decode_matches_plain_on_cuda(cuda, sq):
    """Masked decode with gemma2's window at hd 256 (GQA 8/4): the cache
    filled past the window (``kv_len`` 700 and 900 of 1024, window 256),
    so the window and ``kv_len`` both hide keys in one launch, of the
    decode kernel."""
    k, v = (torch.randn((2, 1024, 4, 256), generator=cuda,
                        device="cuda").bfloat16() for _ in range(2))
    for off in (700 - sq, 900 - sq):
        q = torch.randn((2, sq, 8, 256), generator=cuda,
                        device="cuda").bfloat16()
        kw = dict(causal=True, attn_cap=50.0, window=256, q_offset=off,
                  kv_len=off + sq)
        before = (fa.tc_launches, fa.decode_launches)
        got = ops.attention(q, k, v, **kw)
        assert (fa.tc_launches, fa.decode_launches) == (before[0],
                                                        before[1] + 1)
        want, _ = ref.flash_attention_bshd(q, k, v, scale=256 ** -0.5, **kw)
        torch.cuda.synchronize()
        _assert_flash_close(got, want, v)


#: decode-kernel launches over 2 KV heads: G (query heads a KV head), Sq,
#: Sk, q_offset, kv_len, causal, cap, window.  A ragged ``kv_len``, the
#: cap, the window inside the cache and past it, Sq 4, a cross launch.
_DECODE_KERNEL_CASES = (
    (1, 1, 700, 650, 651, True, 0.0, 0),
    (2, 1, 700, 400, 401, True, 50.0, 0),
    (8, 4, 700, 596, 600, True, 30.0, 256),
    (16, 1, 700, 699, 700, True, 0.0, 1000),
    (48, 1, 700, 0, None, False, 0.0, 0),
    (16, 4, 333, 100, 104, True, 0.0, 0))


def _decode_kernel_vs_plain(q, k, v, plan_check=True, **kw):
    """One launch, which must be the decode kernel's, twice (the same
    bits), against the plain version (``ref.flash_attention_bshd``, or
    ``flash_attention_partial`` with ``shards``) and against the plain
    version of its own splits (``ref.flash_attention_split`` at
    ``decode_plan``'s plan), keyless rows exact.  Returns the plan."""
    n, b = (q.shape[0], q.shape[1]) if q.dim() == 5 else (1, q.shape[0])
    sq, h, hd = q.shape[-3:]
    sk, kv, vd = k.shape[-3], k.shape[-2], v.shape[-1]
    mma = q.dtype == torch.bfloat16
    before = (fa.launches, fa.tc_launches, fa.decode_launches,
              fa.decode_mma_launches)
    got = fa.attention_fwd(q, k, v, **kw)
    assert (fa.launches, fa.tc_launches, fa.decode_launches,
            fa.decode_mma_launches) == (
        before[0] + 1, before[1], before[2] + 1, before[3] + mma)
    again = fa.attention_fwd(q, k, v, **kw)
    assert _same_bits(got[0], again[0]) and _same_bits(got[1], again[1])
    shards = kw.get("shards")
    plan = fa.decode_plan(
        n, b, h, kv, sq, sk, hd, vd, q.dtype, causal=kw["causal"],
        window=kw["window"], q_offset=kw.get("q_offset", 0),
        kv_len=kw.get("kv_len") or sk * (shards or 1), shards=shards)
    blocks = n * b * kv
    if not plan_check:
        pass
    elif mma:   # every SM a block, unless a block would not fill its
        # ring or the grid would outgrow one wave of the blocks SMs hold
        fill = max(1, plan.tiles // fa.DECODE_STAGES)
        wave = max(1, fa.SMS * fa.decode_blocks_per_sm(hd, vd) // blocks)
        assert blocks * plan.splits >= min(fa.SMS, blocks * fill,
                                           blocks * wave)
    else:
        assert blocks * plan.splits >= min(2 * fa.SMS, blocks * plan.tiles)
    split = ref.flash_attention_split(q, k, v, **plan._asdict(), **kw)
    want = (ref.flash_attention_partial(q, k, v, **kw) if shards
            else ref.flash_attention_bshd(q, k, v, **kw))
    torch.cuda.synchronize()
    _assert_partial_close(got, want, v)
    _assert_partial_close(got, split, v)
    return plan


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,dims", [(d, x) for d in ("float32", "bfloat16")
                                        for x in fa.TC_DIMS])
def test_flash_decode_kernel_matches_plain_on_cuda(cuda, dtype, dims):
    """The decode kernel in both dtypes at every (hd, vd) of ``TC_DIMS``:
    G 1, 2, 8, 16 and 48 over 2 KV heads, Sq 1 and 4, every mask
    (``_DECODE_KERNEL_CASES``), launches of one split and of many (the
    plan's grid at least two blocks an SM where there are tiles enough),
    and in fp32 keys and values 4 bytes off 16 (the 4-byte copies)."""
    dt = getattr(torch, dtype)
    hd, vd = dims
    split = set()
    for g, sq, sk, off, kvl, causal, cap, win in _DECODE_KERNEL_CASES:
        q = torch.randn((2, sq, 2 * g, hd), generator=cuda,
                        device="cuda").to(dt)
        k = torch.randn((2, sk, 2, hd), generator=cuda, device="cuda").to(dt)
        v = torch.randn((2, sk, 2, vd), generator=cuda, device="cuda").to(dt)
        kw = dict(causal=causal, scale=hd ** -0.5, attn_cap=cap,
                  window=win, q_offset=off, kv_len=kvl)
        split.add(_decode_kernel_vs_plain(q, k, v, **kw).splits > 1)
        if dt == torch.float32 and g == 8:
            ko = torch.randn((2, sk, 2, hd + 1), generator=cuda,
                             device="cuda")[..., 1:]
            vo = torch.randn((2, sk, 2, vd + 1), generator=cuda,
                             device="cuda")[..., 1:]
            assert ko.data_ptr() % 16 and vo.data_ptr() % 16
            _decode_kernel_vs_plain(q, ko, vo, **kw)
    # the first 9 keys of 200, one tile: one split
    q = torch.randn((4, 1, 16, hd), generator=cuda, device="cuda").to(dt)
    k = torch.randn((4, 200, 8, hd), generator=cuda, device="cuda").to(dt)
    v = torch.randn((4, 200, 8, vd), generator=cuda, device="cuda").to(dt)
    split.add(_decode_kernel_vs_plain(
        q, k, v, causal=True, scale=hd ** -0.5, attn_cap=0.0, window=0,
        q_offset=8, kv_len=9).splits > 1)
    assert split == {True, False}


@pytest.mark.cuda
@pytest.mark.parametrize("dims", fa.TC_DIMS, ids=str)
def test_flash_decode_mma_kernel_joins_both_ways_on_cuda(cuda, dims):
    """The bf16 decode kernel (``flash_decode_mma_kernel``, counted by
    ``decode_mma_launches``) at every ``TC_DIMS`` pair with its splits
    joined both ways, each forced through ``decode_cluster``: inside a
    thread block cluster (distributed shared memory, one launch) and
    through fp32 scratch and the join kernel; G 8 over 2 KV heads at the
    plan's splits, and one (b, KV head) over 16384 keys at up to
    ``DECODE_CLUSTER`` splits and at the plan's (one split an SM, more
    than a cluster joins: scratch only).  Each launch twice with the same
    bits, within one bf16 ulp of the plain version of its splits and of
    the whole attention."""
    hd, vd = dims
    shapes = (((2, 1, 16, hd), (2, 1600, 2, hd), (2, 1600, 2, vd), False),
              ((1, 1, 8, hd), (1, 16384, 1, hd), (1, 16384, 1, vd), True))
    for qs, ks, vs, causal in shapes:
        q, k, v = (torch.randn(s, generator=cuda, device="cuda").bfloat16()
                   for s in (qs, ks, vs))
        kw = dict(causal=causal, scale=hd ** -0.5, attn_cap=0.0, window=0,
                  q_offset=ks[1] - 1 if causal else 0,
                  kv_len=ks[1] if causal else None)
        plan = fa.decode_plan(1, qs[0], qs[2], ks[2], 1, ks[1], hd, vd,
                              torch.bfloat16, causal=causal, window=0,
                              q_offset=kw["q_offset"], kv_len=ks[1])
        assert plan.splits > 1
        for cluster in (True, False):
            use = (plan._replace(splits=fa.DECODE_CLUSTER)
                   if cluster and plan.splits > fa.DECODE_CLUSTER else plan)
            with mock.patch.object(fa, "decode_plan", return_value=use), \
                    mock.patch.object(fa, "decode_cluster",
                                      return_value=cluster):
                _decode_kernel_vs_plain(q, k, v, plan_check=use is plan, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("vd", sorted({vd for _, vd in fa.TC_DIMS}))
def test_flash_bwd_dot_kernel_matches_plain_on_cuda(cuda, dtype, vd):
    """The backward's D kernel alone (``flash_attn.attention_dot``:
    ``flash_bwd_dot_kernel``, 16-byte loads over ``vd·size / 16`` lanes a
    row, a fixed butterfly) at every value dim of ``TC_DIMS`` in both
    dtypes: rows ragged against a block's, ``do`` a strided view (a
    head's slice of a wider tensor), against ``ref.flash_attention_dot``
    within 1e-5 of its terms' magnitudes (the fp32 sums in another
    order); twice the same bits, ``dot_launches`` up by one a launch."""
    dt = getattr(torch, dtype)
    for b, sq, h in ((1, 1, 1), (2, 333, 3), (3, 97, 32)):
        o = torch.randn((b, sq, h, vd), generator=cuda, device="cuda").to(dt)
        do = torch.randn((b, sq, h, 2 * vd), generator=cuda,
                         device="cuda").to(dt)[..., vd:]
        before = fa.dot_launches
        got = fa.attention_dot(o, do)
        again = fa.attention_dot(o, do)
        assert fa.dot_launches == before + 2
        assert _same_bits(got, again) and got.shape == (b, h, sq)
        want = ref.flash_attention_dot(o, do)
        scale = ref.flash_attention_dot(o.abs(), do.abs())
        torch.cuda.synchronize()
        assert bool(((got - want).abs() <= 1e-5 * scale + 1e-30).all()), (
            dtype, vd, b, sq, h)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,dims", [(d, x) for d in ("float32", "bfloat16")
                                        for x in fa.TC_DIMS])
def test_flash_decode_kernel_partial_over_a_strided_cache_on_cuda(
        cuda, dtype, dims):
    """The decode kernel's partial launches (``shards=`` 4, shards of 1024
    keys, 2 data × 4 model ranks × 2 rows) over one layer's slice of a
    ``(ranks, L, B, S, KV, d)`` cache, at (192, 128) the values MLA's
    strided view (head stride 256, 128 values in): G 1, 8 and 48, Sq 1
    and 4, keyless shards under ``kv_len``, the window and the causal
    edge, the cap, a cross launch; launches of many splits."""
    dt = getattr(torch, dtype)
    hd, vd = dims
    n, b, sk, kv = 8, 2, 1024, 2
    k = torch.randn((n, 2, b, sk, kv, hd), generator=cuda,
                    device="cuda").to(dt)[:, 1]
    wide = 256 if (hd, vd) == (192, 128) else vd
    v = torch.randn((n, 2, b, sk, kv, wide), generator=cuda,
                    device="cuda").to(dt)[:, 1][..., wide - vd:]
    keyless, splits = 0, set()
    for g, sq, off, kvl, causal, cap, win in (
            (1, 1, 2600, 2601, True, 0.0, 0),
            (8, 1, 4095, 4096, True, 50.0, 500),
            (48, 1, 0, 3500, False, 0.0, 0), (8, 4, 1500, 1504, True, 0.0, 0)):
        q = torch.randn((n, b, sq, g * kv, hd), generator=cuda,
                        device="cuda").to(dt)
        kw = dict(shards=4, causal=causal, scale=hd ** -0.5, attn_cap=cap,
                  window=win, q_offset=off, kv_len=kvl)
        before = fa.partial_launches
        splits.add(_decode_kernel_vs_plain(q, k, v, **kw).splits)
        assert fa.partial_launches == before + 2
        _, lse = ref.flash_attention_partial(q, k, v, **kw)
        keyless += int(torch.isinf(lse).sum())
    assert keyless > 0 and max(splits) > 1


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["gemma2-2b", "qwen3-moe-235b-a22b"])
def test_new_models_decode_on_cuda_matches_cpu(cuda, arch):
    """gemma2's and qwen3's SMOKE configs (fp32, hd 16): a prefill of 32
    grown by 8 and 8 decode steps on the card against the CPU, as
    ``test_decode_step_on_cuda_matches_cpu`` holds TinyLlama: one flash
    launch a layer a step, logits within 1e-4 of max|logit| (gemma2's
    local layers see 8 keys of up to 40)."""
    from repro_torch import configs
    from repro_torch.models.registry import get_model
    cfg = configs.load(arch).SMOKE.scaled(dtype=torch.float32)
    model = get_model(cfg)
    full = model.init(torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (4, 40), generator=torch.Generator()
                         .manual_seed(1))
    runs = {}
    for dev in ("cuda", "cpu"):
        p = tree.map_leaves(lambda t: t.to(dev), full)
        fa.launches = 0
        with torch.inference_mode():
            logits, cache = model.prefill(p, {"tokens": toks[:, :32].to(dev)})
            for name in set(cache) - {"pos"}:
                cache[name] = {k: torch.cat([v, torch.zeros_like(
                    v[:, :, :8])], 2) for k, v in cache[name].items()}
            outs = [logits]
            for t in range(32, 40):
                logits, cache = model.decode(p, toks[:, t:t + 1].to(dev),
                                             cache)
                outs.append(logits)
        runs[dev] = (torch.cat(outs, 1).cpu(), fa.launches)
    assert runs["cuda"][1] == cfg.n_layers * 9 and runs["cpu"][1] == 0
    got, want = runs["cuda"][0], runs["cpu"][0]
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["whisper-medium", "mamba2-370m"])
def test_whisper_and_mamba2_decode_on_cuda_matches_cpu(cuda, arch):
    """whisper's and mamba2's SMOKE configs (fp32): a prefill of 32 (with
    whisper's frames; mamba2's chunked SSD), whisper's self K/V grown by
    8, then 8 decode steps on the card against the CPU.  Whisper launches
    flash in every encoder layer and twice a decoder layer (self, cross)
    in the prefill, twice a decoder layer a step after it; mamba2 never.
    Logits within 1e-4 of max|logit|."""
    from repro_torch import configs
    from repro_torch.models.registry import get_model
    cfg = configs.load(arch).SMOKE.scaled(dtype=torch.float32)
    model = get_model(cfg)
    full = model.init(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (4, 40), generator=g)
    batch = {"tokens": toks[:, :32]}
    if cfg.family == "audio":
        batch["enc_frames"] = torch.randn(
            (4, cfg.encoder_tokens, cfg.d_model), generator=g) * 0.1
    runs = {}
    for dev in ("cuda", "cpu"):
        p = tree.map_leaves(lambda t: t.to(dev), full)
        fa.launches = 0
        with torch.inference_mode():
            logits, cache = model.prefill(
                p, {k: v.to(dev) for k, v in batch.items()})
            if "dec" in cache:
                for k in ("k", "v"):
                    v = cache["dec"][k]
                    cache["dec"][k] = torch.cat(
                        [v, torch.zeros_like(v[:, :, :8])], 2)
            outs = [logits]
            for t in range(32, 40):
                logits, cache = model.decode(p, toks[:, t:t + 1].to(dev),
                                             cache)
                outs.append(logits)
        runs[dev] = (torch.cat(outs, 1).cpu(), fa.launches)
    want_launches = (cfg.encoder_layers + 2 * cfg.n_layers * 9
                     if cfg.family == "audio" else 0)
    assert runs["cuda"][1] == want_launches and runs["cpu"][1] == 0
    got, want = runs["cuda"][0], runs["cpu"][0]
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.cuda
def test_zamba2_decode_on_cuda_matches_cpu(cuda):
    """zamba2's SMOKE config (fp32, two groups and a tail): a prefill of
    32 (the chunked SSD; the shared block once a group), the shared
    block's K/V grown by 8, then 8 decode steps on the card against the
    CPU, the flash kernel once a group a call.  Logits within 1e-4 of
    max|logit|."""
    from repro_torch import configs
    from repro_torch.models.registry import get_model
    cfg = configs.load("zamba2-1.2b").SMOKE.scaled(dtype=torch.float32)
    model = get_model(cfg)
    full = model.init(torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (4, 40),
                         generator=torch.Generator().manual_seed(1))
    groups = cfg.n_layers // cfg.hybrid_attn_every
    runs = {}
    for dev in ("cuda", "cpu"):
        p = tree.map_leaves(lambda t: t.to(dev), full)
        fa.launches = 0
        with torch.inference_mode():
            logits, cache = model.prefill(p, {"tokens": toks[:, :32].to(dev)})
            for k in ("k", "v"):
                v = cache["attn"][k]
                cache["attn"][k] = torch.cat(
                    [v, torch.zeros_like(v[:, :, :8])], 2)
            outs = [logits]
            for t in range(32, 40):
                logits, cache = model.decode(p, toks[:, t:t + 1].to(dev),
                                             cache)
                outs.append(logits)
        runs[dev] = (torch.cat(outs, 1).cpu(), fa.launches)
    assert runs["cuda"][1] == groups * 9 and runs["cpu"][1] == 0
    got, want = runs["cuda"][0], runs["cpu"][0]
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.cuda
def test_tensor_parallel_train_step_on_cuda_matches_cpu(cuda):
    """One train step of TinyLlama's SMOKE config (fp32) on ``2x2x2``, in
    the network and reproducible, on the card and on the CPU: a rank's 2
    of 4 heads, its half of the FFN and of the vocabulary; the card
    launches flash twice a layer (the forward and its recompute) over all
    8 ranks' rows, the fold kernel in the reduction, and gives the CPU's
    loss and gradient norm within fp32 summation-order noise."""
    from repro_torch.data import pipeline
    from repro_torch.kernels import tree_reduce as tr
    from repro_torch.models.registry import get_model
    from repro_torch.sharding import rules
    from repro_torch.train import trainer

    cfg = tl.SMOKE.scaled(dtype=torch.float32)
    mcfg = rules.MeshCfg(("pod", "data", "model"), (2, 2, 2))
    tcfg = trainer.TrainConfig(lr=1e-3, gather_algorithm="fixed_tree",
                               flare=FlareConfig(axes=AXES,
                                                 transport="innetwork",
                                                 reproducible=True))
    model = get_model(cfg)
    full = model.init(torch.Generator().manual_seed(0))
    runs = {}
    for dev in ("cuda", "cpu"):
        f = tree.map_leaves(lambda t: t.to(dev), full)
        step = trainer.make_train_step(model, mcfg, tcfg, f)
        params = rules.shard_params(f, mcfg)
        opt = step.init_opt_state(params)
        batch = next(pipeline.synthetic_batches(cfg, 4, 64, seed=1,
                                                device=dev))
        fa.launches = tr.launches = 0
        params, opt, m = step(params, opt, rules.split_batch(batch, mcfg))
        runs[dev] = (float(m["loss"]), float(m["grad_norm"]), fa.launches,
                     tr.launches)
    assert runs["cuda"][2] == 2 * cfg.n_layers and runs["cuda"][3] > 0
    assert runs["cpu"][2] == runs["cpu"][3] == 0
    for a, b in zip(runs["cuda"][:2], runs["cpu"][:2]):
        assert abs(a - b) <= 1e-4 * abs(b)


@pytest.mark.cuda
def test_head_split_train_step_on_cuda_matches_cpu(cuda):
    """One train step of gemma2-2b's SMOKE config (fp32) on ``1x1x8``: its
    4 query heads split over 8 ``model`` ranks, so every rank attends over
    all the heads and keeps its own columns of the output; the card
    launches flash twice a layer over the 8 ranks' rows and gives the
    CPU's loss and gradient norm within fp32 summation-order noise."""
    from repro_torch.configs import gemma2_2b
    from repro_torch.data import pipeline
    from repro_torch.models.registry import get_model
    from repro_torch.sharding import rules
    from repro_torch.train import trainer

    cfg = gemma2_2b.SMOKE.scaled(dtype=torch.float32)
    mcfg = rules.MeshCfg(("pod", "data", "model"), (1, 1, 8))
    tcfg = trainer.TrainConfig(lr=1e-3, flare=FlareConfig(axes=AXES))
    model = get_model(cfg)
    full = model.init(torch.Generator().manual_seed(0))
    runs = {}
    for dev in ("cuda", "cpu"):
        f = tree.map_leaves(lambda t: t.to(dev), full)
        step = trainer.make_train_step(model, mcfg, tcfg, f)
        params = rules.shard_params(f, mcfg)
        opt = step.init_opt_state(params)
        batch = next(pipeline.synthetic_batches(cfg, 2, 64, seed=1,
                                                device=dev))
        fa.launches = 0
        params, opt, m = step(params, opt, rules.split_batch(batch, mcfg))
        runs[dev] = (float(m["loss"]), float(m["grad_norm"]), fa.launches)
    assert runs["cuda"][2] == 2 * cfg.n_layers and runs["cpu"][2] == 0
    for a, b in zip(runs["cuda"][:2], runs["cpu"][:2]):
        assert abs(a - b) <= 1e-4 * abs(b)


@pytest.mark.cuda
def test_process_mesh_reduces_on_cuda_as_emulated(cuda):
    """Two gloo ranks, a thread each, on ``cuda:0`` (``mesh.ProcessMesh``,
    every operand staged through the host) reduce a small arena in the
    network on ``(1, 2)``: each rank's result is its slice of the
    emulated reduction's bits, and the fold kernel launched."""
    import datetime
    import threading

    from torch.distributed import HashStore

    from repro_torch.mesh import ProcessMesh
    from repro_torch.switch import dataplane

    shape = (1, 2)
    arena = torch.randn((*shape, 3, 5000), generator=cuda, device="cuda")
    want = dataplane.switch_allreduce_dense(arena, RankMesh(shape, AXES),
                                            AXES, reproducible=True)
    store, out, errors = HashStore(), [None, None], []

    def rank(r):
        try:
            m = ProcessMesh.create(store, r, shape, AXES,
                                   timeout=datetime.timedelta(seconds=60))
            out[r] = dataplane.switch_allreduce_dense(
                m.own(arena), m, AXES, reproducible=True)
            torch.cuda.synchronize()
        except BaseException as e:          # the assertion below names it
            errors.append(repr(e))
    tr.launches = 0
    threads = [threading.Thread(target=rank, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errors and not any(t.is_alive() for t in threads), errors
    assert tr.launches > 0
    for r in range(2):
        assert out[r].device.type == "cuda"
        assert _same_bits(out[r], want[0, r].unsqueeze(0).unsqueeze(0))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["int8", "sparse"])
def test_process_mesh_lossy_planes_on_cuda_as_emulated(cuda, mode):
    """The int8 and sparse in-network planes with two gloo ranks, a
    thread each, on ``cuda:0`` on ``(1, 2)``: each rank's result (and
    the sparse plane's sent lists and collision counts) its slice of the
    emulated plane's bits; the int8 fold launched on the switch rank,
    the root's int8 copy dequantized on both ranks, the sparse lists
    densified at the root."""
    import datetime
    import threading

    from torch.distributed import HashStore

    from repro_torch.mesh import ProcessMesh
    from repro_torch.switch import dataplane

    shape = (1, 2)
    arena = torch.randn((*shape, 3, 5000), generator=cuda, device="cuda")

    def plane(a, m):
        if mode == "int8":
            # the single design: one fold a level (an arena this small
            # would take the tree design, which dequantizes, then folds)
            return [dataplane.switch_allreduce_int8(a, m, AXES,
                                                    design="single")]
        red, sent, st = dataplane.switch_allreduce_sparse(
            a, m, AXES, 50, with_stats=True)
        return [red, *sent, st["collisions"]]
    want = plane(arena, RankMesh(shape, AXES))
    store, out, errors = HashStore(), [None, None], []

    def rank(r):
        try:
            m = ProcessMesh.create(store, r, shape, AXES,
                                   timeout=datetime.timedelta(seconds=60))
            out[r] = plane(m.own(arena), m)
            torch.cuda.synchronize()
        except BaseException as e:          # the assertion below names it
            errors.append(repr(e))
    for k in qt.launches:
        qt.launches[k] = 0
    sa.launches["sparse_accum_slots"] = 0
    threads = [threading.Thread(target=rank, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errors and not any(t.is_alive() for t in threads), errors
    if mode == "int8":
        assert qt.launches["dequant_accum_slots"] == 1
        assert qt.launches["dequantize"] == 2
    else:
        assert sa.launches["sparse_accum_slots"] == 1
    for r in range(2):
        for g, w in zip(out[r], want):
            assert g.device.type == "cuda"
            assert _same_bits(g, w[0, r].unsqueeze(0).unsqueeze(0))
