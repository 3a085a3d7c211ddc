"""The flash attention backward: its plain version against the JAX
package, and the card kernel's rounding emulated on the CPU.

The JAX package has no backward kernel: its train step differentiates
``repro.models.base.attend`` through XLA.  The port's plain backward,
``ref.flash_attention_bwd`` (the chunked recompute from the forward's
log-sum-exp, which the card's ``csrc/flash_bwd.cu`` computes and
``chip_smoke.py`` holds it against), is held here against the jitted
``jax.vjp`` of ``attend`` in both its branches (``chunk = 0`` and the
online softmax, ``chunk > 0``), fp32 and bf16, at the models' cases: GQA
8/2 causal, hd 256 with cap 50 and a window, MLA's (192, 128), cross
attention with ``Sq != Sk`` (not causal), and lengths ragged against 64
and 128.  Inputs are seeded numpy draws.

Tolerances: fp32 ``2e-5`` of each gradient's largest value, both sides
summing in fp32 in other orders over at most 200 keys; bf16 two bf16
ulps of each gradient's largest (both round the same fp32 gradient to
bf16 once; the reference's q·scale and the port's differ in the last
fp32 bit).

The card kernels round P and dS to bf16 as product operands and take D
from the bf16 output.  ``_kernel_emulation`` repeats those rounding
points in fp32 arithmetic, its sums in the kernels' tile order
(``flash_attn.BWD_TILES``); held
against the reference's fp32 gradient it stays within half of the card's
bound (each gradient within 2e-2 of its largest): the bound has margin
before any chip run.

The fp32 kernels take each product as three TF32 products (small·big +
big·small + big·big, ``cvt.rna`` splits).  ``_tf32_kernel_emulation``
repeats that arithmetic: the scores and dP summed in place over 8-wide
k-steps (at the wide pairs from 0 over each 128 of the head dim, the
chunks then added), dV, dK and dQ summed from 0 over each tile (a
consumer's share of a stage's query rows for dK and dV: alternate stages
whole, halves of each, or at the wide pairs the whole stage, summed by one
consumer as dVᵀ = dOᵀ·P and dKᵀ = Qᵀ·dS; a stage's keys for dQ, dQᵀ =
Kᵀ·dSᵀ at the wide pairs) and then added in fp32, the two dK/dV consumers'
sums added at the end where both hold them, in the kernels' tile order
(``flash_attn.BWD_TF32_TILES``).  Held against the jitted ``jax.vjp`` of
``attend`` in fp32 it stays within 5e-5, half of the card's 1e-4, at the
fp32 training paths' hd 32 and 64 and at every pair those kernels take.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import base as jbase
from repro_torch.kernels import flash_attn as fa
from repro_torch.kernels import ops, ref
from repro_torch.launch import step_analysis
from repro_torch.models import base

torch.set_num_threads(1)

#: name → (B, Sq, Sk, H, KV, hd, vd, causal, cap, window, chunk of the
#: reference's online-softmax branch, 0 where the lengths do not allow it)
CASES = {
    "gqa 8/2 causal": (2, 128, 128, 8, 2, 32, 32, True, 0.0, 0, 32),
    "hd 256 cap 50 window": (1, 128, 128, 4, 2, 256, 256, True, 50.0, 48,
                             64),
    "mla (192, 128)": (1, 128, 128, 4, 4, 192, 128, True, 0.0, 0, 64),
    "cross sq != sk": (2, 96, 160, 4, 4, 64, 64, False, 0.0, 0, 32),
    "ragged 150 x 200": (1, 150, 200, 4, 2, 64, 64, True, 0.0, 0, 0),
    "ragged 200 x 150": (1, 200, 150, 4, 2, 64, 64, False, 30.0, 0, 0),
}
#: fp32: a fraction of each gradient's largest value; bf16: bf16 ulps of it
FP32_TOL, BF16_ULPS = 2e-5, 2


def _draw(rng, case, dtype):
    b, sq, sk, h, kv, hd, vd = case[:7]
    shapes = ((b, sq, h, hd), (b, sk, kv, hd), (b, sk, kv, vd),
              (b, sq, h, vd))
    xs = [rng.normal(size=s).astype(np.float32) for s in shapes]
    if dtype == "bfloat16":
        xs = [np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
              for x in xs]
    return xs


def _jax_grads(xs, case, dtype, chunk):
    *_, causal, cap, win, _ = case
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    q, k, v, do = (jnp.asarray(x, jd) for x in xs)

    @jax.jit
    def grads(q, k, v, do):
        _, vjp = jax.vjp(lambda q, k, v: jbase.attend(
            q, k, v, causal=causal, window=win, attn_cap=cap, chunk=chunk),
            q, k, v)
        return vjp(do)
    return [np.asarray(g.astype(jnp.float32)) for g in grads(q, k, v, do)]


def _port_grads(xs, case, dtype):
    *_, causal, cap, win, _ = case
    q, k, v, do = (torch.from_numpy(x).to(getattr(torch, dtype)) for x in xs)
    scale = base._scale(q, None)
    _, lse = ref.flash_attention_bshd(q, k, v, causal=causal, scale=scale,
                                      attn_cap=cap, window=win)
    got = ref.flash_attention_bwd(q, k, v, lse, do, causal=causal,
                                  scale=scale, attn_cap=cap, window=win,
                                  q_chunk=64, max_elems=1 << 16)
    for g, t in zip(got, (q, k, v)):
        assert g.dtype == t.dtype and g.shape == t.shape
    return [g.float().numpy() for g in got]


def _bf16_ulp(x: float) -> float:
    """One bf16 ulp at ``x`` (8 significant bits)."""
    return math.ldexp(1.0, math.frexp(max(abs(x), 1e-30))[1] - 8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("branch", ["dense", "chunked"])
@pytest.mark.parametrize("name", list(CASES))
def test_plain_backward_matches_jax_vjp_of_attend(name, branch, dtype):
    """``ref.flash_attention_bwd`` from the plain forward's log-sum-exp
    against the jitted ``jax.vjp`` of the reference's ``attend``, the
    dense branch and the online-softmax one (the ragged cases have no
    chunk that divides their keys, and run the dense branch twice)."""
    case = CASES[name]
    chunk = case[-1] if branch == "chunked" else 0
    xs = _draw(np.random.default_rng(sorted(CASES).index(name)), case, dtype)
    want = _jax_grads(xs, case, dtype, chunk)
    got = _port_grads(xs, case, dtype)
    for g, w, what in zip(got, want, "qkv"):
        top = float(np.abs(w).max())
        tol = (FP32_TOL * top if dtype == "float32"
               else BF16_ULPS * _bf16_ulp(top))
        err = float(np.abs(g - w).max())
        assert err <= tol, (what, err, tol)


def _kernel_emulation(q, k, v, o, lse, do, *, causal, scale, cap, window):
    """``csrc/flash_bwd.cu``'s bf16 rounding in fp32 arithmetic: scores
    from the bf16 operands scaled after the product, P = 2^(s·log2 e −
    lse·log2 e) (0 where masked), D = Σ dO·O from the bf16 output, dS =
    (P·(1 − tanh²))·(dP − D); P and dS rounded to bf16 as the operands of
    dV += Pᵀ·dO, dK += dSᵀ·Q and dQ += dS·K, each a sum of fp32 tile
    products in the kernels' order, their tiles ``flash_attn.BWD_TILES``:
    dK and dV a block of keys at a time, the group's heads outermost, each
    head's query stages from the first row that sees the block; dQ a
    block of rows at a time, its key stages from the first key a row of
    the block sees; the scale applied to dK and dQ at the end; the results
    rounded to bf16.  q ``(Sq, H, hd)``, k ``(Sk, KV, hd)``, v ``(Sk, KV,
    vd)``, o and do ``(Sq, H, vd)`` bf16, lse ``(H, Sq)`` fp32."""
    sq, h, hd = q.shape
    sk, kv, _ = k.shape
    g = h // kv
    tiles = fa.BWD_TILES[(hd, v.shape[-1])]
    qf, kf, vf, of, dof = (t.float() for t in (q, k, v, o, do))
    rows, keys = torch.arange(sq)[:, None], torch.arange(sk)[None, :]
    vis = torch.ones((sq, sk), dtype=torch.bool)
    if causal:
        vis = keys <= rows
        if window:
            vis &= keys > rows - window
    log2e = math.log2(math.e)
    pb, dsb = [], []
    for hh in range(h):
        j = hh // g
        x = (qf[:, hh] @ kf[:, j].T) * scale
        dt = torch.ones_like(x)
        if cap:
            th = torch.tanh(x / cap)
            x, dt = th * cap, 1 - th * th
        p = torch.where(vis, torch.exp2(x * log2e - lse[hh][:, None] * log2e),
                        0.0)
        d = (dof[:, hh] * of[:, hh]).sum(-1, keepdim=True)
        pb.append(p.bfloat16().float())
        dsb.append(((p * dt) * (dof[:, hh] @ vf[:, j].T - d)).bfloat16()
                   .float())
    dq = torch.zeros_like(qf)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for k0 in range(0, sk, tiles.keys):
        ks = slice(k0, k0 + tiles.keys)
        qbeg, qend = 0, sq
        if causal:
            qbeg = min(k0, sq)
            if window:
                qend = min(sq, k0 + tiles.keys - 1 + window)
        for hh in range(h):
            j = hh // g
            for q0 in range(qbeg, qend, tiles.rows):
                rs = slice(q0, q0 + tiles.rows)
                dv[ks, j] += pb[hh][rs, ks].T @ dof[rs, hh]
                dk[ks, j] += dsb[hh][rs, ks].T @ qf[rs, hh]
    for q0 in range(0, sq, tiles.dq_rows):
        rs = slice(q0, q0 + tiles.dq_rows)
        kbeg, kend = 0, sk
        if causal:
            kend = min(sk, min(q0 + tiles.dq_rows, sq))
            if window:
                kbeg = max(0, q0 - window + 1)
        for hh in range(h):
            j = hh // g
            for t0 in range(kbeg, kend, tiles.dq_keys):
                ts = slice(t0, min(t0 + tiles.dq_keys, kend))
                dq[rs, hh] += dsb[hh][rs, ts] @ kf[ts, j]
    return ((dq * scale).bfloat16(), (dk * scale).bfloat16(), dv.bfloat16())


@pytest.mark.parametrize("name,shape", [
    ("tinyllama causal, GQA 8/2", (1024, 1024, 8, 2, 64, 64, True, 0.0, 0)),
    ("gemma2 hd 256, cap 50, window", (512, 512, 4, 2, 256, 256, True, 50.0,
                                       256)),
    ("mla (192, 128)", (512, 512, 4, 4, 192, 128, True, 0.0, 0)),
    ("whisper cross", (384, 600, 4, 4, 64, 64, False, 0.0, 0)),
    ("gqa 8/1 ragged, window", (600, 600, 8, 1, 64, 64, True, 0.0, 200)),
    ("hd 128, cap 30", (300, 300, 4, 2, 128, 128, True, 30.0, 0))])
def test_kernel_rounding_holds_the_card_bound_with_margin(name, shape):
    """The bf16 kernels' rounding points and summation order, emulated,
    against the reference's fp32 gradient (the jitted ``jax.vjp`` of ``attend`` at the
    same bf16-valued inputs in fp32): each gradient within 1e-2 of its
    largest, half of the card's 2e-2 bound."""
    sq, sk, h, kv, hd, vd, causal, cap, win = shape
    rng = np.random.default_rng(7)
    xs = _draw(rng, (1, sq, sk, h, kv, hd, vd), "bfloat16")
    case = (1, sq, sk, h, kv, hd, vd, causal, cap, win, 0)
    want = _jax_grads(xs, case, "float32", 0)
    q, k, v, do = (torch.from_numpy(x[0]).bfloat16() for x in xs)
    scale = base._scale(q, None)
    o, lse = ref.flash_attention_bshd(q[None], k[None], v[None],
                                      causal=causal, scale=scale,
                                      attn_cap=cap, window=win)
    got = _kernel_emulation(q, k, v, o[0], lse[0], do, causal=causal,
                            scale=scale, cap=cap, window=win)
    for gr, w, what in zip(got, want, "qkv"):
        top = float(np.abs(w).max())
        err = float(np.abs(gr.float().numpy() - w[0]).max())
        assert err <= 1e-2 * top, (name, what, err / top)


def test_bwd_tiles_cover_every_pair():
    """``BWD_TILES`` (the emulation's tile order, the card tests' ragged
    lengths) has the bf16 kernels' tiles at every ``TC_DIMS`` pair: whole
    64-row consumers and 16-deep products, the dK/dV kernel's 64 keys a
    consumer (hd 256 shares them), the dQ kernel's 128 rows."""
    assert set(fa.BWD_TILES) == set(fa.TC_DIMS)
    for (hd, vd), t in fa.BWD_TILES.items():
        assert t.keys == (64 if hd + vd > 320 else 128), (hd, vd)
        assert t.rows in (32, 64) and t.dq_rows == 128
        assert t.dq_keys in (32, 64, 128) and t.dq_keys % 16 == 0


def test_backward_kernel_wrapper_refuses_cpu_tensors():
    """On the CPU the model differentiates the plain forward; the
    backward kernel's wrapper takes CUDA tensors only."""
    q = torch.zeros((1, 16, 2, 16))
    lse = torch.zeros((1, 2, 16))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        fa.attention_bwd(q, q, q, q, lse, q, causal=True, scale=0.25,
                         attn_cap=0.0, window=0)


@pytest.mark.parametrize("causal,window,sq,sk", [
    (True, 0, 256, 256), (True, 64, 200, 200), (False, 0, 96, 160)])
def test_meta_backward_counts_the_kernel(causal, window, sq, sk):
    """The dry-run's backward (``ops._MetaFlash``) counts one launch of the
    backward kernel: its flops ``2·(3·hd + 2·vd)`` a visible pair (the
    forward's ``2·(hd + vd)``, so 2.5 times the forward's at hd = vd
    here), its bytes, its three outputs in the inputs' shapes and dtype."""
    q = torch.empty(2, sq, 8, 64, dtype=torch.bfloat16, device="meta",
                    requires_grad=True)
    k, v = (torch.empty(2, sk, 2, 64, dtype=torch.bfloat16, device="meta",
                        requires_grad=True) for _ in range(2))

    def step(q, k, v):
        out = ops.attention(q, k, v, causal=causal, window=window)
        return torch.autograd.grad(out, (q, k, v), torch.ones_like(out))
    st, (dq, dk, dv) = step_analysis.analyze(step, q, k, v)
    fwd, bwd = st.kernels["flash_attention"], st.kernels[
        "flash_attention_bwd"]
    assert fwd["launches"] == bwd["launches"] == 1
    assert bwd["flops"] == fa.flops_bwd(2, 8, sq, sk, 64, causal=causal,
                                        window=window)
    assert 2 * bwd["flops"] == 5 * fwd["flops"]
    assert bwd["bytes_moved"] == fa.bytes_moved_bwd(q, k, v)
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
    assert dq.dtype == dk.dtype == torch.bfloat16
    before = fa.bwd_launches
    step(q, k, v)
    assert fa.bwd_launches == before     # the card's counter never moves


def test_meta_backward_refuses_a_row_without_a_key():
    """Causal with a window and ``Sq`` past ``Sk + window``: the last rows
    see no key, which the backward kernel refuses, on ``meta`` too."""
    q = torch.empty(1, 300, 2, 64, device="meta", requires_grad=True)
    kv = torch.empty(1, 100, 2, 64, device="meta", requires_grad=True)
    out = ops.attention(q, kv, kv, causal=True, window=50)
    with pytest.raises(ValueError, match="without a key"):
        torch.autograd.grad(out, (q, kv), torch.ones_like(out))


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` through the int32 view (to nearest, ties away,
    on the 13 low bits), as the kernels' ``rna`` rounds."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _sum3(a: torch.Tensor, b: torch.Tensor, acc=None) -> torch.Tensor:
    """``acc + a @ b`` as a TF32 ``wgmma`` chain computes it: per 8-wide
    k-step the three products small·big, big·small, big·big, each added to
    the fp32 accumulator in place (from 0 where ``acc`` is None)."""
    ab, bb = _tf32(a), _tf32(b)
    asm, bsm = _tf32(a - ab), _tf32(b - bb)
    for j in range(0, a.shape[-1], 8):
        ks = slice(j, j + 8)
        for x, y in ((asm, bb), (ab, bsm), (ab, bb)):
            prod = x[:, ks] @ y[ks]
            acc = prod if acc is None else acc + prod
    return acc


def _tf32_kernel_emulation(q, k, v, o, lse, do, *, causal, scale, cap,
                           window):
    """``csrc/flash_bwd.cu``'s fp32 ``wgmma`` kernels' arithmetic in fp32:
    S and dP in three TF32 products summed in place over the head dim (or
    from 0 over each ``chunk`` of it, the chunks added in fp32), P =
    2^(s·scale·log2 e − lse·log2 e) (0 where masked), D = Σ dO·O, dS =
    (P·(1 − tanh²))·(dP − D); dV += Pᵀ·dO and dK += dSᵀ·Q summed from 0
    over each consumer's share of a stage (alternate stages whole, or
    halves of each; ``whole``: the stage, one consumer each as dVᵀ +=
    dOᵀ·P and dKᵀ += Qᵀ·dS) and added in fp32, the group's heads
    outermost, each head's stages from the first row that sees the block,
    consumer 0's total plus consumer 1's; dQ += dS·K (``whole``: dQᵀ +=
    Kᵀ·dSᵀ) summed from 0 over each stage of keys.  q ``(Sq, H, hd)``, k
    ``(Sk, KV, hd)``, v ``(Sk, KV, vd)``, o and do ``(Sq, H, vd)``, lse
    ``(H, Sq)``, fp32."""
    sq, h, hd = q.shape
    sk, kv, vd = v.shape
    g = h // kv
    t = fa.BWD_TF32_TILES[(hd, vd)]
    rows, keys = torch.arange(sq)[:, None], torch.arange(sk)[None, :]
    vis = torch.ones((sq, sk), dtype=torch.bool)
    if causal:
        vis = keys <= rows
        if window:
            vis &= keys > rows - window
    log2e = torch.tensor(math.log2(math.e), dtype=torch.float32)
    sl = torch.tensor(scale, dtype=torch.float32) * log2e

    def scores(a, b):
        """a @ b: from 0 over each ``t.chunk`` of the depth, then added"""
        w = t.chunk or a.shape[-1]
        parts = [_sum3(a[:, i:i + w], b[i:i + w])
                 for i in range(0, a.shape[-1], w)]
        return functools.reduce(torch.add, parts)

    ps, dss = [], []
    for hh in range(h):
        j = hh // g
        x = scores(q[:, hh], k[:, j].T)
        if cap:
            th = torch.tanh(x * (scale / cap))
            p = torch.exp2(th * (cap * log2e) - lse[hh][:, None] * log2e)
            dt = 1 - th * th
        else:
            p = torch.exp2(x * sl - lse[hh][:, None] * log2e)
            dt = torch.ones_like(p)
        p = torch.where(vis, p, 0.0)
        d = (do[:, hh] * o[:, hh]).sum(-1, keepdim=True)
        ps.append(p)
        dss.append((p * dt) * (scores(do[:, hh], v[:, j].T) - d))
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    # a consumer's (first row, rows) of each stage: the whole stage for
    # one of the two in turn (or, whole, for consumer 0's dV and 1's dK),
    # or a half for each
    share = (((0, t.rows),) if t.alternate or t.whole else
             ((0, t.rows // 2), (t.rows // 2, t.rows // 2)))
    for k0 in range(0, sk, t.keys):
        ks = slice(k0, k0 + t.keys)
        qbeg, qend = 0, sq
        if causal:
            qbeg = min(k0, sq)
            if window:
                qend = min(sq, k0 + t.keys - 1 + window)
        for j in range(kv):
            part = [[0.0, 0.0], [0.0, 0.0]]  # consumer → (dK, dV)
            it = 0
            for hh in range(j * g, (j + 1) * g):
                for q0 in range(qbeg, qend, t.rows):
                    for c, (r0, n) in enumerate(share):
                        c = it % 2 if t.alternate else c
                        rs = slice(q0 + r0, min(q0 + r0 + n, sq))
                        if rs.start >= rs.stop:
                            continue
                        if t.whole:  # dKᵀ += Qᵀ·dS, dVᵀ += dOᵀ·P
                            part[c][0] = part[c][0] + _sum3(
                                q[rs, hh].T, dss[hh][rs, ks]).T
                            part[c][1] = part[c][1] + _sum3(
                                do[rs, hh].T, ps[hh][rs, ks]).T
                            continue
                        part[c][0] = part[c][0] + _sum3(dss[hh][rs, ks].T,
                                                        q[rs, hh])
                        part[c][1] = part[c][1] + _sum3(ps[hh][rs, ks].T,
                                                        do[rs, hh])
                    it += 1
            dk[ks, j] = scale * (part[0][0] + part[1][0])
            dv[ks, j] = part[0][1] + part[1][1]
    dq = torch.zeros_like(q)
    for q0 in range(0, sq, t.dq_rows):
        rs = slice(q0, q0 + t.dq_rows)
        kbeg, kend = 0, sk
        if causal:
            kend = min(sk, min(q0 + t.dq_rows, sq))
            if window:
                kbeg = max(0, q0 - window + 1)
        for hh in range(h):
            j = hh // g
            acc = torch.zeros_like(dq[rs, hh])
            for t0 in range(kbeg, kend, t.dq_keys):
                ts = slice(t0, min(t0 + t.dq_keys, sk))
                acc = acc + (_sum3(k[ts, j].T, dss[hh][rs, ts].T).T
                             if t.whole else _sum3(dss[hh][rs, ts], k[ts, j]))
            dq[rs, hh] = scale * acc
    return dq, dk, dv


#: the fp32 kernels' cases: (Sq, Sk, H, KV, hd, vd, causal, cap, window,
#: the values before ``v`` in each head of the tensor it is a view of (0:
#: contiguous, as MLA's strided ``v``))
TF32_CASES = {
    "tinyllama fp32 hd 64, GQA 8/2": (160, 160, 8, 2, 64, 64, True, 0.0, 0,
                                      0),
    "train_e2e hd 32": (64, 64, 2, 1, 32, 32, True, 0.0, 0, 0),
    "hd 16 cap 30, window": (150, 150, 4, 2, 16, 16, True, 30.0, 40, 0),
    "hd 128 cross": (96, 160, 4, 2, 128, 128, False, 0.0, 0, 0),
    "hd 128 causal, cap 50": (130, 130, 4, 4, 128, 128, True, 50.0, 0, 0),
    "hd 256 cap 50, window, GQA 8/4": (150, 150, 8, 4, 256, 256, True, 50.0,
                                       70, 0),
    "mla (192, 128), strided v": (140, 140, 4, 4, 192, 128, True, 0.0, 0,
                                  64),
}


@pytest.mark.parametrize("name", list(TF32_CASES))
def test_tf32_kernel_arithmetic_holds_half_the_card_bound(name):
    """The fp32 ``wgmma`` kernels' arithmetic, emulated, against the
    reference's fp32 gradient (the jitted ``jax.vjp`` of ``attend``): each
    gradient within 5e-5, half of the card's 1e-4, at the fp32 training
    paths' hd 32 and 64 and at every pair those kernels take, gemma2's hd
    256 with its cap, a window and GQA 8/4, and MLA's (192, 128) with ``v``
    a strided view; lengths ragged against their 64-key or 64-row blocks
    and 16- or 32-row or key stages."""
    sq, sk, h, kv, hd, vd, causal, cap, win, v_pad = TF32_CASES[name]
    case = (1, sq, sk, h, kv, hd, vd, causal, cap, win, 0)
    xs = _draw(np.random.default_rng(11), case, "float32")
    want = _jax_grads(xs, case, "float32", 0)
    q, k, v, do = (torch.from_numpy(x[0]) for x in xs)
    if v_pad:  # v read where it lies, inside a wider tensor
        wide = torch.zeros((sk, kv, v_pad + vd))
        wide[..., v_pad:] = v
        v = wide[..., v_pad:]
    scale = base._scale(q, None)
    o, lse = ref.flash_attention_bshd(q[None], k[None], v[None],
                                      causal=causal, scale=scale,
                                      attn_cap=cap, window=win)
    got = _tf32_kernel_emulation(q, k, v, o[0], lse[0], do, causal=causal,
                                 scale=scale, cap=cap, window=win)
    for gr, w, what in zip(got, want, "qkv"):
        err = float(np.abs(gr.numpy() - w[0]).max())
        assert err <= 5e-5, (name, what, err)


def test_bwd_tf32_tiles_cover_the_narrow_pairs():
    """``BWD_TF32_TILES`` (the emulation's tile order) has the fp32
    ``wgmma`` kernels' tiles at every ``TC_DIMS`` pair: 64 keys a dK/dV
    block, stages of at most 32 rows (a transposed plane's 128-byte row) in
    whole 8-row k-steps, taken whole by alternate consumers where the ring
    holds an even number of stages (not at hd 128, whose ring holds one), a
    dQ block of one or two 64-row consumers and at most 32 keys a stage, S
    and dP in place over the head dim; at (256, 256) and (192, 128), whose
    split K and V do not fit beside a stage, stages of 16 rows (keys), a
    stage's big and small parts side by side in one 128-byte row, each
    stage's dK and dV summed whole by one consumer, S and dP from 0 over
    each 128 of the head dim."""
    assert set(fa.BWD_TF32_TILES) == set(fa.TC_DIMS)
    for (hd, vd), t in fa.BWD_TF32_TILES.items():
        assert t.keys == 64 and t.rows in (16, 32) and t.rows % 16 == 0
        assert t.dq_rows in (64, 128) and t.dq_keys in (16, 32)
        if hd + vd > 256:
            assert (t.rows, t.dq_rows, t.dq_keys, t.alternate, t.whole,
                    t.chunk) == (16, 64, 16, False, True, 128), (hd, vd)
            continue
        assert (t.rows, t.dq_rows, t.dq_keys, t.alternate) == (
            (32, 128, 32, True) if hd + vd <= 128
            else (16, 64, 16, False)), (hd, vd)
        assert not t.whole and not t.chunk, (hd, vd)
    assert not any(t.alternate or t.whole or t.chunk
                   for t in fa.BWD_TILES.values())


def _dot_kernel_emulation(o: np.ndarray, do: np.ndarray, *, bf16: bool
                          ) -> np.ndarray:
    """``flash_bwd_dot_kernel``'s D = Σ_d dO·O in fp32, ``(B, Sq, H, vd)``
    → ``(B, H, Sq)``: a row's 16-byte chunks (8 bf16 or 4 fp32 values)
    over ``L = min(32, chunks)`` lanes (lane ``l`` takes chunks ``l, l +
    L, …``), each chunk's products summed in order by fused
    multiply-adds (bf16 from 0, fp32 from its first product), a lane's
    chunks added in order, then the lanes by a butterfly (xor ``L/2`` …
    1).  fp32 arithmetic, each fused step rounded once (in fp64, then to
    fp32)."""
    per = 8 if bf16 else 4
    f32 = np.float32
    x, y = o.astype(np.float64), do.astype(np.float64)
    b, sq, h, vd = o.shape
    ch = vd // per
    lanes = min(32, ch)
    acc = np.zeros((b, sq, h, lanes), f32)
    for lane in range(lanes):
        for c in range(lane, ch, lanes):
            if bf16:
                part, start = np.zeros((b, sq, h), f32), 0
            else:
                part, start = (x[..., c * per] * y[..., c * per]).astype(f32), 1
            for e in range(start, per):
                part = (x[..., c * per + e] * y[..., c * per + e]
                        + part.astype(np.float64)).astype(f32)
            acc[..., lane] = (acc[..., lane] + part).astype(f32)
    width = lanes
    while width > 1:
        width //= 2
        acc = (acc + acc[..., np.arange(lanes) ^ width]).astype(f32)
    return acc[..., 0].transpose(0, 2, 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("vd", sorted({vd for _, vd in fa.TC_DIMS}))
def test_dot_kernel_order_matches_the_reference(dtype, vd):
    """The D kernel's summation order (``_dot_kernel_emulation``) and
    ``ref.flash_attention_dot`` against the reference's own D, the jitted
    ``jnp.sum(dO·O)`` of the JAX package's fp32 arithmetic on the same
    inputs (bf16 values for a bf16 launch), at every value dim of
    ``TC_DIMS``: within 2^-20 of each row's Σ|dO·O| (the fp32 sums differ
    in order only)."""
    rng = np.random.default_rng(vd)
    o, do = (rng.normal(size=(2, 37, 3, vd)).astype(np.float32)
             for _ in range(2))
    if dtype == "bfloat16":
        o, do = (torch.from_numpy(x).bfloat16().float().numpy()
                 for x in (o, do))
    want = np.asarray(jax.jit(lambda a, b: jnp.sum(a * b, -1).transpose(
        0, 2, 1))(o, do))
    mag = np.abs(o * do).sum(-1).transpose(0, 2, 1)
    emu = _dot_kernel_emulation(o, do, bf16=dtype == "bfloat16")
    plain = ref.flash_attention_dot(torch.from_numpy(o),
                                    torch.from_numpy(do)).numpy()
    for got in (emu, plain):
        assert got.shape == (2, 3, 37)
        assert np.all(np.abs(got - want) <= 2.0 ** -20 * mag + 1e-30)
