"""The fp32 flash kernel's arithmetic rehearsed on the CPU: 3xTF32.

The card's fp32 forward (``csrc/flash_attn.cu``, ``flash_fwd_tf32_kernel``)
runs both of its products on the tensor cores in TF32, three times: each
fp32 operand ``x`` splits as ``big = tf32(x)`` and ``small = tf32(x -
big)`` (``cvt.rna.tf32.f32``: round to nearest, ties away from zero, on
the 13 low mantissa bits), and a product is ``small·big + big·small +
big·big``, summed in fp32.  This file emulates that rounding in
plain PyTorch (nothing in ``src/`` uses it) and builds the kernel's
attention from it: the scores ``fl32(q)·scale · k`` in three products, the
cap, the masks (``-1e30``), an online softmax over the kernel's key tiles
with ``exp2((s - m)·log2 e)``, then ``P·V`` in three products.

It rehearses the error budget, not the card's bits: a tensor core's
internal accumulation is not IEEE, and the card sums in another order.
At the models' fp32 shapes (hd 64; the VLM's cross prefill over 1600
keys at hd 128, GQA 64/8; hd 256 with the cap at 50 and a window;
DeepSeek-V2's (192, 128)) the emulation stays within half of the
reference's 3e-5 of ``ref.flash_attention_bshd`` and of the JAX
package's jitted ``attend`` (fp32, on the CPU), on the same numpy
inputs; a single TF32 product does not hold 3e-5 at hd 128, which is
why the kernel takes three.  Also: ``flash_attn.dims`` gives fp32 every
``TC_DIMS`` pair outside a decode launch.
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
from repro_torch.kernels import ref

torch.set_num_threads(1)

LOG2E = math.log2(math.e)
#: the reference's fp32 tolerance, and the design's gate: half of it
TOL, GATE = 3e-5, 1.5e-5

#: name, q (B, Sq, H, hd), k (B, Sk, KV, hd), vd, causal, cap, window,
#: keys a tile of the kernel at these dims
CASES = (
    ("hd64", (1, 128, 4, 64), (1, 128, 2, 64), 64, True, 0.0, 0, 32),
    ("vlm cross hd128", (1, 64, 64, 128), (1, 1600, 8, 128), 128, False,
     0.0, 0, 32),
    ("hd256 cap window", (1, 128, 4, 256), (1, 128, 2, 256), 256, True,
     50.0, 48, 8),
    ("mla 192-128", (1, 128, 4, 192), (1, 128, 4, 192), 128, True, 0.0, 0,
     32),
)
IDS = [c[0] for c in CASES]


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: ``x`` rounded to 10 explicit mantissa bits,
    to nearest with ties away from zero (adding half of the dropped bits'
    weight to the magnitude, through the int32 view), as an fp32 whose 13
    low bits are zero."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def product(a: torch.Tensor, b: torch.Tensor, products: int) -> torch.Tensor:
    """``a @ b`` as the tensor cores compute it in TF32: one product of
    the rounded operands, or three (``small·big + big·small + big·big``,
    the smallest terms first)."""
    if products == 1:
        return tf32(a) @ tf32(b)
    a_big, b_big = tf32(a), tf32(b)
    a_small, b_small = tf32(a - a_big), tf32(b - b_big)
    return (a_small @ b_big + a_big @ b_small) + a_big @ b_big


def emulated(q, k, v, *, causal, scale, cap, window, kt, products=3):
    """The fp32 kernel's attention in plain PyTorch, with its products
    emulated: ``(o (B, Sq, H, vd), lse (B, H, Sq))``."""
    b, sq, h, hd = q.shape
    sk, kv, vd = k.shape[1], k.shape[2], v.shape[-1]
    g = h // kv
    qf = (q * scale).reshape(b, sq, kv, g, hd).permute(0, 2, 3, 1, 4)
    m = torch.full((b, kv, g, sq), -torch.inf)
    l = torch.zeros_like(m)
    o = torch.zeros((b, kv, g, sq, vd))
    qpos = torch.arange(sq)[:, None]
    for t0 in range(0, sk, kt):
        kb = k[:, t0:t0 + kt].permute(0, 2, 1, 3).unsqueeze(2)
        vb = v[:, t0:t0 + kt].permute(0, 2, 1, 3).unsqueeze(2)
        s = product(qf, kb.transpose(-1, -2), products)
        if cap > 0:
            s = torch.tanh(s / cap) * cap
        if causal:
            kpos = torch.arange(t0, t0 + kb.shape[-2])[None]
            seen = kpos <= qpos
            if window > 0:
                seen = seen & (kpos > qpos - window)
            s = torch.where(seen, s, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2((m - m_new) * LOG2E)
        p = torch.exp2((s - m_new[..., None]) * LOG2E)
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + product(p, vb, products)
        m = m_new
    out = (o / torch.clamp(l[..., None], min=1e-30)).permute(0, 3, 1, 2, 4)
    return out.reshape(b, sq, h, vd), (m + torch.log(l)).reshape(b, h, sq)


@functools.cache
def _jax_attend(causal, window, cap, scale):
    return jax.jit(functools.partial(jbase.attend, causal=causal,
                                     window=window, attn_cap=cap,
                                     scale=scale))


def _inputs(case, seed=0):
    _, qs, ks, vd = case[:4]
    rng = np.random.default_rng(seed)
    return (rng.normal(size=qs).astype(np.float32),
            rng.normal(size=ks).astype(np.float32),
            rng.normal(size=ks[:-1] + (vd,)).astype(np.float32))


def test_tf32_rounds_to_nearest_ties_away():
    """Ten explicit mantissa bits; a tie (the dropped bits exactly half)
    rounds away from zero in both signs; the result's 13 low bits are 0."""
    one = 1.0
    ulp = 2.0 ** -10
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2**-23,
                      one + 1.5 * ulp, 3.0, -0.0])
    want = torch.tensor([one + ulp, -(one + ulp), one, one + 2 * ulp, 3.0,
                         -0.0])
    got = tf32(x)
    assert torch.equal(got, want)
    assert not bool((got.view(torch.int32) & 0x1FFF).any())


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_three_tf32_products_hold_the_fp32_tolerance(case):
    """The emulated kernel against the plain version and the JAX
    reference on the same inputs: output and log-sum-exp within the
    design's gate (half of 3e-5)."""
    name, qs, _, _, causal, cap, window, kt = case
    q, k, v = _inputs(case)
    scale = qs[-1] ** -0.5
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got, lse = emulated(tq, tk, tv, causal=causal, scale=scale, cap=cap,
                        window=window, kt=kt)
    want, want_lse = ref.flash_attention_bshd(
        tq, tk, tv, causal=causal, scale=scale, attn_cap=cap, window=window)
    jax_out = np.asarray(_jax_attend(causal, window, cap, scale)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    err = float((got - want).abs().max())
    jerr = float(np.abs(got.numpy() - jax_out).max())
    lerr = float((lse - want_lse).abs().max())
    assert max(err, jerr, lerr) <= GATE <= TOL, (name, err, jerr, lerr)


def test_one_tf32_product_misses_the_fp32_tolerance():
    """At hd 128 (the VLM's cross prefill) a single TF32 product a GEMM
    moves the output past 3e-5, so the gate tells one product from
    three."""
    case = CASES[1]
    _, qs, _, _, causal, cap, window, kt = case
    q, k, v = (torch.from_numpy(x) for x in _inputs(case))
    want, _ = ref.flash_attention_bshd(q, k, v, causal=causal,
                                       scale=qs[-1] ** -0.5)
    got, _ = emulated(q, k, v, causal=causal, scale=qs[-1] ** -0.5, cap=cap,
                      window=window, kt=kt, products=1)
    assert float((got - want).abs().max()) > TOL


@pytest.mark.parametrize("h,kv,sq", [(8, 8, 65), (64, 8, 1024), (8, 4, 4096),
                                     (16, 16, 300)])
def test_fp32_takes_every_head_dim_pair_outside_decode(h, kv, sq):
    """Past ``DECODE_ROWS`` query rows a KV group an fp32 launch takes
    the tensor-core kernel, at every pair the bf16 one takes."""
    assert not fa.decodes(h, kv, sq)
    assert fa.dims(torch.float32, h, kv, sq) == fa.TC_DIMS
    assert fa.dims(torch.bfloat16, h, kv, sq) == fa.TC_DIMS
    assert not hasattr(fa, "FP32_DIMS")
