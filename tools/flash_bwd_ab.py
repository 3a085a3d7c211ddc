"""Time the flash attention backward kernel (``csrc/flash_bwd.cu``) of one
or more sources on one card, in one run, kernel by kernel.

    python3 tools/flash_bwd_ab.py [--source PATH ...] [--ab OLD NEW]
                                  [--case TEXT ...] [--iters N] [--out FILE]

Each ``--source`` is a version of ``csrc/flash_bwd.cu`` (the checkout's
own by default), built with the headers beside it; each is built and
timed in a process of its own, in the order given, so that two versions
are compared on the same card.  ``--ab OLD NEW`` runs them as OLD NEW NEW
OLD.  The cases are the training paths' backward launches:
TinyLlama's step (q ``(8, 4096, 32, 64)`` over 4 KV heads, bf16,
causal), gemma2-2b's global attention (hd 256, cap 50), deepseek's MLA
at ``(hd, vd)`` = (192, 128) with ``v`` a strided view, whisper's cross
attention (4096 queries over 1500 keys, not causal), an fp32 causal
launch ``(4, 1024, 8, 64)``, and the fp32 training paths' launches:
TinyLlama on ``2x2x2`` (``(8, 4096, 16, 64)`` over 2 KV heads) and
``examples_torch/train_e2e.py``'s (``(16, 64, 2, 32)`` over 1), and
phase 31's fp32 steps of gemma2-2b (``(4, 4096, 8, 256)`` over 4 KV
heads, cap 50) and deepseek (``(4, 4096, 16, 192)``, ``v`` the strided
(192, 128) view) on ``2x2x1``.  The forward kernel gives ``o`` and the
log-sum-exp.  Each case: the mean device time of a backward by CUDA
events over ``--iters`` launches queued behind a sleep on the card
(``chip_smoke.cuda_ms``), the device time of each of its three kernels
by ``torch.profiler`` (``flash_bwd_dot``, then bf16's
``flash_bwd_dkdv_wgmma`` and ``flash_bwd_dq_wgmma``, fp32's
``flash_bwd_dkdv_tf32`` and ``flash_bwd_dq_tf32`` at every pair; an
older source's ``mma.sync`` kernels at fp32's wide pairs,
``flash_bwd_dkdv`` and ``flash_bwd_dq``, are found too), the bound (five
products a visible pair at the card's peak, bf16 989 TFLOP/s, fp32 three
TF32 products at 495) and each kernel's
(``chip_smoke.bwd_kernel_bounds``), SDPA's backward on the same inputs
(``chip_smoke.sdpa_bwd_ms``: the gradient alone, KV heads repeated, no
cap; the yardstick, never called by the port) and the backend PyTorch
picked for it, and a hash of the gradients' bits (the inputs drawn from
a seed of the case's own); each build's largest register count and
spill, and each kernel's tensor-core instructions by ``cuobjdump -sass``
(TF32 and other ``HGMMA``, ``HMMA``).  ``--case`` (repeated) keeps the cases whose name holds
one of the strings given.  Prints one JSON
object a line, the card's name and power limit first, and writes them
to ``--out``.  Needs a CUDA card; exits 1 without one.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: name, dtype, q (B, Sq, H, hd), k (B, Sk, KV, hd), vd, causal, cap,
#: window, the width of the tensor ``v`` is a view of (None: contiguous)
CASES = (
    ("train TinyLlama", "bfloat16", (8, 4096, 32, 64), (8, 4096, 4, 64), 64,
     True, 0.0, 0, None),
    ("train gemma2-2b global", "bfloat16", (8, 4096, 8, 256),
     (8, 4096, 4, 256), 256, True, 50.0, 0, None),
    ("train deepseek MLA", "bfloat16", (8, 4096, 16, 192), (8, 4096, 16, 192),
     128, True, 0.0, 0, 256),
    ("train whisper cross", "bfloat16", (8, 4096, 16, 64), (8, 1500, 16, 64),
     64, False, 0.0, 0, None),
    ("train fp32", "float32", (4, 1024, 8, 64), (4, 1024, 8, 64), 64, True,
     0.0, 0, None),
    ("train TinyLlama fp32 2x2x2", "float32", (8, 4096, 16, 64),
     (8, 4096, 2, 64), 64, True, 0.0, 0, None),
    ("train_e2e fp32", "float32", (16, 64, 2, 32), (16, 64, 1, 32), 32, True,
     0.0, 0, None),
    ("train gemma2-2b fp32", "float32", (4, 4096, 8, 256), (4, 4096, 4, 256),
     256, True, 50.0, 0, None),
    ("train deepseek fp32", "float32", (4, 4096, 16, 192),
     (4, 4096, 16, 192), 128, True, 0.0, 0, 256),
)
KERNEL = re.compile(
    r"flash_bwd_(dot|dkdv_wgmma|dq_wgmma|dkdv_tf32|dq_tf32|dkdv|dq)_kernel")


def sass_ops(lib: Path) -> dict:
    """The tensor-core instructions of each kernel of ``lib`` by
    ``cuobjdump -sass`` (beside nvcc): ``{kernel: {"HGMMA.TF32": n,
    "HGMMA": n, "HMMA": n}}`` (``HGMMA`` counts the others), keyed by the
    name ``KERNEL`` finds and the head dims; empty without cuobjdump."""
    from repro_torch.kernels import build as kb
    tool = Path(kb.nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return {}
    out = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                         text=True).stdout
    ops: dict = {}
    cur = None
    for line in out.splitlines():
        if "Function :" in line:
            m = KERNEL.search(line)
            dims = re.findall(r"Li(\d+)E", line)
            cur = ops.setdefault(
                f"{m.group(1)}<{','.join(dims)}>" if m else line.split()[-1],
                {"HGMMA.TF32": 0, "HGMMA": 0, "HMMA": 0})
        elif cur is not None:
            if "HGMMA" in line:
                cur["HGMMA.TF32" if ".TF32" in line else "HGMMA"] += 1
            elif "HMMA" in line:
                cur["HMMA"] += 1
    return ops


def child(source: str, iters: int, only: list) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    from chip_smoke import (BF16_FLOPS_PER_S, HBM_BYTES_PER_S,
                            TF32_FLOPS_PER_S, bwd_kernel_bounds, cuda_ms,
                            sdpa_backend, sdpa_bwd_ms)
    from repro_torch.kernels import build as kb
    from repro_torch.kernels import flash_attn as fa

    fa.BWD_SOURCE = Path(source)
    lib = kb.build(fa.BWD_SOURCE)[0]
    log = lib.with_suffix(".log").read_text()
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores", log)]
    print(json.dumps({"source": source, "build": lib.name,
                      "registers_max": max(regs),
                      "spill_stores_max": max(spills, default=0),
                      "sass": sass_ops(lib)}),
          flush=True)
    for i, (name, dtype, qs, ks, vd, causal, cap, win, v_in) in enumerate(
            CASES):
        if only and not any(w in name for w in only):
            continue
        # a seed a case: its inputs do not depend on which cases run
        gen = torch.Generator(device="cuda").manual_seed(11 + i)
        dt = getattr(torch, dtype)
        q, k = (torch.randn(s, generator=gen, device="cuda").to(dt)
                for s in (qs, ks))
        if v_in:
            v = torch.randn((*ks[:3], v_in), generator=gen,
                            device="cuda").to(dt)[..., -vd:]
        else:
            v = torch.randn((*ks[:3], vd), generator=gen, device="cuda").to(dt)
        do = torch.randn((*qs[:3], vd), generator=gen, device="cuda").to(dt)
        kw = dict(causal=causal, scale=qs[-1] ** -0.5, attn_cap=cap,
                  window=win)
        o, lse = fa.attention_fwd(q, k, v, **kw)

        def bwd():
            return fa.attention_bwd(q, k, v, o, lse, do, **kw)
        ms = cuda_ms(bwd, iters)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                bwd()
            torch.cuda.synchronize()
        parts = {}
        for e in prof.key_averages():
            m = KERNEL.search(e.key)
            if m:
                parts[m.group(1)] = parts.get(m.group(1), 0.0) + (
                    e.device_time_total / 1e3 / 3)
        digest = hashlib.sha256()
        for g in bwd():
            digest.update(g.contiguous().view(torch.uint8).cpu().numpy()
                          .tobytes())
        b, sq, h, hd = qs
        flops = fa.flops_bwd(b, h, sq, ks[1], hd, causal=causal, window=win,
                             vd=vd)
        ops_s = (flops / BF16_FLOPS_PER_S if dt == torch.bfloat16
                 else 3 * flops / TF32_FLOPS_PER_S)
        bound = max(ops_s, fa.bytes_moved_bwd(q, k, v) / HBM_BYTES_PER_S)
        print(json.dumps({"source": source, "case": name, "ms": ms,
                          "kernels_ms": parts, "bound_ms": bound * 1e3,
                          "kernel_bounds_ms": bwd_kernel_bounds(fa, q, k, v,
                                                                kw),
                          "of_bound": bound * 1e3 / ms,
                          "sdpa_bwd_ms": sdpa_bwd_ms(torch, q, k, v, do, kw),
                          "sdpa_backend": sdpa_backend(torch, q, k, v, kw),
                          "bits": digest.hexdigest()[:16]}), flush=True)
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--source", action="append", default=[])
    ap.add_argument("--ab", nargs=2, metavar=("OLD", "NEW"))
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--case", action="append", default=[])
    ap.add_argument("--out", default="results/flash_bwd_ab.jsonl")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.child, args.iters, args.case)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("flash_bwd_ab: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    lines = [json.dumps({"card": card})]
    print(lines[0], flush=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    sources = args.source or [str(ROOT / "src/repro_torch/kernels/csrc/"
                                         "flash_bwd.cu")]
    if args.ab:
        old, new = args.ab
        sources = [old, new, new, old]
    for src in sources:
        out = subprocess.run([sys.executable, __file__, "--child",
                              str(Path(src).resolve()), "--iters",
                              str(args.iters),
                              *(f"--case={c}" for c in args.case)],
                             env=env, capture_output=True,
                             text=True)
        sys.stdout.write(out.stdout)
        if out.returncode:
            sys.stderr.write(out.stderr[-4000:])
            return out.returncode
        lines += out.stdout.splitlines()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
