"""Time the ordinary (unsharded) flash-attention launch of several source
trees of the port on one card, in one run, to compare two versions of
``csrc/flash_attn.cu`` on the same card.

    python3 tools/flash_ab.py --tree OLD --tree src --tree src --tree OLD

Each ``--tree`` is a directory that holds ``repro_torch`` (a checkout's
``src``); the trees are timed in the order given, each in a process of
its own, which builds that tree's kernel into that tree's build
directory.  Every case is timed by CUDA events, ``--iters`` launches
after a warm-up, ``--reps`` times; the median of the reps is kept.  The
cases are the training launch of the TinyLlama step (q ``(8, 4096, 32,
64)``, causal), the TinyLlama and gemma2-2b unsharded decode launches of
``chip_smoke.py``'s phases 35 and 36 (one query over a 4096 and an 8192
cache), and an fp32 causal launch.  The inputs are drawn from a seed, so
every tree sees the same; each case's output bits are hashed, and the
run says whether every tree gave the same bits.  Prints one JSON object
a line, the card's name and power limit first, and writes them to
``--out``.  Needs a CUDA card; exits 1 without one.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

#: name, dtype, q (B, Sq, H, hd), k (B, Sk, KV, hd), causal, cap, window,
#: q_offset, kv_len
CASES = (
    ("train TinyLlama", "bfloat16", (8, 4096, 32, 64), (8, 4096, 4, 64),
     True, 0.0, 0, 0, None),
    ("decode TinyLlama", "bfloat16", (16, 1, 32, 64), (16, 4096, 4, 64),
     True, 0.0, 0, 2048, 2049),
    ("decode gemma2-2b global", "bfloat16", (8, 1, 8, 256),
     (8, 8192, 4, 256), True, 50.0, 0, 5000, 5001),
    ("decode gemma2-2b local", "bfloat16", (8, 1, 8, 256),
     (8, 8192, 4, 256), True, 50.0, 4096, 5000, 5001),
    ("train fp32", "float32", (4, 1024, 8, 64), (4, 1024, 8, 64),
     True, 0.0, 0, 0, None),
)


def time_tree(tree: str, iters: int, reps: int) -> list[dict]:
    """Every case on ``tree``'s kernel (this process imports that tree)."""
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch
    from repro_torch.kernels import flash_attn as fa

    out = []
    for name, dt, qs, ks, causal, cap, window, off, kvl in CASES:
        gen = torch.Generator(device="cuda").manual_seed(29)
        dtype = getattr(torch, dt)
        q, k, v = (torch.randn(s, generator=gen, device="cuda").to(dtype)
                   for s in (qs, ks, ks))
        kw = dict(causal=causal, scale=qs[-1] ** -0.5, attn_cap=cap,
                  window=window, q_offset=off, kv_len=kvl)
        o, lse = fa.attention_fwd(q, k, v, **kw)
        torch.cuda.synchronize()
        digest = hashlib.sha256(
            o.contiguous().view(torch.uint8).cpu().numpy().tobytes()
            + lse.cpu().numpy().tobytes()).hexdigest()
        times = []
        for _ in range(reps):
            for _ in range(3):
                fa.attention_fwd(q, k, v, **kw)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fa.attention_fwd(q, k, v, **kw)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / iters)
        out.append(dict(case=name, ms=statistics.median(times),
                        ms_reps=times, bits=digest[:16]))
        del q, k, v, o, lse
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="a directory holding repro_torch (repeatable)")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default="chiprun_out/flash_ab.jsonl")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(time_tree(args.one, args.iters, args.reps)))
        return 0
    import torch
    if not torch.cuda.is_available() or not args.tree:
        print("flash_ab: needs a CUDA card and at least one --tree",
              file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    lines = [dict(card=card, trees=args.tree, iters=args.iters,
                  reps=args.reps)]
    runs = []
    for tree in args.tree:
        res = subprocess.run(
            [sys.executable, __file__, "--one", tree, "--iters",
             str(args.iters), "--reps", str(args.reps)],
            capture_output=True, text=True, env=dict(os.environ))
        if res.returncode:
            print(res.stdout, res.stderr, file=sys.stderr)
            return 1
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
        for r in runs[-1]:
            lines.append(dict(tree=tree, **r))
    same = all(len({run[i]["bits"] for run in runs}) == 1
               for i in range(len(CASES)))
    lines.append(dict(same_bits_in_every_tree=same))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as f:
        for line in lines:
            print(json.dumps(line))
            f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
