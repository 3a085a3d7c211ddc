"""Time the flash-attention launches of several source trees of the port
on one card, in one run, to compare two versions of
``csrc/flash_attn.cu`` on the same card.

    python3 tools/flash_ab.py --tree OLD --tree src --tree src --tree OLD

Each ``--tree`` is a directory that holds ``repro_torch`` (a checkout's
``src``); the trees are timed in the order given, each in a process of
its own, which builds that tree's kernel into that tree's build
directory.  Every case is timed by CUDA events, ``--iters`` launches
after a warm-up, queued behind a sleep on the card so that the host's
launch cost does not pace them, ``--reps`` times; the median of the
reps is kept.  The
cases are the training launch of the TinyLlama step (q ``(8, 4096, 32,
64)``, causal), an fp32 causal launch, the VLM's fp32 cross prefill (q
``(2, 1024, 64, 128)`` over 1600 keys of 8 KV heads, not causal: the
fp32 kernel's launch on the serving path), and the decode launches of
``chip_smoke.py``: the TinyLlama and gemma2-2b unsharded decodes of
phases 35 and 36 (one query over a 4096 and an 8192 cache), gemma2-2b's
global and windowed decode of phase 20, the partial launches of phases
35 and 36 (``shards=``), the VLM's fp32 cross decode, whisper's cross
decode and a slot server's decode.  The inputs are drawn from a seed,
so every tree sees the same; each case's output bits are hashed, and
the run says whether every tree gave the same bits.  A decode launch
(``G·Sq <= 64``) may give other bits in two trees where one routes it
to another kernel (the decode kernel sums in another order), and an
fp32 launch where the trees' fp32 kernels differ; a bf16 training or
prefill launch must not.  Prints one JSON object a line,
the card's name and power limit first, and writes them to ``--out``.
Needs a CUDA card; exits 1 without one.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

#: name, dtype, q ((N,) B, Sq, H, hd), k ((N,) B, Sk, KV, hd), causal, cap,
#: window, q_offset, kv_len, shards
CASES = (
    ("train TinyLlama", "bfloat16", (8, 4096, 32, 64), (8, 4096, 4, 64),
     True, 0.0, 0, 0, None, None),
    ("decode TinyLlama", "bfloat16", (16, 1, 32, 64), (16, 4096, 4, 64),
     True, 0.0, 0, 2048, 2049, None),
    ("decode gemma2-2b global", "bfloat16", (8, 1, 8, 256),
     (8, 8192, 4, 256), True, 50.0, 0, 5000, 5001, None),
    ("decode gemma2-2b local", "bfloat16", (8, 1, 8, 256),
     (8, 8192, 4, 256), True, 50.0, 4096, 5000, 5001, None),
    ("train fp32", "float32", (4, 1024, 8, 64), (4, 1024, 8, 64),
     True, 0.0, 0, 0, None, None),
    ("prefill cross VLM fp32", "float32", (2, 1024, 64, 128),
     (2, 1600, 8, 128), False, 0.0, 0, 0, None, None),
    ("decode gemma2-2b global, phase 20", "bfloat16", (2, 1, 8, 256),
     (2, 6176, 4, 256), True, 50.0, 0, 6175, 6176, None),
    ("decode gemma2-2b local, phase 20", "bfloat16", (2, 1, 8, 256),
     (2, 6176, 4, 256), True, 50.0, 4096, 6175, 6176, None),
    ("partial TinyLlama 1x2x8", "bfloat16", (16, 8, 1, 32, 64),
     (16, 8, 512, 4, 64), True, 0.0, 0, 2079, 2080, 8),
    ("partial gemma2-2b 1x1x8", "bfloat16", (8, 8, 1, 8, 256),
     (8, 8, 1024, 4, 256), True, 50.0, 0, 5015, 5016, 8),
    ("cross decode VLM fp32", "float32", (2, 1, 64, 128),
     (2, 1600, 8, 128), False, 0.0, 0, 0, None, None),
    ("cross decode whisper", "bfloat16", (8, 1, 16, 64), (8, 1500, 16, 64),
     False, 0.0, 0, 0, None, None),
    ("server decode TinyLlama", "bfloat16", (4, 1, 32, 64), (4, 64, 4, 64),
     True, 0.0, 0, 62, 63, None),
)


def decode_shaped(case) -> bool:
    """At most 64 query rows a KV group: the launches a decode kernel may
    take."""
    qs, ks = case[2], case[3]
    return qs[-2] // ks[-2] * qs[-3] <= 64


def time_tree(tree: str, iters: int, reps: int) -> list[dict]:
    """Every case on ``tree``'s kernel (this process imports that tree)."""
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch
    from repro_torch.kernels import flash_attn as fa

    out = []
    for name, dt, qs, ks, causal, cap, window, off, kvl, shards in CASES:
        gen = torch.Generator(device="cuda").manual_seed(29)
        dtype = getattr(torch, dt)
        q, k, v = (torch.randn(s, generator=gen, device="cuda").to(dtype)
                   for s in (qs, ks, ks))
        kw = dict(causal=causal, scale=qs[-1] ** -0.5, attn_cap=cap,
                  window=window, q_offset=off, kv_len=kvl)
        if shards:
            kw["shards"] = shards
        o, lse = fa.attention_fwd(q, k, v, **kw)
        torch.cuda.synchronize()
        digest = hashlib.sha256(
            o.contiguous().view(torch.uint8).cpu().numpy().tobytes()
            + lse.cpu().numpy().tobytes()).hexdigest()
        times = []
        for _ in range(reps):
            for _ in range(3):
                fa.attention_fwd(q, k, v, **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fa.attention_fwd(q, k, v, **kw)
            torch.cuda.synchronize()
            # the launches queued behind a sleep on the card: device time,
            # not the host's launch rate
            ahead = min(2 * iters * (time.perf_counter() - t0), 0.05)
            torch.cuda._sleep(int(ahead * 2e9))
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
    same = [len({run[i]["bits"] for run in runs}) == 1
            for i in range(len(CASES))]
    lines.append(dict(
        same_bits_in_every_tree=all(same),
        bf16_training_and_prefill_same_bits=all(
            ok for ok, c in zip(same, CASES)
            if not decode_shaped(c) and c[1] == "bfloat16"),
        cases_with_other_bits=[c[0] for ok, c in zip(same, CASES) if not ok],
        note="decode-shaped launches may give other bits in two trees "
             "where one takes the decode kernel, fp32 ones where the "
             "trees' fp32 kernels differ; bf16 training and prefill "
             "launches must not"))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as f:
        for line in lines:
            print(json.dumps(line))
            f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
