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
prefill launch must not.  Beside each case: SDPA's time on the same
inputs with the boolean mask phase 7 builds (the yardstick, never called
by the port) and the launch's byte bound; the last line gives each of
``TABLE``'s launches (the seven bf16 decodes the CUDA-core decode kernel
lost to SDPA)
as kernel ÷ SDPA in every tree.  Prints one JSON object a line, the
card's name and power limit first, and writes them to ``--out``.

    python3 tools/flash_ab.py --sweep [--tree DIR]

times the bf16 decode cases at forced split counts, each with its splits
joined in a thread block cluster and through scratch (the plan's design
runs).  Needs a CUDA card; exits 1 without one.
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
    ("decode TinyLlama, phase 18", "bfloat16", (16, 1, 32, 64),
     (16, 2048, 4, 64), True, 0.0, 0, 1087, 1088, None),
    ("decode qwen3", "bfloat16", (4, 1, 64, 128), (4, 1056, 4, 128),
     True, 0.0, 0, 1055, 1056, None),
    ("server cross decode VLM bf16", "bfloat16", (4, 1, 64, 128),
     (4, 1600, 8, 128), False, 0.0, 0, 0, None, None),
    ("self decode VLM", "bfloat16", (2, 1, 64, 128), (2, 1040, 8, 128),
     True, 0.0, 0, 1039, 1040, None),
    ("self decode whisper", "bfloat16", (8, 1, 16, 64), (8, 1056, 16, 64),
     True, 0.0, 0, 1055, 1056, None),
    ("decode deepseek", "bfloat16", (4, 1, 16, 192), (4, 2080, 16, 192),
     True, 0.0, 0, 2079, 2080, None),
    ("decode zamba2", "bfloat16", (16, 1, 32, 64), (16, 1056, 32, 64),
     True, 0.0, 0, 1055, 1056, None),
)
#: the seven bf16 decode launches that the CUDA-core decode kernel lost
#: to SDPA
TABLE = ("server cross decode VLM bf16", "decode qwen3",
         "decode TinyLlama, phase 18", "cross decode whisper",
         "self decode VLM", "self decode whisper", "partial TinyLlama 1x2x8")


#: split counts the design runs force (``--sweep``)
SWEEP_SPLITS = (1, 2, 3, 4, 5, 6, 8, 12, 16, 24, 32, 48, 66, 132)
#: an H100's memory rate, bytes a second (NVIDIA's data sheet, SXM)
HBM_BYTES_PER_S = 3.35e12


def decode_shaped(case) -> bool:
    """At most 64 query rows a KV group: the launches a decode kernel may
    take."""
    qs, ks = case[2], case[3]
    return qs[-2] // ks[-2] * qs[-3] <= 64


def draw(torch, case):
    """A case's q, k, v (from a seed: every tree sees the same) and its
    launch keywords."""
    name, dt, qs, ks, causal, cap, window, off, kvl, shards = case
    gen = torch.Generator(device="cuda").manual_seed(29)
    dtype = getattr(torch, dt)
    vs = (*ks[:-1], 128) if ks[-1] == 192 else ks  # MLA's (192, 128)
    q, k, v = (torch.randn(s, generator=gen, device="cuda").to(dtype)
               for s in (qs, ks, vs))
    kw = dict(causal=causal, scale=qs[-1] ** -0.5, attn_cap=cap,
              window=window, q_offset=off, kv_len=kvl)
    if shards:
        kw["shards"] = shards
    return q, k, v, kw


def device_ms(torch, fn, iters: int, reps: int) -> list[float]:
    """``reps`` means of ``iters`` calls by CUDA events, each after a
    warm-up, the calls queued behind a sleep on the card: device time,
    not the host's launch rate."""
    times = []
    for _ in range(reps):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ahead = min(2 * iters * (time.perf_counter() - t0), 0.05)
        torch.cuda._sleep(int(ahead * 2e9))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return times


def sdpa_call(torch, q, k, v, kw):
    """``scaled_dot_product_attention`` on a case's inputs with its
    boolean mask (as ``chip_smoke.py``'s phase 7 builds it: ``kv_len``,
    the causal edge and the window at each row's absolute position; a
    partial launch's rows at their shard's positions), no cap (SDPA takes
    none): the library's yardstick, which the port never calls."""
    import torch.nn.functional as F
    shards = kw.get("shards")
    inner = q.shape[1] if q.dim() == 5 else q.shape[0]
    if q.dim() == 5:
        q, k, v = (t.flatten(0, 1) for t in (q, k, v))
    rows, sq, sk = q.shape[0], q.shape[1], k.shape[1]
    off, kvl, win = kw["q_offset"], kw["kv_len"], kw["window"]
    mask = None
    if kw["causal"] or kvl is not None or shards:
        # one mask for every row (phase 7's), a shard's own where split
        row = torch.arange(rows if shards else 1, device="cuda")
        base = (row // inner % shards) * sk if shards else row
        kp = base[:, None, None] + torch.arange(sk, device="cuda")[None, None]
        pos = off + torch.arange(sq, device="cuda")[None, :, None]
        mask = kp < (kvl if kvl is not None else sk * (shards or 1))
        if kw["causal"]:
            mask = mask & (kp <= pos)
            if win:
                mask = mask & (kp > pos - win)
        mask = mask[:, None]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, scale=kw["scale"], enable_gqa=True)


def time_tree(tree: str, iters: int, reps: int) -> list[dict]:
    """Every case on ``tree``'s kernel (this process imports that tree),
    SDPA beside it and the launch's byte bound."""
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch
    from repro_torch.kernels import flash_attn as fa

    out = []
    for case in CASES:
        q, k, v, kw = draw(torch, case)
        o, lse = fa.attention_fwd(q, k, v, **kw)
        torch.cuda.synchronize()
        digest = hashlib.sha256(
            o.contiguous().view(torch.uint8).cpu().numpy().tobytes()
            + lse.cpu().numpy().tobytes()).hexdigest()
        times = device_ms(torch, lambda: fa.attention_fwd(q, k, v, **kw),
                          iters, reps)
        sdpa = device_ms(torch, sdpa_call(torch, q, k, v, kw), iters, reps)
        nbytes = fa.bytes_moved(q, k, v, kw["kv_len"], window=kw["window"],
                                q_offset=kw["q_offset"],
                                shards=kw.get("shards"))
        out.append(dict(case=case[0], ms=statistics.median(times),
                        ms_reps=times, sdpa_ms=statistics.median(sdpa),
                        byte_bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                        bits=digest[:16]))
        del q, k, v, o, lse
    return out


def sweep(tree: str, iters: int, reps: int) -> list[dict]:
    """The bf16 decode cases at forced split counts (``SWEEP_SPLITS``
    that the keys allow, and the plan's own), each joined in a cluster
    (at most ``DECODE_CLUSTER`` splits) and through scratch, on
    ``tree``'s kernel: the design runs of the plan's rule."""
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch
    from repro_torch.kernels import flash_attn as fa

    out = []
    real_splits, real_cluster = fa._mma_splits, fa.decode_cluster
    for case in CASES:
        q, k, v, kw = draw(torch, case)
        if q.dtype != torch.bfloat16 or not decode_shaped(case):
            continue
        n, b = (q.shape[0], q.shape[1]) if q.dim() == 5 else (1, q.shape[0])
        sq, h, hd = q.shape[-3:]
        plan = fa.decode_plan(
            n, b, h, k.shape[-2], sq, k.shape[-3], hd, v.shape[-1], q.dtype,
            causal=kw["causal"], window=kw["window"],
            q_offset=kw["q_offset"],
            kv_len=kw["kv_len"] or k.shape[-3] * (kw.get("shards") or 1),
            shards=kw.get("shards"))
        row = dict(case=case[0], plan=list(plan), blocks=n * b * k.shape[-2],
                   times={})
        for s in sorted({x for x in SWEEP_SPLITS if x <= plan.tiles}
                        | {plan.splits}):
            for join in ("cluster", "scratch"):
                if join == "cluster" and s > fa.DECODE_CLUSTER:
                    continue
                if join == "scratch" and s == 1:
                    continue
                fa._mma_splits = lambda blocks, seen, tiles, per_sm, s=s: s
                fa.decode_cluster = (lambda splits, hd, vd, blocks, c=join:
                                     c == "cluster" or splits == 1)
                ms = device_ms(torch, lambda: fa.attention_fwd(q, k, v, **kw),
                               iters, reps)
                row["times"][f"{s} {join}"] = statistics.median(ms)
        fa._mma_splits, fa.decode_cluster = real_splits, real_cluster
        out.append(row)
        del q, k, v
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="a directory holding repro_torch (repeatable)")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default="chiprun_out/flash_ab.jsonl")
    ap.add_argument("--sweep", action="store_true",
                    help="time the bf16 decode cases of the first --tree "
                         "(this checkout's src by default) at forced split "
                         "counts and both joins instead")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(time_tree(args.one, args.iters, args.reps)))
        return 0
    import torch
    if not torch.cuda.is_available() or not (args.tree or args.sweep):
        print("flash_ab: needs a CUDA card and at least one --tree",
              file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    if args.sweep:
        tree = (args.tree or [str(Path(__file__).resolve().parents[1]
                                  / "src")])[0]
        lines = [dict(card=card, sweep=tree, iters=args.iters,
                      reps=args.reps)] + sweep(tree, args.iters, args.reps)
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            for line in lines:
                print(json.dumps(line))
                f.write(json.dumps(line) + "\n")
        return 0
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
        table_vs_sdpa={c[0]: [round(run[i]["ms"] / run[i]["sdpa_ms"], 4)
                              for run in runs]
                       for i, c in enumerate(CASES) if c[0] in TABLE},
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
