"""Time the training launcher's step on one NVIDIA GPU.

Run:  python examples_torch/train_step_time.py [--src DIR] [--layers N]
          [--steps 5] -- <repro_torch.launch.train flags>

for example, TinyLlama-1.1B's 22 layers as ``chip_smoke.py`` trains them:

    python examples_torch/train_step_time.py --layers 22 -- --mesh 2x4x1 \\
        --batch 8 --seq 4096 --transport innetwork --reproducible \\
        --lr 5e-6 --device cuda

Builds the job with ``launch.train.setup`` (bf16 compute, fp32 master
weights, ``--layers`` deep), takes one warm-up step and ``--steps`` timed
ones (each synchronised, on the host's clock) and prints one JSON line:
the card's name and power limit (``nvidia-smi``), the median step in ms,
every step, the peak device memory and the losses.  ``--src`` imports
the port from another checkout's ``src`` instead of this one's, so that
two versions are timed by the same code: run each in its own process
on the same card, one after another, alternating them (A, B, B, A).
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parent.parent
                                         / "src"))
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("flags", nargs=argparse.REMAINDER)
    args = ap.parse_args()
    flags = args.flags[1:] if args.flags[:1] == ["--"] else args.flags

    import torch
    if not torch.cuda.is_available():
        print("train_step_time: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, args.src)
    from repro_torch.launch import train as launch

    card = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    over = {} if args.layers is None else {"n_layers": args.layers}
    run = launch.setup(flags, dtype=torch.bfloat16, **over)
    steps, losses = [], []
    for _ in range(args.steps + 1):
        t0 = time.perf_counter()
        losses.append(float(run.train_step()["loss"]))
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0) * 1e3)
    print(json.dumps({
        "src": args.src, "card": card, "layers": run.cfg.n_layers,
        "step_ms": statistics.median(steps[1:]), "steps_ms": steps[1:],
        "warmup_ms": steps[0], "losses": losses,
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
