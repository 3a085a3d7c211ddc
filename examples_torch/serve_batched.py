"""Batched serving example: slot-based continuous batching on the
tinyllama smoke config (the port of ``examples/serve_batched.py``), on
the card unless ``--device cpu`` is given; it stops when there is no
card.

Run:  PYTHONPATH=src python examples_torch/serve_batched.py [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.models.registry import get_model
from repro_torch.serve import BatchedServer


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device (use --device cpu)")
    dev = torch.device(args.device)

    cfg = configs.load("tinyllama-1.1b").SMOKE.scaled(dtype=torch.float32)
    model = get_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))

    srv = BatchedServer(model, params, slots=4, max_len=48)
    rng = np.random.default_rng(0)
    reqs = [srv.submit(rng.integers(0, cfg.vocab,
                                    size=int(rng.integers(2, 8))),
                       max_new=12) for _ in range(10)]
    t0 = time.time()
    steps = srv.run()
    dt = time.time() - t0
    toks = sum(len(r.out) for r in reqs)
    print(f"served {len(reqs)} requests / {toks} tokens in {steps} batched "
          f"steps ({toks/dt:.1f} tok/s on {args.device})")
    for r in reqs[:3]:
        print(f"  req {r.rid}: {r.prompt.tolist()} -> {r.out}")
    return reqs


if __name__ == "__main__":
    main()
