"""The paper's experiment in miniature: dense vs sparse vs int8 gradient
reduction, wire bytes and convergence, on one model (the port of
``examples/sparse_allreduce_demo.py``).

TinyLlama's SMOKE config in fp32 on a ``(data, model)`` = ``(4, 2)``
mesh of emulated ranks, eight steps a mode.  On the card the int8 mode
runs the ``quantize`` / ``dequant_accum`` / ``dequantize`` kernels and
the sparse mode's densify the ``sparse_accum_slots`` kernel.

Run:  PYTHONPATH=src python examples_torch/sparse_allreduce_demo.py \\
          [--device cpu] [--steps 8]
"""
import argparse

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core import collectives as coll
from repro_torch.core.engine import FlareConfig
from repro_torch.core.sparse import expected_sparse_wire_bytes
from repro_torch.models.registry import get_model
from repro_torch.sharding import rules
from repro_torch.train import trainer

MODES = {
    "dense_ring": FlareConfig(axes=("data",), algorithm="ring"),
    "reproducible": FlareConfig(axes=("data",), algorithm="fixed_tree",
                                reproducible=True),
    "int8": FlareConfig(axes=("data",), compression="int8"),
    "sparse_1pct": FlareConfig(axes=("data",), sparse_k_frac=0.01),
}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device (use --device cpu)")
    dev = torch.device(args.device)

    cfg = configs.load("tinyllama-1.1b").SMOKE.scaled(dtype=torch.float32)
    model = get_model(cfg)
    mcfg = rules.MeshCfg(("data", "model"), (4, 2))
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(
        0, cfg.vocab, (8, 32)).astype(np.int32)).to(dev)
        for k in ("tokens", "labels")}

    out = {}
    print(f"{'mode':<14}{'final loss':>12}{'grad wire bytes/rank':>24}")
    for name, fc in MODES.items():
        tcfg = trainer.TrainConfig(lr=5e-3, flare=fc)
        full = model.init(torch.Generator(device=dev).manual_seed(0))
        step = trainer.make_train_step(model, mcfg, tcfg, full)
        params = rules.shard_params(full, mcfg)
        opt = step.init_opt_state(params)
        losses = []
        for _ in range(args.steps):
            params, opt, m = step(params, opt, rules.split_batch(batch, mcfg))
            losses.append(float(m["loss"]))
        # wire accounting for a 1 MiB gradient bucket
        z = 1 << 20
        if fc.sparse_k_frac > 0:
            wire = expected_sparse_wire_bytes(z // 4, int(z // 4 * 0.01), 4)
        elif fc.compression == "int8":
            wire = 2 * z // 4
        else:
            wire = coll.wire_bytes_per_rank(
                z, 4, algorithm="ring" if name == "dense_ring"
                else "fixed_tree")
        out[name] = {"losses": losses, "wire": wire}
        print(f"{name:<14}{losses[-1]:>12.4f}{wire:>20,.0f}")
    print("\n(all modes converge; compressed/sparse modes move 4-50x fewer "
          "gradient bytes — the paper's F1/F2 trade)")
    return out


if __name__ == "__main__":
    main()
