"""End-to-end training example: a small llama-family model, a few hundred
steps, the full Flare stack (FSDP gather/reduce-scatter + GradReducer +
AdamW + checkpointing) on a ``(data, model)`` = ``(2, 2)`` mesh of
emulated ranks (the port of ``examples/train_e2e.py``).  On the card
the attention is the flash kernel (fp32, hd 32 at the defaults).

Run:  PYTHONPATH=src python examples_torch/train_e2e.py [--steps 200] \\
          [--device cpu]
Scale up with --d-model/--layers/--steps.  Checkpoints go to ``--ckpt``
(``flare_e2e_ckpt`` under the temporary directory by default).
"""
import argparse
import os
import tempfile
import time

import torch

from repro_torch import tree
from repro_torch.core.engine import FlareConfig
from repro_torch.data import pipeline
from repro_torch.ft import CheckpointManager
from repro_torch.models.base import ModelConfig
from repro_torch.models.registry import get_model
from repro_torch.sharding import rules
from repro_torch.train import trainer


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--vocab", type=int, default=2048)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--algorithm", type=str, default="auto")
    ap.add_argument("--ckpt", type=str, default=os.path.join(
        tempfile.gettempdir(), "flare_e2e_ckpt"))
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device (use --device cpu)")
    dev = torch.device(args.device)

    cfg = ModelConfig(
        name="e2e", family="dense", n_layers=args.layers,
        d_model=args.d_model, n_heads=4, n_kv_heads=2,
        head_dim=args.d_model // 4, d_ff=4 * args.d_model,
        vocab=args.vocab, dtype=torch.float32)
    model = get_model(cfg)
    mcfg = rules.MeshCfg(("data", "model"), (2, 2))
    tcfg = trainer.TrainConfig(
        lr=args.lr,
        flare=FlareConfig(axes=("data",), algorithm=args.algorithm))

    full = model.init(torch.Generator(device=dev).manual_seed(0))
    step = trainer.make_train_step(model, mcfg, tcfg, full)
    params = rules.shard_params(full, mcfg)
    del full
    opt = step.init_opt_state(params)
    cm = CheckpointManager(args.ckpt, keep=2)

    n_params = sum(t[(0,) * step.mesh.ndim].numel()
                   for t in tree.flatten(params)[0])
    print(f"training {n_params/1e6:.1f}M params a rank on 2x2 mesh, "
          f"{args.steps} steps")
    stream = pipeline.synthetic_batches(cfg, args.batch, args.seq, seed=1,
                                        device=dev)
    losses = []
    t0 = time.time()
    for i in range(args.steps):
        params, opt, m = step(params, opt,
                              rules.split_batch(next(stream), mcfg))
        losses.append(float(m["loss"]))
        if i % 20 == 0 or i == args.steps - 1:
            print(f"  step {i:4d} loss {losses[-1]:7.4f} "
                  f"gnorm {float(m['grad_norm']):6.3f}")
        if (i + 1) % 100 == 0:
            unshard = lambda t: rules.unshard_params(        # noqa: E731
                t, mcfg, step.dims, step.tp_dims)
            cm.save(i + 1, {"params": unshard(params),
                            "opt": {"m": unshard(opt["m"]),
                                    "v": unshard(opt["v"]),
                                    "step": opt["step"]}})
    cm.wait()
    dt = time.time() - t0
    toks = args.steps * args.batch * args.seq
    print(f"done: {dt:.1f}s, {toks/dt:.0f} tok/s, "
          f"checkpoints at {args.ckpt}: steps {cm.all_steps()}")
    return {"losses": losses, "steps": cm.all_steps(), "tok_s": toks / dt}


if __name__ == "__main__":
    main()
