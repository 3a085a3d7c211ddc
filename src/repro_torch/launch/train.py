"""Training driver: ``python -m repro_torch.launch.train --arch tinyllama-1.1b``.

The port of the single-job path of ``repro/launch/train.py``: the Flare
train step (FSDP gather + ``GradReducer`` + AdamW) over emulated ranks,
the ``--mesh`` axes laid out as leading tensor axes on one device.  It
runs on the card (``--device cuda``, the default; it stops when there is
none) or, for tests, on the CPU (``--device cpu``).  Examples::

    PYTHONPATH=src python -m repro_torch.launch.train --smoke --steps 3 \\
        --mesh 2x4x1 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --steps 5 \\
        --mesh 2x4x1 --batch 8 --seq 4096 --transport innetwork --reproducible
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --steps 3 \\
        --mesh 2x4x1 --device cpu --transport innetwork --fault-rate 0.01

``--fault-rate`` / ``--fault-seed`` run the switch over a deterministic
lossy fabric (``--transport innetwork`` only): a surviving plan gives the
fault-free bits, a plan past the retry budget degrades to the wire.

Not ported, each stopping with the ROADMAP item that will port it: the
multi-tenant runtime (``--tenants > 1``), checkpoints (``--ckpt-*``,
``--resume``), telemetry and the health plane (``--trace-out``,
``--metrics-out``, ``--health-policy``), and tensor parallelism (a
``model`` axis > 1).
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Any, Iterator


def _parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", type=str, default="tinyllama-1.1b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--mesh", type=str, default="1x1",
                    help="data x model (e.g. 8x1); pod axis via PxDxM")
    ap.add_argument("--algorithm", type=str, default="auto",
                    help="flare allreduce algorithm for replicated grads")
    ap.add_argument("--gather-algorithm", type=str, default="rhd")
    ap.add_argument("--reproducible", action="store_true")
    ap.add_argument("--compression", type=str, default="none")
    ap.add_argument("--sparse-k", type=float, default=0.0)
    ap.add_argument("--transport", type=str, default="auto",
                    choices=("auto", "innetwork"),
                    help="auto = wire collectives; innetwork = the "
                         "emulated sPIN switch data plane")
    ap.add_argument("--device", type=str, default="cuda",
                    choices=("cuda", "cpu"),
                    help="where the ranks run (cpu: tests and bring-up)")
    ap.add_argument("--fault-rate", type=float, default=0.0,
                    help="per-packet drop probability of the injected "
                         "lossy fabric (needs --transport innetwork).  "
                         "Surviving plans stay bitwise; plans past the "
                         "retry budget degrade to the wire")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed of the deterministic fault plan")
    # not ported: each exits naming its ROADMAP item
    ap.add_argument("--tenants", type=int, default=1)
    ap.add_argument("--ckpt-dir", type=str, default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--trace-out", type=str, default=None)
    ap.add_argument("--metrics-out", type=str, default=None)
    ap.add_argument("--health-policy", type=str, default="off",
                    choices=("off", "observe", "auto"))
    return ap.parse_args(argv)


def _refuse_unported(args) -> None:
    if args.tenants > 1:
        sys.exit("--tenants > 1: the multi-tenant switch runtime is not "
                 "ported (ROADMAP queue 1 item 11)")
    if args.ckpt_dir or args.ckpt_every or args.resume:
        sys.exit("--ckpt-dir/--ckpt-every/--resume: checkpoints are not "
                 "ported (ROADMAP queue 1 item 12)")
    if args.trace_out or args.metrics_out or args.health_policy != "off":
        sys.exit("--trace-out/--metrics-out/--health-policy: telemetry and "
                 "the health plane are not ported (ROADMAP queue 1 item 13)")


def _fault_plan(args):
    """``--fault-rate/--fault-seed`` → a deterministic ``FaultPlan``
    (``None`` when no faults are requested, keeping ``FlareConfig``
    valid for the wire transports)."""
    if not args.fault_rate:
        return None
    if args.transport != "innetwork" and args.tenants <= 1:
        sys.exit("--fault-rate models the lossy switch fabric; it needs "
                 "--transport innetwork (or --tenants > 1)")
    from repro_torch.switch.packets import FaultPlan
    return FaultPlan(seed=args.fault_seed, drop=args.fault_rate)


@dataclasses.dataclass
class Run:
    """Everything one training job holds: its config, mesh, train step,
    every rank's parameters and optimizer state, and its data stream."""

    args: argparse.Namespace
    cfg: Any
    mesh: Any
    step: Any
    params: Any
    opt: Any
    stream: Iterator[dict]

    def train_step(self) -> dict:
        """One step on the next batch, split over the ranks; returns its
        metrics."""
        from repro_torch.sharding import rules
        self.params, self.opt, metrics = self.step(
            self.params, self.opt, rules.split_batch(next(self.stream),
                                                     self.mesh))
        return metrics


def setup(argv=None, **overrides) -> Run:
    """Parse the flags and build the job (``overrides`` replace fields
    of the model config, e.g. ``n_layers``)."""
    args = _parse(argv)
    _refuse_unported(args)

    import torch

    from repro_torch import configs
    from repro_torch.core.engine import FlareConfig
    from repro_torch.data import pipeline
    from repro_torch.models.registry import get_model
    from repro_torch.sharding import rules
    from repro_torch.train import trainer

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device (use --device cpu "
                           "to run the ranks on the CPU)")
    dims = [int(x) for x in args.mesh.split("x")]
    if len(dims) == 2:
        axes, shape = ("data", "model"), tuple(dims)
    elif len(dims) == 3:
        axes, shape = ("pod", "data", "model"), tuple(dims)
    else:
        sys.exit("--mesh must be DxM or PxDxM")
    mcfg = rules.MeshCfg(axes, shape)
    if mcfg.tp > 1:
        raise NotImplementedError(
            f"--mesh {args.mesh}: tensor parallelism over 'model' is not "
            "ported (ROADMAP queue 1 item 16)")

    mod = configs.load(args.arch)
    cfg = mod.SMOKE if args.smoke else mod.CONFIG
    if args.smoke:
        cfg = cfg.scaled(dtype=torch.float32)
    if overrides:
        cfg = cfg.scaled(**overrides)
    model = get_model(cfg)
    dev = torch.device(args.device)

    tcfg = trainer.TrainConfig(
        lr=args.lr,
        gather_algorithm=("fixed_tree" if args.reproducible
                          else args.gather_algorithm),
        flare=FlareConfig(axes=mcfg.reduce_axes, algorithm=args.algorithm,
                          reproducible=args.reproducible,
                          compression=args.compression,
                          sparse_k_frac=args.sparse_k,
                          transport=args.transport,
                          fault_plan=_fault_plan(args)))
    full = model.init(torch.Generator(device=dev).manual_seed(0))
    step = trainer.make_train_step(model, mcfg, tcfg, full)
    params = rules.shard_params(full, mcfg)
    del full
    opt = step.init_opt_state(params)
    stream = pipeline.synthetic_batches(cfg, args.batch, args.seq, seed=1,
                                        device=dev)
    return Run(args, cfg, mcfg, step, params, opt, stream)


def main(argv=None) -> list[float]:
    """Run the steps; returns the losses."""
    run = setup(argv)
    args, cfg = run.args, run.cfg
    where = args.device
    if args.device == "cuda":
        import torch
        where += f" ({torch.cuda.get_device_name(0)})"
    print(f"{cfg.name}: {cfg.n_layers} layers, mesh "
          f"{dict(zip(run.mesh.axes, run.mesh.shape))} on {where}",
          flush=True)
    losses = []
    for i in range(args.steps):
        t0 = time.time()
        metrics = run.train_step()
        loss = float(metrics["loss"])
        losses.append(loss)
        print(f"step {i:5d} loss {loss:8.4f} "
              f"gnorm {float(metrics['grad_norm']):8.3f} "
              f"dt {time.time() - t0:6.3f}s", flush=True)
    return losses


if __name__ == "__main__":
    main()
