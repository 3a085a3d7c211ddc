"""Production-mesh dry-run: count every cell on ``meta`` tensors.

The port of ``repro/launch/dryrun.py``.  The reference lowers and
compiles each (arch × shape × mesh) cell for 256 and 512 TPU chips and
reads the compiled program.  The port runs one step of the cell (a
train step, or a serving prefill or decode step) eagerly on ``meta``
tensors, every rank of the production mesh laid out
on the leading tensor axes (``sharding.rules``), and counts it as it
runs (``step_analysis``): no memory and no card.  Run as::

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch tinyllama-1.1b --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

Per cell this script:
  1. takes the production mesh (16×16 single pod / 2×16×16 multi-pod,
     ``mesh.mesh_cfg``),
  2. builds the parameter shapes from ``model.init`` under
     ``FakeTensorMode`` (the counterpart of ``jax.eval_shape``), lays them
     out as ``meta`` tensors on every rank (``rules.shard_params``) with
     the optimizer state and the cell's batch (``pipeline.batch_structs``),
  3. runs ``trainer.make_train_step`` once, forward and backward, under
     ``step_analysis.analyze``: the layers, the FSDP collectives, the
     ``GradReducer`` and AdamW, the kernels through their ``meta``
     branches; a serve cell runs ``serve.engine.make_serve_fns``'s
     prefill or decode step instead (``trace_serve``: the parameters in
     the compute dtype, the cache as ``rules.cache_specs`` lays it out),
  4. prints a rank's FLOPs, bytes, collectives, memory and roofline,
  5. writes a JSON record under ``results/dryrun_torch/``.

The record keeps the reference's keys where
the quantity is the same (``model_flops_global``, ``useful_flops_ratio``,
``collectives``, ``roofline``); ``flops_per_rank`` and
``bytes_per_rank`` are the whole program's over the world size,
``trace_s`` the seconds the step took to count, and ``memory`` a rank's
argument, output and peak live bytes.  The roofline is the H100's
data-sheet peaks: counts and predictions, not card times.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch import configs
from repro_torch import mesh as mesh_mod
from repro_torch.core.engine import FlareConfig
from repro_torch.data import pipeline
from repro_torch.launch import analytic, step_analysis
from repro_torch.models.registry import abstract_params, get_model
from repro_torch.sharding import rules
from repro_torch.train import trainer


def trace_train(model, mcfg: rules.MeshCfg, tcfg: trainer.TrainConfig,
                batch: dict, params: dict | None = None
                ) -> tuple[step_analysis.StepStats, float]:
    """One train step of ``model`` on every rank of ``mcfg`` on ``meta``
    tensors, counted: ``batch`` is the global batch (``meta``),
    ``params`` the global parameters (``abstract_params`` by default).
    Returns the whole program's ``StepStats`` and the seconds the step
    took to count."""
    full = abstract_params(model) if params is None else params
    step = trainer.make_train_step(model, mcfg, tcfg, full)
    p = rules.shard_params(full, mcfg)
    opt = step.init_opt_state(p)
    b = rules.split_batch(batch, mcfg)
    t0 = time.perf_counter()
    stats, _ = step_analysis.analyze(step, p, opt, b)
    return stats, time.perf_counter() - t0


def trace_serve(model, mcfg: rules.MeshCfg, cell,
                params: dict | None = None
                ) -> tuple[step_analysis.StepStats, float]:
    """One serving step of a prefill or decode cell on every rank of
    ``mcfg`` on ``meta`` tensors, counted: the counterpart of the
    reference's ``_serve_lowered``.  The parameters (``abstract_params``
    by default) in the compute dtype, laid out by ``make_serve_fns``'s
    layout; a prefill cell runs ``prefill_fn`` over ``global_batch ×
    seq_len`` tokens, a decode cell one token a row against a
    ``seq_len`` cache (``model.init_cache`` placed by ``cache_specs``) at
    ``pos = seq_len − 1``.  Returns the whole program's ``StepStats`` and
    the seconds the step took to count."""
    from repro_torch.serve.engine import make_serve_fns

    full = abstract_params(model) if params is None else params
    prefill_fn, decode_fn, layout = make_serve_fns(
        model, mcfg, cache_batch=cell.global_batch, cache_len=cell.seq_len,
        device="meta")
    p = layout.shard_params(full)
    batch = pipeline.batch_structs(model.cfg, cell)
    if cell.kind == "prefill":
        fn, args = prefill_fn, (p, batch)
    else:
        cache = layout.shard_cache(model.init_cache(
            cell.global_batch, cell.seq_len, device="meta"))
        cache["pos"] = cell.seq_len - 1
        fn, args = decode_fn, (p, batch["tokens"], cache)
    t0 = time.perf_counter()
    stats, _ = step_analysis.analyze(fn, *args)
    return stats, time.perf_counter() - t0


def trace_flags(flags: list[str], **overrides
                ) -> tuple[step_analysis.StepStats, float, rules.MeshCfg]:
    """The training launcher's job (``launch.train`` flags, ``overrides``
    of its model config) counted on ``meta``: its model, mesh, reduction
    and one global batch of the pipeline's dtypes."""
    from repro_torch.launch import train as launch

    args = launch._parse(flags)
    mcfg, cfg, model = launch.mesh_and_model(args, overrides)
    tcfg = launch.train_config(args, mcfg)
    batch = {k: torch.empty((args.batch, args.seq), dtype=torch.int32,
                            device="meta") for k in ("tokens", "labels")}
    for key, n, fam in (("enc_frames", cfg.encoder_tokens, "audio"),
                        ("vision_embeds", cfg.vision_tokens, "vlm")):
        if cfg.family == fam:               # the pipeline's fp32 frames
            batch[key] = torch.empty((args.batch, n, cfg.d_model),
                                     device="meta")
    stats, secs = trace_train(model, mcfg, tcfg, batch)
    return stats, secs, mcfg


def run_cell(arch: str, cell, *, multi_pod: bool, out_dir: str,
             flare_algorithm: str = "auto", gather_algorithm: str = "rhd",
             tag: str = "", overrides: dict | None = None) -> dict:
    """Count one cell and write its record (returned)."""
    arch = configs.ALIASES.get(arch, arch)   # canonical module name
    cfg = configs.load(arch).CONFIG
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    model = get_model(cfg)
    mcfg = mesh_mod.mesh_cfg(multi_pod=multi_pod)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    chips = mcfg.world
    label = f"{arch}.{cell.name}.{mesh_name}" + (f".{tag}" if tag else "")
    tcfg = trainer.TrainConfig(
        gather_algorithm=gather_algorithm,
        flare=FlareConfig(axes=mcfg.reduce_axes, algorithm=flare_algorithm))
    params = abstract_params(model)
    if cell.kind == "train":
        stats, trace_s = trace_train(model, mcfg, tcfg,
                                     pipeline.batch_structs(cfg, cell),
                                     params)
    else:
        stats, trace_s = trace_serve(model, mcfg, cell, params)
    per = stats.per_rank(chips)
    mf = analytic.model_flops(cfg, params, cell)
    terms = step_analysis.roofline_terms(per.flops, per.bytes_accessed,
                                         per.total_wire_bytes, chips)
    useful_ratio = (mf / chips) / per.flops if per.flops else 0.0
    memory = {"argument_bytes": per.argument_bytes,
              "output_bytes": per.output_bytes,
              "peak_bytes": per.peak_bytes}
    record = {
        "arch": arch, "shape": cell.name, "kind": cell.kind,
        "mesh": mesh_name, "chips": chips,
        "seq_len": cell.seq_len, "global_batch": cell.global_batch,
        "n_layers": cfg.n_layers,
        "flare_algorithm": flare_algorithm,
        "gather_algorithm": gather_algorithm,
        "trace_s": round(trace_s, 1),
        "flops_per_rank": per.flops,
        "bytes_per_rank": per.bytes_accessed,
        "model_flops_global": mf,
        "useful_flops_ratio": useful_ratio,
        "memory": memory,
        "collectives": per.as_dict(),
        "roofline": terms,
    }

    print(f"[dryrun] {label}")
    print(f"  trace {trace_s:.1f}s on meta, {cfg.n_layers} layers")
    print(f"  memory a rank: {memory}")
    print(f"  per-rank: flops={per.flops:.3e} "
          f"bytes={per.bytes_accessed:.3e} "
          f"wire={per.total_wire_bytes:.3e}")
    print(f"  model_flops(global)={mf:.3e} useful_ratio={useful_ratio:.3f}")
    print(f"  collectives: {per.counts}")
    print(f"  roofline: compute={terms['compute_s']:.4f}s "
          f"memory={terms['memory_s']:.4f}s "
          f"collective={terms['collective_s']:.4f}s "
          f"dominant={terms['dominant']}")

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, label + ".json"), "w") as f:
        json.dump(record, f, indent=1)
    return record


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", type=str, default="results/dryrun_torch")
    ap.add_argument("--flare-algorithm", type=str, default="auto")
    ap.add_argument("--gather-algorithm", type=str, default="rhd")
    ap.add_argument("--tag", type=str, default="")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=value (int or str), e.g. "
                         "--set n_layers=2 --set remat_policy=dots")
    args = ap.parse_args(argv)

    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        overrides[k] = int(v) if v.lstrip("-").isdigit() else v

    if args.all:
        cells = configs.all_cells()
    else:
        mod = configs.load(args.arch)
        cells = [(args.arch, s) for s in mod.SHAPES
                 if args.shape in (None, s.name)]

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    t0 = time.perf_counter()
    failures = []
    for arch, cell in cells:
        for mp in meshes:
            mesh_name = "2x16x16" if mp else "16x16"
            label = f"{arch}.{cell.name}.{mesh_name}" \
                + (f".{args.tag}" if args.tag else "")
            path = os.path.join(args.out, label + ".json")
            if args.skip_existing and os.path.exists(path):
                print(f"[dryrun] skip {label} (exists)")
                continue
            try:
                run_cell(arch, cell, multi_pod=mp, out_dir=args.out,
                         flare_algorithm=args.flare_algorithm,
                         gather_algorithm=args.gather_algorithm,
                         tag=args.tag, overrides=overrides)
            except Exception as e:
                traceback.print_exc()
                failures.append((label, repr(e)))
    print(f"\n[dryrun] {time.perf_counter() - t0:.1f} s in all")
    if failures:
        print("\nFAILURES:")
        for l, e in failures:
            print(" ", l, e)
        raise SystemExit(1)
    print("\nall requested dry-run cells traced OK")


if __name__ == "__main__":
    main()
