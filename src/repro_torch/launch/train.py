"""Training driver: ``python -m repro_torch.launch.train --arch tinyllama-1.1b``.

The port of ``repro/launch/train.py``: the Flare
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

    PYTHONPATH=src python -m repro_torch.launch.train --smoke --steps 2 \\
        --mesh 2x4x1 --device cpu --tenants 3 --congestion-replan 0.9

``--arch`` takes every ported config: tinyllama-1.1b (the default),
gemma2-2b, gemma2-27b, granite-20b, qwen3-moe-235b-a22b,
deepseek-v2-lite-16b, llama-3.2-vision-90b (whose batches carry the
pipeline's fp32 ``vision_embeds``), whisper-medium (fp32 ``enc_frames``;
its SMOKE table holds 64 decoder positions, so ``--smoke`` wants
``--seq`` of at most 64, as the reference does) and mamba2-370m::

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \
        --smoke --steps 2 --mesh 2x4x1 --device cpu

``--fault-rate`` / ``--fault-seed`` run the switch over a deterministic
lossy fabric (``--transport innetwork`` only): a surviving plan gives the
fault-free bits, a plan past the retry budget degrades to the wire.

``--tenants K`` trains K jobs, each with its own parameters, optimizer
and data, whose gradients reduce as tenants of ONE shared emulated
switch (``runtime.SessionManager``; implies ``--transport innetwork``).
Job k cycles dense reproducible / int8 / sparse.  The manager prints its
partition, schedule and prediction report after training;
``--partition-policy`` and ``--schedule-order`` pick its policies, and
``--congestion-replan HOTNESS`` then injects that load on the first leaf
switch slot and re-plans the sessions onto the cheapest tree.

``--ckpt-dir D --ckpt-every N`` saves the run's global state
(``{"p": params, "o": opt}``, ``ft.CheckpointManager``, the reference's
layout) every N steps; ``--resume`` restores the latest step, on this
run's ``--mesh`` (an elastic restart onto fewer ranks reshards it), and
trains from there on a fresh data stream, as the reference does::

    PYTHONPATH=src python -m repro_torch.launch.train --smoke --steps 4 \
        --mesh 2x4x1 --device cpu --ckpt-dir /tmp/ck --ckpt-every 2
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --steps 5 \
        --mesh 1x4x1 --device cpu --ckpt-dir /tmp/ck --resume

``--trace-out`` / ``--metrics-out`` record the run in one
``obs.Telemetry`` flight recorder (DESIGN.md §16: step spans, session
events, the data plane's phases, the modeled scheduler tracks) and write
the Chrome-trace and metrics JSON; ``python -m repro_torch.obs.report
METRICS [TRACE]`` summarizes them.

``--health-policy observe|auto`` runs the fabric health plane once after
training (DESIGN.md §17), before the artifacts are written: the
detectors poll the flight recorder, the incident log is printed and, with
``--incidents-out PATH``, exported for ``python -m repro_torch.obs.report
--incidents PATH --fail-on critical``.  ``auto`` (``--tenants`` > 1) also
applies the SLO policy's remediations to the shared switch::

    PYTHONPATH=src python -m repro_torch.launch.train --smoke --steps 2 \
        --mesh 2x4x1 --device cpu --tenants 3 --health-policy auto \
        --incidents-out /tmp/incidents.json

``--ranks processes`` runs one process a rank instead of the emulated
ranks (``launch/procs.py``: a ``ProcessMesh`` over ``torch.distributed``)
under torchrun, whose ``WORLD_SIZE`` must be the product of ``--mesh``.
Every process draws the same seeded parameters and global batches and
keeps its own rank's slice of them (``rules.shard_params``,
``rules.split_batch``), so the ranks' union is the emulated run's input;
rank 0 alone prints and exports.  ``--backend gloo`` (the default) runs
the ranks on the CPU or all on ``cuda:0``; ``nccl`` one a card.  The
int8 and sparse transports run there, in the network and on the wire,
each rank keeping its own error-feedback state; the lossy fabric,
``--tenants`` and ``--ckpt-dir`` raise, naming their ROADMAP item::

    torchrun --nproc-per-node 8 -m repro_torch.launch.train --smoke \
        --steps 2 --mesh 2x4x1 --device cpu --ranks processes \
        --transport innetwork --reproducible
    torchrun --nproc-per-node 8 -m repro_torch.launch.train --smoke \
        --steps 2 --mesh 2x4x1 --device cpu --ranks processes \
        --transport innetwork --compression int8
    torchrun --nproc-per-node 8 -m repro_torch.launch.train --smoke \
        --steps 2 --mesh 2x4x1 --device cpu --ranks processes \
        --sparse-k 0.01

``--mesh PxDxM`` with ``M`` > 1 trains tensor- and expert-parallel over
``model`` (``core.tp``): a rank's heads, FFN columns, experts and
vocabulary rows, the gradients reduced over ``(pod, data)`` with each
``model`` rank's shard as a group of its own, with every transport
option and checkpoint that ``M`` = 1 takes::

    PYTHONPATH=src python -m repro_torch.launch.train --smoke --steps 3 \
        --mesh 2x2x2 --device cpu --transport innetwork --reproducible
"""
from __future__ import annotations

import argparse
import contextlib
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
    ap.add_argument("--ranks", type=str, default="emulated",
                    choices=("emulated", "processes"),
                    help="emulated: every rank in this process, as leading "
                         "tensor axes; processes: this process is one rank "
                         "of a torchrun job (WORLD_SIZE = the mesh's ranks)")
    ap.add_argument("--backend", type=str, default="gloo",
                    choices=("gloo", "nccl"),
                    help="the process groups' backend with --ranks "
                         "processes: gloo (the CPU, or every rank on one "
                         "card) or nccl (one card a rank)")
    ap.add_argument("--fault-rate", type=float, default=0.0,
                    help="per-packet drop probability of the injected "
                         "lossy fabric (needs --transport innetwork).  "
                         "Surviving plans stay bitwise; plans past the "
                         "retry budget degrade to the wire")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed of the deterministic fault plan")
    ap.add_argument("--tenants", type=int, default=1,
                    help="run K concurrent training jobs as tenants of ONE "
                         "shared emulated switch (implies --transport "
                         "innetwork); job k cycles through dense / int8 / "
                         "sparse gradient transports")
    ap.add_argument("--partition-policy", type=str, default="weighted_fair",
                    choices=("static", "weighted_fair", "greedy"),
                    help="HPU-cluster partition policy for --tenants > 1")
    ap.add_argument("--schedule-order", type=str, default="round_robin",
                    choices=("round_robin", "priority"),
                    help="ingress interleave order for --tenants > 1")
    ap.add_argument("--congestion-replan", type=float, default=0.0,
                    metavar="HOTNESS",
                    help="after training, inject HOTNESS background load "
                         "on the fabric's first leaf slot, observe it "
                         "through the congestion monitor and re-plan the "
                         "sessions onto the cheapest tree (needs "
                         "--tenants > 1)")
    ap.add_argument("--ckpt-dir", type=str, default=None,
                    help="checkpoint directory (single job)")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="save the run's state every N steps")
    ap.add_argument("--resume", action="store_true",
                    help="restore the latest checkpoint of --ckpt-dir")
    ap.add_argument("--trace-out", type=str, default=None, metavar="PATH",
                    help="export a Chrome-trace/Perfetto JSON timeline of "
                         "the run (flight recorder, DESIGN.md §16): "
                         "measured step spans, session lifecycle events, "
                         "the data plane's phases and the modeled "
                         "scheduler/perfmodel tracks, with the metric "
                         "snapshot embedded.  Summarize with "
                         "`python -m repro_torch.obs.report`")
    ap.add_argument("--metrics-out", type=str, default=None, metavar="PATH",
                    help="export the metrics registry (typed counters/"
                         "gauges, DESIGN.md §16 name schema) as JSON")
    ap.add_argument("--health-policy", type=str, default="off",
                    choices=("off", "observe", "auto"),
                    help="run the fabric health plane after training "
                         "(DESIGN.md §17): stream the Straggler/"
                         "FaultStorm/CongestionDrift/ModelDivergence "
                         "detectors over the flight recorder and print "
                         "the incident log.  'observe' detects only; "
                         "'auto' additionally binds incidents to the "
                         "SLO policy's remediation paths (replan / "
                         "session recovery; needs --tenants > 1)")
    ap.add_argument("--incidents-out", type=str, default=None,
                    metavar="PATH",
                    help="export the health plane's incident log as "
                         "JSON (needs --health-policy; gate with "
                         "`python -m repro_torch.obs.report --incidents "
                         "PATH --fail-on critical`)")
    return ap.parse_args(argv)


def _check_flags(args) -> None:
    if args.ranks == "processes":
        from repro_torch.mesh import unported
        for on, what, item in ((args.tenants > 1, "--tenants", 22),
                               (args.ckpt_dir, "--ckpt-dir", 23),
                               (args.fault_rate, "--fault-rate", 21)):
            if on:
                raise unported(what, item)
    if args.congestion_replan > 0 and args.tenants <= 1:
        sys.exit("--congestion-replan re-plans the shared switch's "
                 "sessions; it needs --tenants > 1")
    if args.health_policy == "auto" and args.tenants <= 1:
        sys.exit("--health-policy auto binds remediations to the shared "
                 "switch's SessionManager; it needs --tenants > 1 "
                 "(use --health-policy observe for a single job)")
    if args.incidents_out and args.health_policy == "off":
        sys.exit("--incidents-out exports the health plane's log; it "
                 "needs --health-policy observe|auto")


def _telemetry(args):
    """``--trace-out``/``--metrics-out`` (or a health policy, which reads
    the recorder) → one ``obs.Telemetry`` flight recorder threaded through
    ``FlareConfig`` and the ``SessionManager`` (DESIGN.md §16); ``None``
    otherwise: the run is then uninstrumented."""
    if not (args.trace_out or args.metrics_out
            or args.health_policy != "off"):
        return None
    from repro_torch.obs import Telemetry
    return Telemetry.create()


def _step_span(telemetry, step: int):
    """A measured span around one train step (all jobs), or a no-op."""
    if telemetry is None:
        return contextlib.nullcontext()
    return telemetry.tracer.span("train.step", track="steps",
                                 args={"step": step})


def _health(args, telemetry, manager=None) -> None:
    """``--health-policy`` → one deterministic watch pass over the run's
    flight recorder (DESIGN.md §17): poll the detectors, print the
    incident log and (``auto``) the SLO policy's remediation dispatch,
    optionally exporting the log for the report CLI's ``--fail-on``
    gate.  As in the reference the pass watches a fresh
    ``CongestionMonitor`` of the manager, and runs before ``_export``
    renders the modeled tracks."""
    if args.health_policy == "off":
        return
    from repro_torch.obs import HealthMonitor, SLOPolicy
    from repro_torch.obs.health import render_incidents
    monitor = None
    if manager is not None:
        from repro_torch.runtime import CongestionMonitor
        monitor = CongestionMonitor(manager, registry=telemetry.registry)
    hm = HealthMonitor(telemetry, manager=manager, monitor=monitor)
    policy = (SLOPolicy(manager, monitor=monitor)
              if args.health_policy == "auto" else None)
    incidents, taken = hm.watch(1, policy=policy)
    print("== health ==", flush=True)
    print(render_incidents(incidents), flush=True)
    for rem in taken:
        print(f"  -> {rem.action}: "
              f"{'applied' if rem.applied else 'skipped'} "
              f"({rem.detail})", flush=True)
    if args.incidents_out:
        hm.export_incidents(args.incidents_out)
        print(f"incidents -> {args.incidents_out}", flush=True)


def _export(args, telemetry, manager=None) -> None:
    """Render the modeled timeline tracks and write the artifacts."""
    if telemetry is None:
        return
    if manager is not None:
        from repro_torch.obs import timeline
        timeline.manager_tracks(telemetry.tracer, manager)
    if args.trace_out:
        telemetry.export_trace(args.trace_out)
        print(f"trace -> {args.trace_out}", flush=True)
    if args.metrics_out:
        telemetry.export_metrics(args.metrics_out)
        print(f"metrics -> {args.metrics_out}", flush=True)


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
    every rank's parameters and optimizer state, its data stream and its
    flight recorder (``None`` without one)."""

    args: argparse.Namespace
    cfg: Any
    mesh: Any
    step: Any
    params: Any
    opt: Any
    stream: Iterator[dict]
    telemetry: Any = None

    def next_batch(self) -> dict:
        """The stream's next batch, split over the ranks."""
        from repro_torch.sharding import rules
        return rules.split_batch(next(self.stream), self.mesh)

    def train_step(self, batch: dict | None = None) -> dict:
        """One step on ``batch`` (by default the next one); returns its
        metrics."""
        if batch is None:
            batch = self.next_batch()
        self.params, self.opt, metrics = self.step(self.params, self.opt,
                                                   batch)
        return metrics

    def state(self) -> dict:
        """The run's global state, ``{"p": params, "o": opt}``, as the
        reference's checkpoint holds it: parameters and moments unsharded
        (``rules.unshard_params``), and the error-feedback residual of
        rank 0, the one the reference saves."""
        from repro_torch.sharding import rules
        dims, tpd = self.step.dims, self.step.tp_dims
        opt = {"m": rules.unshard_params(self.opt["m"], self.mesh, dims,
                                         tpd),
               "v": rules.unshard_params(self.opt["v"], self.mesh, dims,
                                         tpd),
               "step": self.opt["step"]}
        if "ef" in self.opt:
            opt["ef"] = rules.unshard_params(
                self.opt["ef"], self.mesh, [-1] * len(self.opt["ef"]),
                self._rep_tp_dims())
        return {"p": rules.unshard_params(self.params, self.mesh, dims,
                                          tpd),
                "o": opt}

    def _rep_tp_dims(self) -> list:
        """The TP dims of the leaves the ``GradReducer`` reduces (the
        error-feedback state's), each counted with its stack axis."""
        from repro_torch import tree
        from repro_torch.sharding import rules
        dims = tree.flatten(self.step.dims)[0]
        out = []
        for path, d, t in zip(tree.paths(self.step.dims), dims,
                              tree.flatten(self.step.tp_dims)[0]):
            if d < 0:
                out.append(t + int(rules._leaf_name(path)[1]) if t >= 0
                           else -1)
        return out

    def load_state(self, state: dict) -> None:
        """Lay a global state (:meth:`state`, or a restored checkpoint) out
        on this run's mesh, which may differ from the saving one (elastic
        restart).  The error-feedback residual goes to every rank, as the
        reference restores its one saved copy."""
        import torch

        from repro_torch.sharding import rules
        opt = {"m": rules.shard_params(state["o"]["m"], self.mesh),
               "v": rules.shard_params(state["o"]["v"], self.mesh),
               "step": state["o"]["step"]}
        if "ef" in state["o"]:
            opt["ef"] = [rules.replicate(e, self.mesh, t) for e, t in zip(
                state["o"]["ef"], self._rep_tp_dims())]
        self.params = rules.shard_params(state["p"], self.mesh)
        self.opt = opt


def _prepare(args, overrides):
    """The device, the mesh config and the model the flags ask for."""
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device (use --device cpu "
                           "to run the ranks on the CPU)")
    return (torch.device(args.device), *mesh_and_model(args, overrides))


def mesh_and_model(args, overrides):
    """The mesh config, the model config and the model the flags ask for
    (no device: the dry-run traces them on ``meta``)."""
    import torch

    from repro_torch import configs
    from repro_torch.models.registry import get_model
    from repro_torch.sharding import rules

    dims = [int(x) for x in args.mesh.split("x")]
    if len(dims) == 2:
        axes, shape = ("data", "model"), tuple(dims)
    elif len(dims) == 3:
        axes, shape = ("pod", "data", "model"), tuple(dims)
    else:
        sys.exit("--mesh must be DxM or PxDxM")
    mcfg = rules.MeshCfg(axes, shape)

    mod = configs.load(args.arch)
    cfg = mod.SMOKE if args.smoke else mod.CONFIG
    if args.smoke:
        cfg = cfg.scaled(dtype=torch.float32)
    if overrides:
        cfg = cfg.scaled(**overrides)
    return mcfg, cfg, get_model(cfg)


def _job(args, dev, mcfg, cfg, model, tcfg, *, init_seed: int,
         data_seed: int, manager=None, tenant: str | None = None,
         telemetry=None) -> Run:
    """One job: its parameters from ``init_seed``, its train step (a
    tenant of ``manager`` when given), optimizer state and data."""
    import torch

    from repro_torch.data import pipeline
    from repro_torch.sharding import rules
    from repro_torch.train import trainer

    full = model.init(torch.Generator(device=dev).manual_seed(init_seed))
    step = trainer.make_train_step(model, mcfg, tcfg, full,
                                   reduce_manager=manager, tenant=tenant)
    params = rules.shard_params(full, mcfg)
    del full
    opt = step.init_opt_state(params)
    stream = pipeline.synthetic_batches(cfg, args.batch, args.seq,
                                        seed=data_seed, device=dev)
    return Run(args, cfg, mcfg, step, params, opt, stream, telemetry)


def train_config(args, mcfg, telemetry=None):
    """The ``TrainConfig`` of one job's flags."""
    from repro_torch.core.engine import FlareConfig
    from repro_torch.train import trainer

    return trainer.TrainConfig(
        lr=args.lr,
        gather_algorithm=("fixed_tree" if args.reproducible
                          else args.gather_algorithm),
        flare=FlareConfig(axes=mcfg.reduce_axes, algorithm=args.algorithm,
                          reproducible=args.reproducible,
                          compression=args.compression,
                          sparse_k_frac=args.sparse_k,
                          transport=args.transport,
                          fault_plan=_fault_plan(args),
                          telemetry=telemetry))


def setup(argv=None, **overrides) -> Run:
    """Parse the flags and build the job (``overrides`` replace fields
    of the model config, e.g. ``n_layers``)."""
    args = _parse(argv)
    _check_flags(args)
    if args.tenants > 1:
        raise ValueError("--tenants > 1 builds several jobs: use "
                         "setup_tenants")
    dev, mcfg, cfg, model = _prepare(args, overrides)
    if args.ranks == "processes":
        from repro_torch.launch import procs
        rm = mcfg.rank_mesh()
        dev = procs.setup(rm.shape, rm.axes, device=args.device,
                          backend=args.backend)[1]
    telemetry = _telemetry(args)
    tcfg = train_config(args, mcfg, telemetry)
    return _job(args, dev, mcfg, cfg, model, tcfg, init_seed=0, data_seed=1,
                telemetry=telemetry)


@dataclasses.dataclass
class Tenants:
    """K training jobs that reduce as tenants of one shared switch.

    ``jobs`` holds ``(name, kind, run)`` per job; every job's
    ``GradReducer`` is a tenant of ``manager``, and all record into
    ``telemetry`` (``None`` without a flight recorder).
    """

    args: argparse.Namespace
    manager: Any
    jobs: list
    telemetry: Any = None

    def train_step(self) -> list[float]:
        """One step of every job, in order; returns their losses."""
        return [float(run.train_step()["loss"]) for _, _, run in self.jobs]

    def replan(self):
        """The ``--congestion-replan`` pass: inject the load on the first
        leaf slot, observe it and re-plan.  Prints the reference's line
        and returns the ``ReplanResult``."""
        from repro_torch.runtime import CongestionMonitor

        mgr = self.manager
        tm = self.telemetry
        monitor = CongestionMonitor(
            mgr, registry=tm.registry if tm is not None else None)
        monitor.inject((1, 0), self.args.congestion_replan)
        res = mgr.replan(monitor, threshold=0.5, hysteresis=0.05)
        fanins = [sorted((len(mgr.tree.nodes[n].children) for n in lvl),
                         reverse=True) for lvl in mgr.tree.levels[1:]]
        print(f"congestion replan: replanned={res.replanned} "
              f"reason={res.reason!r} improvement_x={res.improvement_x:.3f} "
              f"readmitted={list(res.readmitted)} "
              f"evicted={list(res.evicted)} fanins={fanins}", flush=True)
        return res


def setup_tenants(argv=None, **overrides) -> Tenants:
    """Parse the flags and build ``--tenants`` jobs on one shared switch.

    Job k is ``job{k}``: dense reproducible, int8 or sparse (``max(
    --sparse-k, 0.01)``) by k mod 3, parameters from seed k and data
    from seed 100 + k.  Every job's sessions are attached before any
    step runs (``GradReducer.attach``), so step 0 already sees the full
    mix, as in the reference.
    """
    args = _parse(argv)
    _check_flags(args)
    if args.tenants < 2:
        raise ValueError("setup_tenants needs --tenants > 1")

    from repro_torch.core.engine import FlareConfig
    from repro_torch.runtime import SessionManager
    from repro_torch.train import trainer

    dev, mcfg, cfg, model = _prepare(args, overrides)
    reduce_sizes = tuple(s for a, s in zip(mcfg.axes, mcfg.shape)
                         if a in mcfg.reduce_axes)
    telemetry = _telemetry(args)
    manager = SessionManager(mcfg.reduce_axes, reduce_sizes,
                             policy=args.partition_policy,
                             order=args.schedule_order,
                             max_sessions=max(8, 2 * args.tenants),
                             telemetry=telemetry)
    variants = [dict(reproducible=True), dict(compression="int8"),
                dict(sparse_k_frac=max(args.sparse_k, 0.01))]
    jobs = []
    for k in range(args.tenants):
        kw = variants[k % len(variants)]
        tcfg = trainer.TrainConfig(
            lr=args.lr, gather_algorithm=args.gather_algorithm,
            flare=FlareConfig(axes=mcfg.reduce_axes, transport="innetwork",
                              fault_plan=_fault_plan(args),
                              telemetry=telemetry, **kw))
        run = _job(args, dev, mcfg, cfg, model, tcfg, init_seed=k,
                   data_seed=100 + k, manager=manager, tenant=f"job{k}",
                   telemetry=telemetry)
        jobs.append((f"job{k}", sorted(kw)[0], run))
    # registration: every job's sessions, before any job steps
    for _, _, run in jobs:
        run.step.attach(run.params)
    return Tenants(args, manager, jobs, telemetry)


def _run_tenants(argv, **overrides) -> list[list[float]]:
    """``--tenants K``: train the jobs, then print the manager's report
    and, with ``--congestion-replan``, the replan and the new report; run
    the health pass; write the flight recorder's artifacts last."""
    shared = setup_tenants(argv, **overrides)
    args = shared.args
    losses = []
    for step in range(args.steps):
        t0 = time.time()
        with _step_span(shared.telemetry, step):
            row = shared.train_step()
        losses.append(row)
        line = [f"{name}({kind}) {loss:8.4f}"
                for (name, kind, _), loss in zip(shared.jobs, row)]
        print(f"step {step:5d} | " + " | ".join(line) +
              f" | dt {time.time() - t0:6.3f}s", flush=True)
    print(shared.manager.report(), flush=True)
    if args.congestion_replan > 0:
        shared.replan()
        print(shared.manager.report(), flush=True)
    _health(args, shared.telemetry, shared.manager)
    _export(args, shared.telemetry, shared.manager)
    return losses


def main(argv=None, **overrides) -> list:
    """Run the steps; returns the losses (with ``--tenants > 1`` a row of
    every job's losses a step).  With ``--ckpt-dir`` the single job saves
    every ``--ckpt-every`` steps and, with ``--resume``, starts from the
    latest checkpoint: its state, on this run's mesh, and batch 0 of the
    data stream, as the reference's launcher does.  ``overrides`` replace
    fields of the model config, as in :func:`setup`."""
    if _parse(argv).tenants > 1:
        return _run_tenants(argv, **overrides)
    from repro_torch.launch import procs
    run = setup(argv, **overrides)
    args, cfg = run.args, run.cfg
    root = procs.is_root()
    where = args.device
    if args.device == "cuda":
        import torch
        where += f" ({torch.cuda.get_device_name(0)})"
    if args.ranks == "processes":
        where += f", one process a rank ({args.backend})"
    if root:
        print(f"{cfg.name}: {cfg.n_layers} layers, mesh "
              f"{dict(zip(run.mesh.axes, run.mesh.shape))} on {where}",
              flush=True)
    start, cm = 0, None
    if args.ckpt_dir:
        from repro_torch.ft import CheckpointManager
        cm = CheckpointManager(args.ckpt_dir)
        if args.resume and cm.latest_step() is not None:
            start = cm.latest_step()
            run.load_state(cm.restore(start, run.state()))
            print(f"resumed from step {start}", flush=True)
    losses = []
    for i in range(start, args.steps):
        t0 = time.time()
        batch = run.next_batch()
        with _step_span(run.telemetry, i):
            metrics = run.train_step(batch)
            loss = float(metrics["loss"])
        losses.append(loss)
        if root:
            print(f"step {i:5d} loss {loss:8.4f} "
                  f"gnorm {float(metrics['grad_norm']):8.3f} "
                  f"dt {time.time() - t0:6.3f}s", flush=True)
        if cm and args.ckpt_every and (i + 1) % args.ckpt_every == 0:
            cm.save(i + 1, run.state())
    if cm:
        cm.wait()
    if root:
        _health(args, run.telemetry)
        _export(args, run.telemetry)
    if args.ranks == "processes":
        procs.teardown()
    return losses


if __name__ == "__main__":
    main()
