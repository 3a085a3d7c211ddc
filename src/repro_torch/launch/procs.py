"""Ranks as processes: one OS process a rank over ``torch.distributed``.

``setup`` builds this process's ``mesh.ProcessMesh`` and makes it the
active mesh (``sharding.rules.MeshCfg.rank_mesh`` returns it), from
torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) or from what
``spawn`` sets.  The backend is explicit:

* ``gloo`` on the CPU, and on one card, where every process uses
  ``cuda:0`` (NCCL refuses two ranks on one device).  gloo's collectives
  copy CUDA tensors through the host; its ``send`` of one aborts the
  process, so the mesh stages point-to-point operands through host
  buffers itself (``ProcessMesh._p2p``).  Timings on one card therefore
  measure host copies and loopback sockets, not an interconnect.
* ``nccl`` puts each process on ``cuda:LOCAL_RANK`` and raises before
  any collective where two ranks would share a device.

Every process group is built with a timeout (``mesh.TIMEOUT``), so a
rank that never arrives fails the run instead of hanging it.  Run the
launcher on processes as::

    torchrun --nproc-per-node 8 -m repro_torch.launch.train \\
        --ranks processes --mesh 2x4x1 --device cpu --smoke --steps 2

``spawn(fn, world, backend, store_path)`` starts ``world`` processes
itself, each with the environment of one rank and a ``FileStore`` at
``store_path`` in place of torchrun's TCP store, runs ``fn(*args)`` in
each and returns their results in rank order; a child that fails or
outlives its time limit fails the call, and every child is stopped.
"""
from __future__ import annotations

import datetime
import math
import multiprocessing as mp
import os
import queue as queue_mod
import time
import traceback
from typing import Any, Callable, Sequence

import torch

from repro_torch import mesh as mesh_mod

#: The environment ``spawn`` adds for its children: the backend and the
#: ``FileStore`` path that take the place of torchrun's.
BACKEND_ENV = "REPRO_TORCH_BACKEND"
STORE_ENV = "REPRO_TORCH_STORE"


def device_for(backend: str, device: str, local_rank: int,
               local_world: int) -> torch.device:
    """The device of this rank: the CPU, ``cuda:0`` for every gloo
    process, ``cuda:LOCAL_RANK`` for NCCL, which raises where two ranks
    of this host would share a card."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"unknown backend {backend!r}: gloo or nccl")
    if device == "cpu":
        if backend == "nccl":
            raise ValueError("nccl carries CUDA tensors only: use gloo for "
                             "ranks on the CPU")
        return torch.device("cpu")
    if device != "cuda":
        raise ValueError(f"unknown device {device!r}: cuda or cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("ranks on cuda: no CUDA device (use --device cpu "
                           "to run the ranks on the CPU)")
    if backend == "gloo":
        return torch.device("cuda", 0)
    cards = torch.cuda.device_count()
    if local_world > cards:
        raise RuntimeError(
            f"nccl: {local_world} ranks on this host and {cards} card(s): "
            "NCCL refuses two ranks on one device; use gloo on one card")
    return torch.device("cuda", local_rank)


def _env_int(name: str) -> int:
    try:
        return int(os.environ[name])
    except KeyError:
        raise RuntimeError(f"--ranks processes needs torchrun's environment "
                           f"({name} is not set)") from None


def _store(rank: int, world: int, timeout: datetime.timedelta):
    """The rendezvous store: ``spawn``'s ``FileStore``, else torchrun's
    TCP store at ``MASTER_ADDR:MASTER_PORT`` (rank 0 serves it)."""
    import torch.distributed as dist
    path = os.environ.get(STORE_ENV)
    if path:
        return dist.FileStore(path, world)
    addr = os.environ.get("MASTER_ADDR")
    port = os.environ.get("MASTER_PORT")
    if not (addr and port):
        raise RuntimeError("--ranks processes needs MASTER_ADDR and "
                           "MASTER_PORT (torchrun sets them)")
    return dist.TCPStore(addr, int(port), world, rank == 0, timeout)


def setup(shape: Sequence[int], axes: Sequence[str], *, device: str = "cuda",
          backend: str | None = None,
          timeout: datetime.timedelta = mesh_mod.TIMEOUT
          ) -> tuple[mesh_mod.ProcessMesh, torch.device]:
    """This process's rank of the mesh ``shape`` over ``axes``: checks
    the world size, picks the device (which raises before any
    collective where NCCL would put two ranks on one card), joins the
    default process group and builds the mesh's groups, each with
    ``timeout``, and activates the mesh for this process's main thread.
    A process joins once: a second call for the same mesh and backend
    returns the mesh it built.  Returns the mesh and the device."""
    import torch.distributed as dist
    rank, world = _env_int("RANK"), _env_int("WORLD_SIZE")
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    backend = backend or os.environ.get(BACKEND_ENV, "gloo")
    if world != math.prod(shape):
        raise ValueError(f"WORLD_SIZE {world} is not the mesh's "
                         f"{math.prod(shape)} ranks ({tuple(shape)})")
    dev = device_for(backend, device, local_rank, local_world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    joined = mesh_mod.active()
    if joined is not None:
        if (joined.shape, joined.axes, joined.backend, joined.rank) != (
                tuple(shape), tuple(axes), backend, rank):
            raise ValueError(f"this process is rank {joined.rank} of "
                             f"{joined.shape} over {joined.axes} "
                             f"({joined.backend}) already")
        return joined, dev
    store = _store(rank, world, timeout)
    dist.init_process_group(backend, store=dist.PrefixStore("default", store),
                            rank=rank, world_size=world, timeout=timeout)
    mesh = mesh_mod.ProcessMesh.create(
        dist.PrefixStore("mesh", store), rank, shape, axes, backend=backend,
        timeout=timeout)
    mesh_mod.set_active(mesh)
    return mesh, dev


def is_root() -> bool:
    """Whether this program prints and exports: every emulated run, and
    rank 0 of a run on processes."""
    pm = mesh_mod.active()
    return pm is None or pm.rank == 0


def teardown() -> None:
    """Leave the default process group once every rank is done, and
    drop the active mesh."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
    mesh_mod.set_active(None)


def _child(fn, args, rank: int, world: int, env: dict, results) -> None:
    os.environ.update(env, RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    torch.set_num_threads(1)
    try:
        results.put((rank, fn(*args), None))
    except BaseException:
        results.put((rank, None, traceback.format_exc()))
        raise


def spawn(fn: Callable, world: int, backend: str, store_path: str,
          args: tuple = (), *, timeout: float = 600.0) -> list[Any]:
    """Run ``fn(*args)`` in ``world`` new processes, one a rank, and
    return their results in rank order.

    Each child gets the environment of its rank (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``), ``backend``
    and a ``FileStore`` at ``store_path`` (which must not exist yet) for
    :func:`setup`, and one torch thread.  ``fn`` must be importable by
    the children (a module's top-level function).  A child that raises,
    exits without a result or is still running after ``timeout``
    seconds fails the call with ``RuntimeError``; every child is stopped
    before it returns or raises."""
    if os.path.exists(store_path):
        raise ValueError(f"spawn: the store {store_path} exists already")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    env = {BACKEND_ENV: backend, STORE_ENV: store_path}
    procs = [ctx.Process(target=_child, args=(fn, args, r, world, env,
                                              results), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    got: dict[int, Any] = {}
    deadline = time.monotonic() + timeout
    try:
        while len(got) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise RuntimeError(f"spawn: {world - len(got)} of {world} "
                                   f"ranks gave no result in {timeout} s")
            try:
                rank, value, err = results.get(timeout=min(left, 5.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in got]
                if dead:
                    raise RuntimeError(f"spawn: rank(s) {dead} exited with "
                                       f"{[procs[r].exitcode for r in dead]}"
                                       " and no result") from None
                continue
            if err is not None:
                raise RuntimeError(f"spawn: rank {rank} failed\n{err}")
            got[rank] = value
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
        late = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if late:
            raise RuntimeError(f"spawn: rank(s) {late} did not exit cleanly "
                               f"({[procs[r].exitcode for r in late]})")
        return [got[r] for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(10.0)
        results.close()
