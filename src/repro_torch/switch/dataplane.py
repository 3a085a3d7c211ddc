"""The emulated switch data plane: ingress → aggregate → multicast (§4).

The port of ``repro/switch/dataplane.py``.
Arenas carry the mesh's rank axes in front, ``(*mesh, B, S)``.  Per level
of the mesh's reduction tree (``topology.mesh_levels``), leaf level
first:

  1. **ingress** — every child frames its arena into MTU packets and
     streams them to the level's switch rank.  The child stack is a view
     of the rank axis (``RankMesh.group_stack``), never a per-rank copy.
  2. **aggregate** — the installed handler folds the stack.  Only the
     switch ranks' stacks are folded, all switches of a level in one
     call with a leading group axis: every other rank's result would be
     masked to zero and overwritten by the multicast, so the bits are
     the same as folding on every rank.  The batched plane carries only
     the switch ranks up to the next level (above the leaf level, only
     the stacks of the lower levels' switch ranks hold data).
  3. after the root, the result **multicasts** back down every level.

``batched=True`` runs each level as a few batched operations over the
packed ``(G, P, n, E)`` slot tensor; ``batched=False`` keeps the
per-packet schedule (``packetize`` / header steering / ``depacketize``,
binomial multicast) as the bitwise oracle.

Three planes share this schedule: the dense one
(``switch_allreduce_dense``), the int8 one (``switch_allreduce_int8``,
F1), whose packets carry int8 payloads with an fp32 scales sideband, and
the sparse one (``switch_allreduce_sparse``, §7), whose packets carry
top-k coordinate lists that the switches merge until they would
overflow, then densify.

``fault_plan`` replays a deterministic lossy fabric on every up-hop: the
reliability layer admits each ``(child, packet)`` slot exactly once
(checksum gating, seen-bitmaps, retransmission rounds), so a surviving
plan leaves every plane's result bitwise the fault-free one.  The
batched planes fold the schedule's masks in numpy and gate the stack
with one select a level (``_admit``); the per-packet planes replay every
round on the packets (``_reliable_ingress``).  ``plan_counters`` and
``level_packet_counts`` give the static packet, combine and buffer
counts that ``perfmodel.switch_model`` consumes, and the multi-tenant
runtime (``runtime.SessionManager``) its admission demands; its
contention reaches the planes as ``arrival_perms``.  A ``telemetry``
handle (``obs.Telemetry``) records each plane's phases as spans on the
``"trace"`` process, track ``plane/<tenant>``, and the static retry
rounds of every faulted level as instants (``_PlaneObs``): host-side
events only, so the bits are the same with or without it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import compression, sparse, topology
from repro_torch.kernels import ops
from repro_torch.mesh import RankMesh, require_emulated
from repro_torch.perfmodel import switch_model as sm
from repro_torch.switch import handlers as hd
from repro_torch.switch import packets as pk

DEFAULT_FORMAT = pk.DEFAULT_FORMAT


def resolve_design(data_bytes: int, design: str = "auto",
                   reproducible: bool = False) -> tuple[str, int]:
    """The §6.4 design switchover for one reduction block.

    ``auto`` follows ``perfmodel.switch_model.select_design`` on the
    block size; reproducible mode always takes tree aggregation (§6.4).
    Returns ``(design, n_bufs)``.
    """
    if reproducible:
        return "tree", 1
    if design == "auto":
        return sm.select_design(data_bytes)
    if design not in hd.DESIGNS:
        raise ValueError(f"unknown aggregation design {design!r}")
    return design, (4 if design == "multi" else 1)


def _levels(mesh: RankMesh,
            axes: Sequence[str]) -> tuple[topology.MeshLevel, ...]:
    sizes = tuple(mesh.axis_size(a) for a in axes)
    return topology.mesh_levels(tuple(axes), sizes)


class _PlaneObs:
    """The phase spans of one plane call (DESIGN.md §16).

    Spans land on the ``"trace"`` process, track ``plane/<tenant>``,
    where the reference records them while tracing the plane.  They wrap
    the level's work on the host and add nothing to it, so the result is
    bitwise the same with or without telemetry.  ``telemetry=None``
    degrades every phase to a ``nullcontext``.
    """

    def __init__(self, telemetry, tenant):
        self._tracer = None if telemetry is None else telemetry.tracer
        self._track = f"plane/{tenant}" if tenant else "plane/solo"

    def __call__(self, name, **args):
        if self._tracer is None:
            return contextlib.nullcontext()
        return self._tracer.span(name, track=self._track, process="trace",
                                 args=args or None)

    def instant(self, name, **args):
        if self._tracer is not None:
            self._tracer.instant(name, track=self._track, process="trace",
                                 args=args or None)

    def retries(self, faults):
        """One instant per faulted level: the static retry rounds the
        reliability layer will execute (mirrors ``FaultSchedule``)."""
        for i, f in enumerate(faults):
            if f is not None:
                self.instant(f"plane.retry.l{i + 1}", rounds=int(f.rounds),
                             retransmits=int(f.retransmits),
                             wait_rounds=float(f.wait_rounds))


def _rank_mask(mask: torch.Tensor, mesh: RankMesh,
               x: torch.Tensor) -> torch.Tensor:
    """Broadcast a per-rank boolean over ``x``'s trailing axes."""
    return mask.reshape(mask.shape + (1,) * (x.dim() - mesh.ndim))


def _like(mesh, shape: tuple[int, ...], dtype: torch.dtype,
          device) -> torch.Tensor:
    """A rank-local ``(*lead, *shape)`` tensor's shape and dtype for
    ``ProcessMesh.multicast``, without its storage (one element
    broadcast)."""
    return torch.empty((), dtype=dtype, device=device).expand(
        mesh.lead + tuple(shape))


def _mask_to_switch(out: torch.Tensor, mesh: RankMesh,
                    lvl: topology.MeshLevel) -> torch.Tensor:
    """Place the switches' ``(G, ...)`` aggregates at their ranks of the
    level's axis; every other rank holds zeros."""
    return mesh.scatter_group(out, lvl.axis, lvl.switch_rank)


# ---------------------------------------------------------------------------
# Root multicast.
# ---------------------------------------------------------------------------

def _multicast(x: torch.Tensor, mesh: RankMesh, axis: str,
               switch_rank: int = 0) -> torch.Tensor:
    """Broadcast the switch rank's tensor to every child of the level.

    Power-of-two fan-in: binomial XOR tree rooted at ``switch_rank``
    (log2 P ``ppermute`` hops).  Otherwise a ring broadcast (P−1 hops).
    """
    p = mesh.axis_size(axis)
    if p == 1:
        return x
    root = switch_rank % p
    r_rel = (mesh.axis_index(axis, x.device) - root) % p
    if p & (p - 1) == 0:
        for k in range(p.bit_length() - 1):
            d = 1 << k
            perm = [((root + i) % p, (root + (i ^ d)) % p) for i in range(p)]
            recv = mesh.ppermute(x, axis, perm)
            keep = _rank_mask((r_rel >= d) & (r_rel < 2 * d), mesh, x)
            x = torch.where(keep, recv, x)
    else:
        perm = [((root + i) % p, (root + i + 1) % p) for i in range(p)]
        for s in range(p - 1):
            recv = mesh.ppermute(x, axis, perm)
            x = torch.where(_rank_mask(r_rel == s + 1, mesh, x), recv, x)
    return x


# ---------------------------------------------------------------------------
# Arrival permutations and header steering.
# ---------------------------------------------------------------------------

def _resolve_perm(perm, p: int, n: int) -> np.ndarray | None:
    """Materialise an arrival permutation as a static ``(P, n)`` order.

    ``perm`` is ``(P,)`` (whole streams arrive out of order), ``(P, n)``
    (each packet slot has its own interleaving) or a callable
    ``(P, n) -> perm``.
    """
    if perm is None:
        return None
    if callable(perm):
        perm = perm(p, n)
        if perm is None:
            return None
    perm = np.asarray(perm, np.int64)
    if perm.ndim == 1:
        perm = np.broadcast_to(perm[:, None], (p, n))
    return perm


def _group_order(order: np.ndarray, groups: int,
                 device) -> torch.Tensor:
    """A static ``(P, n)`` order as the ``(G, P, n)`` tensor of a level."""
    o = torch.as_tensor(np.ascontiguousarray(order), device=device)
    return o.expand(groups, *o.shape)


def _apply_arrival(stack, headers: torch.Tensor, perm):
    """Reorder the child streams (a stack, or a dict of stacks) by a
    static arrival permutation; headers ride along so child-order
    handlers can undo it."""
    g, p, n = headers.shape[:3]
    order = _resolve_perm(perm, p, n)
    if order is None:
        return stack, headers
    o = _group_order(order, g, headers.device)
    return hd.apply_order(stack, o), hd.apply_order(headers, o)


def _steered(handler: hd.Handler) -> bool:
    return handler.header_handler in (hd.child_order, hd.child_order_opt)


def _net_order(handler: hd.Handler, arrival, p: int,
               n: int) -> np.ndarray | None:
    """The net stack order after arrival interleave ∘ header steering:
    identity for a child-steered handler (steering inverts any arrival
    permutation), the permutation itself for an arrival-order one."""
    if _steered(handler):
        return None
    return _resolve_perm(arrival, p, n)


# ---------------------------------------------------------------------------
# Reliability layer: lossy ingress + exactly-once recovery.
# ---------------------------------------------------------------------------

class FaultBudgetExceeded(RuntimeError):
    """A fault plan loses packets the retry budget cannot recover.

    Survival is statically known (corruption deterministically fails the
    checksum, so the set of accepted packets is a pure function of the
    schedule): the transport layer pre-checks with :func:`plan_survives`
    and degrades to the wire transport instead of ever running a
    non-surviving plane."""


def _budget_exceeded(sched: pk.FaultSchedule) -> FaultBudgetExceeded:
    return FaultBudgetExceeded(
        f"fault schedule loses packets beyond the retry budget "
        f"({sched.rounds} rounds, {sched.retransmits} retransmits)")


def _new_fault_stats(mesh: RankMesh, device) -> dict:
    """Per-rank fault counters, int32 of the mesh's rank dims
    (``mesh.lead``): every rank counts every level's ingress, as every
    rank replays it in the reference."""
    return {k: torch.zeros(mesh.lead, dtype=torch.int32, device=device)
            for k in ("retransmits", "duplicates_dropped",
                      "corrupt_rejected", "delivered", "wait_rounds")}


@functools.lru_cache(maxsize=16)
def _admission_folds(sched: pk.FaultSchedule) -> tuple[np.ndarray, dict]:
    """The schedule's per-round masks folded over the rounds: clean =
    arrives ∧ ¬corrupt, seen = any clean delivery so far.  Returns the
    final ``(P, n)`` delivered mask and the counters it implies.  Memoised
    per schedule (schedules are cached per plan and shapes, so a plane
    folds each level's masks once); callers must not write to the
    mask."""
    arrives = np.asarray(sched.arrives)
    corrupt = np.asarray(sched.corrupt)
    clean = arrives & ~corrupt
    seen_after = np.cumsum(clean, axis=0) > 0
    seen_before = np.zeros_like(seen_after)
    seen_before[1:] = seen_after[:-1]
    return seen_after[-1], {
        "corrupt_rejected": int(corrupt.sum()),
        "duplicates_dropped": int((clean & seen_before).sum()),
        "delivered": int(seen_after[-1].sum())}


def _batched_admission(sched: pk.FaultSchedule, stats: dict) -> np.ndarray:
    """Vectorized replay of a level's fault schedule.

    The per-packet ``_reliable_ingress`` is exactly-once by construction:
    when the schedule survives, the recovered stack equals the clean
    stack bit for bit, and every counter is a pure function of the
    schedule's masks.  So the batched planes fold those masks in numpy
    and add the counters as constants:

    * ``corrupt_rejected``: every corrupted delivery fails the checksum,
      ``Σ corrupt``;
    * ``duplicates_dropped``: a clean delivery of an already-seen slot;
    * ``delivered``: slots seen after the final round (= P·n iff the
      schedule survives).

    Returns the final ``(P, n)`` delivered mask — all-ones on a
    surviving schedule, so admission never perturbs bits.
    """
    if not sched.survives:
        raise _budget_exceeded(sched)
    delivered, counts = _admission_folds(sched)
    for k, v in counts.items():
        stats[k] += v
    stats["retransmits"] += sched.retransmits
    stats["wait_rounds"] += round(sched.wait_rounds)
    return delivered


def _admit(stack, fault: pk.FaultSchedule | None, fault_stats: dict):
    """Apply a level's batched admission mask to the gathered stack (or
    to each stack of a dict: the int8 scales sideband fate-shares the
    payload's mask).  The mask goes to the device once a level; the
    select writes the admitted stack as a new tensor, as the reference
    does."""
    if fault is None:
        return stack
    mask = _batched_admission(fault, fault_stats)
    leaf = next(iter(stack.values())) if isinstance(stack, dict) else stack
    m = torch.as_tensor(mask, device=leaf.device)

    def one(l):
        return hd.fold_once(l.new_zeros(()), l, m)
    if isinstance(stack, dict):
        return {k: one(v) for k, v in stack.items()}
    return one(stack)


def _per_rank(count: torch.Tensor, mesh: RankMesh,
              lvl: topology.MeshLevel) -> torch.Tensor:
    """A level's per-switch ``(G,)`` count at every rank of its group."""
    return count.reshape(mesh.collapse(lvl.axis).shape).expand(mesh.shape)


def _reliable_ingress(stack, headers: torch.Tensor, sched: pk.FaultSchedule,
                      stats: dict, mesh: RankMesh, lvl: topology.MeshLevel):
    """Replay a level's fault schedule on the ``(G, P, n, ...)`` child
    stacks and rebuild the clean canonical stack, exactly once per packet.

    Each delivery round: the round's packets arrive (possibly
    bit-corrupted on the wire, possibly interleaved across children),
    header steering un-permutes them by ``HDR_CHILD``, the checksum
    header gates out corrupted payloads, and the seen-bitmap admits each
    ``(child, packet)`` slot at most once (``handlers.accept_mask`` /
    ``fold_once``).  Corruption targets the first leaf of the payload in
    sorted-key order (``"q"`` of the int8 plane's ``{"q", "scale"}``,
    whose headers ride the stack); sidebands fate-share the accept mask.
    One schedule serves every switch of the level.  Returns the
    recovered stack and headers; adds the counters to ``stats`` at every
    rank of each switch's group."""
    if not sched.survives:
        raise _budget_exceeded(sched)
    keys = sorted(stack) if isinstance(stack, dict) else None
    leaves = [stack[k] for k in keys] if keys else [stack]
    g, p, n = headers.shape[:3]
    dev = headers.device
    seen = torch.zeros((g, p, n), dtype=torch.bool, device=dev)
    acc = [torch.zeros_like(l) for l in leaves]
    acc_hdr = torch.zeros_like(headers)
    rejected = torch.zeros(g, dtype=torch.int32, device=dev)
    dropped = torch.zeros(g, dtype=torch.int32, device=dev)
    for r in range(sched.rounds):
        arrives = torch.as_tensor(sched.arrives[r], device=dev)
        any_corrupt = bool(np.asarray(sched.corrupt[r]).any())
        if any_corrupt:
            # wire leg: corrupt the checksummed stream's masked packets
            corrupt = torch.as_tensor(sched.corrupt[r], device=dev)
            lvs = [pk.corrupt_first_elem(leaves[0], corrupt)] + leaves[1:]
        else:
            lvs = list(leaves)
        hdr_r = headers
        perm = np.asarray(sched.perms[r])
        if not np.array_equal(perm, np.arange(p)):
            # the round's streams arrive interleaved; steer them back by
            # the CHILD header, never by arrival position
            order = _group_order(np.broadcast_to(perm[:, None], (p, n)), g,
                                 dev)
            lvs = [hd.apply_order(l, order) for l in lvs]
            hdr_r = hd.apply_order(headers, order)
            back = hd.child_order(hdr_r)
            lvs = [hd.apply_order(l, back) for l in lvs]
            hdr_r = hd.apply_order(hdr_r, back)
        if any_corrupt:
            ok = pk.payload_checksum(lvs[0]) == hdr_r[..., pk.HDR_CSUM]
        else:
            # injection is the only corruption source in the emulation:
            # with none scheduled this round the verify is a pass
            ok = torch.ones((g, p, n), dtype=torch.bool, device=dev)
        accept = hd.accept_mask(arrives, ok, seen)
        acc = [hd.fold_once(a, l, accept) for a, l in zip(acc, lvs)]
        acc_hdr = hd.fold_once(acc_hdr, hdr_r, accept)
        rejected += (arrives & ~ok).sum(dim=(1, 2), dtype=torch.int32)
        dropped += (arrives & ok & seen).sum(dim=(1, 2), dtype=torch.int32)
        seen = seen | (arrives & ok)
    stats["corrupt_rejected"] += _per_rank(rejected, mesh, lvl)
    stats["duplicates_dropped"] += _per_rank(dropped, mesh, lvl)
    stats["delivered"] += _per_rank(seen.sum(dim=(1, 2), dtype=torch.int32),
                                    mesh, lvl)
    stats["retransmits"] += sched.retransmits
    stats["wait_rounds"] += round(sched.wait_rounds)
    out = dict(zip(keys, acc)) if keys else acc[0]
    return out, acc_hdr


def level_packet_counts(level_fanins: Sequence[int], num_buckets: int,
                        bucket_elems: int, dtype: torch.dtype, *,
                        mode: str = "dense",
                        fmt: pk.PacketFormat = DEFAULT_FORMAT,
                        block: int = 256, k_max: int | None = None,
                        density_threshold: float = 0.25,
                        ) -> list[tuple[int, int]]:
    """Per up-hop ``(fanin, packets per child)`` for one plane's schedule.

    The fault plan keys its per-level schedules on these shapes, so this
    is the single source of truth shared by the planes (which inject)
    and the transport layer (which pre-checks survival): dense streams a
    constant ``B · ceil(S/N)`` packets per level, int8 frames the
    quantized (block-padded) arena, and the sparse plane's packed
    coordinate lists grow ``cap *= fanin`` per level until the density
    threshold trips and it continues as dense fp32."""
    if mode == "dense":
        n = num_buckets * fmt.packets_per_block(bucket_elems, dtype)
        return [(p, n) for p in level_fanins]
    if mode == "int8":
        s = bucket_elems + (-bucket_elems) % block
        n = num_buckets * fmt.packets_per_block(s, torch.int8)
        return [(p, n) for p in level_fanins]
    if mode == "sparse":
        if k_max is None:
            raise ValueError("sparse level_packet_counts needs k_max")
        out, cap, dense = [], int(k_max), False
        for p in level_fanins:
            if not dense and sparse.densify_step(cap * p, bucket_elems,
                                                 density_threshold):
                dense = True
            if dense:
                n = num_buckets * fmt.packets_per_block(bucket_elems,
                                                        torch.float32)
            else:
                n = num_buckets * fmt.packets_per_block(2 * cap, torch.int32)
                cap *= p
            out.append((p, n))
        return out
    raise ValueError(f"unknown plane mode {mode!r}")


@functools.lru_cache(maxsize=8)
def _schedules(plan: pk.FaultPlan, counts: tuple[tuple[int, int], ...]
               ) -> tuple[pk.FaultSchedule | None, ...]:
    return tuple(plan.schedule(i, p, n) if plan.applies(i) else None
                 for i, (p, n) in enumerate(counts))


def fault_schedules(plan: pk.FaultPlan | None,
                    counts: Sequence[tuple[int, int]],
                    ) -> list[pk.FaultSchedule | None]:
    """One schedule per level (``None`` where the plan doesn't apply).

    Cached per ``(plan, counts)``: an eager caller would otherwise draw
    the same masks on every reduction (hundreds of ms at full width).
    The schedules are shared between callers; never write to them."""
    counts = tuple((int(p), int(n)) for p, n in counts)
    if plan is None:
        return [None] * len(counts)
    return list(_schedules(plan, counts))


def plan_survives(plan: pk.FaultPlan | None,
                  counts: Sequence[tuple[int, int]]) -> bool:
    """Static pre-check: does every level recover within the budget?

    Deterministic in (plan, level shapes) — exactly the schedules the
    plane will replay — so the transport can decide before running
    whether to go in-network or degrade to the wire."""
    return all(s is None or s.survives
               for s in fault_schedules(plan, counts))


# ---------------------------------------------------------------------------
# Dense / fixed-tree data plane.
# ---------------------------------------------------------------------------

def _dense_level(arena: torch.Tensor, mesh: RankMesh,
                 lvl: topology.MeshLevel, handler: hd.Handler, design: str,
                 n_bufs: int, fmt: pk.PacketFormat, arrival,
                 fault: pk.FaultSchedule | None = None,
                 fault_stats: dict | None = None) -> torch.Tensor:
    """One up-hop, packet by packet: frame, stream to the switch (through
    the reliability layer under a fault schedule), steer by header,
    aggregate, place at the switch rank."""
    b, s = arena.shape[-2:]
    r = mesh.axis_index(lvl.axis, arena.device)
    stream = pk.packetize(arena, fmt, child_rank=r)
    payload = mesh.group_stack(stream.payload, lvl.axis, lvl.switch_rank)
    headers = mesh.group_stack(stream.headers, lvl.axis, lvl.switch_rank)
    if fault is not None:
        payload, headers = _reliable_ingress(payload, headers, fault,
                                             fault_stats, mesh, lvl)
    payload, headers = _apply_arrival(payload, headers, arrival)
    egress, _ = hd.run(handler, payload, headers, design=design,
                       n_bufs=n_bufs, ctx={"dtype": arena.dtype})
    e = fmt.payload_elems(arena.dtype)
    npkt = fmt.packets_per_block(s, arena.dtype)
    out = egress.reshape(egress.shape[0], b, npkt * e)[..., :s]
    return _mask_to_switch(out, mesh, lvl)


def _multicast_arena(arena: torch.Tensor, mesh: RankMesh,
                     lvl: topology.MeshLevel,
                     fmt: pk.PacketFormat) -> torch.Tensor:
    """One down-hop: the switch multicasts its framed result."""
    b, s = arena.shape[-2:]
    stream = pk.packetize(arena, fmt, child_rank=lvl.switch_rank)
    stream = pk.PacketStream(
        headers=_multicast(stream.headers, mesh, lvl.axis, lvl.switch_rank),
        payload=_multicast(stream.payload, mesh, lvl.axis, lvl.switch_rank))
    return pk.depacketize(stream, fmt, b, s)


def _dense_level_batched(arena: torch.Tensor, mesh: RankMesh,
                         lvl: topology.MeshLevel, handler: hd.Handler,
                         design: str, n_bufs: int, plan: pk.FramePlan,
                         arrival, fault: pk.FaultSchedule | None = None,
                         fault_stats: dict | None = None
                         ) -> tuple[torch.Tensor, RankMesh]:
    """One up-hop as a few batched operations over the packed tensor:
    pack, take the switches' child stacks (a view), fold the schedule's
    admission mask in (``_admit``), fold every switch of the level at
    once, unpack.

    ``arena`` holds only the ranks that still carry data: ``mesh`` is
    collapsed to the switch rank on every lower level's axis.  Returns
    the switches' aggregates on ``mesh.collapse(lvl.axis)``.  Every other
    rank's result would be masked to zero and overwritten by the
    multicast, so it is neither folded nor stored; at the switch ranks
    the bits are those of ``_dense_level``.  On a ``ProcessMesh`` the
    children send their packed arenas to the switch rank, which folds its
    one group (``G = 1``); a child that is not the switch gets ``None``.
    """
    ctx = {"dtype": arena.dtype}
    up = mesh.collapse(lvl.axis, lvl.switch_rank)
    stack = mesh.group_stack(plan.pack(arena), lvl.axis,
                             lvl.switch_rank)                 # (G, P, n, E)
    if stack is None:
        return None, up
    stack = _admit(stack, fault, fault_stats)
    order = _net_order(handler, arrival, lvl.fanin, plan.num_packets)
    if order is not None:
        stack = hd.apply_order(
            stack, _group_order(order, stack.shape[0], stack.device))
    agg, _ = handler.payload_handler(stack, None, design, n_bufs, ctx)
    del stack           # release the packed copy before the level's output
    out = plan.unpack(handler.completion_handler(agg, ctx))   # (G, B, S)
    return out.reshape(up.lead + tuple(out.shape[1:])), up


def switch_allreduce_dense(arena: torch.Tensor, mesh: RankMesh,
                           axes: Sequence[str], *,
                           reproducible: bool = False,
                           design: str = "auto",
                           fmt: pk.PacketFormat = DEFAULT_FORMAT,
                           arrival_perms: Sequence | None = None,
                           fault_plan: pk.FaultPlan | None = None,
                           with_fault_stats: bool = False,
                           batched: bool = True,
                           mean: bool = False,
                           telemetry=None, tenant: str | None = None):
    """Allreduce a ``(*mesh, B, S)`` arena through the emulated switch tree.

    ``reproducible=True`` installs the ``fixed_tree`` handler: combines
    follow the aligned binary tree over child ranks at every level, so
    the result is bitwise-invariant to packet arrival order and
    bitwise-equal to the wire ``fixed_tree`` collective.
    ``arrival_perms`` holds one arrival permutation (or None) per level.

    ``fault_plan`` replays a deterministic lossy fabric on every up-hop;
    a surviving plan leaves the result bitwise the fault-free one.
    ``with_fault_stats`` returns ``(out, fstats)``: the retry and
    rejection counters, int32 of the mesh's rank dims.  ``telemetry``
    records the phases under ``tenant`` (``_PlaneObs``).

    On a ``ProcessMesh`` the batched plane runs as the switch's own
    traffic (``ProcessMesh.group_stack``, ``multicast``); the lossy
    fabric and the per-packet plane raise there.
    """
    if fault_plan is not None:
        require_emulated(mesh, "the lossy fabric (fault_plan)", 21)
    if not batched:
        require_emulated(mesh, "the per-packet plane (batched=False)", 25)
    b, s = arena.shape[-2:]
    handler = hd.get_handler("fixed_tree" if reproducible else "dense_sum")
    design, n_bufs = resolve_design(s * arena.element_size(), design,
                                    reproducible)
    levels = _levels(mesh, axes)
    fstats = _new_fault_stats(mesh, arena.device)
    if len(levels) == 1 and levels[0].fanin == 1:
        return (arena, fstats) if with_fault_stats else arena
    faults = fault_schedules(fault_plan, level_packet_counts(
        [l.fanin for l in levels], b, s, arena.dtype, mode="dense", fmt=fmt))
    obs = _PlaneObs(telemetry, tenant)
    obs.retries(faults)
    cur = arena
    if batched:
        plan = pk.FramePlan(b, s, arena.dtype, fmt)
        held = mesh
        for i, lvl in enumerate(levels):
            arrival = arrival_perms[i] if arrival_perms is not None else None
            if not held.holds:          # a child of a lower switch
                continue
            with obs(f"plane.l{i + 1}", mode="dense", fanin=lvl.fanin):
                cur, held = _dense_level_batched(cur, held, lvl, handler,
                                                 design, n_bufs, plan,
                                                 arrival, faults[i], fstats)
        with obs("plane.multicast", mode="dense"):
            cur = mesh.multicast(cur, held, arena)
    else:
        for i, lvl in enumerate(levels):
            arrival = arrival_perms[i] if arrival_perms is not None else None
            with obs(f"plane.l{i + 1}", mode="dense", fanin=lvl.fanin):
                cur = _dense_level(cur, mesh, lvl, handler, design, n_bufs,
                                   fmt, arrival, faults[i], fstats)
        with obs("plane.multicast", mode="dense"):
            for lvl in reversed(levels):
                cur = _multicast_arena(cur, mesh, lvl, fmt)
    if mean:
        cur = mesh.mean(cur, axes)
    return (cur, fstats) if with_fault_stats else cur


# ---------------------------------------------------------------------------
# int8 dequant-accumulate data plane (F1).
# ---------------------------------------------------------------------------

def _scales_format(fmt: pk.PacketFormat, block: int) -> pk.PacketFormat:
    """The fp32 scales sideband: one packet per payload packet.

    Requires the payload MTU to hold whole quantization blocks — that
    is what keeps the sideband's packet count aligned with the
    payload's (``E_s = E / block``) through any tail padding.
    """
    e = fmt.payload_elems(torch.int8)
    if e % block:
        raise ValueError(
            f"int8 switch transport needs the packet MTU ({fmt.mtu_bytes} B) "
            f"to hold whole quantization blocks of {block}")
    return pk.PacketFormat(mtu_bytes=e // block * 4)


def _int8_level_batched(acc: torch.Tensor, mesh: RankMesh,
                        lvl: topology.MeshLevel, handler: hd.Handler,
                        design: str, n_bufs: int, block: int,
                        qplan: pk.FramePlan, splan: pk.FramePlan,
                        fault: pk.FaultSchedule | None = None,
                        fault_stats: dict | None = None
                        ) -> tuple[torch.Tensor, RankMesh]:
    """One up-hop of the int8 plane over the packed tensors: the ranks
    that hold data quantize, the switches fold their children's int8
    stacks with the scales sideband (views of the rank axis), all
    switches of the level at once.  The handler is child-steered, so any
    arrival interleave composes with its steering to the identity and is
    never materialised.  Under a fault schedule ``"q"`` is the admission-
    gated stream and the scales sideband fate-shares its mask.  Returns
    the switches' fp32 aggregates on ``mesh.collapse(lvl.axis)``.  On a
    ``ProcessMesh`` the children send their int8 payload and scales to
    the switch rank, which folds its one group (``G = 1``); a child that
    is not the switch gets ``None``."""
    up = mesh.collapse(lvl.axis, lvl.switch_rank)
    q, scales = compression.quantize_int8(acc, block)
    stack = {"q": mesh.group_stack(qplan.pack(q), lvl.axis, lvl.switch_rank),
             "scale": mesh.group_stack(splan.pack(scales), lvl.axis,
                                       lvl.switch_rank)}
    del q, scales
    if stack["q"] is None:
        return None, up
    stack = _admit(stack, fault, fault_stats)
    agg, _ = handler.payload_handler(stack, None, design, n_bufs,
                                     {"qblock": block})
    del stack           # release the level's int8 copy before unpacking
    out = qplan.unpack(handler.completion_handler(agg, {}))   # (G, B, S)
    return out.reshape(up.lead + tuple(out.shape[1:])), up


def _int8_level(acc: torch.Tensor, mesh: RankMesh, lvl: topology.MeshLevel,
                handler: hd.Handler, design: str, n_bufs: int, block: int,
                fmt: pk.PacketFormat, sfmt: pk.PacketFormat,
                arrival, fault: pk.FaultSchedule | None = None,
                fault_stats: dict | None = None) -> torch.Tensor:
    """One up-hop packet by packet: every rank quantizes and frames both
    streams (``"q"`` is the checksummed stream of the reliability layer,
    its headers steer the stack), the switch steers by the payload's
    headers, folds and places its aggregate at the switch rank (zeros
    elsewhere)."""
    b, s = acc.shape[-2:]
    q, scales = compression.quantize_int8(acc, block)
    r = mesh.axis_index(lvl.axis, acc.device)
    qs = pk.packetize(q, fmt, child_rank=r)
    ss = pk.packetize(scales, sfmt, child_rank=r)
    payload = {"q": mesh.group_stack(qs.payload, lvl.axis, lvl.switch_rank),
               "scale": mesh.group_stack(ss.payload, lvl.axis,
                                         lvl.switch_rank)}
    headers = mesh.group_stack(qs.headers, lvl.axis, lvl.switch_rank)
    if fault is not None:
        payload, headers = _reliable_ingress(payload, headers, fault,
                                             fault_stats, mesh, lvl)
    payload, headers = _apply_arrival(payload, headers, arrival)
    agg, _ = hd.run(handler, payload, headers, design=design, n_bufs=n_bufs,
                    ctx={"qblock": block})
    e = fmt.payload_elems(torch.int8)
    npkt = fmt.packets_per_block(s, torch.int8)
    out = agg.reshape(agg.shape[0], b, npkt * e)[..., :s]
    return _mask_to_switch(out, mesh, lvl)


def switch_allreduce_int8(arena: torch.Tensor, mesh: RankMesh,
                          axes: Sequence[str], *,
                          block: int = 256,
                          design: str = "auto",
                          fmt: pk.PacketFormat = DEFAULT_FORMAT,
                          arrival_perms: Sequence | None = None,
                          fault_plan: pk.FaultPlan | None = None,
                          with_fault_stats: bool = False,
                          batched: bool = True,
                          mean: bool = False,
                          telemetry=None, tenant: str | None = None):
    """int8-transport allreduce of a ``(*mesh, B, S)`` arena through the
    emulated switch.

    Packets carry int8 payloads with a per-``block`` fp32 scale
    sideband; every switch runs the ``int8_dequant`` handler (fused
    dequantize-accumulate into an fp32 buffer — the "FPU in every HPU")
    and requantizes the aggregate for the next wire hop; the root
    requantizes once, multicasts, and every rank dequantizes.  The
    batched plane on a ``RankMesh`` dequantizes the root's one copy and
    broadcasts it (stride 0 over the rank axes): every rank would
    dequantize the same bits.  On a ``ProcessMesh`` a rank that no
    longer holds data skips the upper levels, the root's int8 payload and
    scales come down the tree (``ProcessMesh.multicast``) and every rank
    dequantizes its copy.  ``fault_plan``, ``with_fault_stats``,
    ``telemetry`` and ``tenant`` as in ``switch_allreduce_dense``.
    """
    if fault_plan is not None:
        require_emulated(mesh, "the lossy fabric (fault_plan)", 21)
    if not batched:
        require_emulated(mesh, "the per-packet plane (batched=False)", 25)
    b, s0 = arena.shape[-2:]
    handler = hd.get_handler("int8_dequant")
    sfmt = _scales_format(fmt, block)
    levels = _levels(mesh, axes)
    fstats = _new_fault_stats(mesh, arena.device)
    if len(levels) == 1 and levels[0].fanin == 1:
        return (arena, fstats) if with_fault_stats else arena
    # quantization needs whole blocks; the scales sideband's packet count
    # matches the payload's by construction (E_s = E / block), padding
    # included
    acc, _ = compression._pad_last(arena, block)
    s = acc.shape[-1]
    design, n_bufs = resolve_design(s, design)     # int8: S bytes per block
    faults = fault_schedules(fault_plan, level_packet_counts(
        [l.fanin for l in levels], b, s0, arena.dtype, mode="int8", fmt=fmt,
        block=block))
    obs = _PlaneObs(telemetry, tenant)
    obs.retries(faults)
    acc = acc.float()
    qplan = pk.FramePlan(b, s, torch.int8, fmt)
    splan = pk.FramePlan(b, s // block, torch.float32, sfmt)
    if batched:
        held = mesh
        for i, lvl in enumerate(levels):
            if not held.holds:          # a child of a lower switch
                continue
            with obs(f"plane.l{i + 1}", mode="int8", fanin=lvl.fanin):
                acc, held = _int8_level_batched(acc, held, lvl, handler,
                                                design, n_bufs, block, qplan,
                                                splan, faults[i], fstats)
        with obs("plane.multicast", mode="int8"):
            q, scales = (compression.quantize_int8(acc, block)
                         if acc is not None else (None, None))
            del acc
            if isinstance(mesh, RankMesh):
                out = compression.dequantize_int8(
                    q, scales, block, dtype=arena.dtype)[..., :s0]
                out = out.expand(mesh.shape + tuple(out.shape[mesh.ndim:]))
            else:
                q = mesh.multicast(q, held, _like(mesh, (b, s), torch.int8,
                                                  arena.device))
                scales = mesh.multicast(scales, held, _like(
                    mesh, (b, s // block), torch.float32, arena.device))
                out = compression.dequantize_int8(
                    q, scales, block, dtype=arena.dtype)[..., :s0]
    else:
        for i, lvl in enumerate(levels):
            arrival = arrival_perms[i] if arrival_perms is not None else None
            with obs(f"plane.l{i + 1}", mode="int8", fanin=lvl.fanin):
                acc = _int8_level(acc, mesh, lvl, handler, design, n_bufs,
                                  block, fmt, sfmt, arrival, faults[i],
                                  fstats)
        # root multicast: requantize once, stream int8 + scales back down
        with obs("plane.multicast", mode="int8"):
            q, scales = compression.quantize_int8(acc, block)
            streams = [pk.packetize(q, fmt), pk.packetize(scales, sfmt)]
            for lvl in reversed(levels):
                streams = [pk.PacketStream(
                    headers=_multicast(st.headers, mesh, lvl.axis,
                                       lvl.switch_rank),
                    payload=_multicast(st.payload, mesh, lvl.axis,
                                       lvl.switch_rank)) for st in streams]
            q = pk.depacketize(streams[0], fmt, b, s)
            scales = pk.depacketize(streams[1], sfmt, b, s // block)
        out = compression.dequantize_int8(q, scales, block,
                                          dtype=arena.dtype)[..., :s0]
    if mean:
        out = mesh.mean(out, axes)
    return (out, fstats) if with_fault_stats else out


# ---------------------------------------------------------------------------
# Sparse coordinate-merge data plane (§7).
# ---------------------------------------------------------------------------

def _pack_lists(idx: torch.Tensor, val32: torch.Tensor) -> torch.Tensor:
    """``(..., B, cap)`` int32 indices and fp32 values → the ``(..., B,
    2·cap)`` int32 wire image; the values ride as their bits."""
    return torch.cat([idx, val32.view(torch.int32)], dim=-1)


def _unpack_lists(packed: torch.Tensor, cap: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    return packed[..., :cap], packed[..., cap:].view(torch.float32)


def _densify(idx: torch.Tensor, val32: torch.Tensor, s: int) -> torch.Tensor:
    """§7 array storage: scatter-add ``(..., B, cap)`` lists into dense
    ``(..., B, S)`` fp32 buffers — the ``sparse_accum_slots`` kernel over
    every bucket at once, in its sorted mode: every list here comes from
    ``topk_sparsify`` or ``merge_coordinate_lists``, index-sorted with
    its sentinels (mapped to ``-1``) last."""
    lidx = torch.where(idx != sparse.SENTINEL, idx, -1)
    return ops.sparse_accum_slots(lidx, val32, s, indices_sorted=True)


def _held_stat(stat: torch.Tensor, mesh: RankMesh, held: RankMesh,
               placed: list, lvl: topology.MeshLevel) -> torch.Tensor:
    """A level's per-switch count ``(G,)`` as a per-rank ``mesh``-shaped
    count: every rank of a switch's group holds it, as every rank of the
    group computes it in the reference; a rank off ``held`` (its group's
    lists are all sentinels there) holds 0.  ``placed`` indexes ``held``
    inside ``mesh``: the switch rank on each collapsed axis."""
    x = stat.reshape(held.collapse(lvl.axis).shape).expand(held.shape)
    out = torch.zeros(mesh.shape, dtype=stat.dtype, device=stat.device)
    out[tuple(placed)] = x[tuple(0 if isinstance(p, int) else slice(None)
                                 for p in placed)]
    return out


def _path_collisions(mesh, levels: Sequence[topology.MeshLevel],
                     mine: torch.Tensor, took: Sequence[int]) -> torch.Tensor:
    """This rank's collision count on a ``ProcessMesh``, bitwise its
    slice of ``_held_stat``'s sum: at every list level it took part in
    (``took``), the count of that level's switch of its group.  Each
    rank's own counts as a switch (``mine``, one a level) are gathered
    from every rank, not recomputed."""
    t = mine.reshape(mesh.lead + tuple(mine.shape))
    for a in reversed(mesh.axes):
        t = mesh.all_gather(t, a)               # outer axes outermost
    table = t.reshape(mesh.shape + tuple(mine.shape))
    out = torch.zeros((), dtype=torch.int32, device=mine.device)
    for i in took:
        sw = list(mesh.coords)
        sw[mesh.dim(levels[i].axis)] = levels[i].switch_rank
        out = out + table[tuple(sw) + (i,)]
    return out.reshape(mesh.lead)


def _sparse_level_batched(idx: torch.Tensor, val32: torch.Tensor,
                          held: RankMesh, lvl: topology.MeshLevel,
                          handler: hd.Handler, cap: int,
                          fmt: pk.PacketFormat,
                          fault: pk.FaultSchedule | None = None,
                          fault_stats: dict | None = None):
    """One up-hop of the list plane over the packed wire image: frame the
    ``(B, 2·cap)`` int32 image of every held rank, take the switches'
    child stacks (a view), unframe and merge, every switch of the level
    at once.  The merge regroups packets by child, and any arrival
    interleave composed with that regrouping is the identity on each
    child's image, so arrivals are never materialised.  A fault schedule's
    admission mask gates the stack first.  Returns the merged lists on
    ``held.collapse(lvl.axis)``, the per-switch collision counts and that
    mesh; on a ``ProcessMesh`` a child that is not the switch rank gets
    ``None`` for the lists and the counts."""
    b = idx.shape[-2]
    up = held.collapse(lvl.axis, lvl.switch_rank)
    plan = pk.FramePlan(b, 2 * cap, torch.int32, fmt)
    stack = held.group_stack(plan.pack(_pack_lists(idx, val32)), lvl.axis,
                             lvl.switch_rank)                 # (G, P, n, E)
    if stack is None:           # a child of this level's switch rank
        return None, None, None, up
    stack = _admit(stack, fault, fault_stats)
    cidx, cval = _unpack_lists(plan.unpack(stack), cap)       # (G, P, B, cap)
    merged, stats = handler.payload_handler({"idx": cidx, "val": cval},
                                            None, "single", 1, {})
    shape = up.lead + tuple(merged["idx"].shape[1:])
    return (merged["idx"].reshape(shape), merged["val"].reshape(shape),
            stats["collisions"], up)


def _sparse_level(idx: torch.Tensor, val32: torch.Tensor, mesh: RankMesh,
                  lvl: topology.MeshLevel, handler: hd.Handler, cap: int,
                  fmt: pk.PacketFormat, arrival,
                  fault: pk.FaultSchedule | None = None,
                  fault_stats: dict | None = None):
    """One up-hop packet by packet: every rank frames its wire image, the
    switch regroups the arrivals by the CHILD header (a list spans
    several packets: pairing one child's indices with another's values
    would corrupt the sum), reassembles each child's image, merges, and
    places the merged lists at the switch rank (sentinels elsewhere).
    Returns the lists and the per-rank collision counts."""
    b = idx.shape[-2]
    stream = pk.packetize(_pack_lists(idx, val32), fmt,
                          child_rank=mesh.axis_index(lvl.axis, idx.device))
    payload = mesh.group_stack(stream.payload, lvl.axis, lvl.switch_rank)
    headers = mesh.group_stack(stream.headers, lvl.axis, lvl.switch_rank)
    if fault is not None:
        payload, headers = _reliable_ingress(payload, headers, fault,
                                             fault_stats, mesh, lvl)
    payload, headers = _apply_arrival(payload, headers, arrival)
    order = hd.child_order(headers)
    payload, headers = hd.apply_order(payload, order), hd.apply_order(
        headers, order)
    child = pk.depacketize(pk.PacketStream(headers, payload), fmt, b,
                           2 * cap)                           # (G, P, B, 2cap)
    cidx, cval = _unpack_lists(child, cap)
    merged, stats = hd.run(handler, {"idx": cidx, "val": cval}, headers,
                           design="single")
    idx = mesh.scatter_group(merged["idx"], lvl.axis, lvl.switch_rank,
                             fill=sparse.SENTINEL)
    val32 = mesh.scatter_group(merged["val"], lvl.axis, lvl.switch_rank)
    return idx, val32, _per_rank(stats["collisions"], mesh, lvl)


def switch_allreduce_sparse(arena: torch.Tensor, mesh: RankMesh,
                            axes: Sequence[str], ks: Sequence[int] | int, *,
                            density_threshold: float = 0.25,
                            fmt: pk.PacketFormat = DEFAULT_FORMAT,
                            arrival_perms: Sequence | None = None,
                            fault_plan: pk.FaultPlan | None = None,
                            with_fault_stats: bool = False,
                            batched: bool = True,
                            mean: bool = False,
                            with_stats: bool = False,
                            telemetry=None, tenant: str | None = None):
    """Top-k sparse allreduce of a ``(*mesh, B, S)`` arena through the
    emulated switch (§7).

    Every rank sends each bucket's top-``ks[b]`` coordinate list (``ks``
    one per bucket, or one for all; the lists hold ``max(ks)`` slots);
    each switch runs the ``sparse_merge`` handler and forwards the merged
    list — capacity ``cap · fan-in`` — up the tree while it fits under
    ``density_threshold · S``.  At the first level where it would not
    (before level 1, mid-tree, or at the root) the lists densify into
    fp32 buffers (the ``sparse_accum_slots`` kernel, the paper's array
    storage) and the remaining levels fold them with the child-steered
    ``dense_sum_steered`` handler, so the result is bitwise the same
    under any arrival order.  The root's result multicasts down.

    Returns ``(reduced, sent)``: ``sent`` is this rank's ``(values,
    indices)`` lists, ``(*mesh, B, max(ks))``, from which the caller
    forms its error-feedback residual (the reference returns them
    scattered to a dense arena, ``mine``; the port never holds that
    copy).  With ``with_stats`` a third item, ``{"collisions",
    "spill_bytes"}``, counts per rank the index collisions on the
    switches of its root path.  The batched plane folds and densifies
    only the ranks that hold data; on a ``RankMesh`` its result is one
    copy broadcast over the rank axes.  On a ``ProcessMesh`` the children
    of a level send their packed lists (or, densified, their arenas) to
    the switch rank, which merges its one group; a rank that no longer
    holds data skips the upper levels, the root's fp32 result comes down
    the tree (``ProcessMesh.multicast``), and the collision counts are
    gathered from the switches (``_path_collisions``).  ``fault_plan``
    replays a lossy fabric on every up-hop, the list levels' and the
    densified ones'; ``with_fault_stats`` appends the fault counters
    (int32 of ``mesh.lead``) last.  ``telemetry`` and ``tenant`` as in
    ``switch_allreduce_dense``.
    """
    if fault_plan is not None:
        require_emulated(mesh, "the lossy fabric (fault_plan)", 21)
    if not batched:
        require_emulated(mesh, "the per-packet plane (batched=False)", 25)
    b, s = arena.shape[-2:]
    handler = hd.get_handler("sparse_merge")
    ks = tuple(int(k) for k in (ks if hasattr(ks, "__len__") else [ks] * b))
    if len(ks) != b:
        raise ValueError(f"got {len(ks)} ks for {b} buckets")
    k_max = max(ks)
    levels = _levels(mesh, axes)
    val, idx = sparse.topk_sparsify(arena, k_max, torch.tensor(
        ks, device=arena.device))
    sent = (val, idx)
    collisions = torch.zeros(mesh.lead, dtype=torch.int32,
                             device=arena.device)
    fstats = _new_fault_stats(mesh, arena.device)
    if len(levels) == 1 and levels[0].fanin == 1:
        out = sparse.scatter_dense(val, idx, s, dtype=arena.dtype).float()
        if mean:
            out = mesh.mean(out, axes)
        ret = [out.to(arena.dtype), sent]
        if with_stats:
            ret.append({"collisions": collisions,
                        "spill_bytes": collisions * 8})
        if with_fault_stats:
            ret.append(fstats)
        return tuple(ret)
    val32 = val.float()
    del val
    cap = k_max
    dense: torch.Tensor | None = None
    steered = hd.get_handler("dense_sum_steered")
    held, placed = mesh, [slice(None)] * mesh.ndim
    # on a ProcessMesh: this rank's count as each list level's switch, and
    # the list levels it took part in
    mine = torch.zeros(len(levels), dtype=torch.int32, device=arena.device)
    took = []
    dplan = pk.FramePlan(b, s, torch.float32, fmt)
    faults = fault_schedules(fault_plan, level_packet_counts(
        [l.fanin for l in levels], b, s, arena.dtype, mode="sparse", fmt=fmt,
        k_max=k_max, density_threshold=density_threshold))
    obs = _PlaneObs(telemetry, tenant)
    obs.retries(faults)
    for i, lvl in enumerate(levels):
        if not held.holds:              # a child of a lower switch
            continue
        with obs(f"plane.l{i + 1}", mode="sparse", fanin=lvl.fanin):
            arrival = arrival_perms[i] if arrival_perms is not None else None
            if dense is None and sparse.densify_step(cap * lvl.fanin, s,
                                                     density_threshold):
                # array storage from here on: this level would overflow
                # the list capacity (§7 densification toward the root)
                dense = _densify(idx, val32, s)
                idx = val32 = None
            if dense is not None and batched:
                dense, held = _dense_level_batched(
                    dense, held, lvl, steered, "single", 1, dplan, arrival,
                    faults[i], fstats)
            elif dense is not None:
                dense = _dense_level(dense, mesh, lvl, steered, "single", 1,
                                     fmt, arrival, faults[i], fstats)
            elif batched:
                idx, val32, stat, up = _sparse_level_batched(
                    idx, val32, held, lvl, handler, cap, fmt, faults[i],
                    fstats)
                if isinstance(mesh, RankMesh):
                    collisions += _held_stat(stat, mesh, held, placed, lvl)
                else:
                    took.append(i)
                    if stat is not None:
                        mine[i] = stat.reshape(())
                held = up
                cap *= lvl.fanin
            else:
                idx, val32, counts = _sparse_level(idx, val32, mesh, lvl,
                                                   handler, cap, fmt, arrival,
                                                   faults[i], fstats)
                collisions += counts
                cap *= lvl.fanin
            placed[mesh.dim(lvl.axis)] = lvl.switch_rank

    top = levels[-1]
    if batched:
        if dense is None and held.holds:
            dense = _densify(idx, val32, s)             # root array storage
    elif dense is None:
        k = mesh.dim(top.axis)
        lists = [t.select(k, top.switch_rank).reshape(-1, b, cap)
                 for t in (idx, val32)]
        dense = _mask_to_switch(_densify(*lists, s), mesh, top)
    del idx, val32
    with obs("plane.multicast", mode="sparse"):
        if batched and isinstance(mesh, RankMesh):
            red = dense.contiguous()            # one copy for every rank
        elif batched:
            red = mesh.multicast(dense, held, _like(mesh, (b, s),
                                                    torch.float32,
                                                    arena.device))
        else:
            red = dense
            for lvl in reversed(levels):
                red = _multicast_arena(red, mesh, lvl, fmt)
    del dense
    if mean:
        red = mesh.mean(red, axes)
    red = red.to(arena.dtype)
    if batched and isinstance(mesh, RankMesh):
        red = red.expand(mesh.shape + (b, s))
    if with_stats and not isinstance(mesh, RankMesh):
        collisions = _path_collisions(mesh, levels, mine, took)
    ret = [red, sent]
    if with_stats:
        ret.append({"collisions": collisions,
                    "spill_bytes": collisions * 8})   # (idx, val) a spill
    if with_fault_stats:
        ret.append(fstats)
    return tuple(ret)


def record_trace(mode: str, mesh: RankMesh, axes: Sequence[str],
                 num_buckets: int, bucket_elems: int, dtype: torch.dtype, *,
                 telemetry, tenant: str | None = None, block: int = 256,
                 ks: Sequence[int] | None = None,
                 density_threshold: float = 0.25,
                 fmt: pk.PacketFormat = DEFAULT_FORMAT,
                 fault_plan: pk.FaultPlan | None = None) -> None:
    """Record what one call of the ``mode`` plane on a ``(B, S)`` arena
    of ``dtype`` records, without reducing: the retry instants and the
    phase spans, in the plane's order.

    The registration pass of a shared switch's tenants
    (``SwitchTransport.attach``) records with it what the reference's
    registration trace records: the reference traces each tenant's plane
    once to register its session and once more to run it.
    """
    levels = _levels(mesh, axes)
    if telemetry is None or (len(levels) == 1 and levels[0].fanin == 1):
        return
    faults = fault_schedules(fault_plan, level_packet_counts(
        [l.fanin for l in levels], num_buckets, bucket_elems, dtype,
        mode=mode, fmt=fmt, block=block, k_max=max(ks) if ks else None,
        density_threshold=density_threshold))
    obs = _PlaneObs(telemetry, tenant)
    obs.retries(faults)
    for i, lvl in enumerate(levels):
        with obs(f"plane.l{i + 1}", mode=mode, fanin=lvl.fanin):
            pass
    with obs("plane.multicast", mode=mode):
        pass


# ---------------------------------------------------------------------------
# Static packet/combine counters — the perfmodel cross-check surface.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LevelCounters:
    """Per-switch traffic and work at one tree level, per allreduce."""

    axis: str
    fanin: int                  # P: packets per block arriving at a switch
    ingress_packets: int        # blocks · fanin received per switch
    egress_packets: int         # blocks forwarded up (1 per block)
    combines: int               # blocks · (fanin − 1) combine ops
    buffers_per_block: float    # M — the working-memory multiplier


@dataclasses.dataclass(frozen=True)
class SwitchCounters:
    """What the data plane will execute for one ``(B, S)`` arena.

    These are exactly the analytic model's inputs: ``payload_elems`` is
    the paper's ``N``, each level's ``fanin`` its ``P``, ``combines``
    the ``P−1``-per-block count every §6 service time amortizes, and
    ``buffers_per_block`` the ``M`` of the working-memory equation
    (Little's law, §4.3).
    """

    levels: tuple[LevelCounters, ...]
    blocks: int                 # B · ceil(S/N) reduction blocks framed
    payload_elems: int          # N
    packet_bytes: int           # MTU
    design: str
    n_bufs: int

    @property
    def total_combines(self) -> int:
        return sum(l.combines for l in self.levels)

    def model_point(self, data_bytes: int) -> sm.DesignPoint:
        """Evaluate the analytic model at this plane's operating point."""
        params = sm.SwitchParams(packet_bytes=self.packet_bytes)
        return sm.model_design(self.design, data_bytes, params,
                               B=self.n_bufs, P=self.levels[0].fanin)


def _counters(level_fanins: Sequence[tuple[str, int]], num_buckets: int,
              bucket_elems: int, dtype: torch.dtype, fmt: pk.PacketFormat,
              design: str, reproducible: bool) -> SwitchCounters:
    """Shared counter math for a sequence of (axis label, fan-in) levels."""
    n = fmt.payload_elems(dtype)
    npkt = fmt.packets_per_block(bucket_elems, dtype)
    blocks = num_buckets * npkt
    nbytes = bucket_elems * dtype.itemsize
    design, n_bufs = resolve_design(nbytes, design, reproducible)
    levels = []
    for axis, p in level_fanins:
        levels.append(LevelCounters(
            axis=axis, fanin=p,
            ingress_packets=blocks * p,
            egress_packets=blocks,
            combines=blocks * hd.combines_per_packet_slot(p, design),
            buffers_per_block=sm.buffers_per_block(design, p, n_bufs)))
    return SwitchCounters(levels=tuple(levels), blocks=blocks,
                          payload_elems=n, packet_bytes=fmt.mtu_bytes,
                          design=design, n_bufs=n_bufs)


def plan_counters(axis_names: Sequence[str], axis_sizes: Sequence[int],
                  num_buckets: int, bucket_elems: int, dtype: torch.dtype, *,
                  fmt: pk.PacketFormat = DEFAULT_FORMAT,
                  design: str = "auto",
                  reproducible: bool = False,
                  batched: bool = True) -> SwitchCounters:
    """Static counters for the plane's schedule on a mesh (no reduction).

    ``batched`` is accepted and ignored, so callers can pass the
    transport's knob straight through: batching changes the schedule of
    the emulation, never the modeled switch work.
    """
    del batched
    fanins = [(lvl.axis, lvl.fanin) for lvl in
              topology.mesh_levels(tuple(axis_names), tuple(axis_sizes))]
    return _counters(fanins, num_buckets, bucket_elems, dtype, fmt,
                     design, reproducible)


def tree_counters(tree: topology.ReductionTree, num_buckets: int,
                  bucket_elems: int, dtype: torch.dtype, *,
                  fmt: pk.PacketFormat = DEFAULT_FORMAT,
                  design: str = "auto",
                  reproducible: bool = False,
                  batched: bool = True) -> SwitchCounters:
    """Static counters for an arbitrary :class:`topology.ReductionTree`:
    the fan-ins are read off the tree (per level the largest child count,
    the busiest switch bounding the schedule); a single-host tree
    degenerates to one fan-in-1 level, matching ``topology.mesh_levels``.
    ``batched`` is ignored as in :func:`plan_counters`.
    """
    del batched
    fanins = [(f"level{lvl}",
               max(len(tree.nodes[i].children) for i in tree.levels[lvl]))
              for lvl in range(1, len(tree.levels))]
    if not fanins:
        fanins = [("level1", 1)]
    return _counters(fanins, num_buckets, bucket_elems, dtype, fmt,
                     design, reproducible)
