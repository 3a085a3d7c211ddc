"""The emulated switch data plane: ingress → aggregate → multicast (§4).

The port of the dense part of ``repro/switch/dataplane.py``.  Arenas
carry the mesh's rank axes in front, ``(*mesh, B, S)``.  Per level of the
mesh's reduction tree (``topology.mesh_levels``), leaf level first:

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

The lossy fabric (``fault_plan``), telemetry and multi-tenant arrivals
are not ported yet (ROADMAP queue 1 items 9, 11 and 13).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core import topology
from repro_torch.mesh import RankMesh
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


def _rank_mask(mask: torch.Tensor, mesh: RankMesh,
               x: torch.Tensor) -> torch.Tensor:
    """Broadcast a per-rank boolean over ``x``'s trailing axes."""
    return mask.reshape(mask.shape + (1,) * (x.dim() - mesh.ndim))


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


def _multicast_root(x: torch.Tensor, mesh: RankMesh) -> torch.Tensor:
    """Root multicast down every level: every rank takes the result of
    the switch above it.  ``x`` lies on the collapsed mesh (size 1 on
    each reduced axis).

    The result is a broadcast view: the ranks share one copy of the
    reduced arena (cloned, so the level buffers are released), the way
    every rank holds the same bits after the multicast.
    """
    return x.clone(memory_format=torch.contiguous_format).expand(
        mesh.shape + tuple(x.shape[mesh.ndim:]))


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


def _apply_arrival(stack: torch.Tensor, headers: torch.Tensor, perm,
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Reorder the child streams by a static arrival permutation; headers
    ride along so child-order handlers can undo it."""
    g, p, n = headers.shape[:3]
    order = _resolve_perm(perm, p, n)
    if order is None:
        return stack, headers
    o = _group_order(order, g, stack.device)
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
# Dense / fixed-tree data plane.
# ---------------------------------------------------------------------------

def _dense_level(arena: torch.Tensor, mesh: RankMesh,
                 lvl: topology.MeshLevel, handler: hd.Handler, design: str,
                 n_bufs: int, fmt: pk.PacketFormat, arrival) -> torch.Tensor:
    """One up-hop, packet by packet: frame, stream to the switch,
    steer by header, aggregate, place at the switch rank."""
    b, s = arena.shape[-2:]
    r = mesh.axis_index(lvl.axis, arena.device)
    stream = pk.packetize(arena, fmt, child_rank=r)
    payload = mesh.group_stack(stream.payload, lvl.axis, lvl.switch_rank)
    headers = mesh.group_stack(stream.headers, lvl.axis, lvl.switch_rank)
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
                         arrival) -> tuple[torch.Tensor, RankMesh]:
    """One up-hop as a few batched operations over the packed tensor:
    pack, take the switches' child stacks (a view), fold every switch of
    the level at once, unpack.

    ``arena`` holds only the ranks that still carry data: ``mesh`` is
    collapsed to the switch rank on every lower level's axis.  Returns
    the switches' aggregates on ``mesh.collapse(lvl.axis)``.  Every other
    rank's result would be masked to zero and overwritten by the
    multicast, so it is neither folded nor stored; at the switch ranks
    the bits are those of ``_dense_level``.
    """
    ctx = {"dtype": arena.dtype}
    stack = mesh.group_stack(plan.pack(arena), lvl.axis,
                             lvl.switch_rank)                 # (G, P, n, E)
    order = _net_order(handler, arrival, lvl.fanin, plan.num_packets)
    if order is not None:
        stack = hd.apply_order(
            stack, _group_order(order, stack.shape[0], stack.device))
    agg, _ = handler.payload_handler(stack, None, design, n_bufs, ctx)
    del stack           # release the packed copy before the level's output
    out = plan.unpack(handler.completion_handler(agg, ctx))   # (G, B, S)
    up = mesh.collapse(lvl.axis)
    return out.reshape(up.shape + tuple(out.shape[1:])), up


def switch_allreduce_dense(arena: torch.Tensor, mesh: RankMesh,
                           axes: Sequence[str], *,
                           reproducible: bool = False,
                           design: str = "auto",
                           fmt: pk.PacketFormat = DEFAULT_FORMAT,
                           arrival_perms: Sequence | None = None,
                           fault_plan=None,
                           batched: bool = True,
                           mean: bool = False) -> torch.Tensor:
    """Allreduce a ``(*mesh, B, S)`` arena through the emulated switch tree.

    ``reproducible=True`` installs the ``fixed_tree`` handler: combines
    follow the aligned binary tree over child ranks at every level, so
    the result is bitwise-invariant to packet arrival order and
    bitwise-equal to the wire ``fixed_tree`` collective.
    ``arrival_perms`` holds one arrival permutation (or None) per level.
    """
    if fault_plan is not None:
        raise NotImplementedError(
            "the lossy fabric (fault_plan) is not ported yet: ROADMAP "
            "queue 1 item 9")
    b, s = arena.shape[-2:]
    handler = hd.get_handler("fixed_tree" if reproducible else "dense_sum")
    design, n_bufs = resolve_design(s * arena.element_size(), design,
                                    reproducible)
    levels = _levels(mesh, axes)
    if len(levels) == 1 and levels[0].fanin == 1:
        return arena
    cur = arena
    if batched:
        plan = pk.FramePlan(b, s, arena.dtype, fmt)
        held = mesh
        for i, lvl in enumerate(levels):
            arrival = arrival_perms[i] if arrival_perms is not None else None
            cur, held = _dense_level_batched(cur, held, lvl, handler, design,
                                             n_bufs, plan, arrival)
        cur = _multicast_root(cur, mesh)
    else:
        for i, lvl in enumerate(levels):
            arrival = arrival_perms[i] if arrival_perms is not None else None
            cur = _dense_level(cur, mesh, lvl, handler, design, n_bufs, fmt,
                               arrival)
        for lvl in reversed(levels):
            cur = _multicast_arena(cur, mesh, lvl, fmt)
    if mean:
        cur = cur / mesh.world_size(axes)
    return cur
