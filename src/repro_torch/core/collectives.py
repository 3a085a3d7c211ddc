"""Wire allreduce algorithms over the rank mesh.

The port of ``repro/core/collectives.py``: the ring (Rabenseifner
reduce-scatter + all-gather, the paper's host-based baseline, with §5's
staggered sending), recursive halving-doubling (rhd), the fixed-tree
recursive-doubling allreduce (§6.3, the F3 reproducible wire schedule),
the two-level and the tree-driven hierarchical schedules (§1, §4), the
vendor psum, the §6.4 size switchover, the dispatch, the FSDP pair
``reduce_scatter`` / ``all_gather`` and the wire-byte accounting.

Each function takes tensors with the mesh's rank axes in front and runs
every rank's program at once; a ``ppermute`` is an index along a rank
axis.  A rank-local vector's leading axis is the tensor's axis
``mesh.ndim``.  A ring ``stagger`` is a Python int, or an int tensor of
per-bucket offsets: then the tensor is an arena ``(*mesh, *buckets, S,
...)`` with ``stagger.shape`` the bucket axes, each bucket's vector is
its ``S`` axis, and every collective round carries all buckets at once
(the reference's ``vmap`` over buckets).  The rhd functions take that
axis as ``dim``.
"""
from __future__ import annotations

import math
from typing import Callable, Sequence

import torch

from repro_torch.core import topology
from repro_torch.mesh import RankMesh

Op = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
#: a ring-phase offset: one for the vector, or an int tensor, one a bucket
Stagger = int | torch.Tensor


def _is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def _ring_perm(p: int) -> list[tuple[int, int]]:
    return [(i, (i + 1) % p) for i in range(p)]


def _lead(mesh: RankMesh, stagger: Stagger) -> int:
    """The axis of each rank's vector: after the rank axes and, for a
    tensor of per-bucket staggers, after its bucket axes."""
    return mesh.ndim + (stagger.dim() if isinstance(stagger, torch.Tensor)
                        else 0)


def xor_perm(p: int, d: int) -> list[tuple[int, int]]:
    """The recursive-doubling involution at distance ``d``: rank i <-> i^d."""
    return [(i, i ^ d) for i in range(p)]


def _bitrev_perm(p: int) -> list[tuple[int, int]]:
    """The bit-reversal involution: rank i <-> bitrev(i).

    ``rhd_reduce_scatter`` leaves rank ``r`` holding segment
    ``bitrev(r)``; one ppermute along this involution restores standard
    (rank r ↔ segment r) placement, which the FSDP layout requires.
    """
    bits = p.bit_length() - 1

    def rev(i: int) -> int:
        out = 0
        for b in range(bits):
            out |= ((i >> b) & 1) << (bits - 1 - b)
        return out
    return [(i, rev(i)) for i in range(p)]


def pad_to_multiple(x: torch.Tensor, m: int, dim: int = 0
                    ) -> tuple[torch.Tensor, int]:
    """Pad axis ``dim`` of ``x`` to a multiple of ``m`` with zeros;
    return (padded, original length)."""
    n = x.shape[dim]
    rem = (-n) % m
    if rem:
        shape = list(x.shape)
        shape[dim] = rem
        x = torch.cat([x, x.new_zeros(shape)], dim=dim)
    return x, n


def _chunk_index(mesh: RankMesh, axis: str, stagger: Stagger, offset: int,
                 p: int, dim: int, ndim: int, device) -> torch.Tensor:
    """``(r + offset + stagger) mod p`` for every rank ``r`` on ``axis``
    and every bucket, floored as ``jnp``'s ``%`` is (``stagger = -1``
    wraps), shaped to index axis ``dim`` of an ``ndim``-dim tensor."""
    r = mesh.axis_index(axis, device).long()
    r = r.reshape(*r.shape, *([1] * (dim - mesh.ndim)))
    if isinstance(stagger, torch.Tensor):
        stagger = stagger.to(device=device, dtype=torch.long)
    idx = torch.remainder(r + offset + stagger, p)
    return idx.reshape(*idx.shape, *([1] * (ndim - dim)))


def _bit(mesh: RankMesh, axis: str, d: int, like: torch.Tensor
         ) -> torch.Tensor:
    """Whether bit ``d`` of each rank's index on ``axis`` is set, shaped
    to broadcast against ``like``."""
    bit = (mesh.axis_index(axis, like.device) & d) != 0
    return bit.reshape(*bit.shape, *([1] * (like.dim() - mesh.ndim)))


# ---------------------------------------------------------------------------
# Ring (Rabenseifner) — the paper's host-based baseline.
# ---------------------------------------------------------------------------

def ring_reduce_scatter(x: torch.Tensor, mesh: RankMesh, axis: str, *,
                        op: Op = torch.add, stagger: Stagger = 0
                        ) -> torch.Tensor:
    """Reduce-scatter a vector over ``axis`` with a ppermute ring.

    Rank ``r`` returns the fully reduced chunk ``(r + 1 + stagger) % P``.
    ``stagger`` rotates which chunk each rank starts from — the paper's
    *staggered sending* (§5): concurrent buckets use different offsets so
    their traffic never contends for the same chunk at the same step.
    The vector's length must be divisible by the axis size.
    """
    p = mesh.axis_size(axis)
    dim = _lead(mesh, stagger)
    n = x.shape[dim]
    if n % p:
        raise ValueError(f"ring_reduce_scatter: len {n} % {p} != 0")
    chunks = x.unflatten(dim, (p, n // p))
    perm = _ring_perm(p)

    def take(offset: int) -> torch.Tensor:
        idx = _chunk_index(mesh, axis, stagger, offset, p, dim, chunks.dim(),
                           x.device)
        return torch.take_along_dim(chunks, idx, dim).squeeze(dim)

    acc = take(0)
    for s in range(p - 1):
        recv = mesh.ppermute(acc, axis, perm)
        acc = op(take(-s - 1), recv)
    return acc


def ring_all_gather(chunk: torch.Tensor, mesh: RankMesh, axis: str, *,
                    stagger: Stagger = 0) -> torch.Tensor:
    """Inverse of ``ring_reduce_scatter``: gather P chunks back to a
    vector."""
    p = mesh.axis_size(axis)
    dim = _lead(mesh, stagger)
    perm = _ring_perm(p)
    shape = list(chunk.shape)
    shape.insert(dim, p)
    # every chunk position is written exactly once below
    out = chunk.new_empty(shape)

    def place(v: torch.Tensor, offset: int) -> None:
        v = v.unsqueeze(dim)
        idx = _chunk_index(mesh, axis, stagger, offset, p, dim, out.dim(),
                           v.device)
        out.scatter_(dim, idx.expand(v.shape), v)

    place(chunk, 1)
    send = chunk
    for s in range(p - 1):
        send = mesh.ppermute(send, axis, perm)
        place(send, -s)
    return out.flatten(dim, dim + 1)


def allreduce_ring(x: torch.Tensor, mesh: RankMesh, axis: str, *,
                   op: Op = torch.add, stagger: Stagger = 0) -> torch.Tensor:
    """Rabenseifner ring allreduce: ~2Z(P-1)/P bytes per rank on the
    wire."""
    p = mesh.axis_size(axis)
    dim = _lead(mesh, stagger)
    xp, n = pad_to_multiple(x, p, dim)
    chunk = ring_reduce_scatter(xp, mesh, axis, op=op, stagger=stagger)
    full = ring_all_gather(chunk, mesh, axis, stagger=stagger)
    return full.narrow(dim, 0, n)


def ring_allreduce_bucketed(arena: torch.Tensor, mesh: RankMesh, axis: str,
                            *, op: Op = torch.add,
                            staggers: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """Ring allreduce of a ``(*mesh, B, S)`` arena, all B buckets in
    flight.

    Round s of every bucket's reduce-scatter (then all-gather) is one
    ppermute carrying a ``(B, S/P)`` payload a rank (§6.2), each bucket
    offset by its own ``stagger`` phase (§5).  Per bucket the combine
    chain is exactly ``allreduce_ring``'s, so results are bitwise-equal
    to a per-bucket loop.
    """
    nd = mesh.ndim
    b, size = arena.shape[nd:nd + 2]
    p = mesh.axis_size(axis)
    if p == 1:
        return arena
    if size % p:
        raise ValueError(f"ring_allreduce_bucketed: S {size} % {p} != 0")
    if staggers is None:
        staggers = torch.zeros(b, dtype=torch.int32, device=arena.device)
    return allreduce_ring(arena, mesh, axis, op=op, stagger=staggers)


# ---------------------------------------------------------------------------
# Recursive halving-doubling — bandwidth-optimal, log P steps.
# ---------------------------------------------------------------------------

def rhd_reduce_scatter(x: torch.Tensor, mesh: RankMesh, axis: str, *,
                       op: Op = torch.add, dim: int | None = None
                       ) -> torch.Tensor:
    """Vector-halving distance-doubling reduce-scatter (power-of-two P).

    The combine tree per final segment is the aligned binary tree over
    rank ids, so the result is bitwise-reproducible for IEEE adds.  Rank
    ``r`` ends with the segment at bit-reversed position; use
    ``rhd_all_gather`` to invert.  ``dim`` is the vector's axis
    (default ``mesh.ndim``).
    """
    p = mesh.axis_size(axis)
    nd = mesh.ndim if dim is None else dim
    if not _is_pow2(p):
        raise ValueError(f"rhd requires power-of-two axis size, got {p}")
    if x.shape[nd] % p:
        raise ValueError(f"rhd_reduce_scatter: len {x.shape[nd]} % {p} != 0")
    for k in range(p.bit_length() - 1):
        d = 1 << k
        half = x.shape[nd] // 2
        lo, hi = x.narrow(nd, 0, half), x.narrow(nd, half, half)
        bit = _bit(mesh, axis, d, x)
        send = torch.where(bit, lo, hi)       # keep hi if my bit is set
        recv = mesh.ppermute(send, axis, xor_perm(p, d))
        keep = torch.where(bit, hi, lo)
        x = op(keep, recv)
    return x


def rhd_all_gather(seg: torch.Tensor, mesh: RankMesh, axis: str, *,
                   dim: int | None = None) -> torch.Tensor:
    """Distance-halving all-gather inverting ``rhd_reduce_scatter``."""
    p = mesh.axis_size(axis)
    nd = mesh.ndim if dim is None else dim
    for k in reversed(range(p.bit_length() - 1)):
        d = 1 << k
        recv = mesh.ppermute(seg, axis, xor_perm(p, d))
        bit = _bit(mesh, axis, d, seg)
        # the lower half is the partner's where my bit is set; each half
        # is selected straight into the doubled segment
        n = seg.shape[nd]
        out = seg.new_empty((*seg.shape[:nd], 2 * n, *seg.shape[nd + 1:]))
        torch.where(bit, recv, seg, out=out.narrow(nd, 0, n))
        torch.where(bit, seg, recv, out=out.narrow(nd, n, n))
        seg = out
    return seg


def allreduce_rhd(x: torch.Tensor, mesh: RankMesh, axis: str, *,
                  op: Op = torch.add, dim: int | None = None
                  ) -> torch.Tensor:
    """Recursive halving-doubling allreduce (multi-buffer design analogue)."""
    p = mesh.axis_size(axis)
    dim = mesh.ndim if dim is None else dim
    xp, n = pad_to_multiple(x, p, dim)
    seg = rhd_reduce_scatter(xp, mesh, axis, op=op, dim=dim)
    return rhd_all_gather(seg, mesh, axis, dim=dim).narrow(dim, 0, n)


# ---------------------------------------------------------------------------
# Fixed-tree (tree aggregation §6.3) — reproducible, latency-optimal.
# ---------------------------------------------------------------------------

def allreduce_fixed_tree(x: torch.Tensor, mesh: RankMesh, axis: str, *,
                         op: Op = torch.add,
                         accum_dtype: torch.dtype | None = None
                         ) -> torch.Tensor:
    """Recursive-doubling allreduce over a fixed aligned binary tree.

    At step k each rank combines with rank ``r ^ 2^k``; the combine tree
    is ``((0,1),(2,3)),((4,5),(6,7)) ...`` — a pure function of rank ids.
    IEEE addition is commutative bitwise, so both partners of a step hold
    the same bits.  With ``accum_dtype=float32`` this is the paper's
    reproducible mode (F3).
    """
    p = mesh.axis_size(axis)
    if not _is_pow2(p):
        raise ValueError(f"fixed_tree requires power-of-two axis size, "
                         f"got {p}")
    orig_dtype = x.dtype
    if accum_dtype is not None:
        x = x.to(accum_dtype)
    for k in range(p.bit_length() - 1):
        x = op(x, mesh.ppermute(x, axis, xor_perm(p, 1 << k)))
    return x.to(orig_dtype)


# ---------------------------------------------------------------------------
# Two-level hierarchical — the in-network reduction tree (§1, §4).
# ---------------------------------------------------------------------------

def allreduce_two_level(x: torch.Tensor, mesh: RankMesh, inner_axis: str,
                        outer_axis: str, *, op: Op = torch.add,
                        inner: str = "ring", outer: str = "rhd",
                        stagger: Stagger = 0) -> torch.Tensor:
    """Hierarchical allreduce = the paper's in-network reduction tree.

    Reduce-scatter over ``inner_axis`` (the leaf switch aggregates its
    children; each rank owns 1/P_in of the partial sum), allreduce the
    owned segment over ``outer_axis`` (the root combines per-pod
    partials), all-gather over ``inner_axis`` (the root multicast).
    """
    p_in = mesh.axis_size(inner_axis)
    dim = _lead(mesh, stagger)
    xp, n = pad_to_multiple(x, p_in, dim)
    if inner == "ring":
        seg = ring_reduce_scatter(xp, mesh, inner_axis, op=op,
                                  stagger=stagger)
    elif inner == "rhd":
        seg = rhd_reduce_scatter(xp, mesh, inner_axis, op=op, dim=dim)
    else:
        raise ValueError(f"unknown inner algorithm {inner!r}")

    if outer == "rhd":
        seg = allreduce_rhd(seg, mesh, outer_axis, op=op, dim=dim)
    elif outer == "ring":
        seg = allreduce_ring(seg, mesh, outer_axis, op=op, stagger=stagger)
    elif outer == "fixed_tree":
        seg = allreduce_fixed_tree(seg, mesh, outer_axis, op=op)
    elif outer == "psum":
        seg = allreduce_psum(seg, mesh, outer_axis)
    else:
        raise ValueError(f"unknown outer algorithm {outer!r}")

    if inner == "ring":
        full = ring_all_gather(seg, mesh, inner_axis, stagger=stagger)
    else:
        full = rhd_all_gather(seg, mesh, inner_axis, dim=dim)
    return full.narrow(dim, 0, n)


# ---------------------------------------------------------------------------
# Tree-driven hierarchical schedule — the ReductionTree as source of truth.
# ---------------------------------------------------------------------------

def hierarchical_allreduce(x: torch.Tensor, mesh: RankMesh,
                           axes: Sequence[str], *, op: Op = torch.add,
                           stagger: Stagger = 0, fixed_tree: bool = False,
                           accum_dtype: torch.dtype | None = None
                           ) -> torch.Tensor:
    """Allreduce scheduled by the mesh's reduction tree (§1, §4).

    ``axes`` is outermost-first.  The schedule walks
    ``topology.mesh_levels``: the leaf level reduce-scatters over the
    innermost axis, levels >= 2 allreduce the owned segment over their
    axes, and the root multicast is the closing all-gather over the leaf
    level.  Power-of-two fan-ins take rhd, others the ring.

    ``fixed_tree=True`` is the reproducible variant (F3): the leaf level
    runs the recursive-halving reduce-scatter, upper levels the XOR fixed
    tree, with fp32 accumulation; every combine is a pure function of
    rank ids.  It requires power-of-two fan-ins.
    """
    axes = tuple(axes)
    sizes = tuple(mesh.axis_size(a) for a in axes)
    levels = topology.mesh_levels(axes, sizes)
    if len(levels) == 1 and levels[0].fanin == 1:       # 1-host mesh
        return x
    leaf = levels[0]
    dim = _lead(mesh, stagger)

    orig_dtype = x.dtype
    if fixed_tree:
        if accum_dtype is None:
            accum_dtype = torch.float32
        if any(not _is_pow2(l.fanin) for l in levels):
            raise ValueError(
                f"hierarchical fixed_tree requires power-of-two fan-ins, "
                f"got {[l.fanin for l in levels]}")
        x = x.to(accum_dtype)

    xp, n = pad_to_multiple(x, leaf.fanin, dim)
    rhd_leaf = fixed_tree or _is_pow2(leaf.fanin)
    # level 1: leaf-switch aggregation (reduce-scatter over the inner axis)
    if rhd_leaf:
        seg = rhd_reduce_scatter(xp, mesh, leaf.axis, op=op, dim=dim)
    else:
        seg = ring_reduce_scatter(xp, mesh, leaf.axis, op=op,
                                  stagger=stagger)
    # levels >= 2: upper switches allreduce the owned segment
    for lvl in levels[1:]:
        if fixed_tree:
            seg = allreduce_fixed_tree(seg, mesh, lvl.axis, op=op)
        elif _is_pow2(lvl.fanin):
            seg = allreduce_rhd(seg, mesh, lvl.axis, op=op, dim=dim)
        else:
            seg = allreduce_ring(seg, mesh, lvl.axis, op=op, stagger=stagger)
    # root multicast: all-gather back down the leaf level
    if rhd_leaf:
        full = rhd_all_gather(seg, mesh, leaf.axis, dim=dim)
    else:
        full = ring_all_gather(seg, mesh, leaf.axis, stagger=stagger)
    return full.narrow(dim, 0, n).to(orig_dtype)


def hierarchical_allreduce_bucketed(arena: torch.Tensor, mesh: RankMesh,
                                    axes: Sequence[str], *,
                                    op: Op = torch.add,
                                    staggers: torch.Tensor | None = None,
                                    fixed_tree: bool = False,
                                    accum_dtype: torch.dtype | None = None
                                    ) -> torch.Tensor:
    """Hierarchical allreduce of a ``(*mesh, B, S)`` arena, all buckets
    in flight: every round of every level carries all B buckets, each
    with its own ring ``stagger`` where the ring is in play.  Bitwise
    equal to a per-bucket loop."""
    if staggers is None:
        staggers = torch.zeros(arena.shape[mesh.ndim], dtype=torch.int32,
                               device=arena.device)
    return hierarchical_allreduce(arena, mesh, axes, op=op, stagger=staggers,
                                  fixed_tree=fixed_tree,
                                  accum_dtype=accum_dtype)


# ---------------------------------------------------------------------------
# Vendor baseline.
# ---------------------------------------------------------------------------

def allreduce_psum(x: torch.Tensor, mesh: RankMesh,
                   axes: str | Sequence[str]) -> torch.Tensor:
    """The vendor collective's analogue: a sum over ``axes`` (in rank
    order here, where XLA's psum leaves the order unspecified)."""
    return mesh.psum(x, axes)


#: Paper §6.4 size switchover, mapped onto wire algorithms.
TREE_THRESHOLD = 128 << 10      # bytes
RING_THRESHOLD = 512 << 10      # bytes


def select_algorithm(nbytes: int, *, reproducible: bool = False,
                     multi_level: bool = False) -> str:
    """Size-based switchover reproducing the paper's §6.4 policy."""
    if reproducible:
        return "fixed_tree"
    if nbytes < TREE_THRESHOLD:
        return "fixed_tree"
    if nbytes < RING_THRESHOLD:
        return "rhd"
    return "two_level" if multi_level else "ring"


def allreduce(x: torch.Tensor, mesh: RankMesh, axes: Sequence[str], *,
              algorithm: str = "auto", op: Op = torch.add,
              reproducible: bool = False, stagger: Stagger = 0,
              accum_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Dispatch a per-rank allreduce over one or two mesh axes.

    ``axes`` is ``(inner,)`` or ``(outer, inner)``; the innermost axis is
    the leaf-switch level of the reduction tree.  ``algorithm="auto"``
    sizes the choice by one rank's vector (one bucket's, for per-bucket
    staggers).
    """
    axes = tuple(axes)
    dim = _lead(mesh, stagger)
    if algorithm == "auto":
        nbytes = x[(0,) * dim].numel() * x.element_size()
        algorithm = select_algorithm(nbytes, reproducible=reproducible,
                                     multi_level=len(axes) > 1)
    if reproducible and algorithm not in ("fixed_tree", "hierarchical"):
        raise ValueError("reproducible mode requires the fixed_tree or "
                         "hierarchical (fixed-tree levels) algorithm")
    if accum_dtype is None and reproducible:
        accum_dtype = torch.float32

    if algorithm == "hierarchical":
        return hierarchical_allreduce(x, mesh, axes, op=op, stagger=stagger,
                                      fixed_tree=reproducible,
                                      accum_dtype=accum_dtype)
    if len(axes) == 1:
        inner = axes[0]
        if algorithm in ("ring", "two_level"):
            # two_level without an outer axis is the ring
            return allreduce_ring(x, mesh, inner, op=op, stagger=stagger)
        if algorithm == "rhd":
            return allreduce_rhd(x, mesh, inner, op=op, dim=dim)
        if algorithm == "fixed_tree":
            return allreduce_fixed_tree(x, mesh, inner, op=op,
                                        accum_dtype=accum_dtype)
        if algorithm == "psum":
            return allreduce_psum(x, mesh, inner)
        raise ValueError(f"unknown algorithm {algorithm!r}")
    if len(axes) != 2:
        raise ValueError(f"allreduce over 1 or 2 axes, got {axes}")

    outer, inner = axes
    if algorithm == "two_level":
        return allreduce_two_level(x, mesh, inner, outer, op=op,
                                   stagger=stagger)
    if algorithm == "fixed_tree":
        # inner level first, then the outer: the global combine order is
        # a function of (pod_id, rank_id) only → reproducible multi-pod
        x = allreduce_fixed_tree(x, mesh, inner, op=op,
                                 accum_dtype=accum_dtype)
        return allreduce_fixed_tree(x, mesh, outer, op=op,
                                    accum_dtype=accum_dtype)
    if algorithm == "psum":
        return allreduce_psum(x, mesh, axes)
    if algorithm == "ring":
        x = allreduce_ring(x, mesh, inner, op=op, stagger=stagger)
        return allreduce_ring(x, mesh, outer, op=op, stagger=stagger)
    if algorithm == "rhd":
        x = allreduce_rhd(x, mesh, inner, op=op, dim=dim)
        return allreduce_rhd(x, mesh, outer, op=op, dim=dim)
    raise ValueError(f"unknown algorithm {algorithm!r}")


# ---------------------------------------------------------------------------
# The FSDP pair: reduce-scatter over the inner axis (+ allreduce over the
# outer ones) and its inverse all-gather.
# ---------------------------------------------------------------------------

def _psum_scatter(x: torch.Tensor, mesh: RankMesh, axis: str
                  ) -> torch.Tensor:
    """``lax.psum_scatter(tiled=True)``: rank r gets segment r of the sum."""
    nd = mesh.ndim
    p = mesh.axis_size(axis)
    seg = mesh.psum(x, axis).unflatten(nd, (p, -1))
    idx = mesh.axis_index(axis, x.device).long()
    idx = idx.reshape(*idx.shape, *([1] * (seg.dim() - nd)))
    return torch.take_along_dim(seg, idx, dim=nd).squeeze(nd)


def reduce_scatter(x: torch.Tensor, mesh: RankMesh, axes: Sequence[str], *,
                   algorithm: str = "ring", op: Op = torch.add,
                   stagger: int = 0, ordered: bool = False) -> torch.Tensor:
    """Reduce-scatter over the innermost axis (+ allreduce over outer axes).

    The backward of the FSDP parameter all-gather (``core/fsdp.py``): the
    leaf-switch aggregation of the gradient tree, with the pod level
    fully reduced.  ``ordered=True`` gives rank ``r`` segment ``r`` (the
    ``NamedSharding`` layout); otherwise the ring's ``r + 1`` and rhd's
    bit-reversed placements are kept.
    """
    *outers, inner = axes
    p = mesh.axis_size(inner)
    nd = mesh.ndim
    if x.shape[nd] % p:
        raise ValueError(f"reduce_scatter: len {x.shape[nd]} % {p} != 0")
    if algorithm == "ring":
        seg = ring_reduce_scatter(x, mesh, inner, op=op,
                                  stagger=-1 if ordered else stagger)
    elif algorithm in ("rhd", "fixed_tree"):
        seg = rhd_reduce_scatter(x, mesh, inner, op=op)
        if ordered:
            seg = mesh.ppermute(seg, inner, _bitrev_perm(p))
    elif algorithm == "psum":
        seg = _psum_scatter(x, mesh, inner)
    else:
        raise ValueError(f"unknown algorithm {algorithm!r}")
    for ax in outers:
        seg = allreduce(seg, mesh, (ax,), op=op,
                        algorithm="rhd" if algorithm != "psum" else "psum")
    return seg


def all_gather(seg: torch.Tensor, mesh: RankMesh, axes: Sequence[str], *,
               algorithm: str = "ring", stagger: int = 0,
               ordered: bool = False) -> torch.Tensor:
    """All-gather over the innermost axis (inverse of ``reduce_scatter``)."""
    inner = axes[-1]
    if algorithm == "ring":
        return ring_all_gather(seg, mesh, inner,
                               stagger=-1 if ordered else stagger)
    if algorithm in ("rhd", "fixed_tree"):
        if ordered:
            seg = mesh.ppermute(seg, inner,
                                _bitrev_perm(mesh.axis_size(inner)))
        return rhd_all_gather(seg, mesh, inner)
    if algorithm == "psum":
        return mesh.all_gather(seg, inner).flatten(mesh.ndim, mesh.ndim + 1)
    raise ValueError(f"unknown algorithm {algorithm!r}")


# ---------------------------------------------------------------------------
# Analytic wire-byte accounting.
# ---------------------------------------------------------------------------

def wire_bytes_per_rank(nbytes: int, p_inner: int, p_outer: int = 1, *,
                        algorithm: str) -> float:
    """Bytes each rank puts on the wire for a Z-byte allreduce."""
    z = float(nbytes)
    if algorithm == "ring":
        return 2 * z * (p_inner - 1) / p_inner * (1 if p_outer == 1 else 2)
    if algorithm == "rhd":
        return 2 * z * (p_inner - 1) / p_inner
    if algorithm == "fixed_tree":
        return z * math.log2(max(p_inner, 2)) + (
            z * math.log2(p_outer) if p_outer > 1 else 0.0)
    if algorithm in ("two_level", "hierarchical"):
        # the leaf level carries ~2Z(1-1/fanin) (reduce-scatter up, all-
        # gather down); the inter-level hop shrinks by the leaf fan-in
        inner = 2 * z * (p_inner - 1) / p_inner
        outer = 2 * (z / p_inner) * (p_outer - 1) / max(p_outer, 1)
        return inner + outer
    if algorithm == "psum":
        return 2 * z * (p_inner * p_outer - 1) / (p_inner * p_outer)
    raise ValueError(algorithm)
