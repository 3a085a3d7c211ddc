"""Wire allreduce algorithms over the rank mesh.

The port of part of ``repro/core/collectives.py``: the fixed-tree
recursive-doubling allreduce (§6.3, the F3 reproducible wire schedule),
recursive halving-doubling (rhd: reduce-scatter, all-gather, allreduce),
the vendor psum, the §6.4 size switchover, the dispatch, and the FSDP
pair ``reduce_scatter`` / ``all_gather``.  Each function takes tensors
with the mesh's rank axes in front and runs every rank's program at
once: a rank-local vector's leading axis is the tensor's axis
``mesh.ndim``, and a ``ppermute`` is an index along a rank axis.

The ring, two-level and hierarchical schedules are not ported yet
(ROADMAP queue 1 item 3); asking for them raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from repro_torch.mesh import RankMesh

Op = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

_TODO = "not ported yet: ROADMAP queue 1 item 3"


def _is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


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


def _bit(mesh: RankMesh, axis: str, d: int, like: torch.Tensor
         ) -> torch.Tensor:
    """Whether bit ``d`` of each rank's index on ``axis`` is set, shaped
    to broadcast against ``like``."""
    bit = (mesh.axis_index(axis, like.device) & d) != 0
    return bit.reshape(*bit.shape, *([1] * (like.dim() - mesh.ndim)))


# ---------------------------------------------------------------------------
# Recursive halving-doubling — bandwidth-optimal, log P steps.
# ---------------------------------------------------------------------------

def rhd_reduce_scatter(x: torch.Tensor, mesh: RankMesh, axis: str, *,
                       op: Op = torch.add) -> torch.Tensor:
    """Vector-halving distance-doubling reduce-scatter (power-of-two P).

    The combine tree per final segment is the aligned binary tree over
    rank ids, so the result is bitwise-reproducible for IEEE adds.  Rank
    ``r`` ends with the segment at bit-reversed position; use
    ``rhd_all_gather`` to invert.
    """
    p = mesh.axis_size(axis)
    nd = mesh.ndim
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


def rhd_all_gather(seg: torch.Tensor, mesh: RankMesh, axis: str
                   ) -> torch.Tensor:
    """Distance-halving all-gather inverting ``rhd_reduce_scatter``."""
    p = mesh.axis_size(axis)
    nd = mesh.ndim
    for k in reversed(range(p.bit_length() - 1)):
        d = 1 << k
        recv = mesh.ppermute(seg, axis, xor_perm(p, d))
        bit = _bit(mesh, axis, d, seg)
        seg = torch.where(bit, torch.cat([recv, seg], dim=nd),
                          torch.cat([seg, recv], dim=nd))
    return seg


def allreduce_rhd(x: torch.Tensor, mesh: RankMesh, axis: str, *,
                  op: Op = torch.add) -> torch.Tensor:
    """Recursive halving-doubling allreduce (multi-buffer design analogue)."""
    p = mesh.axis_size(axis)
    xp, n = pad_to_multiple(x, p, mesh.ndim)
    full = rhd_all_gather(rhd_reduce_scatter(xp, mesh, axis, op=op), mesh,
                          axis)
    return full.narrow(mesh.ndim, 0, n)


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
              reproducible: bool = False,
              accum_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Dispatch a per-rank allreduce over one or two mesh axes.

    ``axes`` is ``(inner,)`` or ``(outer, inner)``; the innermost axis is
    the leaf-switch level of the reduction tree.
    """
    axes = tuple(axes)
    if len(axes) not in (1, 2):
        raise ValueError(f"allreduce over 1 or 2 axes, got {axes}")
    if algorithm == "auto":
        nbytes = x[(0,) * mesh.ndim].numel() * x.element_size()
        algorithm = select_algorithm(nbytes, reproducible=reproducible,
                                     multi_level=len(axes) > 1)
    if reproducible and algorithm not in ("fixed_tree", "hierarchical"):
        raise ValueError("reproducible mode requires the fixed_tree or "
                         "hierarchical (fixed-tree levels) algorithm")
    if accum_dtype is None and reproducible:
        accum_dtype = torch.float32
    if algorithm == "fixed_tree":
        # inner level first, then the outer: the global combine order is
        # a function of (pod_id, rank_id) only → reproducible multi-pod
        for a in reversed(axes):
            x = allreduce_fixed_tree(x, mesh, a, op=op,
                                     accum_dtype=accum_dtype)
        return x
    if algorithm == "psum":
        return allreduce_psum(x, mesh, axes)
    if algorithm == "rhd":
        for a in reversed(axes):
            x = allreduce_rhd(x, mesh, a, op=op)
        return x
    raise NotImplementedError(f"wire algorithm {algorithm!r} {_TODO}")


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
    ``NamedSharding`` layout); rhd's bit-reversed placement otherwise.
    """
    *outers, inner = axes
    p = mesh.axis_size(inner)
    nd = mesh.ndim
    if x.shape[nd] % p:
        raise ValueError(f"reduce_scatter: len {x.shape[nd]} % {p} != 0")
    if algorithm == "ring":
        raise NotImplementedError(f"ring reduce-scatter {_TODO}")
    if algorithm in ("rhd", "fixed_tree"):
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
        raise NotImplementedError(f"ring all-gather {_TODO}")
    if algorithm in ("rhd", "fixed_tree"):
        if ordered:
            seg = mesh.ppermute(seg, inner,
                                _bitrev_perm(mesh.axis_size(inner)))
        return rhd_all_gather(seg, mesh, inner)
    if algorithm == "psum":
        return mesh.all_gather(seg, inner).flatten(mesh.ndim, mesh.ndim + 1)
    raise ValueError(f"unknown algorithm {algorithm!r}")
