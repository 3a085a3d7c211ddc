"""Wire allreduce algorithms over the rank mesh.

The port of part of ``repro/core/collectives.py``: the fixed-tree
recursive-doubling allreduce (§6.3, the F3 reproducible wire schedule),
the vendor psum, the §6.4 size switchover and the dispatch.  Each
function takes tensors with the mesh's rank axes in front and runs every
rank's program at once; a ``ppermute`` is an index along a rank axis.

The ring, rhd, two-level and hierarchical schedules are not ported yet
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
    raise NotImplementedError(f"wire algorithm {algorithm!r} {_TODO}")
