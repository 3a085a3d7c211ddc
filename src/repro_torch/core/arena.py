"""Flat-arena gradient packing: one padded buffer per dtype (paper §4/§6.2).

The port of ``repro/core/arena.py``.  All same-dtype leaves live
back-to-back in one flat arena, padded at the tail only and viewed as
``(num_buckets, bucket_elems)``; the plan is computed once per pytree
structure and the pad multiple the collectives need is folded into it.

Leaves carry the mesh's rank axes in front (``(*mesh, *shape)``); the
plan is built from the per-rank shapes, so it is the same plan the JAX
package builds, and ``pack`` / ``unpack`` carry the rank axes through.
``unpack`` returns views into the reduced arena, not copies.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Sequence

import torch


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.float32`` → ``"float32"`` (numpy's and JAX's names)."""
    return str(dtype).removeprefix("torch.")


@dataclasses.dataclass(frozen=True)
class LeafSlot:
    """Where one pytree leaf lives inside its dtype arena."""

    leaf_id: int                 # position in the flattened pytree
    offset: int                  # element offset into the flat arena
    size: int                    # flattened element count (per rank)
    shape: tuple[int, ...]       # per-rank shape


@dataclasses.dataclass(frozen=True)
class DtypeArena:
    """One dtype's padded flat buffer, viewed as equal-size buckets."""

    dtype: torch.dtype
    num_buckets: int             # B — reduction blocks in flight
    bucket_elems: int            # S — elements per block (padded)
    stagger_base: int            # global bucket index of bucket 0 (§5)
    slots: tuple[LeafSlot, ...]

    @property
    def total_elems(self) -> int:
        return self.num_buckets * self.bucket_elems

    @property
    def used_elems(self) -> int:
        return sum(s.size for s in self.slots)

    @property
    def valid_extents(self) -> tuple[int, ...]:
        """Unpadded element count of each bucket (padding is tail-only)."""
        used = self.used_elems
        return tuple(
            max(0, min(self.bucket_elems, used - b * self.bucket_elems))
            for b in range(self.num_buckets))

    def staggers(self, enabled: bool = True, device=None) -> torch.Tensor:
        """Per-bucket ring-phase offsets (staggered sending, §5)."""
        if not enabled:
            return torch.zeros(self.num_buckets, dtype=torch.int32,
                               device=device)
        return self.stagger_base + torch.arange(
            self.num_buckets, dtype=torch.int32, device=device)

    def _lead(self, leaves: Sequence[torch.Tensor]) -> tuple[int, ...]:
        s = self.slots[0]
        leaf = leaves[s.leaf_id]
        return tuple(leaf.shape[:leaf.dim() - len(s.shape)])

    def pack(self, leaves: Sequence[torch.Tensor]) -> torch.Tensor:
        """Gather this dtype's leaves into the ``(*lead, B, S)`` arena."""
        lead = self._lead(leaves)
        pieces = [leaves[s.leaf_id].reshape(*lead, s.size)
                  for s in self.slots]
        tail = self.total_elems - self.used_elems
        if tail:
            pieces.append(pieces[0].new_zeros(*lead, tail))
        flat = torch.cat(pieces, dim=-1)
        return flat.reshape(*lead, self.num_buckets, self.bucket_elems)

    def unpack(self, arena: torch.Tensor,
               out: list[torch.Tensor | None]) -> None:
        """Scatter a reduced ``(*lead, B, S)`` arena back into ``out``."""
        lead = tuple(arena.shape[:-2])
        flat = arena.reshape(*lead, self.total_elems)
        for s in self.slots:
            piece = flat[..., s.offset:s.offset + s.size]
            out[s.leaf_id] = piece.reshape(*lead, *s.shape)


@dataclasses.dataclass(frozen=True)
class FlatArena:
    """The full plan: one DtypeArena per distinct leaf dtype."""

    groups: tuple[DtypeArena, ...]
    num_leaves: int

    @property
    def num_buckets(self) -> int:
        return sum(g.num_buckets for g in self.groups)

    def pack(self, leaves: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        return [g.pack(leaves) for g in self.groups]

    def unpack(self, arenas: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        out: list[torch.Tensor | None] = [None] * self.num_leaves
        for g, a in zip(self.groups, arenas):
            g.unpack(a, out)
        return out


@functools.lru_cache(maxsize=256)
def _build_cached(keys: tuple, bucket_bytes: int,
                  pad_multiple: int) -> FlatArena:
    by_dtype: dict[str, list[int]] = {}
    for i, (_, name) in enumerate(keys):
        by_dtype.setdefault(name, []).append(i)

    groups: list[DtypeArena] = []
    stagger_base = 0
    for name in sorted(by_dtype):
        dtype = getattr(torch, name)
        ids = by_dtype[name]
        slots: list[LeafSlot] = []
        off = 0
        for i in ids:
            shape = keys[i][0]
            size = math.prod(shape)
            slots.append(LeafSlot(i, off, size, shape))
            off += size
        total = off
        total_bytes = total * dtype.itemsize
        b = max(1, math.ceil(total_bytes / bucket_bytes))
        s = math.ceil(total / b)
        s = max(pad_multiple, math.ceil(s / pad_multiple) * pad_multiple)
        # shrink B if padding made later buckets entirely empty
        b = max(1, math.ceil(total / s))
        groups.append(DtypeArena(dtype, b, s, stagger_base, tuple(slots)))
        stagger_base += b
    return FlatArena(tuple(groups), len(keys))


def build_plan(leaves: Sequence[torch.Tensor], bucket_bytes: int = 4 << 20,
               *, pad_multiple: int = 1, lead_dims: int = 0) -> FlatArena:
    """Compute (or fetch) the arena plan for a sequence of leaves.

    The first ``lead_dims`` axes of every leaf are rank axes and are not
    part of the plan.  ``pad_multiple`` folds the collectives'
    divisibility requirement into ``bucket_elems``.
    """
    keys = tuple((tuple(l.shape[lead_dims:]), dtype_name(l.dtype))
                 for l in leaves)
    return _build_cached(keys, int(bucket_bytes), int(pad_multiple))
