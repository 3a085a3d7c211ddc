"""Gradient bucketing and staggered scheduling (paper §4, §5).

The port of ``repro/core/bucketing.py``: the per-bucket path that
``GradReducer(FlareConfig(arena=False))`` walks, and the oracle the flat
arena is held to.  The gradient pytree is packed into same-dtype buckets
of about ``bucket_bytes`` (reduction blocks); with staggered sending each
bucket's ring starts at a bucket-dependent chunk offset (``stagger`` =
bucket index), so concurrent buckets traverse the ring out of phase.

Leaves carry the mesh's rank axes in front (``(*mesh, *shape)``): the
buckets are planned from the rank-local shapes, so they are the buckets
the JAX package plans, and a packed bucket is ``(*mesh, n)``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

from repro_torch.core.arena import dtype_name


@dataclasses.dataclass(frozen=True)
class Bucket:
    """A reduction block: a contiguous pack of same-dtype gradient leaves."""

    leaf_ids: tuple[int, ...]
    sizes: tuple[int, ...]       # flattened element counts per leaf (a rank)
    dtype: torch.dtype
    stagger: int                 # ring-phase offset (staggered sending)

    @property
    def num_elements(self) -> int:
        return sum(self.sizes)

    @property
    def nbytes(self) -> int:
        return self.num_elements * self.dtype.itemsize


def build_buckets(leaves: Sequence[torch.Tensor],
                  bucket_bytes: int = 4 << 20, stagger: bool = True, *,
                  lead_dims: int = 0) -> list[Bucket]:
    """Greedy same-dtype packing of leaves into ~``bucket_bytes`` blocks.

    The first ``lead_dims`` axes of every leaf are rank axes and are not
    part of its size.
    """
    by_dtype: dict[str, list[int]] = {}
    for i, leaf in enumerate(leaves):
        by_dtype.setdefault(dtype_name(leaf.dtype), []).append(i)

    buckets: list[Bucket] = []
    for name, ids in sorted(by_dtype.items()):
        dtype = getattr(torch, name)
        cur_ids: list[int] = []
        cur_sizes: list[int] = []
        cur_bytes = 0
        for i in ids:
            sz = math.prod(leaves[i].shape[lead_dims:])
            nb = sz * dtype.itemsize
            if cur_ids and cur_bytes + nb > bucket_bytes:
                buckets.append(Bucket(tuple(cur_ids), tuple(cur_sizes),
                                      dtype, len(buckets) if stagger else 0))
                cur_ids, cur_sizes, cur_bytes = [], [], 0
            cur_ids.append(i)
            cur_sizes.append(sz)
            cur_bytes += nb
        if cur_ids:
            buckets.append(Bucket(tuple(cur_ids), tuple(cur_sizes), dtype,
                                  len(buckets) if stagger else 0))
    return buckets


def pack_bucket(leaves: Sequence[torch.Tensor], bucket: Bucket,
                lead_dims: int = 0) -> torch.Tensor:
    """Concatenate a bucket's leaves into one ``(*lead, n)`` tensor (a
    copy of its own)."""
    lead = tuple(leaves[bucket.leaf_ids[0]].shape[:lead_dims])
    return torch.cat([leaves[i].reshape(*lead, sz)
                      for i, sz in zip(bucket.leaf_ids, bucket.sizes)],
                     dim=-1)


def unpack_bucket(flat: torch.Tensor, leaves: Sequence[torch.Tensor],
                  bucket: Bucket, lead_dims: int = 0
                  ) -> list[tuple[int, torch.Tensor]]:
    """Split a reduced ``(*lead, n)`` tensor back into ``(leaf_id,
    tensor)`` pieces: views of ``flat``, shaped as the leaves."""
    lead = tuple(flat.shape[:-1])
    out = []
    off = 0
    for i, sz in zip(bucket.leaf_ids, bucket.sizes):
        piece = flat[..., off:off + sz]
        out.append((i, piece.reshape(*lead, *leaves[i].shape[lead_dims:])))
        off += sz
    return out
