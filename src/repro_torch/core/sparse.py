"""Top-k sparse allreduce (paper §7): coordinate lists and their schedules.

The port of ``repro/core/sparse.py``: each rank sends the ``k``
largest-magnitude entries of every arena bucket as an index-sorted
``(idx, val)`` coordinate list; switches (``switch/dataplane.py``) or
the wire's recursive doubling (``sparse_allreduce*``) merge lists while
they fit under ``density_threshold · S`` and densify when they would
not.  Every function takes leading axes (rank and bucket axes) in front
of the list axis and treats each row on its own, as the JAX package's
``vmap`` does, so a batched schedule is its flat form with a bucket axis
and a per-bucket ``k_eff``.

Indices are int32 with ``SENTINEL`` (int32 max) marking an empty slot;
it sorts after every valid index, and the data plane bit-casts the lists
into its int32 wire image as they are.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

from repro_torch.core import collectives as coll
from repro_torch.kernels import ops
from repro_torch.kernels import ref as _ref
from repro_torch.mesh import RankMesh, axis_tuple

#: Sentinel index marking an empty slot; sorts after every valid index.
SENTINEL = torch.iinfo(torch.int32).max
#: elements of ``x`` a piece of ``topk_sparsify`` reads at once
SPARSIFY_CHUNK = 1 << 26


def sparse_k(frac: float, extent: int) -> int:
    """The list capacity of a bucket: ``frac`` of its **unpadded**
    extent, clamped to ``[1, extent]``."""
    return max(1, min(int(extent), int(frac * extent)))


def _rows(x: torch.Tensor) -> tuple[torch.Tensor, tuple[int, ...]]:
    return x.reshape(-1, x.shape[-1]), tuple(x.shape[:-1])


def _lowest_ties(a: torch.Tensor, kth: torch.Tensor,
                 ke: torch.Tensor) -> torch.Tensor:
    """The selection of rows whose ties at the ``k_eff``-th magnitude
    ``kth`` outnumber the slots left: every element above ``kth`` and the
    lowest-indexed ties, as a mask."""
    above = a > kth
    ties = (a == kth).cumsum(dim=1, dtype=torch.int32)
    return above | ((a == kth) & (ties <= ke - above.sum(dim=1,
                                                          keepdim=True)))


def topk_sparsify(x: torch.Tensor, k: int,
                  k_eff: torch.Tensor | int | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Magnitude top-k of each row of ``(..., size)`` → ``(values,
    indices)``, each ``(..., k)``, sorted by index.

    The entries kept are the first ``k_eff`` (default ``k``) in
    ``lax.top_k``'s order: magnitude descending, ties to the lower
    index.  ``torch.topk`` breaks ties in no promised order, so its
    first ``k_eff`` entries are taken only where they are every element
    at or above the ``k_eff``-th magnitude; a row with more ties there
    than slots keeps the elements above it and the lowest-indexed ties.
    ``k_eff`` may be a tensor that broadcasts over the leading axes (one
    per bucket); slots past it hold ``SENTINEL`` and ``0``.  Rows are
    taken a piece at a time, so no arena-sized temporary is held.
    """
    rows, lead = _rows(x)
    n, size = rows.shape
    if k > size:
        raise ValueError(f"k={k} > len(x)={size}")
    keff = torch.as_tensor(k if k_eff is None else k_eff,
                           device=x.device).broadcast_to(lead).reshape(-1)
    val = torch.empty((n, k), dtype=x.dtype, device=x.device)
    idx = torch.empty((n, k), dtype=torch.int32, device=x.device)
    slot = torch.arange(k, device=x.device)
    step = max(1, SPARSIFY_CHUNK // size)
    for r0 in range(0, n, step):
        c = slice(r0, min(r0 + step, n))
        a = rows[c].abs()
        ke = keff[c].long().unsqueeze(1)
        top, pick = torch.topk(a, k, dim=1)
        kth = top.gather(1, ke - 1)
        del top
        chosen = torch.where(slot < ke, pick, SENTINEL).sort(dim=1).values
        del pick
        spill = torch.nonzero((a >= kth).sum(dim=1) != ke.squeeze(1))[:, 0]
        if spill.numel():
            sel = _lowest_ties(a[spill], kth[spill], ke[spill])
            pos = torch.where(sel, sel.cumsum(dim=1) - 1, k)
            cols = torch.arange(size, device=x.device).expand_as(pos)
            slots = torch.full((spill.numel(), k + 1), SENTINEL,
                               dtype=torch.int64, device=x.device)
            chosen[spill] = slots.scatter_(1, pos, cols)[:, :k]
            del sel, pos, slots
        del a
        idx[c] = chosen
        valid = chosen != SENTINEL
        picked = rows[c].gather(1, torch.where(valid, chosen, 0))
        val[c] = torch.where(valid, picked, 0)
    return val.reshape(*lead, k), idx.reshape(*lead, k)


def scatter_dense(val: torch.Tensor, idx: torch.Tensor, size: int,
                  dtype: torch.dtype | None = None) -> torch.Tensor:
    """Scatter ``(..., k)`` coordinate lists into dense ``(..., size)``
    rows of ``dtype`` (default ``val``'s): zeros plus each entry, added
    in list order in ``dtype``; sentinels and negative indices drop.

    On the card this is the ``sparse_accum_slots`` kernel in its sorted
    mode, its fp32 result cast to ``dtype``: every list that reaches it
    comes from ``topk_sparsify`` or ``merge_coordinate_lists``, so it is
    index-sorted and index-unique with its ``SENTINEL`` tail last, which
    the kernel drops as out of range.  Each element then takes a single
    ``0 + v``, exact in fp32, bf16 and f16 (``-0.0`` becomes ``+0.0``,
    as the reference's scatter-add gives)."""
    i2, lead = _rows(idx)
    dtype = dtype or val.dtype
    if val.device.type != "cpu":
        out = ops.sparse_accum_slots(i2, val.reshape(i2.shape), size,
                                     indices_sorted=True)
        return out.to(dtype).reshape(*lead, size)
    out = torch.zeros((i2.shape[0], size), dtype=dtype, device=val.device)
    _ref.scatter_add_rows(out, i2, val.reshape(i2.shape))
    return out.reshape(*lead, size)


def residual_(v: torch.Tensor, val: torch.Tensor,
              idx: torch.Tensor) -> torch.Tensor:
    """Write ``v − scatter_dense(val, idx)`` over ``v`` without forming
    the dense copy: at each listed index ``v − (0 + val)``, the bits the
    reference's dense subtraction gives (``-0.0`` stays ``-0.0``); ``v``
    is left as it is elsewhere.  Each list's indices must be unique, as
    ``topk_sparsify`` makes them.  Returns ``v``."""
    v2 = v.view(-1, v.shape[-1])
    i2, _ = _rows(idx)
    vl = val.reshape(i2.shape)
    step = max(1, SPARSIFY_CHUNK // max(1, i2.shape[1]))
    for r0 in range(0, i2.shape[0], step):
        c = slice(r0, min(r0 + step, i2.shape[0]))
        ok = i2[c] != SENTINEL
        row = torch.arange(r0, c.stop, device=v.device).unsqueeze(1)
        r, col = row.expand_as(ok)[ok], i2[c][ok].long()
        v2[r, col] = v2[r, col] - (vl[c][ok].to(v.dtype) + 0.0)
    return v


def merge_coordinate_lists(idx_a: torch.Tensor, val_a: torch.Tensor,
                           idx_b: torch.Tensor, val_b: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge two index-sorted, index-unique coordinate lists, row by row
    over any leading axes.

    The output holds ``n_a + n_b`` slots; duplicate indices combine by
    addition; empty slots hold ``SENTINEL`` and ``0``.  As in the
    reference: a stable sort of the concatenation, entry ``i + 1`` folded
    into entry ``i`` where their indices match (``val + where(dup_next,
    next, 0)``, so every kept value gains an addition and ``-0.0``
    becomes ``+0.0``), then the survivors compacted by a running count.
    """
    idx = torch.cat([idx_a, idx_b], dim=-1)
    val = torch.cat([val_a, val_b], dim=-1)
    n = idx.shape[-1]
    order = torch.argsort(idx, dim=-1, stable=True)
    idx = idx.gather(-1, order)
    val = val.gather(-1, order)
    del order
    same = idx[..., 1:] == idx[..., :-1]
    nope = torch.zeros_like(same[..., :1])
    dup_next = torch.cat([same, nope], dim=-1)
    keep = ~torch.cat([nope, same], dim=-1)
    folded = val + torch.where(dup_next, torch.roll(val, -1, dims=-1),
                               0).to(val.dtype)
    dest = torch.where(keep, keep.cumsum(dim=-1) - 1, n)
    out_idx = torch.full((*idx.shape[:-1], n + 1), SENTINEL,
                         dtype=idx.dtype, device=idx.device)
    out_val = torch.zeros((*val.shape[:-1], n + 1), dtype=val.dtype,
                          device=val.device)
    out_idx.scatter_(-1, dest, idx)
    out_val.scatter_(-1, dest, torch.where(keep, folded, 0).to(val.dtype))
    return out_idx[..., :n], out_val[..., :n]


def densify_step(nnz_cap: int, size: int, density_threshold: float) -> bool:
    """Would a merge producing ``nnz_cap`` entries overflow sparse storage?"""
    return nnz_cap >= density_threshold * size or nnz_cap >= size


# ---------------------------------------------------------------------------
# The wire schedules: recursive doubling with densify-on-overflow.
# ---------------------------------------------------------------------------

def _is_pow2(p: int) -> bool:
    return p > 0 and (p & (p - 1)) == 0


def _exchange_lists(mesh: RankMesh, idx: torch.Tensor, val: torch.Tensor,
                    axis: str, perm) -> tuple[torch.Tensor, torch.Tensor]:
    """The lists of the XOR partner, every bucket's at once.  On a
    ``RankMesh`` a ppermute is an index along the rank axis, so the
    reference's int32 packing of the pair (one collective instead of
    two) gives the same bits and would only add a copy; its flat
    ``_exchange_flat`` is the same.  On a ``ProcessMesh`` each list is a
    send and a receive with the partner."""
    return mesh.ppermute(idx, axis, perm), mesh.ppermute(val, axis, perm)


def _merge_over_axis(idx, val, dense, cap: int, mesh: RankMesh, axis: str,
                     size: int, density_threshold: float):
    """One tree level of the sparse schedule: recursive doubling over
    ``axis`` with densify-on-overflow.  The ``(lists | dense)`` state
    carries across levels: lists of capacity ``cap`` while the next merge
    fits under ``density_threshold · size``, else an fp32 accumulator
    (``scatter_dense``, the kernel on the card) that the remaining steps
    sum densely.  Returns the updated ``(idx, val, dense, cap)``."""
    p = mesh.axis_size(axis)
    if not _is_pow2(p):
        raise ValueError(f"sparse merge requires power-of-two P, got {p}")
    for s in range(p.bit_length() - 1):
        perm = coll.xor_perm(p, 1 << s)
        if dense is None and densify_step(cap * 2, size, density_threshold):
            dense = scatter_dense(val, idx, size, torch.float32)
            idx = val = None
        if dense is None:
            idx, val = merge_coordinate_lists(
                idx, val, *_exchange_lists(mesh, idx, val, axis, perm))
            cap *= 2
        else:   # dense is this schedule's own: add in place
            dense.add_(mesh.ppermute(dense, axis, perm))
    return idx, val, dense, cap


def _reduce_lists(x: torch.Tensor, mesh: RankMesh, axes: Sequence[str],
                  k: int, k_eff, density_threshold: float, mean: bool):
    """Top-k of every row, then the carried merge over ``axes`` in turn
    (innermost first).  Returns ``(dense in x's dtype, (val, idx))``:
    the lists this rank sent, from which the caller forms its residual
    (``residual_``) without a dense copy of its contribution."""
    size = x.shape[-1]
    val, idx = topk_sparsify(x, k, k_eff)
    sent = (val, idx)
    dense, cap = None, k
    for axis in axes:
        idx, val, dense, cap = _merge_over_axis(
            idx, val, dense, cap, mesh, axis, size, density_threshold)
    if dense is None:
        dense = scatter_dense(val, idx, size, torch.float32)
    if mean:
        dense = mesh.mean(dense, axes)
    return dense.to(x.dtype), sent


def _bucket_ks(x: torch.Tensor, mesh: RankMesh, ks: Sequence[int] | int
               ) -> tuple[int, torch.Tensor]:
    """The list capacity ``max(ks)`` and the per-bucket ``k_eff`` of a
    ``(*mesh, B, Z)`` arena."""
    b = x.shape[mesh.ndim]
    ks = tuple(int(k) for k in (ks if hasattr(ks, "__len__") else [ks] * b))
    if len(ks) != b:
        raise ValueError(f"got {len(ks)} ks for {b} buckets")
    return max(ks), torch.tensor(ks, dtype=torch.int32, device=x.device)


def _check_pow2(mesh: RankMesh, axis: str) -> None:
    p = mesh.axis_size(axis)
    if not _is_pow2(p):
        raise ValueError(f"sparse_allreduce requires power-of-two P, got {p}")


def sparse_allreduce(x: torch.Tensor, mesh: RankMesh, axis: str, k: int, *,
                     density_threshold: float = 0.25, mean: bool = False,
                     k_eff: torch.Tensor | int | None = None):
    """Top-k sparse allreduce of ``(*mesh, Z)`` over one mesh axis.

    Each rank contributes its top-``k`` (the first ``k_eff``) entries by
    magnitude; recursive doubling merges the lists, log2 P steps, and
    densifies at the first step whose merged capacity would cross
    ``density_threshold · Z``, the crossover fixed by ``(k, Z,
    threshold)``.  Returns ``(reduced, (val, idx))``: the reduced vector
    in ``x``'s dtype and the lists this rank sent (the reference returns
    them scattered densely, ``my_contribution``).
    """
    _check_pow2(mesh, axis)
    return _reduce_lists(x, mesh, (axis,), k, k_eff, density_threshold,
                         mean)


def sparse_allreduce_batched(x: torch.Tensor, mesh: RankMesh, axis: str,
                             ks: Sequence[int] | int, *,
                             density_threshold: float = 0.25,
                             mean: bool = False):
    """:func:`sparse_allreduce` of a ``(*mesh, B, Z)`` arena in one
    schedule: each step's exchange carries every bucket's lists.  Bucket
    ``b`` keeps ``ks[b]`` entries in lists of capacity ``max(ks)``."""
    _check_pow2(mesh, axis)
    k_max, k_eff = _bucket_ks(x, mesh, ks)
    return _reduce_lists(x, mesh, (axis,), k_max, k_eff, density_threshold,
                         mean)


def _dense_outer(v: torch.Tensor, mesh: RankMesh, axis: str) -> torch.Tensor:
    """Dense allreduce of the last axis of ``(*mesh, ..., Z)`` over
    ``axis``: rhd when its size is a power of two, the ring (stagger 0
    for every bucket) otherwise."""
    if _is_pow2(mesh.axis_size(axis)):
        return coll.allreduce_rhd(v, mesh, axis, dim=v.dim() - 1)
    stagger = torch.zeros(v.shape[mesh.ndim:-1], dtype=torch.int32,
                          device=v.device)
    return coll.allreduce_ring(v, mesh, axis, stagger=stagger)


def sparse_allreduce_two_level(x: torch.Tensor, mesh: RankMesh,
                               inner_axis: str, outer_axis: str, k: int, *,
                               density_threshold: float = 0.25,
                               mean: bool = False,
                               k_eff: torch.Tensor | int | None = None):
    """Sparse within the pod, dense across: :func:`sparse_allreduce` over
    ``inner_axis``, then a dense allreduce of its result (in ``x``'s
    dtype) over ``outer_axis``."""
    reduced, sent = sparse_allreduce(x, mesh, inner_axis, k,
                                     density_threshold=density_threshold,
                                     k_eff=k_eff)
    reduced = _dense_outer(reduced, mesh, outer_axis)
    if mean:
        reduced = mesh.mean(reduced, (inner_axis, outer_axis))
    return reduced, sent


def sparse_allreduce_two_level_batched(x: torch.Tensor, mesh: RankMesh,
                                       inner_axis: str, outer_axis: str,
                                       ks: Sequence[int] | int, *,
                                       density_threshold: float = 0.25,
                                       mean: bool = False):
    """:func:`sparse_allreduce_two_level` of a ``(*mesh, B, Z)`` arena;
    each dense round carries every bucket."""
    k_max, k_eff = _bucket_ks(x, mesh, ks)
    return sparse_allreduce_two_level(
        x, mesh, inner_axis, outer_axis, k_max,
        density_threshold=density_threshold, mean=mean, k_eff=k_eff)


def sparse_allreduce_hier(x: torch.Tensor, mesh: RankMesh, inner_axis: str,
                          outer_axes, k: int, *,
                          density_threshold: float = 0.25,
                          mean: bool = False,
                          k_eff: torch.Tensor | int | None = None):
    """Hierarchical sparse allreduce: the recursive doubling merges lists
    within the pod, then continues across ``outer_axes`` (a name or
    names, innermost first), densifying wherever in the tree the running
    capacity crosses ``density_threshold · Z``.  Every axis must be a
    power of two."""
    return _reduce_lists(x, mesh, (inner_axis, *axis_tuple(outer_axes)), k,
                         k_eff, density_threshold, mean)


def sparse_allreduce_hier_batched(x: torch.Tensor, mesh: RankMesh,
                                  inner_axis: str, outer_axes,
                                  ks: Sequence[int] | int, *,
                                  density_threshold: float = 0.25,
                                  mean: bool = False):
    """:func:`sparse_allreduce_hier` of a ``(*mesh, B, Z)`` arena; every
    step, intra-pod and inter-pod, carries every bucket's lists."""
    k_max, k_eff = _bucket_ks(x, mesh, ks)
    return sparse_allreduce_hier(x, mesh, inner_axis, outer_axes, k_max,
                                 density_threshold=density_threshold,
                                 mean=mean, k_eff=k_eff)


def expected_sparse_wire_bytes(z_elems: int, k: int, p: int, *,
                               density_threshold: float = 0.25,
                               elem_bytes: int = 4,
                               idx_bytes: int = 4) -> float:
    """Analytic wire bytes per rank for the sparse schedule (roofline aid)."""
    steps = int(math.log2(p))
    total = 0.0
    cap = k
    densified = False
    for _ in range(steps):
        if not densified and densify_step(cap * 2, z_elems,
                                          density_threshold):
            densified = True
        if densified:
            total += z_elems * elem_bytes
        else:
            total += cap * (elem_bytes + idx_bytes)
            cap *= 2
    return total
