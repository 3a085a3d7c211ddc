"""Top-k coordinate lists for the in-network sparse allreduce (paper §7).

The port of the list half of ``repro/core/sparse.py``: each rank sends
the ``k`` largest-magnitude entries of every arena bucket as an
index-sorted ``(idx, val)`` coordinate list; switches merge lists while
they fit under ``density_threshold · S`` and densify when they would
not.  Every function takes leading axes (rank and bucket axes) in front
of the list axis and treats each row on its own, as the JAX package's
``vmap`` does.

Indices are int32 with ``SENTINEL`` (int32 max) marking an empty slot;
it sorts after every valid index, and the data plane bit-casts the lists
into its int32 wire image as they are.

The wire recursive-doubling schedules (``sparse_allreduce*``) are not
ported yet (ROADMAP queue 1 item 8).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref as _ref

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
    in list order in ``dtype``; sentinels and negative indices drop."""
    i2, lead = _rows(idx)
    out = torch.zeros((i2.shape[0], size), dtype=dtype or val.dtype,
                      device=val.device)
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
