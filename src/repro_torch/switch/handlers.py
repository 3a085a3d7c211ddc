"""sPIN-style packet handlers for the emulated switch (paper §3, §6).

The port of the dense part of ``repro/switch/handlers.py``.  A handler
triple — header (steering), payload (the combine) and completion
(finalisation) — runs over a whole child-stacked ingress at once.  Every
stack here carries a leading group axis: ``(G, P, n, ...)`` holds the
ingress of the G switches of one tree level (the ``vmap`` of the JAX
package written out), so one fold serves every switch of the level.

Aggregation-buffer designs (§6.1–§6.3) are folds over the child axis:
``single`` folds in stack (arrival) order, ``multi`` keeps ``n_bufs``
round-robin partials and merges them, ``tree`` combines in the aligned
binary tree over the child index (the ``tree_reduce`` kernel, fp32
accumulation) — the F3 bitwise-reproducibility mechanism.

The ``int8_dequant`` handler (F1) folds int8 payloads with their fp32
scales; ``sparse_merge`` (§7) merges the children's coordinate lists one
after another and counts the index collisions.

Exactly-once admission (``accept_mask``, ``fold_once``) gates the
reliability layer's deliveries before any fold.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core import compression, sparse
from repro_torch.kernels import ops
from repro_torch.switch import packets as pk

DESIGNS = ("single", "multi", "tree")


# ---------------------------------------------------------------------------
# Aggregation-buffer designs (§6.1–§6.3): folds over the child axis (1).
# ---------------------------------------------------------------------------

def fold_single(stack: torch.Tensor) -> torch.Tensor:
    """§6.1 contended single buffer: sequential fold in stack order."""
    acc = stack[:, 0]
    for i in range(1, stack.shape[1]):
        acc = acc + stack[:, i]
    return acc


def fold_multi(stack: torch.Tensor, n_bufs: int) -> torch.Tensor:
    """§6.2 multi-buffer: round-robin partials + the final (B-1)·L merge."""
    p = stack.shape[1]
    n_bufs = max(1, min(int(n_bufs), p))
    partials = [fold_single(stack[:, j::n_bufs]) for j in range(n_bufs)]
    acc = partials[0]
    for part in partials[1:]:
        acc = acc + part
    return acc


def fold_tree(stack: torch.Tensor) -> torch.Tensor:
    """§6.3 binary-counter tree: the aligned fixed tree over the child
    index (``kernels.ops.tree_reduce_slots``; fp32 accumulation for
    floats, exact native accumulation for integers; P padded to a power
    of two with zero streams).  A ``(G, P, S, E)`` packet-slot stack
    keeps its slot axis; any other stack folds as one slot of its
    flattened elements — the tree is elementwise, so the bits agree."""
    if stack.dim() == 4:
        return ops.tree_reduce_slots(stack)
    g, p = stack.shape[:2]
    flat = stack.reshape(g, p, 1, -1)
    return ops.tree_reduce_slots(flat).reshape(g, *stack.shape[2:])


def fold(stack: torch.Tensor, design: str, n_bufs: int = 1) -> torch.Tensor:
    if design == "single":
        return fold_single(stack)
    if design == "multi":
        return fold_multi(stack, n_bufs)
    if design == "tree":
        return fold_tree(stack)
    raise ValueError(f"unknown aggregation design {design!r}")


def combines_per_packet_slot(p: int, design: str) -> int:
    """Combine operations one packet slot costs across P children.

    Every design performs exactly ``P - 1`` combines per reduction-block
    packet slot — the quantity the analytic model's service times
    amortize — they differ in contention and working memory, not in
    arithmetic count.
    """
    if design not in DESIGNS:
        raise ValueError(f"unknown aggregation design {design!r}")
    return p - 1


# ---------------------------------------------------------------------------
# Header-handler steering: arrival order vs child-rank order.
# ---------------------------------------------------------------------------

def child_order(headers: torch.Tensor) -> torch.Tensor:
    """Per-packet-slot child order: ``(G, P, n)`` argsort of HDR_CHILD
    over the child axis, so any arrival permutation lands every payload
    in the same tree leaf."""
    return torch.argsort(headers[..., pk.HDR_CHILD], dim=1, stable=True)


def apply_order(leaf, order: torch.Tensor):
    """Reorder a ``(G, P, n, ...)`` payload leaf (or a dict of them, the
    int8 payload and its scales) by a ``(G, P, n)`` order."""
    if isinstance(leaf, dict):
        return {k: apply_order(v, order) for k, v in leaf.items()}
    o = order.reshape(order.shape + (1,) * (leaf.dim() - order.dim()))
    return torch.take_along_dim(leaf, o.expand(leaf.shape).long(), dim=1)


def child_order_opt(headers):
    """Child-rank steering when headers ride along (``None`` when the
    stack is already in child order)."""
    return None if headers is None else child_order(headers)


# ---------------------------------------------------------------------------
# Exactly-once admission: seen-bitmaps + checksum gating.
# ---------------------------------------------------------------------------

def accept_mask(arrives: torch.Tensor, ok: torch.Tensor,
                seen: torch.Tensor) -> torch.Tensor:
    """Which of a round's deliveries the switch admits: delivered,
    checksum-valid, and not yet in the per-(block, child) seen-bitmap —
    so duplicates and redundant retransmissions are idempotent and
    corrupted payloads never reach a fold."""
    return arrives & ok & ~seen


def fold_once(acc: torch.Tensor, update: torch.Tensor,
              accept: torch.Tensor) -> torch.Tensor:
    """Admit the accepted packets of one delivery round into the
    reassembly buffer: a select keyed on the accept mask, so folding the
    same round twice is a no-op.  ``update`` is a ``(G, P, n, ...)``
    stack; ``accept`` is ``(G, P, n)``, or ``(P, n)`` — one schedule for
    every switch of the level — and broadcasts over the leading ``G``
    and the payload's trailing axes.  ``acc`` broadcasts too (a 0-dim
    zero gives the admitted stack without a zero-filled copy)."""
    if accept.dim() == 2:
        accept = accept.unsqueeze(0)
    m = accept.reshape(accept.shape + (1,) * (update.dim() - 3))
    return torch.where(m, update, acc)


# ---------------------------------------------------------------------------
# The handler registry.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Handler:
    """One sPIN handler triple, vectorised over the packet batch axis.

    ``header_handler(headers) -> (G, P, n) order | None`` — steering.
    ``payload_handler(stack, headers, design, n_bufs, ctx) -> (agg,
    stats)`` — the combine over the (already steered) child stack.
    ``completion_handler(agg, ctx) -> egress`` — block finalisation.
    """

    name: str
    kind: str                       # dense | int8 | sparse
    header_handler: Callable
    payload_handler: Callable
    completion_handler: Callable
    #: designs this handler supports; fixed_tree pins "tree" (§6.3).
    designs: tuple[str, ...] = DESIGNS


def run(handler: Handler, payload: torch.Tensor | dict[str, torch.Tensor],
        headers: torch.Tensor, *, design: str, n_bufs: int = 1,
        ctx: dict | None = None):
    """Execute one handler triple over a child-stacked ingress.

    ``payload`` is ``(G, P, n, ...)`` (or a dict of such stacks, as the
    int8 handler's ``{"q", "scale"}``), ``headers`` the matching
    ``(G, P, n, F)`` stack.  Returns ``(egress, stats)``.
    """
    ctx = {} if ctx is None else ctx
    order = handler.header_handler(headers)
    if order is not None:
        payload = apply_order(payload, order)
        headers = apply_order(headers, order)
    agg, stats = handler.payload_handler(payload, headers, design, n_bufs,
                                         ctx)
    return handler.completion_handler(agg, ctx), stats


_REGISTRY: dict[str, Handler] = {}


def register(handler: Handler) -> Handler:
    _REGISTRY[handler.name] = handler
    return handler


def get_handler(name: str) -> Handler:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown switch handler {name!r}; have "
                         f"{sorted(_REGISTRY)}") from None


# -- dense sum ---------------------------------------------------------------

def _dense_payload(stack, headers, design, n_bufs, ctx):
    return fold(stack.to(ops.accum_dtype_for(stack.dtype)), design,
                n_bufs), {}


def _dense_completion(agg, ctx):
    return agg.to(ctx["dtype"])


register(Handler(
    name="dense_sum", kind="dense",
    header_handler=lambda headers: None,
    payload_handler=_dense_payload,
    completion_handler=_dense_completion))

# child-steered variant: the same folds in child-rank order instead of
# arrival order (the sparse plane's densified levels use it).
register(Handler(
    name="dense_sum_steered", kind="dense",
    header_handler=child_order_opt,
    payload_handler=_dense_payload,
    completion_handler=_dense_completion))


# -- fixed tree (F3 reproducible) --------------------------------------------

def _fixed_tree_payload(stack, headers, design, n_bufs, ctx):
    # design is pinned to "tree": §6.4 — "when reproducibility ... is
    # required, Flare always uses tree aggregation."
    return fold_tree(stack.to(ops.accum_dtype_for(stack.dtype))), {}


register(Handler(
    name="fixed_tree", kind="dense",
    header_handler=child_order,
    payload_handler=_fixed_tree_payload,
    completion_handler=_dense_completion,
    designs=("tree",)))


# -- int8 dequantize-accumulate (F1) -----------------------------------------

def _int8_payload(stack, headers, design, n_bufs, ctx):
    """stack = {"q": (G, P, n, E) int8, "scale": (G, P, n, E/qblock) fp32}.

    The slot axis is kept through the fold (``dequant_accum_slots``, one
    launch for the G switches of a level) whenever the per-packet payload
    tiles into whole quantization blocks; a payload narrower than a block
    folds its slots flattened (``dequant_accum``).  ``multi`` folds the
    round-robin buffers ``q[j::n_bufs]`` as strided views and adds the
    buffers in order; ``tree`` dequantizes and folds in the fixed tree.
    """
    q, s = stack["q"], stack["scale"]
    g, p = q.shape[:2]
    qblock = ctx["qblock"]
    if q.shape[-1] % qblock == 0:
        def accum(qs, ss):
            return ops.dequant_accum_slots(qs, ss, qblock)
    else:   # payload narrower than a quantization block: flatten slots
        def accum(qs, ss):
            pp = qs.shape[1]
            return torch.stack([
                ops.dequant_accum(qi.reshape(pp, -1), si.reshape(pp, -1),
                                  qblock).reshape(qs.shape[2:])
                for qi, si in zip(qs, ss)])
    if design == "single":
        acc = accum(q, s)
    elif design == "multi":
        n_bufs = max(1, min(int(n_bufs), p))
        acc = accum(q[:, 0::n_bufs], s[:, 0::n_bufs])
        for j in range(1, n_bufs):
            acc = acc + accum(q[:, j::n_bufs], s[:, j::n_bufs])
    elif design == "tree":
        deq = compression.dequantize_int8(q.reshape(g, p, -1),
                                          s.reshape(g, p, -1), qblock)
        acc = fold_tree(deq.reshape(q.shape))
    else:
        raise ValueError(f"unknown aggregation design {design!r}")
    return acc.reshape(g, *q.shape[2:]), {}


# child-rank steering makes the int8 plane's bits a pure function of
# child rank, so any arrival interleave gives the same result.
register(Handler(
    name="int8_dequant", kind="int8",
    header_handler=child_order_opt,
    payload_handler=_int8_payload,
    completion_handler=lambda agg, ctx: agg))   # stays fp32; the data
#                                 plane requantizes for the next wire hop


# -- sparse coordinate merge (§7) --------------------------------------------

def _list_nnz(idx: torch.Tensor) -> torch.Tensor:
    """Non-sentinel entries of each group's lists: ``(G, ...)`` → ``(G,)``
    int32."""
    return (idx != sparse.SENTINEL).reshape(idx.shape[0], -1).sum(
        dim=1, dtype=torch.int32)


def _sparse_payload(stack, headers, design, n_bufs, ctx):
    """stack = {"idx": (G, P, B, cap) int32, "val": (G, P, B, cap)}.

    Sequential insert-or-accumulate of each child's coordinate list into
    the aggregation storage, in stack order (the sorted-list analogue of
    the paper's hash table), counting index *collisions* — entries that
    accumulated into an existing slot, what the paper's fixed-size hash
    spills to the host (§7, Fig. 14).  Returns the merged ``(G, B, cap·P)``
    lists and ``{"collisions": (G,) int32}``.
    """
    idx, val = stack["idx"], stack["val"]
    merged_i, merged_v = idx[:, 0], val[:, 0]
    collisions = torch.zeros(idx.shape[0], dtype=torch.int32,
                             device=idx.device)
    for c in range(1, idx.shape[1]):
        before = _list_nnz(merged_i) + _list_nnz(idx[:, c])
        merged_i, merged_v = sparse.merge_coordinate_lists(
            merged_i, merged_v, idx[:, c], val[:, c])
        collisions += before - _list_nnz(merged_i)
    return {"idx": merged_i, "val": merged_v}, {"collisions": collisions}


register(Handler(
    name="sparse_merge", kind="sparse",
    header_handler=lambda headers: None,
    payload_handler=_sparse_payload,
    completion_handler=lambda agg, ctx: agg))
