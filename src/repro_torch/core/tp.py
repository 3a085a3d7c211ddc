"""Tensor and expert parallelism over the mesh's ``model`` axis.

The JAX package leaves ``model`` to XLA's SPMD partitioner: its step is
``shard_map``-manual over ``(pod, data)`` only, and XLA places the
collectives that make a ``model``-sharded program compute the function
of the unsharded one.  The port partitions explicitly, Megatron-style,
on the rank-axis layout: with ``model`` > 1 every rank-local tensor
carries the ``model`` axis among its leading rank axes, and a layer
moves between a *replicated* region (every ``model`` rank holds the same
values: the residual stream, norms, routers) and a *rank-local* one (a
rank's heads, FFN columns, experts, vocabulary rows) through the
conjugate operators below.

Each ``model`` rank differentiates its own copy of the loss, as each
rank of a real mesh does.  On the rank-axis layout the copies are slices
of one tensor, so a plain sum over the ``model`` axis followed by an
expand would, under ``loss.sum().backward()``, hand every rank ``tp``
times its gradient: the backward of an expand is a sum over the copies.
The operators pair each forward with the backward that makes every
rank's gradient the gradient of one loss:

  * :func:`copy_to_model` enters the rank-local region: the identity
    forward, a sum over ``model`` backward (every rank's partial
    gradient of a value all ranks read);
  * :func:`reduce_from_model` leaves it with partial sums: a sum over
    ``model`` forward, the identity backward;
  * :func:`gather_from_model` leaves it with shards: an all-gather along
    a dim forward, each rank's own slice backward;
  * :func:`allreduce_model` sums partial values that feed rank-local
    work again (a norm over a split dim): a sum both ways;
  * :func:`lse_combine` joins partial attention over a sequence split
    across ``model`` (sharded serving's decode): each rank's output over
    its block of keys, weighted by its log-sum-exp.

Sums over ``model`` run in rank order, rank 0 first, so a replay gives
the same bits, and every rank holds the one result (a broadcast view).
The operators take the position ``dim`` of the ``model`` axis among the
tensor's leading dims.  :func:`parallel` sets the ``model`` size the
layers read (:func:`size`); outside it the size is 1 and no layer takes
a TP branch.  The size is the process's, not a context variable's: on
the card autograd runs the backward, and with it a remat recompute of
the forward, on a thread of its own.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.launch import step_analysis

_SIZE = [1]


@contextlib.contextmanager
def parallel(tp: int):
    """Run the layers with a ``model`` axis of ``tp`` ranks (the forward
    and the backward: a remat recompute runs the forward again)."""
    before = _SIZE[0]
    _SIZE[0] = int(tp)
    try:
        yield
    finally:
        _SIZE[0] = before


def size() -> int:
    """The ``model`` axis size the layers run at (1 outside
    :func:`parallel`)."""
    return _SIZE[0]


def splits(n: int) -> bool:
    """Whether a dim of ``n`` is split over ``model``: the sharding rules
    keep a leaf's TP dim where it divides by ``tp`` (``rules.decide``);
    a size of 0 (none given) never splits."""
    tp = size()
    return tp > 1 and n > 0 and n % tp == 0


def model_dim(w: torch.Tensor, own: int) -> int:
    """The ``model`` axis of a weight of rank ``own`` that carries the
    rank axes in front: the last of them."""
    r = w.dim() - own
    if r < 1:
        raise ValueError("tensor parallelism needs the rank axes in front")
    return r - 1


def psum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The sum over ``dim`` in rank order, on every rank (a view)."""
    acc = x.select(dim, 0)
    for m in range(1, x.shape[dim]):
        acc = acc + x.select(dim, m)
    out = acc.unsqueeze(dim).expand(x.shape)
    step_analysis.collective("all-reduce", out, x.shape[dim],
                             step_analysis.group_ranks(x, dim))
    return out


def pmax(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The maximum over ``dim``, on every rank, outside autograd."""
    out = x.detach().amax(dim, keepdim=True).expand(x.shape)
    step_analysis.collective("all-reduce", out, x.shape[dim],
                             step_analysis.group_ranks(x, dim))
    return out


def rank_index(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Each rank's index on the ``model`` axis ``dim`` of ``x``, shaped to
    broadcast against it."""
    view = [1] * x.dim()
    view[dim] = x.shape[dim]
    return torch.arange(x.shape[dim], device=x.device).reshape(view)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim = dim
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return psum(g, ctx.dim), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        return psum(x, dim)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim = dim
        return psum(x, dim)

    @staticmethod
    def backward(ctx, g):
        return psum(g, ctx.dim), None


def _gather(x: torch.Tensor, dim: int, along: int) -> torch.Tensor:
    """Every rank's shard joined along ``along`` (a dim after the rank
    axes), on every rank."""
    full = torch.cat(x.unbind(dim), dim=along - 1 if along > dim else along)
    out = full.unsqueeze(dim).expand(
        *x.shape[:dim], x.shape[dim], *full.shape[dim:])
    step_analysis.collective("all-gather", out, x.shape[dim],
                             step_analysis.group_ranks(x, dim))
    return out


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, along):
        ctx.dim, ctx.along, ctx.n = dim, along, x.shape[along]
        return _gather(x, dim, along)

    @staticmethod
    def backward(ctx, g):
        return own_slice(g, ctx.dim, ctx.along, ctx.n), None, None


def own_slice(x: torch.Tensor, dim: int, along: int, n: int
              ) -> torch.Tensor:
    """Rank ``m``'s block ``m`` of ``n`` entries along ``along``, every
    rank's stacked on ``dim``."""
    return torch.stack([x.select(dim, m).narrow(
        along - 1 if along > dim else along, m * n, n)
        for m in range(x.shape[dim])], dim)


def copy_to_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Enter the rank-local region: the identity forward, a sum over
    ``model`` backward."""
    return _Copy.apply(x, dim)


def reduce_from_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Leave the rank-local region with partial sums: their sum over
    ``model`` forward, the identity backward."""
    return _Reduce.apply(x, dim)


def allreduce_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Partial sums that rank-local work reads again: a sum over
    ``model`` both ways."""
    return _AllReduce.apply(x, dim)


def gather_from_model(x: torch.Tensor, dim: int, along: int = -1
                      ) -> torch.Tensor:
    """Leave the rank-local region with shards: the shards joined along
    ``along`` forward, each rank's own block of the gradient backward.
    ``along`` counts in the whole tensor (a negative one from its end)."""
    along = along % x.dim()
    return _Gather.apply(x, dim, along)


def local_slice(x: torch.Tensor, dim: int, along: int = -1) -> torch.Tensor:
    """A replicated value's block for each rank along ``along`` (a rank's
    heads of ``dt``, its channels of a bias): the entry into the
    rank-local region, then rank ``m``'s ``m``-th of ``tp`` blocks."""
    along = along % x.dim()
    tp = x.shape[dim]
    return own_slice(copy_to_model(x, dim), dim, along, x.shape[along] // tp)


def lse_combine(o: torch.Tensor, lse: torch.Tensor, dim: int
                ) -> torch.Tensor:
    """Every ``model`` rank's partial attention over its block of keys →
    the attention over all of them, on every rank (serving, no autograd).

    ``o`` is ``(..., Sq, H, vd)``, ``lse`` ``(..., Sq, H)`` fp32, the
    ``model`` axis at ``dim``.  Rank ``m`` weighs its output by
    ``exp(lse_m − max lse)`` (:func:`pmax`); the weighted outputs and the
    weights are summed in fp32 in rank order (:func:`psum`) and divided.
    A rank with ``lse = -inf`` (no visible key) contributes exactly 0.
    Returns ``o``'s shape and dtype."""
    lse = lse.float()
    keyless = torch.isneginf(lse)
    w = torch.where(keyless, 0.0, torch.exp(lse - pmax(lse, dim)))
    num = psum(w[..., None] * o.float(), dim)
    den = psum(w, dim)[..., None]
    return (num / torch.clamp(den, min=1e-30)).to(o.dtype)
