"""AdamW, elementwise over every rank's parameters.

The port of ``repro/train/optim.py``.  Moments are elementwise over the
parameters, so they take the parameters' layout: each rank updates only
its own FSDP shard (ZeRO-1), with no optimizer-state collectives.

Unlike the reference's pure functions, ``adamw_update`` updates the
parameters and both moments **in place**, leaf by leaf and in pieces of
``PIECE`` elements, so a step holds no second copy of the parameters or
the moments (at TinyLlama-1.1B on 8 ranks those are 8.8 GB each in
fp32).  It only reads the gradients: a reduced leaf from the in-network
``GradReducer`` is one copy broadcast with stride 0 over the rank axes,
and must never be written.
"""
from __future__ import annotations

import torch

from repro_torch import tree

#: elements updated at a time (bounds the update's temporaries)
PIECE = 1 << 24


def adamw_init(params):
    dev = tree.flatten(params)[0][0].device
    return {
        "m": tree.map_leaves(torch.zeros_like, params),
        "v": tree.map_leaves(torch.zeros_like, params),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def _update(p, g, m, v, c1, c2, lr, b1, b2, eps, weight_decay):
    g = g.float()
    m.mul_(b1).add_((1 - b1) * g)
    v.mul_(b2).add_((1 - b2) * g * g)
    step = (m / c1) / ((v / c2).sqrt_() + eps)
    p.sub_(lr * step.add_(weight_decay * p))


def adamw_update(params, grads, opt_state, *, lr=3e-4, b1=0.9, b2=0.95,
                 eps=1e-8, weight_decay=0.1):
    """One AdamW step, in place; returns ``(params, opt_state)`` (the
    same tensors, and the moments with the step count advanced)."""
    step = opt_state["step"] + 1
    t = step.float()
    c1 = 1.0 - b1 ** t
    c2 = 1.0 - b2 ** t
    for p, g, m, v in zip(tree.flatten(params)[0], tree.flatten(grads)[0],
                          tree.flatten(opt_state["m"])[0],
                          tree.flatten(opt_state["v"])[0]):
        if g.shape != p.shape:
            raise ValueError(f"gradient {tuple(g.shape)} for parameter "
                             f"{tuple(p.shape)}")
        pf, mf, vf = p.view(-1), m.view(-1), v.view(-1)
        gf = g.reshape(-1)
        for i in range(0, pf.numel(), PIECE):
            s = slice(i, i + PIECE)
            _update(pf[s], gf[s], mf[s], vf[s], c1, c2, lr, b1, b2, eps,
                    weight_decay)
    return params, {"m": opt_state["m"], "v": opt_state["v"], "step": step}


def global_grad_norm(fsdp_sumsq: torch.Tensor, rep_sumsq: torch.Tensor,
                     mesh, data_axis: str = "data") -> torch.Tensor:
    """Global L2 norm with FSDP shards summed over the data axis; the
    per-rank sums carry the mesh's rank axes."""
    return torch.sqrt(mesh.psum(fsdp_sumsq, data_axis) + rep_sumsq)
