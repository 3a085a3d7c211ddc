"""The Flare train step on the rank-axis layout.

The port of ``repro/train/trainer.py`` without ``shard_map``: every
emulated rank's program runs at once, each rank-local tensor carrying
the mesh's ``(pod, data)`` axes in front (``sharding.rules.shard_params``
and ``split_batch`` place parameters and batch).  Gradient flow, the
paper's technique end to end:

  * FSDP-sharded weights reach the model through
    ``core.fsdp.gather_params``, whose backward is a Flare rhd /
    fixed-tree **reduce-scatter over data + allreduce over pod**, run
    per layer as the backward walks the stack.
  * Replicated leaves (norms) reach the ``GradReducer`` engine
    unreduced, one gradient per rank, and are reduced on its flat-arena
    path (wire or in-network, dense, int8 or sparse with error feedback,
    optionally bitwise-reproducible).
  * Global-norm clipping, then AdamW on each rank's own shards.

Each rank differentiates its own loss, divided by the data world size.
Autograd sees one leaf per parameter and per layer (views of the stacked
storage) whose ``.grad`` is a view into one zeroed stacked buffer, so the
per-layer gradients land in place and no rank's gradient is summed with
another's; a leaf used several times (zamba2's shared block) gets the
sum of its uses' gradients.

With ``model`` > 1 the rank axes are ``(pod, data, model)`` and the
layers run tensor- and expert-parallel (``core.tp``), every ``model``
rank differentiating its own copy of the loss: the conjugate operators
make each rank's gradient of a TP leaf its block's, and of a leaf
replicated over ``model`` the whole gradient, the same on every
``model`` rank.  The FSDP collectives and the ``GradReducer`` reduce
over ``(pod, data)``, each ``model`` rank's shard as a group of its own;
the gradient norm counts a TP leaf over ``model`` and a replicated one
once; the loss is summed over ``(pod, data)``.

With a ``sharding.rules.MeshCfg`` whose ``rank_mesh`` is a
``ProcessMesh`` (one process a rank, ``launch/procs.py``) the same step
runs in every process on its own rank's tensors, ``(1, 1, *local)``
(``mesh.lead``): the collectives go through ``torch.distributed``, and
every rank's result is its slice of the emulated step's.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable

import torch

from repro_torch import tree
from repro_torch.core import tp
from repro_torch.core.engine import FlareConfig, GradReducer
from repro_torch.mesh import RankMesh
from repro_torch.sharding import rules
from repro_torch.train import optim


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    gather_algorithm: str = "rhd"     # FSDP collective (fixed_tree → F3)
    flare: FlareConfig = dataclasses.field(
        default_factory=lambda: FlareConfig())


def _split_by_fsdp(tree_: Any, dims: Any):
    """Partition leaves into (fsdp, replicated) index sets."""
    leaves, spec = tree.flatten(tree_)
    dim_leaves = tree.flatten(dims)[0]
    if len(leaves) != len(dim_leaves):
        raise ValueError("params/dims tree mismatch")
    fsdp_idx = [i for i, d in enumerate(dim_leaves) if d >= 0]
    rep_idx = [i for i, d in enumerate(dim_leaves) if d < 0]
    return leaves, spec, fsdp_idx, rep_idx


def _leaf(p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """A fresh autograd leaf over ``p``'s storage whose gradient
    accumulates into ``g``."""
    t = p.detach().requires_grad_()
    t.grad = g
    return t


def _autograd_view(params: dict, grads: dict, rank_dims: int) -> dict:
    """The parameters as autograd leaves, stacked roots split into one
    dict per layer (``run_stack`` takes a list)."""
    out = {}
    for k, v in params.items():
        pl, spec = tree.flatten(v)
        gl = tree.flatten(grads[k])[0]
        if k in rules.STACKED_ROOTS:
            out[k] = [tree.unflatten(spec, [
                _leaf(p.select(rank_dims, i), g.select(rank_dims, i))
                for p, g in zip(pl, gl)])
                for i in range(pl[0].shape[rank_dims])]
        else:
            out[k] = tree.unflatten(spec, [_leaf(p, g)
                                           for p, g in zip(pl, gl)])
    return out


@dataclasses.dataclass
class TrainStep:
    """``step(params, opt_state, batch) → (params, opt_state, metrics)``
    with the pieces it is built from."""

    step: Callable
    init_opt_state: Callable
    gather: Callable
    reducer: GradReducer
    mesh: RankMesh
    dims: Any = None        # FSDP dim of every leaf, -1 where replicated
    tp_dims: Any = None     # TP dim of every leaf, -1 where replicated

    def __call__(self, params, opt_state, batch):
        return self.step(params, opt_state, batch)

    def attach(self, params) -> None:
        """Open the reducer's shared-switch sessions for these parameters'
        gradients (the replicated leaves), without stepping
        (``GradReducer.attach``)."""
        leaves, _, _, rep_idx = _split_by_fsdp(params, self.dims)
        self.reducer.attach([leaves[i] for i in rep_idx])


def make_train_step(model, mesh_cfg: rules.MeshCfg, tcfg: TrainConfig,
                    params_tree: Any, *, reduce_manager=None,
                    tenant: str | None = None) -> TrainStep:
    """Build the train step for every rank of ``mesh_cfg``.

    ``params_tree`` is the global tree (tensors, ``meta`` ones will do):
    only its structure and shapes are read, for the sharding rules.  The
    step takes each rank's parameters ``(*mesh, *local)``, updates them
    and the optimizer state in place, and returns the loss summed over
    the ranks (the global mean) and the global gradient norm.

    ``reduce_manager``/``tenant`` attach this job's ``GradReducer`` to a
    shared multi-tenant switch runtime (``runtime.SessionManager``,
    ``transport="innetwork"`` only): several jobs' steps then reduce as
    tenants of one switch.
    """
    mesh = mesh_cfg.rank_mesh()
    nd = mesh.ndim
    dims = rules.param_specs(params_tree, mesh_cfg)
    tp_dims = rules.tp_specs(params_tree, mesh_cfg)
    tp_leaves = [d >= 0 for d in tree.flatten(tp_dims)[0]]
    gather = rules.make_gather(mesh_cfg, tcfg.gather_algorithm, params_tree,
                               compute_dtype=model.cfg.dtype)
    reducer = GradReducer(tcfg.flare, mesh, manager=reduce_manager,
                          tenant=tenant)
    reduce_axes = mesh_cfg.reduce_axes
    data_world = mesh_cfg.data_world

    def sumsq(i: int, g: torch.Tensor) -> torch.Tensor:
        ss = (g.float() ** 2).sum(dim=tuple(range(nd, g.dim())))
        return mesh.psum(ss, "model") if tp_leaves[i] else ss

    def step_body(params, opt_state, batch):
        grads = tree.map_leaves(torch.zeros_like, params)
        view = _autograd_view(params, grads, nd)
        with tp.parallel(mesh_cfg.tp), warnings.catch_warnings():
            # local mean / data_world → summed gradients = global mean
            loss = model.loss(view, batch, gather=gather) / data_world
            # a layer's leaf is a strided view of its stack, and so is
            # the gradient it accumulates into
            warnings.filterwarnings("ignore", message=".*layout contract")
            loss.sum().backward()
        del view
        loss = loss.detach()

        # --- replicated-leaf reduction through the Flare engine ----------
        g_leaves, spec, fsdp_idx, rep_idx = _split_by_fsdp(grads, dims)
        ef = None
        if rep_idx:
            red, ef = reducer([g_leaves[i] for i in rep_idx],
                              opt_state.get("ef"))
            for i, r in zip(rep_idx, red):
                g_leaves[i] = r

        # --- global grad-norm clipping -----------------------------------
        zero = torch.zeros(mesh.lead, device=loss.device)
        fsdp_ss = sum((sumsq(i, g_leaves[i]) for i in fsdp_idx), zero)
        rep_ss = sum((sumsq(i, g_leaves[i]) for i in rep_idx), zero)
        if "data" in reduce_axes:
            fsdp_ss = mesh.psum(fsdp_ss, "data")
        gnorm = torch.sqrt(fsdp_ss + rep_ss)
        scale = torch.clamp(tcfg.clip_norm / (gnorm + 1e-9), max=1.0)
        for i, g in enumerate(g_leaves):
            s = scale.reshape(*mesh.lead, *([1] * (g.dim() - nd)))
            # the FSDP gradients are this step's own buffers; a reduced
            # replicated leaf may be a stride-0 broadcast: never written
            g_leaves[i] = g.mul_(s) if i in fsdp_idx else g * s
        grads = tree.unflatten(spec, g_leaves)

        # --- ZeRO update on local shards, in place --------------------------
        params, new_opt = optim.adamw_update(
            params, grads, opt_state, lr=tcfg.lr,
            weight_decay=tcfg.weight_decay)
        if ef is not None:
            new_opt["ef"] = ef
        loss = mesh.psum(loss, reduce_axes)    # undo /data_world
        first = (0,) * nd
        return params, new_opt, {"loss": loss[first], "grad_norm": gnorm[first]}

    def init_opt_state(params):
        st = optim.adamw_init(params)
        if reducer.needs_state:
            leaves, _, _, rep_idx = _split_by_fsdp(params, dims)
            st["ef"] = reducer.init_state([leaves[i] for i in rep_idx])
        return st

    return TrainStep(step_body, init_opt_state, gather, reducer, mesh, dims,
                     tp_dims)
