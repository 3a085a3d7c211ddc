"""Single source of truth for how every tensor is partitioned.

The port of ``repro/sharding/rules.py``.  Strategy:

  * **TP/EP over ``model``**: attention projections on the flattened
    head dim, MLP ffn dims, mamba's ``d_inner``, MLA's latent, expert
    (E) dim, vocabulary; a leaf whose TP dim does not divide by ``tp``
    stays replicated (``decide``).  The layers run the split explicitly
    (``core.tp``).
  * **FSDP/ZeRO over ``data``**: every ≥64 Ki-element matrix is sharded
    on a non-TP dim, gathered per layer through
    ``core.fsdp.gather_params`` (whose backward is the Flare gradient
    reduce-scatter).  Parameters are replicated across ``pod``.
  * small tensors (norms) replicate; their gradients go through the
    ``GradReducer`` engine.

There are no ``PartitionSpec``s: on the rank-axis layout a rank-local
leaf ``x`` is a tensor ``(*mesh, *x.shape)`` (``shard_params``; its
global view ``unshard_params``), and a batch row block is a rank's
(``split_batch``), exactly where a ``NamedSharding`` would place them.
The rank axes are ``(pod, data)``, and ``(pod, data, model)`` where
``model`` > 1 (``MeshCfg.rank_mesh``): at ``model`` = 1 the layout,
the shapes and the bits are those of a mesh without the axis.

Serving's batch and cache: ``batch_spec`` and ``cache_specs`` name, for
each leaf, the mesh axes each dim is split over (a :class:`Spec`, the
entries of the reference's ``PartitionSpec``): the batch over the data
axes, and a cache's KV heads, else its sequence, else its features over
``model``.  ``split_batch`` and ``shard_cache`` lay a global tree out on
the rank axes as those specs say (``_place``), ``unshard_cache`` takes it
back (``_unplace``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch import tree
from repro_torch.core import fsdp as fsdp_mod
from repro_torch.mesh import ProcessMesh, RankMesh, active, require_emulated

#: leading-axis-stacked parameter collections (per-layer stacks)
STACKED_ROOTS = frozenset({
    "layers", "local_layers", "global_layers", "cross_layers",
    "dense_layers", "enc_layers", "dec_layers",
})

MIN_FSDP_SIZE = 1 << 16


@dataclasses.dataclass(frozen=True)
class MeshCfg:
    """Logical mesh: ('pod',)? + 'data' + 'model'."""

    axes: tuple[str, ...]
    shape: tuple[int, ...]

    @property
    def tp(self) -> int:
        return self.shape[self.axes.index("model")]

    @property
    def fsdp(self) -> int:
        return self.shape[self.axes.index("data")]

    @property
    def reduce_axes(self) -> tuple[str, ...]:
        """Gradient-reduction axes, outer→inner: ('pod','data') or ('data',)."""
        return tuple(a for a in self.axes if a != "model")

    @property
    def world(self) -> int:
        return math.prod(self.shape)

    @property
    def data_world(self) -> int:
        return math.prod(s for a, s in zip(self.axes, self.shape)
                         if a != "model")

    def rank_mesh(self) -> RankMesh | ProcessMesh:
        """The port's rank mesh: the reduction axes, and ``model`` last
        where it is larger than 1.  The ``ProcessMesh`` this thread has
        activated (``mesh.activate``, ``launch/procs.py``) where there is
        one, which must have those axes and sizes; else the emulated
        ``RankMesh``."""
        axes = self.reduce_axes + (("model",) if self.tp > 1 else ())
        shape = tuple(self.shape[self.axes.index(a)] for a in axes)
        pm = active()
        if pm is None:
            return RankMesh(shape, axes)
        if (pm.shape, pm.axes) != (shape, axes):
            raise ValueError(f"the active ProcessMesh {pm.shape} over "
                             f"{pm.axes} is not this mesh's {shape} over "
                             f"{axes}")
        return pm


#: leaf name → (tp_dim, fsdp_dim) for 2D weights
_RULES_2D = {
    "wq": (1, 0), "wk": (1, 0), "wv": (1, 0), "wo": (0, 1),
    "w_gate": (1, 0), "w_up": (1, 0), "w_down": (0, 1),
    "w_dkv": (1, 0), "w_kr": (None, 0), "w_ukv": (1, 0),
    "wz": (1, 0), "wx": (1, 0), "wb": (None, 0), "wc": (None, 0),
    "wdt": (None, 0), "out_proj": (0, 1),
    "router": (None, 0),
    "embed": (0, 1), "lm_head": (1, 0),
    "dec_pos": (None, 0), "enc_pos": (None, 0),
    "conv_xw": (1, None), "conv_bw": (None, None), "conv_cw": (None, None),
}


def decide(name: str, shape: tuple[int, ...], *, tp: int, fsdp: int,
           local_shard: bool = False) -> tuple[int | None, int | None]:
    """(tp_dim, fsdp_dim) for one *sliced* (no stack axis) leaf.

    ``local_shard=True`` means ``shape`` is the per-rank FSDP shard: the
    size threshold scales by ``fsdp`` and divisibility was already
    established on the global shape.
    """
    if len(shape) >= 3 and name in ("w_gate", "w_up", "w_down"):
        tp_dim, fsdp_dim = 0, 1        # expert-parallel MoE weights
    elif len(shape) < 2:
        return None, None
    elif name in _RULES_2D:
        tp_dim, fsdp_dim = _RULES_2D[name]
    else:
        tp_dim, fsdp_dim = None, (0 if len(shape) >= 2 else None)

    if tp_dim is not None and shape[tp_dim] % tp:
        tp_dim = None
    size = math.prod(shape) * (fsdp if local_shard else 1)
    if fsdp_dim is not None and (size < MIN_FSDP_SIZE
                                 or (not local_shard
                                     and shape[fsdp_dim] % fsdp)
                                 or fsdp_dim == tp_dim):
        fsdp_dim = None
    return tp_dim, fsdp_dim


def _leaf_name(path: tuple) -> tuple[str, bool]:
    """(leaf rule name, stacked?) from a tree path (dict keys only)."""
    keys = [k for k in path if isinstance(k, str)]
    stacked = bool(keys) and keys[0] in STACKED_ROOTS
    return (keys[-1] if keys else ""), stacked


def _dims(path: tuple, shape, mesh: MeshCfg) -> tuple:
    """(tp dim, fsdp dim) of a global leaf, each of the sliced leaf (no
    stack axis) or ``None``; the TP dim ``None`` at ``model`` = 1."""
    name, stacked = _leaf_name(path)
    sliced = tuple(shape[1:] if stacked else shape)
    tp_dim, fsdp_dim = decide(name, sliced, tp=mesh.tp, fsdp=mesh.fsdp)
    return (tp_dim if mesh.tp > 1 else None), fsdp_dim


def param_specs(params_tree: Any, mesh: MeshCfg) -> Any:
    """The FSDP dim of every leaf of a global params tree (of the sliced
    leaf, no stack axis; -1 for a replicated leaf)."""
    def f(path, leaf):
        d = _dims(path, leaf.shape, mesh)[1]
        return -1 if d is None else d
    return tree.map_with_path(f, params_tree)


def tp_specs(params_tree: Any, mesh: MeshCfg) -> Any:
    """The TP dim of every leaf of a global params tree (of the sliced
    leaf; -1 where it is replicated over ``model``, every leaf at
    ``model`` = 1)."""
    def f(path, leaf):
        d = _dims(path, leaf.shape, mesh)[0]
        return -1 if d is None else d
    return tree.map_with_path(f, params_tree)


def _local(sliced: tuple, dims: tuple, mesh: MeshCfg) -> tuple:
    """A sliced global shape divided on its TP and FSDP dims."""
    local = list(sliced)
    for d, n in zip(dims, (mesh.tp, mesh.fsdp)):
        if d is not None:
            local[d] //= n
    return tuple(local)


#: leaves that must stay fp32 through the compute path
KEEP_F32 = frozenset({"A_log", "D", "dt_bias", "router"})


def cast_params(params_tree: Any, dtype: torch.dtype) -> Any:
    """Cast float leaves to the compute dtype (KEEP_F32 names exempt)."""
    def f(path, leaf):
        name, _ = _leaf_name(path)
        if name in KEEP_F32 or not leaf.dtype.is_floating_point:
            return leaf
        return leaf.to(dtype)
    return tree.map_with_path(f, params_tree)


def make_gather(mesh: MeshCfg, algorithm: str, params_tree: Any,
                compute_dtype: torch.dtype | None = None):
    """FSDP gather closure passed to models (applied to sliced layer dicts
    whose leaves carry the rank axes in front).

    For each leaf the rules mark FSDP, all-gather it over ``data`` via
    ``core.fsdp.gather_params``, whose backward reduce-scatters the
    gradient over ``data`` and all-reduces it over ``pod``: the paper's
    reduction tree, per layer.  Decisions come from the *global* params
    tree, keyed by (leaf name, local shard shape).  ``compute_dtype``:
    float leaves are cast before the gather, so the gather and the
    reduce-scatter move the compute dtype and only the optimizer sees
    fp32 (KEEP_F32 leaves exempt).
    """
    rmesh = mesh.rank_mesh()
    axes = mesh.reduce_axes
    nd = rmesh.ndim
    lookup: dict[tuple[str, tuple[int, ...]], int] = {}

    def record(path, leaf):
        name, stacked = _leaf_name(path)
        sliced = tuple(leaf.shape[1:] if stacked else leaf.shape)
        dims = _dims(path, leaf.shape, mesh)
        fsdp_dim = dims[1]
        key = (name, _local(sliced, dims, mesh))
        val = -1 if fsdp_dim is None else fsdp_dim
        if lookup.get(key, val) != val:
            raise ValueError(f"ambiguous FSDP decision for {key}")
        lookup[key] = val
        return leaf
    tree.map_with_path(record, params_tree)

    def gather(layer_tree):
        def f(path, leaf):
            name, _ = _leaf_name(path)
            if (compute_dtype is not None and name not in KEEP_F32
                    and leaf.dtype.is_floating_point):
                leaf = leaf.to(compute_dtype)
            fsdp_dim = lookup.get((name, tuple(leaf.shape[nd:])), -1)
            if fsdp_dim < 0:
                return leaf
            return fsdp_mod.gather_params(leaf, rmesh, axes, algorithm,
                                          fsdp_dim)
        return tree.map_with_path(f, layer_tree)
    return gather


def shard_fsdp_leaves(params: Any, mesh: MeshCfg) -> Any:
    """What each rank's params look like: ``meta`` tensors with the
    shapes divided on their TP and FSDP dims (no allocation)."""
    def f(path, leaf):
        _, stacked = _leaf_name(path)
        shape = list(leaf.shape)
        shape[int(stacked):] = _local(tuple(shape[int(stacked):]),
                                      _dims(path, leaf.shape, mesh), mesh)
        return torch.empty(shape, dtype=leaf.dtype, device="meta")
    return tree.map_with_path(f, params)


def _split(leaf: torch.Tensor, d: int | None, n: int, off: int
           ) -> torch.Tensor:
    """``(n, *block)``: ``n`` blocks of ``leaf`` on dim ``d + off``, or ``n``
    copies where ``d`` is ``None``."""
    if d is None:
        return leaf.unsqueeze(0).expand(n, *leaf.shape)
    return torch.stack(leaf.chunk(n, dim=d + off))


def _join(x: torch.Tensor, d: int, off: int) -> torch.Tensor:
    """Inverse of :func:`_split`: the blocks on the leading axis
    concatenated on dim ``d + off``, or the first where ``d`` < 0."""
    return x[0] if d < 0 else torch.cat(x.unbind(0), dim=d + off)


def _own(rmesh, x: torch.Tensor) -> torch.Tensor:
    """An every-rank tensor ``(*mesh, *local)`` as the ranks of this
    program hold it, in storage of their own: all of it on the rank
    axes, this rank's block ``(*lead, *local)`` on a ``ProcessMesh``."""
    own = rmesh.own(x)
    if own is x:
        return x.contiguous()
    return own.clone(memory_format=torch.contiguous_format)


def shard_params(params: Any, mesh: MeshCfg) -> Any:
    """Global leaves → every rank's own copy, ``(*mesh, *local)``: data
    rank ``d`` holds block ``d`` of each FSDP dim, ``model`` rank ``m``
    block ``m`` of each TP dim, every pod the same; replicated leaves
    are copied to every rank.  On a ``ProcessMesh``, this rank's copy
    alone, ``(*lead, *local)``."""
    rmesh = mesh.rank_mesh()
    pods = rmesh.shape[:len(mesh.reduce_axes) - 1]

    def f(path, leaf):
        _, stacked = _leaf_name(path)
        tp_dim, fsdp_dim = _dims(path, leaf.shape, mesh)
        per = _split(leaf, fsdp_dim, mesh.fsdp, int(stacked))
        if mesh.tp > 1:                          # (data, model, *local)
            per = torch.stack([_split(b, tp_dim, mesh.tp, int(stacked))
                               for b in per.unbind(0)])
        return _own(rmesh, per.expand(*pods, *per.shape))
    return tree.map_with_path(f, params)


def replicate(x: torch.Tensor, mesh: MeshCfg, tp_dim: int = -1
              ) -> torch.Tensor:
    """A global tensor on every rank, ``(*mesh, *local)``: the same on
    every ``(pod, data)`` rank, split on ``tp_dim`` (of ``x``) over
    ``model`` where that is given and ``model`` > 1 (this rank's alone on
    a ``ProcessMesh``)."""
    if mesh.tp > 1:
        x = _split(x, None if tp_dim < 0 else tp_dim, mesh.tp, 0)
    rmesh = mesh.rank_mesh()
    red = rmesh.shape[:len(mesh.reduce_axes)]
    return _own(rmesh, x.expand(*red, *x.shape))


def unshard_params(params: Any, mesh: MeshCfg, dims: Any,
                   tp_dims: Any = None) -> Any:
    """Every rank's leaves ``(*mesh, *local)`` → the global leaves: the
    inverse of :func:`shard_params`, and what the reference's
    ``device_get`` of a sharded array gives.  An FSDP leaf is its data
    blocks concatenated, those of pod 0; a replicated leaf is rank 0's.
    Serves the optimizer moments too (they take the parameters' layout).

    ``dims`` is each leaf's FSDP dim, -1 where replicated
    (:func:`param_specs` of the global tree, ``TrainStep.dims``): a local
    shape alone does not tell a replicated leaf from the shard of a leaf
    ``fsdp`` times larger.  ``tp_dims`` is each leaf's TP dim
    (:func:`tp_specs`, ``TrainStep.tp_dims``), needed where ``model`` > 1:
    a TP leaf is its ``model`` blocks concatenated, those of data rank
    0's group first.
    """
    if mesh.tp > 1 and tp_dims is None:
        raise ValueError("unshard_params at model > 1 needs tp_dims")
    require_emulated(mesh.rank_mesh(), "unshard_params (the global state "
                     "of a checkpoint)", 23)
    pods = mesh.rank_mesh().ndim - (2 if mesh.tp > 1 else 1)

    def f(path, leaf, d, t):
        _, stacked = _leaf_name(path)
        per = leaf[(0,) * pods]                 # (fsdp, [tp,] *local)
        if mesh.tp > 1:
            per = torch.stack([_join(b, t, int(stacked))
                               for b in per.unbind(0)])
        return _join(per, d, int(stacked))

    leaves, spec = tree.flatten(params)
    tps = (tree.flatten(tp_dims)[0] if tp_dims is not None
           else [-1] * len(leaves))
    return tree.unflatten(spec, [f(p, l, d, t) for p, l, d, t in zip(
        tree.paths(params), leaves, tree.flatten(dims)[0], tps)])


# ---------------------------------------------------------------------------
# Batch and cache specs (serving), and their placement on the rank axes.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Spec:
    """How a global leaf lies on the mesh: for each of its leading dims the
    mesh axes it is split over, as the reference's ``PartitionSpec``
    entries (a tuple of names, one name, or ``None`` for a whole dim;
    dims past the entries are whole)."""

    dims: tuple = ()

    def axes(self, d: int) -> tuple[str, ...]:
        e = self.dims[d] if d < len(self.dims) else None
        return () if e is None else (e,) if isinstance(e, str) else tuple(e)

    def dim_of(self, axis: str) -> int | None:
        """The dim split over ``axis``, or ``None``."""
        for d in range(len(self.dims)):
            if axis in self.axes(d):
                return d
        return None


def batch_spec(batch_tree: Any, mesh: MeshCfg) -> Any:
    """Shard the leading batch dim over (pod, data) when divisible, else
    over ``data`` when that divides it, else replicate: the reference's
    ``batch_spec``, a :class:`Spec` for every leaf."""
    daxes = mesh.reduce_axes

    def f(leaf):
        if leaf.dim() == 0:
            return Spec()
        if leaf.shape[0] % mesh.data_world == 0:
            return Spec((daxes,))
        if leaf.shape[0] % mesh.fsdp == 0:
            return Spec((("data",),))
        return Spec()
    return tree.map_leaves(f, batch_tree)


_CACHE_SEQ_DIM = {"k": 2, "v": 2, "c_kv": 2, "k_rope": 2,
                  "xk": 2, "xv": 2}
_CACHE_HEAD_DIM = {"k": 3, "v": 3, "xk": 3, "xv": 3, "ssm": 2}
_CACHE_FEAT_DIM = {"conv_x": 3, "conv_b": 3, "conv_c": 3}


def cache_specs(cache_tree: Any, mesh: MeshCfg) -> Any:
    """Partition KV/SSM caches, as the reference's ``cache_specs``: the
    batch dim (caches are stacked ``(L, B, ...)``) over the data axes, or
    ``data``, when divisible; then ``model`` over the heads if they
    divide, else the sequence, else the features, else nothing.  A
    :class:`Spec` for every leaf (``pos``, a host int, is replicated)."""
    daxes = mesh.reduce_axes

    def f(path, leaf):
        keys = [k for k in path if isinstance(k, str)]
        name = keys[-1] if keys else ""
        if not isinstance(leaf, torch.Tensor) or leaf.dim() == 0:
            return Spec()
        spec: list = [None] * leaf.dim()
        if leaf.dim() >= 2:
            if leaf.shape[1] % mesh.data_world == 0:
                spec[1] = daxes
            elif leaf.shape[1] % mesh.fsdp == 0:
                spec[1] = "data"
        for dim_map in (_CACHE_HEAD_DIM, _CACHE_SEQ_DIM, _CACHE_FEAT_DIM):
            d = dim_map.get(name)
            if d is not None and d < leaf.dim() and spec[d] is None \
                    and leaf.shape[d] % mesh.tp == 0:
                spec[d] = "model"
                break
        return Spec(tuple(spec))
    return tree.map_with_path(f, cache_tree)


def seq_split_entries(specs: Any, mesh: MeshCfg) -> frozenset:
    """The entries (top-level keys) of a cache whose :func:`cache_specs`
    split a K/V leaf over its sequence on ``model``, none at ``model`` =
    1 (the specs name it there, a split into one block): what the
    serving layers read (``models.base.serving``)."""
    if mesh.tp == 1:
        return frozenset()
    return frozenset(
        entry for entry, leaves in specs.items() if isinstance(leaves, dict)
        and any(name in _CACHE_SEQ_DIM
                and sp.dim_of("model") == _CACHE_SEQ_DIM[name]
                for name, sp in leaves.items()))


def _place(x: torch.Tensor, spec: Spec, mesh: MeshCfg) -> torch.Tensor:
    """A global leaf on the rank axes as ``spec`` says, ``(*mesh,
    *local)``: a dim split over the data axes in blocks, rank ``r`` of the
    flattened (pod, data) axes the ``r``-th; one split over ``data``
    alone the same for every pod; one split over ``model`` in blocks
    over the ``model`` ranks; the rest whole on every rank.  A view where
    one can be (``expand``s share storage).  On a ``ProcessMesh`` this
    rank's block alone, ``(*lead, *local)``."""
    rmesh = mesh.rank_mesh()
    return rmesh.own(_place_all(x, spec, mesh, rmesh.shape))


def _place_all(x: torch.Tensor, spec: Spec, mesh: MeshCfg,
               rank_shape: tuple[int, ...]) -> torch.Tensor:
    """:func:`_place` on every rank, ``(*mesh, *local)``."""
    red = rank_shape[:len(mesh.reduce_axes)]
    nred = len(red)
    bd = next((d for d in range(x.dim())
               if set(spec.axes(d)) & {"pod", "data"}), None)
    if bd is None:
        y = x.expand(*red, *x.shape)
    elif spec.axes(bd) == ("data",) and nred > 1:
        y = x.unflatten(bd, (mesh.fsdp, x.shape[bd] // mesh.fsdp))
        y = y.movedim(bd, 0)
        y = y.expand(*red[:-1], *y.shape)
    else:
        y = x.unflatten(bd, (*red, x.shape[bd] // math.prod(red)))
        y = y.movedim(list(range(bd, bd + nred)), list(range(nred)))
    if mesh.tp == 1:
        return y
    md = spec.dim_of("model")
    if md is None:
        return y.unsqueeze(nred).expand(*red, mesh.tp, *y.shape[nred:])
    return torch.stack(y.chunk(mesh.tp, dim=nred + md), nred)


def _unplace(x: torch.Tensor, spec: Spec, mesh: MeshCfg) -> torch.Tensor:
    """Inverse of :func:`_place`: every rank's leaf ``(*mesh, *local)`` →
    the global leaf; a replicated dim is the first rank's copy."""
    nred = len(mesh.reduce_axes)
    if mesh.tp > 1:
        md = spec.dim_of("model")
        x = (x.select(nred, 0) if md is None
             else torch.cat(x.unbind(nred), dim=nred + md))
    bd = next((d for d in range(x.dim() - nred)
               if set(spec.axes(d)) & {"pod", "data"}), None)
    if bd is None:
        return x[(0,) * nred]
    if spec.axes(bd) == ("data",) and nred > 1:
        x = x[(0,) * (nred - 1)].movedim(0, bd)
        return x.flatten(bd, bd + 1)
    x = x.movedim(list(range(nred)), list(range(bd, bd + nred)))
    return x.flatten(bd, bd + nred)


def split_batch(batch: Any, mesh: MeshCfg) -> Any:
    """Each rank's rows of a global batch, ``(*mesh, rows, ...)``, as the
    reference's ``batch_spec`` places them (:func:`batch_spec`,
    :func:`_place`): rank ``r`` of the flattened (pod, data) axes gets
    rows ``r·B/P … (r+1)·B/P``; a batch that only divides by ``data`` is
    split over it and shared by the pods; one that divides by neither
    goes whole to every rank.  Every ``model`` rank of a ``(pod, data)``
    rank gets the same rows.  Views of the batch."""
    specs = batch_spec(batch, mesh)
    return tree.unflatten(tree.flatten(batch)[1], [
        _place(x, sp, mesh) for x, sp in zip(tree.flatten(batch)[0],
                                             tree.flatten(specs)[0])])


def shard_cache(cache: Any, mesh: MeshCfg, specs: Any | None = None) -> Any:
    """A global serving cache laid out on the rank axes as ``specs``
    (:func:`cache_specs` of it by default) say: every leaf ``(*mesh, L,
    B_r, S or S/tp, …)``, each rank's own copy, never the global cache's
    storage (the steps write it in place); ``pos`` as it is."""
    specs = cache_specs(cache, mesh) if specs is None else specs
    leaves, struct = tree.flatten(cache)
    return tree.unflatten(struct, [
        _place(x, sp, mesh).clone(memory_format=torch.contiguous_format)
        if isinstance(x, torch.Tensor) else x
        for x, sp in zip(leaves, tree.flatten(specs)[0])])


def unshard_cache(cache: Any, mesh: MeshCfg, specs: Any) -> Any:
    """The global view of a cache laid out by :func:`shard_cache` (or
    returned by a sharded prefill or decode step): the inverse of
    :func:`shard_cache` under the same ``specs``, whatever the sequence
    length."""
    leaves, struct = tree.flatten(cache)
    return tree.unflatten(struct, [
        _unplace(x, sp, mesh) if isinstance(x, torch.Tensor) else x
        for x, sp in zip(leaves, tree.flatten(specs)[0])])
