"""The Flare gradient-reduction engine (the paper's technique, first-class).

The port of ``repro/core/engine.py``.  ``GradReducer`` takes an
unreduced gradient pytree whose leaves carry the mesh's rank axes in
front (``(*mesh, *shape)``, one slice per emulated rank), and:

  1. packs the leaves into one padded ``(*mesh, B, S)`` arena per dtype
     (``core/arena.py``), with the collectives' pad folded into the plan;
  2. per dtype group, picks a transport (``core/transports.py``): the
     wire allreduce, or with ``transport="innetwork"`` the emulated
     switch data plane;
  3. reduces all B buckets of a group in one call and unpacks.

``arena=False`` keeps the reference's per-bucket loop
(``core/bucketing.py``: one unpadded bucket a call, each transport's
per-bucket oracle), which gives the arena's bits wherever the combine
is elementwise.

With ``reproducible=True`` (F3) the result is bitwise-deterministic and
bitwise-equal to the JAX package's on the same inputs.  With
``compression="int8"`` (F1) or ``sparse_k_frac > 0`` (§7), on the wire
or in the network, the reducer carries each rank's error-feedback
residual as its state.  With ``transport="innetwork"`` a ``fault_plan``
runs the switch over the lossy fabric (bitwise the fault-free result
while the plan survives, the wire transport when it cannot), and a
``manager`` (``runtime.SessionManager``) makes the reducer a tenant of a
shared switch.  A ``telemetry`` handle (``obs.Telemetry``) records the
switch's static counters and phase spans on the reducer's first call
for a given set of gradient shapes: the reference records them while
``jit`` traces its step, once per compiled shape, not once per step.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch import tree
from repro_torch.core import arena as arena_mod
from repro_torch.core import bucketing, transports
from repro_torch.mesh import RankMesh


@dataclasses.dataclass(frozen=True)
class FlareConfig:
    """Configuration of the in-network-style gradient reduction."""

    axes: tuple[str, ...] = ("data",)   # (outer..., inner); inner = leaf level
    algorithm: str = "auto"             # auto|ring|rhd|fixed_tree|
    #                                     two_level|hierarchical|psum
    reproducible: bool = False          # F3: bitwise-deterministic reduction
    compression: str = "none"           # none|int8  (F1 transport dtypes)
    sparse_k_frac: float = 0.0          # >0 → §7 sparse allreduce
    density_threshold: float = 0.25     # sparse densify-on-overflow point
    bucket_bytes: int = 4 << 20
    stagger: bool = True                # §5 staggered sending
    mean: bool = False                  # divide by world size after reduce
    arena: bool = True                  # flat-arena pipelined hot path
    #: flat vs hierarchical wire schedule; None → the reduction tree decides
    hierarchical: bool | None = None
    #: "auto" — the wire transports; "innetwork" — the emulated switch
    transport: str = "auto"
    #: deterministic lossy-fabric injection (innetwork only)
    fault_plan: Any = None
    #: flight recorder; never part of equality
    telemetry: Any = dataclasses.field(default=None, compare=False,
                                       repr=False)

    def __post_init__(self):
        if self.transport not in ("auto", "innetwork"):
            raise ValueError(f"unknown transport {self.transport!r}")
        if self.fault_plan is not None and self.transport != "innetwork":
            raise ValueError("fault_plan models the lossy switch fabric; "
                             "it needs transport='innetwork'")
        if self.transport == "innetwork":
            if self.algorithm != "auto":
                raise ValueError(
                    f"transport='innetwork' conflicts with algorithm="
                    f"{self.algorithm!r}: the switch data plane picks its "
                    "aggregation design by the §6.4 size switchover")
            if self.hierarchical is False:
                raise ValueError(
                    "transport='innetwork' is tree-driven by construction; "
                    "hierarchical=False cannot apply")
        if self.reproducible and self.compression != "none":
            raise ValueError("reproducible mode is incompatible with lossy "
                             "compression")
        if self.reproducible and self.sparse_k_frac > 0:
            raise ValueError("reproducible mode is incompatible with "
                             "sparsification")
        if self.compression not in ("none", "int8"):
            raise ValueError(f"unknown compression {self.compression!r}")
        if self.hierarchical and len(self.axes) < 2:
            raise ValueError("hierarchical=True needs a multi-axis mesh "
                             f"(axes={self.axes!r}); the tree has one level")
        if (self.hierarchical is True
                and self.algorithm not in ("auto", "hierarchical")):
            raise ValueError(
                f"hierarchical=True conflicts with algorithm="
                f"{self.algorithm!r}; use algorithm='auto' or 'hierarchical'")
        if self.hierarchical is False and self.algorithm == "hierarchical":
            raise ValueError("hierarchical=False conflicts with "
                             "algorithm='hierarchical'")


class GradReducer:
    """Reduces a gradient pytree over ``config.axes`` of ``mesh``.

    ``manager``/``tenant`` attach the reducer to a shared multi-tenant
    switch runtime (``runtime.SessionManager``, ``transport="innetwork"``
    only): each dtype arena opens its own session, named
    ``{tenant}/{dtype}`` (``"job0/float32"``), admitted against the
    switch's capacity, and reduces under the runtime's contention-derived
    packet arrival permutations.  Without a ``tenant`` the manager names
    one (``manager.new_tenant()``).
    """

    def __init__(self, config: FlareConfig, mesh: RankMesh, *,
                 manager=None, tenant: str | None = None):
        if manager is not None and config.transport != "innetwork":
            raise ValueError(
                "a runtime.SessionManager needs transport='innetwork'; "
                f"config has transport={config.transport!r}")
        if manager is not None and tenant is None:
            # two reducers sharing a manager are distinct tenants even
            # with equal shapes
            tenant = manager.new_tenant()
        missing = [a for a in config.axes if a not in mesh.axes]
        if missing:
            raise ValueError(f"config axes {missing} are not mesh axes "
                             f"{mesh.axes}")
        if config.sparse_k_frac > 0 and config.transport != "innetwork":
            # the wire's recursive-doubling merge needs a power-of-two
            # inner axis (and, hierarchical, outer axes): fail here, not
            # inside the first reduction
            inner = config.axes[-1]
            p = mesh.axis_size(inner)
            if p & (p - 1):
                raise ValueError(
                    f"sparse_k_frac={config.sparse_k_frac} requires a "
                    f"power-of-two inner axis for the §7 recursive-doubling "
                    f"merge; mesh axis {inner!r} has size {p}")
            sizes = tuple(mesh.axis_size(a) for a in config.axes[:-1])
            if config.hierarchical and any(n & (n - 1) for n in sizes):
                raise ValueError(
                    "hierarchical sparse transport requires power-of-two "
                    f"outer axes; mesh axes {config.axes[:-1]!r} have "
                    f"sizes {sizes}")
        self.config = config
        self.mesh = mesh
        self.manager = manager
        self.tenant = tenant
        #: gradient shapes already reduced: the port's record of the
        #: traces the reference would have compiled (telemetry records
        #: on the first call of each)
        self._traced: set = set()

    @property
    def needs_state(self) -> bool:
        """Whether the reducer carries error-feedback residuals."""
        c = self.config
        return c.compression != "none" or c.sparse_k_frac > 0

    def init_state(self, grads: Any) -> Any:
        """Zero error-feedback residuals shaped like ``grads`` (or None)."""
        if not self.needs_state:
            return None
        return tree.map_leaves(torch.zeros_like, grads)

    def __call__(self, grads: Any, state: Any = None) -> tuple[Any, Any]:
        """Reduce ``grads``; returns ``(reduced, state)``.  ``state`` is
        the error-feedback residual tree of the lossy transports (None
        for the lossless ones), shaped like ``grads``: pass it back in on
        the next step.  ``state=None`` counts as zero residuals.

        With ``transport="innetwork"`` the ranks share one copy of each
        reduced leaf: the multicast gives every rank the same bits, so a
        leaf is a broadcast view, stride 0 over the rank axes.  Update it
        out of place, or ``clone()`` it first: an in-place update raises
        (it would write through to every rank).  The wire transports
        return a tensor of their own for every rank.  State leaves are
        views into one arena per dtype.
        """
        if self.config.arena:
            return self._reduce_arena(grads, state)
        return self._reduce_legacy(grads, state)

    def _world(self) -> int:
        return self.mesh.world_size(self.config.axes)

    def _transport(self, dtype: torch.dtype, *, batched: bool,
                   record: bool = True) -> transports.Transport:
        """The group's transport; under a manager each dtype arena is its
        own wire image, hence its own session ``{tenant}/{dtype}``.
        Without ``record`` it records nothing (the shapes were traced)."""
        tenant = self.tenant
        if self.manager is not None and tenant is not None:
            tenant = f"{tenant}/{arena_mod.dtype_name(dtype)}"
        t = transports.from_config(self.config, self.mesh, dtype,
                                   batched=batched, manager=self.manager,
                                   tenant=tenant)
        return t if record else dataclasses.replace(t, telemetry=None)

    def _first_trace(self, leaves: list, ef_leaves) -> bool:
        """Whether this call is the first for these gradient shapes, the
        call on which the reference would trace (and record)."""
        key = (self.config.arena, ef_leaves is None,
               tuple((tuple(l.shape), l.dtype) for l in leaves))
        first = key not in self._traced
        self._traced.add(key)
        return first

    def attach(self, grads: Any) -> None:
        """Open this reducer's sessions on a shared switch for ``grads``,
        without reducing (nothing happens without a manager, or on the
        per-bucket path, which re-attaches its tenant bucket by bucket).

        Arrival permutations depend on every session of the switch, so a
        job that attached only at its first reduction would reduce on a
        switch that does not hold the later jobs' sessions yet.  Calling
        this for every job before the first step registers the whole mix
        (the reference traces every job once before its real builds for
        the same reason).  Only shapes and dtypes are read.
        """
        c = self.config
        if self.manager is None or not c.arena:
            return
        leaves, _, _ = self._leaves(grads, None)
        plan = arena_mod.build_plan(
            leaves, c.bucket_bytes, pad_multiple=self._pad_multiple(
                self._world()), lead_dims=self.mesh.ndim)
        for g in plan.groups:
            t = self._transport(g.dtype, batched=True)
            if isinstance(t, transports.SwitchTransport):
                t.attach(g.num_buckets, g.bucket_elems, g.dtype,
                         g.valid_extents)

    def _leaves(self, grads: Any, state: Any):
        leaves, spec = tree.flatten(grads)
        for l in leaves:
            if tuple(l.shape[:self.mesh.ndim]) != self.mesh.lead:
                raise ValueError(f"leaf {tuple(l.shape)} does not lead with "
                                 f"the mesh shape's rank dims "
                                 f"{self.mesh.lead}")
        ef_leaves = tree.flatten(state)[0] if state is not None else None
        return leaves, spec, ef_leaves

    def _pad_multiple(self, world: int) -> int:
        """Chunk divisibility folded into the arena plan: ``2 · world``
        covers every wire schedule; int8 adds whole quantization blocks."""
        pad = 2 * world
        if self.config.compression == "int8":
            pad = math.lcm(pad, world * transports.QUANT_BLOCK)
        return pad

    def _reduce_arena(self, grads: Any, state: Any) -> tuple[Any, Any]:
        c = self.config
        leaves, spec, ef_leaves = self._leaves(grads, state)
        record = self._first_trace(leaves, ef_leaves)
        plan = arena_mod.build_plan(
            leaves, c.bucket_bytes, pad_multiple=self._pad_multiple(
                self._world()), lead_dims=self.mesh.ndim)
        red_groups: list[torch.Tensor] = []
        ef_groups: list[torch.Tensor | None] = []
        for g in plan.groups:
            transport = self._transport(g.dtype, batched=True, record=record)
            # the packed arenas go straight into the call: a transport
            # may form its results in their storage
            red, ef_red = transport(
                g.pack(leaves),
                g.pack(ef_leaves) if ef_leaves is not None else None,
                g.staggers(c.stagger, leaves[0].device),
                g.valid_extents)
            red_groups.append(red)
            ef_groups.append(ef_red)
        out = tree.unflatten(spec, plan.unpack(red_groups))
        if not self.needs_state:
            return out, None
        ef_flat = plan.unpack([e if e is not None else torch.zeros_like(r)
                               for e, r in zip(ef_groups, red_groups)])
        return out, tree.unflatten(spec, ef_flat)

    def _reduce_legacy(self, grads: Any, state: Any) -> tuple[Any, Any]:
        """The per-bucket loop: each bucket, unpadded, through its
        transport's per-bucket oracle (``batched=False``)."""
        c = self.config
        nd = self.mesh.ndim
        leaves, spec, ef_leaves = self._leaves(grads, state)
        record = self._first_trace(leaves, ef_leaves)
        out: list[torch.Tensor | None] = [None] * len(leaves)
        new_ef: list[torch.Tensor | None] = [None] * len(leaves)
        for b in bucketing.build_buckets(leaves, c.bucket_bytes, c.stagger,
                                         lead_dims=nd):
            flat = bucketing.pack_bucket(leaves, b, nd).unsqueeze(nd)
            ef_flat = (bucketing.pack_bucket(ef_leaves, b, nd).unsqueeze(nd)
                       if ef_leaves is not None else None)
            stagger = torch.full((1,), b.stagger if c.stagger else 0,
                                 dtype=torch.int32, device=flat.device)
            red, ef_out = self._transport(b.dtype, batched=False,
                                          record=record)(
                flat, ef_flat, stagger, (b.num_elements,))
            for i, piece in bucketing.unpack_bucket(red.select(nd, 0),
                                                    leaves, b, nd):
                out[i] = piece
            if self.needs_state:
                # a lossless bucket's state is zeros, as on the arena path
                if ef_out is None:
                    ef_out = torch.zeros_like(red)
                for i, piece in bucketing.unpack_bucket(ef_out.select(nd, 0),
                                                        leaves, b, nd):
                    new_ef[i] = piece
        result = tree.unflatten(spec, out)
        if not self.needs_state:
            return result, None
        return result, tree.unflatten(spec, new_ef)
