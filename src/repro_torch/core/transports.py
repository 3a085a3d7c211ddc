"""The transport layer: one reduction schedule per dtype arena.

The port of ``repro/core/transports.py``.  A ``Transport`` reduces a
whole ``(*mesh, B, S)`` dtype arena — all B buckets of every rank in one
call:

* ``DenseTransport`` — the wire allreduce: ring (each bucket at its own
  §5 stagger), rhd, fixed_tree, two_level, the tree-driven hierarchical
  schedule and psum;
* ``Int8Transport`` — F1 on the wire under error feedback: the int8
  protocol (``compression.quantized_allreduce*``: one ``all_to_all`` and
  one all-gather pair a level for every bucket), hierarchical or flat
  over each axis in turn;
* ``SparseTransport`` — §7 on the wire under error feedback: top-k
  coordinate lists merged by recursive doubling with densify-on-overflow
  (``sparse.sparse_allreduce*``), within the pod only (``two_level``)
  or across the tree (hierarchical);
* ``SwitchTransport`` — the emulated switch data plane: in dense mode
  ``switch.dataplane.switch_allreduce_dense``, which with
  ``reproducible=True`` folds every level in the ``tree_reduce`` kernel;
  in int8 mode ``switch_allreduce_int8`` under error feedback, which
  quantizes with the ``quantize`` kernel and folds every level in the
  ``dequant_accum_slots`` kernel; in sparse mode
  ``switch_allreduce_sparse`` under error feedback, which merges top-k
  coordinate lists and densifies them in the ``sparse_accum_slots``
  kernel.  Under a ``fault_plan`` every plane runs over the lossy
  fabric; a plan the retry budget cannot recover hands the arena to the
  matching wire transport.  With a ``manager``
  (``runtime.SessionManager``) the transport is one tenant of a shared
  switch: it attaches its session (admission control;
  ``runtime.AdmissionError`` propagates to the caller) and its planes
  run under the manager's contention-derived arrival permutations.
  With a ``telemetry`` handle (``obs.Telemetry``) a solo transport
  records the static counters of its wire image and every plane its
  phase spans (``_record_solo``, ``dataplane._PlaneObs``).

``batched=False`` keeps the reference's per-bucket ancestor (its
``lax.scan``; the switch's per-packet plane) as the bitwise oracle of the
batched schedule.

The lossy transports consume ``buf``: the error-feedback sum and then
the new residual are formed in its storage
(``compression.error_feedback_step``), so callers pass an arena of their
own.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch

from repro_torch.core import collectives as coll, compression, sparse
from repro_torch.core import topology
from repro_torch.mesh import RankMesh, require_emulated
from repro_torch.switch import dataplane

#: Quantization block of the int8 transport (folded into the arena pad).
QUANT_BLOCK = 256


@dataclasses.dataclass(frozen=True)
class Transport:
    """Reduces one dtype's ``(*mesh, B, S)`` arena in a single schedule.

    ``__call__(buf, ef, staggers, extents)``:
      * ``buf`` — the arena buffer, rank axes in front;
      * ``ef`` — error-feedback residuals of the same shape (or None);
      * ``staggers`` — per-bucket ring-phase offsets (§5), shape ``(B,)``;
      * ``extents`` — per-bucket unpadded element counts.

    Returns ``(reduced, ef_out)`` with ``ef_out`` None for lossless
    transports.
    """

    mesh: RankMesh
    axes: tuple[str, ...]
    mean: bool = False
    batched: bool = True    # False → the per-bucket ancestor (the oracle)
    #: flat vs hierarchical wire schedule; None → the reduction tree decides
    hierarchical: bool | None = None
    #: ``obs.Telemetry`` flight recorder, never part of equality.  The
    #: switch transport records its static counters and phase spans into
    #: it; the wire transports carry it for callers but add nothing.
    telemetry: Any = dataclasses.field(default=None, compare=False,
                                       repr=False)

    def _use_hierarchy(self) -> bool:
        """Flat vs hierarchical, with the mesh's reduction tree as arbiter."""
        if len(self.axes) < 2:
            return False
        if self.hierarchical is not None:
            return self.hierarchical
        sizes = tuple(self.mesh.axis_size(a) for a in self.axes)
        tree = topology.build_mesh_tree(sizes)
        return topology.transport_schedule(tree) == "hierarchical"

    def __call__(self, buf: torch.Tensor, ef: torch.Tensor | None,
                 staggers: torch.Tensor, extents: Sequence[int],
                 ) -> tuple[torch.Tensor, torch.Tensor | None]:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class DenseTransport(Transport):
    """Lossless wire allreduce of the arena."""

    algorithm: str = "auto"
    reproducible: bool = False

    def _resolve(self, buf: torch.Tensor) -> str:
        alg = self.algorithm
        if alg == "auto":
            if self._use_hierarchy():
                return "hierarchical"
            nbytes = buf.shape[-1] * buf.element_size()
            alg = coll.select_algorithm(nbytes, reproducible=self.reproducible,
                                        multi_level=len(self.axes) > 1)
        return alg

    def __call__(self, buf, ef, staggers, extents):
        alg = self._resolve(buf)

        def one(v, s):
            return coll.allreduce(v, self.mesh, self.axes, algorithm=alg,
                                  reproducible=self.reproducible, stagger=s)
        if self.batched:
            # all B buckets in one schedule: every collective round
            # carries the whole arena, each bucket at its own stagger
            red = one(buf, staggers)
        else:
            nd = self.mesh.ndim
            red = torch.empty_like(buf)
            for b in range(buf.shape[nd]):
                red.select(nd, b).copy_(one(buf.select(nd, b), staggers[b]))
        if self.mean:
            red = self.mesh.mean(red, self.axes)
        return red, (torch.zeros_like(ef) if ef is not None else None)


def _error_feedback(t: Transport, buf: torch.Tensor,
                    ef: torch.Tensor | None, transmit, residual_
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """A lossy transport's reduction under error feedback: ``transmit(v,
    b)`` reduces the whole arena (``b`` None) or, per bucket (``batched=
    False``, the oracle), bucket ``b``; ``residual_`` forms the new state
    (``compression.error_feedback_step``).  Applies ``mean``."""
    if t.batched:
        red, res = compression.error_feedback_step(
            buf, ef, lambda v: transmit(v, None), residual_)
    else:
        nd = t.mesh.ndim
        red, res = torch.empty_like(buf), torch.empty_like(buf)
        for b in range(buf.shape[nd]):
            r, e = compression.error_feedback_step(
                buf.select(nd, b), None if ef is None else ef.select(nd, b),
                lambda v: transmit(v, b), residual_)
            red.select(nd, b).copy_(r)
            res.select(nd, b).copy_(e)
    if t.mean:
        red = t.mesh.mean(red, t.axes)
    return red, res


@dataclasses.dataclass(frozen=True)
class Int8Transport(Transport):
    """F1 int8 transport on the wire: the quantized exchange under error
    feedback.  On a multi-axis mesh the hierarchical protocol (intra-pod
    reduce-scatter, quantized allreduce of the owned chunk across each
    upper level) or, flat, the protocol over the inner axis and then over
    each outer axis in turn."""

    block: int = QUANT_BLOCK

    def _allreduce(self, v: torch.Tensor) -> torch.Tensor:
        *outer_axes, inner = self.axes
        if self._use_hierarchy() and outer_axes:
            # upper tree levels leaf-first: outer axes innermost-first
            return compression.quantized_allreduce_hier(
                v, self.mesh, inner, tuple(reversed(outer_axes)),
                block=self.block)
        red = compression.quantized_allreduce(v, self.mesh, inner,
                                              block=self.block)
        for ax in outer_axes:
            red = compression.quantized_allreduce(red, self.mesh, ax,
                                                  block=self.block)
        return red

    def __call__(self, buf, ef, staggers, extents):
        return _error_feedback(
            self, buf, ef, lambda v, b: (self._allreduce(v), None),
            lambda v, sent: compression.roundtrip_residual_(v, self.block))


@dataclasses.dataclass(frozen=True)
class SparseTransport(Transport):
    """§7 top-k sparse transport on the wire, densify-on-overflow, under
    error feedback.  Bucket ``b`` keeps ``sparse_k(k_frac, extents[b])``
    entries of its unpadded extent.  The recursive doubling needs a
    power-of-two inner axis; the hierarchical schedule needs power-of-two
    outer axes as well, and in auto mode a mesh without them stays on
    ``two_level`` (dense across pods)."""

    k_frac: float = 0.01
    density_threshold: float = 0.25

    def _hier(self) -> bool:
        *outer_axes, inner = self.axes
        p = self.mesh.axis_size(inner)
        if p & (p - 1):
            raise ValueError(
                f"sparse transport requires a power-of-two inner axis; "
                f"mesh axis {inner!r} has size {p}")
        if not (self._use_hierarchy() and outer_axes):
            return False
        bad = [a for a in outer_axes
               if self.mesh.axis_size(a) & (self.mesh.axis_size(a) - 1)]
        if bad and self.hierarchical:
            raise ValueError(
                f"hierarchical sparse transport requires power-of-two "
                f"outer axes; mesh axes {bad!r} are not")
        return not bad

    def __call__(self, buf, ef, staggers, extents):
        *outer_axes, inner = self.axes
        hier = self._hier()
        ks = tuple(sparse.sparse_k(self.k_frac, e) for e in extents)
        k_all = torch.tensor(ks, dtype=torch.int32, device=buf.device)
        kw = dict(density_threshold=self.density_threshold)

        def transmit(v, b):
            k_eff = k_all if b is None else ks[b]
            if hier:
                # lists stay sparse across the inter-pod hop
                return sparse.sparse_allreduce_hier(
                    v, self.mesh, inner, tuple(reversed(outer_axes)),
                    max(ks), k_eff=k_eff, **kw)
            if outer_axes:
                return sparse.sparse_allreduce_two_level(
                    v, self.mesh, inner, outer_axes[-1], max(ks),
                    k_eff=k_eff, **kw)
            return sparse.sparse_allreduce(v, self.mesh, inner, max(ks),
                                           k_eff=k_eff, **kw)
        return _error_feedback(self, buf, ef, transmit,
                               lambda v, sent: sparse.residual_(v, *sent))


@dataclasses.dataclass(frozen=True)
class SwitchTransport(Transport):
    """The emulated sPIN switch data plane as a transport.

    ``mode`` picks the handler family: ``"dense"`` (``reproducible`` pins
    the fixed-tree handler, always tree aggregation, §6.4), ``"int8"``
    (F1: int8 packets with a scales sideband) or ``"sparse"`` (§7: each
    bucket's top-``k`` coordinate list, ``k`` = ``sparse.sparse_k(k_frac,
    extent)`` of its unpadded extent, merged until ``density_threshold``
    and then densified), the last two under error feedback.  Otherwise
    the §6.4 size switchover picks the buffer design.  ``batched``
    picks the batched plane or, with False, the per-packet one.

    In the int8 and sparse modes ``buf`` is consumed: the error-feedback
    sum and then the new residual are formed in its storage
    (``compression.error_feedback_step``), so callers pass an arena of
    their own.

    ``design`` is the §6.1-§6.3 buffer design of the dense and int8
    planes, ``"auto"`` the §6.4 size switchover.

    ``manager`` (``runtime.SessionManager``, never part of equality)
    attaches the transport as tenant ``tenant`` of a shared switch: each
    call attaches its session (admission control: an
    ``runtime.AdmissionError`` propagates to the caller, the host-fallback
    signal) and runs the planes under the manager's arrival permutations
    for the tenant (``None`` alone on an idle switch).  ``None`` is the
    single-job plane.

    ``telemetry`` records, in a solo transport, the static counters of
    this call's wire image (``_record_solo``; under a manager the
    session's admission records them), and in every plane the phase
    spans under ``tenant``.

    ``fault_plan`` (``switch.packets.FaultPlan``) replays a deterministic
    lossy fabric: a surviving plan runs in the network, bitwise the
    fault-free run; a plan the retry budget cannot recover is detected
    statically before the reduction (``dataplane.plan_survives``), the
    session drains from a shared manager and the arena goes to the
    matching wire transport (``_degrade``).
    """

    mode: str = "dense"             # dense | int8 | sparse
    reproducible: bool = False
    design: str = "auto"            # §6.1-§6.3 buffer design, auto = §6.4
    block: int = QUANT_BLOCK
    k_frac: float = 0.0
    density_threshold: float = 0.25
    manager: Any = dataclasses.field(default=None, compare=False)
    tenant: str | None = None
    fault_plan: Any = None

    def __post_init__(self):
        """On a ``ProcessMesh`` a fault plan (which may degrade to the
        wire) and a shared switch raise here; the planes raise for the
        per-packet plane."""
        if self.fault_plan is not None:
            require_emulated(self.mesh, "the lossy fabric (fault_plan)", 21)
        if self.manager is not None:
            require_emulated(self.mesh, "a shared switch (manager=)", 22)

    def _ks(self, extents: Sequence[int]) -> tuple[int, ...] | None:
        """Each bucket's top-k of its unpadded extent (sparse mode)."""
        if self.mode != "sparse":
            return None
        return tuple(sparse.sparse_k(self.k_frac, e) for e in extents)

    def _plan_survives(self, num_buckets: int, bucket_elems: int,
                       dtype: torch.dtype, ks) -> bool:
        """Static retry-budget pre-check on this arena's level shapes."""
        fanins = [l.fanin for l in dataplane._levels(self.mesh, self.axes)]
        counts = dataplane.level_packet_counts(
            fanins, int(num_buckets), int(bucket_elems), dtype,
            mode=self.mode, block=self.block,
            k_max=max(ks) if ks else None,
            density_threshold=self.density_threshold)
        return dataplane.plan_survives(self.fault_plan, counts)

    def _session_perms(self, num_buckets: int, bucket_elems: int,
                       dtype: torch.dtype, ks):
        """Attach to the shared switch; returns this tenant's per-level
        arrival permutations (``None`` alone on an idle switch or without
        a manager).  The sparse session's lists hold ``max(ks)``."""
        if self.manager is None:
            return None
        sess = self.manager.attach(
            self.tenant, mode=self.mode, num_buckets=num_buckets,
            bucket_elems=bucket_elems, dtype=dtype,
            reproducible=self.reproducible, design=self.design,
            k=max(ks) if ks else None, axes=self.axes,
            fault_plan=self.fault_plan)
        return self.manager.arrival_perms(sess.tenant)

    def attach(self, num_buckets: int, bucket_elems: int,
               dtype: torch.dtype, extents: Sequence[int]):
        """Attach what a call on a ``(B, S)`` arena of ``dtype`` attaches,
        without reducing: the tenant's session, unless a doomed fault plan
        sends the arena to the wire.  With telemetry it records what the
        plane records (``dataplane.record_trace``), as the reference's
        registration trace does.  Returns the arrival permutations."""
        ks = self._ks(extents)
        if (self.fault_plan is not None and not self._plan_survives(
                num_buckets, bucket_elems, dtype, ks)):
            return None
        perms = self._session_perms(num_buckets, bucket_elems, dtype, ks)
        dataplane.record_trace(
            self.mode, self.mesh, self.axes, num_buckets, bucket_elems,
            dtype, telemetry=self.telemetry, tenant=self.tenant,
            block=self.block, ks=ks,
            density_threshold=self.density_threshold,
            fault_plan=self.fault_plan)
        return perms

    def _record_solo(self, num_buckets: int, bucket_elems: int,
                     dtype: torch.dtype, ks) -> None:
        """Solo (manager-less) flight recording: register the static
        wire and reliability counters of this call.  Under a manager the
        session's admission records the same sums once, so the two paths
        never double-count."""
        if self.telemetry is None or self.manager is not None:
            return
        tenant = self.tenant or "solo"
        b, s = int(num_buckets), int(bucket_elems)
        if self.mode == "dense":
            wire_dtype, elems = dtype, s
        elif self.mode == "int8":
            wire_dtype, elems = torch.int8, s + (-s) % self.block
        else:
            wire_dtype, elems = torch.int32, 2 * max(ks)
        sizes = tuple(self.mesh.axis_size(a) for a in self.axes)
        self.telemetry.record_switch_counters(
            tenant, dataplane.plan_counters(
                self.axes, sizes, b, elems, wire_dtype,
                design=self.design, reproducible=self.reproducible))
        if self.fault_plan is not None:
            fanins = [l.fanin for l in dataplane._levels(self.mesh,
                                                         self.axes)]
            counts = dataplane.level_packet_counts(
                fanins, b, s, dtype, mode=self.mode, block=self.block,
                k_max=max(ks) if ks else None,
                density_threshold=self.density_threshold)
            self.telemetry.record_fault_schedules(
                tenant, dataplane.fault_schedules(self.fault_plan, counts))

    def _degrade(self) -> Transport:
        """Retry budget exhausted: drain this session from the shared
        runtime (``ft.recover_session_failure``) and hand the arena to the
        matching wire transport.  Only this session degrades: other
        tenants keep the switch."""
        from repro_torch.ft import coordinator as ft

        if self.manager is not None:
            ft.recover_session_failure(self.manager, self.tenant)
        if self.mode == "sparse":
            return SparseTransport(self.mesh, self.axes, mean=self.mean,
                                   batched=True, k_frac=self.k_frac,
                                   density_threshold=self.density_threshold)
        if self.mode == "int8":
            return Int8Transport(self.mesh, self.axes, mean=self.mean,
                                 batched=True, block=self.block)
        return DenseTransport(self.mesh, self.axes, mean=self.mean,
                              batched=True, reproducible=self.reproducible)

    def __call__(self, buf, ef, staggers, extents):
        b, s = buf.shape[-2:]
        ks = self._ks(extents)
        if (self.fault_plan is not None
                and not self._plan_survives(b, s, buf.dtype, ks)):
            return self._degrade()(buf, ef, staggers, extents)
        self._record_solo(b, s, buf.dtype, ks)
        perms = self._session_perms(b, s, buf.dtype, ks)
        plane = dict(fault_plan=self.fault_plan, batched=self.batched,
                     arrival_perms=perms, telemetry=self.telemetry,
                     tenant=self.tenant)
        if self.mode == "dense":
            red = dataplane.switch_allreduce_dense(
                buf, self.mesh, self.axes, reproducible=self.reproducible,
                design=self.design, **plane)
            if self.mean:
                red = self.mesh.mean(red, self.axes)
            return red, (torch.zeros_like(ef) if ef is not None else None)
        if self.mode == "int8":
            def transmit(v):
                return dataplane.switch_allreduce_int8(
                    v, self.mesh, self.axes, block=self.block,
                    design=self.design, **plane), None

            def residual_(v, sent):
                return compression.roundtrip_residual_(v, self.block)
        elif self.mode == "sparse":
            def transmit(v):
                return dataplane.switch_allreduce_sparse(
                    v, self.mesh, self.axes, ks,
                    density_threshold=self.density_threshold, **plane)

            def residual_(v, sent):
                return sparse.residual_(v, *sent)
        else:
            raise ValueError(f"unknown switch transport mode {self.mode!r}")
        red, ef_out = compression.error_feedback_step(buf, ef, transmit,
                                                      residual_)
        if self.mean:
            red = self.mesh.mean(red, self.axes)
        return red, ef_out


def _switch_from_config(config, mesh: RankMesh, is_float: bool, *,
                        batched: bool = True, manager=None,
                        tenant: str | None = None,
                        telemetry=None) -> SwitchTransport:
    kw = dict(mean=config.mean, batched=batched, manager=manager,
              tenant=tenant, fault_plan=getattr(config, "fault_plan", None),
              telemetry=telemetry)
    axes = tuple(config.axes)
    if config.sparse_k_frac > 0 and is_float:
        return SwitchTransport(mesh, axes, mode="sparse",
                               k_frac=config.sparse_k_frac,
                               density_threshold=config.density_threshold,
                               **kw)
    if config.compression == "int8" and is_float:
        return SwitchTransport(mesh, axes, mode="int8", **kw)
    return SwitchTransport(mesh, axes, mode="dense",
                           reproducible=config.reproducible, **kw)


def from_config(config, mesh: RankMesh, dtype: torch.dtype, *,
                batched: bool = True, manager=None,
                tenant: str | None = None) -> Transport:
    """The transport dispatch, in one place.

    ``config`` is any object with the ``FlareConfig`` transport fields.
    Lossy transports apply to floating dtypes only; everything else rides
    the dense path.  ``transport="innetwork"`` swaps the wire schedule
    for the emulated switch data plane; a shared ``manager``
    (``runtime.SessionManager``) attaches it as tenant ``tenant`` of the
    multi-tenant switch runtime.  ``batched=False`` gives the per-bucket
    oracle of the same transport.  The transport carries the config's
    ``telemetry``.
    """
    axes = tuple(config.axes)
    is_float = dtype.is_floating_point
    telemetry = getattr(config, "telemetry", None)
    if config.transport == "innetwork":
        return _switch_from_config(config, mesh, is_float, batched=batched,
                                   manager=manager, tenant=tenant,
                                   telemetry=telemetry)
    if manager is not None:
        raise ValueError(
            "a runtime.SessionManager applies to transport='innetwork' "
            f"only; config has "
            f"transport={getattr(config, 'transport', 'auto')!r}")
    if config.sparse_k_frac > 0 and is_float:
        return SparseTransport(mesh, axes, mean=config.mean, batched=batched,
                               hierarchical=config.hierarchical,
                               telemetry=telemetry,
                               k_frac=config.sparse_k_frac,
                               density_threshold=config.density_threshold)
    if config.compression == "int8" and is_float:
        return Int8Transport(mesh, axes, mean=config.mean, batched=batched,
                             hierarchical=config.hierarchical,
                             telemetry=telemetry)
    return DenseTransport(mesh, axes, mean=config.mean, batched=batched,
                          hierarchical=config.hierarchical,
                          telemetry=telemetry,
                          algorithm=config.algorithm,
                          reproducible=config.reproducible)
