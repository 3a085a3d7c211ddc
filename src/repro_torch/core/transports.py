"""The transport layer: one reduction schedule per dtype arena.

The port of the dense part of ``repro/core/transports.py``.  A
``Transport`` reduces a whole ``(*mesh, B, S)`` dtype arena — all B
buckets of every rank in one call.  Ported so far:

* ``DenseTransport`` — the wire allreduce: ring (each bucket at its own
  §5 stagger), rhd, fixed_tree, two_level, the tree-driven hierarchical
  schedule and psum;
* ``SwitchTransport`` — the emulated switch data plane: in dense mode
  ``switch.dataplane.switch_allreduce_dense``, which with
  ``reproducible=True`` folds every level in the ``tree_reduce`` kernel;
  in int8 mode ``switch_allreduce_int8`` under error feedback, which
  quantizes with the ``quantize`` kernel and folds every level in the
  ``dequant_accum_slots`` kernel; in sparse mode
  ``switch_allreduce_sparse`` under error feedback, which merges top-k
  coordinate lists and densifies them in the ``sparse_accum_slots``
  kernel.

``batched=False`` keeps the reference's per-bucket ancestor (its
``lax.scan``; the switch's per-packet plane) as the bitwise oracle of the
batched schedule.  The wire int8 and wire sparse branches of
``from_config`` raise ``NotImplementedError`` naming their ROADMAP
items.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch.core import collectives as coll, compression, sparse
from repro_torch.core import topology
from repro_torch.mesh import RankMesh
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

    def _world(self) -> int:
        return self.mesh.world_size(self.axes)

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
            red = red / self._world()
        return red, (torch.zeros_like(ef) if ef is not None else None)


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
    """

    mode: str = "dense"             # dense | int8 | sparse
    reproducible: bool = False
    block: int = QUANT_BLOCK
    k_frac: float = 0.0
    density_threshold: float = 0.25

    def __call__(self, buf, ef, staggers, extents):
        if self.mode == "dense":
            red = dataplane.switch_allreduce_dense(
                buf, self.mesh, self.axes, reproducible=self.reproducible,
                batched=self.batched)
            if self.mean:
                red = red / self._world()
            return red, (torch.zeros_like(ef) if ef is not None else None)
        if self.mode == "int8":
            def transmit(v):
                return dataplane.switch_allreduce_int8(
                    v, self.mesh, self.axes, block=self.block,
                    batched=self.batched), None

            def residual_(v, sent):
                return compression.roundtrip_residual_(v, self.block)
        elif self.mode == "sparse":
            ks = tuple(sparse.sparse_k(self.k_frac, e) for e in extents)

            def transmit(v):
                return dataplane.switch_allreduce_sparse(
                    v, self.mesh, self.axes, ks,
                    density_threshold=self.density_threshold,
                    batched=self.batched)

            def residual_(v, sent):
                return sparse.residual_(v, *sent)
        else:
            raise ValueError(f"unknown switch transport mode {self.mode!r}")
        red, ef_out = compression.error_feedback_step(buf, ef, transmit,
                                                      residual_)
        if self.mean:
            red = red / self._world()
        return red, ef_out


def from_config(config, mesh: RankMesh, dtype: torch.dtype, *,
                batched: bool = True) -> Transport:
    """The transport dispatch, in one place.

    ``config`` is any object with the ``FlareConfig`` transport fields.
    Lossy transports apply to floating dtypes only; everything else rides
    the dense path.  ``transport="innetwork"`` swaps the wire schedule
    for the emulated switch data plane.  ``batched=False`` gives the
    per-bucket oracle of the same transport.
    """
    axes = tuple(config.axes)
    is_float = dtype.is_floating_point
    if config.transport == "innetwork":
        if config.sparse_k_frac > 0 and is_float:
            return SwitchTransport(mesh, axes, mean=config.mean,
                                   batched=batched, mode="sparse",
                                   k_frac=config.sparse_k_frac,
                                   density_threshold=config.density_threshold)
        if config.compression == "int8" and is_float:
            return SwitchTransport(mesh, axes, mean=config.mean,
                                   batched=batched, mode="int8")
        return SwitchTransport(mesh, axes, mean=config.mean, batched=batched,
                               reproducible=config.reproducible)
    if is_float and (config.sparse_k_frac > 0
                     or config.compression == "int8"):
        raise NotImplementedError(
            "the lossy wire transports are not ported yet: ROADMAP queue 1 "
            "items 7 (wire int8) and 8 (wire sparse)")
    return DenseTransport(mesh, axes, mean=config.mean, batched=batched,
                          hierarchical=config.hierarchical,
                          algorithm=config.algorithm,
                          reproducible=config.reproducible)
