"""What one eager step computes, moves and holds: the counterpart of
``repro/launch/hlo_analysis.py``.

The JAX package reads its roofline inputs from the compiled,
SPMD-partitioned HLO text.  The port has no HLO: it counts an eager step
as it runs, usually on ``meta`` tensors (shapes without storage), so a
production layout of 256 or 512 ranks is counted without memory:

  * **FLOPs** — ``torch.utils.flop_counter.FlopCounterMode``: the
    matmul-class operations (mm, bmm, einsum's products, attention), as
    the reference counts ``dot`` ops; a kernel's ``meta`` branch adds its
    own (``kernel``);
  * **bytes written** — a ``TorchDispatchMode`` adds each op's output
    bytes.  Views and metadata ops write nothing, nor does an
    allocation (``empty``); an in-place op writes its output, so a write
    into a slice counts the slice (the reference's dynamic-update-slice
    rule).  ``bytes_accessed`` is twice that, as the reference defines it;
  * **peak** — the same mode follows every storage an op creates until
    it is freed, and keeps the largest sum of live bytes beside the
    arguments' (which the caller holds throughout);
  * **collectives** — counted where the port performs them
    (``RankMesh.all_gather``, ``psum``, ``ppermute`` and ``all_to_all``,
    ``core.tp``'s sums, maxima and gathers), forward and autograd
    backward alike, with the reference's formulas per kind and ``n`` the
    size of the group.  Eager code runs one op at a time, so there are
    no loop trip counts to recover.

Every figure is the whole emulated program's: all ranks' work at once.
``StepStats.per_rank(world)`` divides it by the world size, which gives
the reference's per-device figures.  The roofline constants are the
H100 SXM's data-sheet figures at 700 W.
"""
from __future__ import annotations

import dataclasses
import math
import weakref
from typing import Any, Callable

import torch

#: H100 SXM dense bf16 tensor-core rate (NVIDIA data sheet), FLOP/s
PEAK_FLOPS_BF16 = 989e12
#: H100 SXM HBM3 bandwidth (NVIDIA data sheet), bytes/s
HBM_BW = 3.35e12
#: H100 SXM NVLink 4 bandwidth, one direction (NVIDIA data sheet:
#: 900 GB/s both ways), bytes/s
LINK_BW = 450e9

_DTYPE_NAMES = {torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8",
                torch.int16: "s16", torch.float16: "f16",
                torch.bfloat16: "bf16", torch.int32: "s32",
                torch.float32: "f32", torch.int64: "s64",
                torch.float64: "f64"}

#: allocations: their outputs hold nothing written yet
_ALLOCS = frozenset({"empty", "empty_strided", "new_empty",
                     "new_empty_strided", "empty_like"})

#: the StepStats that collectives and kernels report to (innermost last)
_ACTIVE: list = []


@dataclasses.dataclass
class StepStats:
    """``HloStats``' fields for an eager step, plus its memory."""

    flops: float = 0.0
    bytes_written: float = 0.0
    counts: dict = dataclasses.field(default_factory=dict)
    operand_bytes: dict = dataclasses.field(default_factory=dict)
    wire_bytes: dict = dataclasses.field(default_factory=dict)
    bytes_by_shape: dict = dataclasses.field(default_factory=dict)
    #: per kernel: launches, flops, bytes moved (its ``meta`` branch)
    kernels: dict = dataclasses.field(default_factory=dict)
    argument_bytes: float = 0.0
    output_bytes: float = 0.0
    #: the largest sum of live storage bytes, the arguments' included
    peak_bytes: float = 0.0

    @property
    def total_wire_bytes(self) -> float:
        return sum(self.wire_bytes.values())

    @property
    def total_operand_bytes(self) -> float:
        return sum(self.operand_bytes.values())

    @property
    def bytes_accessed(self) -> float:
        return 2.0 * self.bytes_written

    def per_rank(self, world: int) -> "StepStats":
        """Every figure divided by ``world``: one rank's share of the
        whole emulated program (collective counts too, so that a sum
        every rank takes part in counts once)."""
        div = lambda d: {k: v / world for k, v in d.items()}   # noqa: E731
        return StepStats(
            self.flops / world, self.bytes_written / world,
            div(self.counts), div(self.operand_bytes), div(self.wire_bytes),
            div(self.bytes_by_shape),
            {k: {f: v / world if f != "launches" else v
                 for f, v in d.items()} for k, d in self.kernels.items()},
            self.argument_bytes / world, self.output_bytes / world,
            self.peak_bytes / world)

    def as_dict(self) -> dict:
        return {"flops": self.flops, "bytes_written": self.bytes_written,
                "bytes_accessed": self.bytes_accessed,
                "counts": dict(self.counts),
                "operand_bytes": dict(self.operand_bytes),
                "wire_bytes": dict(self.wire_bytes),
                "total_operand_bytes": self.total_operand_bytes,
                "total_wire_bytes": self.total_wire_bytes,
                "bytes_by_shape": dict(self.bytes_by_shape),
                "kernels": {k: dict(v) for k, v in self.kernels.items()}}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _shape_key(t: torch.Tensor) -> str:
    name = _DTYPE_NAMES.get(t.dtype, str(t.dtype).removeprefix("torch."))
    return f"{name}{list(t.shape)}"


def _written(stats: StepStats, t: torch.Tensor) -> None:
    n = _nbytes(t)
    stats.bytes_written += n
    key = _shape_key(t)
    stats.bytes_by_shape[key] = stats.bytes_by_shape.get(key, 0.0) + n


def collective(kind: str, result: torch.Tensor, n: int,
               ranks: int) -> None:
    """Count one collective that ``ranks`` ranks take part in, in groups
    of ``n``, whose result over all of them is ``result`` (a stride-0
    view counts every rank's copy): the reference's operand and wire
    formulas (``hlo_analysis.py``) on the whole program's result bytes.
    A no-op outside :func:`analyze`."""
    if not _ACTIVE:
        return
    st = _ACTIVE[-1]
    rb = float(_nbytes(result))
    n = max(int(n), 1)
    if kind == "all-gather":
        operand, wire = rb / n, rb * (n - 1) / n
    elif kind == "all-reduce":
        operand, wire = rb, 2.0 * rb * (n - 1) / n
    elif kind == "all-to-all":
        operand, wire = rb, rb * (n - 1) / n
    elif kind == "collective-permute":
        operand, wire = rb, rb
    else:
        raise ValueError(f"unknown collective {kind!r}")
    st.counts[kind] = st.counts.get(kind, 0) + ranks
    st.operand_bytes[kind] = st.operand_bytes.get(kind, 0.0) + operand
    st.wire_bytes[kind] = st.wire_bytes.get(kind, 0.0) + wire


def kernel(name: str, flops: float, moved: float,
           outputs: tuple = ()) -> None:
    """Count one launch of a hand-written kernel, traced by its wrapper's
    ``meta`` branch (a ``ctypes`` launch is invisible to dispatch modes):
    its operations, the bytes it must move, and its ``outputs`` as bytes
    written.  A no-op outside :func:`analyze`."""
    if not _ACTIVE:
        return
    st = _ACTIVE[-1]
    st.flops += flops
    for t in outputs:
        _written(st, t)
    k = st.kernels.setdefault(name, {"launches": 0, "flops": 0.0,
                                     "bytes_moved": 0.0})
    k["launches"] += 1
    k["flops"] += flops
    k["bytes_moved"] += moved


def _tensors(x: Any) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _storages(ts) -> dict:
    """Unique storages of ``ts``: id → bytes."""
    return {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
            for t in ts}


class _Counter:
    """The dispatch mode of one :func:`analyze`: bytes written and the
    live storage bytes (``live``: now and the peak, beyond ``held``)."""

    def __init__(self, stats: StepStats, held: dict):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import FlopCounterMode

        self.stats, self.held = stats, held
        self.live = [0, 0]
        self.tracked: set = set()
        self.flops = FlopCounterMode(display=False)
        counter = self

        class Counting(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                counter.saw(func, (args, kwargs), out)
                return out

        self.mode = Counting()

    def _release(self, sid: int, n: int) -> None:
        self.tracked.discard(sid)
        self.live[0] -= n

    def saw(self, func, inputs, out) -> None:
        ins = {t.untyped_storage()._cdata for t in _tensors(inputs)
               if t.layout == torch.strided}
        alloc = func.__name__.split(".")[0] in _ALLOCS
        mutable = func._schema.is_mutable
        for t in _tensors(out):
            if t.layout != torch.strided:
                continue
            st = t.untyped_storage()
            sid = st._cdata
            if sid in ins:
                if mutable:              # in place: the view it writes
                    _written(self.stats, t)
                continue
            if not alloc:
                _written(self.stats, t)
            if sid not in self.tracked and sid not in self.held:
                self.tracked.add(sid)
                n = st.nbytes()
                self.live[0] += n
                self.live[1] = max(self.live[1], self.live[0])
                weakref.finalize(st, self._release, sid, n)


def analyze(fn: Callable, *args, **kwargs) -> tuple[StepStats, Any]:
    """Run ``fn(*args, **kwargs)`` once under the counters; returns its
    :class:`StepStats` (the whole program's) and its result."""
    stats = StepStats()
    held = _storages(_tensors((args, kwargs)))
    stats.argument_bytes = float(sum(held.values()))
    c = _Counter(stats, held)
    _ACTIVE.append(stats)
    try:
        with c.flops, c.mode:
            out = fn(*args, **kwargs)
    finally:
        _ACTIVE.pop()
    stats.flops += c.flops.get_total_flops()
    stats.output_bytes = float(sum(_storages(_tensors(out)).values()))
    stats.peak_bytes = stats.argument_bytes + c.live[1]
    stats.bytes_by_shape = dict(sorted(stats.bytes_by_shape.items(),
                                       key=lambda kv: -kv[1])[:24])
    return stats, out


def roofline_terms(flops: float, hbm_bytes: float, wire_bytes: float,
                   chips: int, *, per_device: bool = True) -> dict:
    """Three roofline terms in seconds on the H100's data-sheet peaks.

    ``per_device=True`` means the inputs are already one device's (as
    ``StepStats.per_rank`` gives them), so the terms divide by a chip's
    peaks only; otherwise they are the whole program's and divide by
    ``chips`` too."""
    div = 1 if per_device else chips
    compute_s = flops / div / PEAK_FLOPS_BF16
    memory_s = hbm_bytes / div / HBM_BW
    collective_s = wire_bytes / div / LINK_BW
    dominant = max((("compute", compute_s), ("memory", memory_s),
                    ("collective", collective_s)), key=lambda kv: kv[1])[0]
    return {"compute_s": compute_s, "memory_s": memory_s,
            "collective_s": collective_s, "dominant": dominant}


def group_ranks(x: torch.Tensor, dim: int) -> int:
    """The ranks a ``core.tp`` collective over ``dim`` spans: the leading
    rank dims up to and including ``model``'s."""
    return math.prod(x.shape[:dim + 1])
