"""Packet framing for the emulated switch data plane (paper §3, §4).

The port of ``repro/switch/packets.py``.  Hosts carve
each ``(B, S)`` dtype arena into MTU-sized packets; every packet carries
the header the handlers key on (block id, sequence number, child rank,
valid element count, last-packet flag, payload checksum).

Framing is bitwise: payloads are padded, reshaped and reassembled
through their integer bit view, so every bit pattern survives, bf16 and
f16 NaN payloads included.  Arenas may carry the mesh's rank axes in
front (``(*mesh, B, S)``); framing maps over them.

The reliability layer rides on two extras here: the payload checksum
(``HDR_CSUM``) makes a corrupted payload detectable at the switch, and
:class:`FaultPlan` / :class:`FaultSchedule` describe a deterministic,
seedable lossy fabric — which packets drop, duplicate, arrive corrupted
or reordered on each delivery round — that the data plane replays.  The
plan and its schedules are numpy on the host, drawn exactly as the JAX
package draws them, so one plan gives the same masks in both.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

#: Header field indices (one int32 each).
HDR_BLOCK = 0       # reduction-block (arena bucket) id
HDR_SEQ = 1         # packet sequence number within the block
HDR_CHILD = 2       # sending child's rank on the reduced axis
HDR_VALID = 3       # valid payload elements (< payload_elems on tails)
HDR_LAST = 4        # 1 on the block's final packet (completion marker)
HDR_CSUM = 5        # payload checksum (wraparound uint32 sum of elements)
HEADER_FIELDS = 6

_INT_OF_SIZE = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def bits(x: torch.Tensor) -> torch.Tensor:
    """The signed-integer view of ``x``'s bits (same element size)."""
    return x.view(_INT_OF_SIZE[x.element_size()])


@dataclasses.dataclass(frozen=True)
class PacketFormat:
    """The wire format: payload MTU in bytes (headers ride separately)."""

    mtu_bytes: int = 1024

    def payload_elems(self, dtype: torch.dtype) -> int:
        """N: elements of ``dtype`` per packet payload."""
        itemsize = dtype.itemsize
        if self.mtu_bytes % itemsize:
            raise ValueError(f"mtu_bytes={self.mtu_bytes} not a multiple of "
                             f"{dtype} itemsize {itemsize}")
        return self.mtu_bytes // itemsize

    def packets_per_block(self, bucket_elems: int, dtype: torch.dtype) -> int:
        """Packets needed to frame one S-element reduction block."""
        return max(1, math.ceil(bucket_elems / self.payload_elems(dtype)))


DEFAULT_FORMAT = PacketFormat()


@dataclasses.dataclass(frozen=True)
class PacketStream:
    """A batch of framed packets: ``headers (..., n, 6)`` int32 and
    ``payload (..., n, E)``."""

    headers: torch.Tensor
    payload: torch.Tensor

    @property
    def num_packets(self) -> int:
        return self.payload.shape[-2]


def _pad_tail(arena: torch.Tensor, pad: int) -> torch.Tensor:
    """Zero-pad the last axis by ``pad`` elements, through the bit view."""
    if not pad:
        return arena
    return F.pad(bits(arena), (0, pad)).view(arena.dtype)


def packetize(arena: torch.Tensor, fmt: PacketFormat,
              child_rank: torch.Tensor | int = 0) -> PacketStream:
    """Frame a ``(..., B, S)`` arena into ``B * ceil(S/N)`` MTU packets.

    The tail packet of each block zero-pads to a whole payload and
    records the true element count in ``HDR_VALID``; ``child_rank`` (an
    int, or a tensor that broadcasts over the leading rank axes) stamps
    every header's ``HDR_CHILD``.
    """
    if arena.dim() < 2:
        raise ValueError(f"packetize wants a (..., B, S) arena, got "
                         f"{tuple(arena.shape)}")
    *lead, b, s = arena.shape
    e = fmt.payload_elems(arena.dtype)
    npkt = fmt.packets_per_block(s, arena.dtype)
    payload = _pad_tail(arena, npkt * e - s).reshape(*lead, b * npkt, e)

    dev = arena.device
    n = b * npkt
    block = torch.arange(b, dtype=torch.int32, device=dev).repeat_interleave(
        npkt)
    seq = torch.arange(npkt, dtype=torch.int32, device=dev).repeat(b)
    valid = torch.clamp(s - seq * e, max=e)
    last = (seq == npkt - 1).to(torch.int32)
    child = torch.as_tensor(child_rank, dtype=torch.int32, device=dev)
    child = child.broadcast_to(tuple(lead)).unsqueeze(-1)
    fields = [block, seq, child, valid, last, payload_checksum(payload)]
    headers = torch.stack([f.expand(*lead, n) for f in fields], dim=-1)
    return PacketStream(headers=headers, payload=payload)


def depacketize(stream: PacketStream, fmt: PacketFormat,
                num_buckets: int, bucket_elems: int) -> torch.Tensor:
    """Reassemble the ``(..., B, S)`` arena from a packet stream, bitwise.

    Packets are placed by their ``(HDR_BLOCK, HDR_SEQ)`` header, never by
    position, so any permutation of the stream reassembles identically.
    """
    dtype = stream.payload.dtype
    e = fmt.payload_elems(dtype)
    npkt = fmt.packets_per_block(bucket_elems, dtype)
    n = num_buckets * npkt
    if stream.num_packets != n:
        raise ValueError(f"stream has {stream.num_packets} packets, plan "
                         f"wants {n} ({num_buckets} blocks x {npkt})")
    hdr = stream.headers
    slot = (hdr[..., HDR_BLOCK] * npkt + hdr[..., HDR_SEQ]).long()
    src = bits(stream.payload)
    flat = torch.zeros_like(src).scatter_(
        -2, slot.unsqueeze(-1).expand(src.shape), src)
    lead = src.shape[:-2]
    return flat.reshape(*lead, num_buckets, npkt * e)[
        ..., :bucket_elems].view(dtype)


@dataclasses.dataclass(frozen=True)
class FramePlan:
    """Static pack/unpack plan for a ``(B, S)`` dtype arena.

    Every slot offset is a function of ``(B, S, dtype, fmt)``, so framing
    is one pad and reshape (``pack``) and reassembly one reshape and
    slice (``unpack``, a view).  Headers are static too (numpy).
    ``pack`` produces exactly ``packetize(...).payload``.
    """

    num_buckets: int
    bucket_elems: int
    dtype: torch.dtype
    fmt: PacketFormat

    @property
    def payload_elems(self) -> int:
        return self.fmt.payload_elems(self.dtype)

    @property
    def packets_per_block(self) -> int:
        return self.fmt.packets_per_block(self.bucket_elems, self.dtype)

    @property
    def num_packets(self) -> int:
        return self.num_buckets * self.packets_per_block

    @property
    def pad(self) -> int:
        return (self.packets_per_block * self.payload_elems
                - self.bucket_elems)

    def pack(self, arena: torch.Tensor) -> torch.Tensor:
        """``(..., B, S)`` arena → ``(..., n, E)`` packed payload tensor."""
        *lead, b, s = arena.shape
        if (b, s) != (self.num_buckets, self.bucket_elems):
            raise ValueError(f"pack: arena {tuple(arena.shape[-2:])} != plan "
                             f"({self.num_buckets}, {self.bucket_elems})")
        return _pad_tail(arena, self.pad).reshape(*lead, self.num_packets,
                                                  self.payload_elems)

    def unpack(self, payload: torch.Tensor) -> torch.Tensor:
        """``(..., n, E)`` canonical-order payload → ``(..., B, S)``."""
        *lead, n, e = payload.shape
        if (n, e) != (self.num_packets, self.payload_elems):
            raise ValueError(f"unpack: payload {tuple(payload.shape[-2:])} "
                             f"!= plan ({self.num_packets}, "
                             f"{self.payload_elems})")
        flat = payload.reshape(*lead, self.num_buckets,
                               self.packets_per_block * e)
        return flat[..., :self.bucket_elems]

    def headers(self, child_rank: int = 0) -> np.ndarray:
        """Static ``(n, HEADER_FIELDS)`` int32 headers in canonical slot
        order; ``HDR_CSUM`` is left 0."""
        npkt = self.packets_per_block
        e = self.payload_elems
        block = np.repeat(np.arange(self.num_buckets, dtype=np.int32), npkt)
        seq = np.tile(np.arange(npkt, dtype=np.int32), self.num_buckets)
        valid = np.minimum(e, self.bucket_elems - seq * e).astype(np.int32)
        last = (seq == npkt - 1).astype(np.int32)
        child = np.full((self.num_packets,), child_rank, np.int32)
        csum = np.zeros((self.num_packets,), np.int32)
        return np.stack([block, seq, child, valid, last, csum], axis=1)

    def child_headers(self, num_children: int) -> np.ndarray:
        """Static ``(P, n, HEADER_FIELDS)`` headers, ``HDR_CHILD`` = the
        child's index in the gathered stack."""
        return np.stack([self.headers(child_rank=p)
                         for p in range(num_children)])


def payload_checksum(payload: torch.Tensor) -> torch.Tensor:
    """Per-packet checksum: wraparound uint32 sum of the payload's
    elements read as unsigned integers, ``(..., E) -> (...)`` int32."""
    width = min(payload.element_size() * 8, 32)
    u = bits(payload).to(torch.int64) & ((1 << width) - 1)
    s = u.sum(dim=-1) & 0xFFFFFFFF
    return torch.where(s >= 1 << 31, s - (1 << 32), s).to(torch.int32)


def corrupt_first_elem(payload: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
    """Flip bits of element 0 of each masked packet (``mask`` broadcasts
    over the leading packet axes of a ``(..., E)`` payload).  The XOR
    pattern 0x5A... is nonzero, so a corrupted packet never equals the
    clean one and its header checksum can never validate; it is positive
    at every width, so the XOR runs on the signed integer view."""
    u = bits(payload)
    pattern = 0x5A5A5A5A5A5A5A5A & ((1 << (8 * u.element_size())) - 1)
    first = u[..., 0]
    out = u.clone()
    out[..., 0] = torch.where(mask, first ^ pattern, first)
    return out.view(payload.dtype)


# ---------------------------------------------------------------------------
# Deterministic fault injection.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Timeout/retransmit knobs, in *modeled rounds* (never wall clock).

    The switch waits ``timeout_rounds`` service rounds for a slot to
    complete, NACKs the missing packets, and backs the wait off
    geometrically (``timeout_rounds * backoff**(retry-1)``) for up to
    ``max_retries`` retransmission rounds before declaring the slot — and
    with it the session — lost."""

    timeout_rounds: int = 4
    max_retries: int = 3
    backoff: float = 2.0

    def wait_rounds(self, retry: int) -> float:
        """Modeled rounds waited before retransmission round ``retry``."""
        return self.timeout_rounds * self.backoff ** max(0, retry - 1)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A deterministic, seedable lossy fabric for the emulated switch.

    Per delivery attempt each packet independently drops with
    probability ``drop`` or arrives bit-corrupted with probability
    ``corrupt``; each retransmission round redelivers already-accepted
    packets with probability ``duplicate`` (exercising the seen-bitmap),
    and with probability ``reorder`` a round's child streams arrive
    interleaved by a random permutation (exercising header steering).
    ``levels`` restricts injection to those tree levels (``None`` = all).

    Hashable and frozen so it can ride inside ``FlareConfig``; all draws
    come from ``np.random.default_rng([seed, level, P, n])`` in the JAX
    package's order, so a plan is a pure function of (plan, level,
    shape) and gives the same schedule in both packages."""

    seed: int = 0
    drop: float = 0.0
    duplicate: float = 0.0
    reorder: float = 0.0
    corrupt: float = 0.0
    levels: tuple[int, ...] | None = None
    retry: RetryPolicy = RetryPolicy()

    def __post_init__(self):
        for f in ("drop", "duplicate", "reorder", "corrupt"):
            v = getattr(self, f)
            if not 0.0 <= v < 1.0:
                raise ValueError(f"FaultPlan.{f}={v} outside [0, 1)")
        if self.levels is not None:
            object.__setattr__(self, "levels",
                               tuple(int(l) for l in self.levels))

    def applies(self, level: int) -> bool:
        return self.levels is None or level in self.levels

    def schedule(self, level: int, num_children: int,
                 num_packets: int) -> "FaultSchedule":
        """Materialize the per-round delivery masks for one level's
        ``(P, n)`` child stack — deterministic in (plan, level, P, n)."""
        p, n = int(num_children), int(num_packets)
        rng = np.random.default_rng([self.seed, level, p, n])
        rounds = 1 + self.retry.max_retries
        arrives = np.zeros((rounds, p, n), bool)
        corrupt = np.zeros((rounds, p, n), bool)
        perms = np.tile(np.arange(p), (rounds, 1))
        accepted = np.zeros((p, n), bool)
        retransmits = duplicates = corrupt_rejected = 0
        used = 1
        for r in range(rounds):
            attempt = ~accepted if r else np.ones((p, n), bool)
            if r and not attempt.any():
                break
            used = r + 1
            dropped = rng.random((p, n)) < self.drop
            corr = rng.random((p, n)) < self.corrupt
            arr = attempt & ~dropped
            arrives[r] = arr
            corrupt[r] = arr & corr
            if r:
                retransmits += int(attempt.sum())
                dup = accepted & (rng.random((p, n)) < self.duplicate)
                arrives[r] |= dup            # redelivered clean copies
                duplicates += int(dup.sum())
            corrupt_rejected += int((arr & corr).sum())
            accepted |= arr & ~corr
            if self.reorder and rng.random() < self.reorder:
                perms[r] = rng.permutation(p)
        return FaultSchedule(
            arrives=arrives[:used], corrupt=corrupt[:used],
            perms=perms[:used], survives=bool(accepted.all()),
            retransmits=retransmits, duplicates=duplicates,
            corrupt_rejected=corrupt_rejected,
            wait_rounds=sum(self.retry.wait_rounds(r)
                            for r in range(1, used)))


@dataclasses.dataclass(frozen=True, eq=False)
class FaultSchedule:
    """One level's replayable fault trace: static numpy masks plus the
    derived counters the perfmodel cross-check keys on.

    ``arrives[r, p, i]`` — child ``p``'s packet ``i`` is delivered on
    round ``r`` (round 0 = first transmission, later rounds =
    NACK-driven retransmissions and duplicate redeliveries);
    ``corrupt[r, p, i]`` — that delivery is bit-corrupted (fails the
    checksum);  ``perms[r]`` — the child interleaving of round ``r``'s
    arrivals.  ``survives`` is statically known because corruption
    deterministically fails the checksum: every clean delivery is
    accepted, everything else is rejected.

    Equality is identity (``eq=False``): numpy masks have no truth
    value, and identity lets the data plane memoise work per schedule.
    """

    arrives: np.ndarray         # (R, P, n) bool
    corrupt: np.ndarray         # (R, P, n) bool
    perms: np.ndarray           # (R, P) int — per-round child interleave
    survives: bool              # all packets accepted within the budget
    retransmits: int            # NACK-driven retransmission attempts
    duplicates: int             # redeliveries of already-accepted packets
    corrupt_rejected: int       # deliveries the checksum must reject
    wait_rounds: float          # modeled backoff rounds spent waiting

    @property
    def rounds(self) -> int:
        return self.arrives.shape[0]
