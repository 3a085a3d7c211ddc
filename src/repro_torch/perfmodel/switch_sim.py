"""Discrete-event simulator of the Flare PsPIN switch (paper §6.4, §7.1).

The port's own copy of ``repro/perfmodel/switch_sim.py``: plain Python and
numpy, the same ``SimResult`` for the same arguments.

Reproduces the paper's cycle-level experiments (Figures 11 and 14) at the
fidelity the models need: clusters × HPU cores, hierarchical FCFS
scheduling (same block → same cluster, §5), per-buffer critical sections
for the three aggregation designs, staggered sending on the host side,
exponentially-distributed packet arrivals ("to simulate delays in the
hosts ... we generate packets with a random and exponentially distributed
arrival rate"), and dense + sparse handlers with hash/array storage.

The paper simulates 4 clusters and scales linearly (clusters are
shared-nothing); we simulate all clusters directly — same assumption,
fewer extrapolations.
"""
from __future__ import annotations

import dataclasses
import heapq
import math

import numpy as np

from repro_torch.perfmodel import switch_model as sm


@dataclasses.dataclass
class SimResult:
    design: str
    data_bytes: int
    sim_cycles: float
    bandwidth_tbps: float
    max_input_buffer_bytes: int
    max_working_memory_bytes: int
    extra_traffic_bytes: int = 0      # sparse spill traffic (§7)
    blocks_completed: int = 0


def _tree_combines(arrival_index: int) -> int:
    """Binary-counter model of §6.3: combines ready when packet i arrives."""
    c = arrival_index - 1              # counter value before this insert
    n = 0
    while c & 1:
        n += 1
        c >>= 1
    return n


def _max_overlap(intervals: list[tuple[float, float, float]]) -> float:
    """Max total weight of overlapping (start, end, weight) intervals."""
    ev: list[tuple[float, float]] = []
    for s, e, w in intervals:
        ev.append((s, w))
        ev.append((e, -w))
    ev.sort()
    cur = best = 0.0
    for _, dw in ev:
        cur += dw
        best = max(best, cur)
    return best


def simulate(design: str,
             data_bytes: int,
             params: sm.SwitchParams = sm.SwitchParams(),
             *,
             B: int = 1,
             S: int | None = None,
             P: int | None = None,
             staggered: bool = True,
             cold_start_cycles: float = 2000.0,
             cycles_per_byte: float | None = None,
             sparse_density: float | None = None,
             sparse_storage: str = "hash",
             seed: int = 0) -> SimResult:
    """Simulate one allreduce of ``data_bytes`` through the switch.

    ``design`` ∈ {single, multi, tree}.  ``sparse_density`` switches the
    handlers to the §7 sparse path (elements are (idx, val) pairs and the
    handler cost follows ``switch_model.tau_sparse``).
    """
    rng = np.random.default_rng(seed)
    C = params.cores_per_cluster
    n_clusters = params.clusters
    S = C if S is None else S
    P = params.ports if P is None else P

    sparse = sparse_density is not None
    if sparse:
        L = sm.tau_sparse(sparse_storage, params, sparse_density, P)
        payload = params.packet_bytes // 2      # half of each packet is idx
    else:
        cpb = params.cycles_per_byte if cycles_per_byte is None \
            else cycles_per_byte
        L = params.packet_bytes * cpb
        payload = params.packet_bytes

    nblocks = max(1, data_bytes // payload)
    host_rate = params.port_gbps / 8.0          # bytes/cycle @ 1 GHz
    mean_gap = params.packet_bytes / host_rate

    # --- host send schedules (staggered sending, §5) ----------------------
    events: list[tuple[float, int, int, int]] = []  # (t, seq, host, block)
    seq = 0
    for h in range(P):
        t = 0.0
        off = (h * nblocks) // P if staggered else 0
        for i in range(nblocks):
            b = (i + off) % nblocks
            t += rng.exponential(mean_gap)
            events.append((t, seq, h, b))
            seq += 1
    heapq.heapify(events)

    # --- switch state ------------------------------------------------------
    core_free = np.zeros((n_clusters, C))
    core_cold = np.ones((n_clusters, C), dtype=bool)
    buf_busy: dict[tuple[int, int], float] = {}
    blk_count = np.zeros(nblocks, dtype=np.int64)
    blk_first = np.full(nblocks, -1.0)
    pkt_intervals: list[tuple[float, float, float]] = []
    blk_intervals: list[tuple[float, float, float]] = []
    finish = 0.0
    extra_traffic = 0
    done_blocks = 0

    # sparse spill model (§7): hash storage spills colliding elements
    # (expectation formula shared with the functional emulator's
    # cross-check — see switch_model.expected_hash_spill_bytes).
    if sparse and sparse_storage == "hash":
        elems = payload // params.elem_bytes
        span = elems / max(sparse_density, 1e-9)
        spill_per_block = sm.expected_hash_spill_bytes(P * elems, span,
                                                      params.elem_bytes)
    else:
        spill_per_block = 0.0

    M = sm.buffers_per_block(design, P, B) if not sparse else \
        sm.buffers_per_block(design, P, B)

    while events:
        t, _, h, b = heapq.heappop(events)
        if blk_first[b] < 0:
            blk_first[b] = t

        # hierarchical FCFS: block → cluster, then earliest-free core in the
        # S-core subset assigned to this block.
        cl = b % n_clusters
        if S >= C:
            cores = np.arange(C)
        else:
            base = (b // n_clusters) % (C // S) * S
            cores = np.arange(base, base + S)
        ci = cores[np.argmin(core_free[cl, cores])]
        start = max(t, core_free[cl, ci])
        if core_cold[cl, ci]:
            start += cold_start_cycles
            core_cold[cl, ci] = False

        blk_count[b] += 1
        arrival_i = int(blk_count[b])

        if design == "single":
            key = (b, 0)
            acquire = max(start, buf_busy.get(key, 0.0))
            done = acquire + L
            buf_busy[key] = done
        elif design == "multi":
            cand = [(buf_busy.get((b, j), 0.0), j) for j in range(B)]
            busy, j = min(cand)
            acquire = max(start, busy)
            done = acquire + L
            if arrival_i == P:
                done += (B - 1) * L          # final merge of B−1 partials
            buf_busy[(b, j)] = done
        elif design == "tree":
            combines = _tree_combines(arrival_i)
            if arrival_i == P and P & (P - 1) == 0:
                combines = int(math.log2(P))  # closing packet finishes tree
            done = start + params.dma_cycles + combines * L
        else:
            raise ValueError(design)

        core_free[cl, ci] = done
        pkt_intervals.append((t, done, 1.0))
        finish = max(finish, done)

        if arrival_i == P:
            done_blocks += 1
            extra_traffic += int(spill_per_block)
            blk_intervals.append((blk_first[b], done, M))

    total_bytes = data_bytes * P
    bw = total_bytes * 8 / max(finish, 1.0)   # bits/cycle = Gb/s @ 1 GHz
    return SimResult(
        design=design,
        data_bytes=data_bytes,
        sim_cycles=finish,
        bandwidth_tbps=bw / 1e3,
        max_input_buffer_bytes=int(_max_overlap(pkt_intervals)
                                   * params.packet_bytes),
        max_working_memory_bytes=int(_max_overlap(blk_intervals) * payload),
        extra_traffic_bytes=extra_traffic,
        blocks_completed=done_blocks,
    )


#: Reference bandwidths the paper compares against (Fig. 11).
SWITCHML_TBPS = 1.6
SHARP_TBPS = 3.2

#: dtype → cycles/byte on the HPUs (§6.4: vectorized sub-word aggregation;
#: fp32 measured at 4 cycles / 4 B element).
CYCLES_PER_BYTE = {
    "int32": 1.0,
    "int16": 0.5,     # two int16 per cycle (paper example)
    "int8": 0.25,
    "fp32": 1.0,
    "fp16": 0.5,
}


def bandwidth_vs_size(design: str, sizes_bytes: list[int],
                      params: sm.SwitchParams = sm.SwitchParams(),
                      B: int = 1, dtype: str = "int32",
                      seed: int = 0) -> list[SimResult]:
    """Fig. 11 sweep: simulated switch bandwidth for one design."""
    return [simulate(design, z, params, B=B,
                     cycles_per_byte=CYCLES_PER_BYTE[dtype], seed=seed)
            for z in sizes_bytes]
