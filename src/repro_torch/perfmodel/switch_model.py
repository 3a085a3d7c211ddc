"""Analytic models of the Flare switch (paper §4–§6).

The port's own copy of ``repro/perfmodel/switch_model.py``: plain Python,
equal outputs for equal arguments (``tests/test_torch_perfmodel.py``).
All times are in cycles of the 1 GHz PsPIN clock; sizes in bytes.

Model inputs (Table 2 of the paper):
  K   — number of cores in the switch (clusters × cores_per_cluster)
  C   — cores per cluster
  S   — cores per scheduling subset (hierarchical FCFS, §5)
  P   — packets per reduction block (= children in the reduction tree)
  N   — elements per packet;  L — cycles to aggregate one packet
  δ   — packet interarrival time at the switch (line rate)
  δ_c — interarrival of packets of the *same block* (staggered sending)

Key equations:
  service time    τ  (Eq. 2 and §6.2/§6.3 variants)
  bandwidth       B = min(K/τ, 1/δ)                      [packets/cycle]
  queue           Q = P/S · (1 − δ_k/τ),  δ_k = min(S·δ_c, K·δ)   (Eq. 1)
  block latency   L_blk = (P−1)·δ_c + (Q+1)·τ
  working memory  R = M · (B/P) · L_blk                  [buffers]

Note: the paper prints τ = L(C−1)/2 for the contended single-buffer case
but defines it as (Σ_{i=1..C} i·L)/C, which evaluates to L(C+1)/2; we
implement the definition (the printed closed form is a typo).
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class SwitchParams:
    """The PsPIN unit of §3: 64 clusters × 8 cores @ 1 GHz."""

    clusters: int = 64
    cores_per_cluster: int = 8
    clock_hz: float = 1e9
    packet_bytes: int = 1024
    elem_bytes: int = 4
    cycles_per_byte: float = 1.0    # measured: 4 cycles per fp32 add+store
    dma_cycles: int = 64            # §6.3: DMA copy instead of aggregation
    ports: int = 64
    port_gbps: float = 100.0
    l1_bytes_per_cluster: int = 1 << 20
    l2_packet_bytes: int = 4 << 20

    @property
    def cores(self) -> int:
        return self.clusters * self.cores_per_cluster

    @property
    def packet_cycles(self) -> float:
        """L: cycles to aggregate one packet into a buffer (≈ 1 ns/B)."""
        return self.packet_bytes * self.cycles_per_byte

    @property
    def delta(self) -> float:
        """δ: cycles between packet arrivals at line rate on all ports."""
        line_bytes_per_cycle = (self.ports * self.port_gbps / 8.0)  # GB/s
        return self.packet_bytes / line_bytes_per_cycle  # cycles (1 GHz)


# ---------------------------------------------------------------------------
# Service time τ per aggregation design.
# ---------------------------------------------------------------------------

def tau_single(L: float, C: int, S: int, delta_c: float) -> float:
    """Single-buffer aggregation (§6.1, Eq. 2)."""
    if S == 1 or delta_c >= L:
        return L
    return L * (C + 1) / 2.0


def tau_multi(L: float, C: int, S: int, delta_c: float, B: int,
              P: int) -> float:
    """Multi-buffer aggregation (§6.2): contention ÷ B, final (B−1)·L merge."""
    base = tau_single(L, C, S, B * delta_c)
    merge = (B - 1) * L / P          # once per block, amortized per packet
    return base + merge


def tau_tree(L: float, P: int, dma_cycles: float = 64.0) -> float:
    """Tree aggregation (§6.3): P−1 combines over P packets, copy ≈ free."""
    return (P - 1) * L / P + dma_cycles


def buffers_per_block(design: str, P: int, B: int = 1) -> float:
    """M: aggregation buffers held per block (working-memory multiplier)."""
    if design == "single":
        return 1.0
    if design == "multi":
        return float(B)
    if design == "tree":
        return (P - 1) / max(1.0, math.log2(P))
    raise ValueError(design)


# ---------------------------------------------------------------------------
# Bandwidth, queueing (Eq. 1), latency, working memory.
# ---------------------------------------------------------------------------

def bandwidth_pkts_per_cycle(K: int, tau: float, delta: float) -> float:
    """B = min(K/τ, 1/δ)."""
    return min(K / tau, 1.0 / delta)


def bandwidth_tbps(params: SwitchParams, tau: float) -> float:
    b = bandwidth_pkts_per_cycle(params.cores, tau, params.delta)
    return b * params.packet_bytes * 8 * params.clock_hz / 1e12


def delta_k(S: int, delta_c: float, K: int, delta: float) -> float:
    """Per-core burst interarrival: δ_k = min(S·δ_c, K·δ)."""
    return min(S * delta_c, K * delta)


def queue_len(P: int, S: int, dk: float, tau: float) -> float:
    """Q: max per-core queue length during a burst (§5)."""
    return max(0.0, (P / S) * (1.0 - dk / tau))


def input_buffer_pkts(P: int, K: int, S: int, dk: float, tau: float) -> float:
    """Eq. 1: max packets resident in the switch, Q_total = (Q+1)·K."""
    return (P * K / S) * max(0.0, 1.0 - dk / tau) + K


def block_latency(P: int, delta_c: float, Q: float, tau: float) -> float:
    """L_blk = (P−1)·δ_c + (Q+1)·τ (§5)."""
    return (P - 1) * delta_c + (Q + 1) * tau


def working_memory_buffers(M: float, bw_pkts: float, P: int,
                           latency: float) -> float:
    """Little's law (§4.3): R = M · (B/P) · L_blk   [buffers]."""
    return M * (bw_pkts / P) * latency


# ---------------------------------------------------------------------------
# End-to-end model for one (design, data size) point — Figures 7 and 10.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DesignPoint:
    design: str
    data_bytes: int
    bandwidth_tbps: float
    tau: float
    delta_c: float
    input_buffer_bytes: float
    working_memory_bytes: float


def staggered_delta_c(params: SwitchParams, data_bytes: int) -> float:
    """δ_c reachable via staggered sending: δ ≤ δ_c ≤ δ·(Z/N) (§5)."""
    nblocks = max(1, data_bytes // params.packet_bytes)
    return params.delta * nblocks


def model_design(design: str, data_bytes: int,
                 params: SwitchParams = SwitchParams(),
                 B: int = 1, S: int | None = None,
                 P: int | None = None,
                 staggered: bool = True) -> DesignPoint:
    """Evaluate bandwidth + memory for one aggregation design (§6.4)."""
    C = params.cores_per_cluster
    S = C if S is None else S
    P = params.ports if P is None else P
    L = params.packet_cycles
    delta = params.delta
    dc = staggered_delta_c(params, data_bytes) if staggered else delta
    dc = max(delta, dc)

    if design == "single":
        tau = tau_single(L, C, S, dc)
    elif design == "multi":
        tau = tau_multi(L, C, S, dc, B, P)
    elif design == "tree":
        tau = tau_tree(L, P, params.dma_cycles)
    else:
        raise ValueError(design)

    bw = bandwidth_pkts_per_cycle(params.cores, tau, delta)
    dk = delta_k(S, dc, params.cores, delta)
    q = queue_len(P, S, dk, tau)
    in_buf = input_buffer_pkts(P, params.cores, S, dk, tau)
    lat = block_latency(P, dc, q, tau)
    M = buffers_per_block(design, P, B)
    wm = working_memory_buffers(M, bw, P, lat)
    return DesignPoint(
        design=design, data_bytes=data_bytes,
        bandwidth_tbps=bw * params.packet_bytes * 8 * params.clock_hz / 1e12,
        tau=tau, delta_c=dc,
        input_buffer_bytes=in_buf * params.packet_bytes,
        working_memory_bytes=wm * params.packet_bytes,
    )


# ---------------------------------------------------------------------------
# Shared-switch mode: per-tenant throughput under a cluster partition (§4).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TenantPoint:
    """Predicted operating point of one tenant on a shared switch.

    The multi-tenant runtime (``runtime``) partitions the K HPU
    clusters across concurrent allreduce sessions; each tenant then runs
    the single-job model on its slice: its aggregation bandwidth is
    ``min(K_i/τ_i, share_i/δ)`` — compute-bound on the clusters it owns,
    or line-bound on its share of the ingress ports (the fraction of
    arriving packets that belong to it under the scheduler's interleave).
    ``bottleneck`` records which term won.
    """

    tenant: str
    clusters: int
    cores: int                  # K_i = clusters · C
    tau: float                  # τ_i — the tenant's own design/service time
    ingress_share: float        # its fraction of line-rate packet arrivals
    bandwidth_pkts: float       # min(K_i/τ_i, share_i/δ)  [packets/cycle]
    bandwidth_tbps: float
    bottleneck: str             # "compute" | "line"


def model_shared(allocs, params: SwitchParams = SwitchParams(),
                 ) -> tuple[TenantPoint, ...]:
    """Per-tenant throughput of a partitioned switch.

    ``allocs`` is a sequence of ``(tenant, clusters, tau, ingress_share)``
    tuples — the partition policy's cluster counts plus each tenant's
    single-job service time τ (from :func:`model_design` at its own
    design point) and its ingress share.  Clusters are shared-nothing
    (§3), so the single-job bandwidth law ``B = min(K/τ, 1/δ)`` applies
    per slice with the line term scaled by the tenant's packet share.
    The emulator's scheduler (``runtime.scheduler.simulate_shared``)
    measures the same quantity from the interleaved ingress schedule;
    ``tests/multidevice_checks.py`` group ``runtime`` pins the two
    together the way ``tests/test_switch.py`` pins the single-job model.
    """
    out = []
    for tenant, clusters, tau, share in allocs:
        k = int(clusters) * params.cores_per_cluster
        compute = k / float(tau)      # 0 clusters → 0 (a reclaimed tenant)
        line = float(share) / params.delta
        bw = min(compute, line)
        out.append(TenantPoint(
            tenant=str(tenant), clusters=int(clusters), cores=k,
            tau=float(tau), ingress_share=float(share),
            bandwidth_pkts=bw,
            bandwidth_tbps=bw * params.packet_bytes * 8
            * params.clock_hz / 1e12,
            bottleneck="compute" if compute <= line else "line"))
    return tuple(out)


def select_design(data_bytes: int) -> tuple[str, int]:
    """§6.4 switchover: (design, B). Reproducible mode always uses tree."""
    if data_bytes > 512 << 10:
        return "single", 1
    if data_bytes > 256 << 10:
        return "multi", 4
    if data_bytes > 128 << 10:
        return "multi", 2
    return "tree", 1


# ---------------------------------------------------------------------------
# Sparse storage model (§7, Figure 13).
# ---------------------------------------------------------------------------

def tau_sparse(storage: str, params: SwitchParams, density: float,
               P: int | None = None,
               hash_cycles_per_elem: float = 16.0,
               flush_cycles_per_elem: float = 1.0) -> float:
    """Service time for sparse handlers.

    hash: constant work per received element (insert-or-accumulate), ~2x
    the dense per-element cost (index compare + probe + accumulate).
    array: dense-array accumulate per element plus the end-of-block flush
    that scans the whole block span (span = packet elems / density),
    amortized over the P packets of the block.
    """
    P = params.ports if P is None else P
    elems = params.packet_bytes // (2 * params.elem_bytes)  # idx+val pairs
    if storage == "hash":
        return elems * hash_cycles_per_elem
    if storage == "array":
        span = elems / max(density, 1e-9)          # block span in elements
        accum = elems * 8.0                         # idx decode + accumulate
        flush = span * flush_cycles_per_elem / P    # once per block
        return accum + flush
    raise ValueError(storage)


def sparse_bandwidth_tbps(storage: str, density: float,
                          params: SwitchParams = SwitchParams()) -> float:
    tau = tau_sparse(storage, params, density)
    return bandwidth_tbps(params, tau)


def expected_hash_collisions(n_inserts: float, table_slots: float) -> float:
    """Expected colliding inserts for n random keys into m slots (§7).

    The birthday-style bound behind the hash-storage spill traffic of
    Fig. 14: ``n − m·(1 − (1 − 1/m)^n)`` (inserts minus expected
    occupied slots).  Shared by the discrete-event simulator
    (``switch_sim``) and the functional emulator's cross-check
    (``tests/test_switch.py``) — the emulator counts *actual*
    collisions in its coordinate merges and validates this expectation
    on real tensors.
    """
    m = max(float(table_slots), 1e-9)
    n = float(n_inserts)
    return max(0.0, n - m * (1.0 - (1.0 - 1.0 / m) ** n))


def expected_hash_spill_bytes(n_inserts: float, table_slots: float,
                              elem_bytes: int = 4) -> float:
    """Spill traffic of the expected collisions: one (idx, val) pair each."""
    return expected_hash_collisions(n_inserts, table_slots) * 2 * elem_bytes


# ---------------------------------------------------------------------------
# Lossy-fabric model (DESIGN.md §14): retransmit/retry-round expectations.
# ---------------------------------------------------------------------------
# Plain-number inputs like the rest of this module; the measured side is
# the reliability layer's retry counters (``dataplane._reliable_ingress``
# / the static ``packets.FaultSchedule``), cross-checked in
# ``tests/test_chaos.py`` the way the shared-switch model is.

def loss_probability(drop: float, corrupt: float) -> float:
    """Per-attempt failure probability: a packet is lost to the fold if
    it drops on the wire OR arrives corrupted (the checksum rejects it —
    corruption behaves exactly like a drop plus a NACK)."""
    return 1.0 - (1.0 - float(drop)) * (1.0 - float(corrupt))


def expected_retransmits_per_packet(q: float, max_retries: int) -> float:
    """Expected retransmission attempts per packet under per-attempt
    loss ``q``: the packet is re-sent once for every failed attempt
    while budget remains — ``sum_{r=1..R} q^r``."""
    return sum(q ** r for r in range(1, int(max_retries) + 1))


def delivery_probability(q: float, max_retries: int) -> float:
    """P(a packet is accepted within the budget): ``1 − q^(R+1)``."""
    return 1.0 - q ** (int(max_retries) + 1)


def expected_retry_rounds(q: float, max_retries: int,
                          num_packets: int) -> float:
    """Expected NACK rounds a level actually runs: round ``r`` happens
    iff any of the ``n`` packets failed all of its first ``r`` attempts
    — ``sum_{r=1..R} (1 − (1 − q^r)^n)``."""
    n = max(1, int(num_packets))
    return sum(1.0 - (1.0 - q ** r) ** n
               for r in range(1, int(max_retries) + 1))


@dataclasses.dataclass(frozen=True)
class LossPoint:
    """The lossy-fabric operating point for one level's ingress."""

    q: float                        # per-attempt loss probability
    retransmits: float              # expected retransmission attempts
    retry_rounds: float             # expected NACK rounds executed
    wait_rounds: float              # expected backoff rounds spent waiting
    survival: float                 # P(every packet accepted in budget)


def model_lossy(drop: float, corrupt: float, num_packets: int, *,
                max_retries: int = 3, timeout_rounds: int = 4,
                backoff: float = 2.0) -> LossPoint:
    """Evaluate the reliability layer's expected cost at one operating
    point: ``num_packets`` independent packets (a level's ``P · n``
    ingress), per-attempt loss ``q = loss_probability(drop, corrupt)``,
    and the retry budget/backoff of ``packets.RetryPolicy``.  The wait
    term charges ``timeout_rounds · backoff^(r−1)`` modeled rounds for
    each retry round expected to run."""
    q = loss_probability(drop, corrupt)
    n = max(1, int(num_packets))
    rounds = [1.0 - (1.0 - q ** r) ** n
              for r in range(1, int(max_retries) + 1)]
    return LossPoint(
        q=q,
        retransmits=n * expected_retransmits_per_packet(q, max_retries),
        retry_rounds=sum(rounds),
        wait_rounds=sum(p * timeout_rounds * backoff ** (r - 1)
                        for r, p in enumerate(rounds, start=1)),
        survival=delivery_probability(q, max_retries) ** n)
