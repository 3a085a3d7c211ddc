"""Flow-level fat-tree simulator — the paper's §7.1 at-scale comparison.

The port's own copy of ``repro/perfmodel/network_sim.py`` (plain Python).

Reproduces the Figure-15 experiment: 64 hosts on a 2-level fat tree of
100 Gb/s links, reducing a 100 MiB gradient vector, comparing

  * ``host_ring``     — host-based ring (Rabenseifner) allreduce,
  * ``innet_dense``   — Flare in-network dense allreduce,
  * ``sparcml``       — SparCML host-based sparse allreduce (recursive
                        doubling of (idx,val) sets, the paper's baseline),
  * ``flare_sparse``  — Flare in-network sparse allreduce (§7).

The paper drives SST with packet-level traces from a real sparsified
ResNet-50 run; we use a flow-level model (per-phase link loads, bottleneck
serialization) with an index-overlap parameter ω calibrated against the
paper's reported densification (sparse data gets denser toward the root).
Times and traffic therefore reproduce the paper's *orderings and ratio
regimes* rather than its exact figures; EXPERIMENTS.md reports both side
by side.

Union growth model: merging ``n`` sparse sets of density ``d`` yields
``min(1, d · n^(1-ω))`` — ω=0 disjoint indices (worst densification),
ω=1 identical supports (none).  ResNet-50 bucket-top-k gradients are
mostly disjoint: ω defaults to 0.15.

Congestion (the Canary extension, DESIGN.md §15): every algorithm takes
``background_flows=`` — injected cross traffic per link class
(:class:`BackgroundFlow`) that scales the per-phase effective link rate
by the processor-sharing factor ``c / (c + b)``.  These are the
background-traffic signals ``runtime/congestion.py`` turns into
per-switch hotness for the replan policy.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class FatTree:
    hosts: int = 64
    hosts_per_leaf: int = 8
    link_gbps: float = 100.0
    hop_latency_us: float = 1.0
    switch_dense_tbps: float = 4.0      # Flare dense agg capacity (Fig. 11)
    switch_sparse_tbps: float = 2.0     # Flare sparse agg capacity (Fig. 13)

    @property
    def leaves(self) -> int:
        return self.hosts // self.hosts_per_leaf

    @property
    def link_bytes_per_us(self) -> float:
        return self.link_gbps / 8.0 * 1e3   # bytes per microsecond


@dataclasses.dataclass(frozen=True)
class AllreduceOutcome:
    algorithm: str
    time_us: float
    network_bytes: float     # total bytes × links traversed
    host_bytes: float        # bytes sent per host


ENTRY_BYTES = 8              # (int32 idx, fp32 val)

#: Link classes of the 2-level fat tree: host↔leaf access links and
#: leaf↔spine aggregation links.
LINK_CLASSES = ("host_leaf", "leaf_spine")


@dataclasses.dataclass(frozen=True)
class BackgroundFlow:
    """Injected cross traffic on one link class of the fat tree.

    ``gbps`` of background load shared with our allreduce on every link
    of class ``link`` — the congestion signal the Canary-style replan
    loop reacts to.  Flows on the same class accumulate.
    """

    link: str                   # "host_leaf" | "leaf_spine"
    gbps: float

    def __post_init__(self):
        if self.link not in LINK_CLASSES:
            raise ValueError(f"unknown link class {self.link!r}; "
                             f"have {LINK_CLASSES}")

    @property
    def bytes_per_us(self) -> float:
        return max(0.0, float(self.gbps)) / 8.0 * 1e3


def effective_link_rates(net: FatTree,
                         background_flows: Sequence[BackgroundFlow] = (),
                         ) -> dict[str, float]:
    """Per-link-class effective rate (bytes/µs) under background load.

    A link of capacity ``c`` carrying ``b`` bytes/µs of background
    traffic serves our flow the processor-sharing fraction ``c/(c+b)``
    of the line: effective rate ``c²/(c+b)`` — monotone decreasing in
    ``b``, → ``c`` as ``b`` → 0 (the fault-free limit is exact).
    """
    cap = net.link_bytes_per_us
    load = {k: 0.0 for k in LINK_CLASSES}
    for f in background_flows or ():
        load[f.link] += f.bytes_per_us
    return {k: cap * cap / (cap + b) for k, b in load.items()}


def _union_density(d: float, n: int, omega: float) -> float:
    return min(1.0, d * n ** (1.0 - omega))


def host_ring(z_bytes: int, net: FatTree = FatTree(), *,
              background_flows: Sequence[BackgroundFlow] = (),
              ) -> AllreduceOutcome:
    """Rabenseifner ring: 2(P−1) steps of Z/P per host."""
    p = net.hosts
    rates = effective_link_rates(net, background_flows)
    steps = 2 * (p - 1)
    per_step = z_bytes / p
    # ring edges: intra-leaf edges traverse 2 links (host→leaf→host),
    # leaf-boundary edges 4 (host→leaf→spine→leaf→host).  Every step
    # includes boundary edges, so the slowest link class paces the ring.
    cross = net.leaves
    intra = p - cross
    traffic = steps * per_step * (2 * intra + 4 * cross)
    time = steps * (per_step / min(rates.values())
                    + 2 * net.hop_latency_us)
    return AllreduceOutcome("host_ring", time, traffic,
                            host_bytes=steps * per_step)


def innet_dense(z_bytes: int, net: FatTree = FatTree(), *,
                background_flows: Sequence[BackgroundFlow] = (),
                ) -> AllreduceOutcome:
    """Flare §4 dense reduction tree: hosts→leaf→root, multicast back."""
    # streaming pipeline: each stage forwards at the min of line rate and
    # the switch's aggregation capacity share for its active ports.
    leaf_ports = net.hosts_per_leaf
    rates = effective_link_rates(net, background_flows)
    # capacity per port in bytes/us: tbps → bytes/us = tbps/8 ·1e6
    cap_per_port = net.switch_dense_tbps / 8.0 * 1e6 / leaf_ports
    eff = min(min(rates.values()), cap_per_port)
    # 4 pipeline hops (host→leaf→spine→leaf→host), streamed
    time = z_bytes / eff + 4 * net.hop_latency_us
    traffic = (net.hosts * z_bytes        # hosts → leaves (up)
               + net.leaves * z_bytes     # leaves → root
               + net.leaves * z_bytes     # root → leaves (down)
               + net.hosts * z_bytes)     # leaves → hosts
    return AllreduceOutcome("innet_dense", time, traffic,
                            host_bytes=z_bytes)


def sparcml(z_bytes: int, density: float, *,
            net: FatTree = FatTree(), omega: float = 0.15,
            merge_ns_per_byte: float = 0.35,
            background_flows: Sequence[BackgroundFlow] = (),
            ) -> AllreduceOutcome:
    """SparCML SSAR recursive doubling: sparse sets double each step.

    Each of log2(P) steps, every host exchanges its current (idx, val) set
    with a partner at distance 2^s (both directions) and *merges* the
    received set on the host CPU — the per-byte merge cost is exactly the
    work Flare moves into the switch, and is why in-network sparse wins.
    Set density grows by the union model; a set denser than the dense
    break-even falls back to dense exchange (documented SparCML behaviour).
    """
    p = net.hosts
    rates = effective_link_rates(net, background_flows)
    z_elems = z_bytes // 4
    steps = int(math.log2(p))
    total_traffic = 0.0
    host_bytes = 0.0
    time = 0.0
    d = density
    for s in range(steps):
        nnz = _union_density(d, 2 ** s, omega) * z_elems
        set_bytes = min(nnz * ENTRY_BYTES, z_bytes)   # dense fallback
        dist = 2 ** s
        hops = 2 if dist < net.hosts_per_leaf else 4
        rate = rates["host_leaf"] if hops == 2 else min(rates.values())
        # both partners send simultaneously on disjoint paths
        total_traffic += p * set_bytes * hops
        host_bytes += set_bytes
        time += set_bytes / rate \
            + set_bytes * merge_ns_per_byte * 1e-3 \
            + hops * net.hop_latency_us
    return AllreduceOutcome("sparcml", time, total_traffic, host_bytes)


def flare_sparse(z_bytes: int, density: float, *,
                 net: FatTree = FatTree(), omega: float = 0.15,
                 spill_fraction: float = 0.0,
                 background_flows: Sequence[BackgroundFlow] = (),
                 ) -> AllreduceOutcome:
    """Flare §7 in-network sparse allreduce on the reduction tree.

    Hosts send (idx, val) lists up; leaf switches merge (hash storage,
    possibly spilling ``spill_fraction`` extra traffic); the root merges
    leaf lists (array storage — densest point) and multicasts the merged
    list down.
    """
    z_elems = z_bytes // 4
    k_bytes = density * z_elems * ENTRY_BYTES
    d_leaf = _union_density(density, net.hosts_per_leaf, omega)
    leaf_bytes = min(d_leaf * z_elems * ENTRY_BYTES, z_bytes)
    d_root = _union_density(density, net.hosts, omega)
    root_bytes = min(d_root * z_elems * ENTRY_BYTES, z_bytes)

    up = net.hosts * k_bytes * (1 + spill_fraction) \
        + net.leaves * leaf_bytes * (1 + spill_fraction)
    down = net.leaves * root_bytes + net.hosts * root_bytes
    traffic = up + down

    rates = effective_link_rates(net, background_flows)
    cap_per_port = net.switch_sparse_tbps / 8.0 * 1e6 / net.hosts_per_leaf
    eff = min(min(rates.values()), cap_per_port)
    # pipeline: host uplink (k), leaf→root (leaf list), down (root list ×2)
    time = (k_bytes + leaf_bytes + 2 * root_bytes) / eff \
        + 4 * net.hop_latency_us
    return AllreduceOutcome("flare_sparse", time, traffic,
                            host_bytes=k_bytes + root_bytes)


def figure15(z_bytes: int = 100 << 20, density: float = 1.0 / 512,
             net: FatTree = FatTree(), omega: float = 0.15,
             background_flows: Sequence[BackgroundFlow] = (),
             ) -> dict[str, AllreduceOutcome]:
    """The full Fig. 15 comparison (defaults = the paper's setup:
    100 MiB vector, buckets of 512 with one value sent per bucket)."""
    bg = tuple(background_flows)
    return {
        "host_ring": host_ring(z_bytes, net, background_flows=bg),
        "innet_dense": innet_dense(z_bytes, net, background_flows=bg),
        "sparcml": sparcml(z_bytes, density, net=net, omega=omega,
                           background_flows=bg),
        "flare_sparse": flare_sparse(z_bytes, density, net=net, omega=omega,
                                     background_flows=bg),
    }
