"""Typed metrics registry: the fabric's single numeric surface.

The port of ``repro/obs/metrics.py``.  Every counter source of the port
(``switch/dataplane`` static plan counters, the runtime scheduler's
measured ``TenantCounters``, the congestion monitor's per-slot hotness,
the ``FaultSchedule`` retry counters, session-lifecycle events)
registers here under one stable hierarchical name schema (DESIGN.md
§16):

``switch.<session>.l<level>.{ingress_packets,egress_packets,combines}``
    static data-plane work per tree level, integer-equal to
    ``dataplane.plan_counters``/``tree_counters``;
``tenant.<name>.{retransmits,retry_rounds,wait_rounds}``
    the static ``FaultSchedule`` reliability counters;
``tenant.<name>.sched.{packets,combines,occupancy_cycles,...}``
    measured per-tenant accounting of the last shared schedule;
``session.<id>.{admitted,demand_bytes,...}`` / ``manager.*``
    admission-control lifecycle;
``schedule.{occupancy_cycles,makespan_cycles,utilization}``
    the shared-schedule aggregates ``CongestionMonitor`` consumes;
``congestion.l<level>s<index>.hotness``
    per physical fabric slot, the observed congestion map.

Three instrument types, strictly typed per name: registering a name as
a counter and later as a gauge is an error, never a silent coercion:

* :class:`Counter`: monotone integer (``inc``), fed host scalars only
  (``observe_tree`` after the reduction, or static schedules at
  admission), so recording never adds work to the reduction;
* :class:`Gauge`: last-write-wins float (``set``), for levels that are
  re-derived per schedule (occupancy, shares, hotness);
* :class:`Histogram`: streaming count/sum/min/max plus retained-sample
  percentiles (``record``), for host-side durations.

Export (``as_dict``/``to_json``) is deterministic: sorted names, typed
records, byte-identical across runs of the same workload and to the
reference's export of the same records.
"""
from __future__ import annotations

import json
import math


def _concrete(value) -> float:
    """A host float from an int/float, a numpy scalar or a tensor on the
    CPU.

    A tensor anywhere else (a card, ``meta``) is rejected loudly: the
    registry is a host-side surface, and ``float()`` of a CUDA tensor
    would silently synchronize the card in the middle of a step.
    """
    if hasattr(value, "device") and getattr(value.device, "type",
                                            "cpu") != "cpu":
        raise TypeError(
            f"metrics take concrete host scalars, not traced values "
            f"({type(value).__name__}); pull counters out of the traced "
            f"program after block_until_ready")
    try:
        return float(value)
    except TypeError as e:
        raise TypeError(
            f"metrics take concrete host scalars, not traced values "
            f"({type(value).__name__}); pull counters out of the traced "
            f"program after block_until_ready") from e


class Counter:
    """Monotone integer counter."""

    kind = "counter"

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n=1) -> int:
        n = int(_concrete(n))
        if n < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease "
                             f"(inc({n}))")
        self.value += n
        return self.value

    def snapshot(self) -> dict:
        return {"type": self.kind, "value": self.value}


class Gauge:
    """Last-write-wins float level."""

    kind = "gauge"

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0
        self.updates = 0

    def set(self, v) -> float:
        self.value = _concrete(v)
        self.updates += 1
        return self.value

    def snapshot(self) -> dict:
        return {"type": self.kind, "value": self.value}


class Histogram:
    """Streaming summary of host-side observations (durations, sizes).

    Alongside the running count/sum/min/max, the first
    ``SAMPLE_CAP`` observations are retained verbatim so the export
    carries percentiles (p50/p95/p99, nearest-rank) — the keep-first
    bound is deterministic (unlike reservoir sampling), which preserves
    the byte-identical-export anchor; past the cap the percentiles
    describe the earliest window while count/sum/min/max stay exact.
    """

    kind = "histogram"

    #: retained-sample bound; keep-first, so exports stay deterministic.
    SAMPLE_CAP = 4096

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.sum = 0.0
        self.min = None
        self.max = None
        self.samples: list[float] = []

    def record(self, v) -> None:
        v = _concrete(v)
        self.count += 1
        self.sum += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)
        if len(self.samples) < self.SAMPLE_CAP:
            self.samples.append(v)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def percentile(self, p: float) -> float | None:
        """Nearest-rank percentile over the retained samples (``None``
        when nothing was recorded)."""
        if not self.samples:
            return None
        if not 0.0 <= p <= 100.0:
            raise ValueError(f"percentile must be in [0, 100], got {p}")
        ordered = sorted(self.samples)
        rank = max(1, math.ceil(p / 100.0 * len(ordered)))
        return ordered[rank - 1]

    def snapshot(self) -> dict:
        return {"type": self.kind, "count": self.count, "sum": self.sum,
                "min": self.min, "max": self.max,
                "p50": self.percentile(50.0),
                "p95": self.percentile(95.0),
                "p99": self.percentile(99.0)}


class MetricsRegistry:
    """Create-or-get instruments by hierarchical dotted name."""

    def __init__(self):
        self._metrics: dict[str, Counter | Gauge | Histogram] = {}

    def _get(self, name: str, cls):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(str(name))
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} is a {m.kind}, not a "
                            f"{cls.kind}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    # -- reading -----------------------------------------------------------
    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def get(self, name: str):
        return self._metrics.get(name)

    def value(self, name: str, default=None):
        m = self._metrics.get(name)
        return default if m is None else m.value

    def names(self, prefix: str = "") -> list[str]:
        return sorted(n for n in self._metrics if n.startswith(prefix))

    # -- population from reduction results ---------------------------------
    def observe_tree(self, prefix: str, tree) -> None:
        """Fold a dict of host scalars (e.g. the data plane's
        fault-stats dict, copied to the CPU after the reduction) into
        counters under ``<prefix>.<key>``."""
        for key in sorted(tree):
            self.counter(f"{prefix}.{key}").inc(tree[key])

    # -- export ------------------------------------------------------------
    def as_dict(self) -> dict:
        """Deterministic snapshot: sorted names → typed records."""
        return {n: self._metrics[n].snapshot()
                for n in sorted(self._metrics)}

    def to_json(self) -> str:
        return json.dumps(self.as_dict(), indent=1, sort_keys=True) + "\n"

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())
