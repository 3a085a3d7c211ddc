"""Structured event tracer with Chrome-trace/Perfetto JSON export.

The port of ``repro/obs/tracer.py``.  Spans (begin/end or ``with
tracer.span(...)``), instants, and pre-computed complete events
(``span_at``: how the modeled timeline renderer lays down analytic
tracks, ``obs.timeline``) land in one event list, grouped two-deep for
the trace viewer:

* ``process``: the comparison axis: ``"measured"`` (host wall-clock
  spans), ``"trace"`` (the data plane's phases, recorded where the
  reference traces them), ``"modeled"`` (scheduler/perfmodel
  predictions).  Perfetto renders each as its own process lane, so
  modeled-vs-measured drift is visible per phase.
* ``track``: the thread lane within a process (one per tenant/session).

Clocks are injectable, as in ``ft.coordinator``: every recording method
takes ``now=``, and the tracer itself takes a ``clock=`` callable,
``time.perf_counter`` by default, :func:`counting_clock` for
byte-identical exports (same workload + same injected clock gives
identical JSON).

``ring=N`` turns the tracer into a flight recorder: a bounded deque
keeps the **last** N events, so an always-on tracer in a long run costs
O(N) memory and still holds the window that matters after an incident.
"""
from __future__ import annotations

import collections
import contextlib
import json
import time


def counting_clock(start: int = 0, tick: int = 1):
    """A deterministic clock: each call advances by ``tick``.

    The injectable stand-in for ``time.perf_counter`` when exports must
    be byte-identical across runs (events then sit at their *ordinal*
    time, which is reproducible whenever the recording sequence is).
    """
    state = {"now": start - tick}

    def now():
        state["now"] += tick
        return state["now"]

    return now


class Tracer:
    """Span/instant event recorder with ring-buffer flight-recorder mode."""

    def __init__(self, *, clock=None, ring: int | None = None):
        self.clock = time.perf_counter if clock is None else clock
        self.ring = ring
        self._events = collections.deque(maxlen=ring)
        self._open: list[dict] = []      # begin() stack, matched by end()

    def now(self) -> float:
        return self.clock()

    def __len__(self) -> int:
        return len(self._events)

    @property
    def events(self) -> tuple:
        return tuple(self._events)

    def _emit(self, ev: dict) -> dict:
        self._events.append(ev)
        return ev

    # -- recording ---------------------------------------------------------
    def instant(self, name: str, *, track: str = "host",
                process: str = "measured", args: dict | None = None,
                now=None) -> dict:
        ts = self.now() if now is None else now
        ev = {"ph": "i", "name": str(name), "ts": float(ts),
              "process": process, "track": str(track)}
        if args:
            ev["args"] = dict(args)
        return self._emit(ev)

    def begin(self, name: str, *, track: str = "host",
              process: str = "measured", args: dict | None = None,
              now=None) -> dict:
        ts = self.now() if now is None else now
        ev = {"ph": "X", "name": str(name), "ts": float(ts), "dur": 0.0,
              "process": process, "track": str(track)}
        if args:
            ev["args"] = dict(args)
        self._open.append(ev)
        return ev

    def end(self, *, args: dict | None = None, now=None) -> dict:
        if not self._open:
            raise RuntimeError("end() without a matching begin()")
        ev = self._open.pop()
        ts = self.now() if now is None else now
        ev["dur"] = max(0.0, float(ts) - ev["ts"])
        if args:
            ev.setdefault("args", {}).update(args)
        return self._emit(ev)

    @contextlib.contextmanager
    def span(self, name: str, *, track: str = "host",
             process: str = "measured", args: dict | None = None):
        """``with tracer.span("train.step", track="train/job0"): ...``"""
        ev = self.begin(name, track=track, process=process, args=args)
        try:
            yield ev
        finally:
            self.end()

    def span_at(self, name: str, ts, dur, *, track: str = "host",
                process: str = "modeled", args: dict | None = None) -> dict:
        """A complete event at an explicit time — the modeled-timeline
        entry point (analytic tracks know their own clock)."""
        ev = {"ph": "X", "name": str(name), "ts": float(ts),
              "dur": max(0.0, float(dur)),
              "process": process, "track": str(track)}
        if args:
            ev["args"] = dict(args)
        return self._emit(ev)

    # -- export ------------------------------------------------------------
    def to_chrome(self, *, metrics: dict | None = None) -> dict:
        """The Chrome-trace/Perfetto JSON object.

        pids/tids are assigned in sorted (process, track) order with
        ``process_name``/``thread_name`` metadata events, so the export
        is a deterministic function of the recorded events.  ``metrics``
        (a ``MetricsRegistry.as_dict()`` snapshot) rides along under a
        top-level key — one artifact holds spans, modeled tracks, and
        the counter surface.
        """
        procs = sorted({ev["process"] for ev in self._events})
        pids = {p: i + 1 for i, p in enumerate(procs)}
        lanes = sorted({(ev["process"], ev["track"])
                        for ev in self._events})
        tids = {lane: i + 1 for i, lane in enumerate(lanes)}
        events = []
        for p in procs:
            events.append({"ph": "M", "name": "process_name",
                           "pid": pids[p], "tid": 0,
                           "args": {"name": p}})
        for (p, t) in lanes:
            events.append({"ph": "M", "name": "thread_name",
                           "pid": pids[p], "tid": tids[(p, t)],
                           "args": {"name": t}})
        for ev in self._events:
            out = {"ph": ev["ph"], "name": ev["name"], "ts": ev["ts"],
                   "pid": pids[ev["process"]],
                   "tid": tids[(ev["process"], ev["track"])]}
            if ev["ph"] == "X":
                out["dur"] = ev["dur"]
            if ev["ph"] == "i":
                out["s"] = "t"           # thread-scoped instant
            if "args" in ev:
                out["args"] = ev["args"]
            events.append(out)
        trace = {"traceEvents": events, "displayTimeUnit": "ms"}
        if metrics is not None:
            trace["metrics"] = metrics
        return trace

    def to_json(self, *, metrics: dict | None = None) -> str:
        return json.dumps(self.to_chrome(metrics=metrics), indent=1,
                          sort_keys=True) + "\n"

    def write(self, path: str, *, metrics: dict | None = None) -> None:
        with open(path, "w") as f:
            f.write(self.to_json(metrics=metrics))
