"""Chrome-trace span recording for the data pipeline.

Port of ``petastorm_tpu.trace``. ``PipelineStats`` gives cheap per-stage totals; this
module adds the per-span view of *when* each stage ran: hand a :class:`TraceRecorder`
to ``DataLoader(trace=...)`` and every pipeline stage (reader fetch, batch formation,
the compressed-page inflate, the staged decode dispatch, H2D, the queue waits, plus
``shm.acquire_wait`` spans from pool feeders starved for a slab and the readahead
pool's ``io.readahead``/``io.wait``) records one duration event a occurrence, tagged
with its thread. :meth:`TraceRecorder.dump` writes trace-event JSON for
``chrome://tracing`` or Perfetto: producer, transfer and consumer lanes, and where the
bubbles are.

A span is host wall time around the enqueue and launch of the stage's work: the
transfer thread's spans never wait for the card, so tracing adds no synchronisation
the untraced path lacks. Enabled, a span costs a ``perf_counter`` pair (already paid
for the stats) and an appended tuple; disabled (``trace=None``, the default) one
``is None`` check a site.

Pool children record ``child.work``/``child.serialize`` around each item and send them
with the result header; the feeder merges them through :meth:`TraceRecorder.add_child`,
clock-aligned through each child's wall/perf anchor pair, so one dump shows the parent's
threads and the children on distinct pid lanes::

    from petastorm_tpu_torch.trace import TraceRecorder

    tracer = TraceRecorder()
    with DataLoader(reader, 256, trace=tracer) as loader:
        for batch in loader:
            with tracer.span("train.step"):
                step(batch)
    tracer.dump("pipeline_trace.json")
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time


class TraceRecorder:
    """Thread-safe duration-event recorder in Chrome trace-event format.

    ``max_events`` bounds memory on long runs (a span is one small tuple, but a
    multi-hour run at hundreds of batches/s would otherwise grow without limit):
    once full, the OLDEST spans are dropped — the dump shows the most recent
    window, which is the one being debugged. ``None`` disables the bound."""

    def __init__(self, max_events=1_000_000):
        from collections import deque

        # (name, lane key (tname, tid), t0_s, dur_s, pid-or-None (None = local))
        self._events = deque(maxlen=max_events)
        #: flow points (flow_id, lane, pid, t, name, terminate), rendered as Perfetto
        #: flow events ("s"/"t"/"f") linking one item's spans across pid lanes
        self._flows = deque(maxlen=max_events)
        self._lock = threading.Lock()
        self._origin = time.perf_counter()
        #: wall-clock instant matching ``_origin`` — the cross-process alignment
        #: anchor (children ship their own (wall, perf) pair; same host, so the
        #: shared wall clock maps child perf_counter values onto this timeline)
        self._wall_origin = time.time()

    def add(self, name, t0, dur):
        """Record one span: ``t0`` from ``time.perf_counter()``, ``dur`` seconds."""
        t = threading.current_thread()
        # keyed by (name, ident): two live threads may SHARE a name (e.g. a train
        # and an eval loader both run a "ptpu-loader" producer) and collapsing them
        # onto one trace lane would render bogus nested slices
        with self._lock:
            self._events.append((name, (t.name, t.ident), t0, dur, None))

    def add_child(self, pid, spans, wall_anchor, perf_anchor, lane=None):
        """Merge spans recorded in a pool child process onto a pid-tagged lane.

        ``spans`` is ``[(name, t0, dur), ...]`` with ``t0`` from the CHILD's
        ``perf_counter``; ``(wall_anchor, perf_anchor)`` is a pair the child
        sampled together, so each span start maps to this recorder's timeline as
        ``wall_anchor + (t0 - perf_anchor)`` on the shared wall clock. Alignment
        error is the wall-clock sampling jitter (microseconds on one host)."""
        if not spans:
            return
        lane = lane or ("ptpu-child-%d" % pid)
        base = (wall_anchor - self._wall_origin) - perf_anchor + self._origin
        with self._lock:
            for name, t0, dur in spans:
                self._events.append((name, (lane, pid), t0 + base, dur, pid))

    def add_flow_point(self, flow_id, lane, pid, t, name="item",
                       terminate=False):
        """Record one point of a Perfetto flow (the provenance plane's item linkage,
        ROADMAP.md Queue 1 item 8b). ``t`` is a value from THIS recorder's timeline
        (``perf_counter``); points sharing ``flow_id`` render as one arrow chain across
        the ``(pid, lane)`` tracks. ``terminate=True`` marks the chain's
        explicit end (the batch delivery point)."""
        with self._lock:
            self._flows.append((int(flow_id), lane, int(pid), t, name,
                                bool(terminate)))

    @contextlib.contextmanager
    def span(self, name):
        """Context manager recording the enclosed block as one span."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, t0, time.perf_counter() - t0)

    def __len__(self):
        with self._lock:
            return len(self._events)

    def events(self):
        """Snapshot of recorded spans as dicts (name/thread/pid/start_s/
        duration_s); ``pid`` is this process for locally recorded spans."""
        with self._lock:
            evs = list(self._events)
        local = os.getpid()
        return [{"name": n, "thread": t[0], "pid": p if p is not None else local,
                 "start_s": t0 - self._origin, "duration_s": d}
                for n, t, t0, d, p in evs]

    def dump(self, path):
        """Write ``chrome://tracing`` / Perfetto JSON (trace-event format).

        Lanes are per (process, thread): locally recorded spans render under
        this process's pid, child spans under THEIR pid with a ``process_name``
        metadata row per child process — one timeline, distinct pid lanes."""
        with self._lock:
            evs = list(self._events)
            flows = list(self._flows)
        local_pid = os.getpid()
        lanes = {}  # (pid, lane key) -> (tid, lane display name)
        for _n, tkey, _t0, _d, p in evs:
            key = (p if p is not None else local_pid, tkey)
            if key not in lanes:
                lanes[key] = tkey[0]
        for _fid, lane, fpid, _t, _n, _term in flows:
            # flow points land on (lane, pid)-keyed tracks like child spans do;
            # a point naming a lane no slice lives on still gets its own track
            key = (fpid, (lane, fpid))
            if key not in lanes:
                lanes[key] = lane
        trace_events = []
        tids = {}
        child_pids = sorted({p for _n, _t, _t0, _d, p in evs if p is not None
                             and p != local_pid}
                            | {fpid for _fid, _l, fpid, _t, _n, _term in flows
                               if fpid != local_pid})
        if child_pids:  # pid lanes only exist on merged multi-process dumps
            for pid in [local_pid] + child_pids:
                trace_events.append({
                    "ph": "M", "pid": pid, "tid": 0, "name": "process_name",
                    "args": {"name": "ptpu-parent" if pid == local_pid
                             else "ptpu-pool-child-%d" % pid}})
        for key in sorted(lanes, key=str):
            tid = tids[key] = len(tids) + 1
            trace_events.append({  # thread-name metadata row
                "ph": "M", "pid": key[0], "tid": tid, "name": "thread_name",
                "args": {"name": lanes[key]}})
        for name, tkey, t0, dur, p in evs:
            pid = p if p is not None else local_pid
            trace_events.append({
                "ph": "X", "pid": pid, "tid": tids[(pid, tkey)], "name": name,
                "ts": (t0 - self._origin) * 1e6, "dur": dur * 1e6, "cat": "pipeline"})
        # flows: chain each flow id's points in time
        # order — "s" start, "t" steps, "f" finish — so Perfetto draws arrows
        # linking one item's spans across pid lanes
        by_flow = {}
        for fid, lane, fpid, t, name, term in flows:
            by_flow.setdefault(fid, []).append((t, lane, fpid, name, term))
        for fid, points in by_flow.items():
            points.sort(key=lambda p: p[0])
            for i, (t, lane, fpid, name, term) in enumerate(points):
                if i == 0:
                    ph = "s"
                elif i == len(points) - 1 or term:
                    ph = "f"
                else:
                    ph = "t"
                ev = {"ph": ph, "id": fid, "pid": fpid,
                      "tid": tids[(fpid, (lane, fpid))], "name": name,
                      "ts": (t - self._origin) * 1e6, "cat": "prov"}
                if ph == "f":
                    ev["bp"] = "e"  # bind to the enclosing slice
                trace_events.append(ev)
                if ph == "f":
                    break
        with open(path, "w") as f:
            json.dump({"traceEvents": trace_events,
                       "displayTimeUnit": "ms"}, f)
        return path
