"""Flight recorder: a bounded ring of recent pipeline events, dumped on demand.

Port of ``petastorm_tpu.obs.flight``. A pipeline that hangs or fails leaves little
evidence: the decisions that mattered (which degradation fired, which chaos fault was
injected) happened seconds earlier. A :class:`FlightRecorder` keeps the last
``max_events`` structured events in a bounded ring (``collections.deque`` appends, no
formatting until a dump), and :func:`write_flight_record` writes a record as JSON.

:func:`active_recorders` is the module-global hook the degradation log and the chaos
plane mirror their entries into, without either depending on whoever owns the
recorder (the health monitor, ROADMAP.md Queue 1 item 8b, or a caller that
registers one through :func:`activate`).
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time
import weakref
from collections import deque

#: recorders currently attached to a live HealthMonitor — the degradation log
#: mirrors entries into these (weak: a dead monitor stops receiving, silently)
_active_lock = threading.Lock()
_active = weakref.WeakSet()


def activate(recorder):
    with _active_lock:
        _active.add(recorder)


def deactivate(recorder):
    with _active_lock:
        _active.discard(recorder)


def active_recorders():
    """Snapshot of recorders attached to live monitors (possibly empty).
    Lock-free fast path when none are active: the degradation log calls this
    per occurrence, and with health disabled (the common case) it must not
    take a process-global lock on per-item paths."""
    if not _active:
        return ()
    with _active_lock:
        return list(_active)


class FlightRecorder:
    """Bounded ring of ``(t, kind, fields)`` events.

    ``record`` is the hot-path entry point: one tuple build plus one deque
    append (the deque's ``maxlen`` makes it a ring — old events fall off the
    far end). No lock on the append path; ``events()`` snapshots under the
    GIL's deque-iteration guarantees via ``list()``.
    """

    def __init__(self, max_events=2048):
        self._events = deque(maxlen=max(16, int(max_events)))
        self._origin = time.perf_counter()
        self._wall_origin = time.time()

    def record(self, kind, **fields):
        self._events.append((time.perf_counter(), kind, fields))

    def __len__(self):
        return len(self._events)

    def events(self):
        """Recent events as dicts, oldest first: ``{"t_s", "kind", ...fields}``
        with ``t_s`` relative to recorder creation."""
        return [{"t_s": round(t - self._origin, 6), "kind": kind, **fields}
                for t, kind, fields in list(self._events)]

    def clear(self):
        self._events.clear()


#: tmp-name disambiguator: two monitors in one process can share the default
#: pid-keyed flight_path and dump concurrently (e.g. a wedged filesystem
#: stalling train + eval loaders at once) — a pid-only tmp suffix would have
#: them truncating each other's half-written record
_tmp_seq = itertools.count()


def write_flight_record(path, record):
    """Atomically write one flight record as JSON (tmp + rename, like the
    Prometheus exporter: a reader never sees a torn file). Non-JSON values are
    stringified — a flight record must never fail to serialize at the exact
    moment it matters most. Returns ``path``."""
    tmp = "%s.tmp.%d.%d" % (path, os.getpid(), next(_tmp_seq))
    try:
        with open(tmp, "w") as f:
            json.dump(record, f, indent=1, default=str)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass
    return path
