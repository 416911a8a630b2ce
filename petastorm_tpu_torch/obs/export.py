"""Metric exporters: Prometheus text files and periodic JSONL snapshots.

Port of ``petastorm_tpu.obs.export``. Two pull points for the registry
(:mod:`petastorm_tpu_torch.obs.metrics`):

- :func:`write_prometheus`: one atomic write of the text exposition format (tmp file
  plus rename, so a scraping sidecar never reads a torn file);
- :class:`Reporter`: a daemon thread snapshotting every ``interval_s`` into a JSONL
  stream (one ``{"ts": ..., "metrics": {...}}`` object a line) and/or refreshing a
  Prometheus file, flushed once more at stop, at interpreter exit and on an unhandled
  exception.

:func:`parse_prometheus_text` is the minimal parser the tests validate exports with
(no ``prometheus_client`` dependency); :func:`read_latest_jsonl_snapshot` and
:func:`read_recent_jsonl_snapshots` read a Reporter's stream back, tolerating a torn
final line. With ``timelines=True`` (the default) each flush first samples the
registry's windowed time series (:meth:`MetricsRegistry.sample_timelines`), which also
drives an attached SLO engine. The stats CLI that pretty-prints both is
:mod:`petastorm_tpu_torch.obs.stats_cli`.
"""
from __future__ import annotations

import itertools
import json
import os
import re
import sys
import threading
import time

from petastorm_tpu_torch.obs.metrics import default_registry

#: per-process tmp-name disambiguator: two THREADS writing the same target
#: concurrently (a Reporter plus a manual write) must not share a tmp file —
#: pid alone is not enough (itertools.count is atomic under the GIL)
_tmp_seq = itertools.count()


def write_prometheus(path, registry=None):
    """Atomically write ``registry.to_prometheus()`` to ``path``; returns path."""
    registry = registry or default_registry()
    text = registry.to_prometheus()
    tmp = "%s.tmp.%d.%d" % (path, os.getpid(), next(_tmp_seq))
    try:
        with open(tmp, "w") as f:
            f.write(text)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):  # replace failed: don't litter tmp files
            try:
                os.remove(tmp)
            except OSError:
                pass
    return path


_SAMPLE_RE = re.compile(
    r'^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)'
    r'(?P<labels>\{[^}]*\})?\s+'
    r'(?P<value>[-+]?(?:[0-9.eE+-]+|Inf|NaN))\s*$')


def parse_prometheus_text(text):
    """Parse Prometheus text format into ``{name{labels}: float}`` + checks.

    Raises ``ValueError`` on any malformed line, on a sample whose family has
    no ``# TYPE`` header, and on histogram buckets whose cumulative counts
    decrease — the validations the CI stats-smoke step asserts.
    """
    samples = {}
    types = {}
    bucket_runs = {}  # (family, non-le labels) -> last cumulative count
    for lineno, line in enumerate(text.splitlines(), start=1):
        if not line.strip():
            continue
        if line.startswith("# TYPE "):
            parts = line.split()
            if len(parts) != 4 or parts[3] not in (
                    "counter", "gauge", "histogram", "summary", "untyped"):
                raise ValueError("line %d: malformed TYPE: %r" % (lineno, line))
            types[parts[2]] = parts[3]
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError("line %d: malformed sample: %r" % (lineno, line))
        name = m.group("name")
        family = re.sub(r"_(bucket|sum|count)$", "", name)
        if name not in types and family not in types:
            raise ValueError("line %d: sample %r has no # TYPE header"
                             % (lineno, name))
        value = float(m.group("value"))
        labels = m.group("labels") or ""
        if name.endswith("_bucket"):
            key = (family, re.sub(r'le="[^"]*",?', "", labels))
            last = bucket_runs.get(key)
            if last is not None and value < last:
                raise ValueError(
                    "line %d: non-monotonic histogram bucket for %s"
                    % (lineno, family))
            bucket_runs[key] = value
        samples[name + labels] = value
    return samples


#: live Reporters flushed by the crash hooks: a run that
#: dies mid-interval — unhandled exception or plain interpreter exit — must
#: not lose its final JSONL/Prometheus window. start() registers, stop()
#: removes; the hooks themselves are installed once per process.
_live_lock = threading.Lock()
_live_reporters = []
_hooks_installed = False


def _flush_live_reporters():
    with _live_lock:
        reporters = list(_live_reporters)
    for reporter in reporters:
        try:
            reporter._write_once()
        except OSError:
            pass  # a dying process's disk may be the reason it is dying


def _install_exit_hooks():
    """atexit + sys.excepthook (chained), installed once per process."""
    global _hooks_installed
    with _live_lock:
        if _hooks_installed:
            return
        _hooks_installed = True
    import atexit

    atexit.register(_flush_live_reporters)
    previous = sys.excepthook

    def _flushing_excepthook(exc_type, exc, tb):
        _flush_live_reporters()
        previous(exc_type, exc, tb)

    sys.excepthook = _flushing_excepthook


class Reporter:
    """Background snapshot thread: JSONL stream and/or Prometheus file.

    Daemonized and stop-event driven (never blocks interpreter exit); one
    final snapshot is flushed on :meth:`stop` so short runs still leave a
    record — and, while the reporter is live, on interpreter exit and on an
    unhandled exception (atexit + a chained ``sys.excepthook``), so a run
    that dies mid-interval still leaves its final window on disk. Use as a
    context manager around the serving loop::

        with Reporter(jsonl_path="run_stats.jsonl", interval_s=2.0):
            for batch in loader: ...
    """

    #: JSONL line schema (the JAX package's): v2 lines carry a ``perf`` stamp and the
    #: reporter's ``anchor`` (wall, perf, host, pid), so a reader can place every
    #: window on one anchored timeline instead of trusting each line's wall stamp
    SCHEMA = "ptpu-stats-v2"

    def __init__(self, registry=None, interval_s=5.0, jsonl_path=None,
                 prom_path=None, max_bytes=None, keep=3, timelines=True):
        if jsonl_path is None and prom_path is None:
            raise ValueError("Reporter needs jsonl_path and/or prom_path")
        self._registry = registry or default_registry()
        self._interval_s = float(interval_s)
        self._jsonl_path = jsonl_path
        self._prom_path = prom_path
        #: sample the registry's windowed time series once a flush, on this thread
        #: (the hot paths never see it); False opts out, e.g. for a second Reporter
        #: on the same registry, which would halve the windows
        self._timelines = bool(timelines)
        import socket

        self._anchor = {"wall": time.time(), "perf": time.perf_counter(),
                        "host": socket.gethostname(), "pid": os.getpid()}
        #: size-capped rotation: when appending would
        #: grow the JSONL stream past ``max_bytes``, the file rotates to
        #: ``<path>.1`` (existing ``.1``→``.2``, …; at most ``keep`` rotated
        #: files retained) BEFORE the write — a multi-day run can no longer
        #: grow the sidecar unbounded. None (default) = never rotate. The
        #: atexit/crash flush goes through the same path, so the final window
        #: survives rotation too.
        self._max_bytes = None if max_bytes is None else int(max_bytes)
        self._keep = max(1, int(keep))
        self._stop_event = threading.Event()
        self._thread = None
        self._rotate_lock = threading.Lock()

    def _maybe_rotate(self, nbytes_next):
        """Rotate ``jsonl_path`` when the pending append would cross the cap.
        Serialized against the crash-hook flush (two writers, one shift
        chain); rotation failures degrade to appending in place — losing the
        cap beats losing the snapshot."""
        if self._max_bytes is None:
            return
        with self._rotate_lock:
            try:
                size = os.path.getsize(self._jsonl_path)
            except OSError:
                return  # nothing to rotate yet
            if size + nbytes_next <= self._max_bytes:
                return
            try:
                oldest = "%s.%d" % (self._jsonl_path, self._keep)
                if os.path.exists(oldest):
                    os.remove(oldest)
                for i in range(self._keep - 1, 0, -1):
                    src = "%s.%d" % (self._jsonl_path, i)
                    if os.path.exists(src):
                        os.replace(src, "%s.%d" % (self._jsonl_path, i + 1))
                os.replace(self._jsonl_path, self._jsonl_path + ".1")
            except OSError:
                pass  # degrade: append past the cap rather than drop data

    def _write_once(self):
        if self._timelines:
            # the SLO engine, a listener of the store, evaluates on this same tick; a
            # failed sample must not cost the flush
            try:
                self._registry.sample_timelines()
            except Exception:  # noqa: BLE001 — flushing beats sampling
                from petastorm_tpu_torch.obs.log import degradation

                degradation("timeline_sample_error",
                            "timeline sampling failed on the Reporter cadence; "
                            "snapshots continue without windows")
        if self._prom_path is not None:
            write_prometheus(self._prom_path, self._registry)
        if self._jsonl_path is not None:
            line = json.dumps({"schema": self.SCHEMA, "ts": time.time(),
                               "perf": time.perf_counter(),
                               "anchor": self._anchor,
                               "metrics": self._registry.snapshot()}) + "\n"
            self._maybe_rotate(len(line))
            with open(self._jsonl_path, "a") as f:
                f.write(line)

    def _run(self):
        while not self._stop_event.wait(self._interval_s):
            try:
                self._write_once()
            except OSError:
                pass  # a full/removed disk must not kill the reporter loop

    def start(self):
        self._stop_event.clear()
        _install_exit_hooks()
        with _live_lock:
            if self not in _live_reporters:
                _live_reporters.append(self)
        self._thread = threading.Thread(target=self._run, name="ptpu-obs-report",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop_event.set()
        with _live_lock:
            if self in _live_reporters:
                _live_reporters.remove(self)
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=10)
        try:
            self._write_once()  # final snapshot: short runs leave a record too
        except OSError:
            pass

    def __enter__(self):
        return self.start()

    def __exit__(self, exc_type, exc, tb):
        self.stop()


def read_latest_jsonl_snapshot(path):
    """Last well-formed ``{"ts", "metrics"}`` object in a Reporter JSONL stream
    (tolerates a torn final line from a live writer); None when none exists."""
    recent = read_recent_jsonl_snapshots(path, limit=1)
    return recent[-1] if recent else None


def read_recent_jsonl_snapshots(path, limit=64):
    """Last ``limit`` well-formed snapshot objects, oldest first (tolerates torn
    lines)."""
    from collections import deque

    recent = deque(maxlen=max(1, int(limit)))
    with open(path, "r") as f:
        for line in f:
            try:
                obj = json.loads(line)
            except ValueError:
                continue
            if isinstance(obj, dict) and "metrics" in obj:
                recent.append(obj)
    return list(recent)
