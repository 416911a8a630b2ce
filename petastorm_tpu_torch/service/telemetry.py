"""Fleet telemetry and the autoscaling sensor of the data service.

Port of ``petastorm_tpu.service.telemetry``: two read-only planes over a
:class:`~petastorm_tpu_torch.service.server.DataService`.

- :class:`FleetTelemetry` keeps the latest ``/timelines``-shaped export each peer sent
  on its frames (decode workers on lease replies, trainers on ``want``) and assembles
  the ``GET /fleet`` document: the service's own export merged with every peer's on
  anchored clocks (:func:`~petastorm_tpu_torch.obs.timeseries.merge_exports`), the
  health of each worker (outstanding leases and the oldest one's age, decode p50/p99,
  idle share, tenants served), and the straggler and advice state.
- :class:`FleetAdvisor` rides the TimelineStore's listener cadence (the seam the SLO
  engine attaches to) and computes an advised fleet size from the starvation, idle and
  burn-rate windows and the straggler p99s of each worker. It publishes
  ``ptpu_svc_advised_workers`` and a ``svc_advise`` flight event at every change: a
  sensor only, with no actuator.
"""
from __future__ import annotations

import math
import os
import threading
import time
from collections import deque

from petastorm_tpu_torch.obs.slo import strip_label

#: worker-labeled series the advisor and the health panel read
WORKER_DECODE_HIST = "ptpu_svc_worker_decode_seconds"
WORKER_IDLE_TOTAL = "ptpu_svc_worker_idle_seconds_total"


class FleetTelemetry:
    """Latest-export store + ``/fleet`` document assembly for one service."""

    def __init__(self, service, registry):
        self._service = service
        self._registry = registry
        self._lock = threading.Lock()
        self._peers = {}  # (kind, name) -> latest export document

    def note_peer(self, kind, name, doc):
        """Absorb one piggybacked export (``kind`` = worker|trainer). Only
        the latest document per peer is kept — telemetry is a level, not a
        log."""
        if not isinstance(doc, dict):
            return
        with self._lock:
            self._peers[(kind, str(name))] = doc

    def drop_peer(self, kind, name):
        with self._lock:
            self._peers.pop((kind, str(name)), None)

    def peer_exports(self):
        with self._lock:
            return dict(self._peers)

    def document(self):
        """The ``GET /fleet`` JSON document. Pull-model: assembled per
        request from the latest state — nothing here runs on a hot path."""
        from petastorm_tpu_torch.obs.timeseries import (
            export_document,
            export_to_merge_shape,
            merge_exports,
        )

        own = export_document(self._registry,
                              extra={"source": "service:%d" % os.getpid()})
        exports = [export_to_merge_shape(own)]
        for (kind, name), doc in sorted(self.peer_exports().items()):
            exports.append(export_to_merge_shape(
                doc, fallback_source="%s:%s" % (kind, name)))
        return {
            "schema": "ptpu-svc-fleet-v1",
            "ts": time.time(),
            "workers": self._service.worker_health(),
            "advice": self._service.advice(),
            "alerts": self._service.straggler_alerts(),
            "fleet": merge_exports(exports),
            "sources": [e["source"] for e in exports],
        }


class FleetAdvisor:
    """Advised-fleet-size sensor on the TimelineStore listener cadence.

    Per sampled window, with ``actual`` the connected-worker gauge:

    - **stragglers**: every worker whose window decode p99 exceeds
      ``straggler_p99_s`` is effectively lost capacity — advise a
      replacement for each (the same threshold the straggler SLO debounces
      on, so the alert and the advice agree on who is slow);
    - **burn**: when trainers starved (``ptpu_svc_starved_seconds_total``
      rate above ``starved_hi`` seconds-per-second) while the fleet ran hot
      (decode burn-rate ≥ ``util_hi`` × actual), add the starvation rate's
      ceiling — the fleet undersupplied attached demand;
    - **idle**: with no stragglers and no starvation, a mean per-worker idle
      share above ``idle_hi`` advises shrinking toward the busy core.

    The published value is the median of the last ``smooth`` windows (one
    anomalous window cannot flap the advice), clamped to
    ``[min_workers, max_workers]``.
    """

    def __init__(self, registry, straggler_p99_s=None, min_workers=1,
                 max_workers=64, starved_hi=0.05, idle_hi=0.6, util_hi=0.8,
                 smooth=3):
        from petastorm_tpu_torch.service.protocol import svc_metrics

        self._registry = registry
        self._gauge = svc_metrics(registry)["advised_workers"]
        self._straggler_s = straggler_p99_s
        self._min = max(0, int(min_workers))
        self._max = int(max_workers)
        self._starved_hi = float(starved_hi)
        self._idle_hi = float(idle_hi)
        self._util_hi = float(util_hi)
        self._history = deque(maxlen=max(1, int(smooth)))
        self._published = None
        self.last_detail = None
        self._store = None
        self._listener = None

    # -- wiring ---------------------------------------------------------------------

    def attach(self, store):
        self.detach()
        self._store = store
        self._listener = store.add_listener(self._on_window)
        return self

    def detach(self):
        store, self._store = self._store, None
        if store is not None and self._listener is not None:
            store.remove_listener(self._listener)
        self._listener = None

    # -- the window fold ------------------------------------------------------------

    def _on_window(self, window, t):
        advised, detail = self._advise(window)
        if advised is None:
            return
        self._history.append(advised)
        ordered = sorted(self._history)
        smoothed = ordered[len(ordered) // 2]
        self._gauge.set(smoothed)
        self.last_detail = dict(detail, advised=smoothed, t=t)
        if smoothed != self._published:
            self._published = smoothed
            self._emit(smoothed, detail)

    def _emit(self, advised, detail):
        from petastorm_tpu_torch.obs import flight as _flight

        for recorder in _flight.active_recorders():
            recorder.record("svc_advise", advised=advised, **detail)

    def _advise(self, window):
        point = window.get("ptpu_svc_workers")
        actual = None if point is None else point.get("value")
        if not actual:
            return None, None  # no fleet connected: nothing to advise
        actual = int(actual)
        starved = (window.get("ptpu_svc_starved_seconds_total")
                   or {}).get("rate") or 0.0
        busy = (window.get("ptpu_svc_decode_seconds_total")
                or {}).get("rate") or 0.0
        util = busy / actual
        stragglers = []
        idle_shares = []
        for series, p in window.items():
            base, worker = strip_label(series, "worker")
            if worker is None:
                continue
            if base == WORKER_DECODE_HIST:
                p99 = p.get("p99")
                if self._straggler_s is not None and p.get("count", 0) >= 1 \
                        and p99 is not None and p99 > self._straggler_s:
                    stragglers.append(worker)
            elif base == WORKER_IDLE_TOTAL:
                rate = p.get("rate")
                if rate is not None:
                    idle_shares.append(min(1.0, rate))
        advised = actual + len(stragglers)
        if starved > self._starved_hi and util >= self._util_hi:
            advised += max(1, int(math.ceil(starved)))
        idle_share = (sum(idle_shares) / len(idle_shares)) \
            if idle_shares else 0.0
        if not stragglers and starved <= self._starved_hi \
                and idle_share > self._idle_hi:
            advised = min(advised,
                          max(self._min,
                              actual - int(actual * (idle_share - 0.5))))
        advised = max(self._min, min(self._max, advised))
        return advised, {
            "actual": actual,
            "stragglers": sorted(stragglers),
            "starved_rate": round(starved, 4),
            "idle_share": round(idle_share, 3),
            "util": round(util, 3),
        }
