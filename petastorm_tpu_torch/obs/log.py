"""Structured degradation log: one logger, one counter family, warn-once policy.

Port of ``petastorm_tpu.obs.log``. Every graceful-degradation path of the port goes
through :func:`degradation`:

- logged on the ``petastorm_tpu_torch.obs`` logger with a machine-greppable
  ``[degradation cause=<cause>]`` suffix, once per cause by default (repeat occurrences
  stay countable without scrolling the log);
- counted on the process-wide registry as ``ptpu_degradations_total{cause="<cause>"}``
  on EVERY call, so the Prometheus export shows the rate after the log went quiet;
- mirrored into every live flight recorder (:mod:`petastorm_tpu_torch.obs.flight`).

The causes are the JAX package's slugs where the port degrades the same way: the wire
(``shm_unsupported``, ``shm_ring_create_failed``, ``shm_view_copyout``), the process
pool (``worker_died``, ``respawn_failed``), the read path (``readahead_unavailable``,
``readahead_fallback``, ``memcache_oversized``, ``disk_cache``, ``remote_unavailable``),
the recovery policy (``io_retry``, ``quarantined``, ``footer_unreadable``), the chaos
plane (``chaos_injected``), the host-wide cache arena (``arena_unavailable``,
``arena_full``, ``arena_lease_revoked``) and the dataset watch (``dataset_mutated``: the
watcher saw a removal or a rewrite under a running reader; ``piece_removed`` and
``piece_rewritten``: a plan item quarantined because its file vanished or changed
generation; ``watch_error``: a watch tick failed, in its scan, its mutate hook or
applying its delta).
:func:`petastorm_tpu_torch.parallel.shm_ring.degradation` is this function.
"""
from __future__ import annotations

import logging
import threading

from petastorm_tpu_torch.obs import flight as _flight
from petastorm_tpu_torch.obs.metrics import default_registry

logger = logging.getLogger("petastorm_tpu_torch.obs")

_lock = threading.Lock()
_announced = set()
_counters = {}  # cause -> Counter, resolved once (hot sites pay one inc())


def _counter(cause):
    counter = _counters.get(cause)
    if counter is None:
        # get-or-create is idempotent, so a racing double-resolve is harmless
        counter = default_registry().counter(
            "ptpu_degradations_total",
            help="graceful-degradation events by cause", cause=cause)
        with _lock:
            _counters[cause] = counter
    return counter


def degradation(cause, message, *args, once=True, level=logging.WARNING):
    """Count + log one degradation occurrence.

    ``cause`` is a short stable slug (the metric label). ``message``/``args``
    are lazy %-formatted like stdlib logging. ``once=True`` (default) logs the
    first occurrence per cause per process and only counts the rest;
    ``once=False`` logs every time (worker deaths, where each event matters).
    Repeat calls for a known cause cost one ``Counter.inc()`` — per-item
    degradation paths (shm view copy-out) stay cheap.

    When a health monitor is live, every occurrence is also mirrored
    into its flight-recorder ring so the record written at a stall/crash shows
    which degradations led up to it (one deque append; no monitor = one empty
    list from :func:`petastorm_tpu_torch.obs.flight.active_recorders`).
    """
    _counter(cause).inc()
    for recorder in _flight.active_recorders():
        recorder.record("degradation", cause=cause)
    if once:
        with _lock:
            if cause in _announced:
                return
            _announced.add(cause)
    logger.log(level, message + " [degradation cause=%s]", *(args + (cause,)))


def degradation_counts():
    """``{cause: count}`` so far this process (CLI / test hook)."""
    snap = default_registry().snapshot()
    out = {}
    prefix = "ptpu_degradations_total{cause="
    for name, value in snap.items():
        if name.startswith(prefix):
            out[name[len(prefix):].strip('"}')] = value
    return out


def _reset_announced_for_tests():
    with _lock:
        _announced.clear()
