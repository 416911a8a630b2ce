"""Recovery policy and poison-item quarantine for the read pipeline.

Port of ``petastorm_tpu.recovery``: one picklable policy struct,
:class:`RecoveryOptions`, handed from the reader factories to every layer (transient-IO
retry on the workers' sync, readahead and coalesced reads; the process pool's respawn
budget; the poison policy of every pool), with the JAX package's fields, defaults and
environment names. The ``link_*`` fields are accepted and carried; the tcp transport
that reads them is ROADMAP.md Queue 1 item 4(c).

A poison item is a plan item that repeatedly fails or kills workers: a corrupt row
group, a page that fails to parse. With ``on_poison="quarantine"`` the item is skipped
after ``poison_attempts`` failures, listed in a :class:`QuarantineReport` on
``Reader``/``DataLoader``, counted as ``ptpu_quarantined_{items,rows}_total``, and
charged to the reader's consumed-work map, so a checkpoint resume neither replays nor
loses it. Every planned row is either delivered exactly once or listed in the report.

``on_poison="raise"`` (the default) keeps the historical contract: the first worker
exception propagates, and a dead child past the respawn budget raises
:class:`~petastorm_tpu_torch.errors.WorkerDiedError` carrying the original failure.
"""
from __future__ import annotations

import os
import threading



def _env_int(name, default):
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        return int(raw)
    except ValueError:
        return default


def _env_float(name, default):
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        return float(raw)
    except ValueError:
        return default


class RecoveryOptions:
    """One policy struct for every recovery layer (picklable — it crosses the
    process-pool handshake inside the worker).

    ==================  ==========================  ===========================
    field               env var                     meaning
    ==================  ==========================  ===========================
    io_retries          PTPU_IO_RETRIES             extra attempts on transient
                                                    IO errors, identical budget
                                                    on the sync, readahead and
                                                    coalesced read paths
                                                    (default 2; 0 = fail fast)
    io_retry_backoff_s  PTPU_IO_RETRY_BACKOFF_S     base of the jittered
                                                    exponential backoff
                                                    (default 0.1)
    io_retry_max_       PTPU_IO_RETRY_MAX_          cap on a single backoff
    backoff_s           BACKOFF_S                   sleep (default 30.0)
    read_deadline_s     PTPU_READ_DEADLINE_S        wall-clock cap across ALL
                                                    attempts of one read; past
                                                    it the last error raises
                                                    without further retries
                                                    (default 0 = no deadline)
    worker_respawns     PTPU_WORKER_RESPAWNS        process-pool elastic-
                                                    recovery budget (default 2;
                                                    0 = fail fast)
    on_poison           PTPU_ON_POISON              'raise' (default) or
                                                    'quarantine': skip an item
                                                    that repeatedly kills or
                                                    wedges workers
    poison_attempts     PTPU_POISON_ATTEMPTS        failures of ONE plan item
                                                    (tracked per plan ordinal,
                                                    across respawns and heals)
                                                    before it is quarantined
                                                    (default 2)
    link_heartbeat_s    PTPU_LINK_HEARTBEAT_S       framed-transport (tcp)
                                                    heartbeat cadence per
                                                    direction (default 2.0)
    link_miss_threshold PTPU_LINK_MISS_THRESHOLD    consecutive missed
                                                    heartbeat intervals before
                                                    a quiet link is declared
                                                    half-open and torn down
                                                    (default 3)
    link_reconnect_s    PTPU_LINK_RECONNECT_S       ceiling on one reconnect
                                                    wait after a link death —
                                                    the child redials with
                                                    jittered exponential
                                                    backoff (base
                                                    io_retry_backoff_s) under
                                                    this cap; past it the link
                                                    is a dead child
                                                    (default 10.0)
    link_connect_       PTPU_LINK_CONNECT_          bound on a single tcp
    timeout_s           TIMEOUT_S                   connect/hello exchange
                                                    (default 10.0)
    ==================  ==========================  ===========================
    """

    __slots__ = ("io_retries", "io_retry_backoff_s", "io_retry_max_backoff_s",
                 "read_deadline_s", "worker_respawns", "on_poison",
                 "poison_attempts", "link_heartbeat_s", "link_miss_threshold",
                 "link_reconnect_s", "link_connect_timeout_s")

    def __init__(self, io_retries=None, io_retry_backoff_s=None,
                 io_retry_max_backoff_s=None, read_deadline_s=None,
                 worker_respawns=None, on_poison=None, poison_attempts=None,
                 link_heartbeat_s=None, link_miss_threshold=None,
                 link_reconnect_s=None, link_connect_timeout_s=None):
        self.io_retries = max(0, _env_int("PTPU_IO_RETRIES", 2)
                              if io_retries is None else int(io_retries))
        self.io_retry_backoff_s = max(
            0.0, _env_float("PTPU_IO_RETRY_BACKOFF_S", 0.1)
            if io_retry_backoff_s is None else float(io_retry_backoff_s))
        self.io_retry_max_backoff_s = max(
            0.0, _env_float("PTPU_IO_RETRY_MAX_BACKOFF_S", 30.0)
            if io_retry_max_backoff_s is None else float(io_retry_max_backoff_s))
        self.read_deadline_s = max(
            0.0, _env_float("PTPU_READ_DEADLINE_S", 0.0)
            if read_deadline_s is None else float(read_deadline_s))
        self.worker_respawns = max(0, _env_int("PTPU_WORKER_RESPAWNS", 2)
                                   if worker_respawns is None
                                   else int(worker_respawns))
        on_poison = (os.environ.get("PTPU_ON_POISON") or "raise") \
            if on_poison is None else on_poison
        if on_poison not in ("raise", "quarantine"):
            raise ValueError("on_poison must be 'raise' or 'quarantine', got %r"
                             % (on_poison,))
        self.on_poison = on_poison
        self.poison_attempts = max(1, _env_int("PTPU_POISON_ATTEMPTS", 2)
                                   if poison_attempts is None
                                   else int(poison_attempts))
        # framed-transport link policy: heartbeat cadence, half-open
        # detection threshold, and the reconnect/connect bounds the tcp
        # transport derives its jittered backoff ceiling from
        self.link_heartbeat_s = max(
            0.05, _env_float("PTPU_LINK_HEARTBEAT_S", 2.0)
            if link_heartbeat_s is None else float(link_heartbeat_s))
        self.link_miss_threshold = max(
            1, _env_int("PTPU_LINK_MISS_THRESHOLD", 3)
            if link_miss_threshold is None else int(link_miss_threshold))
        self.link_reconnect_s = max(
            0.1, _env_float("PTPU_LINK_RECONNECT_S", 10.0)
            if link_reconnect_s is None else float(link_reconnect_s))
        self.link_connect_timeout_s = max(
            0.1, _env_float("PTPU_LINK_CONNECT_TIMEOUT_S", 10.0)
            if link_connect_timeout_s is None
            else float(link_connect_timeout_s))

    @classmethod
    def normalize(cls, value):
        """``None`` → defaults (env-aware), dict → kwargs, RecoveryOptions →
        itself (same contract as ``IoOptions.normalize``)."""
        if value is None:
            return cls()
        if isinstance(value, cls):
            return value
        if isinstance(value, dict):
            return cls(**value)
        raise TypeError("recovery must be a RecoveryOptions, a dict of its "
                        "fields, or None; got %r" % type(value).__name__)

    @classmethod
    def resolve(cls, recovery, **legacy):
        """Factory-side merge: normalize ``recovery`` and overlay the legacy
        per-kwarg knobs (``io_retries=``/``io_retry_backoff_s=``/
        ``worker_respawns=`` on ``make_reader``) where the caller passed one
        explicitly (non-None) — explicit legacy kwargs win over the struct so
        existing call sites keep their exact behavior."""
        explicit = {k: v for k, v in legacy.items() if v is not None}
        if recovery is None and not explicit:
            return cls()
        base = cls.normalize(recovery)
        if not explicit:
            return base
        merged = {name: getattr(base, name) for name in cls.__slots__}
        merged.update(explicit)
        return cls(**merged)

    @property
    def quarantine(self):
        return self.on_poison == "quarantine"

    def __getstate__(self):
        return {name: getattr(self, name) for name in self.__slots__}

    def __setstate__(self, state):
        for name in self.__slots__:
            # .get: tolerate pickles from an older RecoveryOptions missing a
            # newer field (a child on a stale worker image keeps the default)
            setattr(self, name, state.get(name, getattr(type(self)(), name)))

    def __repr__(self):
        return "RecoveryOptions(%s)" % ", ".join(
            "%s=%r" % (name, getattr(self, name)) for name in self.__slots__)


class QuarantinedItem:
    """Executor→reader marker: this plan item was quarantined instead of
    delivered. Rides the results queue like a result; the ``Reader`` absorbs
    it (marks the ordinal consumed, records it in the report) and never yields
    it to the consumer."""

    __slots__ = ("item", "error", "attempts", "kind")

    def __init__(self, item, error, attempts, kind="exception"):
        self.item = item          # the dispatched (epoch, ordinal, work) tuple
        self.error = error        # the LAST failure (original exception chain)
        self.attempts = attempts  # how many times the item was tried
        self.kind = kind          # 'exception' | 'child_death' | 'link_death'
        #                           | 'wire_decode'

    def __repr__(self):
        return "<QuarantinedItem attempts=%d kind=%s error=%r>" % (
            self.attempts, self.kind, self.error)


class QuarantineEntry:
    """One quarantined plan item, with everything an operator needs to find
    the bad data: plan identity, file identity, and the failure chain."""

    __slots__ = ("epoch", "ordinal", "path", "row_group", "num_rows", "error",
                 "attempts", "kind")

    def __init__(self, epoch, ordinal, path, row_group, num_rows, error,
                 attempts, kind):
        self.epoch = epoch
        self.ordinal = ordinal
        self.path = path
        self.row_group = row_group
        self.num_rows = num_rows  # -1 when the footer was never readable
        self.error = error
        self.attempts = attempts
        self.kind = kind

    def as_dict(self):
        return {"epoch": self.epoch, "ordinal": self.ordinal,
                "path": self.path, "row_group": self.row_group,
                "num_rows": self.num_rows, "attempts": self.attempts,
                "kind": self.kind, "error": _format_error_chain(self.error)}

    def __repr__(self):
        return "<QuarantineEntry %s rg=%s ordinal=%s attempts=%d %s>" % (
            self.path, self.row_group, self.ordinal, self.attempts,
            self.kind)


def _format_error_chain(err):
    """``repr`` of an exception plus its ``__cause__``/``__context__`` chain —
    the quarantine report must show the ORIGINAL failure, not just the last
    wrapper."""
    parts = []
    seen = set()
    while err is not None and id(err) not in seen:
        seen.add(id(err))
        parts.append("%s: %s" % (type(err).__name__, err))
        err = err.__cause__ or err.__context__
    return " <- ".join(parts) if parts else ""


class QuarantineReport:
    """Every item this reader quarantined (thread-safe accumulation — markers
    arrive on the consumer thread but the report may be read from anywhere).
    Falsy when empty, so ``if reader.quarantine_report():`` reads naturally."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries = []

    def add(self, entry):
        with self._lock:
            self._entries.append(entry)

    @property
    def entries(self):
        with self._lock:
            return list(self._entries)

    def __len__(self):
        with self._lock:
            return len(self._entries)

    def __bool__(self):
        return len(self) > 0

    def __iter__(self):
        return iter(self.entries)

    def ordinals(self):
        """``{(epoch, ordinal), ...}`` of quarantined plan items — what the
        chaos harness diffs against the delivered set."""
        with self._lock:
            return {(e.epoch, e.ordinal) for e in self._entries}

    def as_dict(self):
        return {"quarantined": [e.as_dict() for e in self.entries]}

    def render(self):
        entries = self.entries
        if not entries:
            return "quarantine report: empty (every planned item delivered)"
        lines = ["quarantine report: %d item(s) skipped" % len(entries)]
        for e in entries:
            lines.append(
                "  epoch=%s ordinal=%s %s row group %s (%s after %d attempts)"
                % (e.epoch, e.ordinal, e.path, e.row_group, e.kind, e.attempts))
            chain = _format_error_chain(e.error)
            if chain:
                lines.append("    %s" % chain)
        return "\n".join(lines)


_metrics_lock = threading.Lock()
_metrics = None


def _quarantine_metrics():
    global _metrics
    if _metrics is None:
        with _metrics_lock:
            if _metrics is None:
                from petastorm_tpu_torch.obs.metrics import default_registry

                reg = default_registry()
                _metrics = (
                    reg.counter("ptpu_quarantined_items_total",
                                help="plan items skipped as poison "
                                     "(quarantined instead of delivered)"),
                    reg.counter("ptpu_quarantined_rows_total",
                                help="rows in quarantined row groups "
                                     "(by footer metadata)"),
                )
    return _metrics


def count_quarantined(rows):
    """Bump ``ptpu_quarantined_items_total`` (and rows, when the footer row
    count is known)."""
    items, row_counter = _quarantine_metrics()
    items.inc()
    if rows and rows > 0:
        row_counter.inc(int(rows))
