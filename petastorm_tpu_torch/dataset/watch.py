"""The dataset-watch plane: generation tokens and mutation detection.

Port of ``petastorm_tpu.dataset.watch``. A reader built without it assumes a frozen
dataset: a plan from one footer scan, caches validated by file size, closed epochs. An
append-heavy store (new Parquet files land, old ones are rewritten or deleted while a
job trains) needs mutation to be an accounted event, not a stale cache or an
unclassified crash:

- **Generation tokens**: every file gets an identity string
  ``"<size>.<mtime_ns>.<footer crc>"`` stamped into its plan items
  (:func:`stamp_generation_tokens` sets ``RowGroupPiece.generation``). The token rides
  into every read (checked on each attempt), every cache key (memory, disk, readahead:
  a rewritten file maps to new keys, so a stale decoded payload is unreachable even when
  size and mtime collide), the footer cache (``FooterEntry.stat_token``) and the
  statistics cache's fingerprint.
- :class:`DatasetWatcher`: a thread a reader that lists the dataset every
  ``interval_s``, diffs it against its snapshot and emits a :class:`PlanDelta` (added,
  removed, rewritten). The reader extends its :class:`~petastorm_tpu_torch.plan.EpochPlan`
  with added pieces in the current epoch, defers a rewritten file's new generation to
  the next epoch (no epoch mixes two generations of a file), and drops the removed and
  rewritten pieces' cache entries. Deltas are counted
  (``ptpu_dataset_{pieces_added,pieces_removed,pieces_rewritten,plan_extensions,
  generation_conflicts}_total``) and mirrored into any live flight recorder.
- **Chaos**: each tick evaluates the ``dataset.mutate`` site when a mutator is attached,
  so a seeded ``FaultPlan`` with ``remove_file``, ``rewrite_file`` or ``append_piece``
  rules replays the same mutations at the same ticks
  (:mod:`petastorm_tpu_torch.dataset.mutate`).

The read-time check is ``_WorkerBase._verify_generation`` in
:mod:`petastorm_tpu_torch.reader`: a deleted file raises
:class:`~petastorm_tpu_torch.errors.PieceRemovedError`, a token mismatch drops the
piece's footer, handle and cache entries and raises
:class:`~petastorm_tpu_torch.errors.PieceRewrittenError`; both quarantine under the
recovery policy with their own causes (``piece_removed``, ``piece_rewritten``), charged
to the checkpoint watermark, so every row is delivered once or quarantined.
"""
from __future__ import annotations

import os
import threading

from petastorm_tpu_torch import chaos as _chaos
from petastorm_tpu_torch.io.remote import _env_float

#: token part separator; a token is "<size>.<mtime_ns>.<crc8hex or ->"
_SEP = "."


def _with_crc(stat, crc=None):
    """The full token from a stat half and an optional crc: the one encoding point (the
    stamping, the watcher's scan and the read-time check compare tokens built here)."""
    return "%s%s%s" % (stat, _SEP, ("%08x" % crc) if crc is not None else "-")


def _format_token(size, mtime_ns, crc=None):
    return _with_crc("%s%s%s" % (size, _SEP, mtime_ns), crc)


def _split(token):
    """``(stat_part, crc_part)`` of a token (crc_part may be ``'-'``)."""
    stat, _, crc = token.rpartition(_SEP)
    return stat, crc


def stat_token_of(token):
    """The ``"<size>.<mtime_ns>"`` half of a full generation token."""
    return _split(token)[0]


def current_stat_token(fs, path, info=None):
    """The file's stat identity now, or :class:`~petastorm_tpu_torch.errors
    .PieceRemovedError` when it is gone."""
    import pyarrow.fs as pafs

    from petastorm_tpu_torch.errors import PieceRemovedError

    if info is None:
        info = fs.get_file_info(path)
    if info.type == pafs.FileType.NotFound:
        raise PieceRemovedError("dataset file removed under a running reader: %s" % path)
    mtime = getattr(info, "mtime_ns", None)
    if mtime is None:  # filesystems without ns stamps: the datetime's second
        dt = getattr(info, "mtime", None)
        mtime = int(dt.timestamp() * 1e9) if dt is not None else 0
    return "%s%s%s" % (info.size, _SEP, mtime)


def generation_token(fs, path, footer_crc=True, info=None, fresh=False):
    """The file's full generation token: its stat identity and (optionally) the footer
    crc, through the shared footer cache pinned to exactly this stat identity, so a
    stale parse of another generation cannot leak in.

    ``fresh=True`` drops any cached footer first: the one hole stat pinning leaves is a
    rewrite that collides on size and mtime while a parse of the predecessor is still
    cached, so reader construction pays one footer read a file to stamp tokens that
    describe the bytes as they are now."""
    stat = current_stat_token(fs, path, info=info)
    if not footer_crc:
        return _format_token(*stat.split(_SEP))
    from petastorm_tpu_torch.io.footercache import shared_footer_cache

    footers = shared_footer_cache()
    if fresh:
        footers.invalidate(path)
    entry = footers.get(fs, path, stat_token=stat)
    return _with_crc(stat, entry.crc)


def tokens_match(stamped, observed):
    """Do two generation tokens name the same generation of a file? ``None`` on either
    side means unknown and matches; a ``'-'`` crc half matches any crc (stat-only
    tokens)."""
    if stamped is None or observed is None:
        return True
    if stamped == observed:
        return True
    a_stat, a_crc = _split(stamped)
    b_stat, b_crc = _split(observed)
    if a_stat != b_stat:
        return False
    return a_crc == "-" or b_crc == "-" or a_crc == b_crc


def stamp_generation_tokens(fs, pieces, footer_crc=True):
    """``pieces`` with each one's ``generation`` stamped: one stat and one fresh footer
    parse a file (a cached parse of a stat-colliding predecessor must not vouch for the
    current bytes). A file that cannot be tokenized (removed while stamping, an
    unreadable footer) keeps ``generation=None``: its reads go unchecked and fail on
    their own terms."""
    tokens = {}
    out = []
    for piece in pieces:
        tok = tokens.get(piece.path)
        if tok is None and piece.path not in tokens:
            try:
                tok = generation_token(fs, piece.path, footer_crc=footer_crc, fresh=True)
            except Exception as e:  # noqa: BLE001 — stamping is best effort
                from petastorm_tpu_torch.obs.log import degradation

                degradation("watch_error", "could not stamp a generation token for %s "
                            "(%s); reads of it proceed unchecked", piece.path, e)
                tok = None
            tokens[piece.path] = tok
        out.append(piece._replace(generation=tok) if tok is not None else piece)
    return out


class WatchOptions:
    """Knobs of the dataset-watch plane (``watch=`` on the reader factories: ``True``,
    a dict of the fields or an instance).

    ==============  ========================  ===============================
    field           environment variable      meaning
    ==============  ========================  ===============================
    interval_s      PTPU_WATCH_INTERVAL_S     seconds between watch ticks
                                              (default 5.0, at least 0.05)
    footer_crc      PTPU_WATCH_FOOTER_CRC     put the footer crc in the
                                              generation tokens (default on;
                                              off: stat-only tokens, one
                                              footer read a file less)
    ==============  ========================  ===============================
    """

    __slots__ = ("interval_s", "footer_crc")

    def __init__(self, interval_s=None, footer_crc=None):
        self.interval_s = max(0.05, _env_float("PTPU_WATCH_INTERVAL_S", 5.0)
                              if interval_s is None else float(interval_s))
        if footer_crc is None:
            footer_crc = (os.environ.get("PTPU_WATCH_FOOTER_CRC", "1")
                          not in ("0", "false", "no"))
        self.footer_crc = bool(footer_crc)

    @classmethod
    def normalize(cls, value):
        """``None``/``False``: None (no watching); ``True``: the defaults; a dict: its
        fields; an instance: itself."""
        if value is None or value is False:
            return None
        if value is True:
            return cls()
        if isinstance(value, cls):
            return value
        if isinstance(value, dict):
            return cls(**value)
        raise TypeError("watch must be a WatchOptions, a dict of its fields, True/False, "
                        "or None; got %r" % type(value).__name__)


class PlanDelta:
    """One watch tick's mutations. ``added``: the new files' pieces (stamped).
    ``removed``: ``(path, old_pieces)``. ``rewritten``: ``(path, old_pieces,
    new_pieces)``, the old generation's pieces (to invalidate) and the new generation's
    stamped pieces (to plan into a later epoch)."""

    __slots__ = ("added", "removed", "rewritten")

    def __init__(self, added=(), removed=(), rewritten=()):
        self.added = list(added)
        self.removed = list(removed)
        self.rewritten = list(rewritten)

    def __bool__(self):
        return bool(self.added or self.removed or self.rewritten)

    def __repr__(self):
        return "<PlanDelta +%d pieces, -%d files, ~%d files>" % (
            len(self.added), len(self.removed), len(self.rewritten))


_metrics_lock = threading.Lock()
_metrics = None


def watch_metrics():
    """The ``ptpu_dataset_*`` counters on the process-wide registry (resolved once)."""
    global _metrics
    if _metrics is None:
        with _metrics_lock:
            if _metrics is None:
                from petastorm_tpu_torch.obs.metrics import default_registry

                reg = default_registry()
                _metrics = {
                    "pieces_added": reg.counter(
                        "ptpu_dataset_pieces_added_total",
                        help="row-group pieces discovered by the dataset watcher and "
                             "appended to a live plan"),
                    "pieces_removed": reg.counter(
                        "ptpu_dataset_pieces_removed_total",
                        help="row-group pieces whose file disappeared under a running "
                             "reader"),
                    "pieces_rewritten": reg.counter(
                        "ptpu_dataset_pieces_rewritten_total",
                        help="row-group pieces whose file changed generation under a "
                             "running reader"),
                    "plan_extensions": reg.counter(
                        "ptpu_dataset_plan_extensions_total",
                        help="EpochPlan.extend calls applied by the watcher"),
                    "generation_conflicts": reg.counter(
                        "ptpu_dataset_generation_conflicts_total",
                        help="reads that found a generation-token mismatch (file "
                             "rewritten between plan and read)"),
                }
    return _metrics


class DatasetWatcher:
    """Polls a dataset for piece-set mutations and reports :class:`PlanDelta` objects.

    One a watching :class:`~petastorm_tpu_torch.reader.Reader`, which primes it with the
    factory's stamped pieces and wires ``on_delta`` to its plan-extension seam. The scan
    lists the real files (not the row-group counts of the store's metadata, which never
    learn of an appended file) and reads footers only for new or changed paths, so a
    quiet tick costs one listing and one stat a file. A new or changed file is stat'ed
    again after its footer is read and left for the next tick if it moved meanwhile (a
    writer that has not finished), so a token never pairs a half-written file's stat with
    the finished file's footer.

    With a mutator attached (:meth:`set_mutator`, the chaos plane's seam) each tick
    first evaluates the ``dataset.mutate`` chaos site, so seeded mutation scenarios
    count ticks from the moment they are armed.
    """

    def __init__(self, fs, path, options=None, on_delta=None):
        if isinstance(path, list):
            raise ValueError("dataset watching supports a single dataset path, got a "
                             "list of %d" % len(path))
        self._fs = fs
        self._path = path
        self._opts = options if options is not None else WatchOptions()
        self._on_delta = on_delta
        self._snapshot = None  # path -> (token, [pieces])
        self._mutator = None
        self._thread = None
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._ticks = 0
        self._deltas = 0
        self._errors = 0

    # -- lifecycle ----------------------------------------------------------------------

    def start(self):
        """Start (or restart after :meth:`stop`) the watch thread."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            self._stop.clear()
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="ptpu-torch-dataset-watch")
            self._thread.start()

    def stop(self):
        with self._lock:
            thread, self._thread = self._thread, None
        self._stop.set()
        if thread is not None:
            thread.join(timeout=30.0)

    def _run(self):
        while not self._stop.wait(self._opts.interval_s):
            self.poll_once()

    # -- wiring -------------------------------------------------------------------------

    def set_mutator(self, mutator):
        """Attach the chaos plane's dataset mutator: from the next tick on, the
        ``dataset.mutate`` site is evaluated with it as the payload."""
        self._mutator = mutator

    def prime(self, pieces, known_paths=None):
        """Seed the snapshot from the factory's stamped plan pieces, so the first tick
        diffs against the plan, not a rescan.

        ``known_paths``: every dataset file that existed at plan time, those that
        plan-time selection (filters, hive partitions, row-group selectors) kept out of
        the plan included. They enter the snapshot as inert entries, so the first tick
        does not take them for appended files and re-add what the selection excluded;
        they stay unwatched."""
        snapshot = {}
        for piece in pieces:
            tok, existing = snapshot.get(piece.path, (piece.generation, []))
            existing.append(piece)
            snapshot[piece.path] = (tok, existing)
        for path in known_paths or ():
            snapshot.setdefault(path, (None, []))
        self._snapshot = snapshot

    # -- one tick -----------------------------------------------------------------------

    def poll_once(self):
        """One tick: the chaos site, a rescan, the diff, the accounting and the
        notification. Returns the :class:`PlanDelta` (empty on a quiet tick), or
        ``None`` when the tick failed (counted and logged as ``watch_error``)."""
        self._ticks += 1
        if _chaos.ACTIVE is not None and self._mutator is not None:
            try:
                _chaos.ACTIVE.hit("dataset.mutate", key="tick=%d" % self._ticks,
                                  payload=self._mutator)
            except Exception as e:  # noqa: BLE001 — a bad mutate rule must not end the
                # watch thread: the scenario sees it in the log
                self._errors += 1
                from petastorm_tpu_torch.obs.log import degradation

                degradation("watch_error", "dataset.mutate chaos action failed: %s", e,
                            once=False)
        try:
            current = self._scan()
        except Exception as e:  # noqa: BLE001 — a failed listing loses a tick, not the
            # watcher: object-store listings flake
            self._errors += 1
            from petastorm_tpu_torch.obs.log import degradation

            degradation("watch_error", "dataset watch scan of %s failed (%s); retrying "
                        "next tick", self._path, e, once=False)
            return None
        previous, self._snapshot = self._snapshot, current
        if previous is None:
            return PlanDelta()
        delta = self._diff(previous, current)
        if delta:
            self._deltas += 1
            self._account(delta)
            if self._on_delta is not None:
                try:
                    self._on_delta(delta)
                except Exception as e:  # noqa: BLE001 — the reader's seam must not end
                    # the watch thread: surfaced like a failed scan
                    self._errors += 1
                    from petastorm_tpu_torch.obs.log import degradation

                    degradation("watch_error", "applying a dataset PlanDelta failed: %s",
                                e, once=False)
        return delta

    def _scan(self):
        """``{path: (token, [pieces])}`` of the dataset as it is now."""
        import pyarrow.fs as pafs

        from petastorm_tpu_torch.io.footercache import shared_footer_cache
        from petastorm_tpu_torch.metadata import RowGroupPiece, _list_parquet_files
        from petastorm_tpu_torch.partitions import partition_values_for_path

        out = {}
        snapshot = self._snapshot or {}
        for full in _list_parquet_files(self._fs, self._path):
            prev = snapshot.get(full)
            if prev is not None and prev[0] is None:
                # a file plan-time selection excluded stays inert: no stat, no footer,
                # no deltas
                out[full] = prev
                continue
            info = self._fs.get_file_info(full)
            if info.type == pafs.FileType.NotFound:
                continue  # deleted between the listing and the stat
            stat = current_stat_token(self._fs, full, info=info)
            if prev is not None and stat_token_of(prev[0] or "") == stat:
                out[full] = prev  # unchanged: the last tick's pieces
                continue
            entry = shared_footer_cache().get(self._fs, full, stat_token=stat)
            if current_stat_token(self._fs, full) != stat:
                # the file changed while its footer was read (a writer still at it):
                # the stat and the footer may describe two states, and a token made of
                # both would fail every read of the finished file. Look again next tick
                if prev is not None:
                    out[full] = prev
                continue
            tok = _with_crc(stat, entry.crc if self._opts.footer_crc else None)
            pv = partition_values_for_path(full, self._path) or None
            pieces = [RowGroupPiece(full, rg, entry.row_group_rows[rg], pv, None, tok)
                      for rg in range(entry.num_row_groups)]
            out[full] = (tok, pieces)
        return out

    @staticmethod
    def _diff(previous, current):
        added, removed, rewritten = [], [], []
        for path, (tok, pieces) in current.items():
            prev = previous.get(path)
            if prev is None:
                added.extend(pieces)
            elif not tokens_match(prev[0], tok):
                rewritten.append((path, prev[1], pieces))
        for path, (_tok, pieces) in previous.items():
            if path not in current:
                removed.append((path, pieces))
        return PlanDelta(added, removed, rewritten)

    def _account(self, delta):
        metrics = watch_metrics()
        if delta.added:
            metrics["pieces_added"].inc(len(delta.added))
        removed = sum(len(pieces) for _p, pieces in delta.removed)
        if removed:
            metrics["pieces_removed"].inc(removed)
        rewritten = sum(len(old) for _p, old, _new in delta.rewritten)
        if rewritten:
            metrics["pieces_rewritten"].inc(rewritten)
        from petastorm_tpu_torch.obs import flight as _flight

        for recorder in _flight.active_recorders():
            recorder.record("dataset_watch", tick=self._ticks, added=len(delta.added),
                            removed=[p for p, _ in delta.removed],
                            rewritten=[p for p, _o, _n in delta.rewritten])
        if delta.removed or delta.rewritten:
            from petastorm_tpu_torch.obs.log import degradation

            # countable, though the mutation is no failure: its consequences for each
            # piece surface as piece_removed / piece_rewritten at read time
            degradation("dataset_mutated", "dataset watch observed +%d piece(s), -%d "
                        "file(s), ~%d rewritten file(s) under a running reader",
                        len(delta.added), len(delta.removed), len(delta.rewritten),
                        once=False)

    def stats(self):
        """Live gauges for ``Reader.io_stats()``."""
        return {
            "watch_ticks": self._ticks,
            "watch_deltas": self._deltas,
            "watch_errors": self._errors,
        }
