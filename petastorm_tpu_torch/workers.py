"""Worker executors: pull row-group work items from a plan, run a worker, stream results.

Port of the pools of ``petastorm_tpu.workers`` (``PullDispatcher``, ``ExecutorBase``,
``SyncExecutor``, ``ThreadExecutor``, ``ProcessExecutor``, ``make_executor``).
Backpressure is a bounded results queue; the "ventilator" is the thread-safe
:class:`~petastorm_tpu_torch.plan.EpochPlan`, pulled through a :class:`PullDispatcher`:
bounded claims a worker (its readahead window, ``IoOptions.lookahead``) and work stealing
when the plan runs dry, each steal counted on ``ptpu_io_steals_total``. Threads are the
default pool: Arrow IO and the native entropy decode release the GIL. The process pool
runs the worker in clean child interpreters, over a socket or a shared-memory slab wire
(:mod:`petastorm_tpu_torch.serializers`); the upcoming items of a child's claim ride
with each item as its readahead hints.

The process pool hands the host-wide cache arena's token to its children
(:data:`petastorm_tpu_torch.io.arena.ENV_ATTACH` on the child environment): each child
attaches at bootstrap and maps the parent's warm set.

Every pool runs the poison policy of :class:`~petastorm_tpu_torch.recovery.RecoveryOptions`
(``recovery=``): with ``on_poison="quarantine"`` an item that fails ``poison_attempts``
times (an exception, a child death, a wire payload that fails to decode) becomes a
:class:`~petastorm_tpu_torch.recovery.QuarantinedItem` on the results stream instead of
an error, and the Reader charges it to its consumed-work map. The chaos sites
``worker.item`` (sync and thread pools), ``pool.dispatch``, ``pool.recv`` and
``wire.decode`` (the process pool's feeders) and ``child.item`` (inside the child) are
evaluated when a :class:`~petastorm_tpu_torch.chaos.FaultPlan` is armed. ``set_trace``
merges the children's ``child.work``/``child.serialize`` spans and the slab ring's
``shm.acquire_wait`` spans into a :class:`~petastorm_tpu_torch.trace.TraceRecorder`.
With the provenance plane armed (:mod:`petastorm_tpu_torch.obs.provenance`) the sync and
thread pools run each item's attempts inside its record, and the process pool
(``set_provenance``) records its wire's spans on the item and merges the record each
child sends with its result.

``set_health`` attaches a :class:`~petastorm_tpu_torch.obs.health.HealthMonitor` (or a
scope of one) to every pool: worker threads and feeder threads heartbeat each work item
(busy while working, ``wait:`` while claiming or blocked on a full results queue) and
record their item latencies (``observe_worker``), the dispatcher records its steals in
the monitor's flight ring, and the process pool adds a heartbeat a child (stamped from
the child's pings), a stack provider (SIGUSR1 to its own live children, whose
faulthandler writes their stacks to a file the parent reads) and the healer of the
``heal`` escalation, which kills a hung child only when the respawn budget or the poison
policy can absorb its item.

The thread and process pools resize live (``resize``): a grow starts workers (children)
against the running dispatcher; a shrink drains, a retiring worker finishing its item and
handing its unprocessed claim back to the dispatcher, so the delivered rows are those of
an un-resized run. The process pool carries a reader's live knob retunes to its running
children in a control frame (``broadcast_io_knobs``, acknowledged in ``ctl_acks``), and
stamps the reader's tenant (:mod:`petastorm_tpu_torch.obs.tenant`) into every child's
environment. Its wire is a unix-socket pipe (``transport='pipe'``, the default) or framed
tcp (``transport='tcp'`` or ``PTPU_TRANSPORT=tcp``,
:mod:`petastorm_tpu_torch.transport.tcp`): a hub the children dial back to, with
heartbeats, a redial after a link death and an in-flight ledger that sends the item of a
dead link again on the healed one.

Contract: ``executor.start(worker, plan)`` then iterate ``executor.results()``; exceptions
in workers propagate to the consumer; ``stop()``/``join()`` mirror the reference pool API.
"""
from __future__ import annotations

import os
import queue
import sys
import threading
import time
from collections import deque

from petastorm_tpu_torch import chaos as _chaos
from petastorm_tpu_torch.errors import TimeoutWaitingForResultError, WorkerDiedError
from petastorm_tpu_torch.obs import provenance as _prov
from petastorm_tpu_torch.obs import tenant as _tenant
from petastorm_tpu_torch.obs.health import ActorSlots
from petastorm_tpu_torch.recovery import QuarantinedItem, RecoveryOptions

_DONE = object()

_steal_counter = None


def _count_steal():
    """Bump ``ptpu_io_steals_total`` (resolved once a process)."""
    global _steal_counter
    counter = _steal_counter
    if counter is None:
        from petastorm_tpu_torch.obs.metrics import default_registry

        counter = _steal_counter = default_registry().counter(
            "ptpu_io_steals_total",
            help="claimed plan items taken from a busy worker by an idle one")
    counter.inc()


class PullDispatcher:
    """Pull-based dispatch over a shared plan: bounded claims a worker plus work
    stealing.

    Each worker claims up to ``1 + lookahead`` upcoming plan items into its own deque;
    the lookahead is what the readahead layer prefetches, so the items a worker
    announces as next are the ones it will process. When the plan runs dry an idle
    worker steals from the tail of the longest peer claim (the item its owner would
    reach last), so a worker stuck on one slow item does not strand the rest of its
    claim. With ``lookahead=0`` and no stealing this is the shared ``next(plan)`` under
    a lock.

    Claims fill strictly in plan order and are consumed first in, first out; only the
    completion order can differ (it always could: workers finish out of order), which
    the Reader's consumed-work map handles. A stolen item keeps its ``(epoch, ordinal)``
    tag, so ``Reader.state_dict()`` stays exact.

    The live fleet resize: :meth:`ensure_workers` grows the claim table,
    :meth:`withdraw` hands a retiring worker's claim back (refilled into claims before
    the plan iterator: it was claimed earlier in plan order than anything left there),
    :meth:`has_work` is the pools' last-worker exit gate, and :meth:`set_lookahead`
    retunes the claim window with the readahead depth.
    """

    def __init__(self, plan, workers_count, lookahead=0, stealing=True, recorder=None):
        self._iter = iter(plan)
        self._lock = threading.Lock()
        self._claims = [deque() for _ in range(max(1, workers_count))]
        self._exhausted = False
        self._lookahead = max(0, int(lookahead))
        self._stealing = bool(stealing)
        #: items handed back (a retiring worker's claim): claims refill from here first
        self._returned = deque()
        #: a FlightRecorder the steals are recorded in (None: no recording)
        self._recorder = recorder
        self.steals = 0

    def set_recorder(self, recorder):
        """Attach or replace the flight recorder mid-stream (the pool starts in the
        reader's constructor, before a loader attaches its health monitor)."""
        with self._lock:
            self._recorder = recorder

    def next(self, worker_idx):
        """Claim the next item for ``worker_idx``: ``(item, upcoming)``, where
        ``upcoming`` is the rest of this worker's claim (the prefetch hint), or ``None``
        when no work is left anywhere."""
        with self._lock:
            claim = self._claims[worker_idx]
            self._fill(claim, 1 + self._lookahead)
            if not claim and self._stealing:
                victim = max((c for c in self._claims if c), key=len, default=None)
                if victim is not None:
                    claim.append(victim.pop())  # the tail: the victim's furthest item
                    self.steals += 1
                    _count_steal()
                    if self._recorder is not None:
                        self._recorder.record("steal", thief=worker_idx,
                                              victim_len=len(victim))
            if not claim:
                return None
            item = claim.popleft()  # the fill above keeps the hint window full
            return item, tuple(claim)

    def set_lookahead(self, lookahead):
        """Retune the claim window live: the claim is the readahead hint window, so a
        deeper prefetch pool needs a wider claim to see more upcoming items."""
        with self._lock:
            self._lookahead = max(0, int(lookahead))

    def ensure_workers(self, workers_count):
        """Grow the claim table to at least ``workers_count`` slots (a live grow). Never
        shrinks: a retired worker's slot stays, empty, so indices keep their claims."""
        with self._lock:
            while len(self._claims) < workers_count:
                self._claims.append(deque())

    def withdraw(self, worker_idx):
        """Hand ``worker_idx``'s unprocessed claim back (a live shrink): its items refill
        other claims before the plan iterator, so a drained worker loses no work and
        duplicates none. Returns the number of items handed back."""
        with self._lock:
            claim = self._claims[worker_idx]
            n = len(claim)
            self._returned.extend(claim)
            claim.clear()
        return n

    def return_items(self, items):
        """Hand specific dispatched items back (items that already left their claim),
        ahead of the plan iterator, with :meth:`withdraw`'s no-loss, no-duplicate
        discipline."""
        with self._lock:
            self._returned.extend(items)
        return len(items)

    def has_work(self):
        """Is anything left to dispatch: handed-back items, claimed items or an
        unexhausted plan? The pools' last-worker exit gate: a retiring worker may hand
        its claim back after its peers saw an empty dispatcher and exited, and ending
        the stream over those items would drop rows."""
        with self._lock:
            return bool(self._returned) or not self._exhausted or any(self._claims)

    def _fill(self, claim, target):
        # the caller MUST hold self._lock: its one call site, next(), does (the
        # analyzer cannot see cross-method lock ownership)
        while len(claim) < target:
            if self._returned:
                claim.append(self._returned.popleft())  # graftlint: disable=GL-C001 (caller holds self._lock)
                continue
            if self._exhausted:
                break
            try:
                claim.append(next(self._iter))
            except StopIteration:
                self._exhausted = True  # graftlint: disable=GL-C001 (caller holds self._lock)

    def stats(self):
        return {"steals": self.steals}


class _ExcResult:
    def __init__(self, exc):
        self.exc = exc


def _attach_health(pool, monitor, *slots):
    """``set_health`` of every pool: store the monitor (its workers resolve it at each
    item, so a monitor attached after ``start()`` instruments the rest of the stream),
    point a running dispatcher's steal events at its flight ring, and watch the work
    already in flight (:meth:`ActorSlots.attach`): a reader starts working at its
    construction, before a loader can attach a monitor, and an item that hangs then
    must not go unseen."""
    pool._health = monitor
    dispatch = getattr(pool, "_dispatch", None)
    if dispatch is not None:
        dispatch.set_recorder(monitor.flight if monitor is not None else None)
    for actor_slots in slots:
        actor_slots.attach(monitor)


def _iter_results(pool):
    """The results drain of the queue-backed pools: ends on ``_DONE``, re-raises a
    worker's exception (stopping the pool first), raises
    :class:`TimeoutWaitingForResultError` when nothing arrives within the pool's timeout,
    and returns promptly once ``stop()`` was called, marking the stream truncated."""
    deadline = time.monotonic() + pool._timeout
    while True:
        try:
            value = pool._results.get(timeout=0.2)
        except queue.Empty:
            if pool._stop_event.is_set():
                pool.truncated = True
                return
            if time.monotonic() > deadline:
                raise TimeoutWaitingForResultError(
                    "No worker result within %.0fs" % pool._timeout) from None
            continue
        if value is _DONE:
            if pool._stop_event.is_set():
                pool.truncated = True
            return
        if isinstance(value, _ExcResult):
            pool.stop()
            raise value.exc
        yield value
        # fresh budget per consumer request: time the consumer spends between next()
        # calls does not count against the worker-result timeout
        deadline = time.monotonic() + pool._timeout


def _run_item(worker, item, recovery):
    """``worker(item)`` under the poison policy (the sync and thread pools): an item
    that raises is tried again in place until ``poison_attempts`` failures make it a
    :class:`QuarantinedItem`; without quarantine the first exception propagates. With
    the provenance plane armed the attempts run inside the item's context, closed on
    every exit (the sync pool yields after this returns: a context held open across the
    consumer's turn would charge its spans to this item)."""
    attempts = 0
    if _prov.ACTIVE is not None:
        _prov.begin_item(item)
    try:
        while True:
            try:
                if _chaos.ACTIVE is not None:
                    _chaos.ACTIVE.hit("worker.item", key=_chaos.item_key(item))
                return worker(item)
            except Exception as e:  # noqa: BLE001 — classified by the policy
                attempts += 1
                if not recovery.quarantine:
                    raise
                if attempts >= recovery.poison_attempts:
                    return QuarantinedItem(item, e, attempts)
    finally:
        if _prov.ACTIVE is not None:
            _prov.end_item()


class ExecutorBase:
    """The contract every pool keeps: ``start(worker, plan)``, the ``results()``
    generator, ``stop()``, ``join()``, the context manager that stops and joins, the
    ``truncated`` flag, and the health and provenance hooks."""

    #: True when the result stream ended because ``stop()`` aborted it mid-pass rather
    #: than because the plan was exhausted (``Reader.last_row_consumed`` reads it)
    truncated = False
    #: the health monitor or scope (``set_health``; None: off, one check a pass)
    _health = None
    #: the provenance recorder the pool's driver records wire spans on (None: off)
    _prov = None

    def set_provenance(self, recorder):
        """Attach a provenance recorder (None: stop); attachable mid-stream."""
        self._prov = recorder

    def set_health(self, monitor):
        """Attach a health monitor (None detaches)."""
        _attach_health(self, monitor)

    def start(self, worker, plan):
        raise NotImplementedError

    def results(self):
        """Generator of worker results; raises worker exceptions; ends when the plan is
        exhausted."""
        raise NotImplementedError

    def stop(self):
        pass

    def join(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.stop()
        self.join()


class SyncExecutor(ExecutorBase):
    """Synchronous in-process execution (reference DummyPool): deterministic, for tests.

    Readahead still applies (``lookahead > 0`` and a worker with ``prefetch``): the
    upcoming items come from ``plan.peek``, so the single consumer keeps its order while
    the IO pool reads ahead of it. Under ``on_poison="quarantine"`` a failing item is
    tried again in place, up to ``poison_attempts`` times."""

    def __init__(self, lookahead=0, recovery=None):
        self._worker = None
        self._plan = None
        self._stopped = False
        self._lookahead = max(0, int(lookahead))
        self._recovery = RecoveryOptions.normalize(recovery)

    def set_lookahead(self, lookahead):
        """Retune how many upcoming items each item's prefetch hint names."""
        self._lookahead = max(0, int(lookahead))

    def start(self, worker, plan):
        self._worker = worker
        self._plan = plan
        self._stopped = False
        self.truncated = False

    def results(self):
        prefetch = getattr(self._worker, "prefetch", None)
        peek = getattr(self._plan, "peek", None)
        for item in self._plan:
            if self._stopped:
                self.truncated = True
                return
            if prefetch is not None and peek is not None and self._lookahead:
                upcoming = peek(self._lookahead)
                if upcoming:
                    prefetch(upcoming)
            yield _run_item(self._worker, item, self._recovery)

    def stop(self):
        self._stopped = True


class ThreadExecutor(ExecutorBase):
    """N threads pulling work items from the shared plan through a
    :class:`PullDispatcher` (bounded claims, work stealing); each hands the rest of its
    claim to the worker's ``prefetch`` before working an item. Bounded results queue =
    backpressure. :meth:`resize` grows or drains the fleet live."""

    def __init__(self, workers_count=4, results_queue_size=16, results_timeout_s=300.0,
                 lookahead=0, work_stealing=True, recovery=None):
        if workers_count < 1:
            raise ValueError("workers_count must be >= 1, got %r" % workers_count)
        self._workers_count = workers_count
        self._queue_size = results_queue_size
        self._timeout = results_timeout_s
        self._lookahead = max(0, int(lookahead))
        self._stealing = bool(work_stealing)
        self._recovery = RecoveryOptions.normalize(recovery)
        self._dispatch = None
        self._threads = []
        self._results = None
        self._stop_event = threading.Event()
        self._active = 0
        self._active_lock = threading.Lock()
        #: the live resize's state, under _active_lock: the fleet's target size, the
        #: retirements not yet claimed by a worker, the next worker index
        self._target = workers_count
        self._retire = 0
        self._next_idx = workers_count
        self._worker_obj = None
        #: the health monitor or scope (set_health; None: off, one check a pass)
        self._health = None
        #: the worker threads' heartbeats and the start of each one's item in flight
        self._slots = ActorSlots(self, "worker.thread-%d", "worker")
        #: True when the result stream ended because ``stop()`` aborted it mid-pass
        self.truncated = False

    def set_health(self, monitor):
        """Attach a health monitor: each worker thread registers
        ``worker.thread-<i>`` (role ``worker``), busy while working an item and
        ``wait:claim``/``wait:results_put`` otherwise, and records its item latencies.
        A worker already in an item is watched from its item's start. None detaches."""
        _attach_health(self, monitor, self._slots)

    def start(self, worker, plan):
        self._results = queue.Queue(maxsize=self._queue_size)
        self._stop_event.clear()
        self.truncated = False
        self._worker_obj = worker
        monitor = self._health
        self._dispatch = PullDispatcher(
            plan, self._workers_count, lookahead=self._lookahead, stealing=self._stealing,
            recorder=monitor.flight if monitor is not None else None)
        with self._active_lock:
            self._active = self._workers_count
            self._target = self._workers_count
            self._retire = 0
            self._next_idx = self._workers_count
        for i in range(self._workers_count):
            self._start_thread(worker, self._dispatch, i)

    def _start_thread(self, worker, dispatch, idx):
        t = threading.Thread(target=self._run_worker, args=(worker, dispatch, idx),
                             daemon=True, name="ptpu-torch-worker-%d" % idx)
        t.start()
        self._threads.append(t)

    # -- the live resize ------------------------------------------------------------------

    def _should_retire(self):
        """Claim one pending retirement: workers check between items only, so a shrink
        drains and never interrupts an item."""
        with self._active_lock:
            if self._retire > 0:
                self._retire -= 1
                return True
            return False

    def set_lookahead(self, lookahead):
        """Retune the dispatcher's claim window (with the readahead depth)."""
        self._lookahead = max(0, int(lookahead))
        dispatch = self._dispatch
        if dispatch is not None:
            dispatch.set_lookahead(self._lookahead)

    @property
    def alive_workers(self):
        """Workers running now (retiring ones count until they drain out)."""
        return self._active

    @property
    def target_workers(self):
        return self._target

    def resize(self, workers_count):
        """Grow or shrink the fleet live. A grow starts worker threads against the
        running dispatcher (cancelling pending retirements first); a shrink queues
        retirements that workers take between items, handing their claims back to the
        dispatcher, so the delivered rows and the checkpoint watermark are those of an
        un-resized run. A no-op once the stream has finished. Returns the applied
        target."""
        n = max(1, int(workers_count))
        dispatch = self._dispatch
        to_start = []
        with self._active_lock:
            if dispatch is None or self._active == 0:
                return self._target  # not started, or drained
            if n > self._target:
                grow = n - self._target
                cancelled = min(grow, self._retire)
                self._retire -= cancelled
                for _ in range(grow - cancelled):
                    to_start.append(self._next_idx)
                    self._next_idx += 1
                self._active += len(to_start)
            elif n < self._target:
                self._retire += self._target - n
            self._target = n
            next_idx = self._next_idx
        if to_start:
            dispatch.ensure_workers(next_idx)
            for idx in to_start:
                self._start_thread(self._worker_obj, dispatch, idx)
        return n

    def _retire_worker(self, worker, dispatch, fatal):
        """One worker's exit: count it out, and post the end of the stream when it was
        the last, unless the dispatcher still holds work. That is one rare race: a
        retiring worker hands its claim back after its peers saw an empty dispatcher and
        exited. The last worker out is the one that sees it, and it starts a rescue
        worker instead of ending the stream over undelivered rows."""
        rescue_idx = None
        with self._active_lock:
            self._active -= 1
            if self._active == 0 and not fatal and not self._stop_event.is_set() \
                    and dispatch.has_work():
                self._active += 1  # the rescue worker's slot, reserved now
                rescue_idx = self._next_idx
                self._next_idx += 1
            last = self._active == 0
        if rescue_idx is not None:
            try:
                dispatch.ensure_workers(rescue_idx + 1)
                self._start_thread(worker, dispatch, rescue_idx)
                return
            except Exception as e:  # noqa: BLE001 — degrade to the stream's end
                from petastorm_tpu_torch.obs.log import degradation

                degradation("ctl_rescue_failed", "the rescue worker for handed-back "
                            "items could not start (%s); those items are lost for this "
                            "pass", e, once=False)
                with self._active_lock:
                    self._active -= 1
                    last = self._active == 0
        if last:
            self._put(_DONE)  # outside the lock: a full queue blocks the put

    def _run_worker(self, worker, dispatch, idx):
        prefetch = getattr(worker, "prefetch", None)
        slots = self._slots
        fatal = False  # a fatal exit never starts a rescue worker
        try:
            while not self._stop_event.is_set():
                if self._should_retire():
                    # a live shrink: the unprocessed claim goes back, this worker exits
                    dispatch.withdraw(idx)
                    break
                # resolved each pass: a monitor attached after start() (the loader
                # attaches to a running reader) instruments the rest of the stream
                hb = slots.heartbeat(idx)
                if hb is not None:
                    hb.wait("claim")  # an exhausted plan is idleness, not a stall
                claim = dispatch.next(idx)
                if claim is None:
                    break
                item, upcoming = claim
                slots.begin(idx)
                monitor = self._health
                if prefetch is not None and upcoming:
                    prefetch(upcoming)  # never raises (degradation-counted)
                t0 = time.perf_counter() if monitor is not None else 0.0
                try:
                    result = _run_item(worker, item, self._recovery)
                except Exception as e:  # noqa: BLE001 — delivered to the consumer
                    slots.end(idx, "results_put")
                    self._put(_ExcResult(e))
                    fatal = True
                    break
                slots.end(idx, "results_put")  # a full results queue is backpressure
                if monitor is not None:
                    # the straggler detector's input
                    monitor.observe_worker(idx, time.perf_counter() - t0)
                self._put(result)
        finally:
            slots.retire(idx)
            self._retire_worker(worker, dispatch, fatal)

    def _put(self, value):
        # yields to a SET stop event: the consumer who set it never reads again
        while True:
            try:
                self._results.put(value, timeout=0.1)
                return
            except queue.Full:
                if self._stop_event.is_set():
                    return

    def results(self):
        """Generator of worker results; raises worker exceptions; ends when the plan is
        exhausted, or promptly once ``stop()`` was called (a truncation)."""
        return _iter_results(self)

    def dispatch_stats(self):
        """The dispatcher's counts (``steals``); ``{}`` before ``start()``."""
        dispatch = self._dispatch
        return dispatch.stats() if dispatch is not None else {}

    def stop(self):
        self._stop_event.set()
        try:  # drain so blocked workers can exit
            while True:
                self._results.get_nowait()
        except (queue.Empty, AttributeError):
            pass

    def join(self):
        deadline = time.monotonic() + self._timeout  # shared across threads
        for t in self._threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
            if t.is_alive():
                from petastorm_tpu_torch.obs.log import degradation

                degradation("thread_join_timeout", "Worker thread %s still alive after "
                            "%.0fs join (blocked in IO?); it exits at its next stop check",
                            t.name, self._timeout, once=False)
        self._threads = []




# -- process pool ----------------------------------------------------------------------

#: the wire's child-death signals: a dead child's socket ends in one of these
_CHILD_GONE = (EOFError, BrokenPipeError, ConnectionResetError)


def _release_result(value):
    """Release the slab lease a dropped result holds (view wires), so a result the
    consumer never sees cannot keep its slab until garbage collection."""
    from petastorm_tpu_torch.io.lease import LEASE_KEY

    payload = value[2] if isinstance(value, tuple) and len(value) == 3 else None
    lease = None
    if isinstance(payload, dict):
        lease = payload.pop(LEASE_KEY, None)
    elif payload is not None:
        lease = getattr(payload, "lease", None)
        if lease is not None:
            payload.lease = None
    if lease is not None:
        lease.release()


class ProcessExecutor(ExecutorBase):
    """Runs the worker in child processes: clean interpreters started as ``python -m
    petastorm_tpu_torch._child_worker`` (never forked from this process, which holds a
    CUDA context, pinned memory and threads), one feeder thread a child. The worker is
    pickled once a child; a feeder claims an item from the :class:`PullDispatcher`,
    sends it with the rest of its claim (the child's readahead hints, handed to the
    worker's ``prefetch`` before the item is worked), and waits for the result, so each
    child has one item in flight and the bounded results queue is the pool's
    backpressure. Each result carries the child worker's ``io_stats()``
    (:meth:`child_io_stats`).

    With a serializer of the ``shm`` family the results do not ride the socket:
    ``start()`` makes a :class:`~petastorm_tpu_torch.parallel.shm_ring.SlabRing` of
    ``shm_slabs`` slabs (default ``workers_count + 2``) of ``PTPU_SHM_SLAB_BYTES``
    (default 32 MB); a feeder grants its child a slab with each item and the child
    writes the frames into it; only a descriptor crosses the socket. An item larger than
    a slab takes the socket, and so does an item that finds the ring empty: at once on a
    view wire, where the consumer holds a slab for as long as it keeps the batches
    viewing it, after 2 s on the others, whose slabs come back as soon as a result is
    rebuilt (both counted in ``wire_stats()``). Where shared memory does not work, or the
    ring does not fit in ``/dev/shm``, the whole pool takes the socket wire, with a
    warning. ``join()`` unlinks every slab.

    A child that dies mid-item is replaced by a fresh one and its item dispatched again,
    at most ``worker_respawns`` times a pool (``RecoveryOptions.worker_respawns``:
    default 2, or ``PTPU_WORKER_RESPAWNS``; 0 fails at the first death) before
    :class:`~petastorm_tpu_torch.errors.WorkerDiedError` reaches the consumer, with the
    first death of the item as its ``original``. A child whose worker raises ships the
    exception, which reaches the consumer like a thread pool's.

    Under ``RecoveryOptions(on_poison="quarantine")`` the failures of one item are
    counted across respawns: an exception from the child is retried on the same live
    child, a result whose wire payload fails to decode (corrupt bytes, a bad
    descriptor) is dispatched again on the same live child (``kind="wire_decode"``),
    and a child death charges the respawn budget until the death that reaches
    ``poison_attempts`` quarantines the item (``kind="child_death"``) and respawns
    without charging it: the item will not be tried again, so it cannot crash-loop.
    A quarantined item travels as a :class:`QuarantinedItem` on the results stream.

    With a health monitor (``set_health``) each feeder thread heartbeats as
    ``pooldrv-<i>`` (always in a ``wait:`` state: the hang candidate is its child) and
    each child as ``worker.child-<i>`` (role ``child``), stamped when its item is sent,
    at every ``("hb", wall_ts)`` ping the child interleaves with its results (one when
    it receives an item, one every ``PTPU_CHILD_PING_S`` seconds, default 5, while it
    waits for work) and at its result. A child hung inside its worker sends nothing, so
    its heartbeat ages: the stall signal. Under ``escalation="heal"`` the pool's healer
    kills such a child when the kill can be absorbed, and the child-death path above
    respawns it and dispatches its item again or quarantines it.

    :meth:`resize` grows the fleet (fresh children through the same handshake) or drains
    it (a retiring feeder finishes its item, hands its claim back and shuts its child
    down). :meth:`broadcast_io_knobs` sends a ``("ctl", {knob: value})`` frame ahead of
    each running child's next item; the child applies it through the worker's
    ``apply_<knob>`` and answers ``("ctl_ack", {knob: applied})``, collected in
    :meth:`ctl_acks`. Children spawned later inherit the retune in the worker's pickle,
    and a replacement for a dead child gets the frame again. The worker's
    ``tenant_context`` goes into every child's environment (``PTPU_TENANT``), and each
    result's worker seconds are charged to that tenant here, in the parent.
    """

    def __init__(self, workers_count=4, results_queue_size=16, results_timeout_s=300.0,
                 serializer="pickle", worker_respawns=None, shm_slab_bytes=None,
                 shm_slabs=None, lookahead=0, work_stealing=True, recovery=None,
                 transport=None):
        from petastorm_tpu_torch.serializers import make_serializer
        from petastorm_tpu_torch.transport import normalize_transport

        if workers_count < 1:
            raise ValueError("workers_count must be >= 1, got %r" % workers_count)
        self._workers_count = workers_count
        self._queue_size = results_queue_size
        self._timeout = results_timeout_s
        self._serializer_name = serializer
        self._serializer = make_serializer(serializer)
        self._shm_slab_bytes = int(shm_slab_bytes
                                   or os.environ.get("PTPU_SHM_SLAB_BYTES", 0)
                                   or (32 << 20))
        self._shm_slabs = shm_slabs
        self._lookahead = max(0, int(lookahead))
        self._stealing = bool(work_stealing)
        self._dispatch = None
        #: {feeder index: the io_stats() its child sent with its latest result}
        self._child_io = {}
        self._ring = None
        self._shm_unavailable = False
        self._recovery = RecoveryOptions.normalize(recovery)
        self._respawn_budget = int(worker_respawns) if worker_respawns is not None \
            else self._recovery.worker_respawns
        #: a TraceRecorder the children's per-item spans merge into (set_trace)
        self._tracer = None
        #: the ProvenanceRecorder the wire spans and the children's item records merge
        #: into (set_provenance; resolved at each item, so it can attach mid-stream)
        self._prov = None
        self._procs = []
        self._conns = []
        self._threads = []
        self._results = None
        self._stop_event = threading.Event()
        self._active = 0
        self._active_lock = threading.Lock()
        #: guards the child/connection lists, the tmpdir and the ring against join()
        self._respawn_lock = threading.Lock()
        self._spawn_counter = 0
        self._tmpdir = None
        self._worker = None
        self._child_env = None
        self._python = sys.executable
        self._authkey = None
        #: worker settings sent to running children ahead of their next item
        #: (``update_settings``), with a version each feeder compares against
        self._settings = {}
        self._settings_version = 0
        self._settings_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._pool_stats = {}
        self._t_start = None
        #: the health monitor or scope (set_health; None: off)
        self._health = None
        #: the live resize's state, under _active_lock (ThreadExecutor's)
        self._target = workers_count
        self._retire = 0
        self._next_idx = workers_count
        #: the live knob frames, under _ctl_lock: the knobs owed to running children,
        #: their version, the version each feeder last sent and each child's acks
        self._ctl_lock = threading.Lock()
        self._ctl_pending = {}
        self._ctl_version = 0
        self._ctl_seen = {}
        self._ctl_acks = {}
        #: the tenant the children bill (from the worker's tenant_context), or None
        self._tenant_label = None
        #: feeder index -> its live child's Popen (under the respawn lock): the healer's
        #: kill target
        self._child_by_idx = {}
        #: feeder index -> failures of its in-flight item so far: lets the healer tell
        #: whether the poison policy can absorb a kill before it kills
        self._inflight_attempts = {}
        #: the children's heartbeats (busy from the send of an item to its result) and
        #: the feeder threads' (always in a wait state)
        self._child_slots = ActorSlots(self, "worker.child-%d", "child")
        self._feeder_slots = ActorSlots(self, "pooldrv-%d", "worker")
        #: the stack provider and healer this pool registered, and the monitor they
        #: were registered on (handles are meaningful only to the monitor that issued
        #: them)
        self._stack_provider_handle = None
        self._healer_handle = None
        self._stack_provider_monitor = None
        #: an idle child pings at this cadence while it waits for work, so a live child
        #: without work is told apart from a hung one in the evidence
        self._ping_interval_s = float(os.environ.get("PTPU_CHILD_PING_S", "") or 5.0)
        #: True when the result stream ended because ``stop()`` aborted it mid-pass
        self.truncated = False
        #: the wire: 'pipe' or 'tcp' (a tcp hub that cannot be made turns the pool back
        #: to 'pipe', with a transport_link_down degradation)
        self._transport_name = normalize_transport(transport)
        #: the tcp hub (the pool's lifetime) and the next session number
        self._hub = None
        self._session_counter = 0

    # -- start-up ----------------------------------------------------------------------

    def start(self, worker, plan):
        import tempfile

        self._results = queue.Queue(maxsize=self._queue_size)
        self._stop_event.clear()
        self.truncated = False
        self._worker = worker
        with self._stats_lock:
            self._t_start = time.perf_counter()
            self._pool_stats = {"children": self._workers_count, "spawn_s": None,
                                "first_result_s": None, "items": 0, "child_work_s": 0.0,
                                "child_first_work_s": 0.0, "child_serialize_s": 0.0,
                                "respawns": 0}
        self._authkey = os.urandom(32)
        if self._transport_name == "tcp":
            self._setup_hub()  # turns the pool back to 'pipe' where it fails
        self._setup_shm()
        with self._respawn_lock:
            self._tmpdir = tempfile.mkdtemp(prefix="ptpu-torch-pool-")
        # the package root goes on PYTHONPATH explicitly: the child must import the port
        # before the handshake can hand it this process's sys.path
        pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        child_pp = os.environ.get("PYTHONPATH", "")
        child_pp = pkg_root + ((os.pathsep + child_pp) if child_pp else "")
        # children decode on the host only: no card is visible to them, so nothing a
        # worker unpickles can make a CUDA context there
        self._child_env = {**os.environ, "PYTHONPATH": child_pp, "CUDA_VISIBLE_DEVICES": ""}
        # the host-wide cache arena: children attach the parent's mapped warm set at
        # bootstrap (the same environment every spawn of this pool reuses)
        from petastorm_tpu_torch.io import arena as arena_mod

        arena_token = arena_mod.current_token()
        if arena_token is not None:
            self._child_env[arena_mod.ENV_ATTACH] = arena_token
        else:
            self._child_env.pop(arena_mod.ENV_ATTACH, None)
        # the tenant: children adopt it at bootstrap (attach_from_env), replacements and
        # grown children too (every spawn reuses this environment)
        tenant_ctx = getattr(worker, "tenant_context", None) or _tenant.current()
        if tenant_ctx is not None:
            self._child_env.update(tenant_ctx.env())
        self._tenant_label = tenant_ctx.tenant if tenant_ctx is not None else None
        try:
            if self._transport_name == "tcp":
                # the child's link policy (redial backoff, heartbeat cadence, half-open
                # threshold) rides the environment: its link exists before any
                # handshake payload could carry it
                rec = self._recovery
                self._child_env.update({
                    "PTPU_LINK_HEARTBEAT_S": repr(rec.link_heartbeat_s),
                    "PTPU_LINK_MISS_THRESHOLD": str(rec.link_miss_threshold),
                    "PTPU_LINK_RECONNECT_S": repr(rec.link_reconnect_s),
                    "PTPU_LINK_CONNECT_TIMEOUT_S": repr(rec.link_connect_timeout_s),
                    "PTPU_IO_RETRY_BACKOFF_S": repr(rec.io_retry_backoff_s),
                    "PTPU_IO_RETRY_MAX_BACKOFF_S": repr(rec.io_retry_max_backoff_s),
                })
                self._start_children_tcp()
            else:
                self._start_children()
        except BaseException:
            self.join()  # no child, socket or slab outlives a failed start
            raise
        with self._stats_lock:
            self._pool_stats["spawn_s"] = time.perf_counter() - self._t_start
        with self._active_lock:
            self._active = len(self._conns)
            self._target = len(self._conns)
            self._retire = 0
            self._next_idx = len(self._conns)
        monitor = self._health
        self._dispatch = PullDispatcher(
            plan, len(self._conns), lookahead=self._lookahead, stealing=self._stealing,
            recorder=monitor.flight if monitor is not None else None)
        with self._stats_lock:
            self._child_io = {}
        for i, conn in enumerate(list(self._conns)):
            self._start_feeder(conn, i, self._dispatch)

    def _start_feeder(self, conn, idx, dispatch):
        t = threading.Thread(target=self._feed_child, args=(conn, idx, dispatch),
                             daemon=True, name="ptpu-torch-feed-%d" % idx)
        t.start()
        self._threads.append(t)

    def _setup_shm(self):
        """Make the slab ring for a serializer of the ``shm`` family; where shared memory
        does not work or the ring does not fit, the pool takes the inner socket
        serializer (same results, socket copies) and ``wire_stats()`` says so."""
        from petastorm_tpu_torch.parallel.shm_ring import (SlabRing, degradation,
                                                           shm_supported)
        from petastorm_tpu_torch.serializers import ShmSerializer

        if not isinstance(self._serializer, ShmSerializer):
            return
        if self._transport_name == "tcp":
            # the tcp wire behaves as if the host boundary were real: a slab grant
            # cannot cross a network link, so payloads take the framed socket
            degradation("transport_shm_bypass", "shared-memory slab wire disabled over "
                        "the tcp transport; result payloads ride the framed socket wire")
            self._shm_unavailable = True
            self._serializer_name = self._serializer.inner_name
            self._serializer = self._serializer.inner
            return
        ring = None
        if shm_supported():
            try:
                ring = SlabRing(self._shm_slab_bytes,
                                self._shm_slabs or (self._workers_count + 2))
            except Exception as e:  # noqa: BLE001 — degrade, never fail the pool
                degradation("shm_ring_create_failed", "shared-memory slab ring creation "
                            "failed (%s); the process pool uses the socket wire", e,
                            once=False)
        if ring is None:
            self._shm_unavailable = True
            self._serializer_name = self._serializer.inner_name
            self._serializer = self._serializer.inner
            return
        self._serializer.bind_ring(ring)
        ring.set_trace(self._tracer)
        with self._respawn_lock:
            self._ring = ring

    def _setup_hub(self):
        """Make the tcp hub. A hub that cannot bind or listen is a classified
        degradation back to the pipe wire, never a raise: the transport is an
        availability feature and must not cost any."""
        from petastorm_tpu_torch.obs.log import degradation
        from petastorm_tpu_torch.transport import tcp

        try:
            hub = tcp.TcpHub(self._recovery, token=self._authkey.hex())
        except Exception as e:  # noqa: BLE001 — degrade, never fail the pool
            degradation("transport_link_down", "tcp transport unavailable (%s); falling "
                        "back to the local pipe pool", e, once=False)
            hub = None
            self._transport_name = "pipe"
        with self._respawn_lock:  # join() takes the hub under this lock
            self._hub = hub

    def _new_session(self):
        """A fresh hub session (tagged with the reader's tenant): ``(hub, number,
        transport)``."""
        with self._respawn_lock:
            if self._hub is None:
                raise RuntimeError("pool stopping during respawn")
            sid = self._session_counter
            self._session_counter += 1
            hub = self._hub
        transport = hub.create_session(sid)
        if self._tenant_label is not None:
            transport.set_tenant(self._tenant_label)
        return hub, sid, transport

    def _start_children_tcp(self):
        """Spawn the fleet over the tcp hub, one session a child; the children dial back
        concurrently, each is handshaken as it connects, then the pid acks are collected
        (the pipe path's two phases)."""
        pending = []
        for _ in range(self._workers_count):
            hub, sid, transport = self._new_session()
            child = self._popen_child(hub.address_for(sid), self._authkey)
            with self._respawn_lock:
                self._procs.append(child)
            pending.append(transport)
        for transport in pending:
            self._await_tcp_connected(transport, self._procs, "Pool child")
            self._send_handshake(transport)
        for transport in pending:
            self._register_conn(transport)

    def _register_conn(self, conn):
        """Collect one child's pid ack and register its connection as the next feeder:
        accept order is not spawn order, and the pid ties the connection to its process,
        which the healer kills by."""
        pid = self._await_pid_ack(conn)
        conn.mark_ready()  # the steady-state link: chaos sites and heartbeats on
        with self._respawn_lock:
            self._child_by_idx[len(self._conns)] = next(
                (p for p in self._procs if p.pid == pid), None)
            self._conns.append(conn)

    def _await_tcp_connected(self, transport, procs, what, check_stop=False,
                             deadline=120.0):
        """Wait for a session's first adoption, polling the children every second: the
        tcp twin of :meth:`_await_accept`."""
        waited = 0.0
        while not transport.wait_connected(1.0):
            waited += 1.0
            if check_stop and self._stop_event.is_set():
                raise RuntimeError("pool stopping during respawn")
            with self._respawn_lock:
                snapshot = list(procs)
            for p in snapshot:
                if p.poll() is not None:
                    raise RuntimeError(
                        "%s exited with code %s before connecting (run 'python -m "
                        "petastorm_tpu_torch._child_worker' to debug)"
                        % (what, p.returncode))
            if waited > deadline:
                raise TimeoutWaitingForResultError(
                    "%s did not connect within %.0fs" % (what, deadline))

    def _popen_child(self, address, authkey):
        import subprocess

        p = subprocess.Popen([self._python, "-m", "petastorm_tpu_torch._child_worker",
                              address], stdin=subprocess.PIPE, env=self._child_env)
        p.stdin.write(authkey)
        p.stdin.close()
        return p

    def _start_children(self):
        """Spawn the fleet and handshake each child as it connects, then collect the pid
        acks: the children bootstrap concurrently."""
        from multiprocessing.connection import Listener

        from petastorm_tpu_torch.transport import PipeTransport

        with self._respawn_lock:
            address = os.path.join(self._tmpdir, "sock")
        # a backlog for the whole fleet: every child dials at once, and some kernels
        # refuse a connect to a full backlog (EAGAIN) instead of queueing it
        listener = Listener(address, family="AF_UNIX", authkey=self._authkey,
                            backlog=self._workers_count + 1)
        try:
            for _ in range(self._workers_count):
                child = self._popen_child(address, self._authkey)
                with self._respawn_lock:
                    self._procs.append(child)
            accepted = self._accept_in_background(listener, self._workers_count)
            pending = []
            while len(pending) < self._workers_count:
                conn = PipeTransport(self._await_accept(accepted, self._procs, "Pool child"))
                self._send_handshake(conn)
                pending.append(conn)
            for conn in pending:
                self._register_conn(conn)
        finally:
            listener.close()  # also unblocks the acceptor thread if we raised

    @staticmethod
    def _accept_in_background(listener, count):
        """Accept ``count`` connections on a helper thread (so this one can watch the
        children meanwhile); returns the queue they, or the acceptor's error, land in."""
        accepted = queue.Queue()

        def _accept_loop():
            try:
                for _ in range(count):
                    accepted.put(listener.accept())
            except Exception as e:  # noqa: BLE001 — surfaced by _await_accept
                accepted.put(e)

        threading.Thread(target=_accept_loop, name="ptpu-torch-accept", daemon=True).start()
        return accepted

    def _await_accept(self, accepted, procs, what, check_stop=False, deadline=120.0):
        """One accepted connection, polling the children every second: a child that dies
        before it connects (an import error, a crash) raises here instead of hanging."""
        waited = 0.0
        while True:
            try:
                item = accepted.get(timeout=1.0)
                break
            except queue.Empty:
                waited += 1.0
                if check_stop and self._stop_event.is_set():
                    raise RuntimeError("pool stopping during respawn")
                for p in procs:
                    if p.poll() is not None:
                        raise RuntimeError(
                            "%s exited with code %s before connecting (run 'python -m "
                            "petastorm_tpu_torch._child_worker' to debug)"
                            % (what, p.returncode))
                if waited > deadline:
                    raise TimeoutWaitingForResultError(
                        "%s did not connect within %.0fs" % (what, deadline))
        if isinstance(item, Exception):
            raise item
        return item

    def _send_handshake(self, conn):
        """This process's sys.path, the serializer's name (and the ring's segments on
        the shared-memory wire), the health settings, the worker. The health settings
        go to every child, monitor or not: the stack-dump hook costs nothing until it is
        signalled and the pings ride the socket, so a monitor attached after the pool
        started still gets its evidence."""
        conn.send(list(sys.path))
        conn.send(self._serializer_name)
        if self._ring is not None:
            conn.send((self._ring.names, self._ring.slab_bytes))
        with self._respawn_lock:
            dump_dir = self._tmpdir
        conn.send({"stack_dump_dir": dump_dir, "ping_interval_s": self._ping_interval_s})
        conn.send(self._worker)

    def _await_pid_ack(self, conn, deadline=120.0):
        """The child's ``("pid", pid)``, sent once it has unpickled the worker."""
        waited = 0.0
        while not conn.poll(1.0):
            waited += 1.0
            if waited > deadline:
                raise TimeoutWaitingForResultError(
                    "pool child connected but never sent its pid ack (worker unpickle "
                    "wedged?)")
        ack = conn.recv()
        if not (isinstance(ack, tuple) and len(ack) == 2 and ack[0] == "pid"):
            raise RuntimeError("unexpected pool-child handshake ack %r" % (ack,))
        return ack[1]

    def _spawn_one(self, idx=None):
        """Spawn and handshake one replacement child for feeder ``idx``; returns its
        connection. Raises when it cannot start or the pool is stopping (the child is
        then killed). On the tcp transport a child whose link cannot be established is
        replaced by a pipe-connected one: all links down degrades to the local pool,
        never a hang."""
        if self._transport_name == "tcp" and self._hub is not None:
            try:
                return self._spawn_one_tcp(idx)
            except Exception as e:  # noqa: BLE001 — degrade to the local pool
                if self._stop_event.is_set():
                    raise
                from petastorm_tpu_torch.obs.log import degradation

                degradation("transport_link_down", "tcp child spawn could not establish "
                            "a link (%s); falling back to a pipe-connected local child",
                            e, once=False)
        return self._spawn_one_pipe(idx)

    def _spawn_one_tcp(self, idx):
        """One replacement child over a fresh hub session."""
        hub, sid, transport = self._new_session()
        p = None
        try:
            p = self._popen_child(hub.address_for(sid), self._authkey)
            self._await_tcp_connected(transport, [p], "respawned pool child",
                                      check_stop=True)
            self._send_handshake(transport)
            self._await_pid_ack(transport)
            transport.mark_ready()
            with self._respawn_lock:
                if self._stop_event.is_set():
                    raise RuntimeError("pool stopping during respawn")
                self._procs.append(p)
                self._conns.append(transport)
                if idx is not None:
                    self._child_by_idx[idx] = p
            return transport
        except BaseException:
            hub.drop_session(sid)
            transport.close()
            if p is not None:
                p.kill()
                p.wait()
            raise

    def _spawn_one_pipe(self, idx):
        """One replacement child over a fresh unix socket."""
        from multiprocessing.connection import Listener

        from petastorm_tpu_torch.transport import PipeTransport

        with self._respawn_lock:
            if self._tmpdir is None:
                raise RuntimeError("pool stopping during respawn")
            self._spawn_counter += 1
            address = os.path.join(self._tmpdir, "sock-r%d" % self._spawn_counter)
        authkey = os.urandom(32)
        listener = Listener(address, family="AF_UNIX", authkey=authkey)
        p = None
        conn = None
        try:
            p = self._popen_child(address, authkey)
            accepted = self._accept_in_background(listener, 1)
            conn = PipeTransport(self._await_accept(accepted, [p], "respawned pool child",
                                                    check_stop=True))
            self._send_handshake(conn)
            self._await_pid_ack(conn)
            conn.mark_ready()
            with self._respawn_lock:
                # join() may have begun meanwhile: registering into cleared lists would
                # leak an unreaped child and an open socket
                if self._stop_event.is_set():
                    raise RuntimeError("pool stopping during respawn")
                self._procs.append(p)
                self._conns.append(conn)
                if idx is not None:
                    self._child_by_idx[idx] = p
            return conn
        except BaseException:
            if conn is not None:
                try:
                    conn.close()
                except OSError:
                    pass
            if p is not None:
                p.kill()
                p.wait()
            raise
        finally:
            listener.close()

    def _respawn(self, err, idx=None, charged=True):
        """A replacement connection for a dead child, or None when the budget is spent,
        the pool is stopping, or the spawn fails. ``charged=False`` is the quarantine
        path: the dead child's item reached the poison threshold and is skipped, so the
        respawn only restores the pool's capacity and costs no budget."""
        from petastorm_tpu_torch.parallel.shm_ring import degradation

        with self._respawn_lock:
            if self._stop_event.is_set():
                return None
            if charged:
                if self._respawn_budget <= 0:
                    return None
                self._respawn_budget -= 1
            budget_left = self._respawn_budget
        try:
            conn = self._spawn_one(idx)
        except Exception as e:  # noqa: BLE001 — the caller raises WorkerDiedError
            degradation("respawn_failed", "Pool child respawn failed: %s", e, once=False)
            return None
        with self._stats_lock:
            self._pool_stats["respawns"] += 1
        degradation("worker_died", "Pool worker died (%s); respawned a replacement, "
                    "its item %s (respawn budget left: %d)", err,
                    "dispatched again" if charged else "quarantined", budget_left,
                    once=False)
        return conn

    # -- the live resize -------------------------------------------------------------------

    def _should_retire(self):
        """Claim one pending retirement: feeders check between items only, so a shrink
        drains and never interrupts an item."""
        with self._active_lock:
            if self._retire > 0:
                self._retire -= 1
                return True
            return False

    def set_lookahead(self, lookahead):
        """Retune the dispatcher's claim window: the hints sent with each item (a
        child's own readahead pool follows its control frame)."""
        self._lookahead = max(0, int(lookahead))
        dispatch = self._dispatch
        if dispatch is not None:
            dispatch.set_lookahead(self._lookahead)

    @property
    def alive_workers(self):
        """Feeders (children) running now (retiring ones count until they drain out)."""
        return self._active

    @property
    def target_workers(self):
        return self._target

    def resize(self, workers_count):
        """Grow or shrink the child fleet live. A grow spawns clean children through
        the pool's handshake (on the calling thread); a shrink queues retirements: a
        retiring feeder finishes its item, hands its claim back to the dispatcher, sends
        its child the orderly shutdown and exits. Never kills mid-item; the delivered and
        quarantined items are those of an un-resized run. Returns the applied target (a
        failed spawn leaves the fleet smaller, with a ``ctl_spawn_failed``
        degradation)."""
        n = max(1, int(workers_count))
        dispatch = self._dispatch
        grow_idxs = []
        with self._active_lock:
            if dispatch is None or self._active == 0:
                return self._target
            if n > self._target:
                grow = n - self._target
                cancelled = min(grow, self._retire)
                self._retire -= cancelled
                for _ in range(grow - cancelled):
                    grow_idxs.append(self._next_idx)
                    self._next_idx += 1
                # reserved before the slow spawns: a feeder exiting meanwhile must not
                # see the fleet at zero and end the stream
                self._active += len(grow_idxs)
            elif n < self._target:
                self._retire += self._target - n
            self._target = n
            next_idx = self._next_idx
        if not grow_idxs:
            return n
        dispatch.ensure_workers(next_idx)
        for idx in grow_idxs:
            try:
                conn = self._spawn_one(idx)
            except Exception as e:  # noqa: BLE001 — degrade, never fail the pool
                from petastorm_tpu_torch.obs.log import degradation

                degradation("ctl_spawn_failed", "a live fleet grow could not spawn a "
                            "pool child (%s); running one worker below the target", e,
                            once=False)
                with self._active_lock:
                    self._target -= 1
                    self._active -= 1
                    last = self._active == 0
                if last:
                    self._put(_DONE)  # the reservation was the last holdout
                continue
            self._start_feeder(conn, idx, dispatch)
        with self._active_lock:
            return self._target

    def _retire_driver(self, dispatch, fatal):
        """A feeder's exit, with ThreadExecutor._retire_worker's rescue: the last feeder
        out that finds handed-back items in the dispatcher spawns a rescue child instead
        of ending the stream."""
        rescue_idx = None
        with self._active_lock:
            self._active -= 1
            if self._active == 0 and not fatal and not self._stop_event.is_set() \
                    and dispatch.has_work():
                self._active += 1
                rescue_idx = self._next_idx
                self._next_idx += 1
            last = self._active == 0
        if rescue_idx is not None:
            try:
                conn = self._spawn_one(rescue_idx)
                dispatch.ensure_workers(rescue_idx + 1)
                self._start_feeder(conn, rescue_idx, dispatch)
                return
            except Exception as e:  # noqa: BLE001 — degrade to the stream's end
                from petastorm_tpu_torch.obs.log import degradation

                degradation("ctl_rescue_failed", "the rescue child for handed-back items "
                            "could not start (%s); those items are lost for this pass",
                            e, once=False)
                with self._active_lock:
                    self._active -= 1
                    last = self._active == 0
        if last:
            self._put(_DONE)  # outside the lock

    # -- the live knob frames -----------------------------------------------------------

    def broadcast_io_knobs(self, knobs):
        """Queue a ``{knob: value}`` retune for every running child: each feeder sends
        one ``("ctl", knobs)`` frame before its next item, the child applies it through
        its worker's ``apply_<knob>()`` and acks. Children spawned later inherit the
        retune through the worker's pickle."""
        if not knobs:
            return
        with self._ctl_lock:
            self._ctl_pending.update(knobs)
            self._ctl_version += 1

    def _pending_ctl(self, idx):
        """The control frame feeder ``idx`` still owes its child, or None."""
        with self._ctl_lock:
            if not self._ctl_pending or self._ctl_seen.get(idx, 0) == self._ctl_version:
                return None
            self._ctl_seen[idx] = self._ctl_version
            return dict(self._ctl_pending)

    def _rearm_ctl(self, idx):
        """A replacement child: the dead child's acks go, and the pending frame is sent
        again (applies are idempotent)."""
        with self._ctl_lock:
            self._ctl_acks.pop(idx, None)
            self._ctl_seen[idx] = 0

    def ctl_acks(self):
        """``{feeder index: {knob: applied value}}`` of the children that confirmed a
        live retune."""
        with self._ctl_lock:
            return {idx: dict(acks) for idx, acks in self._ctl_acks.items()}

    # -- the feeders -------------------------------------------------------------------

    def update_settings(self, **settings):
        """Worker attributes for the running children (``apply_settings`` on the
        worker), sent with each child's next item; a child spawned later gets them with
        the worker pickle, so the caller sets them on the worker too."""
        with self._settings_lock:
            self._settings.update(settings)
            self._settings_version += 1

    def _pending_settings(self, seen):
        """``(settings or None, version)`` for a feeder that last sent ``seen``."""
        with self._settings_lock:
            if seen == self._settings_version:
                return None, seen
            return dict(self._settings), self._settings_version

    def _recv_result(self, conn, idx=None):
        """The next result header, in a poll loop that gives up once the pool stops.
        The child's ``("hb", wall_ts)`` pings are drained here into its heartbeat
        (``worker.child-<idx>``; dropped without a monitor)."""
        if _chaos.ACTIVE is not None:
            _chaos.ACTIVE.hit("pool.recv")
        while True:
            while not conn.poll(0.2):
                if self._stop_event.is_set():
                    raise EOFError("pool stopping while awaiting a child result")
            msg = conn.recv()
            if isinstance(msg, tuple) and len(msg) == 2 and msg[0] == "hb":
                child_hb = self._child_slots.heartbeat(idx) if idx is not None else None
                if child_hb is not None:
                    child_hb.beat("working")
                continue
            if isinstance(msg, tuple) and len(msg) == 2 and msg[0] == "ctl_ack":
                if idx is not None:
                    with self._ctl_lock:
                        self._ctl_acks.setdefault(idx, {}).update(msg[1] or {})
                continue
            return msg

    def _feed_child(self, conn, idx, dispatch):
        from petastorm_tpu_torch.serializers import KIND_SHM

        # a local snapshot: join() takes self._ring while a straggling feeder may still
        # be mid-item (the ring stays safe to call; close() makes release a no-op)
        ring = self._ring
        slab_wait_s = 0.0 if self.wire_views else 2.0
        recovery = self._recovery
        seen = 0
        first = True  # this child's first item (its imports and file opens included)
        fatal = False
        feeder_slots, child_slots = self._feeder_slots, self._child_slots
        try:
            while not fatal and not self._stop_event.is_set():
                if self._should_retire():
                    # a live shrink: the claim goes back, the child gets its shutdown
                    # below and is reaped at join()
                    dispatch.withdraw(idx)
                    with self._respawn_lock:
                        self._child_by_idx.pop(idx, None)
                    break
                # this feeder's heartbeat, always in a wait state; resolved at each use,
                # as the monitor can be attached mid-stream
                hb = feeder_slots.heartbeat(idx)
                if hb is not None:
                    hb.wait("claim")
                claim = dispatch.next(idx)
                if claim is None:
                    break
                item, upcoming = claim
                hints = list(upcoming)  # the child prefetches these before the item
                prov = self._prov
                prov_id = _prov.item_identity(item) if prov is not None else None
                attempts = 0  # failures of this item, across respawns
                first_death = None
                self._inflight_attempts[idx] = 0
                while True:  # attempts: a dead child's item goes to its replacement
                    hb = feeder_slots.heartbeat(idx)
                    slab = None
                    if ring is not None:
                        if hb is not None:
                            hb.wait("slab")  # the consumer holds the slabs
                        t_slab = time.perf_counter() if prov is not None else 0.0
                        slab = ring.acquire(timeout=slab_wait_s)
                        if prov is not None:
                            prov.add_item_span(prov_id[0], prov_id[1], "wire.slab_wait",
                                               t_slab, time.perf_counter(),
                                               key=prov_id[2])
                        if slab is None:  # ring empty: this item takes the socket
                            ring.count_fallback()
                    try:
                        monitor = self._health
                        if hb is not None:
                            # the feeder only waits here; the child's heartbeat (stamped
                            # at the send, from its pings and at its result) carries the
                            # stall detection
                            hb.wait("child")
                        t0 = time.perf_counter() if monitor is not None else 0.0
                        if _chaos.ACTIVE is not None:
                            _chaos.ACTIVE.hit("pool.dispatch", key=_chaos.item_key(item))
                        # the in-flight ledger (a no-op on the pipe): the item is
                        # tracked on its link until its result is fully received;
                        # whatever is still tracked at a link death goes out again
                        conn.track(item)
                        settings, seen = self._pending_settings(seen)
                        ctl = self._pending_ctl(idx)
                        if ctl is not None:
                            # a live knob retune rides ahead of the item; the child
                            # applies it and acks (drained by _recv_result)
                            conn.send(("ctl", ctl))
                        child_slots.begin(idx)
                        t_send = time.perf_counter() if prov is not None else 0.0
                        conn.send((slab, item, hints, settings) if ring is not None
                                  else (item, hints, settings))
                        try:
                            header = self._recv_result(conn, idx)
                        finally:
                            child_slots.end(idx, "idle")
                        if prov is not None:
                            # the child's spans, once merged, nest inside this one: the
                            # fold charges the wire its overhead only
                            prov.add_item_span(prov_id[0], prov_id[1], "wire.roundtrip",
                                               t_send, time.perf_counter(),
                                               key=prov_id[2])
                        if monitor is not None:
                            monitor.observe_worker(idx, time.perf_counter() - t0)
                        if header[0] == "exc":
                            conn.settle()  # the conversation completed
                            if slab is not None:
                                ring.release(slab)
                            attempts += 1
                            self._inflight_attempts[idx] = attempts
                            verdict = self._failed_attempt(item, header[1], attempts)
                            if verdict == "retry":
                                continue  # again, on the same live child
                            fatal = verdict == "fatal"
                            break
                        _, kind, nframes, timing, io, spans = header
                        # the frames first: a link that dies before the result is whole
                        # leaves nothing of it counted
                        frames = [conn.recv_bytes() for _ in range(nframes)]
                        conn.settle()  # the result is off the link
                        if io:
                            with self._stats_lock:
                                self._child_io[idx] = io
                        if self._tenant_label is not None:
                            # the child's registry is its own: its worker seconds are
                            # charged here, where the parent's metrics are read
                            _tenant.charge("worker_s", timing[0],
                                           label=self._tenant_label)
                        tracer = self._tracer
                        if tracer is not None and spans is not None:
                            # (pid, wall anchor, perf anchor, spans, provenance blob):
                            # onto this recorder's timeline, on the child's pid lane
                            tracer.add_child(spans[0], spans[3], spans[1], spans[2])
                        if prov is not None and spans is not None and spans[4] is not None:
                            # the child's item record, on the same anchors
                            prov.absorb_child(spans[4], spans[0], spans[1], spans[2])
                        if slab is not None and kind != KIND_SHM:
                            # granted but unused (a payload larger than a slab)
                            ring.release(slab)
                            ring.count_fallback()
                            slab = None
                        # a shm descriptor hands the slab to deserialize(), which returns
                        # it on its own failure or leases it to the consumer: `slab` is
                        # cleared first so no path here releases it twice
                        granted, slab = slab, None
                        t_dec = time.perf_counter() if prov is not None else 0.0
                        try:
                            if _chaos.ACTIVE is not None:
                                frames = _chaos.ACTIVE.hit(
                                    "wire.decode", key=_chaos.item_key(item),
                                    payload=frames)
                            result = self._serializer.deserialize(kind, frames)
                            if prov is not None:
                                # covers the chaos site too: an injected wire stall
                                # lands in this span's self time
                                prov.add_item_span(prov_id[0], prov_id[1], "wire.decode",
                                                   t_dec, time.perf_counter(),
                                                   key=prov_id[2])
                        except Exception as e:  # noqa: BLE001 — classified by the policy
                            if granted is not None and not getattr(e, "slab_released",
                                                                   True):
                                ring.release(granted)
                            # the child is alive and the socket intact: a payload that
                            # fails to decode is a failed attempt, never a child death
                            attempts += 1
                            self._inflight_attempts[idx] = attempts
                            verdict = self._failed_attempt(item, e, attempts,
                                                           kind="wire_decode")
                            if verdict == "retry":
                                continue  # dispatch again, on the same live child
                            fatal = verdict == "fatal"
                            break
                    except _CHILD_GONE as e:
                        if slab is not None:
                            ring.reclaim(slab)  # revokes a consumer lease, if one views it
                        if self._stop_event.is_set():
                            fatal = True  # teardown, not a child failure
                            break
                        attempts += 1
                        self._inflight_attempts[idx] = attempts
                        first_death = first_death or e
                        # the death that reaches the threshold quarantines the item and
                        # respawns uncharged; earlier deaths charge the budget
                        poison = recovery.quarantine \
                            and attempts >= recovery.poison_attempts
                        # a tcp link death with the child alive: the child redials and
                        # the hub adopts the new link; the item goes out again on it. An
                        # attempt is charged (a frame that reliably kills its link is
                        # poison like any other) but not the respawn budget. Under
                        # on_poison='raise' the poison threshold bounds this too: past
                        # it the respawn path (its budget, then WorkerDiedError) takes
                        # over, never an unbounded reconnect loop. A pipe has no
                        # reconnect: a dead pipe is a dead child.
                        reconnect = getattr(conn, "reconnect", None)
                        if reconnect is not None and not self._stop_event.is_set() \
                                and (recovery.quarantine
                                     or attempts < recovery.poison_attempts):
                            with self._respawn_lock:
                                proc = self._child_by_idx.get(idx)
                            if proc is not None and proc.poll() is None and reconnect():
                                # the settings and a knob frame may have died with the
                                # old link: both go again (applies are idempotent)
                                seen = 0
                                with self._ctl_lock:
                                    if self._ctl_pending:
                                        self._ctl_seen[idx] = 0
                                if poison:
                                    self._put(QuarantinedItem(item, e, attempts,
                                                              kind="link_death"))
                                    break
                                continue  # dispatch again, on the healed link
                        replacement = self._respawn(e, idx, charged=not poison)
                        if poison:
                            self._put(QuarantinedItem(item, e, attempts,
                                                      kind="child_death"))
                        if replacement is None:
                            if not self._stop_event.is_set():
                                self._put(_ExcResult(WorkerDiedError(
                                    "worker process died%s and no replacement could be "
                                    "spawned (respawn budget exhausted, or the spawn "
                                    "failed): %s" % (" %d times on one item" % attempts
                                                     if attempts > 1 else "", first_death),
                                    original=first_death)))
                            fatal = True
                            break
                        try:
                            conn.close()
                        except OSError:
                            pass
                        hub = self._hub
                        if hub is not None and hasattr(conn, "session"):
                            # a zombie child redialing its dead session must find it
                            # gone, not be adopted into a closed transport
                            hub.drop_session(conn.session)
                        conn = replacement
                        seen = 0  # the fresh child gets the current settings again
                        self._rearm_ctl(idx)  # and the pending knob frame
                        first = True
                        if poison:
                            break  # quarantined: the fresh child takes the next item
                        continue
                    self._count_item(timing, first)
                    first = False
                    hb = feeder_slots.heartbeat(idx)
                    if hb is not None:
                        hb.wait("results_put")  # a full results queue is backpressure
                    self._put(result)
                    break
            try:
                conn.send(None)  # orderly shutdown
            except OSError:
                pass
        finally:
            feeder_slots.retire(idx)
            child_slots.retire(idx)
            self._retire_driver(dispatch, fatal)

    def _failed_attempt(self, item, error, attempts, kind="exception"):
        """The poison policy on a failed attempt of ``item`` whose child lives on:
        ``"fatal"`` (the error is on the results queue: no quarantine), ``"quarantined"``
        (its marker is, after ``poison_attempts`` failures) or ``"retry"``."""
        if not self._recovery.quarantine:
            self._put(_ExcResult(error))
            return "fatal"
        if attempts >= self._recovery.poison_attempts:
            self._put(QuarantinedItem(item, error, attempts, kind=kind))
            return "quarantined"
        return "retry"

    def _count_item(self, timing, first):
        with self._stats_lock:
            st = self._pool_stats
            if st["first_result_s"] is None:
                st["first_result_s"] = time.perf_counter() - self._t_start
            st["items"] += 1
            st["child_work_s"] += timing[0]
            if first:
                st["child_first_work_s"] += timing[0]
            st["child_serialize_s"] += timing[1]

    def _put(self, value):
        # yields to a set stop event: the consumer who set it never reads again; a
        # result dropped here returns its slab at once
        while True:
            try:
                self._results.put(value, timeout=0.1)
                return
            except queue.Full:
                if self._stop_event.is_set():
                    _release_result(value)
                    return

    # -- the consumer's side -----------------------------------------------------------

    def set_trace(self, tracer):
        """Merge the children's per-item spans (``child.work``, ``child.serialize``)
        into ``tracer`` on one pid lane each, and record the slab ring's
        ``shm.acquire_wait`` spans there (None: stop). Without a recorder the spans the
        children send are dropped."""
        self._tracer = tracer
        ring = self._ring
        if ring is not None:
            ring.set_trace(tracer)

    def set_provenance(self, recorder):
        """Record the wire's spans (``wire.slab_wait``, ``wire.roundtrip``,
        ``wire.decode``) on ``recorder`` and merge the children's item records into it
        (None: stop). The children always send their records; without a recorder they
        are dropped."""
        self._prov = recorder

    def set_health(self, monitor):
        """Attach a health monitor (or a scope of one; None detaches): the feeders and
        children heartbeat as the class docstring says, and this pool registers on the
        monitor its stack provider (:meth:`_dump_child_stacks`) and its healer
        (:meth:`_heal_stalled`), moved off a previous monitor first. A child already
        working an item is watched from the moment it was sent the item."""
        _attach_health(self, monitor, self._child_slots)
        if monitor is self._stack_provider_monitor:
            return
        old, self._stack_provider_monitor = self._stack_provider_monitor, None
        handle, self._stack_provider_handle = self._stack_provider_handle, None
        healer, self._healer_handle = self._healer_handle, None
        if old is not None:
            if handle is not None:
                old.remove_stack_provider(handle)
            if healer is not None:
                old.remove_healer(healer)
        if monitor is not None:
            self._stack_provider_handle = monitor.add_stack_provider(
                self._dump_child_stacks)
            self._healer_handle = monitor.add_healer(self._heal_stalled)
            self._stack_provider_monitor = monitor

    def _dump_child_stacks(self):
        """Signal this pool's live children to dump their stacks (SIGUSR1, which each
        child's faulthandler answers by writing every thread's stack to
        ``stacks-<pid>.txt`` in the pool's directory) and collect the files: the stall
        watchdog's evidence from across the process boundary. Only this pool's own
        children are signalled. A child that has not written a stable dump within about
        2 s is reported as such, not waited on."""
        import signal

        if not hasattr(signal, "SIGUSR1"):
            return {}  # not POSIX: the driver's stacks only
        with self._respawn_lock:
            procs = list(self._procs)
            tmpdir = self._tmpdir
        if not procs or not tmpdir:
            return {}

        def _path(pid):
            return os.path.join(tmpdir, "stacks-%d.txt" % pid)

        def _size(pid):
            try:
                return os.path.getsize(_path(pid))
            except OSError:
                return 0

        # faulthandler appends to the child's open file: only the bytes written after
        # this signal belong to this capture
        alive = []
        offsets = {}
        for p in procs:
            if p.poll() is None:
                offsets[p.pid] = _size(p.pid)
                try:
                    p.send_signal(signal.SIGUSR1)
                    alive.append(p)
                except OSError:
                    pass
        out = {}
        pending = {p.pid for p in alive}
        partial = {}  # pid -> the last read: a dump is taken once it stops growing
        deadline = time.monotonic() + 2.0
        while pending and time.monotonic() < deadline:
            time.sleep(0.05)
            for pid in list(pending):
                try:
                    with open(_path(pid)) as f:
                        f.seek(offsets[pid])
                        text = f.read()
                except OSError:
                    continue
                if not text.strip():
                    continue
                if partial.get(pid) == text:
                    out["child-%d" % pid] = text
                    pending.discard(pid)
                else:
                    partial[pid] = text
        for pid in pending:
            out["child-%d" % pid] = (
                partial[pid] + "\n<truncated: dump still growing at 2s>"
                if pid in partial else "<no faulthandler dump within 2s>")
        return out

    def _heal_stalled(self, stalled):
        """The healer of ``escalation="heal"``: kill the hung child behind each
        stalled ``worker.child-<i>`` actor of this pool, so that its feeder's
        child-death path takes over (respawn against the budget, slab reclaim, the item
        dispatched again or quarantined at the poison threshold). Returns the actor
        names it acted on. A kill that neither the respawn budget nor the poison policy
        can absorb is not made: it would only turn the stall into a
        ``WorkerDiedError``, and left alone the watchdog delivers the ``StallError``
        with the hang's evidence.

        Runs on the watchdog thread. An actor matches only by the full (scope-prefixed)
        name this pool registered, so on a shared monitor one pipeline's healer never
        kills a sibling's child."""
        import re

        from petastorm_tpu_torch.obs.log import degradation

        healed = set()
        if self._stop_event.is_set():
            return healed
        for st in stalled:
            actor = st.get("actor", "")
            m = re.search(r"(?:^|/)worker\.child-(\d+)$", actor)
            if m is None:
                continue
            idx = int(m.group(1))
            if actor != self._child_actor_name(idx):
                continue  # a sibling pipeline's child on a shared monitor
            with self._respawn_lock:
                proc = self._child_by_idx.get(idx)
                budget = self._respawn_budget
            attempts = self._inflight_attempts.get(idx, 0)
            if proc is None or proc.poll() is not None:
                continue  # already dead: its feeder is respawning it
            absorbable = budget > 0 or (self._recovery.quarantine
                                        and attempts + 1 >= self._recovery.poison_attempts)
            if not absorbable:
                continue
            try:
                proc.kill()
            except OSError:
                continue
            degradation("stall_heal_kill", "Heal tier killed hung pool child pid=%s "
                        "(actor %s, %.1fs past threshold); its item will be dispatched "
                        "again or quarantined", proc.pid, actor, st.get("age_s", 0.0),
                        once=False)
            healed.add(actor)
        return healed

    def _child_actor_name(self, idx):
        """The full (scope-prefixed) actor name of feeder ``idx``'s child."""
        base = "worker.child-%d" % idx
        namer = getattr(self._health, "_name", None)
        return namer(base) if namer is not None else base

    def results(self):
        """Generator of worker results; raises worker exceptions (a dead child past the
        respawn budget as :class:`~petastorm_tpu_torch.errors.WorkerDiedError`); ends
        when the plan is exhausted, or promptly once ``stop()`` was called."""
        return _iter_results(self)

    def wire_stats(self):
        """The shared-memory wire's gauges (slabs, grants, items and bytes through the
        slabs, socket fallbacks, acquire wait), ``{"shm_unavailable": 1}`` where the pool
        fell back to the socket wire, ``{}`` for the socket serializers."""
        if self._ring is not None:
            return self._ring.stats()
        if self._shm_unavailable:
            return {"shm_unavailable": 1}
        return {}

    def pool_stats(self):
        """Start-up and child-side counts: children, seconds from ``start()`` to every
        child's handshake (``spawn_s``) and to the first result (``first_result_s``),
        items, the children's seconds in the worker (all items, and each child's first
        item alone, which pays for its imports) and in the serializer, respawns."""
        with self._stats_lock:
            return dict(self._pool_stats)

    def child_io_stats(self):
        """``{feeder index: io_stats()}``: each child worker's read-path counts
        (readahead, caches, footer cache) as of its latest result; a respawned child
        starts its counts again."""
        with self._stats_lock:
            return {i: dict(v) for i, v in self._child_io.items()}

    def dispatch_stats(self):
        """The dispatcher's counts (``steals``); ``{}`` before ``start()``."""
        dispatch = self._dispatch
        return dispatch.stats() if dispatch is not None else {}

    def child_pids(self):
        """Process ids of the live children."""
        with self._respawn_lock:
            return [p.pid for p in self._procs if p.poll() is None]

    @property
    def wire_views(self):
        """True when results are read-only views into the slabs (a ``-view`` wire)."""
        from petastorm_tpu_torch.serializers import ShmSerializer

        return isinstance(self._serializer, ShmSerializer) and not self._serializer.writable

    def stop(self):
        self._stop_event.set()
        try:  # drain so blocked feeders can exit; dropped results return their slabs
            while True:
                _release_result(self._results.get_nowait())
        except (queue.Empty, AttributeError):
            pass

    def join(self):
        import shutil

        # join == no more results wanted: also aborts a respawn in flight
        self._stop_event.set()
        monitor, self._stack_provider_monitor = self._stack_provider_monitor, None
        handle, self._stack_provider_handle = self._stack_provider_handle, None
        healer, self._healer_handle = self._healer_handle, None
        if monitor is not None:
            # a stall after this point must neither signal nor kill this pool's children
            if handle is not None:
                monitor.remove_stack_provider(handle)
            if healer is not None:
                monitor.remove_healer(healer)
        for t in self._threads:
            t.join(timeout=10)
        self._threads = []
        self.stop()  # results a feeder put after the consumer's stop() return their slabs
        with self._respawn_lock:  # excludes a racing _spawn_one registration
            conns, self._conns = self._conns, []
            procs, self._procs = self._procs, []
            tmpdir, self._tmpdir = self._tmpdir, None
            ring, self._ring = self._ring, None
            hub, self._hub = self._hub, None
            self._child_by_idx = {}
            self._inflight_attempts = {}
        for conn in conns:
            try:
                conn.close()
            except OSError:
                pass
        if hub is not None:
            # after the links close, before the reaping: a child mid-redial finds the
            # connection refused and exits at its ceiling; stragglers are killed below
            hub.close()
        # one 5 s grace for the whole fleet, not one a child: a tcp child whose link died
        # mid-result redials the closed hub until its ceiling, and is killed instead
        deadline = time.monotonic() + 5.0
        for p in procs:
            try:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
            except Exception:  # noqa: BLE001 — a child that will not exit is killed
                p.kill()
                p.wait()
        if ring is not None:
            # after the children are reaped (no writer left): /dev/shm is clean even if
            # a consumer abandoned leased batches
            ring.close()
        if tmpdir:
            shutil.rmtree(tmpdir, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.stop()
        self.join()


def make_executor(reader_pool_type="thread", workers_count=4, results_queue_size=16,
                  results_timeout_s=300.0, serializer="pickle", worker_respawns=None,
                  shm_slab_bytes=None, shm_slabs=None, io_options=None, recovery=None,
                  transport=None):
    """Factory for the reference's ``reader_pool_type``: 'thread', 'process' or 'dummy'.

    ``serializer`` is the process pool's wire: 'pickle' or 'arrow' (socket frames), or
    the shared-memory family 'shm', 'shm-arrow' and their '-view' variants (see
    :mod:`petastorm_tpu_torch.serializers`); ``worker_respawns`` its respawn budget;
    ``shm_slab_bytes``/``shm_slabs`` size its slab ring. Thread and dummy pools share
    memory and ignore them. ``transport`` is the process pool's wire, validated for
    every pool: 'pipe' (default, or ``PTPU_TRANSPORT``) or 'tcp' (framed tcp over the
    pool's hub, with heartbeats, reconnect and the in-flight ledger). ``io_options``
    (:class:`~petastorm_tpu_torch.io.IoOptions`) sets the dispatch side of the read
    path: each worker's claim beyond its current item (``lookahead``, the readahead
    window) and work stealing. ``recovery``
    (:class:`~petastorm_tpu_torch.recovery.RecoveryOptions`, a dict of its fields, or
    None for the environment's defaults) sets every pool's poison policy and the process
    pool's respawn budget (an explicit ``worker_respawns`` wins).
    """
    from petastorm_tpu_torch.io import IoOptions
    from petastorm_tpu_torch.transport import normalize_transport

    transport = normalize_transport(transport)
    io_options = IoOptions.normalize(io_options)
    recovery = RecoveryOptions.normalize(recovery)
    lookahead = io_options.lookahead
    stealing = io_options.work_stealing
    if reader_pool_type in ("dummy", "sync"):
        return SyncExecutor(lookahead=lookahead, recovery=recovery)
    if reader_pool_type == "thread":
        return ThreadExecutor(workers_count, results_queue_size, results_timeout_s,
                              lookahead=lookahead, work_stealing=stealing,
                              recovery=recovery)
    if reader_pool_type == "process":
        return ProcessExecutor(workers_count, results_queue_size, results_timeout_s,
                               serializer=serializer, worker_respawns=worker_respawns,
                               shm_slab_bytes=shm_slab_bytes, shm_slabs=shm_slabs,
                               lookahead=lookahead, work_stealing=stealing,
                               recovery=recovery, transport=transport)
    raise ValueError("Unknown reader_pool_type %r (expected 'thread', 'process' or "
                     "'dummy')" % reader_pool_type)
