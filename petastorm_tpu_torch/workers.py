"""Worker executors: pull row-group work items from a plan, run a worker, stream results.

Port of the pools of ``petastorm_tpu.workers`` (``PullDispatcher``, ``SyncExecutor``,
``ThreadExecutor``, ``ProcessExecutor``, ``make_executor``). Backpressure is a bounded
results queue; the "ventilator" is the thread-safe
:class:`~petastorm_tpu_torch.plan.EpochPlan`, pulled through a :class:`PullDispatcher`:
bounded claims a worker (its readahead window, ``IoOptions.lookahead``) and work stealing
when the plan runs dry. Threads are the default pool: Arrow IO and the native entropy
decode release the GIL. The process pool runs the worker in clean child interpreters,
over a socket or a shared-memory slab wire (:mod:`petastorm_tpu_torch.serializers`); the
upcoming items of a child's claim ride with each item as its readahead hints.

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
``shm.acquire_wait`` spans into a :class:`~petastorm_tpu_torch.trace.TraceRecorder`. Not
ported (each raises ``NotImplementedError`` naming its ROADMAP.md item): the tcp
transport (item 4(c)); the stall healer and health (item 8b); control frames and the
live fleet resize (item 8c).

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
from petastorm_tpu_torch.recovery import QuarantinedItem, RecoveryOptions

_DONE = object()


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
    """

    def __init__(self, plan, workers_count, lookahead=0, stealing=True):
        self._iter = iter(plan)
        self._lock = threading.Lock()
        self._claims = [deque() for _ in range(max(1, workers_count))]
        self._exhausted = False
        self._lookahead = max(0, int(lookahead))
        self._stealing = bool(stealing)
        self.steals = 0

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
            if not claim:
                return None
            item = claim.popleft()  # the fill above keeps the hint window full
            return item, tuple(claim)

    def _fill(self, claim, target):
        # the caller holds self._lock
        while len(claim) < target and not self._exhausted:
            try:
                claim.append(next(self._iter))
            except StopIteration:
                self._exhausted = True

    def stats(self):
        return {"steals": self.steals}


class _ExcResult:
    def __init__(self, exc):
        self.exc = exc


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
    :class:`QuarantinedItem`; without quarantine the first exception propagates."""
    attempts = 0
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


class SyncExecutor:
    """Synchronous in-process execution (reference DummyPool): deterministic, for tests.

    Readahead still applies (``lookahead > 0`` and a worker with ``prefetch``): the
    upcoming items come from ``plan.peek``, so the single consumer keeps its order while
    the IO pool reads ahead of it. Under ``on_poison="quarantine"`` a failing item is
    tried again in place, up to ``poison_attempts`` times."""

    truncated = False

    def __init__(self, lookahead=0, recovery=None):
        self._worker = None
        self._plan = None
        self._stopped = False
        self._lookahead = max(0, int(lookahead))
        self._recovery = RecoveryOptions.normalize(recovery)

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

    def join(self):
        pass


class ThreadExecutor:
    """N threads pulling work items from the shared plan through a
    :class:`PullDispatcher` (bounded claims, work stealing); each hands the rest of its
    claim to the worker's ``prefetch`` before working an item. Bounded results queue =
    backpressure."""

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
        #: True when the result stream ended because ``stop()`` aborted it mid-pass
        self.truncated = False

    def start(self, worker, plan):
        self._results = queue.Queue(maxsize=self._queue_size)
        self._stop_event.clear()
        self.truncated = False
        self._active = self._workers_count
        self._dispatch = PullDispatcher(plan, self._workers_count,
                                        lookahead=self._lookahead,
                                        stealing=self._stealing)
        for i in range(self._workers_count):
            t = threading.Thread(target=self._run_worker, args=(worker, self._dispatch, i),
                                 daemon=True, name="ptpu-torch-worker-%d" % i)
            t.start()
            self._threads.append(t)

    def _run_worker(self, worker, dispatch, idx):
        prefetch = getattr(worker, "prefetch", None)
        try:
            while not self._stop_event.is_set():
                claim = dispatch.next(idx)
                if claim is None:
                    break
                item, upcoming = claim
                if prefetch is not None and upcoming:
                    prefetch(upcoming)  # never raises (degradation-counted)
                try:
                    result = _run_item(worker, item, self._recovery)
                except Exception as e:  # noqa: BLE001 — delivered to the consumer
                    self._put(_ExcResult(e))
                    break
                self._put(result)
        finally:
            with self._active_lock:
                self._active -= 1
                last = self._active == 0
            if last:
                self._put(_DONE)

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


class ProcessExecutor:
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
    """

    def __init__(self, workers_count=4, results_queue_size=16, results_timeout_s=300.0,
                 serializer="pickle", worker_respawns=None, shm_slab_bytes=None,
                 shm_slabs=None, lookahead=0, work_stealing=True, recovery=None):
        from petastorm_tpu_torch.serializers import make_serializer

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
        #: True when the result stream ended because ``stop()`` aborted it mid-pass
        self.truncated = False

    # -- start-up ----------------------------------------------------------------------

    def start(self, worker, plan):
        import tempfile

        self._results = queue.Queue(maxsize=self._queue_size)
        self._stop_event.clear()
        self.truncated = False
        self._worker = worker
        self._t_start = time.perf_counter()
        with self._stats_lock:
            self._pool_stats = {"children": self._workers_count, "spawn_s": None,
                                "first_result_s": None, "items": 0, "child_work_s": 0.0,
                                "child_first_work_s": 0.0, "child_serialize_s": 0.0,
                                "respawns": 0}
        self._authkey = os.urandom(32)
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
        try:
            self._start_children()
        except BaseException:
            self.join()  # no child, socket or slab outlives a failed start
            raise
        with self._stats_lock:
            self._pool_stats["spawn_s"] = time.perf_counter() - self._t_start
        with self._active_lock:
            self._active = len(self._conns)
        self._dispatch = PullDispatcher(plan, len(self._conns), lookahead=self._lookahead,
                                        stealing=self._stealing)
        with self._stats_lock:
            self._child_io = {}
        for i, conn in enumerate(self._conns):
            t = threading.Thread(target=self._feed_child,
                                 args=(conn, i, self._dispatch),
                                 daemon=True, name="ptpu-torch-feed-%d" % i)
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
                self._await_pid_ack(conn)
                with self._respawn_lock:
                    self._conns.append(conn)
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
        the shared-memory wire), the worker."""
        conn.send(list(sys.path))
        conn.send(self._serializer_name)
        if self._ring is not None:
            conn.send((self._ring.names, self._ring.slab_bytes))
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

    def _spawn_one(self):
        """Spawn and handshake one replacement child; returns its connection. Raises
        when it cannot start or the pool is stopping (the child is then killed)."""
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
            with self._respawn_lock:
                # join() may have begun meanwhile: registering into cleared lists would
                # leak an unreaped child and an open socket
                if self._stop_event.is_set():
                    raise RuntimeError("pool stopping during respawn")
                self._procs.append(p)
                self._conns.append(conn)
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

    def _respawn(self, err, charged=True):
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
            conn = self._spawn_one()
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

    def _recv_result(self, conn):
        """The next result header, in a poll loop that gives up once the pool stops."""
        if _chaos.ACTIVE is not None:
            _chaos.ACTIVE.hit("pool.recv")
        while not conn.poll(0.2):
            if self._stop_event.is_set():
                raise EOFError("pool stopping while awaiting a child result")
        return conn.recv()

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
        try:
            while not fatal and not self._stop_event.is_set():
                claim = dispatch.next(idx)
                if claim is None:
                    break
                item, upcoming = claim
                hints = list(upcoming)  # the child prefetches these before the item
                attempts = 0  # failures of this item, across respawns
                first_death = None
                while True:  # attempts: a dead child's item goes to its replacement
                    slab = None
                    if ring is not None:
                        slab = ring.acquire(timeout=slab_wait_s)
                        if slab is None:  # ring empty: this item takes the socket
                            ring.count_fallback()
                    try:
                        if _chaos.ACTIVE is not None:
                            _chaos.ACTIVE.hit("pool.dispatch", key=_chaos.item_key(item))
                        settings, seen = self._pending_settings(seen)
                        conn.send((slab, item, hints, settings) if ring is not None
                                  else (item, hints, settings))
                        header = self._recv_result(conn)
                        if header[0] == "exc":
                            if slab is not None:
                                ring.release(slab)
                            attempts += 1
                            verdict = self._failed_attempt(item, header[1], attempts)
                            if verdict == "retry":
                                continue  # again, on the same live child
                            fatal = verdict == "fatal"
                            break
                        _, kind, nframes, timing, io, spans = header
                        if io:
                            with self._stats_lock:
                                self._child_io[idx] = io
                        tracer = self._tracer
                        if tracer is not None and spans is not None:
                            # (pid, wall anchor, perf anchor, spans): onto this
                            # recorder's timeline, on the child's pid lane
                            tracer.add_child(spans[0], spans[3], spans[1], spans[2])
                        frames = [conn.recv_bytes() for _ in range(nframes)]
                        if slab is not None and kind != KIND_SHM:
                            # granted but unused (a payload larger than a slab)
                            ring.release(slab)
                            ring.count_fallback()
                            slab = None
                        # a shm descriptor hands the slab to deserialize(), which returns
                        # it on its own failure or leases it to the consumer: `slab` is
                        # cleared first so no path here releases it twice
                        granted, slab = slab, None
                        try:
                            if _chaos.ACTIVE is not None:
                                frames = _chaos.ACTIVE.hit(
                                    "wire.decode", key=_chaos.item_key(item),
                                    payload=frames)
                            result = self._serializer.deserialize(kind, frames)
                        except Exception as e:  # noqa: BLE001 — classified by the policy
                            if granted is not None and not getattr(e, "slab_released",
                                                                   True):
                                ring.release(granted)
                            # the child is alive and the socket intact: a payload that
                            # fails to decode is a failed attempt, never a child death
                            attempts += 1
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
                        first_death = first_death or e
                        # the death that reaches the threshold quarantines the item and
                        # respawns uncharged; earlier deaths charge the budget
                        poison = recovery.quarantine \
                            and attempts >= recovery.poison_attempts
                        replacement = self._respawn(e, charged=not poison)
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
                        conn = replacement
                        seen = 0  # the fresh child gets the current settings again
                        first = True
                        if poison:
                            break  # quarantined: the fresh child takes the next item
                        continue
                    self._count_item(timing, first)
                    first = False
                    self._put(result)
                    break
            try:
                conn.send(None)  # orderly shutdown
            except OSError:
                pass
        finally:
            with self._active_lock:
                self._active -= 1
                last = self._active == 0
            if last:
                self._put(_DONE)  # outside the lock

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
        for t in self._threads:
            t.join(timeout=10)
        self._threads = []
        self.stop()  # results a feeder put after the consumer's stop() return their slabs
        with self._respawn_lock:  # excludes a racing _spawn_one registration
            conns, self._conns = self._conns, []
            procs, self._procs = self._procs, []
            tmpdir, self._tmpdir = self._tmpdir, None
            ring, self._ring = self._ring, None
        for conn in conns:
            try:
                conn.close()
            except OSError:
                pass
        for p in procs:
            try:
                p.wait(timeout=5)
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
    memory and ignore them. ``transport`` is validated for every pool: 'pipe' (default,
    or ``PTPU_TRANSPORT``); 'tcp' is not ported. ``io_options``
    (:class:`~petastorm_tpu_torch.io.IoOptions`) sets the dispatch side of the read
    path: each worker's claim beyond its current item (``lookahead``, the readahead
    window) and work stealing. ``recovery``
    (:class:`~petastorm_tpu_torch.recovery.RecoveryOptions`, a dict of its fields, or
    None for the environment's defaults) sets every pool's poison policy and the process
    pool's respawn budget (an explicit ``worker_respawns`` wins).
    """
    from petastorm_tpu_torch.io import IoOptions
    from petastorm_tpu_torch.transport import normalize_transport

    normalize_transport(transport)
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
                               recovery=recovery)
    raise ValueError("Unknown reader_pool_type %r (expected 'thread', 'process' or "
                     "'dummy')" % reader_pool_type)
