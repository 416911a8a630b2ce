"""The port's transient-IO retry in the row-group read path, against the JAX package's
(ROADMAP.md Queue 1 item 8a).

Every case of the JAX package's ``tests/test_io_retry.py`` has a counterpart here, on
the port's factories and ``_WorkerBase``: transient ``OSError``s and errors born in a
storage client stack are retried with jittered exponential backoff, reopening the file
each time; permanent conditions fail at once. Beside them:

- ``_is_transient_io_error`` classifies a table of exceptions as the JAX package's does;
- the retry budget is spent once for a read across the readahead leg and the foreground
  leg, never once on each: a background read that exhausted it re-raises in the
  foreground with no attempt added, and under a fault every fourth read the retries
  counted (``ptpu_degradations_total{cause="io_retry"}``) equal the plan's injections;
- the retry reaches the process pool's children (their reads retry in the child, under
  their own copy of a propagated plan).
"""
import threading
import time

import numpy as np
import pyarrow.fs as pafs
import pytest

torch = pytest.importorskip("torch")

from _torch_pool_helpers import _no_leaked_shm_segments  # noqa: E402,F401
from _torch_pool_helpers import no_leaked_port_slabs  # noqa: E402,F401
from petastorm_tpu import reader as ref_reader  # noqa: E402
from petastorm_tpu_torch import chaos, make_batch_reader, make_reader  # noqa: E402
from petastorm_tpu_torch.recovery import RecoveryOptions  # noqa: E402


@pytest.fixture(autouse=True)
def _disarmed():
    chaos.disarm()
    yield
    chaos.disarm()


class FlakyFS:
    """A pyarrow-filesystem proxy whose ``open_input_file`` raises an error the first
    ``fail_times`` times after ``arm()`` (metadata discovery while the reader is built
    stays clean)."""

    def __init__(self, inner, exc_factory, fail_times):
        self._inner = inner
        self._exc_factory = exc_factory
        self._fail_budget = 0
        self._fail_times = fail_times
        self.open_calls = 0

    def arm(self):
        self._fail_budget = self._fail_times

    def open_input_file(self, path):
        self.open_calls += 1
        if self._fail_budget > 0:
            self._fail_budget -= 1
            raise self._exc_factory()
        return self._inner.open_input_file(path)

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        return getattr(self._inner, name)


@pytest.fixture()
def flaky_store(tmp_path):
    import pyarrow as pa
    import pyarrow.parquet as pq

    d = tmp_path / "store"
    d.mkdir()
    pq.write_table(pa.table({"id": np.arange(20, dtype=np.int64)}),
                   str(d / "part-0.parquet"), row_group_size=5)
    return str(d)


def _ids(reader):
    return sorted(int(v) for b in reader for v in np.asarray(b.id))


def test_transient_error_retried_to_success(flaky_store):
    fs = FlakyFS(pafs.LocalFileSystem(), lambda: ConnectionResetError("peer reset"),
                 fail_times=2)
    reader = make_batch_reader("file://" + flaky_store, filesystem=fs,
                               reader_pool_type="dummy", shuffle_row_groups=False,
                               num_epochs=1, io_retries=3, io_retry_backoff_s=0.01)
    fs.arm()
    with reader:
        assert _ids(reader) == list(range(20))
    assert fs.open_calls >= 3  # two failures and the reopen(s)


def test_retries_exhausted_propagates(flaky_store):
    fs = FlakyFS(pafs.LocalFileSystem(), lambda: TimeoutError("read timed out"),
                 fail_times=10)
    reader = make_batch_reader("file://" + flaky_store, filesystem=fs,
                               reader_pool_type="dummy", shuffle_row_groups=False,
                               num_epochs=1, io_retries=1, io_retry_backoff_s=0.01)
    fs.arm()
    with reader:
        with pytest.raises(TimeoutError):
            list(reader)


def test_zero_retries_is_fail_fast(flaky_store):
    fs = FlakyFS(pafs.LocalFileSystem(), lambda: ConnectionResetError("peer reset"),
                 fail_times=1)
    # readahead off: these cases count exact opens an attempt
    reader = make_batch_reader("file://" + flaky_store, filesystem=fs,
                               reader_pool_type="dummy", io_options={"readahead": False},
                               shuffle_row_groups=False, num_epochs=1, io_retries=0)
    fs.arm()
    calls_before = fs.open_calls
    with reader:
        with pytest.raises(ConnectionResetError):
            list(reader)
    assert fs.open_calls == calls_before + 1  # exactly one attempt


def test_permanent_error_not_retried(flaky_store):
    fs = FlakyFS(pafs.LocalFileSystem(), lambda: FileNotFoundError("gone"),
                 fail_times=10)
    reader = make_batch_reader("file://" + flaky_store, filesystem=fs,
                               reader_pool_type="dummy", io_options={"readahead": False},
                               shuffle_row_groups=False, num_epochs=1, io_retries=5,
                               io_retry_backoff_s=0.01)
    fs.arm()
    calls_before = fs.open_calls
    with reader:
        with pytest.raises(FileNotFoundError):
            list(reader)
    assert fs.open_calls == calls_before + 1  # permanent: no second attempt


def test_storage_stack_exception_retried(flaky_store):
    """fsspec-bridged stores raise their client stack's own types through pyarrow
    (``gcsfs.retry.HttpError`` is not an OSError): classified by origin module."""
    http_error = type("HttpError", (Exception,), {"__module__": "gcsfs.retry"})
    fs = FlakyFS(pafs.LocalFileSystem(), lambda: http_error("429 rate limited"),
                 fail_times=2)
    reader = make_batch_reader("file://" + flaky_store, filesystem=fs,
                               reader_pool_type="dummy", shuffle_row_groups=False,
                               num_epochs=1, io_retries=3, io_retry_backoff_s=0.01)
    fs.arm()
    with reader:
        assert _ids(reader) == list(range(20))


def test_non_storage_exception_not_retried(flaky_store):
    fs = FlakyFS(pafs.LocalFileSystem(), lambda: RuntimeError("not IO at all"),
                 fail_times=10)
    reader = make_batch_reader("file://" + flaky_store, filesystem=fs,
                               reader_pool_type="dummy", io_options={"readahead": False},
                               shuffle_row_groups=False, num_epochs=1, io_retries=5,
                               io_retry_backoff_s=0.01)
    fs.arm()
    calls_before = fs.open_calls
    with reader:
        with pytest.raises(RuntimeError):
            list(reader)
    assert fs.open_calls == calls_before + 1


def test_retry_through_threaded_per_row_reader(tmp_path):
    """The per-row path (make_reader) shares the retry; a flap under a concurrent pool
    heals without losing rows."""
    from petastorm_tpu_torch import types as ptypes
    from petastorm_tpu_torch.codecs import ScalarCodec
    from petastorm_tpu_torch.metadata import write_dataset
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField

    schema = Unischema("S", [
        UnischemaField("id", np.int64, (), ScalarCodec(ptypes.LongType()), False)])
    url = "file://" + str(tmp_path / "ps")
    write_dataset(url, schema, [{"id": i} for i in range(12)], rows_per_file=4)
    fs = FlakyFS(pafs.LocalFileSystem(), lambda: ConnectionResetError("peer reset"),
                 fail_times=2)
    reader = make_reader(url, filesystem=fs, reader_pool_type="thread", workers_count=2,
                         shuffle_row_groups=False, num_epochs=1, io_retries=3,
                         io_retry_backoff_s=0.01)
    fs.arm()
    with reader:
        assert sorted(int(r.id) for r in reader) == list(range(12))


def test_retry_runs_in_the_process_pools_children(flaky_store):
    """A child evaluates its own copy of a propagated plan and retries its own reads:
    each child's first read failing once still delivers every id once."""
    plan = chaos.FaultPlan([chaos.FaultRule("reader.read", "raise_transient", nth=1,
                                            times=1)])
    with chaos.armed(plan):  # propagated: the children arm from PTPU_CHAOS_SPEC
        with make_batch_reader("file://" + flaky_store, reader_pool_type="process",
                               workers_count=2, results_timeout_s=60,
                               shuffle_row_groups=False, num_epochs=1,
                               recovery=RecoveryOptions(io_retries=2,
                                                        io_retry_backoff_s=0)) as reader:
            assert _ids(reader) == list(range(20))
    assert plan.stats()["hits"] == [0]  # the parent read nothing itself


# -- the classification, against the JAX package's --------------------------------------


def _storage_error(module):
    return type("StoreError", (Exception,), {"__module__": module})("x")


@pytest.mark.parametrize("exc", [
    ConnectionResetError("reset"), TimeoutError("t"), OSError(5, "EIO"),
    BrokenPipeError(), ConnectionRefusedError(), FileNotFoundError("f"),
    PermissionError("p"), IsADirectoryError("d"), NotADirectoryError("n"),
    FileExistsError("e"), InterruptedError("i"), RuntimeError("r"), ValueError("v"),
    KeyError("k"), _storage_error("gcsfs.retry"), _storage_error("botocore.exceptions"),
    _storage_error("google.api_core.exceptions"), _storage_error("aiohttp.client"),
    _storage_error("pyarrow.lib"), _storage_error("mylib"),
], ids=lambda e: "%s-%s" % (type(e).__module__.split(".")[0], type(e).__name__))
def test_transient_classification_equals_the_jax_packages(exc):
    from petastorm_tpu_torch.reader import _is_transient_io_error

    assert _is_transient_io_error(exc) == ref_reader._is_transient_io_error(exc)


# -- the retry loop's own contract -------------------------------------------------------


class _Piece:
    def __init__(self, path="store/part-0.parquet", row_group=0):
        self.path = path
        self.row_group = row_group


def _bare_worker(io_retries, backoff_s=0.05, fail_times=0,
                 exc_factory=lambda: ConnectionResetError("reset"), readahead=False):
    """A _WorkerBase whose single read fails ``fail_times`` times, then succeeds, with
    the attempt, eviction and sleep counts exposed. Readahead is off unless asked for,
    so the synchronous retry loop is what runs; with it on, the pool is built by the
    first ``prefetch``."""
    from petastorm_tpu_torch.reader import _WorkerBase

    w = _WorkerBase(None, None, None, io_options={"readahead": readahead},
                    recovery=RecoveryOptions(io_retries=io_retries,
                                             io_retry_backoff_s=backoff_s))
    state = {"attempts": 0, "evictions": []}

    def fake_read_once(piece, columns):
        state["attempts"] += 1
        if state["attempts"] <= fail_times:
            raise exc_factory()
        return "table-%s-%d" % (piece.path, piece.row_group)

    w._read_columns_once = fake_read_once
    w._evict_parquet_file = state["evictions"].append
    w._first_read_columns = lambda: None  # abstract on the base: read every column
    w._cache_key = lambda item: None      # no schema here; the NullCache holds nothing
    return w, state


@pytest.fixture()
def recorded_sleep(monkeypatch):
    """The retry loop's backoff sleep, recorded instead of slept."""
    delays = []
    import petastorm_tpu_torch.reader as reader_mod

    monkeypatch.setattr(reader_mod.time, "sleep", delays.append)
    return delays


def test_retry_exactly_io_retries_attempts(recorded_sleep):
    w, state = _bare_worker(io_retries=3, fail_times=10)
    with pytest.raises(ConnectionResetError):
        w._read_columns(_Piece(), None)
    assert state["attempts"] == 4  # 1 initial + io_retries
    assert len(recorded_sleep) == 3  # one backoff a retry, never after the last
    assert state["evictions"] == [_Piece().path] * 3  # reopened between attempts


def test_retry_backoff_is_exponential_with_jitter(recorded_sleep):
    backoff = 0.1
    w, _ = _bare_worker(io_retries=3, backoff_s=backoff, fail_times=10)
    with pytest.raises(ConnectionResetError):
        w._read_columns(_Piece(), None)
    for attempt, delay in enumerate(recorded_sleep):
        base = backoff * 2 ** attempt
        assert base * 0.5 <= delay <= base * 1.5  # the jitter factor is 0.5 + U[0, 1)


def test_retry_backoff_is_capped(recorded_sleep):
    from petastorm_tpu_torch.reader import _WorkerBase

    w = _WorkerBase(None, None, None, io_options={"readahead": False},
                    recovery=RecoveryOptions(io_retries=6, io_retry_backoff_s=1.0,
                                             io_retry_max_backoff_s=2.5))
    w._read_columns_once = lambda piece, columns: (_ for _ in ()).throw(
        ConnectionResetError("reset"))
    w._evict_parquet_file = lambda path: None
    with pytest.raises(ConnectionResetError):
        w._read_columns_sync(_Piece(), None)
    assert len(recorded_sleep) == 6 and max(recorded_sleep) <= 2.5


def test_retry_success_after_transient_failures(recorded_sleep):
    w, state = _bare_worker(io_retries=2, fail_times=2)
    assert w._read_columns(_Piece(), None) == "table-store/part-0.parquet-0"
    assert state["attempts"] == 3
    assert len(recorded_sleep) == 2
    assert len(state["evictions"]) == 2


def test_permanent_error_fails_fast_no_sleep_no_evict(recorded_sleep):
    w, state = _bare_worker(io_retries=5, fail_times=10,
                            exc_factory=lambda: FileNotFoundError("gone"))
    with pytest.raises(FileNotFoundError):
        w._read_columns(_Piece(), None)
    assert state["attempts"] == 1
    assert recorded_sleep == []
    assert state["evictions"] == []


def test_readahead_failure_spends_the_same_retry_budget(recorded_sleep):
    """A prefetched read runs the same retry loop in the background, and its exhausted
    error surfaces from the foreground read: readahead grants no extra budget and the
    foreground adds no attempt."""
    w, state = _bare_worker(io_retries=1, fail_times=10, readahead=True)
    piece = _Piece()
    w.prefetch([(piece, 0)])
    try:
        # the background leg must run the attempts: wait for the IO thread (an Event,
        # not time.sleep, which the fixture records)
        pause = threading.Event()
        deadline = time.monotonic() + 5
        while state["attempts"] < 2 and time.monotonic() < deadline:
            pause.wait(0.005)
        assert state["attempts"] == 2  # 1 initial + io_retries, all in the background
        with pytest.raises(ConnectionResetError):
            w._read_columns(piece, None)
        assert state["attempts"] == 2  # the foreground added no attempt
        assert len(recorded_sleep) == 1
    finally:
        w.close()


def test_a_healed_background_read_is_a_hit_with_its_retries_counted_once(recorded_sleep):
    """The background leg absorbs a transient error; the foreground serves its table as
    a readahead hit, with one retry counted for the read, not two."""
    from petastorm_tpu_torch.obs.log import degradation_counts

    w, state = _bare_worker(io_retries=2, fail_times=1, readahead=True)
    piece = _Piece()
    before = degradation_counts().get("io_retry", 0)
    w.prefetch([(piece, 0)])
    try:
        pause = threading.Event()
        deadline = time.monotonic() + 5
        while state["attempts"] < 2 and time.monotonic() < deadline:
            pause.wait(0.005)
        assert w._read_columns(piece, None) == "table-store/part-0.parquet-0"
        assert state["attempts"] == 2 and len(recorded_sleep) == 1
        assert w.io_stats()["readahead_hits"] == 1
        assert degradation_counts().get("io_retry", 0) - before == 1
    finally:
        w.close()


@pytest.mark.parametrize("pool", ["dummy", "thread"])
def test_every_fourth_read_failing_delivers_every_id_with_the_injected_retries(pool,
                                                                             tmp_path):
    """The acceptance shape on the CPU: FaultRule("reader.read", "raise_transient",
    every=4) with readahead and coalescing at their defaults delivers every id once,
    and the io_retry count equals the plan's injections. A retry is a hit of the rule
    too, and other threads' hits land between a read's attempts, so a retry fails again
    about one time in four: io_retries=8 leaves a read's budget spent one time in
    4 ** 8."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from petastorm_tpu_torch.obs.log import degradation_counts

    for f in range(3):
        pq.write_table(pa.table({"id": np.arange(40, dtype=np.int64) + 40 * f}),
                       str(tmp_path / ("part_%d.parquet" % f)), row_group_size=5)
    plan = chaos.FaultPlan([chaos.FaultRule("reader.read", "raise_transient", every=4)],
                           seed=14)
    before = degradation_counts().get("io_retry", 0)
    with chaos.armed(plan, propagate=False):
        with make_batch_reader("file://" + str(tmp_path), reader_pool_type=pool,
                               workers_count=3, num_epochs=1,
                               recovery=dict(io_retries=8, io_retry_backoff_s=0)) as r:
            ids = [int(v) for b in r for v in np.asarray(b.id)]
            assert not r.quarantine_report
    assert sorted(ids) == list(range(120))
    fires = plan.stats()["injected_total"]
    assert fires > 0 and degradation_counts().get("io_retry", 0) - before == fires
