"""The port's dataset-watch plane against the JAX package's (ROADMAP.md Queue 1 item
8c(ii)): generation tokens, the growing plan, mid-read mutation survival, generation-
scoped cache invalidation, the watch thread and the chaos mutation actions.

Every case of the JAX package's ``tests/test_dataset_watch.py`` has a counterpart here
under the same name. The invariants they pin:

- a checkpoint taken across a mid-run ``EpochPlan.extend()`` resumes with nothing
  replayed and nothing lost;
- a file rewritten mid-read never gives rows of two generations to one epoch (the old
  generation's pending items quarantine as ``piece_rewritten``, the new generation is
  deferred to the next epoch);
- a file removed mid-read quarantines as ``piece_removed``, charged to the watermark;
- the disk cache never serves a stale decoded payload of a rewritten file, even when
  size and mtime collide (the footer crc in the generation-scoped key settles it).

Beside them, held against the JAX package with exact equality on the same seeded stores:
the tokens with and without the footer crc, ``metadata_crc`` of footers with statistics,
the stamped pieces, the ``(epoch, ordinal)`` streams and ``items_in_epoch`` of both
plans over seeded extension sequences, both watchers' deltas, the delivered ids per
epoch and the quarantine report under one mutation sequence (the dummy pool, then the
id sets on the thread and process pools), the ids after a resume across an extension,
a mutate-rule plan's JSON and ``applied`` list, and the stats panel a watched run's
Reporter JSONL renders. The port's own cases: the errors' retry class and their trip
through the process pool, one count a conflict in the parent, the readahead invariant
(a rewrite landing after the IO thread's checked read still delivers the stamped
generation), a thread's stale open handle never serving a new generation (ROADMAP.md
Queue 3 R), runs split by generation, and the pass-through of a rewritten file.
"""
import collections
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pyarrow as pa
import pyarrow.fs as pafs
import pyarrow.parquet as pq
import pytest

from _torch_pool_helpers import _no_leaked_shm_segments  # noqa: E402,F401
from petastorm_tpu import chaos as ref_chaos  # noqa: E402
from petastorm_tpu import plan as ref_plan  # noqa: E402
from petastorm_tpu import reader as ref_reader  # noqa: E402
from petastorm_tpu.dataset import watch as ref_watch  # noqa: E402
from petastorm_tpu.io import footercache as ref_footercache  # noqa: E402
from petastorm_tpu_torch import chaos  # noqa: E402
from petastorm_tpu_torch.dataset.watch import (  # noqa: E402
    DatasetWatcher,
    WatchOptions,
    generation_token,
    stamp_generation_tokens,
    tokens_match,
)
from petastorm_tpu_torch.errors import PieceRemovedError, PieceRewrittenError  # noqa: E402
from petastorm_tpu_torch.plan import EpochPlan  # noqa: E402
from petastorm_tpu_torch.reader import make_batch_reader  # noqa: E402
from petastorm_tpu_torch.recovery import RecoveryOptions  # noqa: E402

ROWS = 16


def _write_file(root, name, start, rows=ROWS, row_group_size=None, x=None, atomic=False):
    table = pa.table({
        "id": np.arange(start, start + rows, dtype=np.int64),
        "x": np.asarray(x if x is not None else np.full(rows, 1.0), dtype=np.float64),
    })
    full = os.path.join(root, name)
    # atomic: a temporary name the dataset listing skips, then a rename, so a watcher
    # never lists a file half written
    target = full + ".tmp-write" if atomic else full
    pq.write_table(table, target, row_group_size=row_group_size or rows)
    if atomic:
        os.replace(target, full)


@pytest.fixture()
def store(tmp_path):
    root = str(tmp_path / "ds")
    os.makedirs(root)
    for i in range(4):
        _write_file(root, "part_%03d.parquet" % i, i * ROWS)
    return root


@pytest.fixture(autouse=True)
def _disarmed():
    """No chaos plan of either package leaks into or out of a case."""
    chaos.disarm()
    ref_chaos.disarm()
    yield
    chaos.disarm()
    ref_chaos.disarm()


def _local_fs():
    return pafs.LocalFileSystem()


def _ids(reader):
    return [int(v) for b in reader for v in np.asarray(b.id)]


def _per_epoch(tagged):
    out = collections.defaultdict(list)
    for epoch, ids in tagged:
        out[epoch].extend(ids)
    return {e: sorted(v) for e, v in out.items()}


# -- generation tokens -------------------------------------------------------------------


def test_generation_token_stable_and_rewrite_sensitive(store):
    fs = _local_fs()
    path = os.path.join(store, "part_000.parquet")
    tok = generation_token(fs, path)
    assert tokens_match(tok, generation_token(fs, path))
    _write_file(store, "part_000.parquet", start=0, x=np.full(ROWS, 2.0))
    assert not tokens_match(tok, generation_token(fs, path))


def test_generation_token_crc_catches_size_mtime_collision(store):
    """A rewrite that collides on size and mtime is still another generation: the
    footer crc settles it."""
    fs = _local_fs()
    path = os.path.join(store, "part_000.parquet")
    st = os.stat(path)
    tok = generation_token(fs, path)
    _write_file(store, "part_000.parquet", start=0, row_group_size=ROWS // 2)
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns))  # collide the mtime
    fresh = generation_token(fs, path)
    assert fresh.split(".")[1] == tok.split(".")[1]  # the mtime half collides
    assert not tokens_match(tok, fresh)


def test_removed_file_raises_piece_removed(store):
    fs = _local_fs()
    path = os.path.join(store, "part_001.parquet")
    os.remove(path)
    with pytest.raises(PieceRemovedError):
        generation_token(fs, path)


def test_stamp_generation_tokens_marks_every_piece(store):
    from petastorm_tpu_torch.metadata import load_row_groups

    fs = _local_fs()
    pieces = stamp_generation_tokens(fs, load_row_groups(fs, store))
    assert pieces and all(p.generation for p in pieces)
    assert len({p.path for p in pieces}) == 4


# -- EpochPlan.extend --------------------------------------------------------------------


def test_plan_extend_mid_epoch_yields_everything_once():
    plan = EpochPlan(list("abcd"), num_epochs=1, with_epoch=True)
    first = [next(plan) for _ in range(2)]
    plan.extend(list("ef"))
    rest = list(plan)
    items = [item for _e, _o, item in first + rest]
    assert sorted(items) == list("abcdef")
    assert len(items) == len(set(items))
    assert plan.items_in_epoch(0) == 6


def test_plan_extend_deferred_lands_in_next_epoch():
    plan = EpochPlan(list("ab"), num_epochs=2, with_epoch=True)
    next(plan)
    plan.extend(["X"], defer=True)
    epochs = collections.defaultdict(list)
    for epoch, _ordinal, item in plan:
        epochs[epoch].append(item)
    assert "X" not in epochs[0] and "b" in epochs[0]
    assert sorted(epochs[1]) == ["X", "a", "b"]
    assert plan.items_in_epoch(0) == 2 and plan.items_in_epoch(1) == 3


def test_plan_extend_shuffled_epochs_cover_everything():
    plan = EpochPlan(list(range(6)), num_epochs=3, shuffle=True, seed=7, with_epoch=True)
    seen = [next(plan) for _ in range(4)]
    plan.extend([10, 11])
    seen.extend(plan)
    per_epoch = collections.defaultdict(list)
    for epoch, _o, item in seen:
        per_epoch[epoch].append(item)
    for e in (0, 1, 2):
        assert sorted(per_epoch[e]) == [0, 1, 2, 3, 4, 5, 10, 11]


def test_plan_peek_sees_the_extended_permutation():
    """The readahead's lookahead (``peek``) walks the extended permutation exactly as
    ``__next__`` then yields it, across the epoch boundary and a deferred extension."""
    plan = EpochPlan(list(range(5)), num_epochs=3, shuffle=True, seed=4, with_epoch=True)
    next(plan)
    plan.extend([50, 51], defer=False)
    plan.extend([60], defer=True)
    ahead = plan.peek(12)
    assert ahead == [next(plan) for _ in range(12)]


# -- watcher diffing ---------------------------------------------------------------------


def test_watcher_diffs_added_removed_rewritten(store):
    from petastorm_tpu_torch.metadata import load_row_groups

    fs = _local_fs()
    watcher = DatasetWatcher(fs, store, WatchOptions(interval_s=60))
    watcher.prime(stamp_generation_tokens(fs, load_row_groups(fs, store)))

    _write_file(store, "part_zz0.parquet", start=400)          # append
    os.remove(os.path.join(store, "part_001.parquet"))         # remove
    _write_file(store, "part_002.parquet", start=900)          # rewrite

    delta = watcher.poll_once()
    assert delta
    assert {os.path.basename(p.path) for p in delta.added} == {"part_zz0.parquet"}
    assert [os.path.basename(p) for p, _ in delta.removed] == ["part_001.parquet"]
    assert [os.path.basename(p) for p, _o, _n in delta.rewritten] == ["part_002.parquet"]
    assert all(p.generation for p in delta.rewritten[0][2])
    assert not watcher.poll_once()  # a quiet second tick
    assert watcher.stats()["watch_ticks"] == 2


def test_scan_leaves_a_file_that_moves_under_its_footer_read_for_the_next_tick(
        store, monkeypatch):
    """A file whose stat changes while the tick reads its footer (a writer still at it)
    is left for the next tick: a token pairing the half-written file's stat with the
    finished file's footer would fail every read of it. The JAX package's scan stamps
    that token (ROADMAP.md Queue 3 Q)."""
    from petastorm_tpu_torch.io import footercache
    from petastorm_tpu_torch.metadata import load_row_groups

    fs = _local_fs()
    watcher = DatasetWatcher(fs, store, WatchOptions(interval_s=60))
    watcher.prime(stamp_generation_tokens(fs, load_row_groups(fs, store)))
    _write_file(store, "part_zz0.parquet", start=400)
    path = os.path.join(store, "part_zz0.parquet")
    cache = footercache.shared_footer_cache()
    get = cache.get
    moved = []

    def get_then_move(fs_, p, *a, **kw):
        entry = get(fs_, p, *a, **kw)
        if p == path and not moved:  # the writer touches the file once more
            st = os.stat(p)
            os.utime(p, ns=(st.st_atime_ns, st.st_mtime_ns + 1000))
            moved.append(p)
        return entry

    monkeypatch.setattr(cache, "get", get_then_move)
    assert not watcher.poll_once()  # left for the next tick
    delta = watcher.poll_once()
    assert [os.path.basename(p.path) for p in delta.added] == ["part_zz0.parquet"]
    assert delta.added[0].generation == generation_token(fs, path)


def test_watch_error_is_counted_not_fatal(tmp_path):
    from petastorm_tpu_torch.obs.log import degradation_counts

    watcher = DatasetWatcher(_local_fs(), str(tmp_path / "nope"),
                             WatchOptions(interval_s=60))
    watcher._snapshot = {}
    before = degradation_counts().get("watch_error", 0)
    assert watcher.poll_once() is None
    assert watcher.stats()["watch_errors"] == 1
    assert degradation_counts().get("watch_error", 0) == before + 1


# -- reader integration: mutation survival -----------------------------------------------


def _quarantine_recovery():
    return RecoveryOptions(on_poison="quarantine", poison_attempts=1, io_retries=0,
                           io_retry_backoff_s=0.01)


def test_removed_file_mid_read_quarantines_as_piece_removed(store):
    reader = make_batch_reader("file://" + store, num_epochs=1, shuffle_row_groups=False,
                               reader_pool_type="dummy", cache_type="null",
                               recovery=_quarantine_recovery(),
                               io_options={"readahead": False}, watch={"interval_s": 60})
    with reader:
        batches = iter(reader)
        delivered = [int(v) for v in np.asarray(next(batches).id)]
        os.remove(os.path.join(store, "part_002.parquet"))
        reader.dataset_watcher.poll_once()
        delivered += [int(v) for b in batches for v in np.asarray(b.id)]
        report = reader.quarantine_report
    assert [e.kind for e in report] == ["piece_removed"]
    assert report.entries[0].path.endswith("part_002.parquet")
    assert isinstance(report.entries[0].error, PieceRemovedError)
    expected = sorted(set(range(4 * ROWS)) - set(range(2 * ROWS, 3 * ROWS)))
    assert sorted(delivered) == expected


def test_rewritten_file_mid_read_never_mixes_generations(store):
    """After file 3 is rewritten mid-epoch (new ids 900xx), epoch 0 delivers only
    old-generation rows (file 3's pending item quarantines as piece_rewritten) and the
    new generation arrives in epoch 1, never in epoch 0."""
    reader = make_batch_reader("file://" + store, num_epochs=2, shuffle_row_groups=False,
                               reader_pool_type="dummy", cache_type="null",
                               recovery=_quarantine_recovery(),
                               io_options={"readahead": False}, watch={"interval_s": 60})
    with reader:
        batches = iter(reader)
        first = next(batches)
        assert list(np.asarray(first.id)) == list(range(ROWS))
        _write_file(store, "part_003.parquet", start=90000)
        reader.dataset_watcher.poll_once()
        delivered = [int(v) for v in np.asarray(first.id)]
        delivered += [int(v) for b in batches for v in np.asarray(b.id)]
        report = reader.quarantine_report
        stats = reader.io_stats()
    assert {e.kind for e in report} == {"piece_rewritten"}, report.render()
    old_gen = [i for i in delivered if i < 90000]
    new_gen = [i for i in delivered if i >= 90000]
    assert not [i for i in old_gen if 3 * ROWS <= i < 4 * ROWS]
    assert sorted(set(old_gen)) == list(range(3 * ROWS))
    assert sorted(new_gen) == list(range(90000, 90000 + ROWS))
    assert stats["watch_deltas"] >= 1


def test_appended_file_mid_run_extends_the_plan(store):
    """num_epochs=None: an appended piece is seen by the watcher and delivered within
    the same pass: the plan grows under the iterator."""
    reader = make_batch_reader("file://" + store, num_epochs=None, shuffle_row_groups=False,
                               reader_pool_type="dummy", cache_type="null",
                               watch={"interval_s": 60})
    appended = set(range(700, 700 + ROWS))
    seen = False
    with reader:
        for count, batch in enumerate(reader):
            ids = {int(v) for v in np.asarray(batch.id)}
            if count == 0:
                _write_file(store, "part_zz0.parquet", start=700)
                reader.dataset_watcher.poll_once()
            if ids & appended:
                seen = True
                break
            assert count < 64, "appended piece never delivered"
    assert seen


def test_checkpoint_resume_across_extension_replays_nothing_loses_nothing(store):
    """Consume some, extend (an appended file), consume more, checkpoint, resume a fresh
    reader over the final dataset: the rows delivered before and after are exactly one
    epoch of the final dataset, each once."""
    kwargs = dict(num_epochs=1, shuffle_row_groups=False, reader_pool_type="dummy",
                  cache_type="null", watch={"interval_s": 60})
    before = []
    with make_batch_reader("file://" + store, **kwargs) as reader:
        batches = iter(reader)
        for _ in range(2):
            before += [int(v) for v in np.asarray(next(batches).id)]
        _write_file(store, "part_zz0.parquet", start=400)
        reader.dataset_watcher.poll_once()
        before += [int(v) for v in np.asarray(next(batches).id)]
        state = reader.state_dict()
    resumed = make_batch_reader("file://" + store, **kwargs)
    resumed.load_state_dict(state)
    with resumed:
        after = _ids(resumed)
    expected = sorted(list(range(4 * ROWS)) + list(range(400, 400 + ROWS)))
    got = sorted(before + after)
    assert got == expected, "replayed=%s lost=%s" % (
        sorted(set(before) & set(after)), sorted(set(expected) - set(got)))


# -- generation-scoped caches ------------------------------------------------------------


def test_disk_cache_keyed_invalidate(tmp_path):
    from petastorm_tpu_torch.cache import LocalDiskCache

    cache = LocalDiskCache(str(tmp_path / "c"))
    assert cache.get("k", lambda: 1) == 1
    assert cache.contains("k")
    cache.invalidate("k")
    assert not cache.contains("k")
    cache.invalidate("k")  # idempotent
    assert cache.get("k", lambda: 2) == 2


def test_tiered_cache_invalidate_reaches_every_tier(tmp_path):
    from petastorm_tpu_torch.cache import LocalDiskCache
    from petastorm_tpu_torch.io.memcache import MemCache, _Store
    from petastorm_tpu_torch.io.tiers import TieredCache

    disk = LocalDiskCache(str(tmp_path / "c"))
    mem = MemCache(1 << 20, store=_Store())
    tiered = TieredCache(mem=mem, disk=disk)
    try:
        value = {"id": np.arange(8)}
        np.testing.assert_array_equal(tiered.get("k", lambda: value)["id"], value["id"])
        assert tiered.contains("k")
        tiered.invalidate("k")
        assert not tiered.contains("k")
    finally:
        tiered.clear()  # the mem tier's bytes are process-wide


def test_rewritten_file_with_colliding_stat_never_serves_stale_disk_cache(tmp_path, store):
    """Decoded payloads cached on disk under generation-scoped keys; the file rewritten to
    the same row count with the mtime forced back: a fresh watching reader delivers the
    new rows, not the stale cache."""
    kwargs = dict(num_epochs=1, shuffle_row_groups=False, reader_pool_type="dummy",
                  cache_type="local-disk", cache_location=str(tmp_path / "cache"),
                  watch={"interval_s": 60})
    with make_batch_reader("file://" + store, **kwargs) as r1:
        assert sorted(_ids(r1)) == list(range(4 * ROWS))
    path = os.path.join(store, "part_000.parquet")
    st = os.stat(path)
    _write_file(store, "part_000.parquet", start=0, x=np.full(ROWS, 7.0))
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns))
    with make_batch_reader("file://" + store, **kwargs) as r2:
        xs = [float(v) for b in r2 for v in np.asarray(b.x)]
    assert xs.count(7.0) == ROWS, "stale cached generation served"


def test_cache_key_embeds_generation_token(store):
    from petastorm_tpu_torch.metadata import load_row_groups
    from petastorm_tpu_torch.reader import _cache_key
    from petastorm_tpu_torch.unischema import Unischema

    fs = _local_fs()
    schema = Unischema("s", [])
    [piece] = [p for p in stamp_generation_tokens(fs, load_row_groups(fs, store))
               if p.path.endswith("part_000.parquet") and p.row_group == 0]
    k1 = _cache_key(piece, schema, None, None, 0, 1, None)
    assert "gen:" in k1
    assert k1 == ref_reader._cache_key(piece, schema, None, None, 0, 1, None)
    k2 = _cache_key(piece._replace(generation="9.9.deadbeef"), schema, None, None, 0, 1,
                    None)
    assert k1 != k2
    bare = _cache_key(piece._replace(generation=None), schema, None, None, 0, 1, None)
    assert "gen:" not in bare  # watch-less keys unchanged (persistent caches)


def test_plan_refuses_growth_restore_of_mid_epoch_shuffled_pos():
    """A mid-epoch position means something only against the permutation it was saved
    over: restoring it into a grown shuffled plan would replay and lose ordinals, so the
    raw plan refuses (the Reader's resume is immune: pos 0 and the skip map)."""
    plan = EpochPlan(list(range(8)), num_epochs=2, shuffle=True, seed=3)
    for _ in range(3):
        next(plan)
    state = plan.state_dict()
    grown = EpochPlan(list(range(10)), num_epochs=2, shuffle=True, seed=3)
    with pytest.raises(ValueError, match="permutation changed"):
        grown.load_state_dict(state)
    fresh = EpochPlan(list(range(8)), num_epochs=2, shuffle=True, seed=3)
    grown.load_state_dict(fresh.state_dict())  # an epoch boundary stays legal


def test_resume_refuses_interleaving_append(store):
    """A file appended between save and restore that sorts between existing names
    shifts every later ordinal: the checkpoint's items_crc refuses the restore."""
    kwargs = dict(num_epochs=1, shuffle_row_groups=False, reader_pool_type="dummy",
                  cache_type="null", watch={"interval_s": 60})
    with make_batch_reader("file://" + store, **kwargs) as reader:
        next(iter(reader))
        state = reader.state_dict()
    _write_file(store, "part_001x.parquet", start=777000)
    resumed = make_batch_reader("file://" + store, **kwargs)
    try:
        with pytest.raises(ValueError, match="item order"):
            resumed.load_state_dict(state)
    finally:
        resumed.stop()
        resumed.join()


def test_watcher_does_not_readd_plan_time_pruned_files(store):
    """Plan-time pruning keeps files out of the plan; the first tick must not take them
    for appended files and re-add what the selection excluded."""
    reader = make_batch_reader("file://" + store, num_epochs=1, shuffle_row_groups=False,
                               reader_pool_type="dummy", cache_type="null",
                               filters=[("id", "<", ROWS)],  # prunes 3 of the 4 files
                               watch={"interval_s": 60})
    with reader:
        assert reader._num_items == 1
        delta = reader.dataset_watcher.poll_once()
        assert not delta, "first tick re-added pruned files: %r" % delta
        assert reader._num_items == 1
        ids = _ids(reader)
    assert sorted(ids) == list(range(ROWS))


# -- observability -----------------------------------------------------------------------


def test_stats_dashboard_renders_dataset_watch_panel():
    from petastorm_tpu_torch.obs.stats_cli import render_dashboard

    metrics = {
        "ptpu_dataset_pieces_added_total": 3,
        "ptpu_dataset_pieces_removed_total": 1,
        "ptpu_dataset_pieces_rewritten_total": 2,
        "ptpu_dataset_plan_extensions_total": 4,
        "ptpu_dataset_generation_conflicts_total": 2,
    }
    frame = render_dashboard(metrics)
    assert "dataset watch: added=3 removed=1 rewritten=2 extensions=4 " \
           "generation_conflicts=2" in frame
    assert "other metrics" not in frame


def test_watcher_delta_lands_in_flight_ring(store):
    from petastorm_tpu_torch.metadata import load_row_groups
    from petastorm_tpu_torch.obs import flight as _flight

    fs = _local_fs()
    watcher = DatasetWatcher(fs, store, WatchOptions(interval_s=60))
    watcher.prime(stamp_generation_tokens(fs, load_row_groups(fs, store)))

    class _Recorder:
        def __init__(self):
            self.events = []

        def record(self, kind, **fields):
            self.events.append((kind, fields))

    recorder = _Recorder()
    _flight.activate(recorder)
    try:
        _write_file(store, "part_zz5.parquet", start=999)
        watcher.poll_once()
    finally:
        _flight.deactivate(recorder)
    watch_events = [f for k, f in recorder.events if k == "dataset_watch"]
    assert watch_events and watch_events[0]["added"] == 1


# -- the watch thread --------------------------------------------------------------------

#: the longest the live-thread case waits for the plan to grow: far beyond one interval
#: (0.1 s), so that only a watcher that never ticks fails it, never a loaded host
THREAD_GROWTH_BUDGET_S = 120.0


def test_watch_thread_observes_append_within_interval(store):
    """A live watch thread (no manual polling) grows a thread-pool reader's plan with an
    appended file, which is then delivered: the ``num_epochs=None`` shape. The append is
    atomic (a half-written file in the listing fails a tick's footer read, or stamps a
    token of a size the finished file no longer has), and the case waits on the plan's
    item count rather than on a wall-clock budget for the delivery."""
    reader = make_batch_reader("file://" + store, num_epochs=None, shuffle_row_groups=False,
                               workers_count=2, reader_pool_type="thread",
                               cache_type="null", results_queue_size=2,
                               watch={"interval_s": 0.1})
    appended = set(range(800, 800 + ROWS))
    seen = False
    with reader:
        items = len(reader._plan.items)
        batches = iter(reader)
        next(batches)
        _write_file(store, "part_zz1.parquet", start=800, atomic=True)
        t0 = time.monotonic()
        while len(reader._plan.items) == items:
            assert time.monotonic() - t0 < THREAD_GROWTH_BUDGET_S, \
                "the watch thread never grew the plan"
            time.sleep(0.02)
        # the plan holds the appended piece: it is delivered within the next two passes
        for count, batch in enumerate(batches):
            if {int(v) for v in np.asarray(batch.id)} & appended:
                seen = True
                break
            assert count < 3 * (items + 1), "the appended piece was never delivered"
    assert seen, "watch thread never surfaced the appended piece"


# -- held against the JAX package --------------------------------------------------------


def _seeded_store(root, seed, files=4, rows=ROWS, row_group_size=8):
    """Files with seeded float values (non-constant min/max statistics in the footer)."""
    os.makedirs(root)
    rng = np.random.default_rng(seed)
    for i in range(files):
        _write_file(root, "part_%03d.parquet" % i, i * rows, rows=rows,
                    row_group_size=row_group_size, x=rng.random(rows))
    return root


@pytest.mark.parametrize("footer_crc", [True, False])
def test_generation_token_string_equals_the_reference(store, footer_crc):
    fs = _local_fs()
    for name in sorted(os.listdir(store)):
        path = os.path.join(store, name)
        ours = generation_token(fs, path, footer_crc=footer_crc, fresh=True)
        ref = ref_watch.generation_token(fs, path, footer_crc=footer_crc, fresh=True)
        assert ours == ref
        assert ours.endswith(".-") != footer_crc


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metadata_crc_equals_the_reference(tmp_path, seed):
    from petastorm_tpu_torch.io.footercache import FooterEntry, metadata_crc

    root = _seeded_store(str(tmp_path / "s"), seed, files=1, rows=40 + seed,
                         row_group_size=8 + seed)
    md = pq.read_metadata(os.path.join(root, "part_000.parquet"))
    assert md.row_group(0).column(1).statistics.has_min_max
    assert metadata_crc(md) == ref_footercache.metadata_crc(md)
    assert FooterEntry(md, None).crc == ref_footercache.FooterEntry(md, None).crc


@pytest.mark.parametrize("footer_crc", [True, False])
def test_stamp_generation_tokens_equals_the_reference(tmp_path, footer_crc):
    from petastorm_tpu.metadata import load_row_groups as ref_load
    from petastorm_tpu_torch.metadata import load_row_groups

    root = _seeded_store(str(tmp_path / "s"), 5)
    fs = _local_fs()
    ours = stamp_generation_tokens(fs, load_row_groups(fs, root), footer_crc=footer_crc)
    ref = ref_watch.stamp_generation_tokens(fs, ref_load(fs, root), footer_crc=footer_crc)
    assert [(p.path, p.row_group, p.num_rows, p.generation) for p in ours] == \
        [(p.path, p.row_group, p.num_rows, p.generation) for p in ref]


def _plan_script(seed):
    """A seeded sequence of plan operations: takes, extensions (current epoch or
    deferred), a reset and a state round trip."""
    rng = np.random.default_rng(seed)
    ops = []
    nxt = 100
    for _ in range(14):
        r = rng.random()
        if r < 0.55:
            ops.append(("take", int(rng.integers(1, 6))))
        elif r < 0.85:
            n = int(rng.integers(1, 4))
            ops.append(("extend", list(range(nxt, nxt + n)), bool(rng.random() < 0.5)))
            nxt += n
        elif r < 0.93:
            ops.append(("state",))
        else:
            ops.append(("reset",))
    return ops


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_epoch_plan_streams_equal_the_reference(shuffle, seed):
    """Both plans under the same seeded extension sequence: the same ``(epoch,
    ordinal, item)`` stream, ``items_in_epoch`` of every epoch, ``peek`` windows and
    state dicts, across epoch boundaries, a reset and a state round trip."""
    kw = dict(num_epochs=None, shuffle=shuffle, seed=seed + 11, with_epoch=True)
    ours, ref = EpochPlan(list(range(5)), **kw), ref_plan.EpochPlan(list(range(5)), **kw)
    for op in _plan_script(seed):
        if op[0] == "take":
            assert [next(ours) for _ in range(op[1])] == [next(ref) for _ in range(op[1])]
        elif op[0] == "extend":
            assert ours.extend(op[1], defer=op[2]) == ref.extend(op[1], defer=op[2])
        elif op[0] == "reset":
            ours.reset()
            ref.reset()
        else:
            state = ours.state_dict()
            assert state == ref.state_dict()
            ours.load_state_dict(state)
            ref.load_state_dict(state)
        assert ours.peek(7) == ref.peek(7)
        for epoch in range(ours.epoch + 3):
            assert ours.items_in_epoch(epoch) == ref.items_in_epoch(epoch)
    assert [next(ours) for _ in range(40)] == [next(ref) for _ in range(40)]


def _mutate(root, tag=0):
    _write_file(root, "part_zz0.parquet", start=400, row_group_size=8)
    _write_file(root, "part_002.parquet", start=900 + tag, row_group_size=8,
                x=np.full(ROWS, 3.0))
    os.remove(os.path.join(root, "part_003.parquet"))


def test_watcher_plan_deltas_equal_the_reference(tmp_path):
    from petastorm_tpu.metadata import load_row_groups as ref_load
    from petastorm_tpu_torch.metadata import load_row_groups

    root = _seeded_store(str(tmp_path / "s"), 3)
    fs = _local_fs()
    ours = DatasetWatcher(fs, root, WatchOptions(interval_s=60))
    ours.prime(stamp_generation_tokens(fs, load_row_groups(fs, root)))
    ref = ref_watch.DatasetWatcher(fs, root, ref_watch.WatchOptions(interval_s=60))
    ref.prime(ref_watch.stamp_generation_tokens(fs, ref_load(fs, root)))
    _mutate(root)
    a, b = ours.poll_once(), ref.poll_once()

    def flat(delta):
        return ([tuple(p) for p in delta.added],
                [(path, [tuple(p) for p in old]) for path, old in delta.removed],
                [(path, [tuple(p) for p in old], [tuple(p) for p in new])
                 for path, old, new in delta.rewritten])

    assert flat(a) == flat(b) and a and repr(a) == repr(b)
    assert not ours.poll_once() and not ref.poll_once()
    assert ours.stats() == ref.stats()


def _mutation_run(factory, root, **kwargs):
    """Two epochs over ``root``; after the first batch: append, rewrite file 2 with new
    ids, remove file 3, one tick. Returns the ids per epoch and the quarantine report as
    ``(kind, basename, row group, rows, epoch)``."""
    reader = factory("file://" + root, num_epochs=2, shuffle_row_groups=False,
                     cache_type="null", watch={"interval_s": 3600},
                     recovery=dict(on_poison="quarantine", poison_attempts=1, io_retries=0),
                     **kwargs)
    with reader:
        out = []
        for i, tagged in enumerate(_EpochTagged(reader)):
            out.append(tagged)
            if i == 0:
                _mutate(root)
                reader.dataset_watcher.poll_once()
        report = sorted((e.kind, os.path.basename(e.path), e.row_group, e.num_rows,
                         e.epoch) for e in reader.quarantine_report)
    return _per_epoch(out), report


def test_mutation_run_equals_the_reference_on_the_dummy_pool(tmp_path):
    """The same mutation sequence on the same seeded store through both packages' dummy
    pools (readahead off): the same ids per epoch and the same quarantine report."""
    kw = dict(reader_pool_type="dummy", io_options={"readahead": False})
    ours = _mutation_run(make_batch_reader, _seeded_store(str(tmp_path / "a"), 9), **kw)
    ref = _mutation_run(ref_reader.make_batch_reader, _seeded_store(str(tmp_path / "b"), 9),
                        **kw)
    assert ours == ref
    per_epoch, report = ours
    assert {k for k, *_ in report} == {"piece_rewritten", "piece_removed"}
    assert set(range(400, 400 + ROWS)) <= set(per_epoch[0])  # appended, in epoch 0
    assert not set(per_epoch[0]) & set(range(900, 900 + ROWS))  # new generation: epoch 1
    assert sorted(set(per_epoch[1]) & set(range(900, 900 + ROWS))) == \
        list(range(900, 900 + ROWS))


@pytest.mark.parametrize("pool", ["thread", "process"])
def test_mutation_id_sets_equal_the_reference_on_the_pools(tmp_path, pool):
    """The same sequence on the thread and process pools of both packages, over a store
    long enough (8 files of 4 row groups) that the mutated files (6 and 7, late in the
    order) are unread when the tick lands: the same id set in each epoch."""
    def run(factory, root):
        os.makedirs(root)
        for i in range(8):
            _write_file(root, "part_%03d.parquet" % i, i * 32, rows=32, row_group_size=8)
        reader = factory("file://" + root, num_epochs=2, shuffle_row_groups=False,
                         reader_pool_type=pool, workers_count=2, results_queue_size=2,
                         cache_type="null", watch={"interval_s": 3600},
                         results_timeout_s=120,
                         recovery=dict(on_poison="quarantine", poison_attempts=1,
                                       io_retries=0))
        with reader:
            out = []
            it = iter(_EpochTagged(reader))
            out.append(next(it))
            _write_file(root, "part_zz0.parquet", start=4000, rows=32, row_group_size=8,
                        atomic=True)
            _write_file(root, "part_006.parquet", start=9000, rows=32, row_group_size=8,
                        atomic=True)
            os.remove(os.path.join(root, "part_007.parquet"))
            reader.dataset_watcher.poll_once()
            out.extend(it)
            kinds = sorted({e.kind for e in reader.quarantine_report})
        return {e: set(v) for e, v in _per_epoch(out).items()}, kinds

    ours = run(make_batch_reader, str(tmp_path / "a"))
    ref = run(ref_reader.make_batch_reader, str(tmp_path / "b"))
    assert ours == ref
    (per_epoch, kinds) = ours
    assert kinds == ["piece_removed", "piece_rewritten"]
    assert per_epoch[0] == set(range(6 * 32)) | set(range(4000, 4032))
    assert per_epoch[1] == set(range(6 * 32)) | set(range(4000, 4032)) \
        | set(range(9000, 9032))


class _EpochTagged:
    """Iterates a batch reader of either package as ``(epoch, [ids])``."""

    def __init__(self, reader):
        self._reader = reader
        self._tags = []
        mark = reader._mark_consumed

        def recording(tag):
            self._tags.append(tag)
            mark(tag)

        reader._mark_consumed = recording

    def __iter__(self):
        for batch in self._reader:
            yield self._tags[-1][0], [int(v) for v in np.asarray(batch.id)]


def test_resume_across_extension_equals_the_reference(tmp_path):
    def run(factory, root):
        _seeded_store(root, 4)
        kwargs = dict(num_epochs=1, shuffle_row_groups=True, seed=6,
                      reader_pool_type="dummy", cache_type="null",
                      io_options={"readahead": False}, watch={"interval_s": 60})
        before = []
        with factory("file://" + root, **kwargs) as reader:
            batches = iter(reader)
            for _ in range(3):
                before += [int(v) for v in np.asarray(next(batches).id)]
            _write_file(root, "part_zz0.parquet", start=400, row_group_size=8)
            reader.dataset_watcher.poll_once()
            before += [int(v) for v in np.asarray(next(batches).id)]
            state = reader.state_dict()
        resumed = factory("file://" + root, **kwargs)
        resumed.load_state_dict(state)
        with resumed:
            after = _ids(resumed)
        return before, after, state

    ours = run(make_batch_reader, str(tmp_path / "a"))
    ref = run(ref_reader.make_batch_reader, str(tmp_path / "b"))
    assert ours[:2] == ref[:2]
    assert {k: v for k, v in ours[2].items() if k != "items_crc"} == \
        {k: v for k, v in ref[2].items() if k != "items_crc"}
    assert sorted(ours[0] + ours[1]) == sorted(list(range(4 * ROWS)) +
                                               list(range(400, 400 + ROWS)))


def test_mutate_rule_plan_round_trips_like_the_reference(store, tmp_path):
    """A plan of the three mutation rules: its JSON equals the JAX package's, either
    package's JSON arms the other's, and both mutators apply the same actions at the
    same tick."""
    from petastorm_tpu.dataset.mutate import LocalDatasetMutator as RefMutator
    from petastorm_tpu_torch.dataset.mutate import LocalDatasetMutator

    def rules(mod):
        return [mod.FaultRule("dataset.mutate", "append_piece", nth=2,
                              target={"name": "part_zz0.parquet", "start": 500, "rows": 8}),
                mod.FaultRule("dataset.mutate", "rewrite_file", nth=2,
                              target={"name": "part_001.parquet", "start": 600, "rows": 8}),
                mod.FaultRule("dataset.mutate", "remove_file", nth=3,
                              target={"name": "part_002.parquet"})]

    ours = chaos.FaultPlan(rules(chaos), seed=3)
    ref = ref_chaos.FaultPlan(rules(ref_chaos), seed=3)
    assert ours.to_json() == ref.to_json()
    assert chaos.FaultPlan.from_json(ref.to_json()).to_json() == ref.to_json()
    assert ref_chaos.FaultPlan.from_json(ours.to_json()).to_json() == ours.to_json()

    import shutil

    ref_store = str(tmp_path / "ref")
    shutil.copytree(store, ref_store)
    fs = _local_fs()
    applied = {}
    for name, plan_mod, watch_mod, mutator, root in (
            ("ours", chaos, None, LocalDatasetMutator(store, seed=1), store),
            ("ref", ref_chaos, ref_watch, RefMutator(ref_store, seed=1), ref_store)):
        plan = plan_mod.FaultPlan.from_json(ours.to_json())
        if watch_mod is None:
            from petastorm_tpu_torch.metadata import load_row_groups

            watcher = DatasetWatcher(fs, root, WatchOptions(interval_s=60))
            watcher.prime(stamp_generation_tokens(fs, load_row_groups(fs, root)))
        else:
            from petastorm_tpu.metadata import load_row_groups as ref_load

            watcher = watch_mod.DatasetWatcher(fs, root, watch_mod.WatchOptions(
                interval_s=60))
            watcher.prime(watch_mod.stamp_generation_tokens(fs, ref_load(fs, root)))
        watcher.set_mutator(mutator)
        ticks = []
        with plan_mod.armed(plan, propagate=False):
            for _ in range(3):
                delta = watcher.poll_once()
                ticks.append((list(mutator.applied), len(delta.added), len(delta.removed),
                              len(delta.rewritten)))
        applied[name] = ticks
    assert applied["ours"] == applied["ref"]
    assert applied["ours"][1] == ([("append_piece", "part_zz0.parquet"),
                                   ("rewrite_file", "part_001.parquet")], 1, 0, 1)
    assert applied["ours"][2][0][-1] == ("remove_file", "part_002.parquet")
    assert pq.read_table(os.path.join(store, "part_001.parquet")).equals(
        pq.read_table(os.path.join(ref_store, "part_001.parquet")))


_PANEL_SCRIPT = textwrap.dedent('''
    import os, sys
    import numpy as np, pyarrow as pa, pyarrow.parquet as pq
    pkg, root, out = sys.argv[1], sys.argv[2], sys.argv[3]
    if pkg == "port":
        from petastorm_tpu_torch.reader import make_batch_reader
        from petastorm_tpu_torch.obs.export import Reporter
    else:
        from petastorm_tpu.reader import make_batch_reader
        from petastorm_tpu.obs.export import Reporter

    def write(name, start):
        pq.write_table(pa.table({"id": np.arange(start, start + 16, dtype=np.int64),
                                 "x": np.full(16, 1.0)}), os.path.join(root, name),
                       row_group_size=8)

    os.makedirs(root)
    for i in range(4):
        write("part_%03d.parquet" % i, i * 16)
    reporter = Reporter(jsonl_path=out, interval_s=3600)
    reporter.start()
    with make_batch_reader("file://" + root, num_epochs=2, shuffle_row_groups=False,
                           reader_pool_type="dummy", io_options={"readahead": False},
                           recovery={"on_poison": "quarantine", "poison_attempts": 1},
                           watch={"interval_s": 3600}) as reader:
        for i, batch in enumerate(reader):
            if i == 0:
                write("part_zz0.parquet", 400)
                write("part_002.parquet", 900)
                os.remove(os.path.join(root, "part_003.parquet"))
                reader.dataset_watcher.poll_once()
    reporter.stop()
''')


def test_reporter_jsonl_renders_the_reference_dataset_watch_panel(tmp_path):
    """A watched run with the same mutations in a fresh interpreter of each package,
    its Reporter JSONL rendered by each package's stats CLI: the same dataset-watch
    panel line."""
    script = tmp_path / "panel_run.py"
    script.write_text(_PANEL_SCRIPT)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo, JAX_PLATFORMS="cpu")
    panels = {}
    for pkg, cli in (("port", "petastorm_tpu_torch.obs.stats_cli"),
                     ("ref", "petastorm_tpu.obs.stats_cli")):
        out = str(tmp_path / ("%s.jsonl" % pkg))
        subprocess.run([sys.executable, str(script), pkg, str(tmp_path / pkg), out],
                       check=True, env=env, timeout=240, capture_output=True)
        frame = subprocess.run([sys.executable, "-m", cli, "--watch", "--once", out],
                               check=True, env=env, timeout=240, capture_output=True,
                               text=True).stdout
        panels[pkg] = [line for line in frame.splitlines()
                       if line.startswith("dataset watch:")]
    assert panels["port"] == panels["ref"]
    assert panels["port"] == ["dataset watch: added=2 removed=2 rewritten=2 "
                              "extensions=1 generation_conflicts=4"]


# -- the port's own cases ----------------------------------------------------------------


def test_piece_errors_are_permanent_and_cross_the_pool_wire():
    """``PieceRemovedError`` is a ``FileNotFoundError`` (permanent to the IO retry) and
    ``PieceRewrittenError`` is never transient; both pickle intact inside a quarantine
    marker, the form in which a pool child's failure reaches the parent."""
    import pickle

    from petastorm_tpu_torch.reader import _PERMANENT_IO_ERRORS, _is_transient_io_error
    from petastorm_tpu_torch.recovery import QuarantinedItem

    removed, rewritten = PieceRemovedError("gone: /a"), PieceRewrittenError("moved: /b")
    assert isinstance(removed, _PERMANENT_IO_ERRORS) and isinstance(removed, OSError)
    assert not _is_transient_io_error(removed) and not _is_transient_io_error(rewritten)
    for err in (removed, rewritten):
        back = pickle.loads(pickle.dumps(QuarantinedItem((0, 1, "item"), err, 2)))
        assert type(back.error) is type(err) and str(back.error) == str(err)
        assert back.attempts == 2


@pytest.mark.parametrize("pool", ["dummy", "thread", "process"])
def test_generation_conflicts_are_counted_once_in_the_parent(store, pool):
    """A rewritten file's pending items quarantine as piece_rewritten on every pool
    (on the process pool a child finds the mismatch): the parent's
    ``ptpu_dataset_generation_conflicts_total`` rises once a quarantined item, and the
    report's errors are the port's classes."""
    from petastorm_tpu_torch.dataset.watch import watch_metrics

    for i in range(4):  # four row groups a file: items left to conflict after the tick
        _write_file(store, "part_%03d.parquet" % i, i * ROWS, row_group_size=4)
    conflicts = watch_metrics()["generation_conflicts"]
    before = conflicts.value
    reader = make_batch_reader("file://" + store, num_epochs=1, shuffle_row_groups=False,
                               reader_pool_type=pool, workers_count=1,
                               results_queue_size=1, results_timeout_s=120,
                               recovery=_quarantine_recovery(),
                               io_options={"readahead": False}, watch={"interval_s": 3600})
    with reader:
        batches = iter(reader)
        delivered = [int(v) for v in np.asarray(next(batches).id)]
        _write_file(store, "part_003.parquet", start=9000, row_group_size=4, atomic=True)
        reader.dataset_watcher.poll_once()
        delivered += [int(v) for b in batches for v in np.asarray(b.id)]
        report = list(reader.quarantine_report)
    assert report and {e.kind for e in report} == {"piece_rewritten"}
    assert all(isinstance(e.error, PieceRewrittenError) for e in report)
    assert conflicts.value - before == len(report)
    assert not [i for i in delivered if i >= 9000]  # the new generation: a later epoch
    old3 = [i for i in delivered if 3 * ROWS <= i < 4 * ROWS]
    assert len(old3) + sum(e.num_rows for e in report) == ROWS


def test_readahead_hit_delivers_the_generation_its_read_checked(store):
    """The readahead invariant: the IO thread checked the generation when it read, so a
    rewrite landing between that read and the delivery still delivers the stamped
    generation's rows (and the next epoch the new one)."""
    for i in range(4):
        _write_file(store, "part_%03d.parquet" % i, i * ROWS, row_group_size=ROWS // 2)
    reader = make_batch_reader("file://" + store, num_epochs=1, shuffle_row_groups=False,
                               reader_pool_type="dummy", cache_type="null",
                               recovery=_quarantine_recovery(),
                               io_options={"readahead": True, "readahead_depth": 2,
                                           "coalesce": False},
                               watch={"interval_s": 3600})
    with reader:
        batches = iter(reader)
        first = [int(v) for v in np.asarray(next(batches).id)]
        pool = reader._worker._readahead
        t0 = time.monotonic()
        # the next two items (file 0's second row group, file 1's first) were hinted:
        # wait until both are read (the pool idle with two entries)
        while not (pool._idle.wait(0.01) and len(pool._entries) >= 2):
            assert time.monotonic() - t0 < 30, "the readahead never read ahead"
        _write_file(store, "part_001.parquet", start=5000, row_group_size=ROWS // 2,
                    atomic=True)
        second = [int(v) for v in np.asarray(next(batches).id)]
        third = [int(v) for v in np.asarray(next(batches).id)]
        rest = [int(v) for b in batches for v in np.asarray(b.id)]
        hits = reader.io_stats()["readahead_hits"]
        report = list(reader.quarantine_report)
    assert first == list(range(8)) and second == list(range(8, 16))
    assert third == list(range(16, 24))  # read before the rewrite: the stamped rows
    assert hits >= 2
    # file 1's second row group was read after the rewrite: its check failed
    assert [(os.path.basename(e.path), e.row_group, e.kind) for e in report] == \
        [("part_001.parquet", 1, "piece_rewritten")]
    assert not [i for i in rest if i >= 5000]


def test_stale_thread_handle_never_serves_a_new_generation(tmp_path):
    """A pool thread that opened a file's old generation, and reads its new generation
    before any failed check of an old piece evicts that handle, must read the new bytes.
    The JAX package's thread keeps the old inode open and delivers its rows under the
    new generation's items (ROADMAP.md Queue 3 R; seed 1 below shows it there): the port
    pins a thread's handle to the stat identity its check saw."""
    root = str(tmp_path / "s")
    os.makedirs(root)
    for i in range(4):
        _write_file(root, "part_%03d.parquet" % i, i * 64, rows=64, row_group_size=16)
    reader = make_batch_reader("file://" + root, num_epochs=2, shuffle_row_groups=True,
                               seed=1, reader_pool_type="thread", workers_count=1,
                               results_queue_size=1, cache_type="null",
                               recovery=_quarantine_recovery(),
                               io_options={"readahead": False}, watch={"interval_s": 3600})
    counts = collections.Counter()
    with reader:
        seen2 = 0
        ticked = False
        for n, batch in enumerate(reader):
            ids = [int(v) for v in np.asarray(batch.id)]
            counts.update(ids)
            seen2 += sum(1 for i in ids if 128 <= i < 192)
            if not ticked and seen2 == 64 and n < 16:
                _write_file(root, "part_002.parquet", 9000, rows=64, row_group_size=16,
                            atomic=True)
                reader.dataset_watcher.poll_once()
                ticked = True
    assert ticked
    assert not [i for i in range(128, 192) if counts[i] > 1]
    assert sorted(i for i in counts if i >= 9000) == list(range(9000, 9064))


def test_coalesced_runs_never_mix_generations():
    from petastorm_tpu_torch.io.coalesce import plan_runs
    from petastorm_tpu_torch.metadata import RowGroupPiece

    old = [RowGroupPiece("/d/f.parquet", rg, 8, None, None, "1.1.-") for rg in range(2)]
    new = [RowGroupPiece("/d/f.parquet", rg, 8, None, None, "2.2.-") for rg in range(2, 4)]
    runs = plan_runs([(p, ("id",)) for p in old + new], max_run=4)
    assert [[p.row_group for p in pieces] for pieces, _c in runs] == [[0, 1], [2, 3]]


def test_passthrough_reads_a_rewritten_file_fresh(tmp_path, monkeypatch):
    """The compressed-page pass-through over a watched store: a file rewritten between
    two readers' passes (other values, same schema) delivers exactly pyarrow's read of
    the new bytes, with no stale footer or per-file refusal carried over."""
    monkeypatch.setenv("PTPU_PAGEDEC_DEVICE", "1")
    from petastorm_tpu_torch.io.footercache import shared_footer_cache

    root = str(tmp_path / "pt")
    os.makedirs(root)

    def write(name, seed):
        rng = np.random.default_rng(seed)
        n = 4096
        pq.write_table(pa.table({
            "id": np.arange(n, dtype=np.int64) % 97,
            "v": np.repeat(rng.random(n // 64).astype(np.float32), 64),
        }), os.path.join(root, name), row_group_size=2048, compression="snappy")

    write("part_000.parquet", 0)
    write("part_001.parquet", 1)
    kwargs = dict(num_epochs=2, shuffle_row_groups=False, reader_pool_type="dummy",
                  io_options={"pagedec": "on", "readahead": False},
                  recovery=_quarantine_recovery(), watch={"interval_s": 3600})
    with make_batch_reader("file://" + root, **kwargs) as reader:
        reader.adopt_passthrough(on_device=False)
        worker = reader._worker
        tagged = _EpochTagged(reader)
        out = []
        for epoch, batch in _passthrough_batches(reader, tagged):
            out.append((epoch, batch))
            if len(out) == 2:  # file 0 delivered; file 1 not yet read
                shared_footer_cache().get(_local_fs(),
                                          os.path.join(root, "part_001.parquet"))
                worker._pagedec_refused.add((os.path.join(root, "part_001.parquet"), "v"))
                write("part_001.parquet", 7)
                reader.dataset_watcher.poll_once()
        refused = set(worker._pagedec_refused)
        report = list(reader.quarantine_report)
    new = pq.read_table(os.path.join(root, "part_001.parquet"))
    epoch1 = [b for e, b in out if e == 1]
    assert len(epoch1) == 4 and [e.kind for e in report] == ["piece_rewritten"] * 4
    got = {k: np.concatenate([b[k] for b in epoch1[2:]]) for k in ("id", "v")}
    for k in ("id", "v"):
        assert got[k].dtype == new.column(k).to_numpy().dtype
        assert got[k].tobytes() == new.column(k).to_numpy().tobytes()
    assert not [t for t in refused if t[0].endswith("part_001.parquet")]


def _passthrough_batches(reader, tagged):
    """``(epoch, {column: ndarray})`` a batch of a reader that adopted the pass-through,
    each PassthroughColumn inflated by its host twin; asserts that at least one column
    of each batch did pass through."""
    from petastorm_tpu_torch.io.pagedec import PassthroughColumn, materialize_columns

    tags = tagged._tags
    for batch in reader:
        cols = batch._asdict()
        assert any(isinstance(v, PassthroughColumn) for v in cols.values())
        yield tags[-1][0], materialize_columns(cols)
