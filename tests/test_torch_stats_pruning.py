"""Row-group statistics pruning in the port against the JAX package's
``tests/test_stats_pruning.py``, case for case: provably unmatchable row groups are never
read; pruning is conservative and composes with hive pruning and the row mask.

Each case builds the port's reader and the JAX package's with the same arguments (a
predicate built from each package's own ``predicates`` module) and compares, bit-exact:

- the row groups scheduled (``Reader._num_items`` and the plan's ``(path, row_group)``
  items in order);
- the rows delivered (ids and, where read, names).
"""
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

pytest.importorskip("torch")

from _torch_pool_helpers import _no_leaked_shm_segments  # noqa: E402,F401

import petastorm_tpu.errors as ref_errors  # noqa: E402
import petastorm_tpu.predicates as ref_preds  # noqa: E402
import petastorm_tpu.reader as ref_reader  # noqa: E402
import petastorm_tpu_torch.predicates as port_preds  # noqa: E402
from petastorm_tpu_torch.errors import NoDataAvailableError  # noqa: E402
from petastorm_tpu_torch.reader import make_batch_reader  # noqa: E402

PKGS = {"port": (make_batch_reader, port_preds), "ref": (ref_reader.make_batch_reader,
                                                         ref_preds)}


@pytest.fixture(scope="module")
def ordered_dataset(tmp_path_factory):
    """id strictly ordered across 10 row groups of 10 (id range per group is tight)."""
    root = tmp_path_factory.mktemp("ordered")
    pq.write_table(pa.table({
        "id": np.arange(100, dtype=np.int64),
        "name": np.array(["n%03d" % i for i in range(100)], dtype=object),
    }), str(root / "p.parquet"), row_group_size=10)
    return "file://" + str(root)


def _ids(reader):
    return sorted(int(x) for b in reader for x in np.asarray(b.id))


def _scheduled(reader):
    return [(piece.path, piece.row_group) for piece, _part in reader._plan._items]


def _read(pkg, url, predicate=None, **kw):
    """``(items scheduled, their (path, row group)s, ids delivered)`` of one read;
    ``predicate`` is a function of the package's ``predicates`` module."""
    factory, preds = PKGS[pkg]
    if predicate is not None:
        kw["predicate"] = predicate(preds)
    kw.setdefault("reader_pool_type", "dummy")
    with factory(url, **kw) as reader:
        return reader._num_items, _scheduled(reader), _ids(reader)


def _same_as_reference(url, predicate=None, **kw):
    """The port's read of ``url`` equals the JAX package's: the same row groups
    scheduled, the same rows delivered. Returns the port's ``(num_items, ids)``."""
    ours = _read("port", url, predicate, **kw)
    assert ours == _read("ref", url, predicate, **kw)
    return ours[0], ours[2]


def test_stats_prune_range(ordered_dataset):
    # groups [0,10), [10,20), [20,30) only; the row mask finishes the job
    assert _same_as_reference(ordered_dataset, filters=[("id", "<", 25)]) == \
        (3, list(range(25)))
    assert _same_as_reference(ordered_dataset, filters=[("id", ">=", 71)]) == \
        (3, list(range(71, 100)))


def test_stats_prune_point_and_in(ordered_dataset):
    assert _same_as_reference(ordered_dataset, filters=[("id", "=", 42)]) == (1, [42])
    assert _same_as_reference(ordered_dataset, filters=[("id", "in", [5, 55, 95])]) == \
        (3, [5, 55, 95])


def test_stats_prune_or_clauses(ordered_dataset):
    assert _same_as_reference(ordered_dataset,
                              filters=[[("id", "<", 10)], [("id", ">=", 90)]]) == \
        (2, list(range(10)) + list(range(90, 100)))


def test_stats_prune_string_columns(ordered_dataset):
    """String statistics prune too (parquet bounds stay valid under truncation)."""
    names = {}
    for pkg in ("port", "ref"):
        factory, _ = PKGS[pkg]
        with factory(ordered_dataset, filters=[("name", "=", "n015")],
                     reader_pool_type="dummy") as reader:
            assert reader._num_items == 1
            scheduled = _scheduled(reader)
            got = [bytes(x) if isinstance(x, bytes) else x
                   for b in reader for x in b.name]
        names[pkg] = (scheduled, [str(x) for x in got])
    assert names["port"][1] == ["n015"]
    assert names["port"] == names["ref"]


def test_stats_prune_conservative_on_unknowns(ordered_dataset):
    # unknown column term cannot prune anything; the plan is all that is compared (the
    # row mask of both packages raises the same KeyError on the absent column)
    unknown = [("id", "<", 10), ("nope", "=", 1)]
    assert len(_scheduled_of(ordered_dataset, filters=unknown)) == 1
    errors = []
    for pkg in ("port", "ref"):
        factory, _ = PKGS[pkg]
        with factory(ordered_dataset, filters=unknown, reader_pool_type="dummy") as r:
            with pytest.raises(KeyError) as info:
                _ids(r)
        errors.append(str(info.value))
    assert errors[0] == errors[1]
    # mixed-type comparison: conservative (no crash, no wrong pruning)
    # str-vs-int never prunes at plan time
    assert _same_as_reference(ordered_dataset, filters=[("id", "=", "42")])[0] == 10


def _scheduled_of(url, **kw):
    out = {}
    for pkg in ("port", "ref"):
        factory, _ = PKGS[pkg]
        with factory(url, reader_pool_type="dummy", **kw) as reader:
            out[pkg] = _scheduled(reader)
    assert out["port"] == out["ref"]
    return out["port"]


def test_stats_prune_composes_with_hive(tmp_path):
    rid = 0
    for date in ("a", "b"):
        d = tmp_path / ("date=%s" % date)
        os.makedirs(d, exist_ok=True)
        pq.write_table(pa.table({"id": np.arange(rid, rid + 40, dtype=np.int64)}),
                       str(d / "f.parquet"), row_group_size=10)
        rid += 40
    # hive pruning keeps date=b (4 groups); stats pruning keeps ids [40,50)
    assert _same_as_reference("file://" + str(tmp_path),
                              filters=[("date", "=", "b"), ("id", "<", 50)]) == \
        (1, list(range(40, 50)))


def test_stats_prune_ne_keeps_null_rows(tmp_path):
    """Parquet min/max exclude nulls: '!=' must not prune a group whose non-null values
    all equal the filter value but which contains nulls (those null rows MATCH '!=' in
    the row-level mask)."""
    pq.write_table(pa.table({"x": pa.array([5, 5, 5, None, None], pa.int64()),
                             "id": np.arange(5, dtype=np.int64)}),
                   str(tmp_path / "p.parquet"))
    # NOT pruned; exactly the null rows survive the row mask
    assert _same_as_reference("file://" + str(tmp_path), filters=[("x", "!=", 5)]) == \
        (1, [3, 4])


def test_stats_prune_ne_prunes_when_no_nulls(tmp_path):
    pq.write_table(pa.table({"x": pa.array([5] * 4, pa.int64())}),
                   str(tmp_path / "p.parquet"))
    with pytest.raises(NoDataAvailableError) as ours:
        make_batch_reader("file://" + str(tmp_path), filters=[("x", "!=", 5)])
    with pytest.raises(ref_errors.NoDataAvailableError) as theirs:
        ref_reader.make_batch_reader("file://" + str(tmp_path), filters=[("x", "!=", 5)])
    assert str(ours.value) == str(theirs.value)


def test_stats_stripped_from_scheduled_pieces(ordered_dataset):
    """Stats are plan-time only: scheduled work items must not carry per-column
    bounds to pool workers."""
    for pkg in ("port", "ref"):
        factory, _ = PKGS[pkg]
        with factory(ordered_dataset, filters=[("id", "<", 25)],
                     reader_pool_type="dummy") as reader:
            items = reader._plan._items
            assert all(piece.stats is None for piece, _part in items)
    _scheduled_of(ordered_dataset, filters=[("id", "<", 25)])


# ------------------------------------------------------- predicate-implied pruning


def test_predicate_in_set_prunes_row_groups(ordered_dataset):
    """in_set predicates imply 'in' filter clauses: plan-time statistics pruning
    fires without a prebuilt index."""
    # 10 groups without the implied pruning
    assert _same_as_reference(ordered_dataset,
                              lambda p: p.in_set({5, 55, 95}, "id")) == (3, [5, 55, 95])


def test_predicate_negate_and_reduce_prune(ordered_dataset):
    # not-in over a fully-covered group: group [40,50) has ONLY excluded ids -> can
    # be pruned when its null count is recorded as 0
    assert _same_as_reference(
        ordered_dataset, lambda p: p.in_negate(p.in_set(set(range(40, 50)), "id"))) == \
        (9, [i for i in range(100) if not 40 <= i < 50])

    # AND of two in_sets: intersection of implied clauses; only [20,30) can satisfy both
    assert _same_as_reference(
        ordered_dataset,
        lambda p: p.in_reduce([p.in_set(set(range(0, 30)), "id"),
                               p.in_set(set(range(20, 100, 7)), "id")], all)) == \
        (1, [20, 27])

    # OR of two in_sets: union of clauses
    assert _same_as_reference(
        ordered_dataset,
        lambda p: p.in_reduce([p.in_set({3}, "id"), p.in_set({93}, "id")], any)) == \
        (2, [3, 93])


def test_predicate_matching_nothing_yields_empty_read(ordered_dataset):
    """Predicate semantics: matching nothing is an EMPTY read, never a construction
    error, and the provably-empty plan retains only a minimal piece set."""
    # one retained group masks to zero rows
    assert _same_as_reference(ordered_dataset, lambda p: p.in_set({100000}, "id")) == \
        (1, [])
    # sharded: every shard still constructs and yields empty
    for shard in range(2):
        assert _same_as_reference(ordered_dataset, lambda p: p.in_set({100000}, "id"),
                                  cur_shard=shard, shard_count=2, shard_seed=1)[1] == []


def test_predicate_pruning_never_starves_a_shard(ordered_dataset):
    """Implied pruning that keeps fewer pieces than shard_count must pad with
    unpruned survivors: every shard constructs, the union is exactly the matches."""
    got = []
    for shard in range(4):
        n, ids = _same_as_reference(ordered_dataset, lambda p: p.in_set({5}, "id"),
                                    cur_shard=shard, shard_count=4, shard_seed=2,
                                    shuffle_row_groups=False)
        assert n == 1  # padded to one piece per shard, not 10
        got.extend(ids)
    assert got == [5]


def test_untranslatable_predicate_unchanged(ordered_dataset):
    # no pruning derived
    assert _same_as_reference(
        ordered_dataset,
        lambda p: p.in_lambda(["id"], lambda row: row["id"] % 50 == 0,
                              lambda cols: cols["id"] % 50 == 0)) == (10, [0, 50])


def test_predicate_pruning_composes_with_user_filters(ordered_dataset):
    # {5, 55} groups; 95's group cut by filters
    assert _same_as_reference(ordered_dataset, lambda p: p.in_set({5, 55, 95}, "id"),
                              filters=[("id", "<", 60)]) == (2, [5, 55])


def test_implied_dnf_filters_unit():
    def cases(p):
        def true(r):
            return True

        return [
            p.in_set({2, 1}, "f"),
            p.in_negate(p.in_set({1}, "f")),
            p.in_negate(p.in_lambda(["f"], true)),
            p.in_lambda(["f"], true),
            p.in_pseudorandom_split([0.5, 0.5], 0, "f"),
            p.in_reduce([p.in_set({1}, "a"), p.in_lambda(["b"], true)], all),
            p.in_reduce([p.in_lambda(["b"], true)], all),
            p.in_reduce([p.in_set({1}, "a"), p.in_lambda(["b"], true)], any),
            p.in_reduce([p.in_set({1}, "a"), p.in_set({2}, "b")], any),
        ]

    ours = [port_preds.implied_dnf_filters(c) for c in cases(port_preds)]
    assert ours == [
        [[("f", "in", [1, 2])]],
        [[("f", "not in", [1])]],
        None,
        None,
        None,
        # AND: untranslatable children drop out; all untranslatable -> None
        [[("a", "in", [1])]],
        None,
        # OR: any untranslatable child kills the translation
        None,
        [[("a", "in", [1])], [("b", "in", [2])]],
    ]
    assert ours == [ref_preds.implied_dnf_filters(c) for c in cases(ref_preds)]


def test_predicate_pruned_plan_checkpoint_resume(ordered_dataset):
    """state_dict/load_state_dict over a predicate-PRUNED plan: the resumed reader
    reconstructs the identical pruned item list, so the cursor indexes the same
    schedule and no matching row is lost or replayed. Each package's state resumes
    the other's reader."""
    kwargs = dict(reader_pool_type="dummy", shuffle_row_groups=False, num_epochs=1)

    def first_and_state(pkg):
        factory, preds = PKGS[pkg]
        with factory(ordered_dataset, predicate=preds.in_set({5, 15, 55, 95}, "id"),
                     **kwargs) as reader:
            assert reader._num_items == 4
            first = next(iter(reader))  # one row group consumed (one matching row)
            return [int(x) for x in np.asarray(first.id)], reader.state_dict()

    def rest(pkg, state):
        factory, preds = PKGS[pkg]
        with factory(ordered_dataset, predicate=preds.in_set({5, 15, 55, 95}, "id"),
                     **kwargs) as reader2:
            assert reader2._num_items == 4  # same pruned plan on reconstruction
            reader2.load_state_dict(state)
            return _ids(reader2)

    head, state = first_and_state("port")
    ref_head, ref_state = first_and_state("ref")
    assert head == ref_head and state == ref_state
    tail = rest("port", state)
    assert sorted(head + tail) == [5, 15, 55, 95]
    assert rest("port", ref_state) == rest("ref", state) == tail
