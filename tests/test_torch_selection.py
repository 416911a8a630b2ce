"""Port vs reference: row selection in the readers. Row-group statistics pruning (``!=``
and ``not in`` over nulls included), the empty-predicate and empty-filter rules,
``shuffle_row_drop_partitions`` (each partition the reference's rows), the compressed-page
pass-through turned off by each row-selecting option, the JPEG batch path's mask applied
before stage 1, and selection through the process pool (a predicate pickles to the
children)."""
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

from _torch_pool_helpers import _no_leaked_shm_segments, no_leaked_port_slabs  # noqa: E402,F401
from petastorm_tpu import predicates as ref_predicates  # noqa: E402
from petastorm_tpu import reader as ref_reader  # noqa: E402
from petastorm_tpu.errors import NoDataAvailableError as RefNoData  # noqa: E402
from petastorm_tpu_torch import predicates  # noqa: E402
from petastorm_tpu_torch import reader as port_reader  # noqa: E402
from petastorm_tpu_torch.errors import NoDataAvailableError  # noqa: E402
from petastorm_tpu_torch.fs import get_filesystem_and_path_or_paths  # noqa: E402
from petastorm_tpu_torch.io.pagedec import is_passthrough  # noqa: E402
from petastorm_tpu_torch.loader import DataLoader  # noqa: E402
from petastorm_tpu_torch.metadata import load_row_groups  # noqa: E402

ROWS, RG_ROWS = 96, 8


@pytest.fixture(scope="module")
def stats_store(tmp_path_factory):
    """A vanilla Parquet store (no metadata: the footers are scanned, so pieces carry
    statistics): 2 files of 6 row groups of 8 rows, ``id`` ascending, ``x`` with nulls
    in some row groups and constant in others, ``s`` strings."""
    root = tmp_path_factory.mktemp("torch_stats")
    ids = np.arange(ROWS, dtype=np.int64)
    x = [None if (i // RG_ROWS) % 3 == 0 and i % 4 == 0 else int((i // RG_ROWS) % 4)
         for i in range(ROWS)]
    s = ["s%02d" % (i // 16) for i in range(ROWS)]
    half = ROWS // 2
    for f in range(2):
        sl = slice(f * half, (f + 1) * half)
        pq.write_table(pa.table({"id": ids[sl], "x": pa.array(x[sl], pa.int64()),
                                 "s": s[sl]}), str(root / ("part-%d.parquet" % f)),
                       row_group_size=RG_ROWS)
    return {"url": "file://" + str(root), "x": x}


def _batch_ids(module, url, **kwargs):
    """The ids of each delivered batch, in delivery order (dummy pool)."""
    with module.make_batch_reader(url, reader_pool_type="dummy", **kwargs) as r:
        return [[int(i) for i in np.asarray(b.id)] for b in r]


STATS_FILTERS = [
    [("id", "=", 10)], [("id", "<", 8)], [("id", ">=", 80)], [("id", "<=", 8)],
    [("id", ">", 90)], [("id", "in", [3, 50])], [("id", "not in", list(range(8)))],
    [("x", "!=", 1)], [("x", "not in", [0, 1])], [("x", "=", 2)],
    [[("id", "<", 8)], [("s", "=", "s05")]], [("s", "in", ["s01"]), ("id", "!=", 17)],
]
STATS_IDS = ["eq", "lt", "ge", "le", "gt", "in", "not_in_int_span", "ne_with_nulls",
             "not_in_with_nulls", "eq_x", "or_of_ands", "str_in_and_ne"]


def test_footer_scan_pieces_carry_the_references_statistics(stats_store):
    from petastorm_tpu import metadata as ref_metadata

    fs, path = get_filesystem_and_path_or_paths(stats_store["url"])
    got, want = load_row_groups(fs, path), ref_metadata.load_row_groups(fs, path)
    assert [(p.path, p.row_group, p.num_rows, p.partition_values, p.stats) for p in got] \
        == [(p.path, p.row_group, p.num_rows, p.partition_values, p.stats) for p in want]
    assert all(p.stats for p in got)


@pytest.mark.parametrize("flt", STATS_FILTERS, ids=STATS_IDS)
def test_statistics_pruning_equals_the_reference(stats_store, flt):
    fs, path = get_filesystem_and_path_or_paths(stats_store["url"])
    pieces = load_row_groups(fs, path)
    kept = port_reader._prune_by_stats(pieces, flt)
    want = ref_reader._prune_by_stats(
        __import__("petastorm_tpu.metadata", fromlist=["x"]).load_row_groups(fs, path), flt)
    assert [(p.path, p.row_group) for p in kept] == [(p.path, p.row_group) for p in want]
    got_ids = _batch_ids(port_reader, stats_store["url"], filters=flt,
                         shuffle_row_groups=False)
    assert got_ids == _batch_ids(ref_reader, stats_store["url"], filters=flt,
                                 shuffle_row_groups=False)
    with port_reader.make_batch_reader(stats_store["url"], filters=flt,
                                       reader_pool_type="dummy") as r:
        assert r._num_items == len(kept)
        assert all(item[0].stats is None for item in r._plan.items)  # stripped


def test_ne_and_not_in_keep_row_groups_whose_nulls_match(stats_store):
    """Parquet min/max exclude nulls: a row group of x = 0 or null must survive
    ``x != 0`` (its null rows match), one with no null must not."""
    flt = [("x", "!=", 0)]
    fs, path = get_filesystem_and_path_or_paths(stats_store["url"])
    kept = {p.row_group + 6 * ("part-1" in p.path)
            for p in port_reader._prune_by_stats(load_row_groups(fs, path), flt)}
    assert 0 in kept  # x is 0 or null in row group 0: nulls match !=
    assert 4 not in kept  # x is 0 and never null in row group 4
    delivered = sorted(i for b in _batch_ids(port_reader, stats_store["url"], filters=flt)
                       for i in b)
    assert delivered == [i for i, v in enumerate(stats_store["x"]) if v != 0]


@pytest.mark.parametrize("shards", [None, 2, 3])
def test_a_predicate_matching_nothing_gives_an_empty_read(stats_store, shards):
    """The empty-predicate rule: the implied clauses prune everything, one piece a shard
    is kept, and the read is empty (no error), as in the JAX package."""
    for shard in range(shards or 1):
        kw = dict(cur_shard=shard, shard_count=shards) if shards else {}
        with port_reader.make_batch_reader(stats_store["url"], reader_pool_type="dummy",
                                           predicate=predicates.in_set({-5}, "id"),
                                           **kw) as r:
            assert list(r) == []
            n = r._num_items
        with ref_reader.make_batch_reader(stats_store["url"], reader_pool_type="dummy",
                                          predicate=ref_predicates.in_set({-5}, "id"),
                                          **kw) as r:
            assert list(r) == []
            assert n == r._num_items == 1


@pytest.mark.parametrize("factory", ["make_batch_reader", "make_reader"])
def test_filters_pruning_everything_raise_no_data(stats_store, tmp_path, factory):
    """The empty-filter rule: user ``filters`` that prune every row group raise. A store
    planned from its key-value metadata has no statistics to prune with (the KV fast
    path), so there the row mask alone runs and the read is empty, in both packages."""
    flt = [("id", "<", -1)]
    if factory == "make_batch_reader":
        with pytest.raises(NoDataAvailableError, match="No row groups to read"):
            port_reader.make_batch_reader(stats_store["url"], filters=flt)
        with pytest.raises(RefNoData):
            ref_reader.make_batch_reader(stats_store["url"], filters=flt)
        return
    url = _jpeg_store(tmp_path, rows=16)["url"]  # make_reader needs a unischema
    items = []
    for module in (port_reader, ref_reader):
        with module.make_reader(url, filters=flt, reader_pool_type="dummy") as r:
            assert list(r) == []
            items.append(r._num_items)
    assert items[0] == items[1] > 0  # nothing pruned: every row group is read and masked


@pytest.mark.parametrize("k,seed", [(2, 3), (3, None), (5, 11)])
def test_row_drop_partitions_hold_the_references_rows(stats_store, k, seed):
    kw = dict(shuffle_row_drop_partitions=k, seed=seed, shuffle_row_groups=True,
              num_epochs=2)
    got = _batch_ids(port_reader, stats_store["url"], **kw)
    assert got == _batch_ids(ref_reader, stats_store["url"], **kw)
    flat = sorted(i for b in got for i in b)
    assert flat == sorted(list(range(ROWS)) * 2)  # every row once an epoch
    # the workers' partitions directly, item by item
    port_r = port_reader.make_batch_reader(stats_store["url"], reader_pool_type="dummy",
                                           **kw)
    ref_r = ref_reader.make_batch_reader(stats_store["url"], reader_pool_type="dummy", **kw)
    with port_r, ref_r:
        for item, ref_item in zip(port_r._plan.items, ref_r._plan.items):
            np.testing.assert_array_equal(
                port_r._worker._drop_partition_indices(item, RG_ROWS),
                ref_r._worker._drop_partition_indices(ref_item, RG_ROWS))


def test_row_drop_partitions_on_the_per_row_reader(tmp_path):
    store = _jpeg_store(tmp_path, rows=24, decode=False)
    kw = dict(shuffle_row_drop_partitions=3, seed=2, shuffle_row_groups=True)
    with port_reader.make_reader(store["url"], reader_pool_type="dummy", **kw) as r:
        got = [int(row.id) for row in r]
    with ref_reader.make_reader(store["url"], reader_pool_type="dummy", **kw) as r:
        want = [int(row.id) for row in r]
    assert got == want and sorted(got) == list(range(24))


# -- the compressed-page pass-through ---------------------------------------------------


@pytest.fixture(scope="module")
def passthrough_store(tmp_path_factory):
    """Snappy fixed-width columns the pass-through takes (repeated float32, low-card
    int64), flat and as two hive day directories."""
    root = tmp_path_factory.mktemp("torch_sel_pagedec")
    rng = np.random.RandomState(7)
    n = 512
    cols = {"id": np.arange(n, dtype=np.int64),
            "cat": (np.arange(n) % 5).astype(np.int64),
            "f": np.repeat(rng.rand(n // 16), 16).astype(np.float32)}
    os.makedirs(root / "flat")
    pq.write_table(pa.table(cols), str(root / "flat" / "p.parquet"), row_group_size=128,
                   compression="snappy")
    for day in range(2):
        os.makedirs(root / "hive" / ("day=%d" % day))
        sl = slice(day * n // 2, (day + 1) * n // 2)
        pq.write_table(pa.table({k: v[sl] for k, v in cols.items()}),
                       str(root / "hive" / ("day=%d" % day) / "p.parquet"),
                       row_group_size=128, compression="snappy")
    return {"flat": "file://" + str(root / "flat"), "hive": "file://" + str(root / "hive")}


PASSTHROUGH_CASES = {
    "none": ("flat", {}, True),
    "hive_layout": ("hive", {}, True),
    "predicate": ("flat", {"predicate": predicates.in_set({1, 2}, "cat")}, False),
    "filters": ("flat", {"filters": [("id", ">=", 0)]}, False),
    "partition_filters": ("hive", {"filters": [("day", "=", 1)]}, False),
    "row_drop_partitions": ("flat", {"shuffle_row_drop_partitions": 2}, False),
}


@pytest.mark.parametrize("case", sorted(PASSTHROUGH_CASES))
def test_each_row_selecting_option_turns_the_passthrough_off(passthrough_store, case):
    which, kw, on = PASSTHROUGH_CASES[case]
    with port_reader.make_batch_reader(passthrough_store[which], reader_pool_type="dummy",
                                       io_options={"pagedec": "on"}, **kw) as r:
        assert r._worker._pagedec_shape_ok() is on
        r.adopt_passthrough(on_device=False)
        batches = [b._asdict() for b in r]
    shipped = any(is_passthrough(v) for b in batches for v in b.values())
    assert shipped is on
    want = _batch_ids(ref_reader, passthrough_store[which], **kw)
    got = [[int(i) for i in (b["id"].materialize() if is_passthrough(b["id"]) else b["id"])]
           for b in batches]
    assert got == want


# -- the JPEG batch path: the mask before stage 1 ----------------------------------------


def _jpeg_store(tmp_path, rows=48, decode=True):
    """A port-written JPEG store (16x24 q90 noise), 8 rows a row group."""
    from petastorm_tpu_torch import types
    from petastorm_tpu_torch.codecs import CompressedImageCodec, ScalarCodec
    from petastorm_tpu_torch.metadata import RowWriter
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField

    schema = Unischema("Jpeg", [
        UnischemaField("id", np.int64, (), ScalarCodec(types.LongType()), False),
        UnischemaField("image", np.uint8, (16, 24, 3), CompressedImageCodec("jpeg", 90),
                       False)])
    url = "file://" + str(tmp_path / ("jpeg%d" % rows))
    rng = np.random.RandomState(rows)
    with RowWriter(url, schema, row_group_size_mb=0, rows_per_file=8) as w:
        for i in range(rows):
            w.write({"id": i, "image": cv2.GaussianBlur(
                rng.randint(0, 256, (16, 24, 3)).astype(np.float32), (3, 3), 1.0)
                .clip(0, 255).astype(np.uint8)})
    return {"url": url}


def test_jpeg_mask_runs_before_stage_1(tmp_path, monkeypatch):
    """Rows a predicate drops never reach stage 1 (the native entropy decode); the kept
    rows' images equal, per id, the same reader's images without a predicate."""
    from petastorm_tpu_torch.codecs import CompressedImageCodec

    store = _jpeg_store(tmp_path)
    staged = []
    orig = CompressedImageCodec.host_stage_decode_batch

    def counting(self, field, values):
        staged.append(len(values))
        return orig(self, field, values)

    monkeypatch.setattr(CompressedImageCodec, "host_stage_decode_batch", counting)

    def images(**kw):
        reader = port_reader.make_batch_reader(store["url"], reader_pool_type="dummy",
                                               decode_on_device=True, **kw)
        out = {}
        with DataLoader(reader, 8, device="cpu", last_batch="partial") as loader:
            for b in loader:
                for rid, img in zip(b["id"].tolist(), b["image"]):
                    out[rid] = img.numpy()
        return out

    split = predicates.in_pseudorandom_split([0.6, 0.4], 0, "id")
    masked = images(predicate=split, filters=[("id", "<", 40)])
    want_ids = _batch_ids(ref_reader, store["url"], filters=[("id", "<", 40)],
                          predicate=ref_predicates.in_pseudorandom_split([0.6, 0.4], 0,
                                                                         "id"))
    assert sorted(masked) == sorted(i for b in want_ids for i in b)
    assert sum(staged) == len(masked) < 40  # stage 1 ran on the kept rows only
    staged.clear()
    everything = images()
    assert sum(staged) == 48
    for rid, img in masked.items():
        np.testing.assert_array_equal(img, everything[rid])


# -- the process pool ----------------------------------------------------------------


@pytest.mark.parametrize("factory,wire", [("make_batch_reader", "arrow"),
                                          ("make_reader", "pickle")])
def test_selection_through_the_process_pool(tmp_path, factory, wire):
    """A predicate, filters and row-drop partitions cross to the pool's children
    (pickled with the worker) and deliver the reference's rows."""
    store = _jpeg_store(tmp_path, rows=32)
    kw = dict(predicate=predicates.in_pseudorandom_split([0.5, 0.5], 1, "id"),
              filters=[("id", "!=", 7)], shuffle_row_drop_partitions=2, seed=1)
    ref_kw = dict(kw, predicate=ref_predicates.in_pseudorandom_split([0.5, 0.5], 1, "id"))
    with getattr(port_reader, factory)(store["url"], reader_pool_type="process",
                                       workers_count=2, wire_serializer=wire,
                                       schema_fields=["id"], **kw) as r:
        got = sorted(int(i) for x in r for i in np.atleast_1d(x.id))
    with getattr(ref_reader, factory)(store["url"], reader_pool_type="dummy",
                                      schema_fields=["id"], **ref_kw) as r:
        want = sorted(int(i) for x in r for i in np.atleast_1d(x.id))
    assert got == want and 0 < len(got) < 32
