"""Port vs reference: stores and readers. A store written by either package reads in the
other (same key-value metadata keys and schema JSON); the port's readers deliver the
same ids, labels and host-decoded images as the reference's; sharding and epochs keep
their exactly-once semantics."""
import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
pytest.importorskip("torch")

from _torch_pool_helpers import _no_leaked_shm_segments  # noqa: E402,F401

from petastorm_tpu import reader as ref_reader  # noqa: E402
from petastorm_tpu import metadata as ref_metadata  # noqa: E402
from petastorm_tpu import types as ref_types  # noqa: E402
from petastorm_tpu.codecs import (CompressedImageCodec as RefImage,  # noqa: E402
                                  NdarrayCodec as RefNdarray, ScalarCodec as RefScalar)
from petastorm_tpu.unischema import Unischema as RefSchema  # noqa: E402
from petastorm_tpu.unischema import UnischemaField as RefField  # noqa: E402
from petastorm_tpu_torch import make_batch_reader, make_reader  # noqa: E402
from petastorm_tpu_torch import metadata, types  # noqa: E402
from petastorm_tpu_torch.codecs import (CompressedImageCodec, NdarrayCodec,  # noqa: E402
                                        ScalarCodec)
from petastorm_tpu_torch.ops.jpeg import JpegPlanes  # noqa: E402
from petastorm_tpu_torch.unischema import Unischema, UnischemaField  # noqa: E402

ROWS = 40
SHAPE = (24, 32, 3)


def _rows():
    rng = np.random.RandomState(5)
    for i in range(ROWS):
        noise = rng.randint(0, 256, SHAPE).astype(np.float32)
        img = cv2.GaussianBlur(noise, (5, 5), 1.5).clip(0, 255).astype(np.uint8)
        yield {"id": i, "image": img, "label": np.int32(i % 7),
               "vec": rng.rand(4).astype(np.float32)}


def _ref_schema():
    return RefSchema("TorchPortSchema", [
        RefField("id", np.int64, (), RefScalar(ref_types.LongType()), False),
        RefField("image", np.uint8, SHAPE, RefImage("jpeg", 85), False),
        RefField("label", np.int32, (), RefScalar(ref_types.IntegerType()), False),
        RefField("vec", np.float32, (4,), RefNdarray(), False),
    ])


def _port_schema():
    return Unischema("TorchPortSchema", [
        UnischemaField("id", np.int64, (), ScalarCodec(types.LongType()), False),
        UnischemaField("image", np.uint8, SHAPE, CompressedImageCodec("jpeg", 85), False),
        UnischemaField("label", np.int32, (), ScalarCodec(types.IntegerType()), False),
        UnischemaField("vec", np.float32, (4,), NdarrayCodec(), False),
    ])


@pytest.fixture(scope="module")
def ref_store(tmp_path_factory):
    url = "file://" + str(tmp_path_factory.mktemp("torch_ref_store") / "ds")
    ref_metadata.write_dataset(url, _ref_schema(), _rows(), row_group_size_mb=0,
                               rows_per_file=16)
    return url


@pytest.fixture(scope="module")
def port_store(tmp_path_factory):
    url = "file://" + str(tmp_path_factory.mktemp("torch_port_store") / "ds")
    metadata.write_dataset(url, _port_schema(), _rows(), row_group_size_mb=0,
                           rows_per_file=16)
    return url


def _by_id(rows):
    return {int(r.id): r for r in rows}


def test_reference_store_rows_equal_through_make_reader(ref_store):
    with ref_reader.make_reader(ref_store, reader_pool_type="dummy") as r:
        theirs = _by_id(list(r))
    with make_reader(ref_store, reader_pool_type="dummy") as r:
        ours = _by_id(list(r))
    assert sorted(ours) == list(range(ROWS)) and sorted(theirs) == sorted(ours)
    for i, row in ours.items():
        assert row.label == theirs[i].label
        np.testing.assert_array_equal(row.image, theirs[i].image)
        np.testing.assert_array_equal(row.vec, theirs[i].vec)


def test_reference_store_batches_equal_through_make_batch_reader(ref_store):
    kwargs = dict(workers_count=1, shuffle_row_groups=False)
    with ref_reader.make_batch_reader(ref_store, **kwargs) as r:
        theirs = list(r)
    with make_batch_reader(ref_store, **kwargs) as r:
        ours = list(r)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a.id, b.id)
        np.testing.assert_array_equal(a.label, b.label)
        np.testing.assert_array_equal(a.image, b.image)
        np.testing.assert_array_equal(a.vec, b.vec)


def test_port_store_reads_in_reference_with_equal_schema(port_store):
    theirs = ref_metadata.get_schema_from_dataset_url(port_store)
    ours = metadata.get_schema_from_dataset_url(port_store)
    assert theirs.to_json() == ours.to_json() == _ref_schema().to_json()
    with ref_reader.make_reader(port_store, reader_pool_type="dummy") as r:
        theirs_rows = _by_id(list(r))
    with make_reader(port_store, reader_pool_type="dummy") as r:
        ours_rows = _by_id(list(r))
    assert sorted(theirs_rows) == list(range(ROWS))
    for i, row in ours_rows.items():
        np.testing.assert_array_equal(row.image, theirs_rows[i].image)


@pytest.mark.parametrize("factory", [make_reader, make_batch_reader])
def test_shards_are_disjoint_and_cover_the_store(ref_store, factory):
    seen = []
    for shard in range(3):
        with factory(ref_store, cur_shard=shard, shard_count=3, workers_count=2) as r:
            ids = [int(i) for item in r for i in np.atleast_1d(item.id)]
        seen.append(set(ids))
        assert len(ids) == len(set(ids))
    assert all(not (a & b) for i, a in enumerate(seen) for b in seen[i + 1:])
    assert set().union(*seen) == set(range(ROWS))


def test_two_epochs_deliver_each_row_twice(ref_store):
    with make_batch_reader(ref_store, num_epochs=2, workers_count=3, seed=1) as r:
        ids = np.concatenate([b.id for b in r])
    counts = np.bincount(ids, minlength=ROWS)
    assert (counts == 2).all()


def test_shuffle_row_groups_same_plan_as_reference(ref_store):
    kwargs = dict(reader_pool_type="dummy", shuffle_row_groups=True, seed=7)
    with ref_reader.make_batch_reader(ref_store, **kwargs) as r:
        theirs = [list(b.id) for b in r]
    with make_batch_reader(ref_store, **kwargs) as r:
        ours = [list(b.id) for b in r]
    assert ours == theirs


def test_decode_on_device_stages_coefficient_planes(ref_store):
    with make_batch_reader(ref_store, reader_pool_type="dummy",
                           decode_on_device=True) as r:
        assert r.device_decode_fields == frozenset({"image"})
        batch = next(r)
    assert batch.image.dtype == object
    assert all(isinstance(p, JpegPlanes) for p in batch.image)
    assert batch.image[0].height == SHAPE[0] and batch.image[0].width == SHAPE[1]


def test_reset_restarts_the_epoch(ref_store):
    with make_reader(ref_store, reader_pool_type="dummy") as r:
        first = [int(row.id) for row in r]
        assert r.last_row_consumed
        r.reset()
        again = [int(row.id) for row in r]
    assert first == again and len(first) == ROWS


# predicate, filters and shuffle_row_drop_partitions are ported (tests/test_torch_selection.py),
# and so are cache_* and the read path's io_options (tests/test_torch_io_async.py). The
# object-store tier and the arena (item 5b) are ported too: their cases (1-3) now read
# the store, equal to the plain read (tests/test_torch_remote_io.py, test_torch_arena.py).
# The recovery policy is ported (item 8a): the io_retries and recovery cases read too.
# Provenance is ported (item 8b(ii)): its case reads too, and records every row group.
# The tenant is ported (item 8c(i)): its case reads too, and charges every row to it.
# The dataset watch is ported (item 8c(ii)): its case reads too, equal to the plain read.
# The tcp transport is ported (item 4(c)): its case reads through a process pool on tcp
@pytest.mark.parametrize("kwargs", [
    {"reader_pool_type": "process", "transport": "tcp"},
    {"io_options": {"arena_bytes": 1 << 20}},
    {"io_options": {"remote": {"enabled": True}}},
    {"io_options": {"remote": {"hedge": False}}}, {"io_retries": 3},
    {"provenance": True}, {"recovery": {"on_poison": "quarantine"}},
    {"tenant": "team-a"}, {"watch": True},
])
def test_unported_reader_options_raise_naming_the_roadmap(ref_store, kwargs):
    if kwargs.get("transport") == "tcp":
        with make_batch_reader(ref_store, shuffle_row_groups=False, workers_count=2,
                               results_timeout_s=120, **kwargs) as r:
            assert r._executor._transport_name == "tcp"
            got = sorted(int(i) for b in r for i in np.asarray(b.id))
        with make_batch_reader(ref_store, reader_pool_type="dummy",
                               shuffle_row_groups=False) as r:
            want = sorted(int(i) for b in r for i in np.asarray(b.id))
        assert got == want and got
        return
    if "io_options" in kwargs or "io_retries" in kwargs or "recovery" in kwargs \
            or "watch" in kwargs:
        from petastorm_tpu_torch.io import arena as arena_mod
        from petastorm_tpu_torch.io.memcache import shared_store

        try:
            with make_batch_reader(ref_store, reader_pool_type="dummy",
                                   shuffle_row_groups=False, **kwargs) as r:
                got = sorted(int(i) for b in r for i in np.asarray(b.id))
            with make_batch_reader(ref_store, reader_pool_type="dummy",
                                   shuffle_row_groups=False) as r:
                want = sorted(int(i) for b in r for i in np.asarray(b.id))
        finally:
            arena_mod.close_process_arena()
            shared_store().clear()  # the arena implies a process-wide memcache
        assert got == want and got
        return
    if "tenant" in kwargs:
        from petastorm_tpu_torch.obs.metrics import default_registry

        name = 'ptpu_tenant_rows_total{tenant="team-a"}'
        before = default_registry().snapshot().get(name, 0)
        with make_batch_reader(ref_store, reader_pool_type="dummy",
                               shuffle_row_groups=False, **kwargs) as r:
            got = sorted(int(i) for b in r for i in np.asarray(b.id))
        with make_batch_reader(ref_store, reader_pool_type="dummy",
                               shuffle_row_groups=False) as r:
            want = sorted(int(i) for b in r for i in np.asarray(b.id))
        assert got == want and got
        assert default_registry().snapshot()[name] - before == len(got)
        return
    if "provenance" in kwargs:
        from petastorm_tpu_torch.obs import provenance as prov

        try:
            with make_batch_reader(ref_store, reader_pool_type="dummy",
                                   shuffle_row_groups=False, **kwargs) as r:
                got = sorted(int(i) for b in r for i in np.asarray(b.id))
                rows = sum(rec["rows"] for rec in r._prov.items().values())
        finally:
            prov.ACTIVE = None
        assert got and rows == len(got)
        return
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item"):
        make_batch_reader(ref_store, **kwargs)
