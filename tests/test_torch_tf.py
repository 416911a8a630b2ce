"""Port vs reference: the TensorFlow bridges (``petastorm_tpu_torch.adapters.tf``:
``make_petastorm_dataset``, ``tf_tensors``; the ``tf_utils`` alias) over port readers
yield what the JAX package's yield over its readers, on stores made from a numpy seed:
batched and per-row readers (every codec, decimals as strings), hive partition
columns, NGram windows, the eager ``tf_tensors`` with and without a shuffle buffer, and
the refusals (staged device-decode readers, batched NGram readers). ``_tf_compatible``
converts dates, datetimes, decimals and None as the JAX package does.

tensorflow is imported only by the cases (``pytest.importorskip``); the port imports it
only when a bridge is called.
"""
import datetime
import decimal
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

torch = pytest.importorskip("torch")

from _torch_pool_helpers import _no_leaked_shm_segments  # noqa: E402,F401
from _torch_pool_helpers import no_leaked_port_slabs  # noqa: E402,F401
from petastorm_tpu import reader as ref_reader  # noqa: E402
from petastorm_tpu.adapters import tf as ref_tf  # noqa: E402
from petastorm_tpu_torch import reader as port_reader  # noqa: E402
from petastorm_tpu_torch.adapters import tf as port_tf  # noqa: E402

ROWS = 24


@pytest.fixture(scope="module")
def tf():
    return pytest.importorskip("tensorflow")


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    from test_common import create_test_dataset, create_test_scalar_dataset

    root = tmp_path_factory.mktemp("torch_tf")
    hive = root / "hive"
    rid = 0
    for region in ("us", "eu"):
        d = hive / ("region=%s" % region)
        os.makedirs(d)
        pq.write_table(pa.table({"id": np.arange(rid, rid + 6, dtype=np.int64)}),
                       str(d / "f.parquet"), row_group_size=3)
        rid += 6
    return {"rows": create_test_dataset("file://" + str(root / "rows"), num_rows=ROWS,
                                        seed=26),
            "scalar": create_test_scalar_dataset("file://" + str(root / "scalar"),
                                                 num_rows=ROWS, seed=27),
            "hive": "file://" + str(hive)}


def _numpy(struct):
    if isinstance(struct, dict):
        return {k: _numpy(v) for k, v in struct.items()}
    return np.asarray(struct.numpy())


def _both(make, factory_name, url, **kw):
    """``make(reader)`` over a port reader and over a JAX reader of the same store:
    every element as numpy, in order."""
    out = []
    for mod, adapter in ((port_reader, port_tf), (ref_reader, ref_tf)):
        factory = getattr(mod, factory_name)
        with factory(url, reader_pool_type="dummy", shuffle_row_groups=False,
                     num_epochs=1, **kw) as r:
            out.append([_numpy(x) for x in make(adapter)(r)])
    return out


def _assert_equal_elements(ours, theirs):
    assert len(ours) == len(theirs) and ours
    for a, b in zip(ours, theirs):
        assert sorted(a) == sorted(b)
        for k in a:
            if isinstance(a[k], dict):
                _assert_equal_elements([a[k]], [b[k]])
                continue
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_batched_dataset_equals_the_reference(tf, stores):
    ours, theirs = _both(lambda a: a.make_petastorm_dataset, "make_batch_reader",
                         stores["scalar"].url)
    _assert_equal_elements(ours, theirs)
    ids = [i for b in ours for i in b["id"].tolist()]
    assert sorted(ids) == sorted(r["id"] for r in stores["scalar"].data)


def test_per_row_dataset_of_every_codec_equals_the_reference(tf, stores):
    ours, theirs = _both(lambda a: a.make_petastorm_dataset, "make_reader",
                         stores["rows"].url)
    _assert_equal_elements(ours, theirs)
    assert len(ours) == ROWS
    row = ours[0]
    assert row["matrix"].shape == (8, 4) and row["image_png"].shape == (16, 16, 3)
    assert row["decimal"].dtype.kind == "S"  # decimals cross as strings
    want = {d["id"]: d for d in stores["rows"].data}
    for r in ours:
        assert decimal.Decimal(r["decimal"].item().decode()) \
            == want[int(r["id"])]["decimal"]
        assert r["nullable_str"].item() \
            == (want[int(r["id"])]["nullable_str"] or "").encode()


def test_hive_partition_columns_equal_the_reference(tf, stores):
    ours, theirs = _both(lambda a: a.make_petastorm_dataset, "make_batch_reader",
                         stores["hive"])
    _assert_equal_elements(ours, theirs)
    got = {i: r.decode() for b in ours for i, r in zip(b["id"].tolist(),
                                                        b["region"].tolist())}
    assert got == {i: "us" if i < 6 else "eu" for i in range(12)}


def test_ngram_windows_equal_the_reference(tf, stores):
    from petastorm_tpu.ngram import NGram as RefNGram
    from petastorm_tpu_torch.ngram import NGram

    out = []
    for mod, adapter, ngram in ((port_reader, port_tf, NGram), (ref_reader, ref_tf, RefNGram)):
        spec = ngram(fields={0: ["id", "matrix"], 1: ["id"]}, delta_threshold=10,
                     timestamp_field="id")
        with mod.make_reader(stores["rows"].url, schema_fields=spec, num_epochs=1,
                             reader_pool_type="dummy", shuffle_row_groups=False) as r:
            out.append([_numpy(w) for w in adapter.make_petastorm_dataset(r)])
    ours, theirs = out
    _assert_equal_elements(ours, theirs)
    for w in ours:
        assert set(w) == {"0", "1"}
        assert int(w["1"]["id"]) == int(w["0"]["id"]) + 1


@pytest.mark.parametrize("capacity", [0, 64])
def test_tf_tensors_eager_equals_the_reference(tf, stores, capacity):
    out = []
    for mod, adapter in ((port_reader, port_tf), (ref_reader, ref_tf)):
        with mod.make_batch_reader(stores["scalar"].url, reader_pool_type="dummy",
                                   shuffle_row_groups=False, num_epochs=1) as r:
            tf.random.set_seed(0)
            next_fn = adapter.tf_tensors(r, shuffling_queue_capacity=capacity)
            out.append(_numpy(next_fn()))
    ours, theirs = out
    assert "id" in ours
    if capacity:  # a shuffled stream: the same batch's rows, order aside
        assert sorted(ours) == sorted(theirs)
        assert all(ours[k].shape == theirs[k].shape for k in ours)
    else:
        _assert_equal_elements([ours], [theirs])


def test_staged_and_batched_ngram_readers_are_refused(tf, tmp_path, stores):
    import cv2

    from petastorm_tpu_torch import types
    from petastorm_tpu_torch.codecs import CompressedImageCodec, ScalarCodec
    from petastorm_tpu_torch.metadata import write_dataset
    from petastorm_tpu_torch.ngram import NGram
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField

    assert cv2 is not None
    rng = np.random.RandomState(28)
    schema = Unischema("S", [
        UnischemaField("id", np.int64, (), ScalarCodec(types.LongType()), False),
        UnischemaField("image", np.uint8, (16, 16, 3), CompressedImageCodec("jpeg"), False),
    ])
    url = "file://" + str(tmp_path / "ds")
    write_dataset(url, schema, ({"id": i, "image": rng.randint(0, 256, (16, 16, 3),
                                                               dtype=np.uint8)}
                                for i in range(4)))
    with port_reader.make_batch_reader(url, decode_on_device=True,
                                       reader_pool_type="dummy") as r:
        for bridge in (port_tf.make_petastorm_dataset, port_tf.tf_tensors):
            with pytest.raises(ValueError, match="petastorm_tpu_torch.loader.DataLoader"):
                bridge(r)
    spec = NGram(fields={0: ["id"], 1: ["id"]}, delta_threshold=10, timestamp_field="id")
    with port_reader.make_batch_reader(stores["rows"].url, schema_fields=spec,
                                       reader_pool_type="dummy") as r:
        with pytest.raises(ValueError, match="batched NGram"):
            port_tf.make_petastorm_dataset(r)


@pytest.mark.parametrize("value", [
    decimal.Decimal("12.500000001"), datetime.date(2024, 6, 2),
    datetime.datetime(2024, 6, 2, 13, 14, 15, 16),
    datetime.datetime(2024, 6, 2, 13, 14, 15, tzinfo=datetime.timezone.utc),
    np.datetime64("2024-06-02T01:02:03.000004"), None,
    np.array([decimal.Decimal("1.5"), decimal.Decimal("2.25")], dtype=object),
    np.array(["2024-06-02", "2024-06-03"], dtype="datetime64[D]"), np.float32(1.5),
], ids=["decimal", "date", "naive_datetime", "aware_datetime", "datetime64", "none",
        "object_array", "datetime64_array", "float32"])
def test_tf_compatible_converts_as_the_reference(value):
    ours, theirs = port_tf._tf_compatible(value), ref_tf._tf_compatible(value)
    assert type(ours) is type(theirs)
    np.testing.assert_array_equal(np.asarray(ours), np.asarray(theirs))


def test_the_tf_utils_alias_and_the_adapters_package(tf):
    from petastorm_tpu_torch import adapters, tf_utils

    assert tf_utils.make_petastorm_dataset is port_tf.make_petastorm_dataset
    assert tf_utils.tf_tensors is port_tf.tf_tensors
    assert adapters.make_petastorm_dataset is port_tf.make_petastorm_dataset
