"""The slice as a whole: a JPEG store the reference wrote, read with decode_on_device=True,
through the reference's DataLoader (JAX, Pallas in interpret mode) and through the port's
DataLoader(device="cpu"). The uint8 images must be bit-identical and the labels equal;
the normalised float32 device_transform output within 1e-5."""
import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
torch = pytest.importorskip("torch")

from _torch_pool_helpers import _no_leaked_shm_segments  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from petastorm_tpu import loader as ref_loader  # noqa: E402
from petastorm_tpu import metadata as ref_metadata  # noqa: E402
from petastorm_tpu import reader as ref_reader  # noqa: E402
from petastorm_tpu import types as ref_types  # noqa: E402
from petastorm_tpu.codecs import CompressedImageCodec as RefImage  # noqa: E402
from petastorm_tpu.codecs import ScalarCodec as RefScalar  # noqa: E402
from petastorm_tpu.ops.image import normalize_images as ref_normalize  # noqa: E402
from petastorm_tpu.unischema import Unischema as RefSchema  # noqa: E402
from petastorm_tpu.unischema import UnischemaField as RefField  # noqa: E402
from petastorm_tpu_torch import make_batch_reader, make_reader  # noqa: E402
from petastorm_tpu_torch.loader import DataLoader, PipelineStats  # noqa: E402
from petastorm_tpu_torch.ops.image import normalize_images  # noqa: E402

ROWS = 64
SHAPE = (64, 48, 3)
MEAN = [0.485, 0.456, 0.406]
STD = [0.229, 0.224, 0.225]
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def jpeg_store(tmp_path_factory):
    schema = RefSchema("LoaderSchema", [
        RefField("id", np.int64, (), RefScalar(ref_types.LongType()), False),
        RefField("image", np.uint8, SHAPE, RefImage("jpeg", 85), False),
        RefField("label", np.int32, (), RefScalar(ref_types.IntegerType()), False),
    ])
    rng = np.random.RandomState(9)
    x = np.linspace(0, 255, SHAPE[1], dtype=np.float32)
    grad = np.add.outer(np.linspace(0, 255, SHAPE[0], dtype=np.float32), x) * 0.5

    def rows():
        for i in range(ROWS):
            noise = rng.randint(0, 256, SHAPE).astype(np.float32)
            img = 0.55 * cv2.GaussianBlur(noise, (7, 7), 2.0) + 0.45 * grad[..., None]
            yield {"id": i, "image": img.clip(0, 255).astype(np.uint8),
                   "label": np.int32(i % 10)}

    url = "file://" + str(tmp_path_factory.mktemp("torch_loader_store") / "ds")
    ref_metadata.write_dataset(url, schema, rows(), row_group_size_mb=0, rows_per_file=32)
    assert len(ref_metadata.load_row_groups(*_fs_path(url))) >= 2
    return url


def _fs_path(url):
    from petastorm_tpu.fs import get_filesystem_and_path_or_paths

    return get_filesystem_and_path_or_paths(url)


READER_KW = dict(workers_count=1, shuffle_row_groups=False, decode_on_device=True)


def _reference_batches(url, batch_size, transform=None, **kw):
    reader = ref_reader.make_batch_reader(url, **READER_KW)
    with ref_loader.DataLoader(reader, batch_size, device_transform=transform,
                               **kw) as loader:
        return [{k: np.asarray(v) for k, v in b.items()} for b in loader]


def _port_batches(url, batch_size, transform=None, factory=make_batch_reader, **kw):
    reader = factory(url, **READER_KW)
    with DataLoader(reader, batch_size, device=CPU, device_transform=transform,
                    **kw) as loader:
        out = [{k: (v.numpy() if isinstance(v, torch.Tensor) else v)
                for k, v in b.items()} for b in loader]
        return out, loader


def test_uint8_images_bit_identical_to_reference(jpeg_store):
    theirs = _reference_batches(jpeg_store, 16)
    ours, loader = _port_batches(jpeg_store, 16)
    assert len(ours) == len(theirs) == ROWS // 16
    for a, b in zip(ours, theirs):
        assert a["image"].dtype == np.uint8 and a["image"].shape == (16,) + SHAPE
        np.testing.assert_array_equal(a["image"], b["image"])
        np.testing.assert_array_equal(a["label"], b["label"])
        np.testing.assert_array_equal(a["id"], b["id"])
    assert loader.stats.rows == ROWS and loader.stats.batches == ROWS // 16


def test_normalized_transform_within_tolerance_of_reference(jpeg_store):
    def ref_transform(b):
        return {**b, "image": ref_normalize(b["image"], MEAN, STD, out_dtype=jnp.float32)}

    def port_transform(b):
        return {**b, "image": normalize_images(b["image"], MEAN, STD,
                                               out_dtype=torch.float32)}

    theirs = _reference_batches(jpeg_store, 32, ref_transform)
    ours, _ = _port_batches(jpeg_store, 32, port_transform)
    assert len(ours) == len(theirs) == 2
    for a, b in zip(ours, theirs):
        assert a["image"].dtype == np.float32
        np.testing.assert_allclose(a["image"], b["image"], rtol=0, atol=1e-5)
        np.testing.assert_array_equal(a["label"], b["label"])


def test_per_row_reader_batches_equal_batch_reader(jpeg_store):
    rows, _ = _port_batches(jpeg_store, 16, factory=make_reader)
    cols, _ = _port_batches(jpeg_store, 16)
    for a, b in zip(rows, cols):
        np.testing.assert_array_equal(a["image"], b["image"])
        np.testing.assert_array_equal(a["label"], b["label"])


@pytest.mark.parametrize("last_batch,sizes", [("drop", [24, 24]), ("partial", [24, 24, 16]),
                                              ("pad", [24, 24, 24])])
def test_last_batch_policies(jpeg_store, last_batch, sizes):
    ours, _ = _port_batches(jpeg_store, 24, last_batch=last_batch, prefetch=0)
    assert [len(b["label"]) for b in ours] == sizes
    if last_batch == "pad":
        valid = ours[-1]["__valid__"]
        assert valid.sum() == 16 and not valid[16:].any()
        np.testing.assert_array_equal(ours[-1]["image"][16:],
                                      np.repeat(ours[-1]["image"][15:16], 8, axis=0))


def test_shuffling_buffer_is_a_permutation(jpeg_store):
    reader = make_batch_reader(jpeg_store, **READER_KW)
    with DataLoader(reader, 8, device=CPU, shuffling_queue_capacity=32, seed=3,
                    last_batch="partial") as loader:
        ids = np.concatenate([b["id"].numpy() for b in loader])
    assert sorted(ids) == list(range(ROWS)) and list(ids) != list(range(ROWS))


def test_two_argument_transform_gets_a_seeded_generator(jpeg_store):
    def flip_some(batch, generator):
        assert isinstance(generator, torch.Generator)
        return {**batch, "coin": torch.rand(len(batch["label"]), generator=generator)}

    a, _ = _port_batches(jpeg_store, 16, flip_some, seed=5)
    b, _ = _port_batches(jpeg_store, 16, flip_some, seed=5)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x["coin"], y["coin"])


def test_pipeline_stats_field_names_equal_reference():
    # the reference's fields, in order, plus the port's inflate-stage seconds
    # (``inflate_s``; the JAX package keeps that time in a metrics histogram)
    assert PipelineStats.__slots__ == ref_loader.PipelineStats.__slots__ + ("inflate_s",)
    assert list(PipelineStats().snapshot()) \
        == list(ref_loader.PipelineStats().snapshot()) + ["inflate_s"]


def test_reader_errors_reach_the_consumer(jpeg_store):
    reader = make_batch_reader(jpeg_store, **READER_KW)

    def boom(batch):
        raise RuntimeError("transform exploded")

    with DataLoader(reader, 16, device=CPU, device_transform=boom) as loader:
        with pytest.raises(RuntimeError, match="transform exploded"):
            list(loader)


def test_abandoned_iteration_stops_and_a_new_one_restarts(jpeg_store):
    reader = make_batch_reader(jpeg_store, workers_count=1, shuffle_row_groups=False,
                               decode_on_device=True, num_epochs=None)
    with DataLoader(reader, 16, device=CPU) as loader:
        it = iter(loader)
        first = next(it)
        it.close()
        assert loader._stop.is_set()
        second = next(iter(loader))
        assert first["image"].shape == second["image"].shape == (16,) + SHAPE


def test_dataloader_signature_is_the_references_then_device():
    """The reference's parameters, by name and in order, then ``device`` keyword-only."""
    import inspect

    theirs = list(inspect.signature(ref_loader.DataLoader.__init__).parameters.values())
    ours = list(inspect.signature(DataLoader.__init__).parameters.values())
    assert [p.name for p in ours] == [p.name for p in theirs] + ["device"]
    for a, b in zip(ours, theirs):
        assert a.kind == b.kind and a.default == b.default, (a, b)
    assert ours[-1].kind == inspect.Parameter.KEYWORD_ONLY and ours[-1].default is None


def test_to_device_false_batches_equal_reference(jpeg_store):
    """``to_device=False`` delivers host numpy after the staged decode, equal to the
    reference's ``to_device=False`` batches on the same store."""
    theirs = _reference_batches(jpeg_store, 16, to_device=False)
    reader = make_batch_reader(jpeg_store, **READER_KW)
    with DataLoader(reader, 16, to_device=False, device=CPU) as loader:
        ours = list(loader)
    assert len(ours) == len(theirs) == ROWS // 16
    for a, b in zip(ours, theirs):
        assert set(a) == set(b)
        for name in b:
            assert isinstance(a[name], np.ndarray), name
            assert a[name].dtype == np.asarray(b[name]).dtype, name
            np.testing.assert_array_equal(a[name], np.asarray(b[name]))


MIXED_SHAPES = [(40, 56, 3), (56, 40, 3), (33, 47, 3)]


@pytest.fixture(scope="module")
def mixed_store(tmp_path_factory):
    """A mixed-size JPEG store the reference wrote: each row's size drawn from a seed,
    several sizes in every row group (so most rows take the per-image stage 1)."""
    schema = RefSchema("MixedSchema", [
        RefField("id", np.int64, (), RefScalar(ref_types.LongType()), False),
        RefField("image", np.uint8, (None, None, 3), RefImage("jpeg", 85), False),
    ])
    rng = np.random.RandomState(19)

    def rows():
        for i in range(48):
            shape = MIXED_SHAPES[rng.randint(len(MIXED_SHAPES))]
            noise = rng.randint(0, 256, shape).astype(np.float32)
            img = cv2.GaussianBlur(noise, (5, 5), 1.5).clip(0, 255).astype(np.uint8)
            yield {"id": i, "image": img}

    url = "file://" + str(tmp_path_factory.mktemp("torch_mixed_store") / "ds")
    ref_metadata.write_dataset(url, schema, rows(), row_group_size_mb=0, rows_per_file=24)
    return url


def test_mixed_size_store_with_device_decode_resize_within_one_of_reference(mixed_store):
    """Each batch holds several layout groups: each decodes at its stored size, is
    resized on the device and gathered back in order. The resize differs from the
    reference's by at most 1 on uint8, on a small share of the values."""
    from petastorm_tpu.ops import jpeg as ref_jpeg
    from petastorm_tpu_torch.ops import jpeg as port_jpeg

    # both packages start from a fresh transfer state: its sticky per-layout choices are
    # process-global, and a test file run earlier in this process (the JAX package's
    # tests/test_jpeg.py decodes the same 40x56 layout) would leave them apart
    for mod in (port_jpeg, ref_jpeg):
        with mod._STICKY_KS_LOCK:
            mod._STICKY_KS.clear()
            mod._STICKY_SPLIT.clear()
            mod._PACK12_DISABLED.clear()
            mod._SPLIT_DISABLED.clear()
    port_jpeg.transfer_byte_counters(reset=True)
    ref_jpeg.transfer_byte_counters(reset=True)
    theirs = _reference_batches(mixed_store, 16, device_decode_resize=(36, 44))
    ours, _ = _port_batches(mixed_store, 16, device_decode_resize={"image": (36, 44)})
    assert len(ours) == len(theirs) == 3
    for a, b in zip(ours, theirs):
        assert a["image"].shape == (16, 36, 44, 3) and a["image"].dtype == np.uint8
        np.testing.assert_array_equal(a["id"], b["id"])
        diff = np.abs(a["image"].astype(np.int32) - b["image"].astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() < 0.01
    assert port_jpeg.transfer_byte_counters() == ref_jpeg.transfer_byte_counters()


def test_mixed_size_store_without_resize_raises_naming_the_option(mixed_store):
    with pytest.raises(ValueError, match="device_decode_resize"):
        _port_batches(mixed_store, 16)


def test_device_decode_resize_is_validated_at_construction(mixed_store):
    reader = make_batch_reader(mixed_store, **READER_KW)
    try:
        with pytest.raises(ValueError, match="spelled right"):
            DataLoader(reader, 16, device=CPU, device_decode_resize={"imgae": (8, 8)})
        with pytest.raises(ValueError, match="two positive ints|pair"):
            DataLoader(reader, 16, device=CPU, device_decode_resize=(8, 0))
        with pytest.raises(ValueError, match="pair"):
            DataLoader(reader, 16, device=CPU, device_decode_resize=8)
    finally:
        reader.stop()
        reader.join()


@pytest.mark.gpu
def test_no_oversized_staging_across_a_store_whose_ks_grow(tmp_path):
    """Smooth row groups first (narrow zigzag prefixes), sharp ones after (the sticky ks
    grow to 64): the pinned ring, sized by the first batch's full int16 bound, takes
    every batch without an unpooled copy, and the batches equal the CPU path's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from petastorm_tpu_torch.io import staging

    schema = RefSchema("GrowSchema", [
        RefField("id", np.int64, (), RefScalar(ref_types.LongType()), False),
        RefField("image", np.uint8, SHAPE, RefImage("jpeg", 95), False),
    ])
    rng = np.random.RandomState(20)

    def rows():
        for i in range(64):
            noise = rng.randint(0, 256, SHAPE).astype(np.float32)
            img = cv2.GaussianBlur(noise, (9, 9), 3.0) if i < 32 else noise
            yield {"id": i, "image": img.clip(0, 255).astype(np.uint8)}

    url = "file://" + str(tmp_path / "grow")
    ref_metadata.write_dataset(url, schema, rows(), row_group_size_mb=0, rows_per_file=16)
    before = staging.DEGRADATIONS["staging_oversized"]
    reader = make_batch_reader(url, **READER_KW)
    with DataLoader(reader, 16, device="cuda") as loader:
        on_card = [b["image"].cpu().numpy() for b in loader]
    assert staging.DEGRADATIONS["staging_oversized"] == before
    cpu, _ = _port_batches(url, 16)
    assert len(on_card) == len(cpu) == 4
    for a, b in zip(on_card, cpu):
        np.testing.assert_array_equal(a, b["image"])


# -- the click-through training feed: pass-through → shuffle ring → feature pipeline ----

CRITEO_DENSE, CRITEO_CATS = 4, 6
CRITEO_VOCAB = (39884406, 39043, 17289, 7420, 20263, 3)


@pytest.fixture(scope="module")
def criteo_store(tmp_path_factory):
    """A small Criteo-shaped store from a numpy seed: an int32 label, float32 dense
    columns (one with NaN gaps), int32 categoricals modulo the MLPerf vocabulary sizes;
    2 files of 2 row groups of 512 rows, snappy, dictionary pages."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    root = tmp_path_factory.mktemp("torch_criteo_store")
    rng = np.random.default_rng(3)
    n = 1024
    for f in range(2):
        cols = {"label": (rng.random(n) < 0.034).astype(np.int32)}
        for i in range(CRITEO_DENSE):
            dense = np.log1p(rng.zipf(1.6, n).astype(np.float64)).astype(np.float32)
            if i == 0:
                dense[rng.random(n) < 0.1] = np.nan
            cols["i%d" % i] = dense
        for i, vocab in enumerate(CRITEO_VOCAB):
            cols["c%d" % i] = (rng.zipf(1.2, n) % vocab).astype(np.int32)
        pq.write_table(pa.table(cols), str(root / ("part-%d.parquet" % f)),
                       row_group_size=512, compression="snappy",
                       use_dictionary=[c for c in cols if c != "label"],
                       data_page_version="1.0")
    return "file://" + str(root)


def _criteo_ops(m, device=True):
    ops = []
    for i in range(CRITEO_DENSE):
        ops += [m.Standardize("i%d" % i, out="dense%d" % i), m.FillNull("dense%d" % i, 0.0)]
    ops += [m.HashField("c%d" % i, v, out="cat%d" % i) for i, v in enumerate(CRITEO_VOCAB)]
    ops += [m.Bucketize("i1", num_buckets=8, out="i1_bucket"),
            m.VocabLookup("c1", max_size=20, out="c1_vocab"),
            m.FeatureCross(("c2", "c3"), 1000, out="c2_x_c3"),
            m.Normalize("i3", out="i3_unit")]
    return m.FeaturePipeline(ops, device=device)


def _row_multiset(batches):
    """Sorted per-row byte strings over every column (NaN-safe)."""
    rows = []
    for b in batches:
        names = sorted(b)
        cols = [np.ascontiguousarray(np.asarray(b[k])) for k in names]
        n = len(cols[0])
        rows.extend(b"".join(c[i].tobytes() for c in cols) for i in range(n))
    return sorted(rows), sorted(batches[0]) if batches else []


def _as_numpy(batch):
    return {k: v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in batch.items()}


def test_criteo_feed_through_ring_and_pipeline_equals_the_reference(criteo_store,
                                                                    monkeypatch):
    """The slice end to end on the CPU: compressed pages shipped and inflated by the
    kernels' plain versions, the device shuffle ring, then the declarative pipeline's
    device function. As a multiset of rows (raw and derived columns, every byte) it
    equals the JAX package's DataLoader with the same pipeline and statistics and no
    ring; the ring changed the order."""
    from petastorm_tpu import reader as ref_reader_mod
    from petastorm_tpu.io import statscache as ref_stats
    from petastorm_tpu.ops import tabular as ref_tab
    from petastorm_tpu_torch.io import pagedec
    from petastorm_tpu_torch.ops import tabular as port_tab

    monkeypatch.setenv("PTPU_PAGEDEC_DEVICE", "1")  # plain K3 / scan / K4 on the CPU
    ref_stats.clear_memo()
    kw = dict(workers_count=1, shuffle_row_groups=False)
    ref_reader = ref_reader_mod.make_batch_reader(criteo_store, **kw)
    ref_pipe = _criteo_ops(ref_tab)
    fs, path = _fs_path(criteo_store)
    stats, sources = ref_stats.resolve_statistics(
        ref_pipe.required_statistics(ref_reader.schema), fs,
        ref_metadata.load_row_groups(fs, path))
    assert sources["min:i3"] == "rowgroup-stats" and sources["mean:i0"] == "data-pass"
    ref_pipe.compile(ref_reader.schema, statistics=stats)
    with ref_loader.DataLoader(ref_reader, 256, device_transform=ref_pipe) as loader:
        theirs = [{k: np.asarray(v) for k, v in b.items()} for b in loader]
    ref_stats.clear_memo()

    def port_run(capacity):
        reader = make_batch_reader(criteo_store, io_options={"pagedec": "on"}, **kw)
        pipe = _criteo_ops(port_tab).compile(reader.schema, statistics=stats)
        with DataLoader(reader, 256, device=CPU, device_transform=pipe, seed=4,
                        device_shuffle_capacity=capacity) as loader:
            return [_as_numpy(b) for b in loader]

    before = pagedec.counter_values()
    ours = port_run(1024)
    after = pagedec.counter_values()
    assert after["pages"] > before["pages"]  # the pass-through ran
    assert after["host_inflate_columns"] == before["host_inflate_columns"]
    assert len(ours) == len(theirs) == 8
    for a, b in zip(ours, theirs):
        assert sorted(a) == sorted(b)
        for k in b:
            assert a[k].dtype == b[k].dtype, k
    assert _row_multiset(ours) == _row_multiset(theirs)
    unshuffled = port_run(0)
    assert _row_multiset(unshuffled) == _row_multiset(theirs)
    assert [b["label"].tobytes() + b["c0"].tobytes() for b in ours] != \
        [b["label"].tobytes() + b["c0"].tobytes() for b in unshuffled]


def test_device_transform_spec_on_the_reader_is_the_loaders_device_transform(criteo_store):
    """``make_batch_reader(transform_spec=FeaturePipeline(..., device=True))`` resolves
    its own statistics and the DataLoader applies it on its device; the pass-through is
    off for such a read. The rows equal the JAX package's same reader and loader."""
    from petastorm_tpu import reader as ref_reader_mod
    from petastorm_tpu.io import statscache as ref_stats
    from petastorm_tpu.ops import tabular as ref_tab
    from petastorm_tpu_torch.io import statscache as port_stats
    from petastorm_tpu_torch.ops import tabular as port_tab

    kw = dict(workers_count=1, shuffle_row_groups=False)
    ref_stats.clear_memo()
    port_stats.clear_memo()
    ref_reader = ref_reader_mod.make_batch_reader(criteo_store,
                                                  transform_spec=_criteo_ops(ref_tab), **kw)
    with ref_loader.DataLoader(ref_reader, 512) as loader:
        theirs = [{k: np.asarray(v) for k, v in b.items()} for b in loader]
    reader = make_batch_reader(criteo_store, transform_spec=_criteo_ops(port_tab),
                               io_options={"pagedec": "on"}, **kw)
    assert reader.transform_spec.stats_info == ref_reader.transform_spec.stats_info
    assert list(reader.schema.fields) == list(ref_reader.schema.fields)
    with DataLoader(reader, 512, device=CPU) as loader:
        ours = [_as_numpy(b) for b in loader]
    ref_stats.clear_memo()
    port_stats.clear_memo()
    assert len(ours) == len(theirs) == 4
    for a, b in zip(ours, theirs):
        assert sorted(a) == sorted(b)
        for k in b:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_device_shuffle_composes_with_device_decode(jpeg_store):
    """decode_on_device + device_shuffle_capacity (the JAX package's
    test_device_decode_composes_with_device_shuffle): decoded uint8 images ride the ring,
    every row appears once, the order is not the plan's, and every image equals the
    JAX package's ring-less image of the same id bit for bit."""
    theirs = _reference_batches(jpeg_store, 16)
    expected = {int(i): img for b in theirs for i, img in zip(b["id"], b["image"])}
    ours, loader = _port_batches(jpeg_store, 16, device_shuffle_capacity=40, seed=13)
    order = [int(i) for b in ours for i in b["id"]]
    assert sorted(order) == list(range(ROWS)) and order != sorted(order)
    for b in ours:
        assert b["image"].shape == (16,) + SHAPE
        for i, img in zip(b["id"], b["image"]):
            np.testing.assert_array_equal(img, expected[int(i)])
    assert loader.stats.rows == ROWS


def test_device_shuffle_refusals(jpeg_store, tmp_path):
    import pyarrow as pa
    import pyarrow.parquet as pq

    from petastorm_tpu_torch.ops.tabular import (FeaturePipeline, PipelineValidationError,
                                                 Standardize)

    reader = make_batch_reader(jpeg_store, **READER_KW)
    try:
        with pytest.raises(ValueError, match="requires to_device=True"):
            DataLoader(reader, 16, device=CPU, to_device=False, device_shuffle_capacity=32)
        with pytest.raises(PipelineValidationError, match="statistics"):
            DataLoader(reader, 16, device=CPU,
                       device_transform=FeaturePipeline([Standardize("label")],
                                                        device=True))
    finally:
        reader.stop()
        reader.join()
    pq.write_table(pa.table({"id": np.arange(8), "s": ["a"] * 8}), str(tmp_path / "s.parquet"))
    reader = make_batch_reader("file://" + str(tmp_path), reader_pool_type="dummy")
    with DataLoader(reader, 4, device=CPU, device_shuffle_capacity=8) as loader:
        with pytest.raises(ValueError, match="host-only"):
            list(loader)


@pytest.mark.gpu
def test_criteo_feed_on_the_card_equals_the_cpu(criteo_store):
    """The feed on the card (the kernels, the ring and the pipeline on CUDA tensors):
    every delivered tensor on the card, the same multiset of rows as the CPU run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from petastorm_tpu_torch.io import statscache as port_stats
    from petastorm_tpu_torch.ops import pagedec_kernels as pk
    from petastorm_tpu_torch.ops import tabular as port_tab

    port_stats.clear_memo()

    def run(device, capacity):
        from petastorm_tpu_torch.metadata import load_row_groups

        reader = make_batch_reader(criteo_store, io_options={"pagedec": "on"},
                                   workers_count=1, shuffle_row_groups=False)
        fs, path = _fs_path(criteo_store)
        pipe = _criteo_ops(port_tab)
        stats, _src = port_stats.resolve_statistics(
            pipe.required_statistics(reader.schema), fs, load_row_groups(fs, path))
        pipe.compile(reader.schema, statistics=stats)
        with DataLoader(reader, 256, device=device, device_transform=pipe, seed=2,
                        device_shuffle_capacity=capacity) as loader:
            batches = list(loader)
        if device == "cuda":
            assert all(v.is_cuda for b in batches for v in b.values())
        return [_as_numpy({k: v.cpu() for k, v in b.items()}) for b in batches]

    launches = pk.extract_pages.launches
    card = run("cuda", 1024)
    assert pk.extract_pages.launches > launches
    assert _row_multiset(card) == _row_multiset(run(CPU, 0))
    port_stats.clear_memo()


# -- pad_shapes ------------------------------------------------------------------------


def _ragged_cases():
    rng = np.random.RandomState(21)
    ragged_1d = np.empty(9, dtype=object)
    ragged_1d[:] = [rng.randint(0, 1000, rng.randint(0, 7)).astype(np.int32)
                    for _ in range(9)]
    ragged_2d = np.empty(5, dtype=object)
    ragged_2d[:] = [rng.rand(rng.randint(1, 4), rng.randint(1, 3)).astype(np.float32)
                    for _ in range(5)]
    return {
        "ragged_1d": ({"h": ragged_1d, "id": np.arange(9)}, {"h": (8,)}),
        "ragged_2d": ({"m": ragged_2d}, {"m": (3, 2)}),
        "uniform_below_max": ({"u": rng.rand(4, 3).astype(np.float32)}, {"u": (5,)}),
        "uniform_at_max": ({"u": rng.rand(4, 5).astype(np.float32)}, {"u": (5,)}),
        "list_rows": ({"l": [[1, 2], [3]]}, {"l": (4,)}),
        "absent_field": ({"id": np.arange(3)}, {"h": (8,)}),
    }


@pytest.mark.parametrize("case", sorted(_ragged_cases()))
def test_pad_ragged_columns_equal_reference(case):
    from petastorm_tpu_torch.loader import _pad_ragged_columns

    columns, shapes = _ragged_cases()[case]
    got = _pad_ragged_columns(columns, shapes)
    want = ref_loader._pad_ragged_columns(columns, shapes)
    assert sorted(got) == sorted(want)
    for name in want:
        assert np.asarray(got[name]).dtype == np.asarray(want[name]).dtype, name
        np.testing.assert_array_equal(np.asarray(got[name]), np.asarray(want[name]))


@pytest.mark.parametrize("rows,shape", [([np.zeros((2, 2)), np.zeros((1, 1))], (4,)),
                                        ([np.zeros(3), np.zeros(9)], (4,))],
                         ids=["rank_mismatch", "exceeds_max"])
def test_pad_ragged_columns_errors_are_the_references(rows, shape):
    from petastorm_tpu_torch.loader import _pad_ragged_columns

    col = np.empty(len(rows), dtype=object)
    col[:] = rows
    with pytest.raises(ValueError) as err:
        _pad_ragged_columns({"x": col}, {"x": shape})
    with pytest.raises(ValueError) as ref_err:
        ref_loader._pad_ragged_columns({"x": col}, {"x": shape})
    assert str(err.value) == str(ref_err.value)


@pytest.fixture(scope="module")
def ragged_store(tmp_path_factory):
    """A store with a ragged int32 list column (0-6 ids a row), 40 rows in row groups of
    8, values from a numpy seed."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    rng = np.random.RandomState(4)
    hist = [rng.randint(0, 10**6, rng.randint(0, 7)).astype(np.int32) for _ in range(40)]
    root = tmp_path_factory.mktemp("torch_ragged")
    pq.write_table(pa.table({"id": np.arange(40, dtype=np.int64),
                             "hist": pa.array([h.tolist() for h in hist],
                                              pa.list_(pa.int32()))}),
                   str(root / "p.parquet"), row_group_size=8)
    return {"url": "file://" + str(root), "hist": hist}


def test_pad_shapes_through_the_loader_reach_the_device(ragged_store):
    """The padded column and its mask are ordinary device tensors equal to numpy's
    padding of the same rows, and to the reference loader's host batches."""
    reader = make_batch_reader(ragged_store["url"], reader_pool_type="dummy",
                               shuffle_row_groups=False)
    with DataLoader(reader, 16, device="cpu", last_batch="partial",
                    pad_shapes={"hist": (8,)}) as loader:
        batches = list(loader)
    ref_r = ref_reader.make_batch_reader(ragged_store["url"], reader_pool_type="dummy",
                                         shuffle_row_groups=False)
    with ref_loader.DataLoader(ref_r, 16, last_batch="partial", to_device=False,
                               pad_shapes={"hist": (8,)}) as loader:
        ref_batches = list(loader)
    assert len(batches) == len(ref_batches) == 3
    for b, rb in zip(batches, ref_batches):
        # ragged rows arrive as Python lists (as in the reference), so the padding is int64
        assert isinstance(b["hist"], torch.Tensor) and rb["hist"].dtype == np.int64
        assert b["hist"].dtype == torch.int64
        assert isinstance(b["hist__mask"], torch.Tensor) and b["hist__mask"].dtype == \
            torch.bool
        np.testing.assert_array_equal(b["hist"].numpy(), rb["hist"])
        np.testing.assert_array_equal(b["hist__mask"].numpy(), rb["hist__mask"])
        for row, rid in enumerate(b["id"].tolist()):
            h = ragged_store["hist"][rid]
            want = np.zeros(8, np.int64)
            want[:len(h)] = h
            np.testing.assert_array_equal(b["hist"][row].numpy(), want)
            assert b["hist__mask"][row].sum().item() == len(h)


def test_a_ragged_field_without_a_pad_shape_raises_the_references_error(ragged_store):
    reader = make_batch_reader(ragged_store["url"], reader_pool_type="dummy")
    with DataLoader(reader, 8, device="cpu") as loader:
        with pytest.raises(ValueError, match=r"holds ragged tensors .*pad_shapes=\{'hist'"):
            next(iter(loader))
