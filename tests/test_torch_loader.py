"""The slice as a whole: a JPEG store the reference wrote, read with decode_on_device=True,
through the reference's DataLoader (JAX, Pallas in interpret mode) and through the port's
DataLoader(device="cpu"). The uint8 images must be bit-identical and the labels equal;
the normalised float32 device_transform output within 1e-5."""
import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
torch = pytest.importorskip("torch")

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
