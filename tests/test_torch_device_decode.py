"""End-to-end device JPEG decode in the port: the JAX package's
``tests/test_device_decode.py`` case for case. The reader ships coefficient staging
payloads, the DataLoader finishes the decode on its device in one batched stage 2
(``stage2_planes`` then ``stage2_rgb``).

Comparison levels:

- bit-exact: every delivered pixel of the uniform store equals the JAX package's
  ``decode_jpeg_batch`` of the same staged rows (``ref_pixels``), and every case where the
  JAX case asserts equality (sharded against single, resize no-op, process pool against
  dummy, fallback rows) holds it in the port too;
- tolerance: the float device transform against the JAX loader's at f32 ``atol=1e-5``;
- contract: the device shuffle (torch's RNG) delivers each row once, out of plan order;
- the JAX cases' ``mean < 2.0`` / ``< 3.0`` bars against the host (cv2) decode and the
  device resize stay as they are (the resize is not bit-exact against
  ``jax.image.resize``).

The JAX cases' eight-device SPMD decode maps to the port's placement: one card a rank,
``sharding=`` over a torch ``DeviceMesh``, run here as a world of one (gloo), as
``test_torch_sharding.py`` runs it. The ``gpu`` cases hold the kernel path on the card
against the CPU path (bit for bit) and the plain versions on the same device
(``assert_card_matches_plain``): progressive streams, the host-fallback merge, odd and
mixed sizes with resize, and decode then K2 (K2 against its plain version on the same
uint8 batch, bit for bit).
"""
import logging

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
torch = pytest.importorskip("torch")

from _torch_card_helpers import (assert_card_matches_plain,  # noqa: E402,F401
                                 cuda_device, kernel_launches, launches_since,
                                 plain_kernels)
from _torch_pool_helpers import _no_leaked_shm_segments  # noqa: E402,F401
from test_device_decode import (_host_decoded, _mixed_size_store,  # noqa: E402,F401
                                hive_jpeg_dataset, jpeg_dataset)
from test_torch_sharding import one_rank  # noqa: E402,F401

import petastorm_tpu.loader as ref_loader  # noqa: E402
import petastorm_tpu.ops.jpeg as ref_jpeg  # noqa: E402
import petastorm_tpu.reader as ref_reader  # noqa: E402
from petastorm_tpu_torch import codecs as codecs_mod  # noqa: E402
from petastorm_tpu_torch import types as ptypes  # noqa: E402
from petastorm_tpu_torch.codecs import CompressedImageCodec, ScalarCodec  # noqa: E402
from petastorm_tpu_torch.loader import DataLoader, InMemDataLoader  # noqa: E402
from petastorm_tpu_torch.ngram import NGram  # noqa: E402
from petastorm_tpu_torch.ops import image as port_image  # noqa: E402
from petastorm_tpu_torch.ops import jpeg as port_jpeg  # noqa: E402
from petastorm_tpu_torch.ops.jpeg import JpegPlanes, decode_jpeg_batch  # noqa: E402
from petastorm_tpu_torch.reader import make_batch_reader, make_reader  # noqa: E402
from petastorm_tpu_torch.unischema import Unischema, UnischemaField  # noqa: E402

CPU = torch.device("cpu")

#: the store's JPEG field as the port declares it (``test_common.JpegSchema``'s)
PORT_FIELD = UnischemaField("image_jpeg", np.uint8, (32, 48, 3),
                            CompressedImageCodec("jpeg", quality=90), False)
PORT_SCHEMA = Unischema("JpegSchema", [
    UnischemaField("id", np.int64, (), ScalarCodec(ptypes.LongType()), False),
    PORT_FIELD,
    UnischemaField("label", np.int32, (), ScalarCodec(ptypes.IntegerType()), False),
])


@pytest.fixture(scope="module")
def ref_pixels(jpeg_dataset):
    """The JAX package's batched device decode of every row of the uniform store, by
    id: what every port delivery of that store must equal bit for bit."""
    with ref_reader.make_reader(jpeg_dataset.url, decode_on_device=True, num_epochs=1,
                                shuffle_row_groups=False,
                                reader_pool_type="dummy") as reader:
        rows = list(reader)
    out = _ref_codec_decode([row.image_jpeg for row in rows])
    return {int(row.id): out[i] for i, row in enumerate(rows)}


def _ref_codec_decode(staged):
    """The JAX codec's device decode of staged rows (``test_common.JpegSchema``'s
    field): the JAX package's ``decode_jpeg_batch`` in the codec's channel order."""
    from test_common import JpegSchema

    field = JpegSchema.fields["image_jpeg"]
    return np.asarray(field.codec.device_decode_batch(field, staged))


def _local(value):
    value = value.to_local() if hasattr(value, "to_local") else value
    if not isinstance(value, torch.Tensor):
        return np.asarray(value)
    if value.dtype == torch.bfloat16:  # numpy has no bfloat16: widen, exactly
        value = value.float()
    return value.cpu().numpy()


def _by_id(batches, field="image_jpeg"):
    out = {}
    for batch in batches:
        imgs = _local(batch[field])
        for i, rid in enumerate(_local(batch["id"])):
            out[int(rid)] = imgs[i]
    return out


def _assert_equal_by_id(got, want):
    assert sorted(got) == sorted(want)
    for rid, img in got.items():
        np.testing.assert_array_equal(img, want[rid], err_msg="id %d" % rid)


def _loader_pixels(url, batch_size=8, device=CPU, **kw):
    reader = make_batch_reader(url, decode_on_device=True, num_epochs=1,
                               shuffle_row_groups=False)
    with DataLoader(reader, batch_size=batch_size, device=device, **kw) as loader:
        return _by_id(list(loader))


def _smooth_image(seed):
    rng = np.random.RandomState(seed)
    img = np.kron(rng.randint(0, 256, (8, 12)).astype(np.float32),
                  np.ones((4, 4), np.float32))
    return np.stack([img, img, img], -1).astype(np.uint8)


def _progressive(img):
    ok, prog = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 90,
                                          cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    assert ok
    return prog.tobytes()


def test_make_reader_ships_staging_payloads(jpeg_dataset):
    with make_reader(jpeg_dataset.url, decode_on_device=True, num_epochs=1,
                     shuffle_row_groups=False) as reader:
        assert reader.device_decode_fields == frozenset({"image_jpeg"})
        row = next(iter(reader))
        assert isinstance(row.image_jpeg, JpegPlanes)
        assert row.image_jpeg.height == 32 and row.image_jpeg.width == 48
    # every row's planes are the JAX package's (its row group's kmax included)
    ours, theirs = _planes(jpeg_dataset.url, 24), _ref_planes(jpeg_dataset.url, 24)
    for a, b in zip(ours, theirs):
        assert (a.height, a.width, a.kmax) == (b.height, b.width, b.kmax)
        for ca, cb in zip(a.components, b.components):
            np.testing.assert_array_equal(np.asarray(ca.blocks), np.asarray(cb.blocks))
            np.testing.assert_array_equal(np.asarray(ca.qtable), np.asarray(cb.qtable))


def test_loader_device_decode_per_row_path(jpeg_dataset, ref_pixels):
    expected = _host_decoded(jpeg_dataset)
    reader = make_reader(jpeg_dataset.url, decode_on_device=True, num_epochs=1,
                         shuffle_row_groups=False)
    batches = []
    with DataLoader(reader, batch_size=6, device=CPU) as loader:
        for batch in loader:
            imgs = _local(batch["image_jpeg"])
            assert imgs.dtype == np.uint8 and imgs.shape == (6, 32, 48, 3)
            for i, rid in enumerate(_local(batch["id"])):
                ref = expected[int(rid)]
                diff = np.abs(imgs[i].astype(int) - ref.astype(int))
                assert diff.mean() < 2.0 and np.percentile(diff, 99) <= 12
            batches.append(batch)
    got = _by_id(batches)
    assert len(got) == 24
    _assert_equal_by_id(got, ref_pixels)


def test_loader_device_decode_batch_path(jpeg_dataset, ref_pixels):
    expected = _host_decoded(jpeg_dataset)
    got = _loader_pixels(jpeg_dataset.url)
    assert len(got) == 24
    for rid, img in got.items():
        assert img.shape == (32, 48, 3)
        assert np.abs(img.astype(int) - expected[rid].astype(int)).mean() < 2.0
    _assert_equal_by_id(got, ref_pixels)


def _world_sharding():
    from petastorm_tpu_torch.parallel.mesh import batch_sharding, make_mesh

    return batch_sharding(make_mesh(device_type="cpu"))


def test_device_decode_sharded_batches(jpeg_dataset, ref_pixels, one_rank):
    """The JAX case's 8-device batch sharding is the port's DeviceMesh placement: in a
    world of one the decoded batch is a DTensor sharded on the batch axis whose local
    rows are the JAX package's pixels."""
    from torch.distributed.tensor import DTensor

    sharding = _world_sharding()
    reader = make_batch_reader(jpeg_dataset.url, decode_on_device=True, num_epochs=1,
                               shuffle_row_groups=False)
    with DataLoader(reader, batch_size=8, sharding=sharding, device=CPU) as loader:
        batch = next(iter(loader))
        img = batch["image_jpeg"]
        assert isinstance(img, DTensor) and tuple(img.shape) == (8, 32, 48, 3)
        assert [repr(p) for p in img.placements] == ["Shard(dim=0)"]
        got = _by_id([batch])
    for rid, px in got.items():
        np.testing.assert_array_equal(px, ref_pixels[rid])


def _planes(url, n):
    """The first ``n`` staged rows in plan order (dummy pool)."""
    with make_reader(url, decode_on_device=True, num_epochs=1, shuffle_row_groups=False,
                     reader_pool_type="dummy") as reader:
        return [row.image_jpeg for row in reader][:n]


def test_spmd_decode_shards_across_devices(jpeg_dataset, ref_pixels):
    """The JAX case splits one decode across eight devices and checks each shard equals
    an independent decode of its own slice. The port decodes each rank's rows on the
    rank's card: every 2-row slice's decode equals the same rows of the whole batch's
    decode and the JAX package's, so where the rows are decoded changes no pixel."""
    planes = _planes(jpeg_dataset.url, 16)
    single = decode_jpeg_batch(planes, device=CPU).numpy()
    assert single.shape == (16, 32, 48, 3)
    ref = np.asarray(ref_jpeg.decode_jpeg_batch(_ref_planes(jpeg_dataset.url, 16)))
    np.testing.assert_array_equal(single, ref)
    for lo in range(0, 16, 2):
        per_slice = decode_jpeg_batch(planes[lo:lo + 2], device=CPU).numpy()
        np.testing.assert_array_equal(per_slice, single[lo:lo + 2])


def _ref_planes(url, n):
    with ref_reader.make_reader(url, decode_on_device=True, num_epochs=1,
                                shuffle_row_groups=False,
                                reader_pool_type="dummy") as reader:
        return [row.image_jpeg for row in reader][:n]


def test_spmd_decode_indivisible_batch_falls_back(jpeg_dataset):
    """A batch that does not divide the JAX mesh decodes single-device there; the port
    decodes every batch on the rank's card. Six rows decode to the JAX package's
    single-device pixels."""
    out = decode_jpeg_batch(_planes(jpeg_dataset.url, 6), device=CPU).numpy()
    np.testing.assert_array_equal(
        out, np.asarray(ref_jpeg.decode_jpeg_batch(_ref_planes(jpeg_dataset.url, 6))))


def _spy_decode(monkeypatch, record):
    orig = codecs_mod.CompressedImageCodec.device_decode_batch

    def spy(self, field, staged, device, stager=None, resize_to=None):
        record.append((len(staged), device))
        return orig(self, field, staged, device, stager=stager, resize_to=resize_to)

    monkeypatch.setattr(codecs_mod.CompressedImageCodec, "device_decode_batch", spy)


def test_loader_spmd_decode_output_presharded(jpeg_dataset, monkeypatch, one_rank):
    """Through the DataLoader the decode runs on the rank's device over the rank's
    rows (no decode elsewhere then a move), and the consumer gets the sharded batch."""
    calls = []
    _spy_decode(monkeypatch, calls)
    reader = make_batch_reader(jpeg_dataset.url, decode_on_device=True, num_epochs=1,
                               shuffle_row_groups=False)
    with DataLoader(reader, batch_size=8, sharding=_world_sharding(),
                    device=CPU) as loader:
        batch = next(iter(loader))
        assert len(batch["image_jpeg"].device_mesh.mesh.flatten()) == 1
        assert loader.local_batch_size == 8
    assert calls and all(n == 8 and dev == CPU for n, dev in calls)


def test_sharded_loader_with_presharding_codec_signature(jpeg_dataset, monkeypatch,
                                                         one_rank):
    """A codec subclass whose ``device_decode_batch`` has no ``sharding`` keyword (the
    JAX loader inspects the signature for one) works under a sharded port loader: the
    port never passes a sharding to the codec, and counts no unsharded decode."""
    calls = []
    orig = codecs_mod.CompressedImageCodec.device_decode_batch

    def legacy_sig(self, field, staged, device, stager=None, resize_to=None):
        calls.append(resize_to)
        return orig(self, field, staged, device, stager=stager, resize_to=resize_to)

    monkeypatch.setattr(codecs_mod.CompressedImageCodec, "device_decode_batch",
                        legacy_sig)
    reader = make_batch_reader(jpeg_dataset.url, decode_on_device=True, num_epochs=1,
                               shuffle_row_groups=False)
    with DataLoader(reader, batch_size=8, sharding=_world_sharding(),
                    device=CPU) as loader:
        batch = next(iter(loader))
        assert tuple(batch["image_jpeg"].shape) == (8, 32, 48, 3)
        assert loader.stats.decode_unsharded_batches == 0
        assert "decode_unsharded_batches" in loader.stats.snapshot()
    assert calls


def test_decode_unsharded_fallback_counter_and_warning(jpeg_dataset, caplog, one_rank):
    """The JAX loader counts and warns once where a batch sharding's decode ran on one
    device. With one card a rank the port's decode always runs on the rank's card: a
    sharded loader over every batch counts 0 and logs no such warning."""
    reader = make_batch_reader(jpeg_dataset.url, decode_on_device=True, num_epochs=1,
                               shuffle_row_groups=False)
    loader = DataLoader(reader, batch_size=6, sharding=_world_sharding(), device=CPU)
    with caplog.at_level(logging.WARNING, logger="petastorm_tpu_torch.obs"):
        with loader:
            assert sum(1 for _ in loader) == 4
    assert loader.stats.decode_unsharded_batches == 0
    assert not [r for r in caplog.records if "SINGLE device" in r.getMessage()]


def test_device_decode_then_device_transform(jpeg_dataset):
    """A float device transform after the decode: values in [0, 1], equal to the JAX
    loader's same transform within f32 ``atol=1e-5``."""
    import jax.numpy as jnp

    def normalize(batch):
        out = dict(batch)
        out["image_jpeg"] = batch["image_jpeg"].to(torch.float32) / 255.0
        return out

    def ref_normalize(batch):
        out = dict(batch)
        out["image_jpeg"] = batch["image_jpeg"].astype(jnp.float32) / 255.0
        return out

    got = _loader_pixels(jpeg_dataset.url, device_transform=normalize)
    assert {img.dtype for img in got.values()} == {np.dtype(np.float32)}
    assert all(0.0 <= img.min() and img.max() <= 1.0 for img in got.values())
    reader = ref_reader.make_batch_reader(jpeg_dataset.url, decode_on_device=True,
                                          num_epochs=1, shuffle_row_groups=False)
    with ref_loader.DataLoader(reader, batch_size=8, device_transform=ref_normalize) as ld:
        theirs = _by_id(list(ld))
    assert sorted(got) == sorted(theirs)
    for rid, img in got.items():
        np.testing.assert_allclose(img, theirs[rid], rtol=0, atol=1e-5)


def _k2(batch):
    """K2 on the decoded batch, with the plain version's output and the uint8 input
    beside it for the comparison."""
    out = dict(batch)
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    out["image_jpeg"] = port_image.normalize_images(batch["image_jpeg"], mean, std)
    out["k2_plain"] = port_image._normalize_plain(batch["image_jpeg"], mean, std,
                                                  torch.bfloat16)
    out["u8"] = batch["image_jpeg"]
    return out


@pytest.mark.gpu
def test_device_decode_then_k2_on_the_card(jpeg_dataset, ref_pixels, cuda_device):
    """Decode then K2 on the card: the stage-2 kernels and K2 launch; the decoded uint8
    rows are the CPU path's (the JAX package's pixels) and K2's bf16 batch its plain
    version's on the same rows, bit for bit."""
    before = kernel_launches()
    reader = make_batch_reader(jpeg_dataset.url, decode_on_device=True, num_epochs=1,
                               shuffle_row_groups=False)
    with DataLoader(reader, batch_size=8, device=cuda_device, device_transform=_k2) as ld:
        batches = list(ld)
    launched = launches_since(before)
    assert launched["stage2_planes"] >= 3 and launched["stage2_rgb"] >= 3, launched
    assert launched["normalize"] == 3, launched
    for b in batches:
        assert b["image_jpeg"].dtype == torch.bfloat16
        assert torch.equal(b["image_jpeg"], b["k2_plain"])
    _assert_equal_by_id(_by_id(batches, "u8"), ref_pixels)


def test_decode_on_device_rejects_ngram(jpeg_dataset):
    fields = {0: ["id", "image_jpeg"], 1: ["id"]}
    ngram = NGram(fields=fields, delta_threshold=10, timestamp_field="id")
    with pytest.raises(ValueError, match="NGram") as ours:
        make_reader(jpeg_dataset.url, schema_fields=ngram, decode_on_device=True)
    import petastorm_tpu.ngram as ref_ngram

    ref_ng = ref_ngram.NGram(fields=fields, delta_threshold=10, timestamp_field="id")
    with pytest.raises(ValueError, match="NGram") as theirs:
        ref_reader.make_reader(jpeg_dataset.url, schema_fields=ref_ng,
                               decode_on_device=True)
    assert str(ours.value) == str(theirs.value)


def test_decode_on_device_noop_without_jpeg_fields(jpeg_dataset):
    with make_reader(jpeg_dataset.url, schema_fields=["id", "label"],
                     decode_on_device=True, num_epochs=1) as reader:
        assert reader.device_decode_fields == frozenset()
        row = next(iter(reader))
        assert isinstance(row.id, np.int64)


def test_progressive_decodes_through_device_stage():
    """Progressive JPEG rides the two-stage path natively: host_stage_decode yields
    planes, the batched device stage agrees with the full-host decode within lossy
    tolerance, and the pixels are the JAX codec's."""
    codec = PORT_FIELD.codec
    img = _smooth_image(9)
    baseline = bytes(codec.encode(PORT_FIELD, img))
    prog = _progressive(img)
    staged = [codec.host_stage_decode(PORT_FIELD, baseline),
              codec.host_stage_decode(PORT_FIELD, prog),
              codec.host_stage_decode(PORT_FIELD, baseline)]
    from petastorm_tpu_torch.ops import native
    if native.native_available():
        assert isinstance(staged[1], JpegPlanes)
    out = codec.device_decode_batch(PORT_FIELD, staged, CPU).numpy()
    assert out.shape == (3, 32, 48, 3)
    np.testing.assert_array_equal(out[0], out[2])
    ref = codec.decode(PORT_FIELD, prog)
    assert np.abs(out[1].astype(int) - ref.astype(int)).mean() < 3.0
    np.testing.assert_array_equal(out, _ref_device_decode([baseline, prog, baseline]))


def _ref_device_decode(blobs):
    """The JAX codec's staged decode of ``blobs`` (``test_common.JpegSchema``'s field)."""
    from test_common import JpegSchema

    field = JpegSchema.fields["image_jpeg"]
    return _ref_codec_decode([field.codec.host_stage_decode(field, b) for b in blobs])


@pytest.mark.gpu
def test_progressive_decodes_through_device_stage_on_the_card(cuda_device):
    """Baseline and progressive streams in one batch on the card: the stage-2 kernels
    launch, and the pixels equal the CPU path and the plain versions on the card."""
    codec = PORT_FIELD.codec
    img = _smooth_image(9)
    baseline = bytes(codec.encode(PORT_FIELD, img))
    staged = [codec.host_stage_decode(PORT_FIELD, b)
              for b in (baseline, _progressive(img), baseline)]
    before = kernel_launches()
    on_card = codec.device_decode_batch(PORT_FIELD, staged, cuda_device).cpu()
    launched = launches_since(before)
    assert launched["stage2_planes"] >= 1 and launched["stage2_rgb"] >= 1, launched
    with plain_kernels():
        plain = codec.device_decode_batch(PORT_FIELD, staged, cuda_device).cpu()
    assert torch.equal(on_card, codec.device_decode_batch(PORT_FIELD, staged, CPU))
    assert_card_matches_plain(on_card, plain)


def _fallback_batch(seed=10):
    codec = PORT_FIELD.codec
    baseline = bytes(codec.encode(PORT_FIELD, _smooth_image(seed)))
    planes = codec.host_stage_decode(PORT_FIELD, baseline)
    fallback = codec.decode(PORT_FIELD, baseline)  # ndarray staged row (host fallback)
    return [planes, fallback, planes], baseline


def test_host_fallback_rows_merge_back_in_order():
    """device_decode_batch merges host-decoded fallback rows back at their original
    positions, as the JAX codec does."""
    codec = PORT_FIELD.codec
    staged, baseline = _fallback_batch()
    out = codec.device_decode_batch(PORT_FIELD, staged, CPU).numpy()
    assert out.shape == (3, 32, 48, 3)
    np.testing.assert_array_equal(out[0], out[2])
    assert np.abs(out[1].astype(int) - out[0].astype(int)).mean() < 3.0
    np.testing.assert_array_equal(out[1], staged[1])  # the fallback row, untouched
    from test_common import JpegSchema

    field = JpegSchema.fields["image_jpeg"]
    ref_staged = [field.codec.host_stage_decode(field, baseline), staged[1],
                  field.codec.host_stage_decode(field, baseline)]
    np.testing.assert_array_equal(
        out, np.asarray(field.codec.device_decode_batch(field, ref_staged)))


@pytest.mark.gpu
def test_host_fallback_rows_merge_back_in_order_on_the_card(cuda_device):
    """The merge on the card: device rows through the stage-2 kernels, the fallback row
    in place; equal to the CPU path and the plain versions on the card."""
    codec = PORT_FIELD.codec
    staged, _ = _fallback_batch()
    before = kernel_launches()
    on_card = codec.device_decode_batch(PORT_FIELD, staged, cuda_device).cpu()
    launched = launches_since(before)
    assert launched["stage2_planes"] == 1 and launched["stage2_rgb"] == 1, launched
    with plain_kernels():
        plain = codec.device_decode_batch(PORT_FIELD, staged, cuda_device).cpu()
    assert torch.equal(on_card, codec.device_decode_batch(PORT_FIELD, staged, CPU))
    assert_card_matches_plain(on_card, plain)


def test_to_device_false_still_delivers_decoded_images(jpeg_dataset, ref_pixels):
    expected = _host_decoded(jpeg_dataset)
    reader = make_batch_reader(jpeg_dataset.url, decode_on_device=True, num_epochs=1,
                               shuffle_row_groups=False)
    with DataLoader(reader, batch_size=8, to_device=False, device=CPU) as loader:
        batch = next(iter(loader))
        assert isinstance(batch["image_jpeg"], np.ndarray)
        assert batch["image_jpeg"].dtype == np.uint8
        assert batch["image_jpeg"].shape == (8, 32, 48, 3)
        ref = expected[int(batch["id"][0])]
        assert np.abs(batch["image_jpeg"][0].astype(int) - ref.astype(int)).mean() < 2.0
        for rid, img in _by_id([batch]).items():
            np.testing.assert_array_equal(img, ref_pixels[rid])


def test_decode_on_device_rejects_host_transform(jpeg_dataset):
    from petastorm_tpu.transform import TransformSpec as RefTransformSpec
    from petastorm_tpu_torch.transform import TransformSpec

    with pytest.raises(ValueError, match="host transform_spec") as ours:
        make_reader(jpeg_dataset.url, decode_on_device=True,
                    transform_spec=TransformSpec(func=lambda r: r))
    with pytest.raises(ValueError, match="host transform_spec") as theirs:
        ref_reader.make_reader(jpeg_dataset.url, decode_on_device=True,
                               transform_spec=RefTransformSpec(func=lambda r: r))
    assert str(ours.value) == str(theirs.value)


def test_native_rejects_corrupt_category_codes():
    """Corrupt DHT streams (DC category > 11) must raise, not hit UB, in the port's
    decoder as in the JAX package's."""
    from petastorm_tpu.ops import native as ref_native
    from petastorm_tpu_torch.ops import native

    if not native.native_available():
        pytest.skip("native toolchain unavailable: %s" % native.native_error())
    rng = np.random.RandomState(10)
    ok, enc = cv2.imencode(".jpg", rng.randint(0, 256, (16, 16, 3), dtype=np.uint8),
                           [cv2.IMWRITE_JPEG_QUALITY, 90])
    data = bytearray(enc.tobytes())
    # poison EVERY symbol of the DC DHT (FFC4, tc=0) to 200 (> max category 11)
    i = data.find(b"\xff\xc4")
    assert i > 0 and data[i + 4] >> 4 == 0
    total = sum(data[i + 5:i + 21])
    for j in range(total):
        data[i + 21 + j] = 200
    with pytest.raises(ValueError) as ours:
        native.jpeg_decode_coeffs_native(bytes(data))
    with pytest.raises(ValueError) as theirs:
        ref_native.jpeg_decode_coeffs_native(bytes(data))
    assert str(ours.value) == str(theirs.value)


def test_cache_key_distinguishes_device_payloads():
    from petastorm_tpu.reader import _cache_key as ref_cache_key
    from petastorm_tpu_torch.reader import _cache_key

    class Piece:
        path = "/p"
        row_group = 0

    host = _cache_key(Piece, PORT_SCHEMA, None, None, 0, 1, None)
    dev = _cache_key(Piece, PORT_SCHEMA, None, None, 0, 1, None, frozenset({"image_jpeg"}))
    assert host != dev
    from test_common import JpegSchema

    assert host == ref_cache_key(Piece, JpegSchema, None, None, 0, 1, None)
    assert dev == ref_cache_key(Piece, JpegSchema, None, None, 0, 1, None,
                                frozenset({"image_jpeg"}))
    # the workers add their payload kind (ROADMAP Queue 3 AB): still distinct
    assert _cache_key(Piece, PORT_SCHEMA, None, None, 0, 1, None, kind="rows") != \
        _cache_key(Piece, PORT_SCHEMA, None, None, 0, 1, None, frozenset({"image_jpeg"}),
                   kind="rows")


def test_per_row_path_mixed_staged_and_fallback_rows(jpeg_dataset):
    """Per-row readers interleave JpegPlanes staging payloads with host-fallback
    ndarrays (progressive streams where the native stage refuses them); the loader's
    column packing keeps object dtype so batching survives the mix."""
    codec = PORT_FIELD.codec
    img = _smooth_image(12)
    baseline = bytes(codec.encode(PORT_FIELD, img))
    prog = _progressive(img)

    class FakeRow:
        def __init__(self, i, payload):
            self._d = {"id": np.int64(i), "image_jpeg": payload}

        def _asdict(self):
            return dict(self._d)

    class FakeReader:
        is_batched_reader = False
        device_decode_fields = frozenset({"image_jpeg"})
        schema = PORT_SCHEMA
        transform_spec = None

        def __iter__(self):
            for i in range(8):
                enc = prog if i % 3 == 1 else baseline
                staged = codec.host_stage_decode(PORT_FIELD, enc)
                if i % 3 == 1:  # the host fallback's ndarray beside planes
                    staged = codec.decode(PORT_FIELD, enc)
                yield FakeRow(i, staged)

        def stop(self):
            pass

        def join(self):
            pass

    with DataLoader(FakeReader(), batch_size=4, device=CPU) as loader:
        batches = list(loader)
    assert len(batches) == 2
    ref = codec.decode(PORT_FIELD, baseline)
    for b in batches:
        imgs = _local(b["image_jpeg"])
        assert imgs.shape == (4, 32, 48, 3)
        for row in imgs:
            assert np.abs(row.astype(int) - ref.astype(int)).mean() < 3.0


def test_process_pool_spmd_decode_sharded(jpeg_dataset, ref_pixels, one_rank):
    """Process pool x batch sharding: staged payloads cross the wire, the decode runs
    on the rank's device, and the delivered rows equal the dummy-pool unsharded path
    and the JAX package's pixels bit for bit."""
    def collect(pool, sharding):
        reader = make_batch_reader(jpeg_dataset.url, decode_on_device=True,
                                   num_epochs=1, shuffle_row_groups=False,
                                   reader_pool_type=pool, workers_count=2)
        with DataLoader(reader, batch_size=8, sharding=sharding, device=CPU) as loader:
            batches = list(loader)
        if sharding is not None:
            assert all(hasattr(b["image_jpeg"], "to_local") for b in batches)
        return _by_id(batches)

    got = collect("process", _world_sharding())
    ref = collect("dummy", None)
    assert sorted(got) == sorted(ref) == list(range(24))
    _assert_equal_by_id(got, ref)
    _assert_equal_by_id(got, ref_pixels)


def test_process_pool_device_decode_wire(tmp_path):
    """decode_on_device over the process pool: staged payloads cross the wire and the
    finished images match the host-decode path, and the JAX package's device decode of
    the same store bit for bit."""
    from petastorm_tpu_torch.metadata import write_dataset

    rng = np.random.RandomState(0)
    schema = Unischema("S", [
        UnischemaField("id", np.int64, (), ScalarCodec(ptypes.LongType()), False),
        UnischemaField("image", np.uint8, (24, 24, 3),
                       CompressedImageCodec("jpeg", 92), False),
    ])
    url = "file://" + str(tmp_path / "ds")
    write_dataset(url, schema,
                  ({"id": i, "image": rng.randint(0, 256, (24, 24, 3), dtype=np.uint8)}
                   for i in range(12)), rows_per_file=12)

    def collect(factory, loader_cls, **kwargs):
        reader = factory(url, num_epochs=1, **kwargs)
        extra = {"device": CPU} if loader_cls is DataLoader else {}
        with loader_cls(reader, 4, to_device=False, last_batch="partial", **extra) as ld:
            return _by_id(list(ld), "image")

    got = collect(make_batch_reader, DataLoader, reader_pool_type="process",
                  workers_count=2, decode_on_device=True)
    ref = collect(make_batch_reader, DataLoader)
    assert len(got) == 12
    worst = max(np.abs(got[i].astype(int) - ref[i].astype(int)).mean()
                for i in range(12))
    assert worst < 2.5, worst
    theirs = collect(ref_reader.make_batch_reader, ref_loader.DataLoader,
                     reader_pool_type="dummy", decode_on_device=True)
    _assert_equal_by_id(got, theirs)


def test_inmem_loader_over_device_decode_reader(jpeg_dataset, ref_pixels):
    """InMemDataLoader fills through the staged decode path: the resident store holds
    DECODED images (the JAX package's pixels) and epochs serve them without
    re-decoding."""
    expected = _host_decoded(jpeg_dataset)
    reader = make_batch_reader(jpeg_dataset.url, decode_on_device=True, num_epochs=1,
                               shuffle_row_groups=False)
    with InMemDataLoader(reader, batch_size=8, num_epochs=2, seed=5, device=CPU) as loader:
        seen = 0
        for batch in loader:
            imgs = _local(batch["image_jpeg"])
            ids = _local(batch["id"])
            assert imgs.dtype == np.uint8 and imgs.shape[1:] == (32, 48, 3)
            for i, rid in enumerate(ids):
                ref = expected[int(rid)]
                assert np.abs(imgs[i].astype(int) - ref.astype(int)).mean() < 2.0
                np.testing.assert_array_equal(imgs[i], ref_pixels[int(rid)])
                seen += 1
        assert seen == 48  # 24 rows x 2 epochs (drop policy, 24 % 8 == 0)


def test_device_decode_composes_with_hive_pruning(hive_jpeg_dataset):
    """Partition-filter pruning + partition-column materialisation + two-stage device
    decode in ONE reader; the same row groups as the JAX reader, the same pixels."""
    reader = make_batch_reader(hive_jpeg_dataset["url"], decode_on_device=True,
                               filters=[("split", "=", "val")], num_epochs=1,
                               shuffle_row_groups=False)
    assert reader._num_items == 2  # one file x 2 row groups survives pruning
    scheduled = [(p.path, p.row_group) for p, _ in reader._plan._items]
    field = hive_jpeg_dataset["field"]
    expected = {r["id"]: field.codec.decode(field, field.codec.encode(field, r["image_jpeg"]))
                for r in hive_jpeg_dataset["rows"] if r["split"] == "val"}
    batches = []
    with DataLoader(reader, batch_size=4, last_batch="partial", device=CPU) as loader:
        for batch in loader:
            assert all(s == "val" for s in np.asarray(batch["split"]))
            batches.append(batch)
    seen = _by_id(batches)
    assert set(seen) == set(expected)
    for rid, img in seen.items():
        assert np.abs(img.astype(int) - expected[rid].astype(int)).mean() < 2.0
    ref = ref_reader.make_batch_reader(hive_jpeg_dataset["url"], decode_on_device=True,
                                       filters=[("split", "=", "val")], num_epochs=1,
                                       shuffle_row_groups=False)
    assert [(p.path, p.row_group) for p, _ in ref._plan._items] == scheduled
    with ref_loader.DataLoader(ref, batch_size=4, last_batch="partial") as loader:
        _assert_equal_by_id(seen, _by_id(list(loader)))


def test_device_decode_checkpoint_resume(jpeg_dataset, ref_pixels):
    """state_dict/load_state_dict across a staged-decode reader: the resumed read
    completes the epoch with decodable payloads and no row lost or replayed; the
    state is the JAX package's after the same rows."""
    expected = _host_decoded(jpeg_dataset)

    def head_state(factory):
        with factory(jpeg_dataset.url, decode_on_device=True, num_epochs=1,
                     shuffle_row_groups=False, reader_pool_type="dummy") as reader:
            it = iter(reader)
            head = [int(next(it).id) for _ in range(8)]  # one full row group
            return head, reader.state_dict()

    head_ids, state = head_state(make_reader)
    assert (head_ids, state) == head_state(ref_reader.make_reader)

    with make_reader(jpeg_dataset.url, decode_on_device=True, num_epochs=1,
                     shuffle_row_groups=False, reader_pool_type="dummy") as reader2:
        reader2.load_state_dict(state)
        with DataLoader(reader2, batch_size=4, last_batch="partial", device=CPU) as ld:
            seen = _by_id(list(ld))
    assert sorted(head_ids + list(seen)) == list(range(24))
    for rid, img in seen.items():
        assert np.abs(img.astype(int) - expected[rid].astype(int)).mean() < 2.0
        np.testing.assert_array_equal(img, ref_pixels[rid])


def test_device_decode_composes_with_device_shuffle(jpeg_dataset, ref_pixels):
    """decode_on_device + device_shuffle_capacity in one loader: every row once per
    epoch, images correct (the JAX package's pixels), order decorrelated from the plan
    (contract level: torch's RNG draws the order)."""
    expected = _host_decoded(jpeg_dataset)
    reader = make_batch_reader(jpeg_dataset.url, decode_on_device=True, num_epochs=1,
                               shuffle_row_groups=False)
    order = []
    batches = []
    with DataLoader(reader, batch_size=4, device_shuffle_capacity=12, seed=13,
                    device=CPU) as loader:
        for batch in loader:
            batches.append(batch)
            order.extend(int(r) for r in _local(batch["id"]))
    assert sorted(order) == list(range(24))  # exactly once through the ring
    assert order != sorted(order)  # and not plan order
    seen = _by_id(batches)
    for rid, img in seen.items():
        assert np.abs(img.astype(int) - expected[rid].astype(int)).mean() < 2.0
        np.testing.assert_array_equal(img, ref_pixels[rid])


# --------------------------------------------------- mixed-size stores (device resize)


def test_mixed_sizes_without_resize_raise(tmp_path):
    url, _, _ = _mixed_size_store(tmp_path, [(32, 48), (64, 40), (32, 48)])
    reader = make_batch_reader(url, decode_on_device=True, num_epochs=1,
                               shuffle_row_groups=False)
    with pytest.raises(ValueError, match="device_decode_resize"):
        with DataLoader(reader, batch_size=3, last_batch="partial", device=CPU) as loader:
            list(loader)


MIXED_SIZES = [(32, 48), (64, 40), (48, 48), (32, 48), (80, 56), (24, 24), (40, 40),
               (56, 32)]


def test_mixed_sizes_resize_composes_with_spmd_sharding(tmp_path, one_rank):
    """Batch sharding x device_decode_resize: a mixed-size store delivers one static
    shape, sharded, equal to the unsharded path."""
    url, _, _ = _mixed_size_store(tmp_path, MIXED_SIZES)

    def collect(sharding):
        reader = make_batch_reader(url, decode_on_device=True, num_epochs=1,
                                   shuffle_row_groups=False)
        with DataLoader(reader, batch_size=8, sharding=sharding,
                        device_decode_resize=(32, 32), device=CPU) as loader:
            batches = list(loader)
        for b in batches:
            assert tuple(b["image_jpeg"].shape[1:]) == (32, 32, 3)
            if sharding is not None:
                assert hasattr(b["image_jpeg"], "to_local")
        return _by_id(batches)

    sharded, single = collect(_world_sharding()), collect(None)
    assert sorted(sharded) == sorted(single) == list(range(len(MIXED_SIZES)))
    _assert_equal_by_id(sharded, single)


def _resized_reference(field, img, target):
    stored = field.codec.decode(field, field.codec.encode(field, img))
    if stored.shape[:2] == tuple(target):
        return stored
    return cv2.resize(stored, (target[1], target[0]), interpolation=cv2.INTER_LINEAR)


def test_mixed_sizes_device_resize(tmp_path):
    """Mixed-size store rides the device path with one static output shape; values
    track cv2 decode + cv2.resize INTER_LINEAR."""
    sizes = MIXED_SIZES[:6]
    url, imgs, field = _mixed_size_store(tmp_path, sizes)
    target = (32, 32)
    got = _loader_pixels(url, batch_size=3, last_batch="partial",
                         device_decode_resize=target)
    assert len(got) == len(sizes)
    for rid in range(len(sizes)):
        assert got[rid].shape == (32, 32, 3) and got[rid].dtype == np.uint8
        diff = np.abs(got[rid].astype(int) - _resized_reference(field, imgs[rid],
                                                                target).astype(int))
        assert diff.mean() < 3.0, (rid, diff.mean())


#: odd sizes (not multiples of the 16-pixel MCU) beside even ones, for the card
ODD_SIZES = [(33, 47), (64, 40), (17, 25), (48, 48), (81, 55), (24, 24)]


@pytest.mark.gpu
@pytest.mark.parametrize("sizes", [MIXED_SIZES, ODD_SIZES], ids=["mixed", "odd"])
def test_mixed_and_odd_sizes_with_resize_on_the_card(tmp_path, cuda_device, sizes):
    """Mixed and odd sizes with ``device_decode_resize`` on the card: every layout
    group's stage 2 launches the kernels, and the resized batches equal the CPU path
    bit for bit and the plain versions on the card."""
    url, _, _ = _mixed_size_store(tmp_path, sizes)
    kw = dict(batch_size=3, last_batch="partial", device_decode_resize=(32, 32))
    before = kernel_launches()
    got = _loader_pixels(url, device=cuda_device, **kw)
    launched = launches_since(before)
    assert launched["stage2_planes"] >= 2 and launched["stage2_rgb"] >= 2, launched
    with plain_kernels():
        plain = _loader_pixels(url, device=cuda_device, **kw)
    cpu = _loader_pixels(url, **kw)
    assert sorted(got) == sorted(plain) == list(range(len(sizes)))
    _assert_equal_by_id(got, cpu)
    for rid in got:
        assert_card_matches_plain(torch.from_numpy(got[rid]), torch.from_numpy(plain[rid]))


def test_uniform_store_resize_noop_bitexact(jpeg_dataset, ref_pixels):
    """resize target == stored size must not perturb output: bit-equal to the
    no-resize device path and to the JAX package's pixels."""
    with_resize = _loader_pixels(jpeg_dataset.url, device_decode_resize=(32, 48))
    plain = _loader_pixels(jpeg_dataset.url)
    _assert_equal_by_id(with_resize, plain)
    _assert_equal_by_id(plain, ref_pixels)


def test_mixed_sizes_host_fallback_rows_resized(tmp_path, monkeypatch):
    """Rows the native stage rejects (host cv2 fallback) resize on host and merge at
    their positions alongside device-resized rows."""
    url, imgs, field = _mixed_size_store(tmp_path, [(32, 48), (64, 40), (48, 32)])
    real = port_jpeg.entropy_decode_jpeg_batch

    def partial_batch(blobs):
        out = real(blobs)
        if len(out) > 1:
            out[1] = None  # force one row down the host fallback path
        return out

    def refuse_fast(data):
        raise ValueError("forced: no native per-image decode either")

    # batch rejects row 1 AND the per-image native path refuses -> a genuine
    # cv2-decoded ndarray lands in the staged column next to JpegPlanes rows
    monkeypatch.setattr(port_jpeg, "entropy_decode_jpeg_batch", partial_batch)
    monkeypatch.setattr(port_jpeg, "entropy_decode_jpeg_fast", refuse_fast)
    got = _loader_pixels(url, batch_size=3, device_decode_resize=(32, 32))
    assert sorted(got) == [0, 1, 2]
    for i in range(3):
        assert got[i].shape == (32, 32, 3)
        ref = _resized_reference(field, imgs[i], (32, 32))
        assert np.abs(got[i].astype(int) - ref.astype(int)).mean() < 3.0, i


def test_device_decode_resize_validated_at_construction(jpeg_dataset):
    reader = make_batch_reader(jpeg_dataset.url, decode_on_device=True, num_epochs=1)
    ref = ref_reader.make_batch_reader(jpeg_dataset.url, decode_on_device=True,
                                       num_epochs=1)
    try:
        for bad, match in (({"imaeg_jpeg": (32, 32)}, "image_jpeg"),  # misspelled
                           (32, "pair"), ((0, 32), "positive")):
            with pytest.raises(ValueError, match=match) as ours:
                DataLoader(reader, batch_size=4, device_decode_resize=bad, device=CPU)
            with pytest.raises(ValueError, match=match) as theirs:
                ref_loader.DataLoader(ref, batch_size=4, device_decode_resize=bad)
            assert str(ours.value) == str(theirs.value)
    finally:
        for r in (reader, ref):
            r.stop()
            r.join()


def test_device_decode_resize_requires_decode_fields(jpeg_dataset):
    """A resize target against a reader with no device-decoded fields must fail at
    construction, not silently no-op."""
    reader = make_batch_reader(jpeg_dataset.url, num_epochs=1)  # host decode
    try:
        with pytest.raises(ValueError, match="decode_on_device"):
            DataLoader(reader, batch_size=4, device_decode_resize=(32, 32), device=CPU)
    finally:
        reader.stop()
        reader.join()


def test_inmem_loader_mixed_sizes_with_resize(tmp_path):
    """InMemDataLoader fills a mixed-size store through the staged decode + resize:
    the resident store holds one static shape, epochs serve it directly."""
    sizes = [(32, 48), (64, 40), (48, 48), (24, 24)] * 2
    url, _, _ = _mixed_size_store(tmp_path, sizes)
    reader = make_batch_reader(url, decode_on_device=True, num_epochs=1,
                               shuffle_row_groups=False)
    with InMemDataLoader(reader, batch_size=4, num_epochs=2, seed=7,
                         device_decode_resize=(32, 32), device=CPU) as loader:
        seen = 0
        for batch in loader:
            arr = _local(batch["image_jpeg"])
            assert arr.shape == (4, 32, 32, 3) and arr.dtype == np.uint8
            seen += len(arr)
    assert seen == 2 * len(sizes)


def test_weighted_sampling_device_decode_with_resize(tmp_path):
    """WeightedSamplingReader over two mixed-size stores passes the staged-decode
    fields through; the loader's resize gives the mixed stream one static shape."""
    from petastorm_tpu_torch import WeightedSamplingReader

    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    url_a, _, _ = _mixed_size_store(tmp_path / "a", [(32, 48), (64, 40)] * 2)
    url_b, _, _ = _mixed_size_store(tmp_path / "b", [(24, 24), (48, 32)] * 2)
    r1 = make_batch_reader(url_a, decode_on_device=True, num_epochs=1,
                           shuffle_row_groups=False)
    r2 = make_batch_reader(url_b, decode_on_device=True, num_epochs=1,
                           shuffle_row_groups=False)
    mixed = WeightedSamplingReader([r1, r2], [0.5, 0.5], seed=4)
    assert mixed.device_decode_fields == frozenset({"image_jpeg"})
    seen = 0
    with DataLoader(mixed, batch_size=4, last_batch="partial",
                    device_decode_resize=(32, 32), device=CPU) as loader:
        for batch in loader:
            arr = _local(batch["image_jpeg"])
            assert arr.shape[1:] == (32, 32, 3)
            seen += len(arr)
    assert seen == 8
