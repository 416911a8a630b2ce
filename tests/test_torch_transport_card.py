"""The process pool on tcp on the card, at a small size: a JPEG store read with
``make_batch_reader(decode_on_device=True, reader_pool_type='process', transport=...)``
into ``DataLoader(device='cuda')`` with K2 as its device transform, over the pipe and
over tcp. Each wire delivers every id once with the pixels of the plain stage 2 (the
port's CPU decode), the tcp pool really runs on tcp (its links counted), and
``stage2_planes``, ``stage2_rgb`` and K2 launch once a batch.

These cases need a CUDA device (``gpu`` marker; they skip without one) and import
nothing of the JAX package. Run them on the card with
``python -m pytest -m gpu tests/test_torch_transport_card.py``.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_pool_helpers import _no_leaked_shm_segments  # noqa: E402,F401
from _torch_pool_helpers import no_leaked_port_slabs  # noqa: E402,F401

IMG = (48, 64, 3)
ROWS, ROWS_PER_FILE = 96, 24


def _jpeg_store(root):
    """4 files of 24 rows in row groups of 6, with the unischema; returns {id: blob}."""
    import cv2
    import pyarrow as pa
    import pyarrow.fs as pafs
    import pyarrow.parquet as pq

    from petastorm_tpu_torch import types as ptypes
    from petastorm_tpu_torch.codecs import CompressedImageCodec, ScalarCodec
    from petastorm_tpu_torch.metadata import write_petastorm_tpu_metadata
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField

    schema = Unischema("S", [
        UnischemaField("id", np.int64, (), ScalarCodec(ptypes.LongType()), False),
        UnischemaField("image", np.uint8, IMG, CompressedImageCodec("jpeg", 85), False)])
    field = schema.fields["image"]
    rng = np.random.RandomState(19)
    blobs = {i: bytes(field.codec.encode(field, cv2.GaussianBlur(
        rng.randint(0, 256, IMG).astype(np.uint8), (5, 5), 2.0))) for i in range(ROWS)}
    os.makedirs(root)
    for f in range(ROWS // ROWS_PER_FILE):
        ids = list(range(f * ROWS_PER_FILE, (f + 1) * ROWS_PER_FILE))
        pq.write_table(pa.table({"id": pa.array(ids, pa.int64()),
                                 "image": pa.array([blobs[i] for i in ids], pa.binary())}),
                       os.path.join(root, "part-%d.parquet" % f), row_group_size=6)
    write_petastorm_tpu_metadata(pafs.LocalFileSystem(), root, schema,
                                 {"part-%d.parquet" % f: ROWS_PER_FILE // 6
                                  for f in range(ROWS // ROWS_PER_FILE)})
    return blobs


@pytest.mark.gpu
@pytest.mark.parametrize("transport", ["pipe", "tcp"])
def test_jpeg_main_path_over_each_wire_on_the_card(tmp_path, transport):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from petastorm_tpu_torch.loader import DataLoader
    from petastorm_tpu_torch.ops import image, jpeg
    from petastorm_tpu_torch.reader import make_batch_reader
    from petastorm_tpu_torch.transport import net_metrics

    root = str(tmp_path / "s")
    blobs = _jpeg_store(root)
    plain = jpeg.decode_jpeg_batch(jpeg.entropy_decode_jpeg_batch(
        [blobs[i] for i in range(ROWS)]), device="cpu", bgr=True).numpy()
    connects0 = net_metrics().connects.value
    jpeg.stage2_planes_segments.launches = jpeg.stage2_rgb.launches = 0
    image.normalize_images.launches = 0
    reader = make_batch_reader("file://" + root, decode_on_device=True,
                               reader_pool_type="process", workers_count=2,
                               transport=transport, shuffle_row_groups=False,
                               results_timeout_s=120)
    assert reader._executor._transport_name == transport
    seen, batches = [], 0
    with DataLoader(reader, 16, device="cuda", last_batch="partial",
                    device_transform=lambda b: {**b, "norm": image.normalize_images(
                        b["image"], (0.5,) * 3, (0.25,) * 3)}) as loader:
        for batch in loader:
            ids = batch["id"].cpu().numpy()
            np.testing.assert_array_equal(batch["image"].cpu().numpy(), plain[ids])
            assert torch.equal(batch["norm"], image._normalize_plain(
                batch["image"], (0.5,) * 3, (0.25,) * 3, torch.bfloat16))
            seen.extend(ids.tolist())
            batches += 1
    torch.cuda.synchronize()
    assert sorted(seen) == list(range(ROWS))
    assert (jpeg.stage2_planes_segments.launches, jpeg.stage2_rgb.launches,
            image.normalize_images.launches) == (batches,) * 3
    links = net_metrics().connects.value - connects0
    assert links >= 2 if transport == "tcp" else links == 0
