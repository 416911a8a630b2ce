"""The ImageNet example and a store keyed the reference petastorm's way, on the card.

- ``examples/torch/imagenet/train_imagenet_torch.py`` trains ResNet-50 for 4 steps at
  batch 64 on a 224x224 JPEG store written here (``--augment``: the flip on the card):
  finite losses, and the batched stage-2 kernels launched once a decoded batch.
- A store whose ``_common_metadata`` holds only the reference's pickled schema and
  row-group counts is read through ``make_reader`` into the card: its pixels equal the
  port's CPU decode of the same rows (max abs error 0).

These cases need a CUDA device (``gpu`` marker; they skip without one) and import
nothing of the JAX package. Run them on the card with
``python -m pytest -m gpu tests/test_torch_examples_card.py``.
"""
import importlib.util
import math
import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_pool_helpers import _no_leaked_shm_segments  # noqa: E402,F401
from _torch_pool_helpers import no_leaked_port_slabs  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMAGENET = os.path.join(ROOT, "examples", "torch", "imagenet", "train_imagenet_torch.py")
IMG = (224, 224, 3)


def _store(url, rows, rows_per_file, seed):
    """``rows`` blurred-noise 224x224 JPEG q85 rows (id, image, label) from a seed."""
    import cv2

    from petastorm_tpu_torch import types
    from petastorm_tpu_torch.codecs import CompressedImageCodec, ScalarCodec
    from petastorm_tpu_torch.metadata import RowWriter
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField

    schema = Unischema("CardSchema", [
        UnischemaField("id", np.int64, (), ScalarCodec(types.LongType()), False),
        UnischemaField("image", np.uint8, IMG, CompressedImageCodec("jpeg", 85), False),
        UnischemaField("label", np.int32, (), ScalarCodec(types.IntegerType()), False),
    ])
    rng = np.random.RandomState(seed)
    with RowWriter(url, schema, row_group_size_mb=1, rows_per_file=rows_per_file) as w:
        for i in range(rows):
            img = cv2.GaussianBlur(rng.randint(0, 256, IMG).astype(np.uint8), (5, 5), 1.5)
            w.write({"id": i, "image": img, "label": i % 1000})
    return schema


@pytest.mark.gpu
def test_the_imagenet_example_trains_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from petastorm_tpu_torch.codecs import CompressedImageCodec
    from petastorm_tpu_torch.ops import image, jpeg

    url = "file://" + str(tmp_path / "store")
    _store(url, 256, 64, seed=35)
    spec = importlib.util.spec_from_file_location("train_imagenet_torch", IMAGENET)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    decoded = []
    decode = CompressedImageCodec.device_decode_batch

    def counted(self, *args, **kwargs):
        decoded.append(1)
        return decode(self, *args, **kwargs)

    jpeg.stage2_planes_segments.launches = jpeg.stage2_rgb.launches = 0
    image.normalize_images.launches = 0
    CompressedImageCodec.device_decode_batch = counted
    try:
        res = example.main(["--dataset-url", url, "--steps", "4", "--batch-size", "64",
                            "--workers", "2", "--augment"])
    finally:
        CompressedImageCodec.device_decode_batch = decode
    assert res["steps"] == 4 and all(math.isfinite(v) for v in res["losses"])
    assert jpeg.stage2_planes_segments.launches == jpeg.stage2_rgb.launches == len(decoded)
    assert len(decoded) >= 4 and image.normalize_images.launches == 0


@pytest.mark.gpu
def test_a_reference_keyed_store_decodes_on_the_card_as_on_the_cpu(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import pyarrow.parquet as pq

    from petastorm_tpu_torch import make_reader, metadata
    from petastorm_tpu_torch.fs import get_filesystem_and_path_or_paths
    from petastorm_tpu_torch.loader import DataLoader

    path = str(tmp_path / "ref")
    url = "file://" + path
    schema = _store(url, 48, 16, seed=36)
    counts = metadata._count_row_groups_per_file(*get_filesystem_and_path_or_paths(url))
    # the reference's pickles: the schema under its module names, the counts plain
    payload = pickle.dumps(schema, protocol=2)
    for ours, theirs in ((b"petastorm_tpu_torch.unischema", b"petastorm.unischema"),
                         (b"petastorm_tpu_torch.codecs", b"petastorm.codecs"),
                         (b"petastorm_tpu_torch.types", b"pyspark.sql.types")):
        payload = payload.replace(ours, theirs)
    arrow_schema = pq.read_schema(path + "/_common_metadata").remove_metadata()
    pq.write_metadata(arrow_schema.with_metadata({
        metadata.REFERENCE_SCHEMA_KEY: payload,
        metadata.REFERENCE_ROW_GROUPS_KEY: pickle.dumps(counts, protocol=2)}),
        path + "/_common_metadata")
    got = {}
    for device in ("cuda", "cpu"):
        pixels = {}
        reader = make_reader(url, decode_on_device=True, reader_pool_type="dummy",
                             shuffle_row_groups=False)
        with DataLoader(reader, 16, device=device) as loader:
            for b in loader:
                assert b["image"].device.type == device
                for i, img in zip(b["id"].tolist(), b["image"].cpu()):
                    pixels[i] = img
        got[device] = pixels
    assert sorted(got["cuda"]) == sorted(got["cpu"]) == list(range(48))
    for i in range(48):
        err = (got["cuda"][i].int() - got["cpu"][i].int()).abs().max()
        assert int(err) == 0, i
