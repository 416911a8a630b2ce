"""ImageNet → petastorm-format Parquet (reference examples/imagenet): JPEG-encoded images
stored via CompressedImageCodec, in the layout the on-device decode reads.

The counterpart of ``examples/imagenet/generate_petastorm_imagenet.py``, written with
the port's writer (the stores are the same bytes). Pass a directory tree of JPEGs
(class-per-subdir) or omit it for a synthetic smoke run.
"""
import argparse
import os
import tempfile

import numpy as np

from petastorm_tpu_torch.codecs import CompressedImageCodec, ScalarCodec
from petastorm_tpu_torch.metadata import RowWriter
from petastorm_tpu_torch.types import StringType
from petastorm_tpu_torch.unischema import Unischema, UnischemaField

ImagenetSchema = Unischema("ImagenetSchema", [
    UnischemaField("noun_id", np.str_, (), ScalarCodec(StringType()), False),
    UnischemaField("text", np.str_, (), ScalarCodec(StringType()), False),
    UnischemaField("image", np.uint8, (None, None, 3), CompressedImageCodec("jpeg", 90),
                   False),
])


def training_schema(size):
    """Fixed-shape training layout: resized square images + integer labels — the shape
    the on-device decode path and train_imagenet_torch.py consume (uniform image size per
    batch is the device-decode contract)."""
    from petastorm_tpu_torch.types import IntegerType

    return Unischema("ImagenetTrainSchema", [
        UnischemaField("noun_id", np.str_, (), ScalarCodec(StringType()), False),
        UnischemaField("label", np.int32, (), ScalarCodec(IntegerType()), False),
        UnischemaField("image", np.uint8, (size, size, 3),
                       CompressedImageCodec("jpeg", 90), False),
    ])


def _iter_images(src):
    if src is None:
        rng = np.random.RandomState(0)
        for i in range(32):
            yield ("n%08d" % i, "synthetic_%d" % i,
                   rng.randint(0, 256, (64, 64, 3), dtype=np.uint8))
        return
    import cv2

    for noun_id in sorted(os.listdir(src)):
        cls_dir = os.path.join(src, noun_id)
        if not os.path.isdir(cls_dir):
            continue
        for fname in sorted(os.listdir(cls_dir)):
            img = cv2.imread(os.path.join(cls_dir, fname))
            if img is None:
                continue
            yield noun_id, fname, cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def _resize_square(img, size):
    """Shorter-side resize + center crop to (size, size, 3) — standard train layout."""
    import cv2

    h, w = img.shape[:2]
    scale = size / min(h, w)
    img = cv2.resize(img, (max(size, int(round(w * scale))),
                           max(size, int(round(h * scale)))),
                     interpolation=cv2.INTER_AREA)
    h, w = img.shape[:2]
    y, x = (h - size) // 2, (w - size) // 2
    return np.ascontiguousarray(img[y:y + size, x:x + size])


def generate(url, src=None, size=None):
    if size is None:
        with RowWriter(url, ImagenetSchema, row_group_size_mb=64) as writer:
            for noun_id, text, img in _iter_images(src):
                writer.write({"noun_id": noun_id, "text": text, "image": img})
        return
    schema = training_schema(size)
    labels = {}
    with RowWriter(url, schema, row_group_size_mb=64) as writer:
        for noun_id, _text, img in _iter_images(src):
            label = labels.setdefault(noun_id, len(labels))
            writer.write({"noun_id": noun_id, "label": np.int32(label),
                          "image": _resize_square(img, size)})


def main(argv=None):
    """Write the store; returns its URL."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--src", default=None, help="ImageNet root (class dirs of JPEGs)")
    parser.add_argument("--url", default=None)
    parser.add_argument("--size", type=int, default=None,
                        help="write the fixed-shape training layout (resize + center "
                             "crop to SIZE, add integer labels) instead of raw shapes")
    args = parser.parse_args(argv)
    url = args.url or "file://" + tempfile.mkdtemp(prefix="imagenet_pq")
    generate(url, args.src, args.size)
    from petastorm_tpu_torch import make_reader

    with make_reader(url, schema_fields=["noun_id", "image"]) as reader:
        row = next(iter(reader))
        print(row.noun_id, row.image.shape)
    return url


if __name__ == "__main__":
    main()
