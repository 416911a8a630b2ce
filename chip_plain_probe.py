#!/usr/bin/env python3
"""Where the kernel path and the plain versions on the card part (ROADMAP Queue 3 AC).

    python3 chip_plain_probe.py

Writes the device-decode tests' store with the port (24 rows of 32x48 blocky images from
``numpy.random.RandomState(0)``, JPEG q90, three files, as ``tests/test_common.py``'s
``create_test_jpeg_dataset`` makes it), reads its staged rows in plan order, and decodes
them in batches of 8 three ways: the kernels on the card, the plain versions on the card
(``tests/_torch_card_helpers.plain_kernels``) and the CPU path. Then K1's product alone,
component by component: the plain version on the card against the CPU, and the kernel
against the CPU. Prints the count of differing values of each pair. Needs a CUDA card.
"""
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.abspath(__file__))


def write_store(url, rows=24):
    import numpy as np

    from petastorm_tpu_torch import types
    from petastorm_tpu_torch.codecs import CompressedImageCodec, ScalarCodec
    from petastorm_tpu_torch.metadata import write_dataset
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField

    schema = Unischema("JpegSchema", [
        UnischemaField("id", np.int64, (), ScalarCodec(types.LongType()), False),
        UnischemaField("image_jpeg", np.uint8, (32, 48, 3),
                       CompressedImageCodec("jpeg", quality=90), False),
        UnischemaField("label", np.int32, (), ScalarCodec(types.IntegerType()), False),
    ])
    rng = np.random.RandomState(0)
    data = []
    for i in range(rows):
        base = rng.randint(0, 256, (8, 12)).astype(np.float32)
        img = np.kron(base, np.ones((4, 4), np.float32))
        img = np.stack([img, np.flipud(img), np.fliplr(img)], -1)
        data.append({"id": i, "image_jpeg": img.clip(0, 255).astype(np.uint8),
                     "label": np.int32(i % 7)})
    write_dataset(url, schema, data, rows_per_file=rows // 3)


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_plain_probe.py needs a CUDA card")
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    from _torch_card_helpers import plain_kernels

    from petastorm_tpu_torch.ops import jpeg
    from petastorm_tpu_torch.reader import make_reader

    dev, cpu = torch.device("cuda"), torch.device("cpu")
    url = "file://" + os.path.join(tempfile.mkdtemp(prefix="ptpu_plain_probe_"), "ds")
    write_store(url)
    with make_reader(url, decode_on_device=True, shuffle_row_groups=False,
                     reader_pool_type="dummy") as reader:
        planes = [row.image_jpeg for row in reader]
    for lo in range(0, len(planes), 8):
        part = planes[lo:lo + 8]
        kern = jpeg.decode_jpeg_batch(part, device=dev).cpu()
        with plain_kernels():
            plain = jpeg.decode_jpeg_batch(part, device=dev).cpu()
        host = jpeg.decode_jpeg_batch(part, device=cpu)
        print("rows %d-%d (%d values): kernel vs CPU %d differ; kernel vs plain on the "
              "card %d differ (max %d); plain on the card vs CPU %d differ" % (
                  lo, lo + len(part) - 1, kern.numel(), int((kern != host).sum()),
                  int((kern != plain).sum()), int((kern.int() - plain.int()).abs().max()),
                  int((plain != host).sum())))
    coeffs, qtabs = jpeg.stack_jpeg_coefficients(planes)
    for ci, (coef, q) in enumerate(zip(coeffs, qtabs)):
        scaled = (torch.from_numpy(coef).float()
                  * torch.from_numpy(q).float()[:, None, :]).reshape(-1, 64)
        on_card = jpeg._idct_scaled_plain(scaled.to(dev)).cpu()
        host = jpeg._idct_scaled_plain(scaled)
        kern = jpeg.idct_scaled(scaled.to(dev)).cpu()
        print("component %d (%d values): K1's plain product on the card vs CPU %d differ "
              "(max %.3g), %d round differently; kernel vs CPU %d differ, %d round "
              "differently" % (
                  ci, host.numel(), int((on_card != host).sum()),
                  float((on_card - host).abs().max()),
                  int((torch.round(on_card) != torch.round(host)).sum()),
                  int((kern != host).sum()),
                  int((torch.round(kern) != torch.round(host)).sum())))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip())


if __name__ == "__main__":
    main()
