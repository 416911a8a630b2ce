"""Multi-card placement on the card, in a world of one: a ``"cuda"`` mesh over a gloo
group of one rank, the main path (the batched stage 2 and K2 as the device transform)
and the pass-through (K3, the run scan and K4) with ``sharding=batch_sharding(mesh)``.
Every field is a DTensor on the card whose local tensor equals the unsharded loader's
batch (pixels and columns exact, K2's bfloat16 exact: the same kernels on the same
rows), the consumer's stream handoff takes the DTensors, and the kernels launch once a
batch.

These cases need a CUDA device (``gpu`` marker; they skip without one) and import
nothing of the JAX package. Run them on the card with
``python -m pytest -m gpu tests/test_torch_sharding_card.py``.
"""
import datetime
import os
import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_pool_helpers import _no_leaked_shm_segments  # noqa: E402,F401
from _torch_pool_helpers import no_leaked_port_slabs  # noqa: E402,F401

IMG = (48, 64, 3)
ROWS = 96
MEAN = [0.485, 0.456, 0.406]
STD = [0.229, 0.224, 0.225]


@pytest.fixture
def card_mesh():
    """A ``"cuda"`` mesh of one rank over a gloo group in this process."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.distributed as dist

    from petastorm_tpu_torch.parallel.mesh import make_mesh

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method="tcp://127.0.0.1:%d" % port, world_size=1,
                            rank=0, timeout=datetime.timedelta(seconds=60))
    try:
        yield make_mesh()
    finally:
        dist.destroy_process_group()


def _jpeg_store(root):
    import cv2

    from petastorm_tpu_torch import metadata, types
    from petastorm_tpu_torch.codecs import CompressedImageCodec, ScalarCodec
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField

    schema = Unischema("S", [
        UnischemaField("id", np.int64, (), ScalarCodec(types.LongType()), False),
        UnischemaField("image", np.uint8, IMG, CompressedImageCodec("jpeg", 85), False)])
    rng = np.random.RandomState(7)

    def rows():
        for i in range(ROWS):
            noise = rng.randint(0, 256, IMG).astype(np.uint8)
            yield {"id": i, "image": cv2.GaussianBlur(noise, (5, 5), 2.0)}

    url = "file://" + os.path.join(root, "jpeg")
    metadata.write_dataset(url, schema, rows(), row_group_size_mb=0, rows_per_file=32)
    return url


def _run(loader):
    out = []
    with loader:
        for b in loader:
            out.append({k: v.to_local() if hasattr(v, "to_local") else v
                        for k, v in b.items()})
            out[-1]["_dtensor"] = all(hasattr(v, "to_local") for v in b.values())
        torch.cuda.synchronize()
    return out


@pytest.mark.gpu
def test_main_path_delivers_dtensors_equal_to_the_unsharded_loader(card_mesh, tmp_path):
    from petastorm_tpu_torch import make_batch_reader
    from petastorm_tpu_torch.loader import DataLoader
    from petastorm_tpu_torch.ops import image, jpeg
    from petastorm_tpu_torch.parallel.mesh import batch_sharding

    url = _jpeg_store(str(tmp_path))

    def transform(b):
        return {**b, "norm": image.normalize_images(b["image"], MEAN, STD)}

    def loader(sharding):
        reader = make_batch_reader(url, decode_on_device=True, workers_count=1,
                                   shuffle_row_groups=False)
        return DataLoader(reader, 32, sharding=sharding, device_transform=transform)

    launches = jpeg.stage2_rgb.launches, image.normalize_images.launches
    sharded = _run(loader(batch_sharding(card_mesh)))
    assert jpeg.stage2_rgb.launches - launches[0] >= len(sharded) == ROWS // 32
    assert image.normalize_images.launches - launches[1] == len(sharded)
    plain = _run(loader(None))
    for a, b in zip(sharded, plain):
        assert a.pop("_dtensor") and not b.pop("_dtensor")
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].is_cuda and torch.equal(a[k], b[k]), k


@pytest.mark.gpu
def test_passthrough_delivers_dtensors_equal_to_the_unsharded_loader(card_mesh, tmp_path):
    import pyarrow as pa
    import pyarrow.parquet as pq

    from petastorm_tpu_torch import make_batch_reader
    from petastorm_tpu_torch.loader import DataLoader
    from petastorm_tpu_torch.ops import pagedec_kernels as pk
    from petastorm_tpu_torch.parallel.mesh import batch_sharding

    rng = np.random.RandomState(8)
    n = 8192
    pq.write_table(pa.table({
        "cat": rng.randint(0, 7, n).astype(np.int64),
        "f": np.repeat(rng.rand(n // 64).astype(np.float32), 64)}),
        str(tmp_path / "part-0.parquet"), row_group_size=2048, compression="snappy")

    def loader(sharding):
        reader = make_batch_reader("file://" + str(tmp_path), workers_count=1,
                                   shuffle_row_groups=False, io_options={"pagedec": "on"})
        return DataLoader(reader, 2048, sharding=sharding)

    k3 = pk.snappy_inflate_ragged.launches
    sharded = _run(loader(batch_sharding(card_mesh)))
    assert pk.snappy_inflate_ragged.launches - k3 == len(sharded) == 4
    plain = _run(loader(None))
    for a, b in zip(sharded, plain):
        assert a.pop("_dtensor") and not b.pop("_dtensor")
        for k in ("cat", "f"):
            assert a[k].is_cuda and torch.equal(a[k], b[k]), k
