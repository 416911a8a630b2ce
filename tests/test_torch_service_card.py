"""The data service feeding two trainers on the card, at a small size: a ``DataService``
over a JPEG store's row groups whose decode callable turns each row group's JPEG cells
into uint8 images on the host (the port's CPU decode), two ``DecodeWorker``s, and two
trainers, each a ``ServiceReader`` into ``DataLoader(device='cuda')`` with K2 as its
device transform. Each trainer receives every row once with the pixels of the callable
run here, each item is decoded once for both, no lease is left, and K2 launches once a
batch.

These cases need a CUDA device (``gpu`` marker; they skip without one) and import
nothing of the JAX package. Run them on the card with
``python -m pytest -m gpu tests/test_torch_service_card.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_pool_helpers import _no_leaked_shm_segments  # noqa: E402,F401
from _torch_pool_helpers import no_leaked_port_slabs  # noqa: E402,F401

IMG = (48, 64, 3)
ROWS, GROUP = 96, 12


def decode_jpeg_group(item):
    """The service's decode callable: one row group, its JPEG cells decoded on the host."""
    import pyarrow.parquet as pq

    from petastorm_tpu_torch.ops import jpeg

    path, rg = item
    table = pq.ParquetFile(path).read_row_group(rg)
    pixels = jpeg.decode_jpeg_batch(jpeg.entropy_decode_jpeg_batch(
        table.column("image").to_pylist()), device="cpu", bgr=True).numpy()
    return {"id": table.column("id").to_numpy(), "image": pixels}, table.num_rows


@pytest.mark.gpu
def test_two_trainers_on_the_card_decode_once(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import cv2
    import pyarrow as pa
    import pyarrow.parquet as pq

    from petastorm_tpu_torch.loader import DataLoader
    from petastorm_tpu_torch.ops import image
    from petastorm_tpu_torch.reader import make_service_reader
    from petastorm_tpu_torch.service import (DataService, DecodeWorker, JobSpec,
                                             ServiceOptions)
    from petastorm_tpu_torch.service.protocol import svc_metrics
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField

    rng = np.random.RandomState(20)
    blobs = [cv2.imencode(".jpg", cv2.GaussianBlur(
        rng.randint(0, 256, IMG).astype(np.uint8), (5, 5), 2.0))[1].tobytes()
        for _ in range(ROWS)]
    path = str(tmp_path / "part-0.parquet")
    pq.write_table(pa.table({"id": np.arange(ROWS, dtype=np.int64),
                             "image": pa.array(blobs, pa.binary())}), path,
                   row_group_size=GROUP)
    schema = Unischema("S", [UnischemaField("id", np.int64, (), None, False),
                             UnischemaField("image", np.uint8, IMG, None, False)])
    items = [(path, rg) for rg in range(ROWS // GROUP)]
    local = {}  # the callable run here: id -> its pixels
    for it in items:
        cols, _rows = decode_jpeg_group(it)
        local.update(zip(cols["id"].tolist(), cols["image"]))
    m = svc_metrics()
    decodes0, leaked0 = m["decodes"].value, m["lease_leaked"].value
    svc = DataService(options=ServiceOptions(arena=False))
    try:
        svc.add_job(JobSpec("j", items, decode_jpeg_group, schema))
        readers = [make_service_reader(svc.trainer_address(), svc.token, "j",
                                       trainer="t%d" % i, arena=False) for i in range(2)]
        fleet = [DecodeWorker(svc.worker_address(), svc.token) for _ in range(2)]
        for w in fleet:
            w.start()
        image.normalize_images.launches = 0
        batches = 0
        for reader in readers:
            seen = []
            with DataLoader(reader, 16, device="cuda", last_batch="partial",
                            device_transform=lambda b: {**b, "norm": image.normalize_images(
                                b["image"], (0.5,) * 3, (0.25,) * 3)}) as loader:
                for batch in loader:
                    ids = batch["id"].cpu().numpy().tolist()
                    got = batch["image"].cpu().numpy()
                    np.testing.assert_array_equal(got, np.stack([local[i] for i in ids]))
                    assert torch.equal(batch["norm"], image._normalize_plain(
                        batch["image"], (0.5,) * 3, (0.25,) * 3, torch.bfloat16))
                    seen.extend(ids)
                    batches += 1
            assert sorted(seen) == list(range(ROWS))
        torch.cuda.synchronize()
        assert image.normalize_images.launches == batches
        assert svc.outstanding_leases() == 0
    finally:
        svc.stop()
    assert m["decodes"].value - decodes0 == len(items)
    assert m["lease_leaked"].value == leaked0
