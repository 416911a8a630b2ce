"""The dataset watch on the card: a file rewritten under a watched reader, on the JPEG
main path (the batched stage 2 and K2) and on the compressed-page pass-through (K3, the
run scan and K4), with the read path at its defaults (readahead on).

The old generation's rows arrive only before the tick (a read checked before it
delivers them, the readahead invariant), the new generation's exactly once, after every
row of the old one; every image equals the plain stage 2 of its row, every pass-through
value pyarrow's read of the bytes it came from; the kernels launch once a batch.

These cases need a CUDA device (``gpu`` marker; they skip without one) and import
nothing of the JAX package. Run them on the card with
``python -m pytest -m gpu tests/test_torch_dataset_watch_card.py``.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_pool_helpers import _no_leaked_shm_segments  # noqa: E402,F401
from _torch_pool_helpers import no_leaked_port_slabs  # noqa: E402,F401

IMG = (48, 64, 3)
ROWS_PER_FILE = 32


def _blobs(start, n, seed):
    """``n`` q85 JPEGs of IMG from a numpy seed, keyed by id from ``start``."""
    import cv2

    from petastorm_tpu_torch.codecs import CompressedImageCodec
    from petastorm_tpu_torch.unischema import UnischemaField

    field = UnischemaField("image", np.uint8, IMG, CompressedImageCodec("jpeg", 85), False)
    rng = np.random.RandomState(seed)
    return {start + i: bytes(field.codec.encode(field, cv2.GaussianBlur(
        rng.randint(0, 256, IMG).astype(np.uint8), (5, 5), 2.0))) for i in range(n)}


def _jpeg_store(root):
    """4 files of 32 rows in row groups of 4, with the unischema; returns {id: blob}."""
    import pyarrow.fs as pafs

    from petastorm_tpu_torch import types as ptypes
    from petastorm_tpu_torch.codecs import CompressedImageCodec, ScalarCodec
    from petastorm_tpu_torch.metadata import write_petastorm_tpu_metadata
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField

    schema = Unischema("S", [
        UnischemaField("id", np.int64, (), ScalarCodec(ptypes.LongType()), False),
        UnischemaField("image", np.uint8, IMG, CompressedImageCodec("jpeg", 85), False)])
    os.makedirs(root)
    blobs = _blobs(0, 4 * ROWS_PER_FILE, 3)
    for f in range(4):
        _write_jpeg_file(os.path.join(root, "part-%d.parquet" % f),
                         range(f * ROWS_PER_FILE, (f + 1) * ROWS_PER_FILE), blobs)
    write_petastorm_tpu_metadata(pafs.LocalFileSystem(), root, schema,
                                 {"part-%d.parquet" % f: ROWS_PER_FILE // 4 for f in range(4)})
    return blobs


def _write_jpeg_file(path, ids, blobs):
    """One file of ``ids`` (their blobs), row groups of 4, written atomically."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    ids = list(ids)
    table = pa.table({"id": pa.array(ids, pa.int64()),
                      "image": pa.array([blobs[i] for i in ids], pa.binary())})
    pq.write_table(table, path + ".tmp", row_group_size=4)
    os.replace(path + ".tmp", path)


def _plain_images(blobs, ids):
    """The plain stage 2 (the port's CPU decode) of ``ids``' blobs, BGR as delivered."""
    from petastorm_tpu_torch.ops import jpeg

    planes = jpeg.entropy_decode_jpeg_batch([blobs[i] for i in ids])
    return jpeg.decode_jpeg_batch(planes, device="cpu", bgr=True).numpy()


@pytest.mark.gpu
def test_rewrite_under_a_watched_main_path_on_the_card(tmp_path):
    """File 2 rewritten with new ids and images after the first batch, one tick, two
    epochs on the thread pool: the old generation's ids at most once (those read before
    the tick), the new generation's once, after every old one; every image equal to the
    plain stage 2 of its blob; stage2_planes, stage2_rgb and K2 once a batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from petastorm_tpu_torch.loader import DataLoader
    from petastorm_tpu_torch.ops import image, jpeg
    from petastorm_tpu_torch.reader import make_batch_reader

    root = str(tmp_path / "s")
    blobs = _jpeg_store(root)
    new = _blobs(1000, ROWS_PER_FILE, 9)
    everything = {**blobs, **new}
    jpeg.stage2_planes_segments.launches = jpeg.stage2_rgb.launches = 0
    image.normalize_images.launches = 0
    reader = make_batch_reader("file://" + root, workers_count=2, num_epochs=2,
                               shuffle_row_groups=False, decode_on_device=True,
                               results_queue_size=2,
                               recovery={"on_poison": "quarantine", "poison_attempts": 1},
                               watch={"interval_s": 3600})
    delivered = []
    batches = 0
    with DataLoader(reader, 4, device="cuda", last_batch="partial",
                    device_transform=lambda b: {**b, "norm": image.normalize_images(
                        b["image"], (0.5,) * 3, (0.25,) * 3)}) as loader:
        for batch in loader:
            ids = batch["id"].cpu().numpy().tolist()
            got = batch["image"].cpu().numpy()
            np.testing.assert_array_equal(got, _plain_images(everything, ids))
            delivered.extend(ids)
            batches += 1
            if batches == 1:
                _write_jpeg_file(os.path.join(root, "part-2.parquet"),
                                 range(1000, 1000 + ROWS_PER_FILE), new)
                reader.dataset_watcher.poll_once()
        report = list(loader.quarantine_report)
    torch.cuda.synchronize()
    launches = (jpeg.stage2_planes_segments.launches, jpeg.stage2_rgb.launches,
                image.normalize_images.launches)
    assert launches == (batches,) * 3
    old2 = [i for i in delivered if 2 * ROWS_PER_FILE <= i < 3 * ROWS_PER_FILE]
    new2 = [i for i in delivered if i >= 1000]
    assert len(old2) == len(set(old2)) and sorted(new2) == list(range(1000, 1032))
    if old2:  # read before the tick: all of them before the first new one
        assert max(delivered.index(i) for i in old2) < min(delivered.index(i) for i in new2)
    assert {e.kind for e in report} == {"piece_rewritten"}
    for i in list(range(2 * ROWS_PER_FILE)) + list(range(3 * ROWS_PER_FILE, 128)):
        assert delivered.count(i) == 2


@pytest.mark.gpu
def test_rewrite_under_a_watched_passthrough_on_the_card(tmp_path):
    """The pass-through over two files of 16 row groups; file 1 rewritten from a new
    seed after the first batch, one tick, two epochs on the thread pool: each batch
    byte-identical to pyarrow's read of the generation it came from, file 0 twice, the
    new generation once, after every batch of the old, and one K3, scan and K4 launch a
    batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import pyarrow as pa
    import pyarrow.parquet as pq

    from petastorm_tpu_torch.loader import DataLoader
    from petastorm_tpu_torch.ops import pagedec_kernels as pk
    from petastorm_tpu_torch.reader import make_batch_reader

    root = str(tmp_path / "t")
    os.makedirs(root)
    rows, groups = 1024, 16

    def write(f, seed):
        rng = np.random.default_rng(seed)
        path = os.path.join(root, "part-%d.parquet" % f)
        n = groups * rows
        table = pa.table({"k": (rng.zipf(1.3, n) % 50).astype(np.int32),
                          "v": np.repeat(rng.random(n // 64).astype(np.float32), 64)})
        pq.write_table(table, path + ".tmp", row_group_size=rows, compression="snappy")
        os.replace(path + ".tmp", path)
        return {c: table.column(c).to_numpy() for c in ("k", "v")}

    sources = [write(0, 0), write(1, 1)]
    pk.snappy_inflate_ragged.launches = pk.rle_scan_pages.launches = 0
    pk.extract_pages.launches = 0
    reader = make_batch_reader("file://" + root, workers_count=2, num_epochs=2,
                               shuffle_row_groups=False, io_options={"pagedec": "on"},
                               results_queue_size=2,
                               recovery={"on_poison": "quarantine", "poison_attempts": 1},
                               watch={"interval_s": 3600})
    seen = []
    with DataLoader(reader, rows, device="cuda") as loader:
        for batch in loader:
            got = {c: batch[c].cpu().numpy() for c in ("k", "v")}
            match = [(s, rg) for s, src in enumerate(sources) for rg in range(groups)
                     if all(got[c].tobytes() == src[c][rg * rows:(rg + 1) * rows].tobytes()
                            for c in ("k", "v"))]
            assert len(match) == 1, "a batch matches no row group of any generation"
            seen.append(match[0])
            if len(seen) == 1:
                sources.append(write(1, 7))  # file 1's new generation: source 2
                reader.dataset_watcher.poll_once()
    launches = (pk.snappy_inflate_ragged.launches, pk.rle_scan_pages.launches,
                pk.extract_pages.launches)
    assert launches == (len(seen),) * 3
    assert sorted(m for m in seen if m[0] == 0) == sorted([(0, rg)
                                                           for rg in range(groups)] * 2)
    new = [i for i, m in enumerate(seen) if m[0] == 2]
    old = [i for i, m in enumerate(seen) if m[0] == 1]
    assert sorted(seen[i][1] for i in new) == list(range(groups))
    assert len({seen[i] for i in old}) == len(old)
    assert not old or max(old) < min(new)
