"""The unsupported-JPEG error contract in the port: the JAX package's
``tests/test_decode_errors.py`` case for case.

A legitimately encoded stream that neither the native stage 1 nor cv2 can decode (a
lossless SOF3 stream) surfaces as a ``DecodeFieldError`` naming the field and the row
group, on both read paths, with ``decode_on_device`` on and off, over the thread and the
process pools; rows before it are delivered intact; an arithmetic-coded stream (SOF9)
falls back to the host beside the device rows; the loader surfaces the error.

Comparison level: bit-exact. The error's message (field, file and row group) equals the
JAX package's on the same store, and every delivered pixel equals the JAX package's
delivery. The stores are written by the JAX file's own helpers
(``test_decode_errors.py``). The ``gpu`` case holds the fallback merge on the card
against the CPU path and the plain versions of the stage-2 kernels on the same device.
"""
import re

import numpy as np
import pytest

pytest.importorskip("cv2")
torch = pytest.importorskip("torch")

from _torch_card_helpers import (assert_card_matches_plain,  # noqa: E402,F401
                                 cuda_device, kernel_launches, launches_since,
                                 plain_kernels)
from _torch_pool_helpers import _no_leaked_shm_segments  # noqa: E402,F401
from test_decode_errors import (_patched_sof, _sample_image,  # noqa: E402
                                _write_with_bad_row)

import petastorm_tpu.errors as ref_errors  # noqa: E402
import petastorm_tpu.loader as ref_loader  # noqa: E402
import petastorm_tpu.reader as ref_reader  # noqa: E402
from petastorm_tpu_torch.errors import DecodeFieldError  # noqa: E402
from petastorm_tpu_torch.loader import DataLoader  # noqa: E402
from petastorm_tpu_torch.reader import make_batch_reader, make_reader  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def lossless_dataset(tmp_path_factory):
    """Row 4 is a lossless-marker (SOF3) stream: undecodable by native stage 1 AND cv2."""
    path = tmp_path_factory.mktemp("jpeg_lossless")
    url = "file://" + str(path / "ds")
    return _write_with_bad_row(url, _patched_sof(_sample_image(4), b"\xff\xc3"))


@pytest.fixture(scope="module")
def arith_dataset(tmp_path_factory):
    """Row 4 is an arithmetic-marker (SOF9) stream: native stage 1 rejects it, cv2
    decodes it on the host beside the device-decoded siblings."""
    path = tmp_path_factory.mktemp("jpeg_arith")
    url = "file://" + str(path / "ds")
    return _write_with_bad_row(url, _patched_sof(_sample_image(4), b"\xff\xc9"))


def _reference_error(factory, url, decode_on_device):
    with factory(url, reader_pool_type="dummy", decode_on_device=decode_on_device,
                 num_epochs=1, shuffle_row_groups=False) as reader:
        with pytest.raises(ref_errors.DecodeFieldError) as exc_info:
            for _ in reader:
                pass
    return str(exc_info.value)


def _where(msg):
    """(field, file, row group) that a decode error names."""
    field = re.search(r"field '([^']+)'", msg)
    at = re.search(r"while decoding (\S+) row group (\d+)", msg)
    assert field and at, msg
    return field.group(1), at.group(1), int(at.group(2))


@pytest.mark.parametrize("decode_on_device", [False, True])
@pytest.mark.parametrize("pool", ["thread", "process"])
def test_per_row_path_names_field_and_rowgroup(lossless_dataset, decode_on_device, pool):
    with make_reader(lossless_dataset, reader_pool_type=pool, workers_count=2,
                     decode_on_device=decode_on_device, num_epochs=1,
                     shuffle_row_groups=False) as reader:
        with pytest.raises(DecodeFieldError) as exc_info:
            for _ in reader:
                pass
    msg = str(exc_info.value)
    assert "image_jpeg" in msg
    assert "row group" in msg and ".parquet" in msg
    assert "cv2" in msg  # says WHY, not just where
    theirs = _reference_error(ref_reader.make_reader, lossless_dataset, decode_on_device)
    assert _where(msg) == _where(theirs)
    assert msg == theirs


@pytest.mark.parametrize("decode_on_device", [False, True])
@pytest.mark.parametrize("pool", ["thread", "process"])
def test_batch_path_names_field_and_rowgroup(lossless_dataset, decode_on_device, pool):
    with make_batch_reader(lossless_dataset, reader_pool_type=pool, workers_count=2,
                           decode_on_device=decode_on_device, num_epochs=1,
                           shuffle_row_groups=False) as reader:
        with pytest.raises(DecodeFieldError) as exc_info:
            for _ in reader:
                pass
    msg = str(exc_info.value)
    assert "image_jpeg" in msg
    assert "row group" in msg and ".parquet" in msg
    theirs = _reference_error(ref_reader.make_batch_reader, lossless_dataset,
                              decode_on_device)
    assert _where(msg) == _where(theirs)
    assert msg == theirs


def _rows_until_error(factory, url, error_type):
    seen = {}
    with factory(url, reader_pool_type="dummy", decode_on_device=False, num_epochs=1,
                 shuffle_row_groups=False) as reader:
        try:
            for row in reader:
                seen[int(row.id)] = np.asarray(row.image_jpeg)
        except error_type:
            pass
    return seen


def test_rows_before_error_delivered_intact(tmp_path):
    """Row groups ahead of the poisoned one arrive bit-intact before the error surfaces
    (in-order delivery on the dummy pool), equal to the JAX package's rows."""
    url = "file://" + str(tmp_path / "ds")
    # bad row 10 lives in the SECOND file (rows 6..11); the first file is clean
    _write_with_bad_row(url, _patched_sof(_sample_image(10), b"\xff\xc3"), bad_idx=10)
    seen = _rows_until_error(make_reader, url, DecodeFieldError)
    assert set(seen) == {0, 1, 2, 3, 4, 5}
    for rid, img in seen.items():
        assert img.shape == (32, 48, 3) and img.dtype == np.uint8
    theirs = _rows_until_error(ref_reader.make_reader, url, ref_errors.DecodeFieldError)
    assert sorted(theirs) == sorted(seen)
    for rid, img in seen.items():
        np.testing.assert_array_equal(img, theirs[rid])


def _loader_images(reader, loader_cls, **kw):
    out = {}
    with loader_cls(reader, batch_size=6, **kw) as loader:
        for batch in loader:
            ids = np.asarray(batch["id"].cpu() if hasattr(batch["id"], "cpu")
                             else batch["id"])
            imgs = batch["image_jpeg"]
            imgs = np.asarray(imgs.cpu() if hasattr(imgs, "cpu") else imgs)
            for i, img in zip(ids.tolist(), imgs):
                out[int(i)] = img
    return out


def _arith_read(url, device):
    reader = make_batch_reader(url, decode_on_device=True, num_epochs=1,
                               shuffle_row_groups=False)
    return _loader_images(reader, DataLoader, device=device)


def test_arith_stream_falls_back_beside_device_rows(arith_dataset):
    """A stream stage 1 rejects but cv2 CAN decode rides the per-stream host fallback;
    siblings stay on the device path and every row is delivered bit-intact, equal to
    the JAX package's loader pixel for pixel."""
    ours = _arith_read(arith_dataset, CPU)
    assert sorted(ours) == list(range(12))
    assert {img.shape for img in ours.values()} == {(32, 48, 3)}
    reader = ref_reader.make_batch_reader(arith_dataset, decode_on_device=True,
                                          num_epochs=1, shuffle_row_groups=False)
    theirs = _loader_images(reader, ref_loader.DataLoader)
    assert sorted(theirs) == sorted(ours)
    for i, img in ours.items():
        np.testing.assert_array_equal(img, theirs[i], err_msg="row %d" % i)


@pytest.mark.gpu
def test_arith_stream_falls_back_beside_device_rows_on_the_card(arith_dataset,
                                                                cuda_device):
    """The fallback merge on the card: the device rows go through ``stage2_planes`` and
    ``stage2_rgb``, the arithmetic row through cv2, merged in order; equal bit for bit
    to the CPU path, and to the plain versions on the card (``assert_card_matches_plain``)."""
    before = kernel_launches()
    on_card = _arith_read(arith_dataset, cuda_device)
    launched = launches_since(before)
    assert launched["stage2_planes"] >= 1 and launched["stage2_rgb"] >= 1, launched
    with plain_kernels():
        plain = _arith_read(arith_dataset, cuda_device)
    cpu = _arith_read(arith_dataset, CPU)
    assert sorted(on_card) == sorted(plain) == sorted(cpu) == list(range(12))
    for i in on_card:
        np.testing.assert_array_equal(on_card[i], cpu[i], err_msg="row %d" % i)
        assert_card_matches_plain(torch.from_numpy(on_card[i]), torch.from_numpy(plain[i]))


def test_loader_surfaces_decode_error(lossless_dataset):
    """Through the full device pipeline the consumer sees the annotated DecodeFieldError
    (the JAX package's message), and the loader tears down cleanly."""
    reader = make_reader(lossless_dataset, decode_on_device=True, num_epochs=1,
                         shuffle_row_groups=False)
    with pytest.raises(DecodeFieldError, match="image_jpeg") as exc_info:
        with DataLoader(reader, batch_size=6, device=CPU) as loader:
            for _ in loader:
                pass
    theirs = _reference_error(ref_reader.make_reader, lossless_dataset, True)
    assert _where(str(exc_info.value)) == _where(theirs)
