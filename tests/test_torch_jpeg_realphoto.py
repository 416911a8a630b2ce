"""The zigzag-prefix transfer on real photographs through the port: the JAX package's
``tests/test_jpeg_realphoto.py`` case for case, on the JAX file's crops (sklearn's two
photographs, 224x224, detail-heavy regions first) and encodings (q75/q85/q95 4:2:0,
q85 4:4:4, q85 progressive).

The truncated decode through the port's batched stage 2 must be bit-equal to the
full-spectrum per-image decode, and the kmax / bytes-saved distribution is printed.

Comparison level: bit-exact. The port's planes (coefficients, tables, kmax) and its
pixels equal the JAX package's ``entropy_decode_jpeg_batch`` and ``decode_jpeg_batch``
on the same streams. The ``gpu`` case runs the committed photo crops' truncated decode
on the card and holds ``stage2_planes`` and ``stage2_rgb`` against the CPU path and the
plain versions on the same device.
"""
import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
torch = pytest.importorskip("torch")

from _torch_card_helpers import (assert_card_matches_plain,  # noqa: E402,F401
                                 cuda_device, kernel_launches, launches_since,
                                 plain_kernels)
from _torch_pool_helpers import _no_leaked_shm_segments  # noqa: E402,F401
from test_jpeg_realphoto import ENCODINGS, _encode_all, _photo_crops  # noqa: E402
from test_torch_jpeg import fresh_transfer_state  # noqa: E402,F401

from petastorm_tpu.ops import jpeg as ref  # noqa: E402
from petastorm_tpu.ops import native as ref_native  # noqa: E402
from petastorm_tpu_torch.ops import jpeg as port  # noqa: E402
from petastorm_tpu_torch.ops import native  # noqa: E402

pytestmark = pytest.mark.skipif(
    not (native.native_available() and ref_native.native_available()),
    reason="native toolchain unavailable: %s / %s" % (native.native_error(),
                                                     ref_native.native_error()))

CPU = torch.device("cpu")


@pytest.fixture
def photo_crops():
    pytest.importorskip("sklearn", reason="sklearn ships the two photographs")
    return _photo_crops


def _assert_same_planes(ours, theirs):
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert (a.height, a.width, a.kmax) == (b.height, b.width, b.kmax)
        assert len(a.components) == len(b.components)
        for ca, cb in zip(a.components, b.components):
            assert (ca.h_samp, ca.v_samp) == (cb.h_samp, cb.v_samp)
            np.testing.assert_array_equal(np.asarray(ca.blocks), np.asarray(cb.blocks))
            np.testing.assert_array_equal(np.asarray(ca.qtable), np.asarray(cb.qtable))


def test_truncated_decode_bit_exact_on_real_photos(fresh_transfer_state, photo_crops):
    """On photographic content the port's zigzag-prefix batched decode is BIT-equal to
    its full-spectrum per-image decode for every encoding, and its planes and pixels
    are the JAX package's."""
    crops = photo_crops(n_per_photo=2)
    for name, opts in ENCODINGS.items():
        blobs = _encode_all(crops, opts)
        batch = port.entropy_decode_jpeg_batch(blobs)
        ref_batch = ref.entropy_decode_jpeg_batch(blobs)
        _assert_same_planes(batch, ref_batch)
        out = port.decode_jpeg_batch(batch, device=CPU).numpy()
        for i, blob in enumerate(blobs):
            full = port.decode_jpeg_device_stage(port.entropy_decode_jpeg_fast(blob), CPU)
            np.testing.assert_array_equal(out[i], full.numpy(), err_msg=name)
        np.testing.assert_array_equal(out, np.asarray(ref.decode_jpeg_batch(ref_batch)),
                                      err_msg=name)
    assert port.transfer_byte_counters() == ref.transfer_byte_counters()


def test_kmax_distribution_and_bytes_saved_on_real_photos(capsys, photo_crops):
    """The kmax / transfer-savings distribution on real photos per encoding: kmax is a
    true bound everywhere, no config saves negatively, and the report is the JAX
    package's."""
    crops = photo_crops(n_per_photo=4)
    report = {}
    for name, opts in ENCODINGS.items():
        blobs = _encode_all(crops, opts)
        batch = port.entropy_decode_jpeg_batch(blobs)
        assert batch[0].kmax is not None
        coeffs, _ = port.stack_jpeg_coefficients(batch)
        ref_coeffs, _ = ref.stack_jpeg_coefficients(ref.entropy_decode_jpeg_batch(blobs))
        kmaxes = []
        full_bytes = 0
        packed_bytes = 0
        for c, (arr, ref_arr) in enumerate(zip(coeffs, ref_coeffs)):
            np.testing.assert_array_equal(arr, ref_arr)
            nz = np.where((arr != 0).any(axis=(0, 1))[port.ZIGZAG])[0]
            true_kmax = int(nz[-1]) if len(nz) else 0
            batch_kmax = max(p.kmax[c] for p in batch)
            assert batch_kmax >= true_kmax, (name, c)  # kmax is a true bound
            kmaxes.append(batch_kmax)
            bucket = next((b for b in port._K_BUCKETS if batch_kmax + 1 <= b), 64)
            full_bytes += arr.shape[0] * arr.shape[1] * 64 * 2
            packed_bytes += arr.shape[0] * arr.shape[1] * bucket * 2
        report[name] = {
            "kmax": kmaxes,
            "bytes_saved_frac": round(1 - packed_bytes / full_bytes, 3),
        }
    print("REAL-PHOTO ZIGZAG REPORT:", report)
    assert port._K_BUCKETS == ref._K_BUCKETS
    assert np.array_equal(port.ZIGZAG, ref.ZIGZAG)
    assert report["q75_420"]["bytes_saved_frac"] >= 0.0
    # and no config may ever "save" negatively (bucket overflow bug)
    assert all(r["bytes_saved_frac"] >= 0.0 for r in report.values())


@pytest.mark.gpu
def test_truncated_decode_on_real_photos_on_the_card(fresh_transfer_state, cuda_device):
    """The committed photo crops (``tests/data/torch_jpeg/``: a 224x224 crop of each
    photograph at q50, q75 and q95, so the card machine needs no sklearn) as one
    truncated batch on the card: the stage-2 kernels launch, and the pixels equal the
    CPU path (the JAX package's pixels, ``test_torch_edge_fixtures.py``) bit for bit,
    and the plain versions on the card as ``assert_card_matches_plain`` holds them."""
    from test_torch_edge_fixtures import _group, _script

    fixtures = _script().load()
    blobs = _group(fixtures, "photo")
    batch = port.entropy_decode_jpeg_batch(blobs)
    assert all(p is not None and p.kmax is not None for p in batch)
    before = kernel_launches()
    on_card = port.decode_jpeg_batch(batch, device=cuda_device).cpu()
    launched = launches_since(before)
    assert launched["stage2_planes"] == 1 and launched["stage2_rgb"] == 1, launched
    with plain_kernels():
        plain = port.decode_jpeg_batch(batch, device=cuda_device).cpu()
    assert torch.equal(on_card, port.decode_jpeg_batch(batch, device=CPU))
    assert_card_matches_plain(on_card, plain)
