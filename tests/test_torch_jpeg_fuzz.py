"""Fuzzing of the port's own copy of the C++ stage-1 decoder
(``petastorm_tpu_torch/ops/native/jpeg_decoder.cpp``): the JAX package's
``tests/test_jpeg_fuzz.py`` case for case, on the JAX file's seeded corpus (baseline,
progressive, restart-interval, optimised-Huffman and grayscale seeds x byte flips,
truncation, marker splices, DHT/DQT/SOS/DRI length fields and RST injection; 1,100
mutants).

Corrupt input must always surface as a clean ``ValueError``/status-slot rejection or a
successful decode, never a crash or a hang, and the sandwich ``[good, mutant, good]``
must leave the good slices bit-identical.

Comparison level: bit-exact. For every mutant the port's decoder gives the JAX package's
native decoder's outcome: the same exception type and message, or the same layout,
statuses, kmax, coefficients and (in the slots that decoded) quantisation tables. The
``gpu`` case puts the sandwich's surviving mutants through ``decode_jpeg_batch`` on the
card and holds the stage-2 kernels against their plain versions on the same device.
"""
import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
torch = pytest.importorskip("torch")

from _torch_card_helpers import (assert_card_matches_plain,  # noqa: E402,F401
                                 cuda_device, kernel_launches, launches_since,
                                 plain_kernels)
from _torch_pool_helpers import _no_leaked_shm_segments  # noqa: E402,F401
from test_jpeg_fuzz import _find_markers, _mutants, _seed_streams  # noqa: E402

from petastorm_tpu.ops import native as ref_native  # noqa: E402
from petastorm_tpu_torch.ops import jpeg as port_jpeg  # noqa: E402
from petastorm_tpu_torch.ops import native  # noqa: E402

pytestmark = pytest.mark.skipif(
    not (native.native_available() and ref_native.native_available()),
    reason="native toolchain unavailable: %s / %s" % (native.native_error(),
                                                     ref_native.native_error()))

CPU = torch.device("cpu")


def _outcome(mod, fn, *args):
    """What a native call did, package-free: ``("raised", type, message)`` or
    ``("ok", result)``."""
    try:
        return ("ok", getattr(mod, fn)(*args))
    except (ValueError, RuntimeError) as e:
        return ("raised", type(e).__name__, str(e))


def _assert_same_result(ours, theirs):
    """Recursive bit-exact equality of two native results (tuples, arrays, scalars)."""
    if isinstance(ours, np.ndarray) or isinstance(theirs, np.ndarray):
        a, b = np.asarray(ours), np.asarray(theirs)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    elif isinstance(ours, (tuple, list)):
        assert type(ours) is type(theirs) and len(ours) == len(theirs)
        for x, y in zip(ours, theirs):
            _assert_same_result(x, y)
    elif hasattr(ours, "_asdict"):
        _assert_same_result(tuple(ours), tuple(theirs))
    else:
        assert ours == theirs


def _same_as_reference(fn, *args):
    """The port's ``native.<fn>(*args)`` outcome; asserts it is the JAX package's. A
    batch decode's quantisation tables are compared in the slots that decoded: both
    packages allocate them with ``np.empty`` and a failed slot's row is unspecified (its
    coefficients are zeroed, its status nonzero, and the caller decodes it again)."""
    ours = _outcome(native, fn, *args)
    theirs = _outcome(ref_native, fn, *args)
    assert ours[0] == theirs[0], (fn, ours[:2], theirs[:2])
    if ours[0] == "raised":
        assert ours[1:] == theirs[1:]
    elif fn == "jpeg_decode_coeffs_batch_native":
        layout, coeffs, qtabs, kmax, status = ours[1]
        decoded = np.asarray(status) == 0
        _assert_same_result((layout, coeffs, kmax, status, qtabs[decoded]),
                            (theirs[1][0], theirs[1][1], theirs[1][3], theirs[1][4],
                             theirs[1][2][decoded]))
    else:
        _assert_same_result(ours[1], theirs[1])
    return ours


def test_fuzz_native_decoder_never_crashes():
    """>=1k mutated streams through layout parse + batch decode: clean rejection or
    successful decode, never a crash; sane shapes; the JAX decoder's outcome each."""
    seeds = _seed_streams()
    rng = np.random.RandomState(99)
    total = 0
    rejected = 0
    for stream in seeds:
        for mut in _mutants(stream, rng, 220):  # 5 seeds x 220 = 1100 streams
            total += 1
            _same_as_reference("jpeg_parse_layout_native", mut)
            got = _same_as_reference("jpeg_decode_coeffs_batch_native", [mut])
            if got[0] == "raised":
                rejected += 1
                continue
            layout, coeffs, qtabs, kmax, status = got[1]
            if int(status[0]) != 0:
                rejected += 1
            for c in coeffs:
                assert c.shape[0] == 1 and c.shape[2] == 64
            assert all(0 <= k <= 63 for k in kmax)
    assert total >= 1000
    # the corpus exercises the rejection paths (and some mutants, e.g. scan-body bit
    # flips, stay decodable, which is fine)
    assert rejected > total * 0.2, (rejected, total)


def test_fuzz_length_field_edge_cases():
    """Targeted DHT/DQT/SOS/DRI length-field edges: zero, 1, 2 (empty payload), max,
    and exactly-past-EOF, on every segment of a baseline and a progressive stream."""
    for stream in _seed_streams()[:2]:
        offsets = _find_markers(stream, {0xC4, 0xDB, 0xDA, 0xDD, 0xC0, 0xC2})
        assert offsets
        for off in offsets:
            for val in (0, 1, 2, 3, 0xFFFF, len(stream) - off):
                b = bytearray(stream)
                b[off + 2], b[off + 3] = (val >> 8) & 0xFF, val & 0xFF
                mut = bytes(b)
                _same_as_reference("jpeg_parse_layout_native", mut)
                _same_as_reference("jpeg_decode_coeffs_batch_native", [mut])


def _sandwich_survivors():
    """``(stream, mutant)`` pairs whose sandwich decoded with every slot checked: the
    JAX file's sandwich loop, each batch also held against the JAX decoder."""
    seeds = _seed_streams()
    rng = np.random.RandomState(7)
    survivors = []
    for stream in (seeds[0], seeds[1]):  # baseline and progressive layouts
        ref_layout, ref_coeffs, ref_qtabs, _, ref_status = \
            native.jpeg_decode_coeffs_batch_native([stream, stream])
        assert (np.asarray(ref_status) == 0).all()
        checked = 0
        for mut in _mutants(stream, rng, 60):
            got = _same_as_reference("jpeg_decode_coeffs_batch_native",
                                     [stream, mut, stream])
            if got[0] == "raised":
                continue  # whole-batch rejection is legal when the mutant poisons
            layout, coeffs, qtabs, kmax, status = got[1]
            checked += 1
            assert int(status[0]) == 0 and int(status[2]) == 0
            for c_ref, c in zip(ref_coeffs, coeffs):
                np.testing.assert_array_equal(c[0], c_ref[0])
                np.testing.assert_array_equal(c[2], c_ref[1])
            np.testing.assert_array_equal(qtabs[0], ref_qtabs[0])
            np.testing.assert_array_equal(qtabs[2], ref_qtabs[1])
            if int(status[1]) != 0:
                # a failed mutant's slice is zeroed, not leftover garbage
                for c in coeffs:
                    assert not c[1].any()
            else:
                survivors.append((stream, mut))
        assert checked > 10  # the sandwich ran against many mutants
    return survivors


def test_fuzz_sandwich_no_cross_slice_writes():
    """[good, mutant, good] batch: the good streams' coefficients are BIT-equal to
    decoding them without the mutant, and every batch equals the JAX decoder's."""
    assert _sandwich_survivors()


def _decode_sandwiches(survivors, device):
    out = []
    for stream, mut in survivors:
        planes = port_jpeg.entropy_decode_jpeg_batch([stream, mut, stream])
        out.append(port_jpeg.decode_jpeg_batch(planes, device=device).cpu())
    return out


@pytest.mark.gpu
def test_fuzz_sandwich_survivors_through_the_stage2_kernels_on_the_card(cuda_device):
    """Every sandwich whose mutant still decodes goes through ``decode_jpeg_batch`` on
    the card: ``stage2_planes`` and ``stage2_rgb`` launch, and the pixels equal the CPU
    path bit for bit and the plain versions on the card (``assert_card_matches_plain``)."""
    survivors = _sandwich_survivors()
    before = kernel_launches()
    on_card = _decode_sandwiches(survivors, cuda_device)
    launched = launches_since(before)
    assert launched["stage2_planes"] >= len(survivors), launched
    assert launched["stage2_rgb"] >= len(survivors), launched
    with plain_kernels():
        plain = _decode_sandwiches(survivors, cuda_device)
    cpu = _decode_sandwiches(survivors, CPU)
    for a, b, c in zip(on_card, plain, cpu):
        assert torch.equal(a, c)
        assert_card_matches_plain(a, b)
