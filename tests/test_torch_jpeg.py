"""Port vs reference: two-stage JPEG decode in petastorm_tpu_torch.ops.jpeg held against
petastorm_tpu.ops.jpeg (the JAX package, Pallas in interpret mode on the CPU).

Stage 1 must give bit-identical coefficients and quantisation tables; stage 2 must give
bit-identical uint8 pixels (the plain float32 IDCT on the CPU agrees with the reference's
to ~1e-5, far from any rounding boundary of these inputs); the raw IDCT output is held
to atol=1e-4 in float32. The CUDA kernels are held against their plain versions by the
`gpu`-marked tests, which skip without a card."""
import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
torch = pytest.importorskip("torch")

from petastorm_tpu.ops import jpeg as ref  # noqa: E402
from petastorm_tpu_torch.ops import jpeg as port  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _encode(img, quality, sampling=None, progressive=False):
    params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    if sampling is not None:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sampling]
    if progressive:
        params += [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
    ok, enc = cv2.imencode(".jpg", img, params)
    assert ok
    return enc.tobytes()


def _image(rng, shape):
    noise = rng.randint(0, 256, shape).astype(np.float32)
    return cv2.GaussianBlur(noise, (5, 5), 1.5).clip(0, 255).astype(np.uint8)


def _streams():
    """Mixed qualities, 4:2:0, 4:4:4, grayscale, odd sizes and a progressive stream."""
    rng = np.random.RandomState(11)
    return [
        _encode(_image(rng, (48, 64, 3)), 75),
        _encode(_image(rng, (48, 64, 3)), 95),
        _encode(_image(rng, (48, 64, 3)), 85, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444),
        _encode(_image(rng, (48, 64)), 90),
        _encode(_image(rng, (17, 19, 3)), 80),
        _encode(_image(rng, (40, 56, 3)), 85, progressive=True),
    ]


def _to_port(planes):
    return port.planes_from_arrays(planes.height, planes.width, [
        (c.blocks, c.qtable, c.h_samp, c.v_samp) for c in planes.components])


def _assert_same_planes(a, b):
    assert (a.height, a.width) == (b.height, b.width)
    assert len(a.components) == len(b.components)
    for ca, cb in zip(a.components, b.components):
        assert (ca.h_samp, ca.v_samp) == (cb.h_samp, cb.v_samp)
        np.testing.assert_array_equal(np.asarray(ca.blocks, np.int32),
                                      np.asarray(cb.blocks, np.int32))
        np.testing.assert_array_equal(ca.qtable, cb.qtable)


@pytest.mark.parametrize("index", range(6))
def test_stage1_native_bit_identical_to_reference(index):
    data = _streams()[index]
    _assert_same_planes(port.entropy_decode_jpeg_fast(data),
                        ref.entropy_decode_jpeg_fast(data))


def test_stage1_batch_bit_identical_to_reference():
    rng = np.random.RandomState(12)
    blobs = [_encode(_image(rng, (32, 48, 3)), q) for q in (70, 85, 95)]
    blobs.append(_encode(_image(rng, (32, 48, 3)), 85, progressive=True))
    ours = port.entropy_decode_jpeg_batch(blobs)
    theirs = ref.entropy_decode_jpeg_batch(blobs)
    for a, b in zip(ours, theirs):
        _assert_same_planes(a, b)
        assert a.kmax == b.kmax


def test_python_oracle_bit_identical_to_reference():
    for data in _streams()[:5]:  # the Python oracle is baseline-only, as the reference's
        _assert_same_planes(port.entropy_decode_jpeg(data), ref.entropy_decode_jpeg(data))
    with pytest.raises(ValueError, match="progressive|Unsupported"):
        port.entropy_decode_jpeg(_streams()[5])


def test_idct_blocks_plain_matches_reference():
    rng = np.random.RandomState(3)
    coeffs = rng.randint(-256, 256, (700, 64)).astype(np.int32)
    qtable = rng.randint(1, 64, 64).astype(np.int32)
    theirs = np.asarray(ref.idct_blocks(coeffs, qtable))
    ours = port.idct_blocks(torch.from_numpy(coeffs), torch.from_numpy(qtable)).numpy()
    assert ours.shape == (700, 64) and ours.dtype == np.float32
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-4)


@pytest.mark.parametrize("cut", [None, (1, 129, 77)])
def test_idct_segments_plain_equal_reference_per_component(cut):
    """The multi-segment K1 wrapper (its plain version on the CPU) against the
    reference's ``_idct_scaled`` (Pallas, interpret mode) on each segment: the
    dequantised components of a batch of real JPEGs, whole or cut to uneven lengths."""
    rng = np.random.RandomState(16)
    blobs = [_encode(_image(rng, (64, 96, 3)), q) for q in (75, 85, 95)]
    coeffs, qtabs = port.stack_jpeg_coefficients(port.entropy_decode_jpeg_batch(blobs))
    scaled = [(c.astype(np.float32) * q.astype(np.float32)[:, None, :]).reshape(-1, 64)
              for c, q in zip(coeffs, qtabs)]
    if cut is not None:
        scaled = [a[:n] for a, n in zip(scaled, cut)]
    ours = port.idct_scaled_segments([torch.from_numpy(a) for a in scaled])
    assert [tuple(o.shape) for o in ours] == [a.shape for a in scaled]
    for got, a in zip(ours, scaled):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(ref._idct_scaled(a)), rtol=0,
                                   atol=1e-4)
        assert torch.equal(got, port.idct_scaled(torch.from_numpy(a)))


def test_idct_segments_refuses_what_the_kernel_does_not_take():
    rows = torch.zeros(4, 64)
    with pytest.raises(ValueError):
        port.idct_scaled_segments([])
    with pytest.raises(ValueError):
        port.idct_scaled_segments([rows] * 5)
    with pytest.raises(TypeError):
        port.idct_scaled_segments([rows, rows.double()])


def test_batched_stage2_makes_one_idct_call_a_batch(monkeypatch):
    """Stage 2 hands all of a batch's components to K1's wrapper in one call, and stays
    bit-identical to the reference."""
    rng = np.random.RandomState(15)
    blobs = [_encode(_image(rng, (48, 64, 3)), q) for q in (75, 85, 95)]
    calls = []
    real = port.idct_scaled_segments

    def counting(segments):
        calls.append([tuple(t.shape) for t in segments])
        return real(segments)

    monkeypatch.setattr(port, "idct_scaled_segments", counting)
    ours = port.decode_jpeg_batch(port.entropy_decode_jpeg_batch(blobs), device=CPU)
    theirs = np.asarray(ref.decode_jpeg_batch(ref.entropy_decode_jpeg_batch(blobs)))
    np.testing.assert_array_equal(ours.numpy(), theirs)
    assert calls == [[(3 * 48, 64), (3 * 12, 64), (3 * 12, 64)]]


@pytest.mark.parametrize("index", range(6))
def test_device_stage_bit_identical_to_reference(index):
    planes = ref.entropy_decode_jpeg_fast(_streams()[index])
    theirs = np.asarray(ref.decode_jpeg_device_stage(planes))
    ours = port.decode_jpeg_device_stage(_to_port(planes), CPU).numpy()
    assert ours.dtype == np.uint8
    np.testing.assert_array_equal(ours, theirs)


def test_batch_mixed_layouts_bit_identical_and_in_input_order():
    rng = np.random.RandomState(13)
    shape = (32, 48)
    blobs = [
        _encode(_image(rng, shape + (3,)), 80),
        _encode(_image(rng, shape), 90),
        _encode(_image(rng, shape + (3,)), 90, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444),
        _encode(_image(rng, shape + (3,)), 95),
        _encode(_image(rng, shape), 70),
    ]
    planes = [ref.entropy_decode_jpeg_fast(b) for b in blobs]
    theirs = np.asarray(ref.decode_jpeg_batch(planes))
    ours = port.decode_jpeg_batch([_to_port(p) for p in planes], device=CPU).numpy()
    assert ours.shape == (5,) + shape + (3,)
    np.testing.assert_array_equal(ours, theirs)
    for i, p in enumerate(planes):
        np.testing.assert_array_equal(
            ours[i], port.decode_jpeg_device_stage(_to_port(p), CPU).numpy())
    bgr = port.decode_jpeg_batch([_to_port(p) for p in planes], device=CPU, bgr=True)
    np.testing.assert_array_equal(bgr.numpy(), theirs[..., ::-1])


def test_batch_from_rowgroup_stage1_views_bit_identical():
    rng = np.random.RandomState(14)
    blobs = [_encode(_image(rng, (48, 64, 3)), q) for q in (75, 85, 90, 95)]
    ours_planes = port.entropy_decode_jpeg_batch(blobs)
    theirs = np.asarray(ref.decode_jpeg_batch(ref.entropy_decode_jpeg_batch(blobs)))
    # consecutive rows (slice of the parent buffers) and a gather (shuffled rows)
    np.testing.assert_array_equal(
        port.decode_jpeg_batch(ours_planes, device=CPU).numpy(), theirs)
    order = [2, 0, 3, 1]
    np.testing.assert_array_equal(
        port.decode_jpeg_batch([ours_planes[i] for i in order], device=CPU).numpy(),
        theirs[order])


def test_batch_rejects_mixed_sizes():
    rng = np.random.RandomState(8)
    planes = [port.entropy_decode_jpeg_fast(_encode(_image(rng, s), 90))
              for s in ((32, 32, 3), (48, 32, 3))]
    with pytest.raises(ValueError, match="uniform image size"):
        port.decode_jpeg_batch(planes, device=CPU)


def test_codec_device_decode_matches_reference_codec():
    """BGR order for colour fields, one channel for 2-D fields, and host-decoded rows
    merged back at their positions — as the reference codec."""
    from petastorm_tpu.codecs import CompressedImageCodec as RefCodec
    from petastorm_tpu.unischema import UnischemaField as RefField
    from petastorm_tpu_torch.codecs import CompressedImageCodec
    from petastorm_tpu_torch.unischema import UnischemaField

    rng = np.random.RandomState(15)
    color = [_encode(_image(rng, (32, 48, 3)), q) for q in (80, 90, 95)]
    host_row = _image(rng, (32, 48, 3))  # stands in for a stream stage 1 refused
    field = UnischemaField("image", np.uint8, (32, 48, 3), CompressedImageCodec("jpeg"))
    ref_field = RefField("image", np.uint8, (32, 48, 3), RefCodec("jpeg"))
    ours_staged = [port.entropy_decode_jpeg_fast(color[0]), host_row,
                   port.entropy_decode_jpeg_fast(color[1]),
                   port.entropy_decode_jpeg_fast(color[2])]
    theirs_staged = [ref.entropy_decode_jpeg_fast(color[0]), host_row,
                     ref.entropy_decode_jpeg_fast(color[1]),
                     ref.entropy_decode_jpeg_fast(color[2])]
    ours = field.codec.device_decode_batch(field, ours_staged, CPU).numpy()
    theirs = np.asarray(ref_field.codec.device_decode_batch(ref_field, theirs_staged))
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(ours[1], host_row)

    gray = [_encode(_image(rng, (32, 48)), 90), color[0]]
    gfield = UnischemaField("g", np.uint8, (32, 48), CompressedImageCodec("jpeg"))
    ref_gfield = RefField("g", np.uint8, (32, 48), RefCodec("jpeg"))
    ours = gfield.codec.device_decode_batch(
        gfield, [port.entropy_decode_jpeg_fast(b) for b in gray], CPU).numpy()
    theirs = np.asarray(ref_gfield.codec.device_decode_batch(
        ref_gfield, [ref.entropy_decode_jpeg_fast(b) for b in gray]))
    assert ours.shape == (2, 32, 48)
    np.testing.assert_array_equal(ours, theirs)


def test_codec_host_stage_falls_back_to_host_decode_and_counts_it():
    from petastorm_tpu_torch import codecs
    from petastorm_tpu_torch.unischema import UnischemaField

    field = UnischemaField("image", np.uint8, (16, 16, 3),
                           codecs.CompressedImageCodec("jpeg"))
    rng = np.random.RandomState(16)
    ok, png = cv2.imencode(".png", _image(rng, (16, 16, 3)))  # stage 1 refuses: no SOI
    good = _encode(_image(rng, (16, 16, 3)), 90)
    codecs.host_decoded_rows(reset=True)
    out = field.codec.host_stage_decode_batch(field, [good, None, png.tobytes()])
    assert isinstance(out[0], port.JpegPlanes) and out[1] is None
    assert isinstance(out[2], np.ndarray) and out[2].shape == (16, 16, 3)
    assert codecs.host_decoded_rows() == 1


@pytest.mark.gpu
def test_idct_kernel_matches_plain_on_the_card(cuda_device):
    rng = np.random.RandomState(21)
    blobs = [_encode(_image(rng, (224, 224, 3)), 85) for _ in range(8)]
    coeffs, qtabs = port.stack_jpeg_coefficients(port.entropy_decode_jpeg_batch(blobs))
    for coef, qtab in zip(coeffs, qtabs):
        scaled = (torch.from_numpy(coef).float()
                  * torch.from_numpy(qtab).float()[:, None, :]).reshape(-1, 64)
        scaled = scaled.to(cuda_device)
        before = port.idct_scaled_segments.launches
        out = port.idct_scaled(scaled)
        torch.cuda.synchronize()
        assert port.idct_scaled_segments.launches == before + 1
        plain = port._idct_scaled_plain(scaled)
        assert (out - plain).abs().max().item() <= 1e-3
        assert torch.equal(torch.clamp(torch.round(out), 0, 255),
                           torch.clamp(torch.round(plain), 0, 255))


@pytest.mark.gpu
def test_batched_decode_on_the_card_equals_cpu(cuda_device):
    rng = np.random.RandomState(22)
    blobs = [_encode(_image(rng, (64, 48, 3)), q) for q in (75, 85, 95)]
    planes = port.entropy_decode_jpeg_batch(blobs)
    on_card = port.decode_jpeg_batch(planes, device=cuda_device).cpu()
    np.testing.assert_array_equal(on_card.numpy(),
                                  port.decode_jpeg_batch(planes, device=CPU).numpy())


@pytest.mark.gpu
def test_idct_segments_kernel_matches_plain_on_the_card(cuda_device):
    """One launch over a batch's three components, cut to uneven lengths (partial
    128-row tiles included), equals the plain version per segment."""
    rng = np.random.RandomState(23)
    blobs = [_encode(_image(rng, (224, 224, 3)), 85) for _ in range(8)]
    coeffs, qtabs = port.stack_jpeg_coefficients(port.entropy_decode_jpeg_batch(blobs))
    scaled = [(torch.from_numpy(c).float() * torch.from_numpy(q).float()[:, None, :])
              .reshape(-1, 64)[:n].contiguous().to(cuda_device)
              for c, q, n in zip(coeffs, qtabs, (6272, 1568 - 31, 1))]
    before = port.idct_scaled_segments.launches
    outs = port.idct_scaled_segments(scaled)
    torch.cuda.synchronize()
    assert port.idct_scaled_segments.launches == before + 1
    for out, seg in zip(outs, scaled):
        plain = port._idct_scaled_plain(seg)
        assert (out - plain).abs().max().item() <= 1e-3
        assert torch.equal(torch.clamp(torch.round(out), 0, 255),
                           torch.clamp(torch.round(plain), 0, 255))
