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

from _torch_pool_helpers import _no_leaked_shm_segments  # noqa: E402,F401

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
    """Stage 2 hands all of a batch's components to ``stage2_planes_segments`` in one
    call (the IDCT's one call a batch lives there now) and their planes to ``stage2_rgb``
    in one call, and stays bit-identical to the reference."""
    rng = np.random.RandomState(15)
    blobs = [_encode(_image(rng, (48, 64, 3)), q) for q in (75, 85, 95)]
    calls = []
    real_planes, real_rgb = port.stage2_planes_segments, port.stage2_rgb

    def counting_planes(segments):
        calls.append(("planes", [(seg.by, seg.bx) for seg in segments]))
        return real_planes(segments)

    def counting_rgb(planes, layout, bgr=False):
        calls.append(("rgb", [tuple(p.shape) for p in planes]))
        return real_rgb(planes, layout, bgr)

    monkeypatch.setattr(port, "stage2_planes_segments", counting_planes)
    monkeypatch.setattr(port, "stage2_rgb", counting_rgb)
    ours = port.decode_jpeg_batch(port.entropy_decode_jpeg_batch(blobs), device=CPU)
    theirs = np.asarray(ref.decode_jpeg_batch(ref.entropy_decode_jpeg_batch(blobs)))
    np.testing.assert_array_equal(ours.numpy(), theirs)
    assert calls == [("planes", [(6, 8), (3, 4), (3, 4)]),
                     ("rgb", [(3, 48, 64), (3, 24, 32), (3, 24, 32)])]


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
    # the reference's message, which names the option that lifts the requirement
    with pytest.raises(ValueError, match=r"resize_to=\(h, w\) \(DataLoader\("
                                         r"device_decode_resize=\.\.\.\)\)"):
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
@pytest.mark.parametrize("index", range(6))
def test_per_image_stage_launches_the_unpack_and_idct_a_component_on_the_card(
        cuda_device, index):
    """The per-image stage 2 is the standalone kernels' path: native (int16) coefficients
    dequantise through one unpack launch a component, then one K1 launch; the Python
    oracle's int32 coefficients take the torch dequantisation. Equal to the CPU path."""
    data = _streams()[index]
    planes = port.entropy_decode_jpeg_fast(data)
    u0, k0 = port.unpack_dequant_segments.launches, port.idct_scaled_segments.launches
    on_card = port.decode_jpeg_device_stage(planes, cuda_device).cpu()
    ncomp = len(planes.components)
    assert port.unpack_dequant_segments.launches == u0 + ncomp
    assert port.idct_scaled_segments.launches == k0 + ncomp
    assert torch.equal(on_card, port.decode_jpeg_device_stage(planes, CPU))
    if index < 5:  # baseline: the oracle's int32 blocks skip the unpack, same pixels
        oracle = port.entropy_decode_jpeg(data)
        u0 = port.unpack_dequant_segments.launches
        assert torch.equal(port.decode_jpeg_device_stage(oracle, cuda_device).cpu(),
                           on_card)
        assert port.unpack_dequant_segments.launches == u0


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


# -- the narrowed coefficient transfer ------------------------------------------------
#
# Both packages keep the transfer choice in process-global sticky state, so every test
# below starts from a fresh state in both (``fresh_transfer_state``).


def _reset_transfer_state(mod):
    with mod._STICKY_KS_LOCK:
        mod._STICKY_KS.clear()
        mod._STICKY_SPLIT.clear()
        mod._PACK12_DISABLED.clear()
        mod._SPLIT_DISABLED.clear()
        mod._TRANSFER_BYTES.update(shipped=0, raw=0)


@pytest.fixture
def fresh_transfer_state():
    _reset_transfer_state(port)
    _reset_transfer_state(ref)
    yield
    _reset_transfer_state(port)
    _reset_transfer_state(ref)


def _smooth(rng, shape=(40, 56, 3), quality=85):
    img = cv2.GaussianBlur(rng.randint(0, 256, shape).astype(np.float32), (9, 9), 3.0)
    return _encode(img.clip(0, 255).astype(np.uint8), quality)


def _sharp(rng, shape=(40, 56, 3), quality=95):
    return _encode(rng.randint(0, 256, shape).astype(np.uint8), quality)


def _spy_variants(monkeypatch):
    """Record the (ks, packed, split) each port stage-2 group was handed."""
    seen = []
    real = port._batched_stage2

    def spy(layout, coeffs, qtabs, ks=None, packed=None, split=None, bgr=False):
        seen.append((ks, packed, split))
        return real(layout, coeffs, qtabs, ks, packed, split, bgr)

    monkeypatch.setattr(port, "_batched_stage2", spy)
    return seen


def _disable(mod, table, layout, ncomp):
    with mod._STICKY_KS_LOCK:
        getattr(mod, table).update((layout, ci) for ci in range(ncomp))


def _variant_case(case, monkeypatch):
    """Force one transfer variant in both packages by content and sticky state; returns
    the batch's blobs and the check the chosen variant must pass."""
    from petastorm_tpu.ops import native as ref_native
    from petastorm_tpu_torch.ops import native as port_native

    rng = np.random.RandomState(60)
    smooth = [_smooth(rng) for _ in range(4)]
    sharp = [_sharp(rng) for _ in range(4)]
    layout = port._layout_key(port.entropy_decode_jpeg_batch(smooth)[0])
    blobs = {"int16": sharp, "truncated_int16": smooth, "pack12_natural": sharp,
             "pack12_zigzag": smooth, "split_truncated": smooth, "split_k64": sharp,
             "pack12_overflow": smooth, "split_overflow": sharp}[case]
    no_split = ("int16", "truncated_int16", "pack12_natural", "pack12_zigzag",
                "pack12_overflow")
    if case in no_split:
        for mod in (port, ref):
            _disable(mod, "_SPLIT_DISABLED", layout, 3)
    if case in ("int16", "truncated_int16"):
        for mod in (port, ref):
            _disable(mod, "_PACK12_DISABLED", layout, 3)
    if case == "pack12_overflow":
        monkeypatch.setattr(ref_native, "jpeg_pack12_native", lambda src: None)
        monkeypatch.setattr(port_native, "jpeg_pack12_native", lambda src, out=None: None)
    if case == "split_overflow":
        monkeypatch.setattr(ref_native, "jpeg_pack_split_native",
                            lambda src, k1, k2, is_zigzag=False: None)
        monkeypatch.setattr(port_native, "jpeg_pack_split_native",
                            lambda src, k1, k2, is_zigzag=False, out=None: None)

    def check(ks, packed, split):
        truncated = ks is not None
        if case in ("int16", "pack12_overflow"):
            assert not truncated or case == "pack12_overflow"
            assert not any(packed) and not any(split)
        elif case == "truncated_int16":
            assert truncated and not any(packed) and not any(split)
        elif case == "pack12_natural":
            assert not truncated and all(packed) and not any(split)
        elif case == "pack12_zigzag":
            assert truncated and all(packed) and not any(split)
        elif case == "split_truncated":
            assert truncated and any(split)
        elif case == "split_k64":
            assert not truncated and any(split)
        elif case == "split_overflow":
            assert all(packed) and not any(split)
        if case == "pack12_overflow":
            with port._STICKY_KS_LOCK:
                assert {(layout, ci) for ci in range(3)} <= port._PACK12_DISABLED
        if case == "split_overflow":
            with port._STICKY_KS_LOCK:
                assert any(key[0] == layout for key in port._SPLIT_DISABLED)

    return blobs, check


VARIANT_CASES = ["int16", "truncated_int16", "pack12_natural", "pack12_zigzag",
                 "split_truncated", "split_k64", "pack12_overflow", "split_overflow"]


@pytest.mark.parametrize("case", VARIANT_CASES)
def test_every_transfer_variant_bit_identical_to_reference(case, monkeypatch,
                                                           fresh_transfer_state):
    """Each transfer variant, forced by content or sticky state in both packages, gives
    uint8 pixels bit-identical to the reference's decode of the same stage-1 planes, and
    both packages count the same shipped and raw bytes."""
    blobs, check = _variant_case(case, monkeypatch)
    seen = _spy_variants(monkeypatch)
    ours = port.decode_jpeg_batch(port.entropy_decode_jpeg_batch(blobs), device=CPU)
    theirs = np.asarray(ref.decode_jpeg_batch(ref.entropy_decode_jpeg_batch(blobs)))
    assert len(seen) == 1
    check(*seen[0])
    assert ours.dtype == torch.uint8
    np.testing.assert_array_equal(ours.numpy(), theirs)
    counters = port.transfer_byte_counters()
    assert counters == ref.transfer_byte_counters()
    assert counters["raw"] == sum(c.blocks.size * 2 for b in blobs
                                  for c in port.entropy_decode_jpeg_fast(b).components)
    if case == "int16":
        assert counters["shipped"] == counters["raw"]
    else:
        assert counters["shipped"] < counters["raw"]


def test_group_without_specmax_profiles_the_stacked_batch(monkeypatch,
                                                          fresh_transfer_state):
    """Rows from the per-image stage 1 carry no kmax or specmax: truncation turns off for
    their group and the split profiles the stacked batch, as in the reference; pixels
    bit-identical, counters equal."""
    rng = np.random.RandomState(61)
    blobs = [_smooth(rng) for _ in range(3)] + [_sharp(rng) for _ in range(2)]
    seen = _spy_variants(monkeypatch)
    batch = port.entropy_decode_jpeg_batch(blobs[:3])
    loners = [port.entropy_decode_jpeg_fast(b) for b in blobs[3:]]
    assert loners[0].specmax is None and loners[0].kmax is None
    ours = port.decode_jpeg_batch([batch[0], loners[0], batch[1], loners[1], batch[2]],
                                  device=CPU).numpy()
    rbatch = ref.entropy_decode_jpeg_batch(blobs[:3])
    rloners = [ref.entropy_decode_jpeg_fast(b) for b in blobs[3:]]
    theirs = np.asarray(ref.decode_jpeg_batch(
        [rbatch[0], rloners[0], rbatch[1], rloners[1], rbatch[2]]))
    np.testing.assert_array_equal(ours, theirs)
    ks, _packed, split = seen[0]
    assert ks is None and any(split)
    assert port.transfer_byte_counters() == ref.transfer_byte_counters()


def test_sticky_ks_grow_across_batches_and_stay_bit_identical(fresh_transfer_state):
    """A smooth batch then a sharp one of the same layout: the sticky buckets only grow,
    in both packages alike, and every batch stays bit-identical."""
    rng = np.random.RandomState(62)
    for blobs in ([_smooth(rng) for _ in range(3)], [_sharp(rng) for _ in range(3)],
                  [_smooth(rng) for _ in range(3)]):
        ours = port.decode_jpeg_batch(port.entropy_decode_jpeg_batch(blobs), device=CPU)
        theirs = np.asarray(ref.decode_jpeg_batch(ref.entropy_decode_jpeg_batch(blobs)))
        np.testing.assert_array_equal(ours.numpy(), theirs)
        assert port._STICKY_KS == ref._STICKY_KS
        assert port._STICKY_SPLIT == {k: list(v) for k, v in ref._STICKY_SPLIT.items()}
    assert port.transfer_byte_counters() == ref.transfer_byte_counters()


def test_without_native_stage1_ships_full_int16(monkeypatch, fresh_transfer_state):
    """No native decoder: full int16 in natural order, ``raw == shipped``, as the
    reference counts it."""
    from petastorm_tpu_torch.ops import native as port_native

    rng = np.random.RandomState(63)
    blobs = [_smooth(rng) for _ in range(3)]
    planes = port.entropy_decode_jpeg_batch(blobs)
    theirs = np.asarray(ref.decode_jpeg_batch(ref.entropy_decode_jpeg_batch(blobs)))
    seen = _spy_variants(monkeypatch)
    monkeypatch.setattr(port_native, "native_available", lambda: False)
    np.testing.assert_array_equal(port.decode_jpeg_batch(planes, device=CPU).numpy(), theirs)
    assert seen == [(None, None, None)]
    counters = port.transfer_byte_counters()
    assert counters["shipped"] == counters["raw"] > 0


def _ref_unpack_dequant(slabs, qtab, k, packed, split):
    """The reference's stage-2 integer ops (``_batched_stage2``'s ``unpack12``,
    ``unpack4``, pad, unzigzag and dequantise), written in jnp as there."""
    import jax.numpy as jnp

    def unpack12(u8):
        triples = u8.reshape(u8.shape[0], u8.shape[1], -1, 3)
        b0, b1, b2 = (triples[..., i].astype(jnp.int32) for i in range(3))
        pair = jnp.stack([b0 | ((b1 & 0xF) << 8), (b1 >> 4) | (b2 << 4)], axis=-1)
        pair = pair - ((pair & 0x800) << 1)
        return pair.reshape(u8.shape[0], u8.shape[1], -1)

    def unpack4(u8):
        b = u8.astype(jnp.int32)
        pair = jnp.stack([b & 0xF, (b >> 4) & 0xF], axis=-1)
        pair = pair - ((pair & 0x8) << 1)
        return pair.reshape(u8.shape[0], u8.shape[1], -1)

    unzig = np.asarray(ref.UNZIGZAG)
    if split is not None:
        head, mid, tail = (jnp.asarray(a) for a in slabs)
        parts = []
        if head.shape[-1]:
            parts.append(unpack12(head))
        if mid.shape[-1]:
            parts.append(mid.astype(jnp.int32))
        if tail.shape[-1]:
            parts.append(unpack4(tail))
        coef = parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=-1)
        if k < 64:
            coef = jnp.pad(coef, ((0, 0), (0, 0), (0, 64 - k)))
        coef = jnp.take(coef, unzig, axis=-1)
    else:
        coef = jnp.asarray(slabs)
        if packed:
            coef = unpack12(coef)
        if k < 64:
            coef = jnp.pad(coef, ((0, 0), (0, 0), (0, 64 - k)))
            coef = jnp.take(coef, unzig, axis=-1)
    scaled = coef.astype(jnp.float32) * jnp.asarray(qtab).astype(jnp.float32)[:, None, :]
    return np.asarray(scaled.reshape(-1, 64))


def _edge_slabs(rng, n, nb, k, packed, split):
    """Shipped slabs whose values reach their tier's range edges: random bytes (any byte
    pattern is a valid pack) with the extremes planted in the first block."""
    from petastorm_tpu_torch.ops import native

    if split is not None:
        k1, k2 = split
        src = np.zeros((n, nb, k), np.int16)
        src[..., :k1] = rng.randint(-2048, 2048, (n, nb, k1))
        src[..., k1:k2] = rng.randint(-128, 128, (n, nb, k2 - k1))
        src[..., k2:] = rng.randint(-8, 8, (n, nb, k - k2))
        for lo, hi, edges in ((0, k1, (-2048, 2047)), (k1, k2, (-128, 127)),
                              (k2, k, (-8, 7))):
            for j, v in zip(range(lo, hi), edges * k):
                src[0, 0, j] = v
        slabs = native.jpeg_pack_split_native(src, k1, k2, is_zigzag=True)
        assert slabs is not None
        return slabs
    if packed:
        src = rng.randint(-2048, 2048, (n, nb, k)).astype(np.int16)
        src[0, 0, :4] = (-2048, 2047, -1, 0)
        out = native.jpeg_pack12_native(src)
        assert out is not None
        return out
    src = rng.randint(-32768, 32768, (n, nb, k)).astype(np.int16)
    src[0, 0, :2] = (-32768, 32767)
    return src


#: (k, packed, split): every case of the stage-2 unpack
UNPACK_CASES = [(64, False, None), (16, False, None), (32, False, None),
                (64, True, None), (32, True, None), (16, True, None),
                (64, False, (12, 40)), (32, False, (4, 16)), (16, False, (0, 16)),
                (64, False, (0, 0)), (64, False, (64, 64)), (32, False, (32, 32)),
                (16, False, (0, 0)), (64, False, (8, 64))]


@pytest.mark.parametrize("k,packed,split", UNPACK_CASES)
def test_unpack_plain_equals_reference_integer_ops(k, packed, split):
    """``_unpack_dequant_plain`` against the reference's integer ops in jnp on crafted
    slabs at the range edges (12-bit ±2047/-2048, int8 -128..127, 4-bit -8..7; split
    points at 0 and k), with quantisation tables up to 65535: equal exactly."""
    rng = np.random.RandomState(64 + k)
    n, nb = 3, 5
    slabs = _edge_slabs(rng, n, nb, k, packed, split)
    qtab = rng.randint(1, 65536, (n, 64)).astype(np.int32)
    qtab[0, :2] = (1, 65535)
    theirs = _ref_unpack_dequant(slabs, qtab, k, packed, split)
    tslabs = tuple(torch.from_numpy(a) for a in slabs) if split is not None \
        else torch.from_numpy(slabs)
    seg = port.CoefSegment(tslabs, torch.from_numpy(qtab), k, packed, split)
    ours = port._unpack_dequant_plain(seg)
    assert ours.dtype == torch.float32 and tuple(ours.shape) == (n * nb, 64)
    np.testing.assert_array_equal(ours.numpy(), theirs)
    # the wrapper is the plain version on CPU tensors, one segment or several
    outs = port.unpack_dequant_segments([seg, seg])
    assert all(torch.equal(o, ours) for o in outs)


def test_unpack_refuses_what_the_kernel_does_not_take():
    q = torch.ones(2, 64, dtype=torch.int32)
    good = torch.zeros(2, 3, 64, dtype=torch.int16)
    with pytest.raises(ValueError):
        port.unpack_dequant_segments([])
    with pytest.raises(ValueError):
        port.unpack_dequant_segments([port.CoefSegment(good, q, 64, False, None)] * 5)
    with pytest.raises(ValueError, match="qtab"):
        port.unpack_dequant_segments([port.CoefSegment(good, q.to(torch.int64), 64, False,
                                                       None)])
    with pytest.raises(ValueError, match="slab"):  # packed, but int16 bytes
        port.unpack_dequant_segments([port.CoefSegment(good, q, 64, True, None)])
    with pytest.raises(ValueError, match="split"):
        port.unpack_dequant_segments([port.CoefSegment(
            (good, good, good), q, 64, False, (8, 4))])


@pytest.mark.parametrize("packer", ["truncate", "pack12", "specmax", "split"])
def test_packers_give_the_reference_bytes(packer):
    """Each port binding gives the reference binding's bytes on the same arrays, None on
    overflow where the reference gives None, and ``out=`` writes in place."""
    from petastorm_tpu.ops import native as rn
    from petastorm_tpu_torch.ops import native as pn

    rng = np.random.RandomState(65)
    nat = rng.randint(-2048, 2048, (2, 7, 64)).astype(np.int16)
    if packer == "truncate":
        src = nat.copy()
        src[..., 1:] = 0  # past zigzag index 0 every coefficient is zero
        for k in (1, 16, 64):
            out = np.empty((2, 7, k), np.int16)
            got = pn.jpeg_zigzag_truncate_native(nat, k, out=out)
            assert got is out
            np.testing.assert_array_equal(out, rn.jpeg_zigzag_truncate_native(nat, k))
        with pytest.raises(ValueError):
            pn.jpeg_zigzag_truncate_native(nat, 65)
    elif packer == "pack12":
        out = np.empty((2, 7, 96), np.uint8)
        assert pn.jpeg_pack12_native(nat, out=out) is out
        np.testing.assert_array_equal(out, rn.jpeg_pack12_native(nat))
        wide = nat.copy()
        wide[1, 3, 5] = 2048
        assert pn.jpeg_pack12_native(wide) is None and rn.jpeg_pack12_native(wide) is None
        with pytest.raises(ValueError, match="out"):
            pn.jpeg_pack12_native(nat, out=np.empty((2, 7, 95), np.uint8))
    elif packer == "specmax":
        np.testing.assert_array_equal(pn.jpeg_specmax_native(nat),
                                      rn.jpeg_specmax_native(nat))
        zz = nat[..., :32]
        np.testing.assert_array_equal(pn.jpeg_specmax_native(zz, is_zigzag=True),
                                      rn.jpeg_specmax_native(zz, is_zigzag=True))
    else:
        src = np.zeros((2, 7, 32), np.int16)
        src[..., :8] = rng.randint(-2048, 2048, (2, 7, 8))
        src[..., 8:20] = rng.randint(-128, 128, (2, 7, 12))
        src[..., 20:] = rng.randint(-8, 8, (2, 7, 12))
        outs = (np.empty((2, 7, 12), np.uint8), np.empty((2, 7, 12), np.int8),
                np.empty((2, 7, 6), np.uint8))
        got = pn.jpeg_pack_split_native(src, 8, 20, is_zigzag=True, out=outs)
        assert all(g is o for g, o in zip(got, outs))
        for a, b in zip(outs, rn.jpeg_pack_split_native(src, 8, 20, is_zigzag=True)):
            np.testing.assert_array_equal(a, b)
        bad = src.copy()
        bad[0, 0, 25] = 8  # a tail value beyond 4 bits
        assert pn.jpeg_pack_split_native(bad, 8, 20, is_zigzag=True) is None
        assert rn.jpeg_pack_split_native(bad, 8, 20, is_zigzag=True) is None


def test_specmax_and_kmax_survive_detach_and_pickle():
    import pickle

    rng = np.random.RandomState(34)
    row = port.entropy_decode_jpeg_batch([_smooth(rng, (24, 24, 3))])[0]
    assert row.specmax is not None and row.specmax.shape == (3, 64)
    np.testing.assert_array_equal(
        row.specmax, ref.entropy_decode_jpeg_batch([_smooth(np.random.RandomState(34),
                                                           (24, 24, 3))])[0].specmax)
    det = row.detach()
    assert det.batch_ref is None and det.specmax is row.specmax and det.kmax == row.kmax
    back = pickle.loads(pickle.dumps(row))
    assert back.batch_ref is None and back.kmax == row.kmax
    np.testing.assert_array_equal(back.specmax, row.specmax)
    for a, b in zip(back.components, row.components):
        np.testing.assert_array_equal(a.blocks, b.blocks)
    # the pickle carries this row, not its row group's buffers
    group = port.entropy_decode_jpeg_batch([_smooth(rng, (24, 24, 3)) for _ in range(16)])
    assert len(pickle.dumps(group[0])) < len(pickle.dumps(group[0].detach())) * 2


def test_staging_region_fits_every_later_batch_as_ks_grow(fresh_transfer_state):
    """The upload asks a staging pool for the full int16 bound of the batch, which every
    variant fits under: a ring sized by its first request (smooth content, narrow ks)
    takes every later one (sharp content, ks grown) without an oversized copy."""
    rng = np.random.RandomState(66)
    asked = []

    class Recorder:
        def reserve_bytes(self, nbytes):
            asked.append(nbytes)
            host = np.empty(nbytes, np.uint8)
            return host, lambda device, used: torch.from_numpy(host[:used].copy())

    for blobs in ([_smooth(rng) for _ in range(4)], [_sharp(rng) for _ in range(4)]):
        planes = port.entropy_decode_jpeg_batch(blobs)
        # a "cuda" device with a recording stager: the tensors themselves stay on the CPU
        ours = port._stage_groups([(port._layout_key(planes[0]), planes)],
                                  torch.device("cuda"), Recorder())
        assert ours[0][1][0].device.type == "cpu"  # the first table
    assert len(asked) == 2 and asked[1] <= asked[0]
    counters = port.transfer_byte_counters()
    assert counters["shipped"] < counters["raw"]


# -- on-device resize -----------------------------------------------------------------


@pytest.mark.parametrize("src,dst", [((17, 23), (32, 40)), ((48, 64), (21, 29)),
                                     ((33, 31), (33, 57)), ((40, 56), (19, 56))])
def test_resize_within_one_of_reference(src, dst):
    """Bilinear, half-pixel centres, no antialiasing: the port's torch resize against the
    reference's ``jax.image.resize``. The two weigh the taps in another float order, so
    a value near .5 may round the other way: the limit is 1 on uint8 and 0.5 % of the
    values. Seen here: a largest difference of 1, on 0.017 % of the values upscaling
    17x23 and 0.11 % downscaling 48x64; none on the other two shapes (not bit-exact in
    general)."""
    rng = np.random.RandomState(67)
    img = rng.randint(0, 256, (3,) + src + (3,), dtype=np.uint8)
    ours = port.resize_image_batch(torch.from_numpy(img), dst).numpy()
    theirs = np.asarray(ref.resize_image_batch(img, dst))
    assert ours.shape == theirs.shape == (3,) + dst + (3,) and ours.dtype == np.uint8
    diff = np.abs(ours.astype(np.int32) - theirs.astype(np.int32))
    assert diff.max() <= 1
    assert (diff > 0).mean() < 0.005, "%.4f of the values differ" % (diff > 0).mean()


def test_resize_at_the_stored_size_is_the_identity():
    img = torch.from_numpy(np.random.RandomState(68).randint(0, 256, (2, 9, 7, 3),
                                                             dtype=np.uint8))
    assert port.resize_image_batch(img, (9, 7)) is img


def test_mixed_size_batch_with_resize_within_one_of_reference(fresh_transfer_state):
    """Mixed sizes decode group by group at their stored size, resize, and come back in
    input order; the same uniform batch with resize_to at its own size is bit-identical
    to the batch without it."""
    rng = np.random.RandomState(69)
    shapes = [(40, 56, 3), (33, 47, 3), (40, 56, 3), (48, 32), (33, 47, 3)]
    blobs = [_encode(_image(rng, s), 85) for s in shapes]
    ours = port.decode_jpeg_batch([port.entropy_decode_jpeg_fast(b) for b in blobs],
                                  device=CPU, resize_to=(36, 44)).numpy()
    theirs = np.asarray(ref.decode_jpeg_batch([ref.entropy_decode_jpeg_fast(b) for b in blobs],
                                              resize_to=(36, 44)))
    assert ours.shape == (5, 36, 44, 3)
    diff = np.abs(ours.astype(np.int32) - theirs.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01
    same = [blobs[0], blobs[2]]
    planes = port.entropy_decode_jpeg_batch(same)
    np.testing.assert_array_equal(
        port.decode_jpeg_batch(planes, device=CPU, resize_to=(40, 56)).numpy(),
        port.decode_jpeg_batch(planes, device=CPU).numpy())


def test_codec_resizes_host_fallback_rows_with_cv2_like_the_reference():
    from petastorm_tpu.codecs import CompressedImageCodec as RefCodec
    from petastorm_tpu.unischema import UnischemaField as RefField
    from petastorm_tpu_torch.codecs import CompressedImageCodec
    from petastorm_tpu_torch.unischema import UnischemaField

    rng = np.random.RandomState(70)
    blobs = [_encode(_image(rng, s), 90) for s in ((32, 48, 3), (40, 36, 3))]
    host_row = _image(rng, (24, 30, 3))  # stands in for a stream stage 1 refused
    field = UnischemaField("image", np.uint8, (None, None, 3), CompressedImageCodec("jpeg"))
    ref_field = RefField("image", np.uint8, (None, None, 3), RefCodec("jpeg"))
    ours = field.codec.device_decode_batch(
        field, [port.entropy_decode_jpeg_fast(blobs[0]), host_row,
                port.entropy_decode_jpeg_fast(blobs[1])], CPU, resize_to=(28, 28)).numpy()
    theirs = np.asarray(ref_field.codec.device_decode_batch(
        ref_field, [ref.entropy_decode_jpeg_fast(blobs[0]), host_row,
                    ref.entropy_decode_jpeg_fast(blobs[1])], resize_to=(28, 28)))
    assert ours.shape == (3, 28, 28, 3)
    np.testing.assert_array_equal(ours[1], cv2.resize(host_row, (28, 28),
                                                      interpolation=cv2.INTER_LINEAR))
    np.testing.assert_array_equal(ours[1], theirs[1])
    diff = np.abs(ours.astype(np.int32) - theirs.astype(np.int32))
    assert diff.max() <= 1


# -- the unpack kernel on the card ----------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("k,packed,split", UNPACK_CASES)
def test_unpack_kernel_equals_plain_on_the_card(cuda_device, k, packed, split):
    rng = np.random.RandomState(71 + k)
    n, nb = 5, 37
    segs = []
    for _ in range(3):  # one launch over three segments of the same case
        slabs = _edge_slabs(rng, n, nb, k, packed, split)
        tslabs = tuple(torch.from_numpy(a).to(cuda_device) for a in slabs) \
            if split is not None else torch.from_numpy(slabs).to(cuda_device)
        qtab = torch.from_numpy(rng.randint(1, 65536, (n, 64)).astype(np.int32))
        segs.append(port.CoefSegment(tslabs, qtab.to(cuda_device), k, packed, split))
    before = port.unpack_dequant_segments.launches
    outs = port.unpack_dequant_segments(segs)
    torch.cuda.synchronize()
    assert port.unpack_dequant_segments.launches == before + 1
    for out, seg in zip(outs, segs):
        assert torch.equal(out, port._unpack_dequant_plain(seg))


@pytest.mark.gpu
def test_unpack_kernel_mixed_cases_in_one_launch(cuda_device):
    """A group's components differ in variant (a split Y, a packed Cb, an int16 Cr)."""
    rng = np.random.RandomState(72)
    segs = []
    for (k, packed, split), nb in zip([(64, False, (12, 40)), (32, True, None),
                                       (16, False, None)], (24, 6, 6)):
        slabs = _edge_slabs(rng, 4, nb, k, packed, split)
        tslabs = tuple(torch.from_numpy(a).to(cuda_device) for a in slabs) \
            if split is not None else torch.from_numpy(slabs).to(cuda_device)
        qtab = torch.from_numpy(rng.randint(1, 256, (4, 64)).astype(np.int32))
        segs.append(port.CoefSegment(tslabs, qtab.to(cuda_device), k, packed, split))
    outs = port.unpack_dequant_segments(segs)
    for out, seg in zip(outs, segs):
        assert torch.equal(out, port._unpack_dequant_plain(seg))


@pytest.mark.gpu
@pytest.mark.parametrize("case", VARIANT_CASES)
def test_group_is_one_unpack_and_one_idct_launch_on_the_card(cuda_device, case,
                                                             monkeypatch,
                                                             fresh_transfer_state):
    """A layout group on the card is one ``stage2_planes`` launch (the unpack and K1's
    product live there now) and one ``stage2_rgb`` launch; the standalone unpack and K1
    do not launch; the pixels equal the CPU path's."""
    blobs, _check = _variant_case(case, monkeypatch)
    planes = port.entropy_decode_jpeg_batch(blobs)
    cpu = port.decode_jpeg_batch(planes, device=CPU).numpy()
    u0, k0 = port.unpack_dequant_segments.launches, port.idct_scaled_segments.launches
    p0, r0 = port.stage2_planes_segments.launches, port.stage2_rgb.launches
    on_card = port.decode_jpeg_batch(planes, device=cuda_device).cpu().numpy()
    assert port.stage2_planes_segments.launches == p0 + 1
    assert port.stage2_rgb.launches == r0 + 1
    assert port.unpack_dequant_segments.launches == u0
    assert port.idct_scaled_segments.launches == k0
    np.testing.assert_array_equal(on_card, cpu)


@pytest.mark.gpu
def test_mixed_size_resize_on_the_card_equals_cpu(cuda_device, fresh_transfer_state):
    rng = np.random.RandomState(73)
    blobs = [_encode(_image(rng, s), 85) for s in ((40, 56, 3), (33, 47, 3), (40, 56, 3))]
    planes = [port.entropy_decode_jpeg_fast(b) for b in blobs]
    p0, r0 = port.stage2_planes_segments.launches, port.stage2_rgb.launches
    on_card = port.decode_jpeg_batch(planes, device=cuda_device, resize_to=(36, 44)).cpu()
    assert port.stage2_planes_segments.launches == p0 + 2  # one a layout group
    assert port.stage2_rgb.launches == r0 + 2
    cpu = port.decode_jpeg_batch(planes, device=CPU, resize_to=(36, 44))
    diff = (on_card.to(torch.int32) - cpu.to(torch.int32)).abs()
    assert diff.max().item() <= 1
