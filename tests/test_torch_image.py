"""Port vs reference: petastorm_tpu_torch.ops.image held against petastorm_tpu.ops.image
(Pallas in interpret mode on the CPU) at the tests/test_ops.py tolerances: float32
atol=1e-5, bfloat16 atol=2e-2. The flip is random, so it is held to its contract: each
output is the normalised image or its horizontal mirror."""
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_pool_helpers import _no_leaked_shm_segments  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from petastorm_tpu.ops import image as ref  # noqa: E402
from petastorm_tpu_torch.ops import image as port  # noqa: E402

MEAN = [0.485, 0.456, 0.406]
STD = [0.229, 0.224, 0.225]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(4, 8, 16, 3), (3, 5, 7, 3), (2, 6, 10, 1)])
def test_normalize_float32_matches_reference(shape):
    rng = np.random.RandomState(0)
    imgs = rng.randint(0, 256, shape, dtype=np.uint8)
    c = shape[-1]
    theirs = np.asarray(ref.normalize_images(jnp.asarray(imgs), MEAN[:c], STD[:c],
                                             out_dtype=jnp.float32))
    ours = port.normalize_images(torch.from_numpy(imgs), MEAN[:c], STD[:c],
                                 out_dtype=torch.float32)
    assert ours.dtype == torch.float32 and tuple(ours.shape) == shape
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape", [(3, 5, 7, 3), (4, 8, 16, 3)])  # row 105: not lane-aligned
def test_normalize_bfloat16_matches_reference(shape):
    rng = np.random.RandomState(1)
    imgs = rng.randint(0, 256, shape, dtype=np.uint8)
    theirs = np.asarray(ref.normalize_images(jnp.asarray(imgs), [0.5] * 3, [0.5] * 3),
                        dtype=np.float32)
    ours = port.normalize_images(torch.from_numpy(imgs), [0.5] * 3, [0.5] * 3)
    assert ours.dtype == torch.bfloat16 and tuple(ours.shape) == shape
    np.testing.assert_allclose(ours.float().numpy(), theirs, rtol=0, atol=2e-2)


def test_normalize_and_augment_flip_contract():
    rng = np.random.RandomState(2)
    imgs = rng.randint(0, 256, (16, 4, 6, 3), dtype=np.uint8)
    gen = torch.Generator().manual_seed(0)
    out = port.normalize_and_augment(torch.from_numpy(imgs), [0.0] * 3, [1.0] * 3, gen,
                                     out_dtype=torch.float32).numpy()
    base = imgs.astype(np.float32) / 255.0
    flipped = 0
    for i in range(len(imgs)):
        same = np.allclose(out[i], base[i], atol=1e-5)
        mirror = np.allclose(out[i], base[i][:, ::-1], atol=1e-5)
        assert same or mirror, "image %d is neither original nor flipped" % i
        flipped += mirror and not same
    assert 0 < flipped < len(imgs)  # 16 fair draws: all-or-none has p = 2**-15
    again = port.normalize_and_augment(torch.from_numpy(imgs), [0.0] * 3, [1.0] * 3,
                                       torch.Generator().manual_seed(0),
                                       out_dtype=torch.float32).numpy()
    np.testing.assert_array_equal(out, again)  # the generator alone decides the flips


@pytest.mark.parametrize("out_dtype,atol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("width", [16, 7], ids=["row_multiple_of_16", "row_not_multiple"])
@pytest.mark.parametrize("channels", [1, 3, 4, 5])
def test_plain_with_flips_matches_reference_body(channels, width, out_dtype, atol):
    """The plain version with ``flips`` equals the JAX package's normalize_and_augment body
    (normalize, then select the W-mirrored image) given the same flags, made with numpy."""
    rng = np.random.RandomState(10 + channels)
    imgs = rng.randint(0, 256, (6, 5, width, channels), dtype=np.uint8)
    flags = np.array([1, 0, 1, 1, 0, 0], dtype=bool)
    mean = rng.uniform(0.2, 0.6, channels).tolist()
    std = rng.uniform(0.1, 0.4, channels).tolist()
    jdtype = jnp.float32 if out_dtype == torch.float32 else jnp.bfloat16
    normed = ref.normalize_images(jnp.asarray(imgs), mean, std, out_dtype=jdtype)
    theirs = np.asarray(jnp.where(jnp.asarray(flags)[:, None, None, None],
                                  normed[:, :, ::-1, :], normed), dtype=np.float32)
    ours = port._normalize_plain(torch.from_numpy(imgs), mean, std, out_dtype,
                                 torch.from_numpy(flags))
    assert ours.dtype == out_dtype and tuple(ours.shape) == imgs.shape
    np.testing.assert_allclose(ours.float().numpy(), theirs, rtol=0, atol=atol)
    # the wrapper on a CPU tensor is the plain version, flips included
    wrapped = port.normalize_images(torch.from_numpy(imgs), mean, std, out_dtype,
                                    flips=torch.from_numpy(flags.astype(np.uint8)))
    assert torch.equal(wrapped, ours)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_normalize_and_augment_equals_the_two_step_composition(out_dtype):
    """One pass with flips is bit for bit the normalise-then-flip-and-select composition
    for the same generator state."""
    rng = np.random.RandomState(4)
    imgs = torch.from_numpy(rng.randint(0, 256, (32, 6, 10, 3), dtype=np.uint8))
    fused = port.normalize_and_augment(imgs, MEAN, STD, torch.Generator().manual_seed(7),
                                       out_dtype=out_dtype)
    gen = torch.Generator().manual_seed(7)
    out = port.normalize_images(imgs, MEAN, STD, out_dtype=out_dtype)
    flips = torch.rand(imgs.shape[0], generator=gen) < 0.5
    composed = torch.where(flips[:, None, None, None], out.flip(2), out)
    assert 0 < int(flips.sum()) < imgs.shape[0]
    assert torch.equal(fused, composed)
    unflipped = port.normalize_and_augment(imgs, MEAN, STD, flip=False, out_dtype=out_dtype)
    assert torch.equal(unflipped, out)


@pytest.mark.parametrize("shape,images_off,out_off,out_size,want", [
    ((256, 224, 224, 3), 0, 0, 2, ("bulk", 18)),    # the main path: 18 rows of 672 bytes
    ((256, 224, 224, 3), 0, 0, 4, ("bulk", 12)),    # to float32: 12 rows
    ((2, 5, 16, 3), 0, 0, 2, ("bulk", 10)),         # the tile is capped at the batch's rows
    ((1, 4, 4096, 4), 0, 0, 2, ("bulk", 1)),        # one 16 KiB row a tile
    ((1, 4, 4096, 4), 0, 0, 4, ("vector", 0)),      # its float32 tile overflows shared memory
    ((1, 4, 4097, 4), 0, 0, 2, ("vector", 0)),      # W*C = 16388: not a multiple of 16
    ((4, 8, 7, 3), 0, 0, 4, ("vector", 0)),         # W*C = 21: not a multiple of 16
    ((4, 8, 16, 3), 1, 0, 2, ("scalar", 0)),        # the batch one byte off alignment
    ((4, 8, 16, 3), 16, 8, 4, ("scalar", 0)),       # the output off a 16-byte boundary
    ((4, 8, 16, 16), 32, 0, 2, ("bulk", 32)),       # C = 16, aligned at an offset
])
def test_route_choice(shape, images_off, out_off, out_size, want):
    assert port.choose_route(shape, 0x7f0000000000 + images_off,
                             0x7f1000000000 + out_off, out_size) == want


def test_route_forcing_takes_slower_routes_and_refuses_faster_ones():
    main = (256, 224, 224, 3)
    assert port.choose_route(main, 0, 0, 2, "bulk") == ("bulk", 18)
    assert port.choose_route(main, 0, 0, 2, "vector") == ("vector", 0)
    assert port.choose_route(main, 0, 0, 4, "scalar") == ("scalar", 0)
    assert port.choose_route((4, 8, 7, 3), 0, 0, 2, "scalar") == ("scalar", 0)
    with pytest.raises(ValueError, match="route 'bulk'"):
        port.choose_route((4, 8, 7, 3), 0, 0, 2, "bulk")
    with pytest.raises(ValueError, match="route 'vector'"):
        port.choose_route(main, 1, 0, 2, "vector")
    with pytest.raises(ValueError, match="route 'tma'"):
        port.choose_route(main, 0, 0, 2, "tma")


def test_bulk_tiles_fit_shared_memory():
    for w, c in ((224, 3), (16, 1), (4, 4), (96, 16), (2048, 4), (3072, 4), (5456, 3)):
        for out_size in (2, 4):
            route, rows = port.choose_route((8, 64, w, c), 0, 0, out_size)
            if route == "bulk":
                assert port._bulk_smem(rows, w * c, out_size) <= port.BULK_SMEM_BYTES
                assert rows == 1 or (rows * w * c <= port.BULK_TILE_IN_BYTES and
                                     rows * w * c * out_size <= port.BULK_TILE_OUT_BYTES)
                assert rows == 8 * 64 or ((rows + 1) * w * c > port.BULK_TILE_IN_BYTES or
                                          (rows + 1) * w * c * out_size
                                          > port.BULK_TILE_OUT_BYTES)


def test_flips_must_match_the_batch():
    imgs = torch.zeros((2, 3, 7, 3), dtype=torch.uint8)
    for bad in (torch.zeros(3, dtype=torch.bool), torch.zeros(2, dtype=torch.float32),
                torch.zeros((2, 1), dtype=torch.uint8)):
        with pytest.raises(ValueError, match="flips"):
            port.normalize_images(imgs, MEAN, STD, flips=bad)


def test_constants_cache_follows_mean_and_std():
    calls = [([0.5, 0.25, 0.125], [0.5, 0.5, 0.25], 3), ((0.1, 0.2, 0.3), (0.3, 0.2, 0.1), 3),
             ([0.5, 0.25, 0.125], [0.5, 0.5, 0.25], 3), (0.5, 0.25, 3), (0.5, 0.25, 1),
             ([0.2] * 4, [0.4] * 4, 4), ([0.5, 0.25, 0.125], [0.5, 0.5, 0.25], 3)]
    for mean, std, channels in calls:
        mean_c, inv_c, mean_p, inv_p = port._cached_constants(mean, std, channels)
        want_m, want_i = port._channel_constants(mean, std, channels)
        np.testing.assert_array_equal(mean_c, want_m)
        np.testing.assert_array_equal(inv_c, want_i)
        assert [mean_p[c] for c in range(channels)] == want_m.tolist()
        assert [inv_p[c] for c in range(channels)] == want_i.tolist()
    # an array-valued mean is not cached, and still right
    mean_c, _inv, _mp, _ip = port._cached_constants(np.array([0.1, 0.2, 0.3]), STD, 3)
    np.testing.assert_array_equal(mean_c, np.array([0.1, 0.2, 0.3], np.float32))
    imgs = torch.from_numpy(np.random.RandomState(5).randint(0, 256, (2, 3, 4, 3),
                                                             dtype=np.uint8))
    first = port.normalize_images(imgs, [0.1, 0.2, 0.3], STD, torch.float32)
    second = port.normalize_images(imgs, [0.3, 0.2, 0.1], STD, torch.float32)
    assert not torch.equal(first, second)
    assert torch.equal(second, port._normalize_plain(imgs, [0.3, 0.2, 0.1], STD,
                                                     torch.float32))


@pytest.mark.gpu
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_normalize_kernel_matches_plain_on_the_card(cuda_device, out_dtype):
    rng = np.random.RandomState(3)
    for shape in ((16, 224, 224, 3), (3, 5, 7, 3)):
        imgs = torch.from_numpy(rng.randint(0, 256, shape, dtype=np.uint8)).to(cuda_device)
        before = port.normalize_images.launches
        out = port.normalize_images(imgs, MEAN, STD, out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert port.normalize_images.launches == before + 1
        assert torch.equal(out, port._normalize_plain(imgs, MEAN, STD, out_dtype))
    # a batch that starts off a 16-byte boundary takes the one-element kernel
    flat = torch.from_numpy(rng.randint(0, 256, 3 * 5 * 7 * 3 + 1, dtype=np.uint8))
    odd = flat.to(cuda_device)[1:].view(3, 5, 7, 3)
    out = port.normalize_images(odd, MEAN, STD, out_dtype=out_dtype)
    assert torch.equal(out, port._normalize_plain(odd, MEAN, STD, out_dtype))


# (shape, byte offset of the batch) for the card: every route the batch allows is held
# against the plain version
_CARD_CASES = {
    "n1": ((1, 224, 224, 3), 0),
    "short_last_tile": ((3, 7, 224, 3), 0),      # 21 rows: tiles of 18, the last of 3
    "n_mod16": ((2, 5, 7, 3), 0),                # 210 elements: 210 % 16 != 0
    "one_byte_off": ((3, 8, 32, 3), 1),
    "c16": ((4, 6, 10, 16), 0),
    "c1": ((5, 9, 48, 1), 0),
    "c4": ((3, 11, 20, 4), 0),
    "c5_wide": ((2, 13, 48, 5), 0),              # generic C through the bulk route
    "main_path": ((256, 224, 224, 3), 0),
    # one 12 KiB row a tile, one block an SM and 140 rows: the tile count, rounded up to
    # a multiple of the grid, exceeds the rows, so some bulk tiles are empty
    "empty_tiles": ((2, 70, 3072, 4), 0),
}


def _card_params():
    for name, (shape, off) in sorted(_CARD_CASES.items()):
        for out_dtype, size in ((torch.float32, 4), (torch.bfloat16, 2),
                                (torch.float16, 2)):
            best = port.choose_route(shape, off, 0, size)[0]
            for route in port.ROUTES[port.ROUTES.index(best):]:
                yield pytest.param(name, route, out_dtype,
                                   id="%s-%s-%s" % (name, route, str(out_dtype)[6:]))


@pytest.mark.gpu
@pytest.mark.parametrize("with_flips", [False, True], ids=["plain", "flips"])
@pytest.mark.parametrize("case,route,out_dtype", list(_card_params()))
def test_every_route_equals_plain_on_the_card(cuda_device, case, route, out_dtype,
                                              with_flips):
    shape, off = _CARD_CASES[case]
    rng = np.random.RandomState(zlib.crc32(case.encode()))
    n = int(np.prod(shape))
    flat = torch.from_numpy(rng.randint(0, 256, n + off, dtype=np.uint8)).to(cuda_device)
    imgs = flat[off:].view(shape)
    c = shape[-1]
    mean = rng.uniform(0.2, 0.6, c).tolist()
    std = rng.uniform(0.1, 0.4, c).tolist()
    flips = None
    if with_flips:
        flips = torch.from_numpy(rng.randint(0, 2, shape[0]).astype(bool)).to(cuda_device)
        flips[0] = True
    before = dict(port.normalize_images.routes)
    out = port.normalize_images(imgs, mean, std, out_dtype, flips=flips, route=route)
    torch.cuda.synchronize()
    assert port.normalize_images.routes[route] == before[route] + 1
    assert torch.equal(out, port._normalize_plain(imgs, mean, std, out_dtype, flips))


@pytest.mark.gpu
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16, torch.float16],
                         ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("with_flips", [False, True], ids=["plain", "flips"])
def test_non_contiguous_batch_equals_plain_on_the_card(cuda_device, out_dtype, with_flips):
    """A crop's view (not contiguous) goes through K2 after one contiguous copy and
    equals the plain version on the same view (max abs error 0)."""
    rng = np.random.RandomState(30)
    for shape, cut in (((2, 8, 8, 3), (slice(1, 7), slice(1, 7))),
                       ((4, 230, 230, 3), (slice(3, 227), slice(2, 226)))):
        x = torch.from_numpy(rng.randint(0, 256, shape, dtype=np.uint8)).to(cuda_device)
        view = x[:, cut[0], cut[1], :]
        assert not view.is_contiguous()
        flips = None
        if with_flips:
            flips = torch.from_numpy(rng.randint(0, 2, shape[0]).astype(bool)).to(cuda_device)
        before = port.normalize_images.launches
        out = port.normalize_images(view, MEAN, STD, out_dtype, flips=flips)
        torch.cuda.synchronize()
        assert port.normalize_images.launches == before + 1
        assert out.is_contiguous() and tuple(out.shape) == tuple(view.shape)
        assert torch.equal(out, port._normalize_plain(view, MEAN, STD, out_dtype, flips))


@pytest.mark.parametrize("shape", [(4, 8, 16, 3), (3, 5, 7, 3)])
def test_normalize_float16_matches_reference(shape):
    rng = np.random.RandomState(4)
    imgs = rng.randint(0, 256, shape, dtype=np.uint8)
    theirs = np.asarray(ref.normalize_images(jnp.asarray(imgs), MEAN, STD,
                                             out_dtype=jnp.float16), dtype=np.float32)
    ours = port.normalize_images(torch.from_numpy(imgs), MEAN, STD, out_dtype=torch.float16)
    assert ours.dtype == torch.float16 and tuple(ours.shape) == shape
    # both cast the same float32 formula to float16
    np.testing.assert_allclose(ours.float().numpy(), theirs, rtol=0, atol=2e-3)
    plain32 = port._normalize_plain(torch.from_numpy(imgs), MEAN, STD, torch.float32)
    assert torch.equal(ours, plain32.to(torch.float16))


def test_non_contiguous_batch_on_the_cpu_equals_its_copy():
    x = torch.from_numpy(np.random.RandomState(5).randint(0, 256, (2, 8, 8, 3),
                                                          dtype=np.uint8))
    view = x[:, 1:7, 1:7, :]
    for out_dtype in (torch.float32, torch.bfloat16, torch.float16):
        assert torch.equal(port.normalize_images(view, MEAN, STD, out_dtype),
                           port.normalize_images(view.contiguous(), MEAN, STD, out_dtype))


# -- random crop and colour jitter: the draws of the reference's key, handed over --------


def _ref_crop_draws(key, n, h, w, crop_h, crop_w):
    kh, kw = jax.random.split(key)  # as petastorm_tpu.ops.image.random_crop splits it
    return (np.array(jax.random.randint(kh, (n,), 0, h - crop_h + 1)),
            np.array(jax.random.randint(kw, (n,), 0, w - crop_w + 1)))


def _ref_jitter_draws(key, n, spans):
    keys = jax.random.split(key, 3)  # as petastorm_tpu.ops.image.color_jitter splits it
    return [None if not span else np.array(jax.random.uniform(
        k, (n, 1, 1, 1), minval=1.0 - span, maxval=1.0 + span)) for k, span in zip(keys, spans)]


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("crop", [(5, 7), (12, 16), (1, 1)])
def test_crop_equals_reference_given_its_offsets(dtype, crop):
    rng = np.random.RandomState(40)
    imgs = rng.randint(0, 256, (6, 12, 16, 3)).astype(dtype)
    key = jax.random.PRNGKey(7)
    theirs = np.asarray(ref.random_crop(jnp.asarray(imgs), key, *crop))
    tops, lefts = _ref_crop_draws(key, 6, 12, 16, *crop)
    ours = port._crop_at(torch.from_numpy(imgs), torch.from_numpy(tops),
                         torch.from_numpy(lefts), *crop).numpy()
    assert ours.dtype == imgs.dtype and ours.shape == (6,) + crop + (3,)
    np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("spans", [(0.4, 0.4, 0.4), (0.4, 0.0, 0.2), (0.0, 0.3, 0.0)])
def test_jitter_float32_within_1e3_of_reference_given_its_factors(spans):
    """float32 images up to 255: the reductions (image mean, channel mean) sum in another
    order, so the limit is atol 1e-3."""
    rng = np.random.RandomState(41)
    imgs = rng.uniform(0, 255, (5, 9, 11, 3)).astype(np.float32)
    key = jax.random.PRNGKey(8)
    theirs = np.asarray(ref.color_jitter(jnp.asarray(imgs), key, *spans))
    factors = [None if f is None else torch.from_numpy(f)
               for f in _ref_jitter_draws(key, 5, spans)]
    ours = port._jitter_with(torch.from_numpy(imgs), *factors).numpy()
    assert ours.dtype == np.float32
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-3)


def test_jitter_uint8_within_one_of_reference_on_few_pixels():
    """uint8 truncates back after the float32 arithmetic, as the reference does: a value
    within 1e-3 of an integer may land on either side, so the limit is 1 on under 0.1 %
    of the values."""
    rng = np.random.RandomState(42)
    imgs = rng.randint(0, 256, (8, 24, 32, 3), dtype=np.uint8)
    key = jax.random.PRNGKey(9)
    theirs = np.asarray(ref.color_jitter(jnp.asarray(imgs), key))
    factors = [torch.from_numpy(f) for f in _ref_jitter_draws(key, 8, (0.4, 0.4, 0.4))]
    ours = port._jitter_with(torch.from_numpy(imgs), *factors).numpy()
    assert ours.dtype == np.uint8
    diff = np.abs(ours.astype(np.int32) - theirs.astype(np.int32))
    assert diff.max() <= 1
    assert (diff > 0).mean() < 1e-3, "%.5f of the values differ" % (diff > 0).mean()


def test_random_crop_contract():
    """Every crop lies inside its image, the offsets vary, and the generator alone
    decides them."""
    n, h, w = 64, 20, 30
    pos = torch.arange(n * h * w, dtype=torch.int64).view(n, h, w, 1)
    out = port.random_crop(pos, torch.Generator().manual_seed(1), 7, 11)
    assert tuple(out.shape) == (n, 7, 11, 1)
    flat = out[..., 0]
    img = flat // (h * w)
    row = (flat % (h * w)) // w
    col = flat % w
    assert torch.equal(img, torch.arange(n)[:, None, None].expand(n, 7, 11))
    tops, lefts = row[:, 0, 0], col[:, 0, 0]
    assert (row == tops[:, None, None] + torch.arange(7)[None, :, None]).all()
    assert (col == lefts[:, None, None] + torch.arange(11)[None, None, :]).all()
    assert tops.min() >= 0 and tops.max() <= h - 7 and lefts.min() >= 0 \
        and lefts.max() <= w - 11
    assert len(set(tops.tolist())) > 1 and len(set(lefts.tolist())) > 1
    again = port.random_crop(pos, torch.Generator().manual_seed(1), 7, 11)
    assert torch.equal(out, again)
    with pytest.raises(ValueError):
        port.random_crop(pos, None, h + 1, 2)


def test_color_jitter_contract():
    """The factors lie in [1 - x, 1 + x]: a constant image shows the brightness factor
    alone (contrast and saturation leave a constant image as it is); the dtype stays."""
    n = 256
    imgs = torch.full((n, 2, 3, 3), 100.0)
    out = port.color_jitter(imgs, torch.Generator().manual_seed(2), 0.4, 0.4, 0.4)
    assert out.dtype == torch.float32
    factor = out[:, 0, 0, 0] / 100.0
    assert factor.min() >= 0.6 - 1e-6 and factor.max() <= 1.4 + 1e-6
    assert factor.min() < 0.7 and factor.max() > 1.3  # spread over the range
    assert torch.allclose(out, factor[:, None, None, None] * 100.0)
    u8 = port.color_jitter(imgs.to(torch.uint8), torch.Generator().manual_seed(2))
    assert u8.dtype == torch.uint8 and tuple(u8.shape) == (n, 2, 3, 3)
    assert torch.equal(port.color_jitter(imgs, torch.Generator().manual_seed(2), 0, 0, 0),
                       imgs)
