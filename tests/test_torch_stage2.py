"""Port vs reference: the batched JPEG stage 2 of petastorm_tpu_torch.ops.jpeg
(``stage2_planes_segments``: shipped slabs → range-limited uint8 planes, and
``stage2_rgb``: planes → RGB) held against the JAX package's ``_batched_stage2``
(jitted on the CPU, K1 in interpret mode) and against the reference's own functions
composed in jnp.

Inputs are made with numpy from a seed: per component a zigzag-order coefficient array
whose positions stay within the tiers a split ships (12-bit head, int8 mid, 4-bit tail,
zeros past zigzag 30), shipped in every transfer variant, and per-image quantisation
tables. On the CPU every plain version must be bit-identical to the reference (uint8,
max difference 0). The `gpu` tests hold each kernel to its plain version with
``torch.equal`` and skip without a card."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_pool_helpers import _no_leaked_shm_segments  # noqa: E402,F401

from petastorm_tpu.ops import jpeg as ref  # noqa: E402
from petastorm_tpu_torch.ops import jpeg as port  # noqa: E402

CPU = torch.device("cpu")

#: name → (height, width, per component (h_samp, v_samp, by, bx), images)
LAYOUTS = {
    "420_224": (224, 224, ((2, 2, 28, 28), (1, 1, 14, 14), (1, 1, 14, 14)), 2),
    "420_ragged": (359, 481, ((2, 2, 46, 62), (1, 1, 23, 31), (1, 1, 23, 31)), 2),
    "422": (40, 56, ((2, 1, 5, 8), (1, 1, 5, 4), (1, 1, 5, 4)), 3),
    "444": (40, 56, ((1, 1, 5, 7), (1, 1, 5, 7), (1, 1, 5, 7)), 3),
    "gray": (48, 64, ((1, 1, 6, 8),), 3),
    "411": (32, 64, ((4, 1, 4, 8), (1, 1, 4, 2), (1, 1, 4, 2)), 3),
    "440": (48, 40, ((1, 2, 6, 5), (1, 1, 3, 5), (1, 1, 3, 5)), 3),
    # the kernels' edges: Y 280 blocks (tiles of 128, 128 and a ragged 24), 75 rows (not
    # a multiple of the 16-row band), 107 x 3 bytes a row (not a 16-byte multiple)
    "420_edge": (75, 107, ((2, 2, 10, 14), (1, 1, 5, 7), (1, 1, 5, 7)), 2),
    "420_w359": (40, 359, ((2, 2, 6, 46), (1, 1, 3, 23), (1, 1, 3, 23)), 2),
    "444_odd": (37, 53, ((1, 1, 5, 7), (1, 1, 5, 7), (1, 1, 5, 7)), 4),  # odd bx, 140 blocks
    # too wide for a 16-row band in 64 KB of shared memory: 2-row bands
    "420_wide": (40, 2000, ((2, 2, 6, 250), (1, 1, 3, 125), (1, 1, 3, 125)), 1),
    # too wide for a one-row band: stage2_rgb's row route
    "gray_wide": (8, 26000, ((1, 1, 1, 3250),), 1),
}

#: name → (ks, packed, split), per component (Y, Cb, Cr); a grayscale layout takes Y's
VARIANTS = {
    "int16": (None, None, None),
    "int16_truncated": ((32, 16, 16), None, None),
    "pack12": (None, (True, True, True), None),
    "pack12_truncated": ((32, 16, 16), (True, True, True), None),
    "split": (None, None, ((6, 16), (4, 10), (4, 10))),
    "split_truncated": ((32, 16, 16), None, ((6, 16), (4, 10), (4, 10))),
    "mixed": ((64, 16, 16), (False, True, False), ((6, 16), None, None)),
}

#: variants of the edge cases only: the three kinds in one launch, at k = 64 and cut
EDGE_VARIANTS = {
    "kinds": (None, (False, True, False), ((6, 16), None, None)),
    "kinds_truncated": ((32, 16, 16), (False, True, False), ((6, 16), None, None)),
}

#: every variant on the main path's layout, two on each other layout
CASES = [("420_224", v) for v in VARIANTS] + [
    ("420_ragged", "split"), ("420_ragged", "mixed"),
    ("422", "int16_truncated"), ("422", "pack12"),
    ("444", "pack12_truncated"), ("444", "split_truncated"),
    ("gray", "int16"), ("gray", "split"),
    ("411", "pack12"), ("411", "mixed"),
    ("440", "split"),
]
CASE_IDS = ["%s-%s" % c for c in CASES]

#: per zigzag position, the largest |coefficient| (Y, chroma): within each split's tiers
_Y_RANGE = np.array([120] + [300] * 5 + [100] * 10 + [7] * 14 + [0] * 34)
_C_RANGE = np.array([100] + [200] * 3 + [60] * 6 + [7] * 6 + [0] * 48)


def _pack12(v):
    """(..., 2m) ints → (..., 3m) uint8, the 12-bit pair layout the kernels read."""
    u = (np.asarray(v, np.int32) & 0xFFF).reshape(v.shape[:-1] + (-1, 2))
    lo, hi = u[..., 0], u[..., 1]
    b = np.stack([lo & 0xFF, (lo >> 8) | ((hi & 0xF) << 4), hi >> 4], axis=-1)
    return np.ascontiguousarray(b.reshape(v.shape[:-1] + (-1,)).astype(np.uint8))


def _pack4(v):
    """(..., 2m) ints → (..., m) uint8, 4-bit two's complement, low nibble first."""
    u = (np.asarray(v, np.int32) & 0xF).reshape(v.shape[:-1] + (-1, 2))
    return np.ascontiguousarray((u[..., 0] | (u[..., 1] << 4)).astype(np.uint8))


def _ship(z, k, packed, split):
    """One component's zigzag-order coefficients (n, blocks, 64) as the variant ships
    them: a split's (head, mid, tail), else the zigzag prefix (k < 64) or the natural
    order (k == 64), as int16 or its 12-bit pack."""
    if split is not None:
        k1, k2 = split
        zz = z[..., :k]
        return (_pack12(zz[..., :k1]), np.ascontiguousarray(zz[..., k1:k2].astype(np.int8)),
                _pack4(zz[..., k2:k]))
    src = np.ascontiguousarray(z[..., :k] if k < 64 else z[..., ref.UNZIGZAG])
    return _pack12(src) if packed else src.astype(np.int16)


def _pick(spec, ncomp):
    return None if spec is None else tuple(spec[:ncomp])


def _natural(*positions):
    """A zigzag-order mask (64,) of the given natural positions."""
    keep = np.zeros(64, bool)
    keep[np.asarray(ref.UNZIGZAG)[list(positions)]] = True
    return keep


def _shape_content(z, ci, content):
    """Edge content on one component's zigzag-order coefficients (n, blocks, 64), in
    place: ``zero_tile``: Y's first 128 blocks all zero (a whole tile); ``last_block_hf``:
    natural positions 0 and 9 only, and position 63 non-zero only in Y's block 127 (the
    last of a full tile) and in each component's last block (its ragged last tile), so
    Y's tiles have 3, 2 and 3 active columns; ``odd_active``: natural 0, 1, 2, 8 and 17
    only (5 active columns)."""
    flat = z.reshape(-1, 64)
    if content == "zero_tile":
        if ci == 0:
            flat[:128] = 0
    elif content == "last_block_hf":
        flat[:, ~_natural(0, 9)] = 0
        hf = np.asarray(ref.UNZIGZAG)[63]
        if ci == 0:
            flat[127, hf] = 5
        flat[-1, hf] = -6
    elif content == "odd_active":
        flat[:, ~_natural(0, 1, 2, 8, 17)] = 0
    elif content != "random":
        raise ValueError(content)


@functools.lru_cache(maxsize=None)
def _case(layout_name, variant, content="random"):
    """The case's layout key, variant and numpy inputs: ``(layout, ks, packed, split,
    coeffs, qtabs)`` with ``coeffs`` per component an array or a slab triple."""
    height, width, comps, n = LAYOUTS[layout_name]
    layout = (height, width, comps)
    ncomp = len(comps)
    ks, packed, split = (_pick(s, ncomp) for s in {**VARIANTS, **EDGE_VARIANTS}[variant])
    tag = layout_name + variant + ("" if content == "random" else content)
    rng = np.random.RandomState(sum(map(ord, tag)))
    coeffs, qtabs = [], []
    for ci, (_h, _v, by, bx) in enumerate(comps):
        lim = _Y_RANGE if ci == 0 else _C_RANGE
        z = (rng.randint(-32768, 32768, (n, by * bx, 64)) % (2 * lim + 1) - lim).astype(np.int16)
        _shape_content(z, ci, content)
        k = 64 if ks is None else ks[ci]
        coeffs.append(_ship(z, k, packed is not None and packed[ci],
                            None if split is None else split[ci]))
        qtabs.append(rng.randint(1, 25, (n, 64)).astype(np.int32))
    return layout, ks, packed, split, tuple(coeffs), tuple(qtabs)


def _tensors(coeffs, qtabs, device=CPU):
    tc = [tuple(torch.from_numpy(a).to(device) for a in c) if isinstance(c, tuple)
          else torch.from_numpy(c).to(device) for c in coeffs]
    return tc, [torch.from_numpy(q).to(device) for q in qtabs]


def _segments(case, device=CPU):
    layout, ks, packed, split, coeffs, qtabs = case
    tc, tq = _tensors(coeffs, qtabs, device)
    return [port.CoefSegment(c, q, 64 if ks is None else ks[ci],
                             bool(packed is not None and packed[ci]),
                             None if split is None else split[ci], by, bx)
            for ci, ((_h, _v, by, bx), c, q) in enumerate(zip(layout[2], tc, tq))]


# -- the reference, composed in jnp from its own functions --------------------------------


def _ref_planes(case):
    """The reference's ``_batched_stage2`` up to its range-limited planes
    (``petastorm_tpu/ops/jpeg.py:573-608``): the integer unpack, pad and unzigzag, the
    dequantisation, ``_idct_scaled`` (Pallas, interpret mode), round and clip, the
    block-to-plane transpose."""
    import jax.numpy as jnp

    layout, ks, packed, split, coeffs, qtabs = case

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
    planes = []
    for ci, ((_h, _v, by, bx), coef, qtab) in enumerate(zip(layout[2], coeffs, qtabs)):
        k = 64 if ks is None else ks[ci]
        n = qtab.shape[0]
        if split is not None and split[ci] is not None:
            head, mid, tail = (jnp.asarray(a) for a in coef)
            parts = [p for p, t in ((unpack12(head), head), (mid.astype(jnp.int32), mid),
                                    (unpack4(tail), tail)) if t.shape[-1]]
            c = parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=-1)
            if k < 64:
                c = jnp.pad(c, ((0, 0), (0, 0), (0, 64 - k)))
            c = jnp.take(c, unzig, axis=-1)
        else:
            c = jnp.asarray(coef)
            if packed is not None and packed[ci]:
                c = unpack12(c)
            if k < 64:
                c = jnp.take(jnp.pad(c, ((0, 0), (0, 0), (0, 64 - k))), unzig, axis=-1)
        scaled = c.astype(jnp.float32) * jnp.asarray(qtab).astype(jnp.float32)[:, None, :]
        pix = jnp.clip(jnp.round(ref._idct_scaled(scaled.reshape(-1, 64))), 0.0, 255.0)
        plane = jnp.transpose(pix.reshape(n, by, bx, 8, 8), (0, 1, 3, 2, 4))
        planes.append(np.asarray(plane.reshape(n, by * 8, bx * 8)))
    return planes


def _ref_rgb(planes, layout):
    """The rest of the reference's ``_batched_stage2`` (``jpeg.py:609-618``) on float32
    planes, jitted as there (XLA then fuses the colour's multiply-adds):
    ``_fancy_upsample2`` or a repeat per axis, the crop, ``ycbcr_to_rgb``, round, clip,
    uint8."""
    import jax
    import jax.numpy as jnp

    height, width, comps = layout
    hmax = max(h for h, _v, _by, _bx in comps)
    vmax = max(v for _h, v, _by, _bx in comps)

    def fn(planes):
        full = []
        for (h, v, _by, _bx), plane in zip(comps, planes):
            for axis, r in ((1, vmax // v), (2, hmax // h)):
                if r == 2:
                    plane = ref._fancy_upsample2(plane, axis)
                elif r > 1:
                    plane = jnp.repeat(plane, r, axis=axis)
            full.append(plane[:, :height, :width])
        if len(full) == 1:
            y = jnp.clip(full[0], 0, 255).astype(jnp.uint8)
            return jnp.stack([y, y, y], axis=-1)
        rgb = ref.ycbcr_to_rgb(full[0], full[1], full[2])
        return jnp.clip(jnp.round(rgb), 0, 255).astype(jnp.uint8)

    return np.asarray(jax.jit(fn)([np.asarray(p, np.float32) for p in planes]))


@functools.lru_cache(maxsize=None)
def _reference(layout_name, variant, content="random"):
    """``(planes, rgb)`` of the reference for a case: its planes composed in jnp, and its
    whole jitted ``_batched_stage2``."""
    case = _case(layout_name, variant, content)
    layout, ks, packed, split, coeffs, qtabs = case
    whole = ref._batched_stage2(layout, ks, packed, split)(coeffs, qtabs)
    return _ref_planes(case), np.asarray(whole)


# -- CPU: the plain versions against the reference ---------------------------------------


@pytest.mark.parametrize("layout_name,variant", CASES, ids=CASE_IDS)
def test_planes_plain_bit_identical_to_reference(layout_name, variant):
    """``_stage2_planes_plain`` (and the wrapper on CPU tensors, all segments in one
    call) against the reference's planes: uint8 equal to the reference's range-limited
    float32 planes, value for value."""
    case = _case(layout_name, variant)
    theirs, _rgb = _reference(layout_name, variant)
    segments = _segments(case)
    ours = [port._stage2_planes_plain(seg) for seg in segments]
    for got, want, (_h, _v, by, bx) in zip(ours, theirs, case[0][2]):
        assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape \
            == (want.shape[0], by * 8, bx * 8)
        np.testing.assert_array_equal(got.numpy().astype(np.float32), want)
    for got, want in zip(port.stage2_planes_segments(segments), ours):
        assert torch.equal(got, want)


@pytest.mark.parametrize("layout_name,variant", CASES, ids=CASE_IDS)
def test_rgb_plain_bit_identical_to_reference(layout_name, variant):
    """``_stage2_rgb_plain`` (and the wrapper on CPU tensors) against the reference's
    upsample, crop and colour on the same planes, RGB and BGR."""
    layout = _case(layout_name, variant)[0]
    planes, _rgb = _reference(layout_name, variant)
    tplanes = [torch.from_numpy(p.astype(np.uint8)) for p in planes]
    want = _ref_rgb(planes, layout)
    ours = port._stage2_rgb_plain(tplanes, layout)
    assert ours.dtype == torch.uint8 and tuple(ours.shape) == want.shape \
        == (want.shape[0], layout[0], layout[1], 3)
    np.testing.assert_array_equal(ours.numpy(), want)
    assert torch.equal(port.stage2_rgb(tplanes, layout), ours)
    bgr = port.stage2_rgb(tplanes, layout, bgr=True).numpy()
    np.testing.assert_array_equal(bgr, want[..., ::-1])


@pytest.mark.parametrize("layout_name,variant", CASES, ids=CASE_IDS)
def test_batched_stage2_bit_identical_to_reference(layout_name, variant):
    """The port's ``_batched_stage2`` as a whole (``stage2_planes_segments`` then
    ``stage2_rgb``) against the reference's jitted ``_batched_stage2(layout, ks, packed,
    split)`` on the same shipped slabs and tables; ``bgr=True`` gives the reversed
    channels."""
    layout, ks, packed, split, coeffs, qtabs = _case(layout_name, variant)
    _planes, theirs = _reference(layout_name, variant)
    tc, tq = _tensors(coeffs, qtabs)
    ours = port._batched_stage2(layout, tc, tq, ks, packed, split)
    np.testing.assert_array_equal(ours.numpy(), theirs)
    bgr = port._batched_stage2(layout, tc, tq, ks, packed, split, bgr=True)
    np.testing.assert_array_equal(bgr.numpy(), theirs[..., ::-1])


@pytest.fixture
def fresh_transfer_state():
    def reset(mod):
        with mod._STICKY_KS_LOCK:
            mod._STICKY_KS.clear()
            mod._STICKY_SPLIT.clear()
            mod._PACK12_DISABLED.clear()
            mod._SPLIT_DISABLED.clear()
            mod._TRANSFER_BYTES.update(shipped=0, raw=0)

    reset(port)
    reset(ref)
    yield
    reset(port)
    reset(ref)


@pytest.mark.parametrize("bgr", [False, True])
def test_ratio_four_layout_from_arrays_bit_identical_to_reference(bgr, fresh_transfer_state):
    """A 4:1:1 layout (horizontal ratio 4: the chroma is repeated, not filtered) built
    with ``planes_from_arrays`` decodes through ``decode_jpeg_batch`` bit-identically to
    the reference's decode of the same blocks, in either channel order."""
    height, width, comps, n = LAYOUTS["411"]
    rng = np.random.RandomState(81)
    rows = []
    for _ in range(n):
        row = []
        for ci, (h, v, by, bx) in enumerate(comps):
            lim = _Y_RANGE if ci == 0 else _C_RANGE
            z = rng.randint(-32768, 32768, (by, bx, 64)) % (2 * lim + 1) - lim
            row.append((z[..., ref.UNZIGZAG].astype(np.int32),
                        rng.randint(1, 25, 64).astype(np.int32), h, v))
        rows.append(row)
    ours = port.decode_jpeg_batch([port.planes_from_arrays(height, width, r) for r in rows],
                                  device=CPU, bgr=bgr).numpy()
    theirs = np.asarray(ref.decode_jpeg_batch([ref.JpegPlanes(height, width, [
        ref.JpegComponent(b, q, h, v) for b, q, h, v in r]) for r in rows]))
    assert ours.shape == (n, height, width, 3)
    np.testing.assert_array_equal(ours, theirs[..., ::-1] if bgr else theirs)


def test_colour_follows_each_reference_entry_point():
    """The reference rounds its colour two ways: its jitted ``_batched_stage2`` has XLA
    fuse each multiply-add of ``ycbcr_to_rgb`` into an FMA on the CPU, its eager form
    rounds every product. The port's batched colour is the fused one, its per-image
    colour (``ycbcr_to_rgb``) the eager one: each equal to its reference, on a pixel
    where the two differ (Y 252, Cb 3, Cr 0: B is 31 fused, 30 eager) and on samples at
    the 1/16 grid the upsample leaves."""
    import jax
    import jax.numpy as jnp

    def ref_u8(y, cb, cr):
        return jnp.clip(jnp.round(ref.ycbcr_to_rgb(y, cb, cr)), 0, 255).astype(jnp.uint8)

    rng = np.random.RandomState(82)
    y, cb, cr = (np.concatenate([[v], rng.randint(0, 256 * 16, 100000) / 16]).astype(np.float32)
                 for v in (252.0, 3.0, 0.0))
    jitted = np.asarray(jax.jit(ref_u8)(y, cb, cr))
    eager = np.asarray(ref_u8(jnp.asarray(y), jnp.asarray(cb), jnp.asarray(cr)))
    assert (jitted[0, 2], eager[0, 2]) == (31, 30)
    ty, tcb, tcr = (torch.from_numpy(a) for a in (y, cb, cr))
    np.testing.assert_array_equal(port._ycbcr_to_rgb_u8_fused(ty, tcb, tcr).numpy(), jitted)
    np.testing.assert_array_equal(port._to_uint8(port.ycbcr_to_rgb(ty, tcb, tcr)).numpy(),
                                  eager)


def test_stage2_wrappers_refuse_what_the_kernels_do_not_take():
    layout, _ks, _packed, _split, coeffs, qtabs = _case("444", "int16")
    segs = _segments(_case("444", "int16"))
    with pytest.raises(ValueError):
        port.stage2_planes_segments([])
    with pytest.raises(ValueError):
        port.stage2_planes_segments(segs[:1] * 5)
    with pytest.raises(ValueError, match="by="):  # by * bx must be the blocks an image
        port.stage2_planes_segments([segs[0]._replace(by=4)])
    with pytest.raises(ValueError, match="by="):
        port.stage2_planes_segments([segs[0]._replace(by=None, bx=None)])
    with pytest.raises(ValueError, match="qtab"):
        port.stage2_planes_segments([segs[0]._replace(qtab=segs[0].qtab.to(torch.int64))])
    with pytest.raises(ValueError, match="slab"):  # packed, but int16 bytes
        port.stage2_planes_segments([segs[0]._replace(packed=True)])
    planes = port.stage2_planes_segments(segs)
    with pytest.raises(ValueError, match="1 or 3 planes"):
        port.stage2_rgb(planes[:2], layout)
    with pytest.raises(ValueError, match="expected uint8"):
        port.stage2_rgb([p.float() for p in planes], layout)
    with pytest.raises(ValueError, match="expected uint8"):
        port.stage2_rgb([p[:, :8] for p in planes], layout)
    with pytest.raises(ValueError, match="does not cover"):  # a plane too small
        port.stage2_rgb(planes, (48, 56, layout[2]))


# -- the kernels' edges: one table, held on the CPU against the reference and on the card
# against the plain versions ---------------------------------------------------------------

#: (id, layout, variant, content, the active-column counts of Y's 128-block tiles or None)
STAGE2_EDGES = [
    ("zero_tile_int16", "420_edge", "int16", "zero_tile", None),
    ("zero_tile_split", "420_edge", "split", "zero_tile", None),
    ("last_block_hf_kinds", "420_edge", "kinds", "last_block_hf", (3, 2, 3)),
    ("odd_active_pack12", "444_odd", "pack12", "odd_active", (5, 5)),
    ("kinds_truncated", "420_edge", "kinds_truncated", "random", None),
    ("odd_bx_split_truncated", "444_odd", "split_truncated", "random", None),
    ("width_359_mixed", "420_w359", "mixed", "random", None),
    ("width_481_int16_truncated", "420_ragged", "int16_truncated", "random", None),
    ("ratio4_split", "411", "split", "random", None),
    ("gray_pack12", "gray", "pack12", "random", None),
]
STAGE2_EDGE_IDS = [e[0] for e in STAGE2_EDGES]


def _tile_active(seg):
    """Per 128-block tile of a segment, the natural positions non-zero in any block."""
    nz = (port._unpack_dequant_plain(seg) != 0).numpy()
    return tuple(int(nz[t:t + 128].any(axis=0).sum()) for t in range(0, nz.shape[0], 128))


@pytest.mark.parametrize("case_id,layout_name,variant,content,active", STAGE2_EDGES,
                         ids=STAGE2_EDGE_IDS)
def test_stage2_edges_plain_bit_identical_to_reference(case_id, layout_name, variant, content,
                                                       active):
    """Each edge case (an all-zero tile, a high-frequency column in only the last block of
    a full and of a ragged tile, active counts not a multiple of 4, the three kinds and
    cut segments in one group, odd block widths, ragged bands, rows of 359 and 481
    pixels, ratio 4, one component): the plain planes equal the reference's, value for
    value, and the plain RGB (and BGR) equals its whole jitted ``_batched_stage2``."""
    case = _case(layout_name, variant, content)
    layout = case[0]
    theirs, whole = _reference(layout_name, variant, content)
    segs = _segments(case)
    if content == "zero_tile":
        assert _tile_active(segs[0])[0] == 0
    if active is not None:
        assert _tile_active(segs[0]) == active
    ours = [port._stage2_planes_plain(seg) for seg in segs]
    for got, want in zip(ours, theirs):
        np.testing.assert_array_equal(got.numpy().astype(np.float32), want)
    for bgr in (False, True):
        rgb = port._stage2_rgb_plain(ours, layout, bgr).numpy()
        np.testing.assert_array_equal(rgb, whole[..., ::-1] if bgr else whole)


# -- the kernels on the card --------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("layout_name,variant", CASES, ids=CASE_IDS)
def test_planes_kernel_equals_plain_on_the_card(cuda_device, layout_name, variant):
    """One ``stage2_planes`` launch over a group's components equals the plain version
    on the card, plane for plane (``torch.equal``)."""
    segs = _segments(_case(layout_name, variant), cuda_device)
    before = port.stage2_planes_segments.launches
    outs = port.stage2_planes_segments(segs)
    torch.cuda.synchronize()
    assert port.stage2_planes_segments.launches == before + 1
    for out, seg in zip(outs, segs):
        assert torch.equal(out, port._stage2_planes_plain(seg))


#: (k, packed, split, by, bx): every way the load stage reads a value, at odd and even
#: plane widths and with partial 128-block tiles
EDGE_CASES = [(64, False, None, 3, 5), (16, False, None, 2, 4), (32, False, None, 7, 9),
              (64, True, None, 4, 6), (32, True, None, 1, 3), (16, True, None, 5, 2),
              (64, False, (12, 40), 3, 3), (32, False, (4, 16), 2, 6),
              (16, False, (0, 16), 6, 1), (64, False, (0, 0), 2, 2),
              (64, False, (64, 64), 3, 4), (32, False, (32, 32), 1, 1),
              (16, False, (0, 0), 4, 4), (64, False, (8, 64), 5, 5)]


def _edge_segment(rng, n, k, packed, split, by, bx, device):
    """Random shipped bytes (any byte pattern is a valid pack, so every tier reaches its
    range edges) and a one-hot table a image: image i dequantises position i % 64 alone,
    so every pixel is one rounded product plus 128, the same in any summation order."""
    nb = by * bx
    if split is not None:
        k1, k2 = split
        slabs = (rng.randint(0, 256, (n, nb, k1 * 3 // 2)).astype(np.uint8),
                 rng.randint(-128, 128, (n, nb, k2 - k1)).astype(np.int8),
                 rng.randint(0, 256, (n, nb, (k - k2) // 2)).astype(np.uint8))
        slabs = tuple(torch.from_numpy(a).to(device) for a in slabs)
    elif packed:
        slabs = torch.from_numpy(rng.randint(0, 256, (n, nb, k * 3 // 2)).astype(np.uint8))
    else:
        slabs = torch.from_numpy(rng.randint(-32768, 32768, (n, nb, k)).astype(np.int16))
    if not isinstance(slabs, tuple):
        slabs = slabs.to(device)
    qtab = np.zeros((n, 64), np.int32)
    qtab[np.arange(n), np.arange(n) % 64] = rng.randint(1, 4, n)
    return port.CoefSegment(slabs, torch.from_numpy(qtab).to(device), k, packed, split, by, bx)


@pytest.mark.gpu
@pytest.mark.parametrize("k,packed,split,by,bx", EDGE_CASES)
def test_planes_kernel_range_edges_on_the_card(cuda_device, k, packed, split, by, bx):
    """Three segments of one case in one launch, 64 images each (every position
    dequantised in some image), at the tiers' range edges: equal to the plain version."""
    rng = np.random.RandomState(90 + k + by)
    segs = [_edge_segment(rng, 64, k, packed, split, by + s, bx, cuda_device)
            for s in range(3)]
    outs = port.stage2_planes_segments(segs)
    torch.cuda.synchronize()
    for out, seg in zip(outs, segs):
        assert torch.equal(out, port._stage2_planes_plain(seg))


@pytest.mark.gpu
@pytest.mark.parametrize("layout_name", list(LAYOUTS))
@pytest.mark.parametrize("bgr", [False, True])
def test_rgb_kernel_equals_plain_on_the_card(cuda_device, layout_name, bgr):
    """One ``stage2_rgb`` launch on random planes of each layout equals the plain
    version (``torch.equal``), RGB and BGR; the edges clamp at the padded plane."""
    height, width, comps, n = LAYOUTS[layout_name]
    rng = np.random.RandomState(91)
    planes = [torch.from_numpy(rng.randint(0, 256, (n, by * 8, bx * 8)).astype(np.uint8))
              .to(cuda_device) for _h, _v, by, bx in comps]
    layout = (height, width, comps)
    before = port.stage2_rgb.launches
    out = port.stage2_rgb(planes, layout, bgr)
    torch.cuda.synchronize()
    assert port.stage2_rgb.launches == before + 1
    assert torch.equal(out, port._stage2_rgb_plain(planes, layout, bgr))


@pytest.mark.gpu
@pytest.mark.parametrize("layout_name,variant", CASES, ids=CASE_IDS)
def test_batched_stage2_on_the_card_equals_cpu(cuda_device, layout_name, variant):
    layout, ks, packed, split, coeffs, qtabs = _case(layout_name, variant)
    tc, tq = _tensors(coeffs, qtabs, cuda_device)
    on_card = port._batched_stage2(layout, tc, tq, ks, packed, split).cpu()
    tc, tq = _tensors(coeffs, qtabs)
    assert torch.equal(on_card, port._batched_stage2(layout, tc, tq, ks, packed, split))


@pytest.mark.gpu
def test_stage2_kernels_refuse_unaligned_inputs_on_the_card(cuda_device):
    segs = _segments(_case("444", "int16"), cuda_device)
    base = torch.zeros(segs[0].slabs.numel() + 8, dtype=torch.int16, device=cuda_device)
    shifted = base[1:1 + segs[0].slabs.numel()].view(segs[0].slabs.shape)
    with pytest.raises(ValueError, match="aligned"):
        port.stage2_planes_segments([segs[0]._replace(slabs=shifted)])
    planes = port.stage2_planes_segments(segs)
    layout = _case("444", "int16")[0]
    with pytest.raises(ValueError, match="contiguous"):
        port.stage2_rgb([p.transpose(1, 2).contiguous().transpose(1, 2) for p in planes],
                        layout)
    room = torch.zeros(planes[0].numel() + 16, dtype=torch.uint8, device=cuda_device)
    off_by_one = room[1:1 + planes[0].numel()].view(planes[0].shape)
    with pytest.raises(ValueError, match="aligned"):
        port.stage2_rgb([off_by_one] + planes[1:], layout)


@pytest.mark.gpu
@pytest.mark.parametrize("case_id,layout_name,variant,content,active", STAGE2_EDGES,
                         ids=STAGE2_EDGE_IDS)
def test_stage2_edges_kernels_equal_plain_on_the_card(cuda_device, case_id, layout_name,
                                                      variant, content, active):
    """Each edge case through one ``stage2_planes`` launch and one ``stage2_rgb`` launch
    (RGB and BGR): equal to the plain versions on the card (``torch.equal``)."""
    case = _case(layout_name, variant, content)
    layout = case[0]
    segs = _segments(case, cuda_device)
    before = port.stage2_planes_segments.launches
    outs = port.stage2_planes_segments(segs)
    torch.cuda.synchronize()
    assert port.stage2_planes_segments.launches == before + 1
    for out, seg in zip(outs, segs):
        assert torch.equal(out, port._stage2_planes_plain(seg))
    for bgr in (False, True):
        before = port.stage2_rgb.launches
        rgb = port.stage2_rgb(outs, layout, bgr)
        torch.cuda.synchronize()
        assert port.stage2_rgb.launches == before + 1
        assert torch.equal(rgb, port._stage2_rgb_plain(outs, layout, bgr))
