"""The edge-stream fixtures under ``tests/data/torch_jpeg/`` (made by its seeded
``make_fixtures.py``; ``chip_smoke.py``'s edge-stream phase decodes them on the card).

- the committed files are what the script makes, where cv2 and sklearn are present, and
  stay under 256 KB;
- each group decodes through the port on the CPU (the stage-2 kernels' plain versions)
  bit for bit as the JAX package decodes it: ``uniform`` (every coding and sampling the
  native stage 1 takes) and ``photo`` through ``decode_jpeg_batch``, ``fallback`` (an
  arithmetic-marked stream between two device rows) through the codec's
  ``device_decode_batch``; ``sizes`` with ``resize_to`` against the port's own per-size
  decode resized alone (the resize is not bit-exact against ``jax.image.resize``);
- the ``gpu`` case decodes every group on the card and holds the kernel path against
  the CPU, bit for bit, and the plain versions on the same device.
"""
import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_card_helpers import (assert_card_matches_plain,  # noqa: E402,F401
                                 cuda_device, kernel_launches, launches_since,
                                 plain_kernels)
from _torch_pool_helpers import _no_leaked_shm_segments  # noqa: E402,F401

from petastorm_tpu_torch.codecs import CompressedImageCodec  # noqa: E402
from petastorm_tpu_torch.ops import jpeg as port  # noqa: E402
from petastorm_tpu_torch.unischema import UnischemaField  # noqa: E402

DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_jpeg")
CPU = torch.device("cpu")
RESIZE = (32, 32)


def _script():
    spec = importlib.util.spec_from_file_location("make_fixtures",
                                                  os.path.join(DIR, "make_fixtures.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def fixtures():
    return _script().load(DIR)


def _group(fixtures, group):
    streams, manifest, _ = fixtures
    return [streams[name] for name in sorted(manifest) if manifest[name]["group"] == group]


def test_fixtures_match_the_script():
    pytest.importorskip("cv2", reason="the script encodes with cv2")
    pytest.importorskip("sklearn", reason="the script crops sklearn's photographs")
    mod = _script()
    streams, manifest, host = mod.build()
    ours = mod.load(DIR)
    assert sorted(ours[0]) == sorted(streams)
    for name, data in streams.items():
        assert ours[0][name] == data, name
    assert ours[1] == manifest
    np.testing.assert_array_equal(ours[2], host)


def test_fixtures_stay_small(fixtures):
    total = sum(os.path.getsize(os.path.join(DIR, n)) for n in os.listdir(DIR)
                if not n.startswith("__"))
    assert total <= 256 * 1024, total
    groups = {m["group"] for m in fixtures[1].values()}
    assert groups == {"uniform", "sizes", "fallback", "photo"}


def _field(fixtures):
    h, w = fixtures[1]["arith_sof9"]["size"]
    return UnischemaField("image", np.uint8, (h, w, 3),
                          CompressedImageCodec("jpeg", quality=90), False)


def _fallback_staged(fixtures):
    """[baseline, arithmetic-marked, baseline] as the reader stages them: planes for
    the device rows, the host decode for the row the native stage 1 refuses."""
    streams = fixtures[0]
    field = _field(fixtures)
    blobs = [streams["baseline"], streams["arith_sof9"], streams["baseline"]]
    try:
        import cv2  # noqa: F401
        staged = field.codec.host_stage_decode_batch(field, blobs)
    except ImportError:  # no host decoder here: the committed host decode stands in
        planes = port.entropy_decode_jpeg_batch([blobs[0]])[0]
        staged = [planes, fixtures[2], planes]
    assert isinstance(staged[1], np.ndarray), "the native stage 1 took the SOF9 stream"
    return field, staged


def _stage1(jpeg, blobs):
    """Stage 1 as the reader runs it: the batched native decode, and the per-image one
    for rows of another layout than the first stream's (they come back None)."""
    planes = jpeg.entropy_decode_jpeg_batch(blobs)
    return [p if p is not None else jpeg.entropy_decode_jpeg_fast(b)
            for p, b in zip(planes, blobs)]


def decode_groups(fixtures, device):
    """Every group decoded on ``device``: ``{group: (n, h, w, 3) uint8 tensor}``."""
    field, staged = _fallback_staged(fixtures)
    return {
        "uniform": port.decode_jpeg_batch(_stage1(port, _group(fixtures, "uniform")),
                                          device=device),
        "photo": port.decode_jpeg_batch(_stage1(port, _group(fixtures, "photo")),
                                        device=device),
        "sizes": port.decode_jpeg_batch(
            [port.entropy_decode_jpeg_fast(b) for b in _group(fixtures, "sizes")],
            device=device, resize_to=RESIZE),
        "fallback": field.codec.device_decode_batch(field, staged, device),
    }


def test_edge_streams_decode_as_the_reference_on_the_cpu(fixtures):
    from petastorm_tpu import codecs as ref_codecs
    from petastorm_tpu import unischema as ref_unischema
    from petastorm_tpu.ops import jpeg as ref

    got = decode_groups(fixtures, CPU)
    for group in ("uniform", "photo"):
        blobs = _group(fixtures, group)
        np.testing.assert_array_equal(
            got[group].numpy(),
            np.asarray(ref.decode_jpeg_batch(_stage1(ref, blobs))),
            err_msg=group)
    field, staged = _fallback_staged(fixtures)
    ref_field = ref_unischema.UnischemaField(
        field.name, field.numpy_dtype, field.shape,
        ref_codecs.CompressedImageCodec("jpeg", quality=90), False)
    np.testing.assert_array_equal(got["fallback"].numpy()[1], staged[1])
    ref_staged = [ref.entropy_decode_jpeg_fast(fixtures[0]["baseline"]), staged[1],
                  ref.entropy_decode_jpeg_fast(fixtures[0]["baseline"])]
    np.testing.assert_array_equal(
        got["fallback"].numpy(),
        np.asarray(ref_field.codec.device_decode_batch(ref_field, ref_staged)))
    # each size resized in the batch equals its own decode resized alone
    sizes = got["sizes"].numpy()
    assert sizes.shape == (len(_group(fixtures, "sizes")),) + RESIZE + (3,)
    for i, blob in enumerate(_group(fixtures, "sizes")):
        alone = port.decode_jpeg_batch([port.entropy_decode_jpeg_fast(blob)], device=CPU,
                                       resize_to=RESIZE)
        np.testing.assert_array_equal(sizes[i], alone.numpy()[0])


@pytest.mark.gpu
def test_edge_streams_on_the_card(fixtures, cuda_device):
    """Every group on the card: ``stage2_planes`` and ``stage2_rgb`` launch, and the
    output equals the CPU path bit for bit and the plain versions on the card
    (``assert_card_matches_plain``)."""
    before = kernel_launches()
    on_card = decode_groups(fixtures, cuda_device)
    launched = launches_since(before)
    assert launched["stage2_planes"] >= 4 and launched["stage2_rgb"] >= 4, launched
    with plain_kernels():
        plain = decode_groups(fixtures, cuda_device)
    cpu = decode_groups(fixtures, CPU)
    for group, out in on_card.items():
        assert torch.equal(out.cpu(), cpu[group]), group
        assert_card_matches_plain(out, plain[group])
