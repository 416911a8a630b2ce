#!/usr/bin/env python3
"""Seeded JPEG streams for the edge-stream checks of the port's device decode.

    python3 tests/data/torch_jpeg/make_fixtures.py          # write the fixtures
    python3 tests/data/torch_jpeg/make_fixtures.py --check  # compare, write nothing

Writes, next to this script, one ``<name>.jpg`` a stream, ``arith_host.npy`` (the host
decode of the arithmetic-marked stream, for a machine without cv2) and
``manifest.json`` (each stream's group and size). Needs numpy, cv2 and sklearn (the two
photographs); the content comes from ``numpy.random.RandomState(SEED)``, so a run with
the same cv2 build writes the same bytes (``tests/test_torch_edge_fixtures.py`` checks
that where cv2 and sklearn are present). ``chip_smoke.py``'s edge-stream phase reads the
files and needs neither module.

Groups (each is one ``decode_jpeg_batch`` call in that phase):

- ``uniform``: 48x64 streams of every coding the native stage 1 takes: baseline,
  progressive, a restart interval, optimised Huffman tables, grayscale, and the 4:2:0,
  4:2:2 and 4:4:4 samplings (one layout group each);
- ``sizes``: odd sizes (33x47, 17x25) beside other sizes, decoded with ``resize_to``;
- ``fallback``: a baseline stream whose SOF0 marker reads SOF9 (arithmetic coding, which
  the native stage 1 refuses), decoded on the host between two device rows;
- ``photo``: a 224x224 crop of each of sklearn's two photographs at qualities 50, 75
  and 95 (the truncated transfer on photographic spectra).
"""
import json
import os
import sys

import numpy as np

SEED = 20261019
HERE = os.path.dirname(os.path.abspath(__file__))
UNIFORM = (48, 64)
SIZES = [(33, 47), (64, 40), (17, 25), (80, 56)]
PHOTO_QUALITIES = (50, 75, 95)


def _image(rng, shape):
    """Blocky random content plus a gradient: every frequency band in use, smooth
    enough that a mutation or a decode fault shows as a large pixel error."""
    h, w = shape[:2]
    base = rng.randint(0, 256, (h // 4 + 1, w // 4 + 1)).astype(np.float32)
    img = np.kron(base, np.ones((4, 4), np.float32))[:h, :w]
    img = 0.7 * img + 0.3 * np.linspace(0, 255, w, dtype=np.float32)[None, :]
    if len(shape) == 2:
        return img.clip(0, 255).astype(np.uint8)
    return np.stack([img, np.flipud(img), np.fliplr(img)], -1).clip(0, 255).astype(np.uint8)


def _encode(cv2, img, *opts):
    ok, enc = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 85, *opts])
    assert ok
    return enc.tobytes()


def _sof9(stream):
    i = stream.find(b"\xff\xc0")
    assert i > 0
    return stream[:i] + b"\xff\xc9" + stream[i + 2:]


def _photo_crops(cv2, rng, size=224):
    """One 224x224 crop of each photograph, the most detailed of 8 seeded candidates."""
    from sklearn.datasets import load_sample_images

    crops = []
    for img in load_sample_images().images:
        h, w = img.shape[:2]
        best = None
        for _ in range(8):
            y, x = rng.randint(0, h - size), rng.randint(0, w - size)
            c = np.ascontiguousarray(img[y:y + size, x:x + size])
            energy = cv2.Laplacian(cv2.cvtColor(c, cv2.COLOR_RGB2GRAY), cv2.CV_32F).var()
            if best is None or energy > best[0]:
                best = (energy, c)
        crops.append(cv2.cvtColor(best[1], cv2.COLOR_RGB2BGR))
    return crops


def build():
    """``(streams, manifest, arith_host)``: name → bytes, name → {group, size}, and the
    host decode of the arithmetic-marked stream."""
    import cv2

    rng = np.random.RandomState(SEED)
    streams, manifest = {}, {}

    def add(name, group, data, size):
        streams[name] = data
        manifest[name] = {"group": group, "size": list(size)}

    color = _image(rng, UNIFORM + (3,))
    add("baseline", "uniform", _encode(cv2, color), UNIFORM)
    add("progressive", "uniform",
        _encode(cv2, _image(rng, UNIFORM + (3,)), cv2.IMWRITE_JPEG_PROGRESSIVE, 1), UNIFORM)
    add("restart", "uniform",
        _encode(cv2, _image(rng, UNIFORM + (3,)), cv2.IMWRITE_JPEG_RST_INTERVAL, 2), UNIFORM)
    add("optimized", "uniform",
        _encode(cv2, _image(rng, UNIFORM + (3,)), cv2.IMWRITE_JPEG_OPTIMIZE, 1,
                cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_RST_INTERVAL, 3), UNIFORM)
    add("grayscale", "uniform", _encode(cv2, _image(rng, UNIFORM)), UNIFORM)
    for name, factor in (("sampling_420", cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420),
                         ("sampling_422", cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422),
                         ("sampling_444", cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444)):
        add(name, "uniform", _encode(cv2, _image(rng, UNIFORM + (3,)),
                                     cv2.IMWRITE_JPEG_SAMPLING_FACTOR, int(factor)),
            UNIFORM)
    for h, w in SIZES:
        add("size_%dx%d" % (h, w), "sizes", _encode(cv2, _image(rng, (h, w, 3))), (h, w))
    arith = _sof9(_encode(cv2, _image(rng, UNIFORM + (3,)), cv2.IMWRITE_JPEG_QUALITY, 90))
    add("arith_sof9", "fallback", arith, UNIFORM)
    host = cv2.imdecode(np.frombuffer(arith, np.uint8), cv2.IMREAD_UNCHANGED)
    assert host is not None and host.shape == UNIFORM + (3,)
    for p, crop in enumerate(_photo_crops(cv2, rng)):
        for q in PHOTO_QUALITIES:
            ok, enc = cv2.imencode(".jpg", crop, [cv2.IMWRITE_JPEG_QUALITY, q])
            assert ok
            add("photo%d_q%d" % (p, q), "photo", enc.tobytes(), crop.shape[:2])
    return streams, manifest, host


def load(directory=HERE):
    """The committed fixtures: ``(streams, manifest, arith_host)``, without cv2."""
    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)["streams"]
    streams = {}
    for name in manifest:
        with open(os.path.join(directory, name + ".jpg"), "rb") as f:
            streams[name] = f.read()
    return streams, manifest, np.load(os.path.join(directory, "arith_host.npy"))


def main(argv):
    streams, manifest, host = build()
    if "--check" in argv:
        ours = load()
        same = ours[0] == streams and ours[1] == manifest and np.array_equal(ours[2], host)
        print("fixtures match" if same else "fixtures differ")
        return 0 if same else 1
    for name, data in streams.items():
        with open(os.path.join(HERE, name + ".jpg"), "wb") as f:
            f.write(data)
    np.save(os.path.join(HERE, "arith_host.npy"), host)
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump({"seed": SEED, "streams": manifest}, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(os.path.getsize(os.path.join(HERE, n)) for n in os.listdir(HERE))
    print("wrote %d streams, %d bytes in the directory" % (len(streams), total))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
