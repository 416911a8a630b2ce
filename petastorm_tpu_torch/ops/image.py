"""Image prep on the device: uint8 → normalised bfloat16 (+ random horizontal flip), and
the random crop and colour jitter of train-time augmentation.

Port of ``petastorm_tpu.ops.image``: ``normalize_images`` is kernel K2 (``csrc/normalize.cu``,
port of ``petastorm_tpu/ops/image.py:24 _normalize_kernel``) on a CUDA tensor and its
plain PyTorch version on a CPU tensor; ``normalize_and_augment`` draws a per-image flip
from a ``torch.Generator`` and hands it to the same K2 launch, which writes flipped images
mirrored. ``random_crop`` and ``color_jitter`` draw from a ``torch.Generator`` where the
JAX package takes a key, and are plain torch ops, as the JAX package's are plain ``jnp``;
each is built on a helper that takes its draws as tensors (``_crop_at``,
``_jitter_with``).

Layout: NHWC with C innermost, as in the JAX package.
"""
from __future__ import annotations

import ctypes

import numpy as np

#: most channels K2 takes (its per-channel constants ride in the launch parameters)
MAX_CHANNELS = 16
#: K2's routes, fastest first, by the code the C entry point takes
ROUTES = ("bulk", "vector", "scalar")
#: the bulk route's shared memory: input stages and output tiles (csrc/normalize.cu's
#: kStages, kOutTiles), at most BULK_SMEM_BYTES a block (an H100 block's opt-in, 227 KiB,
#: less 1 KiB for the kernel's static shared memory)
BULK_STAGES, BULK_OUT_TILES = 4, 3
BULK_SMEM_BYTES = 227 * 1024 - 1024
#: a bulk tile is as many whole rows as keep it within 12 KiB in and 32 KiB out (at least
#: one): 18 rows of 224 x 3 to bfloat16, 12 to float32, the fastest of 6-24 rows on an
#: H100 80GB HBM3 (chip_smoke.py's K2 phase)
BULK_TILE_IN_BYTES, BULK_TILE_OUT_BYTES = 12 * 1024, 32 * 1024

_FLOAT_P = ctypes.POINTER(ctypes.c_float)
_CONSTANTS = {}
_CONSTANTS_MAX = 64


def _channel_constants(mean, std, channels):
    """(C,) float32 mean and inv_std = 1/std (divided in float32, as the JAX package)."""
    mean = np.broadcast_to(np.asarray(mean, dtype=np.float32), (channels,)).copy()
    std = np.broadcast_to(np.asarray(std, dtype=np.float32), (channels,))
    return mean, (np.float32(1.0) / std).astype(np.float32)


def _hashable(v):
    if isinstance(v, (list, tuple)):
        return tuple(v)
    return v if isinstance(v, (int, float)) else None


def _cached_constants(mean, std, channels):
    """``(mean_c, inv_c, mean_ptr, inv_ptr)`` of :func:`_channel_constants`, cached per
    ``(mean, std, C)`` when both are plain numbers or sequences of them; the arrays stay
    alive in the cache beside their ctypes pointers."""
    key = (_hashable(mean), _hashable(std), channels)
    hit = _CONSTANTS.get(key) if None not in key else None
    if hit is not None:
        return hit
    mean_c, inv_c = _channel_constants(mean, std, channels)
    hit = (mean_c, inv_c, mean_c.ctypes.data_as(_FLOAT_P), inv_c.ctypes.data_as(_FLOAT_P))
    if None not in key:
        if len(_CONSTANTS) >= _CONSTANTS_MAX:
            _CONSTANTS.clear()
        _CONSTANTS[key] = hit
    return hit


def _bulk_smem(rows, row_bytes, out_size):
    """Dynamic shared memory of a bulk tile of ``rows`` rows, as the C side lays it out."""
    def round128(v):
        return (v + 127) // 128 * 128
    return (BULK_STAGES * round128(rows * row_bytes)
            + BULK_OUT_TILES * round128(rows * row_bytes * out_size) + 8 * BULK_STAGES)


def choose_route(shape, images_ptr, out_ptr, out_size, route=None):
    """K2's route for an (N, H, W, C) uint8 batch at ``images_ptr`` written to
    ``out_ptr`` in ``out_size``-byte values: ``("bulk", rows_per_tile)`` when both
    pointers are 16-byte aligned, a row (W*C bytes) is a multiple of 16 and the tile's
    shared memory fits ``BULK_SMEM_BYTES``; else ``("vector", 0)`` when both pointers are
    16-byte aligned; else ``("scalar", 0)``. A bulk tile is as many whole rows as keep
    it within ``BULK_TILE_IN_BYTES`` in and ``BULK_TILE_OUT_BYTES`` out (at least one, at
    most N*H). A ``route`` named by the caller is taken when the batch allows it (any
    route slower than the fastest allowed one does); a faster one raises."""
    n, h, w, c = shape
    rows = max(1, min(BULK_TILE_IN_BYTES // (w * c), BULK_TILE_OUT_BYTES // (w * c * out_size),
                      n * h))
    if images_ptr % 16 or out_ptr % 16:
        best = ("scalar", 0)
    elif ((w * c) % 16 == 0 and n * h < 2 ** 31
          and _bulk_smem(rows, w * c, out_size) <= BULK_SMEM_BYTES):
        best = ("bulk", rows)
    else:
        best = ("vector", 0)
    if route is None or route == best[0]:
        return best
    if route not in ROUTES or ROUTES.index(route) < ROUTES.index(best[0]):
        raise ValueError("normalize_images cannot take route %r for this batch (%r is the "
                         "fastest it allows)" % (route, best[0]))
    return route, 0


def _normalize_plain(images, mean, std, out_dtype, flips=None):
    """Plain PyTorch version of K2: ``(x * (1/255) - mean) * (1/std)`` in float32, cast to
    ``out_dtype``, then each image whose ``flips`` entry is set mirrored along W."""
    import torch

    mean_c, inv_c = _channel_constants(mean, std, images.shape[-1])
    x = images.to(torch.float32) * (1.0 / 255.0)
    mean_t = torch.from_numpy(mean_c).to(images.device)
    inv_t = torch.from_numpy(inv_c).to(images.device)
    out = ((x - mean_t) * inv_t).to(out_dtype)
    if flips is not None:
        out = torch.where(flips.to(torch.bool)[:, None, None, None], out.flip(2), out)
    return out


def _out_kinds():
    import torch

    return {torch.bfloat16: 0, torch.float32: 1, torch.float16: 2}


def normalize_images(images, mean, std, out_dtype=None, flips=None, route=None):
    """(N, H, W, C) uint8 → (N, H, W, C) ``out_dtype`` (default bfloat16; float32 and
    float16 also taken), ``(x/255 - mean) / std`` per channel. ``mean``/``std``: (C,)
    floats. ``flips``: optional (N,) bool or uint8 tensor on the images' device; image i
    comes out mirrored along W where ``flips[i]`` is set, in the same pass.

    K2 on a CUDA tensor, the plain version on a CPU tensor. A batch that is not
    contiguous (a crop's view) is made contiguous with one copy before the launch.
    ``route`` (None: the fastest :func:`choose_route` allows) forces one of K2's slower
    routes (``"vector"``, ``"scalar"``), for tests. ``normalize_images.launches`` counts
    kernel launches, ``normalize_images.routes`` those of each route."""
    import torch

    out_dtype = torch.bfloat16 if out_dtype is None else out_dtype
    if images.dtype != torch.uint8 or images.dim() != 4:
        raise TypeError("normalize_images takes (N, H, W, C) uint8, got %s %s"
                        % (images.dtype, tuple(images.shape)))
    out_kind = _out_kinds().get(out_dtype)
    if out_kind is None:
        raise TypeError("normalize_images writes bfloat16, float32 or float16, got %s"
                        % out_dtype)
    if flips is not None and (flips.dtype not in (torch.bool, torch.uint8)
                              or tuple(flips.shape) != (images.shape[0],)
                              or flips.device != images.device):
        raise ValueError("flips must be an (N,) bool or uint8 tensor on %s, got %s %s on %s"
                         % (images.device, flips.dtype, tuple(flips.shape), flips.device))
    if images.device.type == "cpu":
        return _normalize_plain(images, mean, std, out_dtype, flips)
    if images.device.type != "cuda":
        raise ValueError("normalize_images runs on CPU or CUDA tensors, got %s"
                         % images.device)
    n, h, w, channels = images.shape
    if not 1 <= channels <= MAX_CHANNELS:
        raise ValueError("normalize_images kernel takes 1..%d channels, got %d"
                         % (MAX_CHANNELS, channels))
    images = images.contiguous()
    from petastorm_tpu_torch.ops import kernels

    _m, _i, mean_p, inv_p = _cached_constants(mean, std, channels)
    out = torch.empty(images.shape, dtype=out_dtype, device=images.device)
    x_ptr, out_ptr = images.data_ptr(), out.data_ptr()
    chosen, rows_per_tile = choose_route(images.shape, x_ptr, out_ptr, out.element_size(),
                                         route)
    if flips is not None:
        flips = flips.contiguous()
    rc = kernels.library().ptpu_normalize_u8(
        x_ptr, out_ptr, n, h, w, channels, mean_p, inv_p, out_kind,
        None if flips is None else flips.data_ptr(), ROUTES.index(chosen), rows_per_tile,
        *kernels.launch_target(images.device))
    kernels.check_launch("normalize_u8", rc)
    normalize_images.launches += 1
    normalize_images.routes[chosen] += 1
    return out


normalize_images.launches = 0
normalize_images.routes = dict.fromkeys(ROUTES, 0)


def normalize_and_augment(images, mean, std, generator=None, flip=True, out_dtype=None):
    """Train-time prep: normalise + per-image random horizontal flip, each image flipped
    with probability 1/2 drawn from ``generator`` (a ``torch.Generator`` on the images'
    device, or None for torch's default one). One K2 launch on a CUDA tensor."""
    import torch

    flips = None
    if flip:
        flips = torch.rand(images.shape[0], generator=generator,
                           device=images.device) < 0.5
    return normalize_images(images, mean, std, out_dtype=out_dtype, flips=flips)


def _crop_at(images, tops, lefts, crop_h, crop_w):
    """(N, H, W, C) → (N, crop_h, crop_w, C): image i cut at rows ``tops[i]`` and columns
    ``lefts[i]`` onwards ((N,) integer tensors on the images' device), as one gather (the
    JAX package's ``random_crop`` body)."""
    import torch

    n = images.shape[0]
    dev = images.device
    rows = tops.to(torch.int64)[:, None] + torch.arange(crop_h, device=dev)[None, :]
    cols = lefts.to(torch.int64)[:, None] + torch.arange(crop_w, device=dev)[None, :]
    batch = torch.arange(n, device=dev)[:, None, None]
    return images[batch, rows[:, :, None], cols[:, None, :], :]


def random_crop(images, generator, crop_h, crop_w):
    """Per-image random crop of an (N, H, W, C) batch to (N, crop_h, crop_w, C): offsets
    drawn uniformly from ``generator`` (a ``torch.Generator`` on the images' device, or
    None for torch's default one), every crop inside its image."""
    import torch

    n, h, w, _c = images.shape
    if not (0 < crop_h <= h and 0 < crop_w <= w):
        raise ValueError("random_crop: crop (%d, %d) does not fit images of (%d, %d)"
                         % (crop_h, crop_w, h, w))
    tops = torch.randint(0, h - crop_h + 1, (n,), generator=generator, device=images.device)
    lefts = torch.randint(0, w - crop_w + 1, (n,), generator=generator,
                          device=images.device)
    return _crop_at(images, tops, lefts, crop_h, crop_w)


def _jitter_with(images, fb, fc, fs):
    """The JAX package's ``color_jitter`` body with its factors given: ``fb``, ``fc``,
    ``fs`` (N, 1, 1, 1) float32 brightness, contrast and saturation factors (or None to
    skip that step), applied in float32; clipped to [0, 255] and cast back to the input
    dtype (truncating, for uint8)."""
    import torch

    dtype = images.dtype
    x = images.to(torch.float32)
    if fb is not None:
        x = x * fb
    if fc is not None:
        mean = x.mean(dim=(1, 2, 3), keepdim=True)
        x = (x - mean) * fc + mean
    if fs is not None:
        gray = x.mean(dim=-1, keepdim=True)
        x = (x - gray) * fs + gray
    return torch.clamp(x, 0.0, 255.0).to(dtype)


def color_jitter(images, generator, brightness=0.4, contrast=0.4, saturation=0.4):
    """Per-image random brightness, contrast and saturation (torchvision-style ranges:
    factor ~ U[1-x, 1+x]) of an (N, H, W, C) batch, same dtype out; the factors are drawn
    from ``generator`` (a ``torch.Generator`` on the images' device, or None)."""
    import torch

    n = images.shape[0]

    def factors(span):
        if not span:
            return None
        u = torch.rand((n, 1, 1, 1), generator=generator, device=images.device)
        return (1.0 - span) + (2.0 * span) * u

    fb = factors(brightness)
    fc = factors(contrast)
    fs = factors(saturation)
    return _jitter_with(images, fb, fc, fs)
