"""Card-side helpers of the port's ``gpu`` tests.

``plain_kernels()`` routes the hand-written kernels' wrappers of the JPEG path and K2 to
their plain PyTorch versions, which run on any device: inside it a decode on the card
takes the same steps on the same inputs through torch ops, so a test holds the kernel
path against the plain one on the card (``assert_card_matches_plain``).
``kernel_launches()`` reads the wrappers' launch counters.

The exact oracle of a decode is the CPU path: the plain versions on CPU tensors, which
equal the JAX package's stage 2 bit for bit. On a CUDA tensor the plain version of K1's
product runs in cuBLAS, whose summation order is neither the kernel's nor the CPU's:
its float32 sums differ in the last bits, and where one sits on a rounding tie a pixel
comes out one apart (ROADMAP Queue 3 AC)."""
import contextlib

import pytest


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def kernel_launches():
    """``{name: launches}`` of the JPEG path's kernels and K2."""
    from petastorm_tpu_torch.ops import image, jpeg

    return {"stage2_planes": jpeg.stage2_planes_segments.launches,
            "stage2_rgb": jpeg.stage2_rgb.launches,
            "unpack": jpeg.unpack_dequant_segments.launches,
            "idct": jpeg.idct_scaled_segments.launches,
            "normalize": image.normalize_images.launches}


def plain_differences(out, plain):
    """``(max abs difference, values that differ, values allowed to differ)`` between
    the kernel path's uint8 output and the plain versions' on the card. They are equal
    but where cuBLAS rounds a tie of K1's product the other way: at most 1 apart, in at
    most one value in a thousand (Queue 3 AC: 11 of the 36,864 values of one batch of
    eight 32x48 images)."""
    diff = (out.cpu().int() - plain.cpu().int()).abs()
    return int(diff.max()), int((diff > 0).sum()), max(1, out.numel() // 1000)


def assert_card_matches_plain(out, plain):
    assert out.shape == plain.shape and out.dtype == plain.dtype
    worst, off, allowed = plain_differences(out, plain)
    assert worst <= 1 and off <= allowed, (worst, off, allowed)


def launches_since(before):
    now = kernel_launches()
    return {name: now[name] - before[name] for name in now}


@contextlib.contextmanager
def plain_kernels():
    """Within the block, the wrappers of ``stage2_planes``, ``stage2_rgb``, the unpack,
    K1 and K2 run their plain versions on the tensors' own device."""
    import torch

    from petastorm_tpu_torch.ops import image, jpeg

    def planes(segments):
        return [jpeg._stage2_planes_plain(seg) for seg in segments]

    def rgb(planes_, layout, bgr=False):
        return jpeg._stage2_rgb_plain(planes_, layout, bgr)

    def unpack(segments):
        return [jpeg._unpack_dequant_plain(seg) for seg in segments]

    def idct(segments):
        return [jpeg._idct_scaled_plain(seg) for seg in segments]

    def normalize(images, mean, std, out_dtype=None, flips=None, route=None):
        return image._normalize_plain(images, mean, std,
                                      torch.bfloat16 if out_dtype is None else out_dtype,
                                      flips)

    swaps = [(jpeg, "stage2_planes_segments", planes), (jpeg, "stage2_rgb", rgb),
             (jpeg, "unpack_dequant_segments", unpack), (jpeg, "idct_scaled_segments", idct),
             (image, "normalize_images", normalize)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for (mod, name, fn), (_, _, orig) in zip(swaps, saved):
        fn.launches = orig.launches
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, orig in saved:
            setattr(mod, name, orig)
