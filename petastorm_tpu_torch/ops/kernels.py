"""The package's CUDA kernels: build from ``csrc/*.cu`` and bind with ctypes.

The sources compile with nvcc for ``sm_90a`` (one nvcc per source, all started together)
and link into one shared library with a plain C interface
(:mod:`petastorm_tpu_torch.ops._build`). Nothing builds or loads at import: the first
:func:`library` call does, from the wrapper that launches a kernel on a CUDA tensor.
The wrappers themselves live beside their plain PyTorch versions:
``ops.jpeg.stage2_planes_segments`` and ``ops.jpeg.stage2_rgb`` (the batched stage 2),
``ops.jpeg.unpack_dequant_segments`` (the standalone stage-2 unpack),
``ops.jpeg.idct_scaled_segments`` (K1), ``ops.image.normalize_images`` (K2), and
``ops.pagedec_kernels.snappy_inflate_ragged`` (K3), ``rle_scan_pages`` (the run scan)
and ``extract_pages`` (K4).
"""
from __future__ import annotations

import ctypes
import os
import shutil
import threading
import time

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
SOURCES = (os.path.join(_CSRC, "coef_unpack.cu"), os.path.join(_CSRC, "idct.cu"),
           os.path.join(_CSRC, "normalize.cu"), os.path.join(_CSRC, "pagedec.cu"),
           os.path.join(_CSRC, "stage2.cu"))
HEADERS = (os.path.join(_CSRC, "idct_tile.cuh"),)
ARCH_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a"]

_LOCK = threading.Lock()
_LIB = None
#: what the last build did: {"seconds": wall time, "log": compiler output (ptxas -v)}
BUILD_INFO = {}


class CoefSegmentDesc(ctypes.Structure):
    """One component of the stage-2 unpack (``csrc/coef_unpack.cu``'s struct)."""
    _fields_ = [
        ("src0", ctypes.c_void_p), ("src1", ctypes.c_void_p), ("src2", ctypes.c_void_p),
        ("qtab", ctypes.c_void_p), ("out", ctypes.c_void_p),
        ("rows", ctypes.c_int64), ("blocks_per_image", ctypes.c_int64),
        ("kind", ctypes.c_int32), ("k", ctypes.c_int32), ("k1", ctypes.c_int32),
        ("k2", ctypes.c_int32), ("zigzag", ctypes.c_int32), ("pad", ctypes.c_int32),
    ]


class PlaneSegmentDesc(ctypes.Structure):
    """One component of ``stage2_planes`` (``csrc/stage2.cu``'s struct)."""
    _fields_ = [
        ("src0", ctypes.c_void_p), ("src1", ctypes.c_void_p), ("src2", ctypes.c_void_p),
        ("qtab", ctypes.c_void_p), ("out", ctypes.c_void_p),
        ("rows", ctypes.c_int64), ("blocks_per_image", ctypes.c_int64),
        ("bx", ctypes.c_int32), ("kind", ctypes.c_int32), ("k", ctypes.c_int32),
        ("k1", ctypes.c_int32), ("k2", ctypes.c_int32), ("zigzag", ctypes.c_int32),
    ]


class RgbDesc(ctypes.Structure):
    """The arguments of ``stage2_rgb`` (``csrc/stage2.cu``'s struct)."""
    _fields_ = [
        ("plane", ctypes.c_void_p * 3), ("out", ctypes.c_void_p), ("images", ctypes.c_int64),
        ("rows", ctypes.c_int32 * 3), ("cols", ctypes.c_int32 * 3),
        ("ry", ctypes.c_int32 * 3), ("rx", ctypes.c_int32 * 3),
        ("height", ctypes.c_int32), ("width", ctypes.c_int32), ("ncomp", ctypes.c_int32),
        ("bgr", ctypes.c_int32),
    ]


def nvcc_path():
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on PATH, or the toolkit's
    default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def library():
    """The loaded kernel library (built on first call). Raises RuntimeError when it
    cannot be built or loaded."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        from petastorm_tpu_torch.ops._build import build_shared_library

        nvcc = nvcc_path()

        def compile_cmd(src, out):
            return [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-Xptxas", "-v",
                    "-Xcompiler", "-fPIC", "-c", src, "-o", out]

        def link_cmd(objects, out):
            return [nvcc, *ARCH_FLAGS, "-shared", "-o", out, *objects]

        t0 = time.perf_counter()
        try:
            path, log = build_shared_library("ptpu_torch_kernels", list(SOURCES),
                                             compile_cmd, link_cmd, timeout=600,
                                             headers=HEADERS)
        except FileNotFoundError as e:
            raise RuntimeError("CUDA kernels need nvcc (%s): %s" % (nvcc, e)) from e
        BUILD_INFO.update(seconds=time.perf_counter() - t0, log=log, path=path)
        lib = ctypes.CDLL(path)
        lib.ptpu_coef_unpack_segments.argtypes = [
            ctypes.POINTER(CoefSegmentDesc), ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.ptpu_coef_unpack_segments.restype = ctypes.c_int
        lib.ptpu_stage2_planes.argtypes = [
            ctypes.POINTER(PlaneSegmentDesc), ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p]
        lib.ptpu_stage2_planes.restype = ctypes.c_int
        lib.ptpu_stage2_rgb.argtypes = [ctypes.POINTER(RgbDesc), ctypes.c_int,
                                        ctypes.c_void_p]
        lib.ptpu_stage2_rgb.restype = ctypes.c_int
        lib.ptpu_idct_segments_f32.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p]
        lib.ptpu_idct_segments_f32.restype = ctypes.c_int
        lib.ptpu_normalize_u8.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        lib.ptpu_normalize_u8.restype = ctypes.c_int
        ptr, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.ptpu_snappy_ragged.argtypes = [ptr, i64, ptr, ptr, i64, ptr, i64, ctypes.c_int,
                                           ptr]
        lib.ptpu_snappy_ragged.restype = ctypes.c_int
        lib.ptpu_rle_scan_pages.argtypes = [ptr, i64, ptr, i64, ptr, i64, ptr, i64, ptr, i64,
                                            ptr, ptr, ctypes.c_int, ptr]
        lib.ptpu_rle_scan_pages.restype = ctypes.c_int
        lib.ptpu_extract_pages.argtypes = [ptr, i64, ptr, i64, ptr, i64, ptr, i64, ptr, i64,
                                           ptr, ptr, ptr, i64, ctypes.c_int, ptr]
        lib.ptpu_extract_pages.restype = ctypes.c_int
        _LIB = lib
        return _LIB


def check_launch(name, rc):
    """Raise when a kernel's C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError("CUDA kernel %s failed to launch: cudaError_t %d" % (name, rc))


def launch_target(device):
    """``(device index, raw cudaStream_t of torch's current stream there)`` for a launch.

    Asks torch's C layer for the raw stream where it offers that: much cheaper than
    building a ``torch.cuda.Stream`` object on every launch."""
    import torch

    index = torch.cuda.current_device() if device.index is None else device.index
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return index, raw(index)
    return index, torch.cuda.current_stream(index).cuda_stream
