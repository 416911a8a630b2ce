"""Host JPEG entropy decoder: ``jpeg_decoder.cpp`` built with g++ at first use, bound with ctypes.

Port of the loader half of ``petastorm_tpu.ops.native``: the C++ source is a byte-for-byte
copy of the JAX package's, built into ``petastorm_tpu_torch/_build/``
(:mod:`petastorm_tpu_torch.ops._build`). The ctypes calls release the GIL, so the reader's
thread pool runs stage 1 in parallel. Bound here: single-stream decode, layout parse, the
row-group batch decode, and the transfer packers of the JPEG path's narrowed coefficient
transfer (zigzag truncation, the spectral profile, the 12-bit and split packs). Each packer
takes an optional ``out=`` for its destination arrays, so the last pass can write straight
into a pinned staging slab; pointers cross as ``ctypes.c_void_p``.
"""
from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading

import numpy as np

logger = logging.getLogger(__name__)

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "jpeg_decoder.cpp")
_LOCK = threading.Lock()
_LIB = None
_LIB_ERR = None


class _JpegCoeffs(ctypes.Structure):
    _fields_ = [
        ("height", ctypes.c_int32),
        ("width", ctypes.c_int32),
        ("ncomp", ctypes.c_int32),
        ("h_samp", ctypes.c_int32 * 4),
        ("v_samp", ctypes.c_int32 * 4),
        ("blocks_y", ctypes.c_int32 * 4),
        ("blocks_x", ctypes.c_int32 * 4),
        ("blocks", ctypes.POINTER(ctypes.c_int16) * 4),
        ("qtables", (ctypes.c_uint16 * 64) * 4),
    ]


class _JpegLayout(ctypes.Structure):
    _fields_ = [
        ("height", ctypes.c_int32),
        ("width", ctypes.c_int32),
        ("ncomp", ctypes.c_int32),
        ("h_samp", ctypes.c_int32 * 4),
        ("v_samp", ctypes.c_int32 * 4),
        ("blocks_y", ctypes.c_int32 * 4),
        ("blocks_x", ctypes.c_int32 * 4),
    ]


def _compile_cmd(src, out):
    return ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-o", out, src]


def _load():
    global _LIB, _LIB_ERR
    if _LIB is not None or _LIB_ERR is not None:
        return _LIB
    with _LOCK:
        if _LIB is not None or _LIB_ERR is not None:
            return _LIB
        from petastorm_tpu_torch.ops._build import build_shared_library

        try:
            path, _ = build_shared_library("ptpu_torch_jpeg", [_SRC], _compile_cmd,
                                           timeout=180)
            lib = ctypes.CDLL(path)
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            _LIB_ERR = str(e)
            logger.warning("Native JPEG decoder unavailable (%s); stage 1 uses the "
                           "Python decoder", e)
            return None
        lib.ptpu_jpeg_decode_coeffs.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(_JpegCoeffs)]
        lib.ptpu_jpeg_decode_coeffs.restype = ctypes.c_int
        lib.ptpu_jpeg_free_coeffs.argtypes = [ctypes.POINTER(_JpegCoeffs)]
        lib.ptpu_jpeg_free_coeffs.restype = None
        lib.ptpu_jpeg_error_string.argtypes = [ctypes.c_int]
        lib.ptpu_jpeg_error_string.restype = ctypes.c_char_p
        lib.ptpu_jpeg_parse_layout.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(_JpegLayout)]
        lib.ptpu_jpeg_parse_layout.restype = ctypes.c_int
        lib.ptpu_jpeg_decode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int32, ctypes.POINTER(_JpegLayout),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int16)),
            ctypes.POINTER(ctypes.c_uint16), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32)]
        lib.ptpu_jpeg_decode_batch.restype = ctypes.c_int32
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
        lib.ptpu_jpeg_zigzag_truncate.argtypes = [ptr, ptr, i64, i32]
        lib.ptpu_jpeg_zigzag_truncate.restype = None
        lib.ptpu_jpeg_pack12.argtypes = [ptr, ptr, i64]
        lib.ptpu_jpeg_pack12.restype = i32
        lib.ptpu_jpeg_specmax.argtypes = [ptr, i64, i32, i32, ptr]
        lib.ptpu_jpeg_specmax.restype = None
        lib.ptpu_jpeg_pack_split.argtypes = [ptr, i64, i32, i32, i32, i32, ptr, ptr, ptr]
        lib.ptpu_jpeg_pack_split.restype = i32
        _LIB = lib
        return _LIB


def native_available():
    """True when the compiled decoder loaded (builds it on first call)."""
    return _load() is not None


def native_error():
    """Why native is unavailable (None when it loaded fine)."""
    _load()
    return _LIB_ERR


#: Error codes the decoder maps to ValueError (bad input) vs RuntimeError (internal).
_VALUE_ERRORS = {-1, -2, -3, -4, -5, -6}


def _raise_for(lib, rc):
    msg = lib.ptpu_jpeg_error_string(rc).decode()
    if rc in _VALUE_ERRORS:
        raise ValueError(msg)
    raise RuntimeError(msg)


def _require():
    lib = _load()
    if lib is None:
        raise RuntimeError("native jpeg decoder unavailable: %s" % _LIB_ERR)
    return lib


def jpeg_decode_coeffs_batch_native(blobs):
    """Entropy-decode a whole row group of same-layout JPEGs in ONE native call.

    Returns ``(layout, coeffs, qtabs, kmax, status)``: ``layout`` is
    ``(height, width, ((h_samp, v_samp, blocks_y, blocks_x), ...))`` from the first
    stream; ``coeffs`` one ``(n, blocks_y*blocks_x, 64)`` int16 array per component;
    ``qtabs`` ``(n, ncomp, 64)`` uint16 natural-order tables; ``kmax`` per component the
    max zigzag index any stream wrote; ``status`` ``(n,)`` int32, nonzero where that
    stream failed (its slice is zeroed; the caller re-decodes it on its own).

    Raises ValueError when the FIRST stream has no parseable baseline-or-progressive
    layout."""
    lib = _require()
    blobs = [bytes(b) for b in blobs]
    n = len(blobs)
    if n == 0:
        raise ValueError("empty batch")
    layout = _JpegLayout()
    rc = lib.ptpu_jpeg_parse_layout(blobs[0], len(blobs[0]), ctypes.byref(layout))
    if rc != 0:
        _raise_for(lib, rc)
    ncomp = layout.ncomp
    datas = (ctypes.c_char_p * n)(*blobs)
    lens = (ctypes.c_int64 * n)(*[len(b) for b in blobs])
    coeffs = []
    block_ptrs = (ctypes.POINTER(ctypes.c_int16) * 4)()
    for c in range(ncomp):
        arr = np.empty((n, layout.blocks_y[c] * layout.blocks_x[c], 64), dtype=np.int16)
        coeffs.append(arr)
        block_ptrs[c] = arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int16))
    qtabs = np.empty((n, ncomp, 64), dtype=np.uint16)
    kmax = np.zeros(4, dtype=np.int32)
    status = np.empty(n, dtype=np.int32)
    lib.ptpu_jpeg_decode_batch(
        datas, lens, n, ctypes.byref(layout), block_ptrs,
        qtabs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        kmax.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    layout_key = (
        layout.height,
        layout.width,
        tuple((layout.h_samp[c], layout.v_samp[c], layout.blocks_y[c], layout.blocks_x[c])
              for c in range(ncomp)),
    )
    return layout_key, tuple(coeffs), qtabs, tuple(int(k) for k in kmax[:ncomp]), status


def jpeg_decode_coeffs_native(data):
    """JPEG bytes → (height, width, [(blocks, qtable, h_samp, v_samp), ...]) via C++.

    ``blocks``: (blocks_y, blocks_x, 64) int16 natural-order quantized coefficients;
    ``qtable``: (64,) int32 natural order. Raises ValueError on malformed/unsupported
    streams and RuntimeError when the native library is unavailable."""
    lib = _require()
    raw = bytes(data)
    out = _JpegCoeffs()
    rc = lib.ptpu_jpeg_decode_coeffs(raw, len(raw), ctypes.byref(out))
    if rc != 0:
        _raise_for(lib, rc)
    try:
        comps = []
        for c in range(out.ncomp):
            by, bx = out.blocks_y[c], out.blocks_x[c]
            blocks = np.ctypeslib.as_array(out.blocks[c], shape=(by * bx * 64,)).copy()
            qtable = np.asarray(out.qtables[c], dtype=np.int32).copy()
            comps.append((blocks.reshape(by, bx, 64), qtable, out.h_samp[c], out.v_samp[c]))
        return out.height, out.width, comps
    finally:
        lib.ptpu_jpeg_free_coeffs(ctypes.byref(out))


def _coefficients(src, what):
    """``src`` as a C-contiguous (n, nblocks, k) int16 array (no copy when it is one)."""
    src = np.ascontiguousarray(src, dtype=np.int16)
    if src.ndim != 3:
        raise ValueError("%s takes (n, nblocks, k) coefficients, got shape %s"
                         % (what, src.shape))
    return src


def _destination(out, shape, dtype, what):
    """A fresh array of ``shape``/``dtype``, or ``out`` checked to be one (C-contiguous,
    writable) for the packer to fill in place."""
    if out is None:
        return np.empty(shape, dtype=dtype)
    if not isinstance(out, np.ndarray) or out.shape != tuple(shape) \
            or out.dtype != np.dtype(dtype) or not out.flags.c_contiguous \
            or not out.flags.writeable:
        raise ValueError("%s: out must be a writable C-contiguous %s array of shape %s, "
                         "got %s" % (what, np.dtype(dtype), tuple(shape),
                                     None if not isinstance(out, np.ndarray)
                                     else (out.dtype, out.shape)))
    return out


def _ptr(a):
    return ctypes.c_void_p(a.ctypes.data)


def jpeg_zigzag_truncate_native(src, k, out=None):
    """(n, nblocks, 64) int16 natural-order coefficients → (n, nblocks, k) int16
    zigzag-prefix pack (``dst[..., j] = src[..., zigzag_to_natural(j)]``), written into
    ``out`` when given. The caller guarantees all coefficients beyond zigzag index k-1 are
    zero (``kmax`` from the batch decode)."""
    lib = _require()
    src = _coefficients(src, "zigzag_truncate")
    n, nb, last = src.shape
    if last != 64:
        raise ValueError("expected trailing dim 64, got %d" % last)
    if not 1 <= int(k) <= 64:  # k > 64 would read past the zigzag table in C
        raise ValueError("k must be in [1, 64], got %r" % (k,))
    dst = _destination(out, (n, nb, int(k)), np.int16, "zigzag_truncate")
    lib.ptpu_jpeg_zigzag_truncate(_ptr(src), _ptr(dst), n * nb, int(k))
    return dst


def jpeg_pack12_native(src, out=None):
    """(n, nblocks, k) int16 coefficients → (n, nblocks, k*3//2) uint8 12-bit pack (two
    coefficients per 3 bytes), written into ``out`` when given; None when any value
    exceeds the 12-bit range (the caller ships int16; ``out`` is then partly written).
    ``k`` must be even."""
    lib = _require()
    src = _coefficients(src, "pack12")
    n, nb, k = src.shape
    if k % 2:
        raise ValueError("pack12 needs an even trailing dim, got %d" % k)
    dst = _destination(out, (n, nb, k * 3 // 2), np.uint8, "pack12")
    rc = lib.ptpu_jpeg_pack12(_ptr(src), _ptr(dst), n * nb * k)
    return dst if rc == 0 else None


def jpeg_specmax_native(src, is_zigzag=False):
    """(n, nblocks, k) int16 coefficients → (k,) int32 per-zigzag-position max |value|.

    ``is_zigzag`` says rows are zigzag-prefix packs (:func:`jpeg_zigzag_truncate_native`
    output); otherwise rows are natural order and k must be 64. The spectral range
    profile drives the per-position bit-width split (:func:`jpeg_pack_split_native`)."""
    lib = _require()
    src = _coefficients(src, "specmax")
    n, nb, k = src.shape
    if not is_zigzag and k != 64:
        raise ValueError("natural-order specmax needs trailing dim 64, got %d" % k)
    out = np.zeros(k, dtype=np.int32)
    lib.ptpu_jpeg_specmax(_ptr(src), n * nb, k, 1 if is_zigzag else 0, _ptr(out))
    return out


def jpeg_pack_split_native(src, k1, k2, is_zigzag=False, out=None):
    """Spectral-split pack: (n, nblocks, k) int16 → three slabs with per-zigzag-position
    bit widths (12-bit head [0, k1) as uint8, int8 mid [k1, k2), 4-bit nibble tail
    [k2, k) as uint8), written into ``out`` (a ``(head, mid, tail)`` triple) when given;
    None when any value exceeds its tier's range (the caller falls back to a wider pack).
    k1 and k - k2 must be even; 0 <= k1 <= k2 <= k. Zero-width slabs come back empty."""
    lib = _require()
    src = _coefficients(src, "pack_split")
    n, nb, k = src.shape
    k1, k2 = int(k1), int(k2)
    if not 0 <= k1 <= k2 <= k:
        raise ValueError("need 0 <= k1 <= k2 <= k, got k1=%d k2=%d k=%d" % (k1, k2, k))
    if k1 % 2 or (k - k2) % 2:
        raise ValueError("k1 and k - k2 must be even, got k1=%d k2=%d k=%d" % (k1, k2, k))
    if not is_zigzag and k != 64:
        raise ValueError("natural-order pack_split needs trailing dim 64, got %d" % k)
    outs = (None, None, None) if out is None else tuple(out)
    if len(outs) != 3:
        raise ValueError("pack_split: out must be a (head, mid, tail) triple")
    head = _destination(outs[0], (n, nb, k1 * 3 // 2), np.uint8, "pack_split head")
    mid = _destination(outs[1], (n, nb, k2 - k1), np.int8, "pack_split mid")
    tail = _destination(outs[2], (n, nb, (k - k2) // 2), np.uint8, "pack_split tail")
    rc = lib.ptpu_jpeg_pack_split(_ptr(src), n * nb, k, 1 if is_zigzag else 0, k1, k2,
                                  _ptr(head), _ptr(mid), _ptr(tail))
    return (head, mid, tail) if rc == 0 else None
