"""Two-stage JPEG decode: host entropy decode → device dequant + IDCT + colour, in torch.

Port of ``petastorm_tpu.ops.jpeg``:

- **Stage 1 (host)**: :func:`entropy_decode_jpeg` (pure-Python oracle, baseline only),
  :func:`entropy_decode_jpeg_fast` (the C++ decoder, baseline and progressive) and
  :func:`entropy_decode_jpeg_batch` (one native call per row group) turn JPEG bytes into
  *quantized DCT coefficient blocks* per component (:class:`JpegPlanes`).
- **Stage 2 (device)**: :func:`decode_jpeg_batch` dequantises, runs the 8x8 inverse DCT
  as one (N, 64) @ (64, 64) product per component (:func:`idct_scaled_segments`, the CUDA
  kernel K1 on CUDA tensors, one launch for a batch's components), range-limits,
  upsamples chroma with libjpeg's triangle filter and converts YCbCr to RGB. The
  operations around the IDCT are plain torch ops, as they sit outside the Pallas kernel
  in the JAX package too.

Stage 2 ships full int16 coefficients (k = 64). The JAX package's H2D byte savers (12-bit,
zigzag-truncated and split packs) and ``resize_image_batch`` are not ported yet.
"""
from __future__ import annotations

import dataclasses
import functools
import struct
import threading

import numpy as np

# -- zigzag order (JPEG spec, Figure A.6) ----------------------------------------------

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
], dtype=np.int32)
UNZIGZAG = np.argsort(ZIGZAG)


@dataclasses.dataclass
class JpegComponent:
    blocks: np.ndarray      # (blocks_y, blocks_x, 64) int, natural (unzigzagged) order
    qtable: np.ndarray      # (64,) int32, natural order
    h_samp: int
    v_samp: int


@dataclasses.dataclass
class JpegPlanes:
    height: int
    width: int
    components: list        # [Y, Cb, Cr] or [Y]
    #: set by the row-group batched stage 1: ``(coeffs_tuple, qtabs_array, row_index)``
    #: where each component's ``blocks`` is a zero-copy view into ``coeffs_tuple[c]``,
    #: so :func:`stack_jpeg_coefficients` can slice the parent buffers.
    batch_ref: tuple | None = None
    #: per component, the max zigzag index with any nonzero coefficient (row group)
    kmax: tuple | None = None

    def detach(self):
        """An equivalent ``JpegPlanes`` that owns its coefficients: a ``batch_ref`` row
        pins its whole row group's buffers, so rows that linger (a shuffling buffer)
        are detached."""
        if self.batch_ref is None:
            return self
        comps = [JpegComponent(c.blocks.copy(), c.qtable.copy(), c.h_samp, c.v_samp)
                 for c in self.components]
        return JpegPlanes(self.height, self.width, comps, batch_ref=None, kmax=self.kmax)


def planes_from_arrays(height, width, components):
    """Build :class:`JpegPlanes` from plain numpy: ``components`` is a sequence of
    ``(blocks, qtable, h_samp, v_samp)``, blocks ``(blocks_y, blocks_x, 64)`` natural
    order. The bridge that hands another stage 1's output (e.g. the JAX package's) to
    this package's stage 2."""
    return JpegPlanes(int(height), int(width), [
        JpegComponent(np.asarray(blocks), np.asarray(qtable, dtype=np.int32),
                      int(h), int(v))
        for blocks, qtable, h, v in components])


class _HuffTable:
    __slots__ = ("lookup", "max_len")

    def __init__(self, counts, symbols):
        self.lookup = {}
        code = 0
        k = 0
        self.max_len = 0
        for length in range(1, 17):
            for _ in range(counts[length - 1]):
                self.lookup[(length, code)] = symbols[k]
                self.max_len = length
                code += 1
                k += 1
            code <<= 1


class _BitReader:
    """MSB-first bit reader over an entropy-coded segment with 0xFF00 byte-stuffing."""

    __slots__ = ("data", "pos", "bitbuf", "bitcnt")

    def __init__(self, data, pos):
        self.data = data
        self.pos = pos
        self.bitbuf = 0
        self.bitcnt = 0

    def _fill(self):
        while self.bitcnt <= 24:
            if self.pos >= len(self.data):
                b = 0  # pad with zeros past the end (spec allows)
            else:
                b = self.data[self.pos]
                if b == 0xFF:
                    nxt = self.data[self.pos + 1] if self.pos + 1 < len(self.data) else 0xD9
                    if nxt == 0x00:
                        self.pos += 2  # byte-stuffed 0xFF data byte
                    else:
                        # restart or real marker: stop feeding real bytes, pad zeros
                        # (align_restart advances past RSTn when the caller asks)
                        b = 0
                else:
                    self.pos += 1
            self.bitbuf = (self.bitbuf << 8) | b
            self.bitcnt += 8

    def read_bit(self):
        if self.bitcnt == 0:
            self._fill()
        self.bitcnt -= 1
        return (self.bitbuf >> self.bitcnt) & 1

    def read_bits(self, n):
        v = 0
        for _ in range(n):
            v = (v << 1) | self.read_bit()
        return v

    def align_restart(self):
        """Skip to just past the next RSTn marker; reset bit state."""
        self.bitbuf = 0
        self.bitcnt = 0
        d = self.data
        while self.pos + 1 < len(d):
            if d[self.pos] == 0xFF and 0xD0 <= d[self.pos + 1] <= 0xD7:
                self.pos += 2
                return
            self.pos += 1

    def decode_huff(self, table):
        length = 0
        code = 0
        while length < 16:
            code = (code << 1) | self.read_bit()
            length += 1
            sym = table.lookup.get((length, code))
            if sym is not None:
                return sym
        raise ValueError("Invalid Huffman code in JPEG stream")


def _extend(v, t):
    """JPEG EXTEND: map t-bit magnitude to signed value."""
    return v if v >= (1 << (t - 1)) else v - (1 << t) + 1


def entropy_decode_jpeg(data):
    """Baseline-JPEG stage 1: bytes → :class:`JpegPlanes` of quantized DCT blocks."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("Not a JPEG (missing SOI)")
    pos = 2
    qtables = {}
    huff_dc, huff_ac = {}, {}
    frame = None
    restart_interval = 0
    while pos < len(data):
        if data[pos] != 0xFF:
            pos += 1
            continue
        marker = data[pos + 1]
        pos += 2
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            continue
        if marker == 0xD9:  # EOI
            break
        (seglen,) = struct.unpack(">H", data[pos: pos + 2])
        seg = data[pos + 2: pos + seglen]
        if marker == 0xDB:  # DQT
            s = 0
            while s < len(seg):
                pq, tq = seg[s] >> 4, seg[s] & 0xF
                s += 1
                if pq:
                    q = np.frombuffer(seg[s: s + 128], dtype=">u2").astype(np.int32)
                    s += 128
                else:
                    q = np.frombuffer(seg[s: s + 64], dtype=np.uint8).astype(np.int32)
                    s += 64
                qtables[tq] = q  # kept in zigzag order; unzigzagged in _decode_scan
        elif marker == 0xC0 or marker == 0xC1:  # SOF0/1 baseline
            precision, h, w, nc = seg[0], struct.unpack(">H", seg[1:3])[0], \
                struct.unpack(">H", seg[3:5])[0], seg[5]
            if precision != 8:
                raise ValueError("Only 8-bit baseline JPEG supported")
            comps = []
            for i in range(nc):
                cid, samp, tq = seg[6 + 3 * i], seg[7 + 3 * i], seg[8 + 3 * i]
                comps.append({"id": cid, "h": samp >> 4, "v": samp & 0xF, "tq": tq})
            frame = {"h": h, "w": w, "comps": comps}
        elif marker in (0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF):
            raise ValueError("Unsupported JPEG mode (progressive/lossless); marker %02x"
                             % marker)
        elif marker == 0xC4:  # DHT
            s = 0
            while s < len(seg):
                tc, th = seg[s] >> 4, seg[s] & 0xF
                counts = list(seg[s + 1: s + 17])
                total = sum(counts)
                symbols = list(seg[s + 17: s + 17 + total])
                table = _HuffTable(counts, symbols)
                (huff_dc if tc == 0 else huff_ac)[th] = table
                s += 17 + total
        elif marker == 0xDD:  # DRI
            restart_interval = struct.unpack(">H", seg[:2])[0]
        elif marker == 0xDA:  # SOS
            ns = seg[0]
            scan = []
            for i in range(ns):
                cs, tables = seg[1 + 2 * i], seg[2 + 2 * i]
                scan.append({"id": cs, "dc": tables >> 4, "ac": tables & 0xF})
            return _decode_scan(data, pos + seglen, frame, scan, qtables,
                                huff_dc, huff_ac, restart_interval)
        pos += seglen
    raise ValueError("No SOS marker found")


def _decode_scan(data, pos, frame, scan, qtables, huff_dc, huff_ac, restart_interval):
    h, w, comps = frame["h"], frame["w"], frame["comps"]
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    mcus_x = -(-w // (8 * hmax))
    mcus_y = -(-h // (8 * vmax))
    out = []
    for c in comps:
        bx = mcus_x * c["h"]
        by = mcus_y * c["v"]
        out.append(np.zeros((by, bx, 64), np.int32))

    reader = _BitReader(data, pos)
    pred = [0] * len(comps)
    mcu_count = 0
    for my in range(mcus_y):
        for mx in range(mcus_x):
            if restart_interval and mcu_count and mcu_count % restart_interval == 0:
                reader.align_restart()
                pred = [0] * len(comps)
            for ci, c in enumerate(comps):
                sc = next(s for s in scan if s["id"] == c["id"])
                dc_t, ac_t = huff_dc[sc["dc"]], huff_ac[sc["ac"]]
                for v in range(c["v"]):
                    for hh in range(c["h"]):
                        block = np.zeros(64, np.int32)
                        t = reader.decode_huff(dc_t)
                        diff = _extend(reader.read_bits(t), t) if t else 0
                        pred[ci] += diff
                        block[0] = pred[ci]
                        k = 1
                        while k < 64:
                            rs = reader.decode_huff(ac_t)
                            r, s = rs >> 4, rs & 0xF
                            if s == 0:
                                if r == 15:
                                    k += 16
                                    continue
                                break  # EOB
                            k += r
                            if k > 63:
                                break
                            block[k] = _extend(reader.read_bits(s), s)
                            k += 1
                        out[ci][my * c["v"] + v, mx * c["h"] + hh] = block[UNZIGZAG]
            mcu_count += 1

    components = []
    for ci, c in enumerate(comps):
        q = qtables[c["tq"]][UNZIGZAG].astype(np.int32)
        components.append(JpegComponent(out[ci], q, c["h"], c["v"]))
    return JpegPlanes(height=h, width=w, components=components)


# -- fast stage 1 (native C++ behind the same contract) --------------------------------


def entropy_decode_jpeg_fast(data):
    """Stage 1 via the compiled C++ decoder (:mod:`petastorm_tpu_torch.ops.native`);
    the pure-Python oracle when the native build is unavailable.

    Raises ValueError on streams the two-stage path cannot handle (lossless/arithmetic,
    CMYK, corrupt): the codec layer catches that and decodes that row on the host."""
    from petastorm_tpu_torch.ops import native

    if native.native_available():
        height, width, comps = native.jpeg_decode_coeffs_native(data)
        planes = JpegPlanes(height=height, width=width, components=[
            JpegComponent(blocks, qtable, h, v) for blocks, qtable, h, v in comps])
    else:
        planes = entropy_decode_jpeg(data)
    if len(planes.components) not in (1, 3):
        raise ValueError("Unsupported JPEG component count %d (expected 1 or 3)"
                         % len(planes.components))
    return planes


def entropy_decode_jpeg_batch(blobs):
    """Row-group batched stage 1: list of JPEG byte strings → list of :class:`JpegPlanes`
    (``None`` per stream the batch decoder could not handle; the caller re-decodes
    those one by one).

    One native call decodes every same-layout stream straight into stacked coefficient
    buffers (GIL released throughout); each returned ``JpegPlanes`` holds zero-copy
    views into them plus a ``batch_ref``. Raises RuntimeError when the native decoder is
    unavailable and ValueError when the first stream has no usable layout."""
    from petastorm_tpu_torch.ops import native

    if not native.native_available():
        raise RuntimeError("native jpeg decoder unavailable: %s" % native.native_error())
    layout, coeffs, qtabs, kmax, status = native.jpeg_decode_coeffs_batch_native(blobs)
    height, width, comps_layout = layout
    if len(comps_layout) not in (1, 3):
        raise ValueError("Unsupported JPEG component count %d (expected 1 or 3)"
                         % len(comps_layout))
    qtabs = qtabs.astype(np.int32)
    out = []
    for i in range(len(blobs)):
        if status[i] != 0:
            out.append(None)
            continue
        comps = [JpegComponent(coeffs[c][i].reshape(by, bx, 64), qtabs[i, c], h, v)
                 for c, (h, v, by, bx) in enumerate(comps_layout)]
        out.append(JpegPlanes(height, width, comps, batch_ref=(coeffs, qtabs, i),
                              kmax=kmax))
    return out


# -- stage 2: device --------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _idct_basis():
    """(64, 64) flattened 2-D IDCT basis: pixels_flat = coeffs_flat @ B."""
    a = np.zeros((8, 8), np.float64)
    for u in range(8):
        alpha = np.sqrt(0.25) if u else np.sqrt(0.125)
        for p in range(8):
            a[u, p] = alpha * np.cos((2 * p + 1) * u * np.pi / 16.0)
    return np.kron(a, a).astype(np.float32)  # rows (u,v) -> cols (p,q)


_basis_lock = threading.Lock()
_basis_by_device = {}


def _basis_on(device):
    """The IDCT basis as a float32 tensor on ``device`` (one upload per device)."""
    import torch

    key = str(device)
    basis = _basis_by_device.get(key)
    if basis is None:
        with _basis_lock:
            basis = _basis_by_device.get(key)
            if basis is None:
                basis = torch.from_numpy(_idct_basis()).to(device)
                if basis.is_cuda:
                    # uploaded on whatever stream is current; later users may be on others
                    torch.cuda.current_stream(basis.device).synchronize()
                _basis_by_device[key] = basis
    return basis


def _idct_scaled_plain(scaled):
    """Plain PyTorch version of K1: (N, 64) float32 @ basis + 128, in full float32
    (TF32 off for the product)."""
    import torch

    basis = _basis_on(scaled.device)
    if not scaled.is_cuda:
        return torch.matmul(scaled, basis) + 128.0
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.matmul(scaled, basis) + 128.0
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


_MAX_IDCT_SEGMENTS = 4  # csrc/idct.cu kMaxSegments


def idct_scaled_segments(segments):
    """A list of (N_i, 64) dequantized float32 coefficient tensors (a batch's colour
    components, all on one device) → the list of (N_i, 64) pixel blocks (+128 level
    shift), in order.

    K1: on CUDA tensors, the hand-written kernel ``csrc/idct.cu`` (port of
    ``petastorm_tpu/ops/jpeg.py:311 _idct_kernel``), ONE launch for every segment; on CPU
    tensors, the plain version per segment. ``idct_scaled_segments.launches`` counts
    kernel launches."""
    import torch

    segments = list(segments)
    if not 1 <= len(segments) <= _MAX_IDCT_SEGMENTS:
        raise ValueError("idct_scaled_segments takes 1..%d segments, got %d"
                         % (_MAX_IDCT_SEGMENTS, len(segments)))
    device = segments[0].device
    for scaled in segments:
        if scaled.dim() != 2 or scaled.shape[1] != 64:
            raise ValueError("idct_scaled takes (N, 64) rows, got %s"
                             % (tuple(scaled.shape),))
        if scaled.dtype != torch.float32:
            raise TypeError("idct_scaled takes float32, got %s" % scaled.dtype)
        if scaled.device != device:
            raise ValueError("idct_scaled_segments: segments on %s and %s"
                             % (device, scaled.device))
    if device.type == "cpu":
        return [_idct_scaled_plain(scaled) for scaled in segments]
    if device.type != "cuda":
        raise ValueError("idct_scaled runs on CPU or CUDA tensors, got %s" % device)
    import ctypes

    from petastorm_tpu_torch.ops import kernels

    for scaled in segments:
        if not scaled.is_contiguous() or scaled.data_ptr() % 16:
            raise ValueError("idct_scaled needs contiguous, 16-byte aligned inputs")
    basis = _basis_on(device)
    outs = [torch.empty_like(scaled) for scaled in segments]
    n = len(segments)
    ins = (ctypes.c_void_p * n)(*[t.data_ptr() for t in segments])
    out_ptrs = (ctypes.c_void_p * n)(*[t.data_ptr() for t in outs])
    rows = (ctypes.c_int64 * n)(*[t.shape[0] for t in segments])
    rc = kernels.library().ptpu_idct_segments_f32(ins, out_ptrs, rows, n, basis.data_ptr(),
                                                  *kernels.launch_target(device))
    kernels.check_launch("idct_segments_f32", rc)
    idct_scaled_segments.launches += 1
    return outs


idct_scaled_segments.launches = 0


def idct_scaled(scaled):
    """(N, 64) dequantized float32 coefficients → (N, 64) pixel blocks (+128 level shift):
    the one-segment case of :func:`idct_scaled_segments` (K1 on a CUDA tensor, the plain
    version on a CPU tensor)."""
    return idct_scaled_segments([scaled])[0]


def idct_blocks(coeffs, qtable):
    """(N, 64) quantized coefficients → (N, 64) pixel blocks (dequant + IDCT + shift)."""
    scaled = coeffs.float() * qtable.float()[None, :]
    return idct_scaled(scaled.contiguous())


def _fancy_upsample2(plane, axis):
    """libjpeg 'fancy' 2x upsampling along ``axis``: triangle filter (3*near + far) / 4,
    edges clamped."""
    import torch

    plane = plane.movedim(axis, 0)
    prev = torch.cat([plane[:1], plane[:-1]], dim=0)
    nxt = torch.cat([plane[1:], plane[-1:]], dim=0)
    even = (3.0 * plane + prev) * 0.25
    odd = (3.0 * plane + nxt) * 0.25
    out = torch.stack([even, odd], dim=1).reshape((-1,) + tuple(plane.shape[1:]))
    return out.movedim(0, axis)


def ycbcr_to_rgb(y, cb, cr, bgr=False):
    """JFIF YCbCr → RGB (float in, float out, unclamped); ``bgr`` stacks B, G, R."""
    import torch

    r = y + 1.402 * (cr - 128.0)
    g = y - 0.344136 * (cb - 128.0) - 0.714136 * (cr - 128.0)
    b = y + 1.772 * (cb - 128.0)
    return torch.stack([b, g, r] if bgr else [r, g, b], dim=-1)


def _to_uint8(x):
    import torch

    return torch.clamp(torch.round(x), 0, 255).to(torch.uint8)


def decode_jpeg_device_stage(planes, device=None):
    """Stage 2 of one image: :class:`JpegPlanes` → (h, w, 3) uint8 RGB tensor on
    ``device`` (grayscale → 3 channels)."""
    import torch

    device = _resolve_device(device)
    outs = []
    for comp in planes.components:
        by, bx, _ = comp.blocks.shape
        coeffs = torch.from_numpy(np.ascontiguousarray(comp.blocks.reshape(-1, 64))).to(device)
        qtable = torch.from_numpy(np.asarray(comp.qtable, dtype=np.int32)).to(device)
        pix = idct_blocks(coeffs, qtable)
        # libjpeg range-limits every sample at IDCT output, before upsampling/color
        pix = torch.clamp(torch.round(pix), 0.0, 255.0)
        outs.append(pix.reshape(by, bx, 8, 8).permute(0, 2, 1, 3).reshape(by * 8, bx * 8))
    hmax = max(c.h_samp for c in planes.components)
    vmax = max(c.v_samp for c in planes.components)
    full = []
    for comp, plane in zip(planes.components, outs):
        ry, rx = vmax // comp.v_samp, hmax // comp.h_samp
        for axis, r in ((0, ry), (1, rx)):
            if r == 2:
                plane = _fancy_upsample2(plane, axis)
            elif r > 1:
                plane = torch.repeat_interleave(plane, r, dim=axis)
        full.append(plane[: planes.height, : planes.width])
    if len(full) == 1:
        y = torch.clamp(full[0], 0, 255).to(torch.uint8)
        return torch.stack([y, y, y], dim=-1)
    return _to_uint8(ycbcr_to_rgb(full[0], full[1], full[2]))


# -- batched stage 2 (one IDCT launch per batch) --------------------------------------


def _layout_key(planes):
    """Hashable decode layout: everything that shapes the batched program."""
    return (
        planes.height,
        planes.width,
        tuple((c.h_samp, c.v_samp, c.blocks.shape[0], c.blocks.shape[1])
              for c in planes.components),
    )


def _batched_stage2(layout, coeffs, qtabs, bgr=False):
    """Same-layout batch on device: per component ``(n, by*bx, 64)`` int16 coefficients
    and ``(n, 64)`` int32 quantisation tables (per image: quality may vary) →
    ``(n, h, w, 3)`` uint8, RGB or (``bgr``) BGR. One K1 launch for all components."""
    import torch

    height, width, comp_layout = layout
    hmax = max(h for h, _v, _by, _bx in comp_layout)
    vmax = max(v for _h, v, _by, _bx in comp_layout)
    n = coeffs[0].shape[0]
    scaled = [(coef.float() * qtab.float()[:, None, :]).reshape(n * by * bx, 64)
              for (_h, _v, by, bx), coef, qtab in zip(comp_layout, coeffs, qtabs)]
    planes = []
    for (h_samp, v_samp, by, bx), pix in zip(comp_layout, idct_scaled_segments(scaled)):
        pix = torch.clamp(torch.round(pix), 0.0, 255.0)  # libjpeg range-limits at IDCT out
        plane = pix.reshape(n, by, bx, 8, 8).permute(0, 1, 3, 2, 4).reshape(n, by * 8, bx * 8)
        ry, rx = vmax // v_samp, hmax // h_samp
        for axis, r in ((1, ry), (2, rx)):
            if r == 2:
                plane = _fancy_upsample2(plane, axis)
            elif r > 1:
                plane = torch.repeat_interleave(plane, r, dim=axis)
        planes.append(plane[:, :height, :width])
    if len(planes) == 1:
        y = torch.clamp(planes[0], 0, 255).to(torch.uint8)
        return torch.stack([y, y, y], dim=-1)
    return _to_uint8(ycbcr_to_rgb(planes[0], planes[1], planes[2], bgr=bgr))


def stack_jpeg_coefficients(planes_list, out=None):
    """Stack same-layout :class:`JpegPlanes` into per-component batch arrays.

    Returns ``(coeffs, qtabs)``: tuples with one ``(n, by*bx, 64)`` int16 and one
    ``(n, 64)`` int32 array per component, written into ``out`` (a ``(coeffs, qtabs)``
    pair of such arrays, e.g. views into a pinned staging slab) when given. Rows of one
    row group (``batch_ref``) are gathered from their parent buffers with one ``take``
    per parent and component; other rows are copied one by one."""
    ncomp = len(planes_list[0].components)
    n = len(planes_list)
    if out is None:
        blocks = [c.blocks.shape[0] * c.blocks.shape[1] for c in planes_list[0].components]
        out = (tuple(np.empty((n, nb, 64), np.int16) for nb in blocks),
               tuple(np.empty((n, 64), np.int32) for _ in blocks))
    coeffs, qtabs = out
    by_parent = {}
    for j, p in enumerate(planes_list):
        ref = p.batch_ref
        if ref is None:
            for c, comp in enumerate(p.components):
                coeffs[c][j] = comp.blocks.reshape(-1, 64)
                qtabs[c][j] = comp.qtable
            continue
        group = by_parent.setdefault(id(ref[0]), (ref[0], ref[1], [], []))
        group[2].append(j)
        group[3].append(ref[2])
    for parent_coeffs, parent_qtabs, positions, rows in by_parent.values():
        rows = np.asarray(rows, dtype=np.intp)
        first, last = positions[0], positions[-1]
        contiguous = last - first + 1 == len(positions)
        for c in range(ncomp):
            if contiguous:  # positions ascend: one gather straight into the output
                np.take(parent_coeffs[c], rows, axis=0, out=coeffs[c][first:last + 1],
                        mode="clip")
                qtabs[c][first:last + 1] = parent_qtabs[rows, c, :]
            else:
                coeffs[c][positions] = parent_coeffs[c][rows]
                qtabs[c][positions] = parent_qtabs[rows, c, :]
    return tuple(coeffs), tuple(qtabs)


def _resolve_device(device):
    import torch

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: petastorm_tpu_torch runs on the GPU unless the caller "
                "asks for the CPU (device='cpu')")
        return torch.device("cuda")
    return torch.device(device)


def _stack_to_device(group, layout, device, stager):
    """Stack a same-layout group's coefficients and tables and put them on ``device``:
    straight into a slab of ``stager`` (the loader's pinned staging ring, whose
    ``reserve`` hands out the host views) when given, else through numpy."""
    import torch

    if stager is not None and device.type == "cuda":
        n = len(group)
        specs = [((n, by * bx, 64), np.int16) for _h, _v, by, bx in layout[2]]
        specs += [((n, 64), np.int32)] * len(layout[2])
        views, upload = stager.reserve(specs)
        ncomp = len(layout[2])
        stack_jpeg_coefficients(group, out=(views[:ncomp], views[ncomp:]))
        return upload(device)
    coeffs, qtabs = stack_jpeg_coefficients(group)
    tensors = [torch.from_numpy(a) for a in coeffs + qtabs]
    return tensors if device.type == "cpu" else [t.to(device) for t in tensors]


def decode_jpeg_batch(planes_list, device=None, bgr=False, stager=None):
    """Batched stage 2: list of :class:`JpegPlanes` → (n, h, w, 3) uint8 tensor on
    ``device`` (default: the CUDA device; raises when there is none).

    All images must share height/width; mixed chroma samplings are grouped, decoded per
    group and gathered back in input order. ``bgr`` returns the stored channel order of
    colour JPEGs (what cv2 returns) instead of RGB. ``stager``: optional
    :class:`~petastorm_tpu_torch.io.staging.PinnedStagingPool` the coefficient slabs are
    stacked into and uploaded from (the loader's)."""
    import torch

    if not planes_list:
        raise ValueError("decode_jpeg_batch: empty batch")
    device = _resolve_device(device)
    sizes = {(p.height, p.width) for p in planes_list}
    if len(sizes) > 1:
        raise ValueError(
            "decode_jpeg_batch requires a uniform image size per batch, got %s. Resize "
            "on write or decode on host via CompressedImageCodec.decode (the on-device "
            "resize is not ported yet)." % sizes)
    groups = {}
    for i, p in enumerate(planes_list):
        groups.setdefault(_layout_key(p), []).append(i)
    parts = []
    order = []
    for layout, indices in groups.items():
        group = [planes_list[i] for i in indices]
        ncomp = len(layout[2])
        on_device = _stack_to_device(group, layout, device, stager)
        parts.append(_batched_stage2(layout, on_device[:ncomp], on_device[ncomp:], bgr))
        order.extend(indices)
    if len(parts) == 1:
        return parts[0]
    stacked = torch.cat(parts, dim=0)
    inverse = torch.from_numpy(np.argsort(np.asarray(order))).to(device)
    return stacked.index_select(0, inverse)
