"""Two-stage JPEG decode: host entropy decode → device dequant + IDCT + colour, in torch.

Port of ``petastorm_tpu.ops.jpeg``:

- **Stage 1 (host)**: :func:`entropy_decode_jpeg` (pure-Python oracle, baseline only),
  :func:`entropy_decode_jpeg_fast` (the C++ decoder, baseline and progressive) and
  :func:`entropy_decode_jpeg_batch` (one native call per row group, with the row group's
  spectral profile ``specmax``) turn JPEG bytes into *quantized DCT coefficient blocks*
  per component (:class:`JpegPlanes`).
- **The transfer**: :func:`decode_jpeg_batch` ships only what the content needs, with the
  JAX package's rules (``_decode_group``): the zigzag prefix when the rest of the
  spectrum is zero (:func:`_truncation_ks`), a per-position bit-width split from the
  profile (:func:`_split_points`), else a 12-bit pack, else int16; all of a batch's groups
  are packed into one pinned staging region and cross in ONE upload
  (:func:`transfer_byte_counters` counts the bytes).
- **Stage 2 (device)**, two launches a layout group (``csrc/stage2.cu`` on CUDA
  tensors): :func:`stage2_planes_segments` unpacks and dequantises each component's
  shipped slabs, runs the 8x8 inverse DCT (K1's product) and range-limits into uint8
  planes; :func:`stage2_rgb` upsamples the chroma with libjpeg's triangle filter, crops
  and converts YCbCr to RGB. The per-image stage 2 (:func:`decode_jpeg_device_stage`)
  keeps the standalone kernels (:func:`idct_blocks`: the unpack
  :func:`unpack_dequant_segments`, ``csrc/coef_unpack.cu``, then K1,
  ``csrc/idct.cu``) and plain torch ops around them.
  :func:`resize_image_batch` resizes a mixed-size batch's groups to one size.
"""
from __future__ import annotations

import collections
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
    #: ``(ncomp, 64)`` int32 per-zigzag-position max |coefficient| over the row group
    #: (one array shared by the group's rows): drives the split transfer. None when
    #: stage 1 did not profile the spectrum (per-image stage 1).
    specmax: object = None

    def detach(self):
        """An equivalent ``JpegPlanes`` that owns its coefficients, so rows that linger
        (a shuffling buffer, a padded tail) are detached: a ``batch_ref`` row pins its
        whole row group's buffers, and a row rebuilt from a view wire holds read-only
        views into a pool slab that is rewritten once its lease is released. A row that
        owns writable arrays comes back as it is; a writable ``specmax`` stays shared
        (small, never written)."""
        specmax = self.specmax
        spec_view = isinstance(specmax, np.ndarray) and not specmax.flags.writeable
        if self.batch_ref is None and not spec_view and all(
                c.blocks.flags.writeable and c.qtable.flags.writeable
                for c in self.components):
            return self
        comps = [JpegComponent(c.blocks.copy(), c.qtable.copy(), c.h_samp, c.v_samp)
                 for c in self.components]
        return JpegPlanes(self.height, self.width, comps, batch_ref=None, kmax=self.kmax,
                          specmax=specmax.copy() if spec_view else specmax)

    def __reduce__(self):
        # a pickle carries this row only, not its row group's buffers (batch_ref)
        d = self.detach()
        return (JpegPlanes, (d.height, d.width, d.components, None, d.kmax, d.specmax))


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
    # the row group's spectral profile, one native pass a component over the stacked
    # buffers (failed streams' slices are zeroed, so they cannot widen it)
    specmax = np.stack([native.jpeg_specmax_native(c) for c in coeffs])
    out = []
    for i in range(len(blobs)):
        if status[i] != 0:
            out.append(None)
            continue
        comps = [JpegComponent(coeffs[c][i].reshape(by, bx, 64), qtabs[i, c], h, v)
                 for c, (h, v, by, bx) in enumerate(comps_layout)]
        out.append(JpegPlanes(height, width, comps, batch_ref=(coeffs, qtabs, i),
                              kmax=kmax, specmax=specmax))
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
    """(N, 64) quantized coefficients → (N, 64) pixel blocks (dequant + IDCT + shift).

    The per-image stage 2's path to the standalone kernels: on a CUDA device, int16
    coefficients (the native stage 1's) dequantise in one launch of the unpack kernel
    (one segment of one image, :func:`unpack_dequant_segments`), then K1; other integer
    types with torch ops. Both are one float32 product a coefficient."""
    import torch

    if coeffs.is_cuda and coeffs.dtype == torch.int16:
        seg = CoefSegment(coeffs.reshape(1, -1, 64).contiguous(),
                          qtable.to(torch.int32).reshape(1, 64).contiguous(), 64, False, None)
        return idct_scaled(unpack_dequant_segments([seg])[0])
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


#: :func:`ycbcr_to_rgb`'s constants as float32 (a Python float rounded, as torch and jnp
#: take them)
_CR_R, _CB_G, _CR_G, _CB_B = (float(np.float32(c)) for c in (1.402, 0.344136, 0.714136, 1.772))


def _ycbcr_to_rgb_u8_fused(y, cb, cr, bgr=False):
    """JFIF YCbCr → RGB uint8 as the reference's jitted ``_batched_stage2`` computes it on
    the CPU, where XLA contracts each multiply-add of ``ycbcr_to_rgb`` into one fused
    multiply-add (one rounding): ``r = fma(1.402, cr - 128, y)``, ``g = fma(-0.714136,
    cr - 128, fma(-0.344136, cb - 128, y))``, ``b = fma(1.772, cb - 128, y)``, then round,
    clip and uint8. Each fma is computed in float64 and rounded once to float32: the
    product of two float32 is exact there, and so is the sum, for these operands (samples
    in [0, 255] at a 1/16 grid), so the result is the fused one. :func:`ycbcr_to_rgb` on
    its own rounds every product (the reference's eager form, used by the per-image
    stage 2)."""
    import torch

    f64 = torch.float64
    y64 = y.to(f64)
    dcb = (cb - 128.0).to(f64)
    dcr = (cr - 128.0).to(f64)
    r = (y64 + _CR_R * dcr).to(torch.float32)
    g = ((y64 - _CB_G * dcb).to(torch.float32).to(f64) - _CR_G * dcr).to(torch.float32)
    b = (y64 + _CB_B * dcb).to(torch.float32)
    return _to_uint8(torch.stack([b, g, r] if bgr else [r, g, b], dim=-1))


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


def decode_jpeg(data, device=None):
    """Full two-stage decode of one image: JPEG bytes → (h, w, 3) uint8 RGB tensor on
    ``device`` (the card unless the caller asks for the CPU). Stage 1 is the native
    entropy decode (int16 coefficients), so on the card each component is one unpack
    launch and one K1 launch (:func:`decode_jpeg_device_stage`)."""
    return decode_jpeg_device_stage(entropy_decode_jpeg_fast(data), device=device)


# -- the stage-2 unpack: shipped slabs → dequantised blocks (csrc/coef_unpack.cu) ------


#: one component's shipped coefficients, as :func:`unpack_dequant_segments` takes them:
#: ``slabs`` an (n, blocks, k) int16 tensor, or its 12-bit pack (n, blocks, k*3//2) uint8
#: when ``packed``, or when ``split = (k1, k2)`` a ``(head, mid, tail)`` triple: uint8
#: 12-bit pairs for zigzag positions [0, k1), int8 for [k1, k2), uint8 4-bit nibble pairs
#: for [k2, k). ``qtab``: (n, 64) int32 natural order. Order: natural when k == 64 and no
#: split, else zigzag. ``by``, ``bx``: the component's blocks a column and a row, which
#: :func:`stage2_planes_segments` needs for its planes (the unpack alone ignores them).
CoefSegment = collections.namedtuple("CoefSegment", "slabs qtab k packed split by bx",
                                     defaults=(None, None))

_MAX_UNPACK_SEGMENTS = 4  # csrc/coef_unpack.cu kMaxSegments


def _unpack12(u8):
    """(n, blocks, m*3) uint8 → (n, blocks, 2m) int32, 12-bit two's complement
    (``ptpu_jpeg_pack12`` layout: ``lo = b0 | (b1 & 0xF) << 8``, ``hi = b1 >> 4 | b2 << 4``)."""
    import torch

    triples = u8.reshape(u8.shape[0], u8.shape[1], -1, 3).to(torch.int32)
    b0, b1, b2 = triples[..., 0], triples[..., 1], triples[..., 2]
    lo = b0 | ((b1 & 0xF) << 8)
    hi = (b1 >> 4) | (b2 << 4)
    pair = torch.stack([lo, hi], dim=-1)
    pair = pair - ((pair & 0x800) << 1)
    return pair.reshape(u8.shape[0], u8.shape[1], -1)


def _unpack4(u8):
    """(n, blocks, m) uint8 → (n, blocks, 2m) int32, 4-bit two's complement, low nibble
    first."""
    import torch

    b = u8.to(torch.int32)
    pair = torch.stack([b & 0xF, (b >> 4) & 0xF], dim=-1)
    pair = pair - ((pair & 0x8) << 1)
    return pair.reshape(u8.shape[0], u8.shape[1], -1)


def _unpack_dequant_plain(seg):
    """Plain PyTorch version of the stage-2 unpack for one :class:`CoefSegment`: the JAX
    package's integer ops (``_batched_stage2``, ``petastorm_tpu/ops/jpeg.py:573-602``),
    then ``coef.float() * qtab.float()``. Returns (n * blocks, 64) float32, natural
    order."""
    import torch

    k = seg.k
    if seg.split is not None:
        head, mid, tail = seg.slabs
        parts = []
        if head.shape[-1]:
            parts.append(_unpack12(head))
        if mid.shape[-1]:
            parts.append(mid.to(torch.int32))
        if tail.shape[-1]:
            parts.append(_unpack4(tail))
        coef = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
        zigzag = True
    else:
        coef = _unpack12(seg.slabs) if seg.packed else seg.slabs
        zigzag = k < 64
    if zigzag:
        if k < 64:
            coef = torch.nn.functional.pad(coef, (0, 64 - k))
        coef = coef.index_select(-1, torch.from_numpy(UNZIGZAG).to(coef.device))
    n, blocks = coef.shape[0], coef.shape[1]
    scaled = coef.to(torch.float32) * seg.qtab.to(torch.float32)[:, None, :]
    return scaled.reshape(n * blocks, 64)


def _check_segment(seg, what="unpack_dequant"):
    """Shapes and dtypes of one :class:`CoefSegment`; returns (images, blocks)."""
    import torch

    if seg.qtab.dim() != 2 or seg.qtab.shape[1] != 64 or seg.qtab.dtype != torch.int32:
        raise ValueError("%s: qtab must be (n, 64) int32, got %s %s"
                         % (what, seg.qtab.dtype, tuple(seg.qtab.shape)))
    k = int(seg.k)
    if not 1 <= k <= 64 or k % 2:
        raise ValueError("%s: k must be even in [2, 64], got %r" % (what, seg.k))
    if seg.split is not None:
        k1, k2 = seg.split
        if not 0 <= k1 <= k2 <= k or k1 % 2 or (k - k2) % 2:
            raise ValueError("%s: bad split %r for k=%d" % (what, seg.split, k))
        want = ((torch.uint8, k1 * 3 // 2), (torch.int8, k2 - k1), (torch.uint8, (k - k2) // 2))
        slabs = tuple(seg.slabs)
    else:
        want = ((torch.uint8, k * 3 // 2),) if seg.packed else ((torch.int16, k),)
        slabs = (seg.slabs,)
    n = seg.qtab.shape[0]
    blocks = slabs[0].shape[1] if slabs[0].dim() == 3 else -1
    for t, (dtype, width) in zip(slabs, want):
        if t.dtype != dtype or t.dim() != 3 or tuple(t.shape) != (n, blocks, width):
            raise ValueError("%s: slab %s %s, expected %s of shape %s"
                             % (what, t.dtype, tuple(t.shape), dtype, (n, blocks, width)))
    if len(slabs) != len(want):
        raise ValueError("%s: a split segment takes (head, mid, tail)" % what)
    return n, blocks


def unpack_dequant_segments(segments):
    """A layout group's components as shipped (:class:`CoefSegment` each, all on one
    device) → the list of (n * blocks, 64) float32 dequantised blocks in natural order,
    K1's input.

    On CUDA tensors, the hand-written kernel ``csrc/coef_unpack.cu`` (it replaces the
    unpack and dequantisation the JAX package fuses into its stage-2 program,
    ``petastorm_tpu/ops/jpeg.py:552-602``), ONE launch for every segment; on CPU tensors,
    the plain version per segment. ``unpack_dequant_segments.launches`` counts kernel
    launches."""
    import torch

    segments = list(segments)
    if not 1 <= len(segments) <= _MAX_UNPACK_SEGMENTS:
        raise ValueError("unpack_dequant_segments takes 1..%d segments, got %d"
                         % (_MAX_UNPACK_SEGMENTS, len(segments)))
    device = segments[0].qtab.device
    shapes = []
    for seg in segments:
        shapes.append(_check_segment(seg))
        slabs = seg.slabs if seg.split is not None else (seg.slabs,)
        if any(t.device != device for t in slabs) or seg.qtab.device != device:
            raise ValueError("unpack_dequant_segments: tensors on more than one device")
    if device.type == "cpu":
        return [_unpack_dequant_plain(seg) for seg in segments]
    if device.type != "cuda":
        raise ValueError("unpack_dequant runs on CPU or CUDA tensors, got %s" % device)
    from petastorm_tpu_torch.ops import kernels

    descs = (kernels.CoefSegmentDesc * len(segments))()
    outs = []
    for d, seg, (n, blocks) in zip(descs, segments, shapes):
        slabs = tuple(seg.slabs) if seg.split is not None else (seg.slabs,)
        if not all(t.is_contiguous() for t in slabs) or not seg.qtab.is_contiguous():
            raise ValueError("unpack_dequant needs contiguous slabs and tables")
        out = torch.empty((n * blocks, 64), dtype=torch.float32, device=device)
        outs.append(out)
        ptrs = [t.data_ptr() for t in slabs] + [0] * (3 - len(slabs))
        d.src0, d.src1, d.src2 = ptrs
        d.qtab, d.out = seg.qtab.data_ptr(), out.data_ptr()
        d.rows, d.blocks_per_image = n * blocks, blocks
        d.kind = 2 if seg.split is not None else int(bool(seg.packed))  # split, pack12, int16
        d.k = seg.k
        d.k1, d.k2 = seg.split if seg.split is not None else (0, 0)
        d.zigzag = int(seg.split is not None or seg.k < 64)
    rc = kernels.library().ptpu_coef_unpack_segments(descs, len(segments),
                                                     *kernels.launch_target(device))
    kernels.check_launch("coef_unpack_segments", rc)
    unpack_dequant_segments.launches += 1
    return outs


unpack_dequant_segments.launches = 0


# -- the batched stage 2: shipped slabs → planes → RGB (csrc/stage2.cu) ----------------

_MAX_PLANES_SEGMENTS = 4  # csrc/stage2.cu kMaxSegments


def _stage2_planes_plain(seg):
    """Plain PyTorch version of ``stage2_planes`` for one :class:`CoefSegment`: the
    unpack (:func:`_unpack_dequant_plain`), the IDCT (:func:`_idct_scaled_plain`), the
    range limit (round half to even, clamp to [0, 255]) and the block-to-plane transpose,
    as the reference's ``_batched_stage2`` (``petastorm_tpu/ops/jpeg.py:552-608``) does
    them. Returns (n, by*8, bx*8) uint8."""
    import torch

    n = seg.qtab.shape[0]
    pix = torch.clamp(torch.round(_idct_scaled_plain(_unpack_dequant_plain(seg))), 0.0, 255.0)
    plane = pix.reshape(n, seg.by, seg.bx, 8, 8).permute(0, 1, 3, 2, 4)
    return plane.reshape(n, seg.by * 8, seg.bx * 8).to(torch.uint8)


def stage2_planes_segments(segments):
    """A layout group's components as shipped (:class:`CoefSegment` each, with ``by`` and
    ``bx``, all on one device) → the list of (n, by*8, bx*8) uint8 planes, range-limited
    pixels in plane layout.

    On CUDA tensors, the hand-written kernel ``stage2_planes`` (``csrc/stage2.cu``: the
    unpack and dequantisation, K1's product and the range limit in one pass), ONE launch
    for every segment; on CPU tensors, the plain version per segment.
    ``stage2_planes_segments.launches`` counts kernel launches."""
    import torch

    segments = list(segments)
    if not 1 <= len(segments) <= _MAX_PLANES_SEGMENTS:
        raise ValueError("stage2_planes_segments takes 1..%d segments, got %d"
                         % (_MAX_PLANES_SEGMENTS, len(segments)))
    device = segments[0].qtab.device
    shapes = []
    for seg in segments:
        n, blocks = _check_segment(seg, "stage2_planes")
        if seg.by is None or seg.bx is None or int(seg.by) < 1 or int(seg.bx) < 1 \
                or int(seg.by) * int(seg.bx) != blocks:
            raise ValueError("stage2_planes: by=%r, bx=%r do not make the %d blocks an image"
                             % (seg.by, seg.bx, blocks))
        slabs = seg.slabs if seg.split is not None else (seg.slabs,)
        if any(t.device != device for t in slabs) or seg.qtab.device != device:
            raise ValueError("stage2_planes_segments: tensors on more than one device")
        shapes.append((n, int(seg.by), int(seg.bx)))
    if device.type == "cpu":
        return [_stage2_planes_plain(seg) for seg in segments]
    if device.type != "cuda":
        raise ValueError("stage2_planes runs on CPU or CUDA tensors, got %s" % device)
    from petastorm_tpu_torch.ops import kernels

    descs = (kernels.PlaneSegmentDesc * len(segments))()
    outs = []
    for d, seg, (n, by, bx) in zip(descs, segments, shapes):
        slabs = tuple(seg.slabs) if seg.split is not None else (seg.slabs,)
        if not all(t.is_contiguous() for t in slabs) or not seg.qtab.is_contiguous():
            raise ValueError("stage2_planes needs contiguous slabs and tables")
        if any(t.numel() and t.data_ptr() % 16 for t in (*slabs, seg.qtab)):
            raise ValueError("stage2_planes needs 16-byte aligned slabs and tables")
        out = torch.empty((n, by * 8, bx * 8), dtype=torch.uint8, device=device)
        outs.append(out)
        ptrs = [t.data_ptr() for t in slabs] + [0] * (3 - len(slabs))
        d.src0, d.src1, d.src2 = ptrs
        d.qtab, d.out = seg.qtab.data_ptr(), out.data_ptr()
        d.rows, d.blocks_per_image, d.bx = n * by * bx, by * bx, bx
        d.kind = 2 if seg.split is not None else int(bool(seg.packed))  # split, pack12, int16
        d.k = seg.k
        d.k1, d.k2 = seg.split if seg.split is not None else (0, 0)
        d.zigzag = int(seg.split is not None or seg.k < 64)
    rc = kernels.library().ptpu_stage2_planes(descs, len(segments), _basis_on(device).data_ptr(),
                                              *kernels.launch_target(device))
    kernels.check_launch("stage2_planes", rc)
    stage2_planes_segments.launches += 1
    return outs


stage2_planes_segments.launches = 0


def _ratios(comp_layout):
    """Per component ``(ry, rx)``: the vertical and horizontal upsample ratios."""
    hmax = max(h for h, _v, _by, _bx in comp_layout)
    vmax = max(v for _h, v, _by, _bx in comp_layout)
    return [(vmax // v, hmax // h) for h, v, _by, _bx in comp_layout]


def _stage2_rgb_plain(planes, layout, bgr=False):
    """Plain PyTorch version of ``stage2_rgb``: per component the upsample (libjpeg's
    triangle filter at ratio 2, a nearest repeat above, vertical then horizontal, edges
    clamped at the padded plane), the crop to (h, w), then YCbCr → RGB with round, clip and
    uint8 (:func:`_ycbcr_to_rgb_u8_fused`), as the reference's jitted ``_batched_stage2``
    (``petastorm_tpu/ops/jpeg.py:609-618``)."""
    import torch

    height, width, comp_layout = layout
    full = []
    for plane, (ry, rx) in zip(planes, _ratios(comp_layout)):
        plane = plane.to(torch.float32)
        for axis, r in ((1, ry), (2, rx)):
            if r == 2:
                plane = _fancy_upsample2(plane, axis)
            elif r > 1:
                plane = torch.repeat_interleave(plane, r, dim=axis)
        full.append(plane[:, :height, :width])
    if len(full) == 1:
        y = torch.clamp(full[0], 0, 255).to(torch.uint8)
        return torch.stack([y, y, y], dim=-1)
    return _ycbcr_to_rgb_u8_fused(full[0], full[1], full[2], bgr=bgr)


def stage2_rgb(planes, layout, bgr=False):
    """A layout group's uint8 planes (one (n, by*8, bx*8) tensor a component, all on one
    device, as :func:`stage2_planes_segments` gives them) → (n, h, w, 3) uint8, RGB or
    (``bgr``) BGR; one component is copied to three channels.

    On CUDA tensors, the hand-written kernel ``stage2_rgb`` (``csrc/stage2.cu``: the
    chroma upsample, the crop and the colour conversion in one pass), ONE launch; on CPU
    tensors, the plain version. ``stage2_rgb.launches`` counts kernel launches."""
    import torch

    height, width, comp_layout = layout
    planes = list(planes)
    if len(planes) != len(comp_layout) or len(planes) not in (1, 3):
        raise ValueError("stage2_rgb takes 1 or 3 planes, one a component of the layout; "
                         "got %d for %d components" % (len(planes), len(comp_layout)))
    device, n = planes[0].device, planes[0].shape[0]
    ratios = _ratios(comp_layout)
    for plane, (_h, _v, by, bx), (ry, rx) in zip(planes, comp_layout, ratios):
        if plane.dtype != torch.uint8 or tuple(plane.shape) != (n, by * 8, bx * 8):
            raise ValueError("stage2_rgb: plane %s %s, expected uint8 of shape %s"
                             % (plane.dtype, tuple(plane.shape), (n, by * 8, bx * 8)))
        if plane.device != device:
            raise ValueError("stage2_rgb: planes on more than one device")
        if by * 8 * ry < height or bx * 8 * rx < width:
            raise ValueError("stage2_rgb: a %dx%d plane upsampled by (%d, %d) does not cover "
                             "%dx%d" % (by * 8, bx * 8, ry, rx, height, width))
    if device.type == "cpu":
        return _stage2_rgb_plain(planes, layout, bgr)
    if device.type != "cuda":
        raise ValueError("stage2_rgb runs on CPU or CUDA tensors, got %s" % device)
    if not all(plane.is_contiguous() for plane in planes):
        raise ValueError("stage2_rgb needs contiguous planes")
    if any(plane.data_ptr() % 16 for plane in planes):
        raise ValueError("stage2_rgb needs 16-byte aligned planes")
    from petastorm_tpu_torch.ops import kernels

    out = torch.empty((n, height, width, 3), dtype=torch.uint8, device=device)
    d = kernels.RgbDesc()
    for c, (plane, (_h, _v, by, bx), (ry, rx)) in enumerate(zip(planes, comp_layout, ratios)):
        d.plane[c] = plane.data_ptr()
        d.rows[c], d.cols[c], d.ry[c], d.rx[c] = by * 8, bx * 8, ry, rx
    d.out, d.images = out.data_ptr(), n
    d.height, d.width, d.ncomp, d.bgr = height, width, len(planes), int(bool(bgr))
    rc = kernels.library().ptpu_stage2_rgb(d, *kernels.launch_target(device))
    kernels.check_launch("stage2_rgb", rc)
    stage2_rgb.launches += 1
    return out


stage2_rgb.launches = 0


# -- batched stage 2 (two launches a layout group) --------------------------------------


def _layout_key(planes):
    """Hashable decode layout: everything that shapes the batched program."""
    return (
        planes.height,
        planes.width,
        tuple((c.h_samp, c.v_samp, c.blocks.shape[0], c.blocks.shape[1])
              for c in planes.components),
    )


def _batched_stage2(layout, coeffs, qtabs, ks=None, packed=None, split=None, bgr=False):
    """Same-layout batch on device: per component the shipped coefficients (an
    ``(n, by*bx, k)`` int16 tensor, its 12-bit pack, or a split's slab triple: see
    :class:`CoefSegment`; ``ks``, ``packed`` and ``split`` give each component's variant,
    None = full int16 in natural order) and ``(n, 64)`` int32 quantisation tables (per
    image: quality may vary) → ``(n, h, w, 3)`` uint8, RGB or (``bgr``) BGR. One
    :func:`stage2_planes_segments` launch for all components, then one
    :func:`stage2_rgb` launch."""
    _height, _width, comp_layout = layout
    segments = [CoefSegment(coef, qtab, 64 if ks is None else ks[ci],
                            bool(packed is not None and packed[ci]),
                            None if split is None else split[ci], by, bx)
                for ci, ((_h, _v, by, bx), coef, qtab) in enumerate(
                    zip(comp_layout, coeffs, qtabs))]
    return stage2_rgb(stage2_planes_segments(segments), layout, bgr)


def stack_jpeg_coefficients(planes_list):
    """Stack same-layout :class:`JpegPlanes` into per-component batch arrays.

    Returns ``(coeffs, qtabs)``: tuples with one ``(n, by*bx, 64)`` int16 and one
    ``(n, 64)`` int32 array per component. Rows of one row group (``batch_ref``) are
    gathered from their parent buffers with one ``take`` per parent and component; other
    rows are copied one by one. (The transfer packs from the parent buffers in place,
    :func:`_runs`; this is the stacked form for callers that want one array.)"""
    ncomp = len(planes_list[0].components)
    n = len(planes_list)
    blocks = [c.blocks.shape[0] * c.blocks.shape[1] for c in planes_list[0].components]
    coeffs = tuple(np.empty((n, nb, 64), np.int16) for nb in blocks)
    qtabs = tuple(np.empty((n, 64), np.int32) for _ in blocks)
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
    return coeffs, qtabs


def resize_image_batch(img, target):
    """(n, h, w, c) uint8 batch → (n, *target, c) uint8, bilinear with half-pixel centres
    and no antialiasing, computed in float32, then rounded and clamped (the JAX package's
    ``jax.image.resize(method="linear", antialias=False)``, which tracks
    ``cv2.resize(INTER_LINEAR)``). A no-op, returning ``img`` itself, when the size
    already matches. The JAX package's resize is no Pallas kernel, so this is
    ``torch.nn.functional.interpolate`` on a channels-last view (the CUDA bilinear takes
    no uint8)."""
    import torch

    h, w = int(target[0]), int(target[1])
    if img.shape[1] == h and img.shape[2] == w:
        return img
    x = img.to(torch.float32).permute(0, 3, 1, 2)  # NCHW view of NHWC memory
    out = torch.nn.functional.interpolate(x, size=(h, w), mode="bilinear",
                                          align_corners=False, antialias=False)
    return _to_uint8(out.permute(0, 2, 3, 1)).contiguous()


def _resolve_device(device):
    import torch

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: petastorm_tpu_torch runs on the GPU unless the caller "
                "asks for the CPU (device='cpu')")
        return torch.device("cuda")
    return torch.device(device)


# -- the narrowed coefficient transfer (the JAX package's _decode_group rules) ----------

#: Coarse zigzag-prefix buckets; 64 means "ship the full spectrum for this component".
_K_BUCKETS = (16, 32, 64)

#: Per-layout sticky buckets: ks only ever GROW, so content variation across row groups
#: switches a layout's variant a bounded number of times. Updated from loader transfer
#: threads under _STICKY_KS_LOCK (compare-and-grow must be atomic).
_STICKY_KS: dict = {}
_STICKY_KS_LOCK = threading.Lock()

#: (layout, component) pairs seen to exceed the 12-bit range: pack12 off for them, sticky.
_PACK12_DISABLED: set = set()

#: Per-layout sticky split points: layout → per-component ``(k1, k2)``, only ever growing.
_STICKY_SPLIT: dict = {}

#: (layout, component) pairs whose split pack failed its ranges: split off, sticky.
_SPLIT_DISABLED: set = set()

#: Cumulative coefficient-transfer accounting: ``raw`` = what full int16 coefficients
#: would ship, ``shipped`` = the bytes shipped after truncation/split/pack.
_TRANSFER_BYTES = {"shipped": 0, "raw": 0}


def transfer_byte_counters(reset=False):
    """Snapshot (optionally reset) the cumulative coefficient-transfer accounting:
    ``{"shipped": bytes_actually_shipped, "raw": int16_equivalent_bytes}``."""
    with _STICKY_KS_LOCK:
        out = dict(_TRANSFER_BYTES)
        if reset:
            _TRANSFER_BYTES["shipped"] = 0
            _TRANSFER_BYTES["raw"] = 0
    return out


def _truncation_ks(group, layout=None):
    """Per-component zigzag-prefix buckets for a same-layout group, or None when
    truncation is unavailable (a row without kmax) or useless (every component at full
    width)."""
    kms = [p.kmax for p in group]
    if any(km is None for km in kms):
        return None
    ncomp = len(group[0].components)

    def bucket(kcount):
        for b in _K_BUCKETS:
            if kcount <= b:
                return b
        return 64

    ks = [bucket(max(km[c] for km in kms) + 1) for c in range(ncomp)]
    if layout is not None:
        with _STICKY_KS_LOCK:
            prev = _STICKY_KS.get(layout)
            if prev is not None:
                ks = [max(a, b) for a, b in zip(ks, prev)]
            _STICKY_KS[layout] = ks
    if all(k >= 64 for k in ks):
        return None
    return tuple(ks)


def _batch_specmax(group):
    """The group's combined ``(ncomp, 64)`` spectral range profile, or None when any row
    lacks one. Rows of one row group share the profile array; mixed-parent groups take
    the elementwise max."""
    vecs = []
    seen = set()
    for p in group:
        sm = p.specmax
        if sm is None:
            return None
        if id(sm) not in seen:
            seen.add(id(sm))
            vecs.append(sm)
    return vecs[0] if len(vecs) == 1 else np.maximum.reduce(vecs)


def _round_up4(x):
    return (x + 3) & ~3


def _split_points(profile, ks, layout):
    """Per-component spectral split ``(k1, k2)`` (or None = plain pack12 is as good) from
    the measured per-position ranges. Positions >= k1 fit int8, positions >= k2 fit 4
    bits; both bucketed to multiples of 4 and sticky-grown per layout."""
    ncomp = profile.shape[0]
    out = []
    for ci in range(ncomp):
        k = ks[ci] if ks is not None else 64
        mx = profile[ci]

        def low_bound(lim):
            j = k
            while j > 0 and mx[j - 1] <= lim:
                j -= 1
            return j

        k1 = min(_round_up4(low_bound(127)), k)
        k2 = min(max(_round_up4(low_bound(7)), k1), k)
        out.append((k1, k2))
    with _STICKY_KS_LOCK:
        prev = _STICKY_SPLIT.get(layout)
        if prev is not None:
            out = [(max(a1, b1), max(max(a2, b2), max(a1, b1)))
                   for (a1, a2), (b1, b2) in zip(out, prev)]
        _STICKY_SPLIT[layout] = out
    spec = []
    for ci, (k1, k2) in enumerate(out):
        k = ks[ci] if ks is not None else 64
        k1, k2 = min(k1, k), min(k2, k)
        # k1 == k: every position needs 12 bits, the bytes of pack12 without its
        # natural-order layout: use pack12
        spec.append(None if k1 >= k else (k1, k2))
    return spec


_SCRATCH = threading.local()
_ALIGN = 256  # offsets of the arrays inside one upload


def _scratch(slot, shape, dtype):
    """A reusable host array of ``shape``/``dtype`` for this thread (a view into a
    growing buffer, one per ``slot``): the zigzag truncation writes here."""
    bufs = getattr(_SCRATCH, "bufs", None)
    if bufs is None:
        bufs = _SCRATCH.bufs = {}
    nbytes = int(np.prod(shape, dtype=np.int64)) * np.dtype(dtype).itemsize
    buf = bufs.get(slot)
    if buf is None or buf.nbytes < nbytes:
        buf = bufs[slot] = np.empty(max(nbytes, 1), np.uint8)
    return buf[:nbytes].view(dtype).reshape(shape)


def _runs(group):
    """A same-layout group's rows as runs ``(position, count, coeffs, qtabs)``: per
    component an (count, blocks, 64) int16 array and a (count, 64) table, slices of one
    row group's buffers for rows that follow each other there, else one row's own
    arrays. The packers read these in place: no stacked copy of the batch."""
    runs = []
    j, n = 0, len(group)
    while j < n:
        ref = group[j].batch_ref
        if ref is None:
            comps = group[j].components
            runs.append((j, 1, tuple(c.blocks.reshape(1, -1, 64) for c in comps),
                         tuple(np.asarray(c.qtable).reshape(1, 64) for c in comps)))
            j += 1
            continue
        m = 1
        while j + m < n:
            nxt = group[j + m].batch_ref
            if nxt is None or nxt[0] is not ref[0] or nxt[2] != ref[2] + m:
                break
            m += 1
        r0 = ref[2]
        runs.append((j, m, tuple(c[r0:r0 + m] for c in ref[0]),
                     tuple(ref[1][r0:r0 + m, ci, :] for ci in range(len(ref[0])))))
        j += m
    return runs


class _Upload:
    """Host room for one batch's shipped arrays, filled front to back at 256-byte aligned
    offsets, then sent to the device in ONE copy of the used span: a pinned staging slab
    of the loader's ring (``stager``), else a numpy buffer."""

    def __init__(self, capacity, stager, device):
        self.device = device
        self.end = 0
        if stager is not None and device.type == "cuda":
            self.host, self._send = stager.reserve_bytes(capacity)
        else:
            self.host, self._send = np.empty(capacity, np.uint8), None
        self.specs = []

    def view(self, shape, dtype, at=None):
        """A host array at the next free offset (or at ``at``), not yet claimed."""
        at = self.end if at is None else at
        nbytes = int(np.prod(shape, dtype=np.int64)) * np.dtype(dtype).itemsize
        if at + nbytes > self.host.nbytes:
            raise RuntimeError("transfer region of %d bytes overflows at %d + %d"
                               % (self.host.nbytes, at, nbytes))
        return self.host[at:at + nbytes].view(dtype).reshape(shape)

    def claim(self, arr, at=None):
        """Claim a :meth:`view` made at offset ``at`` (default: the next free one);
        returns its index among the claims."""
        at = self.end if at is None else at
        self.specs.append((at, arr.shape, arr.dtype))
        self.end = -(-(at + arr.nbytes) // _ALIGN) * _ALIGN
        return len(self.specs) - 1

    def send(self):
        """ONE copy of the claimed span to the device; the claimed arrays as tensors."""
        import torch

        used = self.end
        if self._send is not None:
            dev = self._send(self.device, used)
        else:
            dev = torch.from_numpy(self.host[:used])
            if self.device.type != "cpu":
                dev = dev.to(self.device)
        out = []
        for at, shape, dtype in self.specs:
            nbytes = int(np.prod(shape, dtype=np.int64)) * np.dtype(dtype).itemsize
            t = dev[at:at + nbytes]
            out.append(t.view(torch.from_numpy(np.empty(0, dtype)).dtype).view(shape))
        return out


def _row_bytes(layout):
    """Bytes of one image's full int16 coefficients and int32 tables: the most any
    transfer variant ships for it."""
    return sum(by * bx * 64 * 2 + 64 * 4 for _h, _v, by, bx in layout[2])


def _plan_group(layout, group):
    """The transfer variant of one same-layout group, with the reference's rules and
    sticky state: ``(sources, qtabs, ks, split)``. ``sources`` per component the runs
    ``(position, count, int16 array)`` to pack (the truncated components stacked into
    one zigzag-prefix run in this thread's scratch), ``qtabs`` the runs of tables, ``ks``
    None or the zigzag-prefix widths, ``split`` each component's candidate ``(k1, k2)``
    or None. ``ks is False`` means native stage 1 is unavailable: full int16."""
    from petastorm_tpu_torch.ops import native

    runs = _runs(group)
    ncomp = len(group[0].components)
    n = len(group)
    sources = [[(pos, m, coeffs[ci]) for pos, m, coeffs, _q in runs] for ci in range(ncomp)]
    qtabs = [(pos, m, q) for pos, m, _c, q in runs]
    if not native.native_available():
        return sources, qtabs, False, None
    ks = _truncation_ks(group, layout)
    if ks is not None:
        for ci, k in enumerate(ks):
            if k < 64:
                nb = sources[ci][0][2].shape[1]
                trunc = _scratch(("trunc", ci), (n, nb, k), np.int16)
                for pos, m, src in sources[ci]:
                    native.jpeg_zigzag_truncate_native(src, k, out=trunc[pos:pos + m])
                sources[ci] = [(0, n, trunc)]
    profile = _batch_specmax(group)
    if profile is None:
        # a row without a stage-1 profile (per-image stage 1): profile the batch
        vecs = []
        for ci in range(ncomp):
            zig = ks is not None and ks[ci] < 64
            v = np.maximum.reduce([native.jpeg_specmax_native(src, is_zigzag=zig)
                                   for _pos, _m, src in sources[ci]])
            vecs.append(np.pad(v, (0, 64 - ks[ci])) if zig else v)
        profile = np.stack(vecs)
    candidate = _split_points(profile, ks, layout)
    split = [None] * ncomp
    with _STICKY_KS_LOCK:
        for ci, sp in enumerate(candidate):
            if sp is not None and (layout, ci) not in _SPLIT_DISABLED:
                split[ci] = sp
    return sources, qtabs, ks, split


def _pack_runs(pack, runs, outs):
    """``pack(src, out)`` over every run, into the rows ``[pos, pos + count)`` of the
    arrays ``outs``; False as soon as one run overflows its tier. Blocks are packed
    independently, so the runs give the bytes one call over the stacked batch gives."""
    for pos, m, src in runs:
        if pack(src, tuple(o[pos:pos + m] for o in outs)) is None:
            return False
    return True


def _pack_group(layout, plan, up):
    """Pack one planned group into ``up``: per component the split pack, else the 12-bit
    pack, else int16, each written run by run straight into the upload's host room (a
    failed tier's bytes are overwritten by the next). Counts the bytes; returns
    ``(coeff_claims, qtab_claims, ks, packed, split)``."""
    from petastorm_tpu_torch.ops import native

    sources, qtab_runs, ks, split = plan
    n = sum(m for _pos, m, _q in qtab_runs)
    raw = sum(n * by * bx * 64 * 2 for _h, _v, by, bx in layout[2])
    native_ok = ks is not False
    if not native_ok:
        ks, split = None, [None] * len(sources)
    split = list(split)
    claims, packed = [], []
    shipped = 0

    def int16(src, out):
        np.copyto(out[0], src)
        return out[0]

    for ci, runs in enumerate(sources):
        nb, k = runs[0][2].shape[1], runs[0][2].shape[2]
        is_zig = ks is not None and ks[ci] < 64
        if split[ci] is not None:
            k1, k2 = split[ci]
            at = [up.end]
            slabs = []
            for shape, dtype in (((n, nb, k1 * 3 // 2), np.uint8), ((n, nb, k2 - k1), np.int8),
                                 ((n, nb, (k - k2) // 2), np.uint8)):
                slabs.append(up.view(shape, dtype, at=at[-1]))
                at.append(at[-1] + _aligned(slabs[-1].nbytes))
            if _pack_runs(lambda src, out: native.jpeg_pack_split_native(
                    src, k1, k2, is_zigzag=is_zig, out=out), runs, slabs):
                claims.append(tuple(up.claim(a, o) for a, o in zip(slabs, at)))
                packed.append(False)
                shipped += sum(a.nbytes for a in slabs)
                continue
            # a range exceeded despite the profile (rows of mixed provenance): split off
            # for this component, sticky; fall through to pack12
            split[ci] = None
            with _STICKY_KS_LOCK:
                _SPLIT_DISABLED.add((layout, ci))
        with _STICKY_KS_LOCK:
            enabled = native_ok and (layout, ci) not in _PACK12_DISABLED
        dst = None
        if enabled:
            dst = up.view((n, nb, k * 3 // 2), np.uint8)
            if not _pack_runs(lambda src, out: native.jpeg_pack12_native(src, out=out[0]),
                              runs, (dst,)):
                dst = None  # 12-bit range exceeded: int16 for this component, sticky
                with _STICKY_KS_LOCK:
                    _PACK12_DISABLED.add((layout, ci))
        if dst is None:
            dst = up.view((n, nb, k), np.int16)
            _pack_runs(int16, runs, (dst,))
        packed.append(dst.dtype == np.uint8)
        claims.append(up.claim(dst))
        shipped += dst.nbytes
    qclaims = []
    for ci in range(len(sources)):
        dst = up.view((n, 64), np.int32)
        for pos, m, q in qtab_runs:
            np.copyto(dst[pos:pos + m], q[ci])
        qclaims.append(up.claim(dst))
    with _STICKY_KS_LOCK:
        _TRANSFER_BYTES["raw"] += raw
        _TRANSFER_BYTES["shipped"] += raw if not native_ok else shipped
    if not native_ok:
        return claims, qclaims, None, None, None
    return claims, qclaims, ks, tuple(packed), tuple(split)


def _aligned(nbytes):
    return -(-nbytes // _ALIGN) * _ALIGN


def _stage_groups(groups, device, stager):
    """Plan and pack every layout group of a batch into one host region and send it in
    ONE upload (a slab of ``stager``, the loader's pinned ring, when given on a CUDA
    device). Returns per group ``(coeffs, qtabs, ks, packed, split)`` on ``device``.

    The region asks for the full int16 bound of the batch's rows at its largest layout,
    which every variant fits under, so a pinned ring sized by its first batch takes
    every later batch of that size whatever the variants."""
    n_rows = sum(len(g) for _l, g in groups)
    # alignment padding: at most 16 arrays a group (3 slabs and a table a component)
    capacity = n_rows * max(_row_bytes(layout) for layout, _g in groups) \
        + max(1 << 20, 16 * _ALIGN * len(groups))
    up = _Upload(capacity, stager, device)
    packed_groups = [_pack_group(layout, _plan_group(layout, group), up)
                     for layout, group in groups]
    tensors = up.send()
    out = []
    for claims, qclaims, ks, packed, split in packed_groups:
        coeffs = [tuple(tensors[i] for i in c) if isinstance(c, tuple) else tensors[c]
                  for c in claims]
        out.append((coeffs, [tensors[i] for i in qclaims], ks, packed, split))
    return out


def decode_jpeg_batch(planes_list, device=None, bgr=False, stager=None, resize_to=None):
    """Batched stage 2: list of :class:`JpegPlanes` → (n, h, w, 3) uint8 tensor on
    ``device`` (default: the CUDA device; raises when there is none).

    Without ``resize_to`` all images must share height/width; mixed chroma samplings are
    grouped, decoded per group and gathered back in input order. ``resize_to=(h, w)``
    takes mixed sizes: each same-layout group decodes at its stored size and is resized
    to ``(h, w)`` (:func:`resize_image_batch`) before the gather. ``bgr`` returns the
    stored channel order of colour JPEGs (what cv2 returns) instead of RGB. The
    coefficients of every group cross in one upload, narrowed as the content allows
    (see the module docstring); ``stager``: optional
    :class:`~petastorm_tpu_torch.io.staging.PinnedStagingPool` whose slab they are packed
    into (the loader's)."""
    import torch

    if not planes_list:
        raise ValueError("decode_jpeg_batch: empty batch")
    device = _resolve_device(device)
    sizes = {(p.height, p.width) for p in planes_list}
    if len(sizes) > 1 and resize_to is None:
        raise ValueError(
            "decode_jpeg_batch requires a uniform image size per batch, got %s. "
            "Pass resize_to=(h, w) (DataLoader(device_decode_resize=...)) to decode "
            "mixed sizes with an on-device resize, resize on write, or decode on "
            "host via CompressedImageCodec.decode." % sizes)
    groups = {}
    for i, p in enumerate(planes_list):
        groups.setdefault(_layout_key(p), []).append(i)
    staged = _stage_groups([(layout, [planes_list[i] for i in indices])
                            for layout, indices in groups.items()], device, stager)
    parts = []
    order = []
    for (layout, indices), (coeffs, qtabs, ks, packed, split) in zip(groups.items(), staged):
        img = _batched_stage2(layout, coeffs, qtabs, ks, packed, split, bgr)
        if resize_to is not None:
            img = resize_image_batch(img, resize_to)
        parts.append(img)
        order.extend(indices)
    if len(parts) == 1:
        return parts[0]
    stacked = torch.cat(parts, dim=0)
    inverse = torch.from_numpy(np.argsort(np.asarray(order))).to(device)
    return stacked.index_select(0, inverse)
