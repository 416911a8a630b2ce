"""Compressed-page pass-through: classify, slice and host-decode raw Parquet pages.

A copy of ``petastorm_tpu.io.pagedec`` (the host half of the pass-through), cut to what
the local read path needs:

- :func:`walk_pages` parses the thrift-compact page headers inside one raw
  column-chunk byte span and classifies every page: dictionary/data page, codec,
  encoding, value count.
- :func:`classify_chunk` decides **eligibility** from the footer alone:
  fixed-width primitive columns (INT32/INT64/FLOAT/DOUBLE), flat
  (no nesting/repetition), provably null-free (statistics ``null_count == 0``
  or ``max_definition_level == 0``), codec snappy or uncompressed, encodings
  PLAIN / RLE_DICTIONARY. Everything else degrades **per column** to the
  classic pyarrow host-inflate path.
- :class:`PassthroughColumn` carries the raw compressed pages of eligible
  columns through the delivery path (worker → batcher → loader) as an
  opaque columnar value with **page-granular** zero-copy row slicing — the
  loader's batch cutting selects covering pages plus a (skip, take) window
  instead of decoding on the host.
- The **numpy reference decoder** (:func:`decode_chunk_numpy` and friends) is
  the correctness twin of the CUDA kernels
  (:mod:`petastorm_tpu_torch.ops.pagedec_kernels`) and the CPU/host fallback,
  bit-identical to pyarrow's own column decode. Snappy inflation itself
  delegates to ``pyarrow.Codec`` (the library pyarrow's reader uses); the page /
  definition-level / RLE-dictionary layer — which pyarrow does not expose —
  is reimplemented here in vectorized numpy.
- :func:`pagedec_counters`: pages, compressed and saved bytes, fallbacks, host
  inflates and inflate seconds, as process-wide running totals.

Corruption contract: a truncated or bit-flipped page raises
:class:`~petastorm_tpu_torch.errors.PagedecCorruptError` (``cause=pagedec_corrupt``),
a permanent error; every decoder bounds-checks offsets/lengths before touching
memory, so corrupt input can never read out of bounds.

- :class:`PageIndexCache` (:func:`shared_page_index`): the walked page starts of each
  chunk, written by the reader's walk and read by the object-store range planner
  (:meth:`petastorm_tpu_torch.io.remote.RemoteReadEngine.raw_chunk_plan`), shared
  host-wide through the cache arena.
"""
from __future__ import annotations

import logging
import struct
import threading

import numpy as np

from petastorm_tpu_torch.errors import PagedecCorruptError

logger = logging.getLogger(__name__)

_warned = set()
_warned_lock = threading.Lock()


def warn_once(cause, msg, *args):
    """Log ``msg`` the first time ``cause`` happens in this process."""
    with _warned_lock:
        if cause in _warned:
            return
        _warned.add(cause)
    logger.warning("[%s] " + msg, cause, *args)


# Parquet page types (format/PageType)
PAGE_DATA = 0
PAGE_INDEX = 1
PAGE_DICT = 2
PAGE_DATA_V2 = 3

# Parquet encodings (format/Encoding)
ENC_PLAIN = 0
ENC_PLAIN_DICT = 2
ENC_RLE = 3
ENC_BIT_PACKED = 4
ENC_RLE_DICT = 8

#: physical types with a fixed byte width the device kernels reconstruct
_FIXED_WIDTH_TYPES = {
    "INT32": np.dtype("<i4"),
    "INT64": np.dtype("<i8"),
    "FLOAT": np.dtype("<f4"),
    "DOUBLE": np.dtype("<f8"),
}

#: codecs the pass-through ships raw (zstd is *classified* by the walker but
#: stays ineligible until a zstd device kernel lands — shipping bytes the
#: device cannot inflate would just move the host decode downstream)
_PASSTHROUGH_CODECS = ("UNCOMPRESSED", "SNAPPY")
_KNOWN_CODECS = ("UNCOMPRESSED", "SNAPPY", "ZSTD")


# -- thrift compact page-header parsing ------------------------------------------------
#
# Page headers are thrift-compact structs inline in the data stream (NOT in
# the footer pyarrow parses for us). The subset below covers every field the
# classifier needs and skips the rest structurally — statistics blobs, future
# fields — so new writer versions degrade to "ineligible", never to a crash.

def _varint(buf, pos, end):
    out = 0
    shift = 0
    while True:
        if pos >= end or shift > 63:
            raise PagedecCorruptError("truncated varint in page header")
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not (b & 0x80):
            return out, pos
        shift += 7


def _zigzag(v):
    return (v >> 1) ^ -(v & 1)


def _parse_compact_struct(buf, pos, end, depth=0):
    """One thrift-compact struct → ``({field_id: value}, next_pos)``; nested
    structs parse into dicts, lists into Python lists. Bounds-checked: any
    walk past ``end`` raises :class:`PagedecCorruptError`."""
    if depth > 8:
        raise PagedecCorruptError("page header nests deeper than thrift allows")
    fields = {}
    last = 0
    while True:
        if pos >= end:
            raise PagedecCorruptError("truncated page header (no STOP field)")
        b = buf[pos]
        pos += 1
        if b == 0:
            return fields, pos
        delta = b >> 4
        t = b & 0x0F
        if delta:
            fid = last + delta
        else:
            v, pos = _varint(buf, pos, end)
            fid = _zigzag(v)
        last = fid
        if t in (1, 2):                      # BOOLEAN_TRUE / BOOLEAN_FALSE
            fields[fid] = (t == 1)
        elif t == 3:                         # BYTE
            if pos >= end:
                raise PagedecCorruptError("truncated byte field")
            fields[fid] = buf[pos]
            pos += 1
        elif t in (4, 5, 6):                 # I16 / I32 / I64
            v, pos = _varint(buf, pos, end)
            fields[fid] = _zigzag(v)
        elif t == 7:                         # DOUBLE
            if pos + 8 > end:
                raise PagedecCorruptError("truncated double field")
            fields[fid] = struct.unpack_from("<d", buf, pos)[0]
            pos += 8
        elif t == 8:                         # BINARY / STRING
            n, pos = _varint(buf, pos, end)
            if n < 0 or pos + n > end:
                raise PagedecCorruptError("binary field runs past the chunk")
            fields[fid] = bytes(buf[pos:pos + n])
            pos += n
        elif t in (9, 10):                   # LIST / SET
            if pos >= end:
                raise PagedecCorruptError("truncated list header")
            hdr = buf[pos]
            pos += 1
            n = hdr >> 4
            et = hdr & 0x0F
            if n == 15:
                n, pos = _varint(buf, pos, end)
            if n > 1 << 20:
                raise PagedecCorruptError("implausible list length %d" % n)
            vals = []
            for _ in range(n):
                if et == 12:
                    v, pos = _parse_compact_struct(buf, pos, end, depth + 1)
                elif et in (4, 5, 6):
                    v, pos = _varint(buf, pos, end)
                    v = _zigzag(v)
                elif et == 8:
                    ln, pos = _varint(buf, pos, end)
                    if ln < 0 or pos + ln > end:
                        raise PagedecCorruptError(
                            "list element runs past the chunk")
                    v = bytes(buf[pos:pos + ln])
                    pos += ln
                elif et == 3:
                    if pos >= end:
                        raise PagedecCorruptError("truncated list byte")
                    v = buf[pos]
                    pos += 1
                else:
                    raise PagedecCorruptError(
                        "unsupported thrift list element type %d" % et)
                vals.append(v)
            fields[fid] = vals
        elif t == 12:                        # STRUCT
            fields[fid], pos = _parse_compact_struct(buf, pos, end, depth + 1)
        else:
            raise PagedecCorruptError("unsupported thrift field type %d" % t)


class PageInfo:
    """One classified page inside a column chunk (offsets chunk-relative)."""

    __slots__ = ("kind", "encoding", "def_encoding", "num_values",
                 "header_offset", "payload_offset", "comp_size", "uncomp_size")

    def __init__(self, kind, encoding, def_encoding, num_values,
                 header_offset, payload_offset, comp_size, uncomp_size):
        self.kind = kind
        self.encoding = encoding
        self.def_encoding = def_encoding
        self.num_values = num_values
        self.header_offset = header_offset
        self.payload_offset = payload_offset
        self.comp_size = comp_size
        self.uncomp_size = uncomp_size

    def __repr__(self):
        return ("PageInfo(kind=%d, enc=%s, n=%d, hdr@%d, payload@%d+%d->%d)"
                % (self.kind, self.encoding, self.num_values,
                   self.header_offset, self.payload_offset, self.comp_size,
                   self.uncomp_size))


def walk_pages(chunk, expected_values=None):
    """Parse every page header in one raw column-chunk byte span.

    Returns ``(dict_page_or_None, [data PageInfo, ...])``. Raises
    :class:`PagedecCorruptError` on malformed headers, payloads running past
    the chunk, or a data-page value total that disagrees with
    ``expected_values`` (the footer's row count) — the never-read-out-of-
    bounds gate runs here, before any payload is touched."""
    buf = memoryview(chunk)
    end = len(buf)
    pos = 0
    dict_page = None
    data_pages = []
    total = 0
    while pos < end:
        hdr, payload_pos = _parse_compact_struct(buf, pos, end)
        kind = hdr.get(1)
        uncomp = hdr.get(2)
        comp = hdr.get(3)
        if kind is None or uncomp is None or comp is None \
                or comp < 0 or uncomp < 0:
            raise PagedecCorruptError("page header missing type/size fields")
        if payload_pos + comp > end:
            raise PagedecCorruptError(
                "page payload (%d bytes at %d) runs past the %d-byte chunk"
                % (comp, payload_pos, end))
        if kind == PAGE_DICT:
            dph = hdr.get(7) or {}
            page = PageInfo(kind, dph.get(2, ENC_PLAIN), None,
                            int(dph.get(1, 0)), pos, payload_pos, comp, uncomp)
            if dict_page is not None:
                raise PagedecCorruptError("second dictionary page in one chunk")
            dict_page = page
        elif kind == PAGE_DATA:
            dph = hdr.get(5) or {}
            n = dph.get(1)
            if n is None or n < 0:
                raise PagedecCorruptError("data page header missing num_values")
            page = PageInfo(kind, dph.get(2, ENC_PLAIN), dph.get(3, ENC_RLE),
                            int(n), pos, payload_pos, comp, uncomp)
            data_pages.append(page)
            total += page.num_values
        elif kind == PAGE_DATA_V2:
            dph = hdr.get(8) or {}
            n = dph.get(1)
            if n is None or n < 0:
                raise PagedecCorruptError("v2 data page header missing num_values")
            # classified (the caller's eligibility check rejects v2 for now —
            # its levels live OUTSIDE the compressed block) but walked safely
            page = PageInfo(kind, dph.get(4, ENC_PLAIN), ENC_RLE, int(n),
                            pos, payload_pos, comp, uncomp)
            data_pages.append(page)
            total += page.num_values
        else:
            # index pages etc.: skip structurally
            pass
        pos = payload_pos + comp
    if expected_values is not None and total != expected_values:
        raise PagedecCorruptError(
            "chunk pages carry %d values, footer says %d" % (total,
                                                             expected_values))
    return dict_page, data_pages


# -- eligibility -----------------------------------------------------------------------

def chunk_byte_range(col):
    """``(start, length)`` byte span of one column chunk — dictionary page
    (when present) through the end of the data pages. The ONE definition of
    a chunk's raw span, shared by the local reader, the remote planner, and
    the page-index bookkeeping (three drifting copies would read different
    ranges for the same chunk)."""
    start = col.data_page_offset
    if col.dictionary_page_offset is not None:
        start = min(start, col.dictionary_page_offset)
    return start, col.total_compressed_size


class Eligibility:
    """A column chunk's pass-through verdict with the human-readable reason."""

    __slots__ = ("eligible", "reason", "dtype", "codec", "max_def")

    def __init__(self, eligible, reason, dtype=None, codec=None, max_def=0):
        self.eligible = eligible
        self.reason = reason
        self.dtype = dtype
        self.codec = codec
        self.max_def = max_def

    def __bool__(self):
        return self.eligible


#: codec (lower case) -> column reads locked out of the pass-through by a codec the
#: walker classifies but no kernel inflates
CODEC_INELIGIBLE = {}


def _count_codec_ineligible(codec):
    """One column read locked out of the pass-through by a classified-but-
    kernel-less codec: count it and warn once per codec."""
    label = codec.lower()
    with _warned_lock:
        CODEC_INELIGIBLE[label] = CODEC_INELIGIBLE.get(label, 0) + 1
    warn_once(
        "pagedec_codec_ineligible{codec=%s}" % label,
        "pagedec: %s chunks are classified but have no device inflate "
        "kernel yet — these columns take the full classic host read", codec)


def classify_chunk(metadata, rg, col_idx):
    """Footer-only eligibility of row group ``rg``'s ``col_idx``-th column.

    This is the cheap first gate (no chunk bytes needed): physical type,
    nesting, codec, and provable null-freedom. The walker's per-page check
    (:func:`classify_pages`) runs after the raw bytes arrive."""
    col = metadata.row_group(rg).column(col_idx)
    sch = metadata.schema.column(col_idx)
    if "." in col.path_in_schema or sch.max_repetition_level > 0:
        return Eligibility(False, "nested or repeated column")
    dtype = _FIXED_WIDTH_TYPES.get(col.physical_type)
    if dtype is None:
        return Eligibility(False,
                           "non-fixed-width physical type %s" % col.physical_type)
    codec = col.compression
    if codec not in _PASSTHROUGH_CODECS:
        if codec in _KNOWN_CODECS:
            # zstd: the walker classifies these chunks
            # fine, but without a device inflate kernel they silently take
            # the full classic read — surface how much of the store is
            # locked out until the kernel lands
            _count_codec_ineligible(codec)
            reason = "codec %s classified but no device kernel yet" % codec
        else:
            reason = "unsupported codec %s" % codec
        return Eligibility(False, reason, dtype=dtype, codec=codec)
    max_def = sch.max_definition_level
    if max_def > 1:
        return Eligibility(False, "definition depth %d (nested optionality)"
                           % max_def, dtype=dtype, codec=codec)
    if max_def == 1:
        st = col.statistics
        if st is None or st.null_count is None or st.null_count != 0:
            return Eligibility(False, "null-freedom not provable from "
                               "statistics", dtype=dtype, codec=codec,
                               max_def=max_def)
    return Eligibility(True, "eligible", dtype=dtype, codec=codec,
                       max_def=max_def)


def classify_pages(dict_page, data_pages):
    """Second gate, after the walk: every page's encoding must be one the
    inflate stage (device kernels AND numpy twin) reconstructs. Returns
    ``(ok, reason)``."""
    if not data_pages:
        return False, "chunk has no data pages"
    if dict_page is not None and dict_page.encoding not in (ENC_PLAIN,
                                                            ENC_PLAIN_DICT):
        return False, "dictionary page encoding %d" % dict_page.encoding
    for page in data_pages:
        if page.kind == PAGE_DATA_V2:
            return False, "v2 data pages (uncompressed levels) not supported"
        if page.encoding in (ENC_PLAIN_DICT, ENC_RLE_DICT):
            if dict_page is None:
                return False, "dictionary-encoded page without a dictionary"
        elif page.encoding != ENC_PLAIN:
            return False, "data page encoding %d" % page.encoding
        if page.def_encoding not in (None, ENC_RLE):
            return False, "definition-level encoding %d" % page.def_encoding
    return True, "eligible"


# -- pass-through column ---------------------------------------------------------------

class PassthroughChunk:
    """The raw compressed pages of ONE eligible column chunk (immutable).

    ``buf`` is the chunk's full byte span exactly as stored; page offsets
    index into it. ``decode()``/``decode_window()`` are the numpy
    reference/CPU-fallback decode (bit-identical to pyarrow); the device
    kernels consume the same layout via
    :mod:`petastorm_tpu_torch.ops.pagedec_kernels`. Decodes are PAGE-GRANULAR: a
    window decodes only its covering pages, so cutting one row group into
    many batches stays linear (boundary pages decode at most twice). Only
    the decoded *dictionary* is memoized (``_dict_cache``, bounded by the
    writer's dictionary-page limit and excluded from pickling) — memoizing
    whole decoded chunks would pin raw-sized arrays inside long-lived
    holders like the memcache."""

    __slots__ = ("buf", "codec", "dtype_str", "max_def", "dict_page",
                 "pages", "num_rows", "raw_nbytes", "_dict_cache")

    def __init__(self, buf, codec, dtype, max_def, dict_page, pages):
        self.buf = bytes(buf)
        self.codec = codec
        self.dtype_str = np.dtype(dtype).str
        self.max_def = int(max_def)
        self.dict_page = dict_page
        self.pages = tuple(pages)
        self.num_rows = sum(p.num_values for p in pages)
        #: what the classic path would have delivered for this chunk — the
        #: bytes the pass-through saves on the wire + PCIe
        self.raw_nbytes = self.num_rows * np.dtype(dtype).itemsize
        self._dict_cache = None

    def __getstate__(self):
        return {name: getattr(self, name) for name in self.__slots__
                if name != "_dict_cache"}

    def __setstate__(self, state):
        for name, value in state.items():
            setattr(self, name, value)
        self._dict_cache = None

    @property
    def dtype(self):
        return np.dtype(self.dtype_str)

    @property
    def nbytes(self):
        return len(self.buf)

    def page_starts(self):
        """Row offset of each data page's first value (cumulative counts)."""
        starts = [0]
        for p in self.pages:
            starts.append(starts[-1] + p.num_values)
        return starts

    def covering_pages(self, skip, take):
        """``(first_page, last_page_exclusive, row_base)`` of the pages a
        (skip, take) window touches; ``row_base`` is the first page's row
        offset within the chunk."""
        starts = self.page_starts()
        p0 = 0
        while p0 + 1 < len(self.pages) and starts[p0 + 1] <= skip:
            p0 += 1
        p1 = p0
        while p1 < len(self.pages) and starts[p1] < skip + take:
            p1 += 1
        return p0, p1, starts[p0]

    def dict_values(self):
        """The decoded dictionary page (memoized — small and re-used by
        every window of this chunk), or ``None``."""
        if self.dict_page is not None and self._dict_cache is None:
            self._dict_cache = decode_dict_values(self)
        return self._dict_cache

    def decode_window(self, skip, take):
        """Rows ``[skip, skip+take)`` via the numpy reference decode of the
        COVERING pages only."""
        if take <= 0:
            return np.empty((0,), dtype=self.dtype)
        p0, p1, base = self.covering_pages(skip, take)
        dict_values = self.dict_values()
        parts = [decode_data_page_numpy(self, page, dict_values)
                 for page in self.pages[p0:p1]]
        full = parts[0] if len(parts) == 1 else np.concatenate(parts)
        return full[skip - base:skip - base + take]

    def decode(self):
        """Full-chunk numpy reference decode."""
        return self.decode_window(0, self.num_rows).copy()


class PassthroughColumn:
    """An opaque columnar value of raw compressed pages with page-granular
    row slicing — what rides the worker → wire → batcher → loader path in
    place of the decoded ndarray.

    ``parts`` is a list of ``(chunk, skip, take)`` windows: batch cuts slice
    by adjusting windows (zero-copy on the underlying buffers; the covering
    pages are selected at inflate time), and cross-row-group concatenation
    just chains windows. ``materialize()`` is the host fallback decode."""

    __slots__ = ("parts", "dtype_str")

    def __init__(self, parts):
        if not parts:
            raise ValueError("PassthroughColumn needs at least one window")
        self.parts = list(parts)
        self.dtype_str = parts[0][0].dtype_str

    @classmethod
    def from_chunk(cls, chunk):
        return cls([(chunk, 0, chunk.num_rows)])

    @property
    def dtype(self):
        return np.dtype(self.dtype_str)

    @property
    def is_passthrough(self):
        return True

    def __len__(self):
        return sum(take for _c, _s, take in self.parts)

    @property
    def shape(self):
        return (len(self),)

    @property
    def nbytes(self):
        """Compressed payload bytes held (budget accounting: memcache etc.)."""
        return sum(c.nbytes for c, _s, _t in self.parts)

    @property
    def raw_nbytes(self):
        """What the decoded rows of this window will occupy."""
        return len(self) * self.dtype.itemsize

    @property
    def shipped_nbytes(self):
        """Bytes that actually cross the wire/PCIe for this window: the
        compressed payload of the COVERING pages plus each window's small
        page-table overhead (the ≤60%-of-raw number the bench asserts)."""
        total = 0
        for chunk, skip, take in self.parts:
            starts = chunk.page_starts()
            if chunk.dict_page is not None:
                total += chunk.dict_page.comp_size
            for i, page in enumerate(chunk.pages):
                if starts[i + 1] <= skip or starts[i] >= skip + take:
                    continue
                total += page.comp_size + 16  # ~page-table row
        return total

    def __getitem__(self, key):
        if not isinstance(key, slice):
            raise TypeError(
                "PassthroughColumn supports slice windows only (materialize() "
                "for element access)")
        start, stop, step = key.indices(len(self))
        if step != 1:
            raise ValueError("PassthroughColumn slices must be contiguous")
        return self.slice(start, stop - start)

    def slice(self, offset, length):
        """A new column over rows ``[offset, offset+length)`` — window
        arithmetic only, no decode, no copy."""
        if offset < 0 or length < 0 or offset + length > len(self):
            raise IndexError("slice [%d, %d) outside %d rows"
                             % (offset, offset + length, len(self)))
        out = []
        pos = 0
        for chunk, skip, take in self.parts:
            lo = max(offset, pos)
            hi = min(offset + length, pos + take)
            if hi > lo:
                out.append((chunk, skip + (lo - pos), hi - lo))
            pos += take
        if not out:
            out = [(self.parts[0][0], 0, 0)]
        return PassthroughColumn(out)

    @classmethod
    def concat(cls, columns):
        parts = []
        for col in columns:
            parts.extend(col.parts)
        return cls(parts)

    def detach(self):
        """Buffers are owned ``bytes`` (never slab views): nothing to copy."""
        return self

    def materialize(self):
        """Host-side decode of this window via the numpy reference twin
        (page-granular: only the covering pages of each window decode)."""
        outs = []
        for chunk, skip, take in self.parts:
            if take == 0:
                continue
            outs.append(chunk.decode_window(skip, take))
        if not outs:
            return np.empty((0,), dtype=self.dtype)
        return outs[0].copy() if len(outs) == 1 else np.concatenate(outs)

    def __reduce__(self):
        return (_rebuild_column, (self.parts,))

    def __repr__(self):
        return ("PassthroughColumn(rows=%d, windows=%d, dtype=%s, "
                "compressed=%dB, raw=%dB)"
                % (len(self), len(self.parts), self.dtype_str, self.nbytes,
                   self.raw_nbytes))


def _rebuild_column(parts):
    return PassthroughColumn(parts)


def is_passthrough(value):
    return getattr(value, "is_passthrough", False) is True


def materialize_columns(columns, cause=None):
    """Replace every pass-through value in a columnar dict with its decoded
    ndarray (host reference decode). ``cause`` names the degradation to count
    (warn-once) when anything was actually materialized — the seams where
    host inflate is a *fallback*, not the design (shuffling buffers, plain
    Reader consumers are the designed host path and pass ``cause=None``)."""
    out = None
    names = []
    for name, value in columns.items():
        if is_passthrough(value):
            if out is None:
                out = dict(columns)
            out[name] = value.materialize()
            names.append(name)
    if out is not None and cause is not None:
        warn_once(cause, "pass-through column(s) %s inflated on host; "
                  "the device inflate stage was bypassed at this seam",
                  sorted(names))
    return columns if out is None else out


# -- numpy reference decoders ----------------------------------------------------------

def _decompress_page(codec, payload, uncomp_size):
    """One page payload → raw bytes, via the same codec library pyarrow's own
    reader uses. Corruption (bad stream, wrong length) classifies as
    :class:`PagedecCorruptError`."""
    if codec == "UNCOMPRESSED":
        if len(payload) != uncomp_size:
            raise PagedecCorruptError(
                "uncompressed page is %d bytes, header says %d"
                % (len(payload), uncomp_size))
        return bytes(payload)
    if uncomp_size > 1 << 30:
        raise PagedecCorruptError(
            "implausible uncompressed page size %d" % uncomp_size)
    import pyarrow as pa

    try:
        raw = bytes(pa.Codec(codec.lower()).decompress(
            bytes(payload), uncomp_size))
    except Exception as e:  # noqa: BLE001 — any codec failure IS corruption here
        raise PagedecCorruptError(
            "%s page failed to inflate (%s)" % (codec, e)) from e
    if len(raw) != uncomp_size:
        raise PagedecCorruptError(
            "%s page inflated to %d bytes, header says %d"
            % (codec, len(raw), uncomp_size))
    return raw


def rle_bp_decode(buf, bit_width, count):
    """Parquet RLE/bit-packed hybrid → ``count`` int64 values.

    Vectorized numpy: the run table is scanned sequentially (runs ≪ values),
    RLE runs fill slices, bit-packed groups unpack via a bit-matrix gather —
    the same two-phase shape the device kernel uses (CODAG: sequential scan,
    parallel expansion). Bounds-checked throughout."""
    if bit_width < 0 or bit_width > 32:
        raise PagedecCorruptError("RLE bit width %d out of range" % bit_width)
    out = np.zeros(count, dtype=np.int64)
    if count == 0:
        return out
    if bit_width == 0:
        return out
    data = memoryview(buf)
    end = len(data)
    pos = 0
    filled = 0
    byte_width = (bit_width + 7) // 8
    while filled < count:
        if pos >= end:
            raise PagedecCorruptError(
                "RLE stream exhausted at %d of %d values" % (filled, count))
        header, pos = _varint(data, pos, end)
        if header & 1:
            # bit-packed run: (header >> 1) groups of 8 values
            groups = header >> 1
            n = groups * 8
            nbytes = groups * bit_width
            if pos + nbytes > end:
                raise PagedecCorruptError("bit-packed run past stream end")
            packed = np.frombuffer(data, dtype=np.uint8, count=nbytes,
                                   offset=pos)
            pos += nbytes
            bits = np.unpackbits(packed, bitorder="little")
            vals = bits.reshape(n, bit_width).astype(np.int64)
            weights = (1 << np.arange(bit_width, dtype=np.int64))
            vals = vals @ weights
            take = min(n, count - filled)
            # trailing values in the final group are padding, legal per spec
            out[filled:filled + take] = vals[:take]
            filled += take
        else:
            run = header >> 1
            if run <= 0:
                raise PagedecCorruptError("zero-length RLE run")
            if pos + byte_width > end:
                raise PagedecCorruptError("RLE run value past stream end")
            value = int.from_bytes(bytes(data[pos:pos + byte_width]), "little")
            pos += byte_width
            take = min(run, count - filled)
            out[filled:filled + take] = value
            filled += take
    return out


def _decode_def_levels(raw, num_values, max_def):
    """The v1 data page's definition-level block: returns the byte offset of
    the values section. Null-free is an *eligibility invariant* — a zero
    definition level here means the footer statistics lied, which is
    corruption, not a fallback."""
    if max_def == 0:
        return 0
    if len(raw) < 4:
        raise PagedecCorruptError("page too short for definition-level block")
    block_len = struct.unpack_from("<I", raw, 0)[0]
    if 4 + block_len > len(raw):
        raise PagedecCorruptError("definition-level block past page end")
    levels = rle_bp_decode(raw[4:4 + block_len], 1, num_values)
    if not (levels == 1).all():
        raise PagedecCorruptError(
            "null value in a chunk whose statistics claimed null_count=0")
    return 4 + block_len


def decode_dict_values(chunk):
    """The dictionary page's PLAIN values as a typed numpy array (or None)."""
    page = chunk.dict_page
    if page is None:
        return None
    payload = chunk.buf[page.payload_offset:page.payload_offset + page.comp_size]
    raw = _decompress_page(chunk.codec, payload, page.uncomp_size)
    dtype = chunk.dtype
    if len(raw) < page.num_values * dtype.itemsize:
        raise PagedecCorruptError("dictionary page shorter than its %d values"
                                  % page.num_values)
    return np.frombuffer(raw, dtype=dtype, count=page.num_values)


def decode_data_page_numpy(chunk, page, dict_values):
    """One v1 data page → typed numpy values (the reference decode)."""
    payload = chunk.buf[page.payload_offset:page.payload_offset + page.comp_size]
    raw = _decompress_page(chunk.codec, payload, page.uncomp_size)
    off = _decode_def_levels(raw, page.num_values, chunk.max_def)
    values = raw[off:]
    dtype = chunk.dtype
    if page.encoding == ENC_PLAIN:
        need = page.num_values * dtype.itemsize
        if len(values) < need:
            raise PagedecCorruptError(
                "PLAIN page holds %d bytes, needs %d" % (len(values), need))
        return np.frombuffer(values, dtype=dtype, count=page.num_values)
    if page.encoding in (ENC_PLAIN_DICT, ENC_RLE_DICT):
        if dict_values is None:
            raise PagedecCorruptError("dictionary-encoded page without a "
                                      "dictionary")
        if len(values) < 1:
            raise PagedecCorruptError("dictionary page body empty")
        bit_width = values[0]
        idx = rle_bp_decode(values[1:], bit_width, page.num_values)
        if idx.size and (idx.max(initial=0) >= len(dict_values)
                         or idx.min(initial=0) < 0):
            raise PagedecCorruptError(
                "dictionary index out of range (max %d, dictionary %d)"
                % (int(idx.max(initial=0)), len(dict_values)))
        return dict_values[idx]
    raise PagedecCorruptError("unsupported data page encoding %d"
                              % page.encoding)


def decode_chunk_numpy(chunk):
    """Full column-chunk reference decode: every data page, concatenated.
    Bit-identical to pyarrow's decode of the same chunk (pinned in
    tests/test_pagedec.py, incl. the seeded fuzz corpora)."""
    dict_values = decode_dict_values(chunk)
    parts = [decode_data_page_numpy(chunk, page, dict_values)
             for page in chunk.pages]
    if not parts:
        return np.empty((0,), dtype=chunk.dtype)
    return parts[0] if len(parts) == 1 else np.concatenate(parts)


# -- chunk construction (the worker's entry point) -------------------------------------

def build_chunk(raw, eligibility, expected_values=None, require_saving=True):
    """Walk + page-classify one raw chunk span into a :class:`PassthroughChunk`.

    Returns ``(chunk_or_None, reason)`` — ``None`` means the *pages* turned
    out ineligible (footer said yes, stream said no: e.g. a mid-column
    dictionary-overflow fallback to an unsupported encoding). Corruption
    raises; ineligibility degrades.

    ``require_saving``: a chunk whose compressed span is not smaller than its
    decoded rows (incompressible float noise dictionary-encoded into a
    *bigger* stream — measured on random f32) is pointless to pass through:
    shipping it raw-decoded costs fewer link bytes. Such chunks degrade with
    reason ``no byte saving`` (CODAG only wins when the compressed
    representation is the smaller one)."""
    dict_page, data_pages = walk_pages(raw, expected_values)
    ok, reason = classify_pages(dict_page, data_pages)
    if not ok:
        return None, reason
    chunk = PassthroughChunk(raw, eligibility.codec, eligibility.dtype,
                             eligibility.max_def, dict_page, data_pages)
    if require_saving and chunk.nbytes >= chunk.raw_nbytes:
        return None, ("no byte saving (compressed %d >= raw %d)"
                      % (chunk.nbytes, chunk.raw_nbytes))
    return chunk, reason


# -- page-index cache (the remote planner's page-granular split points) ----------------

class PageIndexCache:
    """Process-wide memo of walked page boundaries keyed by ``(path, row_group,
    column)``. Parquet keeps page offsets inline in the data, not in the footer, so the
    object-store range planner can split a big chunk fetch at page starts only once a
    walk has seen them: a chunk's first fetch splits at request size, its re-reads at
    page starts. A bounded count LRU (a get refreshes recency).

    The walked boundaries are also published through the host-wide cache arena (key
    ``("pi", path, rg, column)``): a process that never walked a chunk still splits its
    first fetch at page starts when a peer on the host has."""

    def __init__(self, max_entries=4096):
        from collections import OrderedDict

        self._lock = threading.Lock()
        self._entries = OrderedDict()
        self._max = int(max_entries)

    @staticmethod
    def _arena():
        from petastorm_tpu_torch.io import arena as arena_mod

        return arena_mod.process_arena()

    def put(self, path, rg, column, chunk_offset, page_offsets):
        key = (path, rg, column)
        entry = (int(chunk_offset), tuple(int(o) for o in page_offsets))
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
            elif len(self._entries) >= self._max:
                self._entries.popitem(last=False)
            self._entries[key] = entry
        arena_obj = self._arena()
        if arena_obj is not None:
            import pickle

            arena_obj.put_bytes(("pi",) + key, pickle.dumps(entry, protocol=2))

    def get(self, path, rg, column):
        """``(chunk_offset, page_offsets)`` or ``None``."""
        key = (path, rg, column)
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
        if entry is not None:
            return entry
        arena_obj = self._arena()
        if arena_obj is None:
            return None
        blob = arena_obj.get_bytes(("pi",) + key)
        if blob is None:
            return None
        import pickle

        try:
            chunk_offset, page_offsets = pickle.loads(blob)
        except Exception:  # noqa: BLE001 — a torn or foreign memo reads as a miss
            return None
        with self._lock:  # admit locally: later gets skip the arena
            if key not in self._entries and len(self._entries) >= self._max:
                self._entries.popitem(last=False)
            self._entries[key] = (int(chunk_offset), tuple(page_offsets))
            return self._entries[key]

    def clear(self):
        with self._lock:
            self._entries.clear()


_page_index_lock = threading.Lock()
_page_index = None


def shared_page_index():
    """The process-wide :class:`PageIndexCache` (created on first use)."""
    global _page_index
    with _page_index_lock:
        if _page_index is None:
            _page_index = PageIndexCache()
        return _page_index

# -- counters --------------------------------------------------------------------------


class _Counter:
    """A thread-safe running total (count or seconds)."""

    __slots__ = ("_lock", "value")

    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0

    def inc(self, amount=1):
        with self._lock:
            self.value += amount

    def observe(self, seconds):
        self.inc(seconds)


_COUNTERS = {name: _Counter() for name in (
    "pages",                 # compressed pages shipped through the pass-through path
    "bytes_compressed",      # compressed page bytes handed to the device-bound transfer
    "bytes_saved",           # raw-minus-compressed bytes kept off the host->device link
    "fallback_columns",      # column reads that degraded to the classic host read
    "host_inflate_columns",  # pass-through columns the loader inflated on the HOST
    "inflate_seconds",       # the loader's inflate stage, seconds summed over batches
)}


def pagedec_counters():
    """The process-wide pass-through counters, ``{name: counter}`` under the JAX
    package's names; each counter has ``inc(n)`` and a ``value``."""
    return _COUNTERS


def counter_values():
    """``{name: value}`` of every pass-through counter."""
    return {name: c.value for name, c in _COUNTERS.items()}
