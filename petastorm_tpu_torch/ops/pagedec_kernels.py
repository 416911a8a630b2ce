"""Device inflate stage for the compressed-page pass-through.

Port of ``petastorm_tpu.ops.pagedec_kernels``, the device half of
:mod:`petastorm_tpu_torch.io.pagedec`: the compressed pages of a batch cross the host to
device link, and the card inflates them.

- :func:`snappy_inflate_ragged` is kernel K3 (``csrc/pagedec.cu``, port of
  ``petastorm_tpu/ops/pagedec_kernels.py:149 _snappy_pages_kernel``): the snappy LZ token
  machine over a batch of pages packed back to back, ONE launch, one thread block a page
  (a warp machine in shared memory); a bound violation latches the page's ``ok`` flag.
  :func:`snappy_inflate_pages` keeps the reference's padded signature as a thin caller
  of it. :func:`stored_pages` is the UNCOMPRESSED twin (a torch reshuffle, no kernel).
- :func:`rle_scan_pages` is the run scan (port of the ``lax.while_loop``
  ``_rle_run_scan``) and :func:`extract_pages` is kernel K4 (port of ``_extract_kernel``,
  with the run lookup, the window gather, the per-page checks and the dictionary gather
  inside the kernel): ONE launch each over every data page of a batch, described by a
  page table (:func:`page_row`, :data:`PAGE_COLS`). K4's windows are 5 bytes, so it
  takes every bit width Parquet allows (1-32), where the reference's 4-byte windows stop
  at 24. :func:`rle_run_scan`, :func:`rle_extract` and :func:`rle_expand` keep the
  reference's one-stream signatures as thin callers of them.
- :func:`inflate_columns` is the loader-facing entry: one batch's
  :class:`~petastorm_tpu_torch.io.pagedec.PassthroughColumn` values → decoded tensors on
  the device, from the covering pages only, with one upload (:func:`stage_batch`), one
  launch each of K3, the scan and K4, and one read back to the host.
  :func:`inflate_column`, :func:`inflate_window` and :func:`inflate_chunk` are its
  one-column cases.

Every kernel wrapper runs its kernel on a CUDA tensor and its plain version beside it on
a CPU tensor, and nothing else; ``<wrapper>.launches`` counts kernel launches. The numpy
decoders of ``io/pagedec.py`` are the host twin: when a page's ``ok`` flag latches or a
page check fails, the stage raises :class:`DeviceInflateError`; the caller runs the
host twin on the same pages to classify them, which raises
:class:`~petastorm_tpu_torch.errors.PagedecCorruptError` if the bytes are bad, and
raises :class:`KernelFaultError` if the twin decodes them (the device path delivers
nothing the host decoded). A kernel that fails to build or launch raises
``RuntimeError`` to the caller.

The stage reads back to the host once a batch: K3's ok flags and each data page's
verdict (a :data:`REASONS` code), in one vector; on a CUDA device the read waits for
the transfer stream. :data:`HOST_READS` counts it. (The JAX package reads the ok flags
once a column window and four values a nullable dictionary data page.)
"""
from __future__ import annotations

import functools
import threading

import numpy as np

from petastorm_tpu_torch.io.pagedec import ENC_PLAIN, PassthroughColumn

_MAX_BIT_WIDTH = 32  # Parquet's widest; 5-byte windows cover shift (<= 7) + width bits
_INT32_MAX = 2 ** 31 - 1
#: K3's page table columns (csrc/pagedec.cu kTableCols): src_off, src_len, comp_len,
#: dst_off, out_cap
PAGE_TABLE_COLS = 5
_PAGE_ALIGN = 16  # pages start 16-byte aligned in K3's buffers (cp.async, 16-byte stores)


class DeviceInflateError(Exception):
    """The device path rejected the pages: an ``ok`` flag latched false or a layout
    check failed. The caller runs the host twin on them, which raises the classified
    error if the bytes are bad. ``column`` names the column (:func:`inflate_columns`)."""

    column = None


class KernelFaultError(RuntimeError):
    """The device path rejected pages that the host twin decodes: the kernels (or, on
    the CPU, their plain versions) disagree with the reference decode."""


class _Count:
    __slots__ = ("_lock", "value")

    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0

    def add(self, n=1):
        with self._lock:
            self.value += n


#: device-to-host reads made by the inflate stage (each a stream sync on a CUDA device)
HOST_READS = _Count()


@functools.lru_cache(maxsize=None)
def _torch_dtype(np_dtype):
    import torch

    return torch.from_numpy(np.empty(0, dtype=np_dtype)).dtype


def _require_cuda(t, name):
    """Raise unless ``t`` is a CUDA tensor (the wrappers take CPU or CUDA tensors)."""
    if t.device.type != "cuda":
        raise ValueError("%s runs on CPU or CUDA tensors, got %s" % (name, t.device))


def _wrap32(x):
    """``x`` as an int32 wraps it (the reference's varint arithmetic)."""
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x >= 1 << 31 else x


# -- K3: snappy pages ------------------------------------------------------------------
#
# Format: varint uncompressed length, then tagged elements. tag & 3:
#   0 literal  (len from tag>>2, 60..63 select 1..4 extra length bytes)
#   1 copy     (len 4..11 from tag bits 2-4, offset 11 bits: tag bits 5-7 + 1 byte)
#   2 copy     (len 1..64 from tag>>2, offset 2 bytes LE)
#   3 copy     (len 1..64 from tag>>2, offset 4 bytes LE)
# Copies may overlap their own output (offset < len): the byte-serial inner loop IS the
# semantics. Bound checks are in Python integers (64-bit in the kernel), the varint
# preamble is 32-bit as in the reference.


def _snappy_page_plain(comp, comp_len, out_cap):
    """One page: ``comp`` (src_cap,) uint8 numpy, its readable span → ((out_cap,) uint8,
    ok)."""
    src_cap = comp.shape[0]
    data = comp.tobytes()

    def rd(i):
        return data[min(max(i, 0), src_cap - 1)] if src_cap else 0

    ok = True
    pos = val = shift = 0
    done = False
    while not done and ok:
        b = rd(pos)
        if shift < 32:
            val |= (b & 0x7F) << shift
        done = (b & 0x80) == 0
        ok = ok and pos < comp_len and shift <= 28
        pos += 1
        shift += 7
    out_len = _wrap32(val)
    ok = ok and out_len <= out_cap
    out = bytearray(out_cap)
    src, dst = pos, 0
    while src < comp_len and dst < out_len and ok:
        tag = rd(src)
        t = tag & 3
        if t == 0:
            n0 = tag >> 2
            extra = n0 - 59 if n0 >= 60 else 0
            mask = 0x7FFFFFFF if extra >= 4 else (1 << (8 * min(extra, 3))) - 1
            word = rd(src + 1) | rd(src + 2) << 8 | rd(src + 3) << 16 \
                | (rd(src + 4) & 0x7F) << 24
            ln = (word & mask if n0 >= 60 else n0) + 1
            start = src + 1 + extra
            if not (ln >= 1 and start + ln <= comp_len and dst + ln <= out_len):
                ok = False
                break
            if start + ln <= src_cap:
                out[dst:dst + ln] = data[start:start + ln]
            else:  # comp_len past the buffer: clamped reads, as the reference
                for k in range(ln):
                    out[dst + k] = rd(start + k)
            src, dst = start + ln, dst + ln
        else:
            b1 = rd(src + 1)
            if t == 1:
                ln, off, consumed = ((tag >> 2) & 7) + 4, ((tag >> 5) << 8) | b1, 2
            elif t == 2:
                ln, off, consumed = (tag >> 2) + 1, b1 | rd(src + 2) << 8, 3
            else:
                ln, consumed = (tag >> 2) + 1, 5
                off = _wrap32(b1 | rd(src + 2) << 8 | rd(src + 3) << 16 | rd(src + 4) << 24)
            if not (src + consumed <= comp_len and 0 < off <= dst and dst + ln <= out_len):
                ok = False
                break
            for k in range(ln):  # byte-serial: an overlapping copy repeats its pattern
                out[dst + k] = out[dst - off + k]
            src, dst = src + consumed, dst + ln
    ok = ok and dst == out_len and src == comp_len
    return np.frombuffer(bytes(out), np.uint8), ok


def _snappy_ragged_plain(src, table, out_bytes):
    """Plain version of K3: a Python token loop per page of the ragged page table. Bytes
    of the output that no page's span covers are zero."""
    import torch

    buf = src.cpu().numpy()
    out = np.zeros(out_bytes, np.uint8)
    ok = np.zeros(table.shape[0], bool)
    for i, (src_off, src_len, comp_len, dst_off, out_cap) in enumerate(
            table.cpu().numpy().tolist()):
        if not (src_off >= 0 and src_len >= 0 and src_off + src_len <= buf.shape[0]
                and dst_off >= 0 and out_cap >= 0 and dst_off + out_cap <= out_bytes):
            continue  # a span outside the buffers: ok stays False, nothing written
        out[dst_off:dst_off + out_cap], ok[i] = _snappy_page_plain(
            buf[src_off:src_off + src_len], comp_len, out_cap)
    return torch.from_numpy(out).to(src.device), torch.from_numpy(ok).to(src.device)


def _check_ragged(src, table, name):
    import torch

    if src.dtype != torch.uint8 or src.dim() != 1:
        raise TypeError("%s takes a 1-D uint8 page buffer, got %s %s"
                        % (name, src.dtype, tuple(src.shape)))
    if table.dtype != torch.int64 or table.dim() != 2 or table.shape[1] != PAGE_TABLE_COLS:
        raise TypeError("%s takes an (n_pages, %d) int64 page table, got %s %s"
                        % (name, PAGE_TABLE_COLS, table.dtype, tuple(table.shape)))
    if src.device != table.device:
        raise ValueError("%s: pages on %s, page table on %s"
                         % (name, src.device, table.device))


def snappy_inflate_ragged(src, table, out_bytes):
    """Inflate a batch of snappy pages packed back to back: one K3 launch.

    ``src``: (src_bytes,) uint8. ``table``: (n_pages, 5) int64 rows ``[src_off, src_len,
    comp_len, dst_off, out_cap]``: the page's readable bytes are ``src[src_off:src_off +
    src_len]`` (reads past them clamp, as the reference's gather does), its stream is
    ``comp_len`` bytes long, and it decodes into ``out[dst_off:dst_off + out_cap]``, zero
    past the bytes it decoded. Its ``ok`` latches where the reference's does (a bad
    stream, a decoded length above ``out_cap``) and when a span leaves the buffers.
    Returns ``(out (out_bytes,) uint8, ok (n_pages,) bool)``; bytes outside every page's
    span are unspecified on a CUDA device (zero on the CPU).

    K3 on CUDA tensors (``csrc/pagedec.cu``), the plain version on CPU tensors.
    ``snappy_inflate_ragged.launches`` counts kernel launches."""
    import torch

    _check_ragged(src, table, "snappy_inflate_ragged")
    out_bytes = int(out_bytes)
    if out_bytes < 0:
        raise ValueError("snappy_inflate_ragged: out_bytes %d" % out_bytes)
    if src.device.type == "cpu":
        return _snappy_ragged_plain(src, table, out_bytes)
    _require_cuda(src, "snappy_inflate_ragged")
    from petastorm_tpu_torch.ops import kernels

    src, table = src.contiguous(), table.contiguous()
    n = table.shape[0]
    out = torch.empty((out_bytes,), dtype=torch.uint8, device=src.device)
    ok = torch.empty((n,), dtype=torch.int32, device=src.device)
    if n == 0:
        return out, ok != 0
    rc = kernels.library().ptpu_snappy_ragged(
        src.data_ptr(), src.shape[0], table.data_ptr(), out.data_ptr(), out_bytes,
        ok.data_ptr(), n, *kernels.launch_target(src.device))
    kernels.check_launch("snappy_ragged", rc)
    snappy_inflate_ragged.launches += 1
    return out, ok != 0


snappy_inflate_ragged.launches = 0


def _check_pages(comp, meta, name):
    import torch

    if comp.dtype != torch.uint8 or comp.dim() != 2 or comp.shape[1] < 1:
        raise TypeError("%s takes (n_pages, src_cap >= 1) uint8 pages, got %s %s"
                        % (name, comp.dtype, tuple(comp.shape)))
    if meta.dtype != torch.int32 or tuple(meta.shape) != (comp.shape[0], 2):
        raise TypeError("%s takes an (n_pages, 2) int32 page table, got %s %s"
                        % (name, meta.dtype, tuple(meta.shape)))
    if comp.device != meta.device:
        raise ValueError("%s: pages on %s, page table on %s"
                         % (name, comp.device, meta.device))


def snappy_inflate_pages(comp, meta, out_cap):
    """Inflate a batch of snappy pages (the reference's padded signature).

    ``comp``: (n_pages, src_cap) uint8, zero-padded compressed pages. ``meta``: (n_pages,
    2) int32 rows [compressed_len, uncompressed_len]. Returns ``(raw (n_pages, out_cap)
    uint8, ok (n_pages,) bool)``; a row is zero past the bytes it decoded.

    A thin caller of :func:`snappy_inflate_ragged` (K3 on CUDA tensors, the plain version
    on CPU tensors): page ``i`` reads row ``i`` of ``comp`` and decodes into row ``i``."""
    import torch

    _check_pages(comp, meta, "snappy_inflate_pages")
    out_cap = int(out_cap)
    n, src_cap = comp.shape
    idx = torch.arange(n, dtype=torch.int64, device=comp.device)
    table = torch.stack([idx * src_cap, torch.full_like(idx, src_cap), meta[:, 0].long(),
                         idx * out_cap, torch.full_like(idx, out_cap)], dim=1)
    out, ok = snappy_inflate_ragged(comp.contiguous().view(-1), table, n * out_cap)
    return out.view(n, out_cap), ok


def stored_pages(comp, meta, out_cap):
    """The UNCOMPRESSED-codec twin of :func:`snappy_inflate_pages`: pages are already
    raw — pad/truncate to the output layout (a torch reshuffle, no kernel)."""
    import torch

    _check_pages(comp, meta, "stored_pages")
    out_cap = int(out_cap)
    src_cap = comp.shape[1]
    if src_cap < out_cap:
        comp = torch.nn.functional.pad(comp, (0, out_cap - src_cap))
    else:
        comp = comp[:, :out_cap]
    idx = torch.arange(out_cap, device=comp.device)[None, :]
    out = torch.where(idx < meta[:, 1:2], comp, torch.zeros_like(comp))
    return out, meta[:, 0] == meta[:, 1]


# -- the batched run scan and K4 -------------------------------------------------------
#
# Both take a page table: one int64 row of PAGE_COLS a data page (csrc/pagedec.cu
# PageCol). A page's bytes are [off, off + size) of K3's output (buf 0) or of the stored,
# UNCOMPRESSED pages (buf 1).

#: the page table's columns, in order (csrc/pagedec.cu PageCol)
PAGE_COLS = ("buf", "off", "size", "ok_idx", "max_def", "enc", "num_values", "item",
             "dict_buf", "dict_off", "dict_n", "run_off", "run_cap", "max_runs",
             "stream_len", "lo", "hi", "dst")
_COL = {name: i for i, name in enumerate(PAGE_COLS)}
ENC_VALUES_PLAIN, ENC_VALUES_DICT, ENC_VALUES_INDICES = 0, 1, 2
#: K4's values a block (csrc/pagedec.cu kValuesPerBlock): the block table's stride
VALUES_PER_BLOCK = 1024
#: a page's verdict (the scan's and K4's flag) → the DeviceInflateError message
REASONS = {
    1: "page inflate kernel latched ok=False",
    2: "page too short for level block",
    3: "level block past page end",
    4: "PLAIN page shorter than its values",
    5: "dictionary page missing",
    6: "empty dictionary-index body",
    7: "RLE expansion latched ok=False",
    8: "dictionary index out of range",
}
_INFLATE, _RLE_LATCHED, _INDEX_RANGE = 1, 7, 8


def page_row(**fields):
    """One page table row: ``fields`` by :data:`PAGE_COLS` name; ``ok_idx`` and
    ``stream_len`` default to -1, the rest to 0."""
    row = [0] * len(PAGE_COLS)
    row[_COL["ok_idx"]] = row[_COL["stream_len"]] = -1
    for name, value in fields.items():
        row[_COL[name]] = int(value)
    return row


def block_table(pages):
    """K4's block-range table of a page table ((n, PAGE_COLS) int64 numpy): (n_blocks, 2)
    int32 rows ``[page, first value]``, :data:`VALUES_PER_BLOCK` values a block, over every
    value of a dictionary or index page and the delivered ``[lo, hi)`` of a PLAIN page."""
    pages = np.asarray(pages, np.int64).reshape(-1, len(PAGE_COLS))
    plain = pages[:, _COL["enc"]] == ENC_VALUES_PLAIN
    start = np.where(plain, pages[:, _COL["lo"]], 0)
    limit = np.where(plain, pages[:, _COL["hi"]], pages[:, _COL["num_values"]])
    counts = np.maximum(0, -(-(limit - start) // VALUES_PER_BLOCK))
    page = np.repeat(np.arange(len(pages)), counts)
    rank = np.arange(len(page)) - np.repeat(np.cumsum(counts) - counts, counts)
    return np.stack([page, start[page] + rank * VALUES_PER_BLOCK], 1).astype(np.int32)


def _check_page_inputs(name, k3_out, stored, pages):
    import torch

    for what, t in (("K3 output", k3_out), ("stored pages", stored)):
        if t.dtype != torch.uint8 or t.dim() != 1:
            raise TypeError("%s takes a 1-D uint8 %s buffer, got %s %s"
                            % (name, what, t.dtype, tuple(t.shape)))
    if pages.dtype != torch.int64 or pages.dim() != 2 or pages.shape[1] != len(PAGE_COLS):
        raise TypeError("%s takes an (n_pages, %d) int64 page table, got %s %s"
                        % (name, len(PAGE_COLS), pages.dtype, tuple(pages.shape)))
    if not k3_out.device == stored.device == pages.device:
        raise ValueError("%s: buffers and page table on different devices" % name)


def _clamped(buf, cap):
    def rd(i):
        return int(buf[min(max(i, 0), cap - 1)]) if cap > 0 else 0
    return rd


def _scan_page_plain(buffers, row, k3_ok, runs, m):
    """One page of the plain scan (csrc/pagedec.cu scan_page): returns the verdict and
    sets ``m`` = [stream_off, bit_width, n_runs]."""
    r = dict(zip(PAGE_COLS, row))
    ok_idx = r["ok_idx"]
    if (ok_idx >= len(k3_ok) or not k3_ok[ok_idx]) if ok_idx >= 0 else ok_idx != -1:
        return _INFLATE
    buf = buffers[r["buf"]]
    off, size = r["off"], r["size"]
    if not (off >= 0 and size >= 0 and off <= buf.shape[0] - size):
        return _INFLATE
    page = buf[off:off + size]
    pos = 0
    if r["max_def"]:
        if size < 4:
            return 2
        pos = 4 + int(page[:4].view("<u4")[0])
        if pos > size:
            return 3
    total = r["num_values"]
    if r["enc"] == ENC_VALUES_PLAIN:
        m[0] = pos
        return 4 if size - pos < total * r["item"] else 0
    if r["enc"] == ENC_VALUES_DICT and r["dict_n"] < 0:
        return 5
    if size - pos < 1:
        return 6
    bit_width = int(page[pos])
    m[0], m[1] = pos + 1, bit_width
    if bit_width == 0:
        return 0
    if bit_width > _MAX_BIT_WIDTH:
        return _RLE_LATCHED
    data = page[pos + 1:]
    cap = data.shape[0]
    rd = _clamped(data, cap)
    data_len = r["stream_len"] if r["stream_len"] >= 0 else cap
    run_off, run_cap, max_runs = r["run_off"], r["run_cap"], r["max_runs"]
    byte_width = (bit_width + 7) // 8
    p = filled = nruns = 0
    ok = True
    while filled < total and ok:
        header = shift = 0
        done = False
        while not done and ok:
            b = rd(p)
            if shift < 32:
                header |= (b & 0x7F) << shift
            done = (b & 0x80) == 0
            ok = ok and p < data_len and shift <= 28
            p += 1
            shift += 7
        header = _wrap32(header)
        packed = (header & 1) == 1
        groups = header >> 1
        count = groups * 8 if packed else groups
        consumed = groups * bit_width if packed else byte_width
        v = 0
        for k in range(byte_width):
            v |= rd(p + k) << (8 * k)
        ok = ok and p + consumed <= data_len and count > 0 and nruns < max_runs
        idx = min(nruns, max_runs - 1)
        if run_off >= 0 and idx < run_cap and run_off + idx < runs.shape[0]:
            # a packed run's trailing values beyond `total` are spec-legal padding
            runs[run_off + idx] = (min(filled + count, total), int(packed),
                                   0 if packed else _wrap32(v), _wrap32(p))
        p += consumed
        filled += count
        nruns += 1
    m[2] = min(nruns, _INT32_MAX)
    return 0 if ok and filled >= total else _RLE_LATCHED


def _rle_scan_pages_plain(k3_out, stored, pages, k3_ok, runs_total):
    """Plain version of the batched scan: a Python walk a page. Run entries it does not
    write are zero."""
    import torch

    buffers = (k3_out.cpu().numpy(), stored.cpu().numpy())
    ok = k3_ok.cpu().numpy()
    rows = pages.cpu().numpy().tolist()
    runs = np.zeros((runs_total, 4), np.int32)
    meta = np.zeros((len(rows), 4), np.int32)
    for i, row in enumerate(rows):
        m = [0, 0, 0]
        reason = _scan_page_plain(buffers, row, ok, runs, m)
        meta[i] = m + [reason]
    dev = pages.device
    return (torch.from_numpy(runs).to(dev), torch.from_numpy(meta).to(dev),
            torch.from_numpy(meta[:, 3].copy()).to(dev))


def rle_scan_pages(k3_out, stored, pages, k3_ok, runs_total):
    """The run scan over every data page of a batch: ONE launch.

    ``k3_out``, ``stored``: 1-D uint8 buffers holding the pages' bytes (K3's output and
    the stored pages); ``pages``: (n, len(PAGE_COLS)) int64 page table (:func:`page_row`);
    ``k3_ok``: K3's (n_ok,) bool ok flags, which ``ok_idx`` indexes; ``runs_total``: rows
    of the ragged run table, at least every page's ``run_off + run_cap``.

    Per page, in the reference's order (``_decode_window``, then ``_rle_run_scan``): its
    K3 flag, the level block's length read from its bytes, the PLAIN length check, the
    dictionary and index-body checks, the bit width, then the run walk with the
    reference's latches (a run of no values, an overrun stream, more than ``max_runs``
    runs, fewer than ``num_values`` values; bounds in 64 bits). Returns ``(runs
    (runs_total, 4) int32 [run_end, is_packed, rle_value, byte_pos] with only the
    entries that exist written, meta (n, 4) int32 [stream_off, bit_width, n_runs,
    verdict], flags (n,) int32 verdict)``, a verdict being 0 or a :data:`REASONS` code.

    The scan kernel on CUDA tensors, the plain version on CPU tensors.
    ``rle_scan_pages.launches`` counts kernel launches."""
    import torch

    _check_page_inputs("rle_scan_pages", k3_out, stored, pages)
    runs_total = int(runs_total)
    if runs_total < 0:
        raise ValueError("rle_scan_pages: runs_total %d" % runs_total)
    if k3_ok.dtype != torch.bool or k3_ok.dim() != 1 or k3_ok.device != pages.device:
        raise TypeError("rle_scan_pages takes K3's 1-D bool ok flags on the pages' device")
    if pages.device.type == "cpu":
        return _rle_scan_pages_plain(k3_out, stored, pages, k3_ok, runs_total)
    _require_cuda(pages, "rle_scan_pages")
    from petastorm_tpu_torch.ops import kernels

    dev = pages.device
    k3_out, stored, pages, k3_ok = (t.contiguous() for t in (k3_out, stored, pages, k3_ok))
    n = pages.shape[0]
    runs = torch.empty((runs_total, 4), dtype=torch.int32, device=dev)
    meta = torch.empty((n, 4), dtype=torch.int32, device=dev)
    flags = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return runs, meta, flags
    rc = kernels.library().ptpu_rle_scan_pages(
        k3_out.data_ptr(), k3_out.shape[0], stored.data_ptr(), stored.shape[0],
        pages.data_ptr(), n, k3_ok.data_ptr(), k3_ok.shape[0], runs.data_ptr(), runs_total,
        meta.data_ptr(), flags.data_ptr(), *kernels.launch_target(dev))
    kernels.check_launch("rle_scan_pages", rc)
    rle_scan_pages.launches += 1
    return runs, meta, flags


rle_scan_pages.launches = 0


def _le_bytes(values, item):
    """(k,) int64 → (k, item) uint8, little-endian."""
    import torch

    shifts = 8 * torch.arange(item, dtype=torch.int64)
    return ((values[:, None] >> shifts[None, :]) & 0xFF).to(torch.uint8)


def _extract_page_plain(buffers, r, m, runs, values, out):
    """One page of the plain K4 over the values ``values`` (int64) it covers; returns
    True where a dictionary index is out of range."""
    import torch

    item, lo, hi, dst = r["item"], r["lo"], r["hi"], r["dst"]
    if not (item in (4, 8) and 0 <= lo <= hi <= r["num_values"] and dst >= 0
            and dst % item == 0 and dst <= out.shape[0] - (hi - lo) * item):
        return False
    delivered = (values >= lo) & (values < hi)
    at = (dst + (values[delivered] - lo) * item)[:, None] + torch.arange(item)[None, :]
    buf = buffers[r["buf"]]
    off, size, stream_off = r["off"], r["size"], int(m[0])
    bit_width = int(m[1])
    n_runs = min(int(m[2]), r["run_cap"], r["max_runs"])
    run_off = r["run_off"]
    runs_in = r["enc"] == ENC_VALUES_PLAIN or bit_width == 0 or (
        n_runs >= 1 and 0 <= run_off <= runs.shape[0] - n_runs)
    readable = off >= 0 and size >= 0 and off <= buf.shape[0] - size \
        and 0 <= stream_off <= size and runs_in
    if int(m[3]) != 0 or not readable:
        out[at] = 0
        return False
    page = buf[off:off + size]
    if r["enc"] == ENC_VALUES_PLAIN:
        src = (stream_off + values[delivered] * item)[:, None] + torch.arange(item)[None, :]
        out[at] = page[src]
        return False
    data = page[stream_off:]
    cap = data.shape[0]
    if bit_width == 0:
        idx = torch.zeros_like(values)
    else:
        e = runs[run_off:run_off + n_runs].long()
        rid = torch.searchsorted(e[:, 0].contiguous(), values, right=True).clamp(max=n_runs - 1)
        run_start = torch.where(rid == 0, torch.zeros_like(rid), e[(rid - 1).clamp(min=0), 0])
        bitpos = (e[rid, 3] & 0xFFFFFFFF) * 8 + (values - run_start) * bit_width
        if cap:
            gather = ((bitpos >> 3)[:, None] + torch.arange(5)[None, :]).clamp(0, cap - 1)
            word = (data[gather].long() << (8 * torch.arange(5))[None, :]).sum(1)
        else:
            word = torch.zeros_like(values)
        packed = (word >> (bitpos & 7)) & ((1 << bit_width) - 1)
        idx = torch.where(e[rid, 1] != 0, packed, e[rid, 2] & 0xFFFFFFFF)
    if r["enc"] == ENC_VALUES_INDICES:
        out[at] = _le_bytes(idx[delivered], item)
        return False
    si = torch.where(idx >= 1 << 31, idx - (1 << 32), idx)  # the index as int32
    dict_n = max(0, r["dict_n"])
    dbuf, doff = buffers[r["dict_buf"]], r["dict_off"]
    if not (doff >= 0 and doff <= dbuf.shape[0] - dict_n * item):
        dict_n = 0
    in_range = (si >= 0) & (si < dict_n)
    if dict_n:
        table = dbuf[doff:doff + dict_n * item].view(dict_n, item)
        vals = table[si.clamp(0, dict_n - 1)]
        vals[~in_range] = 0
        out[at] = vals[delivered]
    else:
        out[at] = 0
    return not bool(in_range.all())


def _extract_pages_plain(k3_out, stored, pages, blocks, runs, meta, flags, out_bytes):
    """Plain version of the batched K4: torch ops a page (the reference's run-id
    ``searchsorted`` and window gather, then the dictionary gather), over the values the
    block table gives each page. Output bytes no page writes are zero."""
    import torch

    buffers = (k3_out.cpu(), stored.cpu())
    rows = pages.cpu().numpy().tolist()
    blk = blocks.cpu().numpy()
    runs_c, meta_c = runs.cpu(), meta.cpu().numpy()
    out = torch.zeros((out_bytes,), dtype=torch.uint8)
    latched = flags.cpu().clone()
    for p, row in enumerate(rows):
        firsts = blk[blk[:, 0] == p, 1].astype(np.int64)
        if not len(firsts):
            continue
        r = dict(zip(PAGE_COLS, row))
        limit = r["hi"] if r["enc"] == ENC_VALUES_PLAIN else r["num_values"]
        values = torch.from_numpy(np.concatenate([
            np.arange(f, min(f + VALUES_PER_BLOCK, limit)) for f in firsts]))
        if _extract_page_plain(buffers, r, meta_c[p], runs_c, values, out):
            latched[p] = _INDEX_RANGE
    flags.copy_(latched.to(flags.device))
    return out.to(pages.device)


def extract_pages(k3_out, stored, pages, blocks, runs, meta, flags, out_bytes):
    """K4 over every data page of a batch: ONE launch.

    The buffers and ``pages`` as for :func:`rle_scan_pages`, and its ``runs``, ``meta``
    and ``flags``; ``blocks``: (n_blocks, 2) int32 :func:`block_table`. Per value of a
    dictionary page: its run among the page's real runs, ``(word >> shift) & mask`` from a
    5-byte window clamped to the stream or the run's RLE value, the range check ``0 <=
    index < dict_n`` (a failure latches the page's flag, in place, to the "dictionary
    index out of range" code), and the dictionary value's bytes at the value's row of
    the output; per value of a PLAIN page, its item bytes. Only the delivered values
    ``[lo, hi)`` of a page are written, at ``dst``; a page whose verdict is not 0 writes
    zeros there. Returns the (out_bytes,) uint8 output.

    K4 on CUDA tensors, the plain version on CPU tensors. ``extract_pages.launches``
    counts kernel launches."""
    import torch

    _check_page_inputs("extract_pages", k3_out, stored, pages)
    n = pages.shape[0]
    out_bytes = int(out_bytes)
    for what, t, shape in (("blocks", blocks, (blocks.shape[0], 2)),
                           ("runs", runs, (runs.shape[0], 4)), ("meta", meta, (n, 4)),
                           ("flags", flags, (n,))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape or t.device != pages.device:
            raise TypeError("extract_pages takes %s as %s int32 on the pages' device, got "
                            "%s %s" % (what, shape, t.dtype, tuple(t.shape)))
    if out_bytes < 0:
        raise ValueError("extract_pages: out_bytes %d" % out_bytes)
    if pages.device.type == "cpu":
        return _extract_pages_plain(k3_out, stored, pages, blocks, runs, meta, flags,
                                    out_bytes)
    _require_cuda(pages, "extract_pages")
    from petastorm_tpu_torch.ops import kernels

    dev = pages.device
    k3_out, stored, pages, blocks, runs, meta = (
        t.contiguous() for t in (k3_out, stored, pages, blocks, runs, meta))
    if not flags.is_contiguous() or runs.data_ptr() % 16:
        raise ValueError("extract_pages: flags must be contiguous and runs 16-byte aligned")
    out = torch.empty((out_bytes,), dtype=torch.uint8, device=dev)
    if blocks.shape[0] == 0:
        return out
    rc = kernels.library().ptpu_extract_pages(
        k3_out.data_ptr(), k3_out.shape[0], stored.data_ptr(), stored.shape[0],
        pages.data_ptr(), n, blocks.data_ptr(), blocks.shape[0], runs.data_ptr(),
        runs.shape[0], meta.data_ptr(), flags.data_ptr(), out.data_ptr(), out_bytes,
        *kernels.launch_target(dev))
    kernels.check_launch("extract_pages", rc)
    extract_pages.launches += 1
    return out


extract_pages.launches = 0


# -- the one-stream entry points: thin callers of the batched scan and K4 ---------------


def _check_stream(data, name):
    import torch

    if data.dtype != torch.uint8 or data.dim() != 1:
        raise TypeError("%s takes a 1-D uint8 stream, got %s %s"
                        % (name, data.dtype, tuple(data.shape)))


def _check_width(bit_width, name):
    if not 1 <= bit_width <= _MAX_BIT_WIDTH:
        raise ValueError("%s takes bit widths 1..%d, got %d"
                         % (name, _MAX_BIT_WIDTH, bit_width))


def _stream_page(data, data_len, bit_width, total, max_runs):
    """One stream as a batch of one page: its bytes behind a bit-width byte, and the
    (1, PAGE_COLS) page table (numpy) of an index page that reads them."""
    import torch

    page = torch.cat([torch.full((1,), bit_width, dtype=torch.uint8, device=data.device),
                      data])
    row = page_row(size=page.shape[0], enc=ENC_VALUES_INDICES, num_values=total, item=4,
                   run_cap=max_runs, max_runs=max_runs, stream_len=max(0, data_len),
                   hi=total)
    return page, np.asarray([row], np.int64)


def _no_pages(dev):
    import torch

    return (torch.empty((0,), dtype=torch.uint8, device=dev),
            torch.empty((0,), dtype=torch.bool, device=dev))


def rle_run_scan(data, data_len, total, max_runs, bit_width):
    """Phase 1 of :func:`rle_expand` (sequential; runs ≪ values): parse the hybrid run
    stream ``data`` (first ``data_len`` bytes) into a bounded run table.

    Returns ``(run_end, is_packed, rle_value, bit_base, status)``: four (max_runs,) int32
    tables (unused entries: run_end INT32_MAX, the others 0) and ``status`` (2,) int32 =
    [n_runs, ok]. ``ok`` latches 0 on a run of no values, an overrun stream, more than
    ``max_runs`` runs, or fewer than ``total`` values.

    A thin caller of :func:`rle_scan_pages` over one page (the scan kernel on a CUDA
    tensor, the plain version on a CPU tensor); the padding is done in torch around it."""
    import torch

    _check_stream(data, "rle_run_scan")
    bit_width, total, max_runs = int(bit_width), int(total), int(max_runs)
    _check_width(bit_width, "rle_run_scan")
    if max_runs < 1 or total < 0:
        raise ValueError("rle_run_scan: max_runs %d, total %d" % (max_runs, total))
    page, table = _stream_page(data, int(data_len), bit_width, total, max_runs)
    stored, no_ok = _no_pages(data.device)
    runs, meta, flags = rle_scan_pages(page, stored, torch.from_numpy(table).to(data.device),
                                       no_ok, max_runs)
    written = torch.arange(max_runs, device=data.device) < meta[0, 2].clamp(max=max_runs)
    zero = torch.zeros((), dtype=torch.int32, device=data.device)
    bit_base = (runs[:, 3].long() * 8 + (1 << 31)) % (1 << 32) - (1 << 31)
    return (torch.where(written, runs[:, 0], torch.full_like(zero, _INT32_MAX)),
            torch.where(written, runs[:, 1], zero), torch.where(written, runs[:, 2], zero),
            torch.where(written, bit_base.int(), zero),
            torch.stack([meta[0, 2], (flags[0] == 0).int()]))


def rle_extract(data, run_end, is_packed, rle_value, bit_base, bit_width, total):
    """Phase 2 of :func:`rle_expand`: ``total`` int32 values of one stream from its run
    tables (:func:`rle_run_scan`; ``bit_base`` a multiple of 8, as the scan makes it) and
    its bytes ``data``.

    A thin caller of :func:`extract_pages` over one index page (K4 on CUDA tensors, the
    plain version on CPU tensors)."""
    import torch

    _check_stream(data, "rle_extract")
    bit_width, total = int(bit_width), int(total)
    _check_width(bit_width, "rle_extract")
    tables = (run_end, is_packed, rle_value, bit_base)
    max_runs = run_end.shape[0]
    for t in tables:
        if t.dtype != torch.int32 or tuple(t.shape) != (max_runs,) or t.device != data.device:
            raise TypeError("rle_extract takes four (max_runs,) int32 run tables on the "
                            "stream's device")
    if max_runs < 1:
        raise ValueError("rle_extract needs a run table")
    dev = data.device
    runs = torch.stack([run_end, is_packed, rle_value,
                        ((bit_base.long() & 0xFFFFFFFF) >> 3).int()], 1)
    rows = [page_row(size=data.shape[0], enc=ENC_VALUES_INDICES, num_values=total, item=4,
                     run_cap=max_runs, max_runs=max_runs, hi=total)]
    meta = torch.tensor([[0, bit_width, max_runs, 0]], dtype=torch.int32, device=dev)
    flags = torch.zeros((1,), dtype=torch.int32, device=dev)
    out = extract_pages(data, _no_pages(dev)[0], torch.tensor(rows, dtype=torch.int64,
                                                              device=dev),
                        torch.from_numpy(block_table(rows)).to(dev), runs, meta, flags,
                        4 * total)
    return out.view(torch.int32)


def rle_expand(data, data_len, bit_width, total):
    """RLE/bit-packed hybrid stream → ``total`` int32 values on ``data``'s device.

    ``data``: (cap,) uint8 (the values section after the bit-width byte). Returns
    ``(values (total,) int32, ok)`` with ``ok`` a 0-dim bool tensor. Width 0 gives zeros;
    a width over 32 (not Parquet) gives ``ok = False``. One batched scan and one batched
    K4 over the stream as a one-page batch; a latched stream's values are zeros."""
    import torch

    _check_stream(data, "rle_expand")
    bit_width, total = int(bit_width), int(total)
    if bit_width == 0:
        return (torch.zeros((total,), dtype=torch.int32, device=data.device),
                torch.ones((), dtype=torch.bool, device=data.device))
    if bit_width > _MAX_BIT_WIDTH:
        return (torch.zeros((total,), dtype=torch.int32, device=data.device),
                torch.zeros((), dtype=torch.bool, device=data.device))
    max_runs = max(8, total)  # worst case: 1-value RLE runs
    page, table = _stream_page(data, int(data_len), bit_width, total, max_runs)
    stored, no_ok = _no_pages(data.device)
    blocks = torch.from_numpy(block_table(table)).to(data.device)
    table = torch.from_numpy(table).to(data.device)
    runs, meta, flags = rle_scan_pages(page, stored, table, no_ok, max_runs)
    ok = flags[0] == 0
    values = extract_pages(page, stored, table, blocks, runs, meta, flags, 4 * total)
    return values.view(torch.int32), ok


def bitcast_values(raw_bytes, dtype):
    """(n*itemsize,) uint8 → (n,) ``dtype`` tensor (little-endian, as the hosts are).

    Torch has no x64 switch: INT64 gives int64 and FLOAT64 float64, the host twin's
    dtypes. A values section may start at any byte offset, so a slice whose offset is not
    a multiple of the item size is copied to a fresh (aligned) buffer first."""
    dtype = np.dtype(dtype)
    k = dtype.itemsize
    n = raw_bytes.shape[0] // k
    words = raw_bytes[:n * k]
    if words.storage_offset() % k:
        words = words.clone()
    return words.view(_torch_dtype(dtype))


# -- loader-facing orchestration -------------------------------------------------------


def _align(n):
    return -(-n // _PAGE_ALIGN) * _PAGE_ALIGN


def _pack_pages(chunk, pages):
    """Host prep of the padded entries (:func:`snappy_inflate_pages`,
    :func:`stored_pages`): the COMPRESSED page payloads zero-padded into one (n, src_cap)
    matrix + the (n, 2) page table. Returns ``(comp, meta, out_cap)``."""
    buf = np.frombuffer(chunk.buf, np.uint8)
    comp = np.zeros((len(pages), max(1, max(p.comp_size for p in pages))), np.uint8)
    meta = np.empty((len(pages), 2), np.int32)
    for i, p in enumerate(pages):
        comp[i, :p.comp_size] = buf[p.payload_offset:p.payload_offset + p.comp_size]
        meta[i] = (p.comp_size, p.uncomp_size)
    return comp, meta, max(p.uncomp_size for p in pages)


class RaggedLayout:
    """Where K3's one launch finds and puts the pages of several windows.

    ``groups``: ``(chunk, pages)`` pairs, each a window's covering pages. Their compressed
    payloads lie back to back in one source buffer, each page 16-byte aligned and with no
    padding beyond that: these bytes (plus the page table) are the H2D traffic of the
    pass-through. Group ``i`` decodes into the rows of one ``(n, out_cap)`` matrix of the
    output buffer (:meth:`matrix`), ``out_cap`` its largest uncompressed page, as the
    padded entry's ``out_cap``; its rows start 16-byte aligned."""

    def __init__(self, groups):
        self.groups = list(groups)
        rows, self.matrices = [], []
        src_off = out_off = 0
        for _chunk, pages in self.groups:
            cap = max(p.uncomp_size for p in pages)
            stride = _align(cap)
            self.matrices.append((out_off, len(pages), stride, cap))
            for p in pages:
                rows.append((src_off, p.comp_size, p.comp_size, out_off, cap))
                src_off += _align(p.comp_size)
                out_off += stride
        self.table = np.asarray(rows, np.int64).reshape(-1, PAGE_TABLE_COLS)
        self.src_bytes, self.out_bytes = src_off, out_off

    def specs(self):
        """``(shape, dtype)`` of the source buffer and the page table."""
        return [((self.src_bytes,), np.uint8), (self.table.shape, np.int64)]

    def fill(self, src, table):
        """Copy the payloads into ``src`` and the page table into ``table`` (host arrays
        of :meth:`specs`, e.g. views into a pinned slab)."""
        row = 0
        for chunk, pages in self.groups:
            buf = np.frombuffer(chunk.buf, np.uint8)
            for p in pages:
                off = int(self.table[row, 0])
                src[off:off + p.comp_size] = \
                    buf[p.payload_offset:p.payload_offset + p.comp_size]
                row += 1
        table[...] = self.table

    def matrix(self, out, i):
        """Group ``i``'s ``(n, out_cap)`` rows of K3's output ``out``."""
        off, n, stride, cap = self.matrices[i]
        return out[off:off + n * stride].view(n, stride)[:, :cap]


def pack_ragged(groups):
    """:class:`RaggedLayout` of ``groups`` with its host arrays filled: returns
    ``(layout, src, table)``, numpy arrays for :func:`snappy_inflate_ragged`."""
    layout = RaggedLayout(groups)
    (src_shape, _), (table_shape, _) = layout.specs()
    src, table = np.zeros(src_shape, np.uint8), np.empty(table_shape, np.int64)
    layout.fill(src, table)
    return layout, src, table


class StoredLayout:
    """Where the scan and K4 find the UNCOMPRESSED pages of several windows: each page's
    ``uncomp_size`` bytes back to back, 16-byte aligned, its payload truncated or
    zero-padded to them as :func:`stored_pages` does. These bytes cross the link in the
    batch's one upload. ``offsets[i][j]``: page ``j`` of group ``i``."""

    def __init__(self, groups):
        self.groups = list(groups)
        self.offsets, off = [], 0
        for _chunk, pages in self.groups:
            self.offsets.append([])
            for p in pages:
                self.offsets[-1].append(off)
                off += _align(p.uncomp_size)
        self.nbytes = off

    def fill(self, dst):
        for (chunk, pages), offs in zip(self.groups, self.offsets):
            buf = np.frombuffer(chunk.buf, np.uint8)
            for p, off in zip(pages, offs):
                n = min(p.comp_size, p.uncomp_size)
                dst[off:off + n] = buf[p.payload_offset:p.payload_offset + n]
                dst[off + n:off + p.uncomp_size] = 0


class _Window:
    """One ``(chunk, skip, take)`` window of a column and its covering pages (the
    dictionary page first when there is one); ``loc[i]`` = ``(buf, off, ok_idx)`` of page
    ``i``: where its inflated bytes lie and its row of K3's ok vector (-1: a whole stored
    page, -2: a stored page whose payload is not its uncompressed size)."""

    __slots__ = ("name", "chunk", "skip", "take", "pages", "base", "loc", "rows")

    def __init__(self, name, chunk, skip, take):
        self.name, self.chunk, self.skip, self.take = name, chunk, skip, take
        p0, p1, self.base = chunk.covering_pages(skip, take)
        self.pages = ([chunk.dict_page] if chunk.dict_page is not None else []) \
            + list(chunk.pages[p0:p1])
        self.loc = self.rows = None

    def inflated(self, k3_ok):
        """Every page of the window inflated (K3's flags, the stored pages' sizes)."""
        return all(k3_ok[i] if i >= 0 else i == -1 for _b, _o, i in self.loc)


class BatchPlan:
    """The page table, block table, run table size and output layout of one batch's
    windows (``{name: [_Window]}``, columns in order), whose ``loc`` are set: one page
    table row a data page, in column, window and page order (``w.rows`` is the window's
    slice of them). Each column's output starts 16-byte aligned in one buffer of
    ``out_bytes``; ``columns[name] = (offset, n_values, numpy dtype)``."""

    def __init__(self, windows, dtypes):
        rows, self.columns = [], {}
        run_off = out_off = 0
        for name, ws in windows.items():
            dtype = np.dtype(dtypes[name])
            item = dtype.itemsize
            out_off = _align(out_off)
            col_off, n_values = out_off, 0
            for w in ws:
                chunk = w.chunk
                first = 1 if chunk.dict_page is not None else 0
                dict_buf, dict_off, _i = w.loc[0] if first else (0, 0, 0)
                dict_n = min(chunk.dict_page.num_values, chunk.dict_page.uncomp_size // item) \
                    if first else -1
                start, row0 = w.skip - w.base, len(rows)
                s = 0  # the page's first value, counted from the window's first page
                for page, (buf, off, ok_idx) in zip(w.pages[first:], w.loc[first:]):
                    n = page.num_values
                    lo = min(n, max(0, start - s))
                    hi = max(lo, min(n, start + w.take - s))
                    plain = page.encoding == ENC_PLAIN
                    run_cap = 0 if plain else max(1, min(max(8, n), page.uncomp_size // 2 + 1))
                    rows.append(page_row(
                        buf=buf, off=off, size=page.uncomp_size, ok_idx=ok_idx,
                        max_def=chunk.max_def, enc=ENC_VALUES_PLAIN if plain
                        else ENC_VALUES_DICT, num_values=n, item=item, dict_buf=dict_buf,
                        dict_off=dict_off, dict_n=dict_n, run_off=run_off, run_cap=run_cap,
                        max_runs=max(8, n), lo=lo, hi=hi,
                        dst=out_off + (n_values + s + lo - start) * item))
                    run_off += run_cap
                    s += n
                w.rows = slice(row0, len(rows))
                n_values += w.take
            self.columns[name] = (col_off, n_values, dtype)
            out_off = col_off + n_values * item
        self.pages = np.asarray(rows, np.int64).reshape(-1, len(PAGE_COLS))
        self.blocks = block_table(self.pages)
        self.runs_total, self.out_bytes = run_off, out_off

    def specs(self):
        """``(shape, dtype)`` of the page table and the block table."""
        return [(self.pages.shape, np.int64), (self.blocks.shape, np.int32)]

    def fill(self, pages, blocks):
        pages[...] = self.pages
        blocks[...] = self.blocks


def _upload(specs, fill, device, stager):
    """Host arrays of ``specs`` (``(shape, dtype)`` pairs), filled by ``fill(views)``, on
    ``device``: through one slab of ``stager`` (one non-blocking copy) on a CUDA device,
    else numpy arrays moved with ``.to(device)``."""
    import torch

    if stager is not None and device.type == "cuda":
        views, upload = stager.reserve(specs)
        fill(views)
        return upload(device)
    views = [np.zeros(shape, dtype) for shape, dtype in specs]
    fill(views)
    return [torch.from_numpy(v).to(device) for v in views]


def _as_device(device):
    """``None`` is the CUDA device, and raises without one: the entry points run on the
    card unless the caller asks for the CPU (``device="cpu"``)."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: petastorm_tpu_torch runs on the GPU unless the caller "
                "asks for the CPU (device='cpu')")
        return torch.device("cuda")
    return torch.device(device) if not isinstance(device, torch.device) else device


def _verdict(windows, k3_ok, flags):
    """Raise :class:`DeviceInflateError` for the first rejected page, in the order the
    reference checks them: column by column, window by window, first every page's inflate
    flag, then the dictionary page's length (a host check), then each data page's
    verdict."""
    for name, ws in windows.items():
        try:
            for w in ws:
                if not w.inflated(k3_ok):
                    raise DeviceInflateError(REASONS[_INFLATE])
                dict_page = w.chunk.dict_page
                if dict_page is not None and dict_page.num_values \
                        > dict_page.uncomp_size // w.chunk.dtype.itemsize:
                    raise DeviceInflateError("dictionary page shorter than its values")
                for code in flags[w.rows]:
                    if code:
                        raise DeviceInflateError(REASONS[int(code)])
        except DeviceInflateError as e:
            e.column = name
            raise


class StagedBatch:
    """One batch's pages and tables on the device (:func:`stage_batch`): the windows by
    column, the host layouts (:class:`RaggedLayout`, :class:`StoredLayout`,
    :class:`BatchPlan`) and the uploaded arrays ``src``, ``table`` (K3's), ``stored``,
    ``pages`` and ``blocks``."""

    __slots__ = ("windows", "layout", "stored_layout", "plan", "src", "table", "stored",
                 "pages", "blocks")

    def __init__(self, **fields):
        for name, value in fields.items():
            setattr(self, name, value)

    def run(self):
        """The three launches on the current stream, K3 (when a page is snappy), the scan
        and K4: returns ``(k3_out, k3_ok, runs, meta, flags, values)``, ``values`` the
        one output buffer of every column (:attr:`BatchPlan.columns`)."""
        if self.layout.groups:
            out, ok = snappy_inflate_ragged(self.src, self.table, self.layout.out_bytes)
        else:
            out, ok = _no_pages(self.pages.device)
        runs, meta, flags = rle_scan_pages(out, self.stored, self.pages, ok,
                                           self.plan.runs_total)
        values = extract_pages(out, self.stored, self.pages, self.blocks, runs, meta, flags,
                               self.plan.out_bytes)
        return out, ok, runs, meta, flags, values


def stage_batch(columns, device, stager=None):
    """Host prep and the ONE upload of a batch's pages (:func:`inflate_columns`): returns
    a :class:`StagedBatch`, or ``None`` when no column has a row."""
    windows = {name: [_Window(name, chunk, skip, take)
                      for chunk, skip, take in column.parts if take]
               for name, column in columns.items()}
    flat = [w for ws in windows.values() for w in ws]
    if not flat:
        return None
    snappy = [w for w in flat if w.chunk.codec == "SNAPPY"]
    stored = [w for w in flat if w.chunk.codec != "SNAPPY"]
    layout = RaggedLayout([(w.chunk, w.pages) for w in snappy])
    k3_row = 0
    for i, w in enumerate(snappy):
        off, _n, stride, _cap = layout.matrices[i]
        w.loc = [(0, off + j * stride, k3_row + j) for j in range(len(w.pages))]
        k3_row += len(w.pages)
    stored_layout = StoredLayout([(w.chunk, w.pages) for w in stored])
    for w, offs in zip(stored, stored_layout.offsets):
        w.loc = [(1, off, -1 if p.comp_size == p.uncomp_size else -2)
                 for p, off in zip(w.pages, offs)]
    plan = BatchPlan(windows, {name: col.dtype for name, col in columns.items()})

    def fill(views):
        layout.fill(views[0], views[1])
        stored_layout.fill(views[2])
        plan.fill(views[3], views[4])

    arrays = _upload(layout.specs() + [((stored_layout.nbytes,), np.uint8)] + plan.specs(),
                     fill, device, stager)
    return StagedBatch(windows=windows, layout=layout, stored_layout=stored_layout,
                       plan=plan, **dict(zip(("src", "table", "stored", "pages", "blocks"),
                                             arrays)))


def inflate_columns(columns, device=None, stager=None):
    """The loader's device inflate of one batch: ``{name:``
    :class:`~petastorm_tpu_torch.io.pagedec.PassthroughColumn` ``}`` → ``{name: tensor}``
    on ``device`` (``None``: the CUDA device), each for exactly its rows, from the
    COVERING pages of each window only (plus the dictionary page when one exists).

    The pages of every window of every column cross the link in ONE upload (one slab of
    ``stager``, a :class:`~petastorm_tpu_torch.io.staging.PinnedStagingPool`, when given),
    with the batch's page table and block table (:class:`BatchPlan`): snappy pages packed
    back to back (:class:`RaggedLayout`) for ONE K3 launch (:func:`snappy_inflate_ragged`),
    UNCOMPRESSED pages as they are stored (:class:`StoredLayout`). Then ONE scan launch
    (:func:`rle_scan_pages`) and ONE K4 launch (:func:`extract_pages`) over every data
    page, which write each column's values into one output buffer. K3's ok flags and the
    pages' verdicts come back to the host in ONE read.

    Raises :class:`DeviceInflateError`, its ``column`` naming the first column (in
    ``columns`` order) with a rejected page, with the reference's message for it."""
    import torch

    device = _as_device(device)
    batch = stage_batch(columns, device, stager)
    if batch is None:
        return {name: torch.zeros((0,), dtype=_torch_dtype(np.dtype(col.dtype)),
                                  device=device) for name, col in columns.items()}
    _out, ok, _runs, _meta, flags, values = batch.run()
    HOST_READS.add()  # K3's ok flags and every data page's verdict, in one read
    both = torch.cat([ok.to(torch.int32), flags]).cpu().numpy()
    _verdict(batch.windows, both[:ok.shape[0]], both[ok.shape[0]:])
    return {name: values[off:off + n * dtype.itemsize].view(_torch_dtype(dtype))
            for name, (off, n, dtype) in batch.plan.columns.items()}


def inflate_column(column, device=None, stager=None):
    """One column's device inflate: the one-column case of :func:`inflate_columns`."""
    return inflate_columns({"column": column}, device, stager)["column"]


def inflate_window(chunk, skip, take, device=None, stager=None):
    """Rows ``[skip, skip+take)`` of one
    :class:`~petastorm_tpu_torch.io.pagedec.PassthroughChunk`, inflated on ``device``
    from the covering pages only: cutting a row group into many batches ships and decodes
    each data page at most twice (boundary pages), never the whole chunk per batch."""
    return inflate_column(PassthroughColumn([(chunk, skip, take)]), device, stager)


def inflate_chunk(chunk, device=None, stager=None):
    """All rows of one chunk (the full-range window) — test/CLI convenience."""
    return inflate_window(chunk, 0, chunk.num_rows, device, stager)
