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
- :func:`rle_expand` expands a hybrid RLE/bit-packed dictionary-index stream in two
  launches: :func:`rle_run_scan` (the run table; port of the ``lax.while_loop``
  ``_rle_run_scan``) and :func:`rle_extract`, kernel K4 (port of ``_extract_kernel``,
  with the run-id lookup and the window gather done inside the kernel). Its windows
  are 5 bytes, so it takes every bit width Parquet allows (1-32), where the reference's
  4-byte windows stop at 24.
- :func:`inflate_columns` is the loader-facing entry: one batch's
  :class:`~petastorm_tpu_torch.io.pagedec.PassthroughColumn` values → decoded tensors on
  the device, from the covering pages only, with one upload, one K3 launch and one read
  of the ok flags for all of them. :func:`inflate_column`, :func:`inflate_window` and
  :func:`inflate_chunk` are its one-column cases.

Every kernel wrapper runs its kernel on a CUDA tensor and its plain version beside it on
a CPU tensor, and nothing else; ``<wrapper>.launches`` counts kernel launches. The numpy
decoders of ``io/pagedec.py`` are the host twin: when a page's ``ok`` flag latches or a
layout check fails, the stage raises :class:`DeviceInflateError`; the caller runs the
host twin on the same pages to classify them, which raises
:class:`~petastorm_tpu_torch.errors.PagedecCorruptError` if the bytes are bad, and
raises :class:`KernelFaultError` if the twin decodes them (the device path delivers
nothing the host decoded). A kernel that fails to build or launch raises
``RuntimeError`` to the caller.

The stage reads a few values back to the host: the pages' ``ok`` flags (once a batch;
the JAX package reads them once a column window), each data page's definition-level
block length and bit width, each stream's ``ok`` flag and the dictionary index range
check. On a CUDA device each read waits for
the transfer stream; :data:`HOST_READS` counts them.
"""
from __future__ import annotations

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


def _host_int(t):
    """One scalar of a device tensor on the host (counted in :data:`HOST_READS`)."""
    HOST_READS.add()
    return int(t.item())


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


# -- RLE/bit-packed hybrid expansion ---------------------------------------------------


def _check_stream(data, name):
    import torch

    if data.dtype != torch.uint8 or data.dim() != 1:
        raise TypeError("%s takes a 1-D uint8 stream, got %s %s"
                        % (name, data.dtype, tuple(data.shape)))


def _check_width(bit_width, name):
    if not 1 <= bit_width <= _MAX_BIT_WIDTH:
        raise ValueError("%s takes bit widths 1..%d, got %d"
                         % (name, _MAX_BIT_WIDTH, bit_width))


def _rle_run_scan_plain(data, data_len, total, max_runs, bit_width):
    """Plain version of the run scan: a Python loop over the runs."""
    import torch

    buf = data.cpu().numpy().tobytes()
    cap = len(buf)

    def rd(i):
        return buf[min(max(i, 0), cap - 1)] if cap else 0

    run_end = np.full(max_runs, _INT32_MAX, np.int32)
    is_packed = np.zeros(max_runs, np.int32)
    rle_value = np.zeros(max_runs, np.int32)
    bit_base = np.zeros(max_runs, np.int32)
    byte_width = (bit_width + 7) // 8
    pos = filled = nruns = 0
    ok = True
    while filled < total and ok:
        header = shift = 0
        done = False
        while not done and ok:
            b = rd(pos)
            if shift < 32:
                header |= (b & 0x7F) << shift
            done = (b & 0x80) == 0
            ok = ok and pos < data_len and shift <= 28
            pos += 1
            shift += 7
        header = _wrap32(header)
        packed = (header & 1) == 1
        groups = header >> 1
        count = groups * 8 if packed else groups
        consumed = groups * bit_width if packed else byte_width
        v = 0
        for k in range(byte_width):
            v |= rd(pos + k) << (8 * k)
        ok = ok and pos + consumed <= data_len and count > 0 and nruns < max_runs
        idx = min(nruns, max_runs - 1)
        # a packed run's trailing values beyond `total` are spec-legal padding
        run_end[idx] = min(filled + count, total)
        is_packed[idx] = int(packed)
        rle_value[idx] = 0 if packed else _wrap32(v)
        bit_base[idx] = _wrap32(pos * 8)
        pos += consumed
        filled += count
        nruns += 1
    ok = ok and filled >= total
    status = np.array([_wrap32(nruns), int(ok)], np.int32)
    return tuple(torch.from_numpy(a).to(data.device)
                 for a in (run_end, is_packed, rle_value, bit_base, status))


def rle_run_scan(data, data_len, total, max_runs, bit_width):
    """Phase 1 of :func:`rle_expand` (sequential; runs ≪ values): parse the hybrid run
    stream ``data`` (first ``data_len`` bytes) into a bounded run table.

    Returns ``(run_end, is_packed, rle_value, bit_base, status)``: four (max_runs,) int32
    tables (unused entries: run_end INT32_MAX, the others 0) and ``status`` (2,) int32 =
    [n_runs, ok]. ``ok`` latches 0 on a run of no values, an overrun stream, more than
    ``max_runs`` runs, or fewer than ``total`` values.

    The scan kernel on a CUDA tensor, the plain version on a CPU tensor."""
    import torch

    _check_stream(data, "rle_run_scan")
    bit_width, total, max_runs = int(bit_width), int(total), int(max_runs)
    _check_width(bit_width, "rle_run_scan")
    if max_runs < 1 or total < 0:
        raise ValueError("rle_run_scan: max_runs %d, total %d" % (max_runs, total))
    if data.device.type == "cpu":
        return _rle_run_scan_plain(data, int(data_len), total, max_runs, bit_width)
    _require_cuda(data, "rle_run_scan")
    from petastorm_tpu_torch.ops import kernels

    data = data.contiguous()
    tables = torch.empty((4, max_runs), dtype=torch.int32, device=data.device)
    status = torch.empty((2,), dtype=torch.int32, device=data.device)
    rc = kernels.library().ptpu_rle_run_scan(
        data.data_ptr(), int(data_len), data.shape[0], total, max_runs, bit_width,
        tables[0].data_ptr(), tables[1].data_ptr(), tables[2].data_ptr(),
        tables[3].data_ptr(), status.data_ptr(), *kernels.launch_target(data.device))
    kernels.check_launch("rle_run_scan", rc)
    rle_run_scan.launches += 1
    return tables[0], tables[1], tables[2], tables[3], status


rle_run_scan.launches = 0


def _rle_extract_plain(data, run_end, is_packed, rle_value, bit_base, bit_width, total):
    """Plain version of K4: the reference's run-id ``searchsorted`` and window gather
    (5 bytes, each index clamped to the stream), then ``(word >> shift) & mask`` or the
    run's RLE value, in torch ops. A 32-bit value wraps to int32 as the kernel's does."""
    import torch

    dev = data.device
    max_runs = run_end.shape[0]
    cap = data.shape[0]
    i = torch.arange(total, dtype=torch.int32, device=dev)
    rid = torch.searchsorted(run_end, i, right=True).clamp(0, max_runs - 1)
    prev = run_end[(rid - 1).clamp(0, max_runs - 1)].long()
    run_start = torch.where(rid == 0, torch.zeros_like(prev), prev)
    bitpos = bit_base[rid].long() + (i.long() - run_start) * bit_width
    byte_off = bitpos >> 3
    shift = bitpos & 7
    if cap:
        gather = (byte_off[:, None] + torch.arange(5, device=dev)[None, :]).clamp(0, cap - 1)
        win = data[gather].long()
    else:
        win = torch.zeros((total, 5), dtype=torch.int64, device=dev)
    word = (win << (8 * torch.arange(5, device=dev))[None, :]).sum(1)
    packed = (word >> shift) & ((1 << bit_width) - 1)
    return torch.where(is_packed[rid] != 0, packed, rle_value[rid].long()).to(torch.int32)


def rle_extract(data, run_end, is_packed, rle_value, bit_base, bit_width, total):
    """Phase 2 of :func:`rle_expand`: ``total`` int32 values of one stream from its run
    tables (:func:`rle_run_scan`) and its bytes ``data``.

    K4 on CUDA tensors, the plain version on CPU tensors."""
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
    if data.device.type == "cpu":
        return _rle_extract_plain(data, *tables, bit_width, total)
    _require_cuda(data, "rle_extract")
    from petastorm_tpu_torch.ops import kernels

    data = data.contiguous()
    tables = [t.contiguous() for t in tables]
    out = torch.empty((total,), dtype=torch.int32, device=data.device)
    if total == 0:
        return out
    rc = kernels.library().ptpu_rle_extract(
        data.data_ptr(), data.shape[0], *(t.data_ptr() for t in tables), max_runs,
        bit_width, total, out.data_ptr(), *kernels.launch_target(data.device))
    kernels.check_launch("rle_extract", rc)
    rle_extract.launches += 1
    return out


rle_extract.launches = 0


def rle_expand(data, data_len, bit_width, total):
    """RLE/bit-packed hybrid stream → ``total`` int32 values on ``data``'s device.

    ``data``: (cap,) uint8 (the values section after the bit-width byte). Returns
    ``(values (total,) int32, ok)`` with ``ok`` a 0-dim bool tensor. Width 0 gives zeros;
    a width over 32 (not Parquet) gives ``ok = False``."""
    import torch

    bit_width, total = int(bit_width), int(total)
    if bit_width == 0:
        return (torch.zeros((total,), dtype=torch.int32, device=data.device),
                torch.ones((), dtype=torch.bool, device=data.device))
    if bit_width > _MAX_BIT_WIDTH:
        return (torch.zeros((total,), dtype=torch.int32, device=data.device),
                torch.zeros((), dtype=torch.bool, device=data.device))
    max_runs = max(8, total)  # worst case: 1-value RLE runs
    run_end, is_packed, rle_value, bit_base, status = rle_run_scan(
        data, data_len, total, max_runs, bit_width)
    values = rle_extract(data, run_end, is_packed, rle_value, bit_base, bit_width, total)
    return values, status[1] != 0


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


def _padded_specs(pages):
    src_cap = max(1, max(p.comp_size for p in pages))
    return [((len(pages), src_cap), np.uint8), ((len(pages), 2), np.int32)]


def _fill_padded(chunk, pages, comp, meta):
    buf = np.frombuffer(chunk.buf, np.uint8)
    for i, p in enumerate(pages):
        comp[i, :p.comp_size] = buf[p.payload_offset:p.payload_offset + p.comp_size]
        comp[i, p.comp_size:] = 0
        meta[i] = (p.comp_size, p.uncomp_size)


def _pack_pages(chunk, pages):
    """Host prep of the padded entries (:func:`snappy_inflate_pages`,
    :func:`stored_pages`): the COMPRESSED page payloads zero-padded into one (n, src_cap)
    matrix + the (n, 2) page table. Returns ``(comp, meta, out_cap)``."""
    comp, meta = (np.empty(shape, dtype) for shape, dtype in _padded_specs(pages))
    _fill_padded(chunk, pages, comp, meta)
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


class _Window:
    """One ``(chunk, skip, take)`` window of a column and its covering pages (the
    dictionary page first when there is one)."""

    __slots__ = ("name", "chunk", "skip", "take", "pages", "base", "raw", "flags")

    def __init__(self, name, chunk, skip, take):
        self.name, self.chunk, self.skip, self.take = name, chunk, skip, take
        p0, p1, self.base = chunk.covering_pages(skip, take)
        self.pages = ([chunk.dict_page] if chunk.dict_page is not None else []) \
            + list(chunk.pages[p0:p1])
        self.raw = self.flags = None


def _decode_window(w):
    """The window's values from its inflated pages ``w.raw`` ((n, out_cap) uint8 on the
    device): dictionary, level blocks, PLAIN or RLE_DICTIONARY values, then the rows
    ``[skip, skip + take)``."""
    import torch

    chunk, raw = w.chunk, w.raw
    pos = 0
    dict_vals = None
    if chunk.dict_page is not None:
        dict_vals = bitcast_values(raw[0, :chunk.dict_page.uncomp_size], chunk.dtype)
        if chunk.dict_page.num_values > dict_vals.shape[0]:
            raise DeviceInflateError("dictionary page shorter than its values")
        dict_vals = dict_vals[:chunk.dict_page.num_values]
        pos = 1
    outs = []
    for i, page in enumerate(w.pages[pos:]):
        body = raw[pos + i, :page.uncomp_size]
        off = 0
        if chunk.max_def:
            if page.uncomp_size < 4:
                raise DeviceInflateError("page too short for level block")
            # the level-block length is part of the page layout: 4 bytes read back to the
            # host, so the slicing below has a host offset
            HOST_READS.add()
            head = body[:4].cpu().numpy().view("<u4")[0]
            off = 4 + int(head)
            if off > page.uncomp_size:
                raise DeviceInflateError("level block past page end")
        values = body[off:]
        if page.encoding == ENC_PLAIN:
            need = page.num_values * chunk.dtype.itemsize
            if values.shape[0] < need:
                raise DeviceInflateError("PLAIN page shorter than its values")
            outs.append(bitcast_values(values[:need], chunk.dtype))
        else:  # RLE_DICTIONARY / PLAIN_DICTIONARY
            if dict_vals is None:
                raise DeviceInflateError("dictionary page missing")
            if values.shape[0] < 1:
                raise DeviceInflateError("empty dictionary-index body")
            bit_width = _host_int(values[0])
            idx, ok = rle_expand(values[1:], values.shape[0] - 1, bit_width,
                                 page.num_values)
            if not _host_int(ok):
                raise DeviceInflateError("RLE expansion latched ok=False")
            if not _host_int(((idx >= 0) & (idx < dict_vals.shape[0])).all()):
                raise DeviceInflateError("dictionary index out of range")
            outs.append(dict_vals.index_select(0, idx.long()))
    full = outs[0] if len(outs) == 1 else torch.cat(outs)
    return full[w.skip - w.base:w.skip - w.base + w.take]


def inflate_columns(columns, device=None, stager=None):
    """The loader's device inflate of one batch: ``{name:``
    :class:`~petastorm_tpu_torch.io.pagedec.PassthroughColumn` ``}`` → ``{name: tensor}``
    on ``device`` (``None``: the CUDA device), each for exactly its rows, from the
    COVERING pages of each window only (plus the dictionary page when one exists).

    The compressed pages of every window of every column cross the link in ONE upload
    (one slab of ``stager``, a
    :class:`~petastorm_tpu_torch.io.staging.PinnedStagingPool`, when given): snappy pages
    packed back to back (:class:`RaggedLayout`) for ONE K3 launch
    (:func:`snappy_inflate_ragged`), UNCOMPRESSED pages as padded matrices for
    :func:`stored_pages`. Every page's ``ok`` flag comes back to the host in ONE read.
    Then each column's dictionary, level-block and RLE steps run, column by column, on
    views of the one output buffer.

    Raises :class:`DeviceInflateError`, its ``column`` naming the column, when a page's
    ok flag latched or a layout check failed."""
    import torch

    device = _as_device(device)
    windows = {name: [_Window(name, chunk, skip, take)
                      for chunk, skip, take in column.parts if take]
               for name, column in columns.items()}
    flat = [w for ws in windows.values() for w in ws]
    snappy = [w for w in flat if w.chunk.codec == "SNAPPY"]
    stored = [w for w in flat if w.chunk.codec != "SNAPPY"]
    layout = RaggedLayout([(w.chunk, w.pages) for w in snappy])
    specs = layout.specs()
    for w in stored:
        specs += _padded_specs(w.pages)

    def fill(views):
        layout.fill(views[0], views[1])
        for k, w in enumerate(stored):
            _fill_padded(w.chunk, w.pages, views[2 + 2 * k], views[3 + 2 * k])

    arrays = _upload(specs, fill, device, stager) if flat else []
    oks = []
    n_flags = 0
    if snappy:
        out, ok = snappy_inflate_ragged(arrays[0], arrays[1], layout.out_bytes)
        oks.append(ok)
    for i, w in enumerate(snappy):
        w.raw = layout.matrix(out, i)
    for k, w in enumerate(stored):
        w.raw, ok = stored_pages(arrays[2 + 2 * k], arrays[3 + 2 * k],
                                 max(p.uncomp_size for p in w.pages))
        oks.append(ok)
    for w in snappy + stored:
        w.flags = slice(n_flags, n_flags + len(w.pages))
        n_flags += len(w.pages)
    if oks:
        HOST_READS.add()  # every page's ok flag, in one read
        flags = torch.cat(oks).cpu().numpy()
    result = {}
    for name, ws in windows.items():
        try:
            outs = []
            for w in ws:
                if not flags[w.flags].all():
                    raise DeviceInflateError("page inflate kernel latched ok=False")
                outs.append(_decode_window(w))
        except DeviceInflateError as e:
            e.column = name
            raise
        if not outs:
            result[name] = torch.zeros((0,), dtype=_torch_dtype(columns[name].dtype),
                                       device=device)
        else:
            result[name] = outs[0] if len(outs) == 1 else torch.cat(outs)
    return result


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
