"""Coalescing planners: merge reads whose gap is cheaper than a round trip.

Port of ``petastorm_tpu.io.coalesce`` (pure Python, no device code):

- **Row-group runs** (:func:`plan_runs`): consecutive plan items hitting row groups of
  the same file merge into ONE ``ParquetFile.read_row_groups`` ranged read, sliced back
  into per-row-group tables (zero-copy, :func:`split_run_table`). Strict adjacency, or
  non-adjacent increasing row groups that an optional ``gap_ok(prev_piece, piece)``
  predicate admits (``pf.read_row_groups([0, 2])`` concatenates in list order, so the
  slice-back is unchanged).
- **Byte ranges** (:func:`plan_byte_ranges`, :func:`slice_ranges`): column-chunk byte
  ranges whose gap is at most ``min_gap_bytes`` merge into one request, and merged
  spans longer than ``target_request_bytes`` split into parallel ones; the fetched
  chunks are cut back into the original requests, byte-identical. The object-store
  engine (:mod:`petastorm_tpu_torch.io.remote`) issues such requests.

Both planners only merge or split what is already queued together: they never reorder
or delay a read.
"""
from __future__ import annotations


def plan_runs(requests, max_run=4, gap_ok=None):
    """Group ``(piece, columns)`` read requests into coalescible runs.

    A run is a maximal set of requests sharing one file, one generation of it
    (``piece.generation``: a watched read checks the run's first piece only) and one
    column set whose row groups are strictly increasing and pairwise mergeable — adjacent
    (``rg == prev + 1``), or non-adjacent with ``gap_ok(prev_piece, piece)``
    approving the byte gap between them — capped at ``max_run`` row groups (a
    bigger merge would hold too many decoded-table bytes hostage to one read).
    Returns ``[(pieces, columns), ...]`` covering every input request exactly
    once; ``pieces`` within a run are ordered by row group. Input order is
    otherwise preserved (first-seen run order), so the readahead queue's FIFO
    eviction semantics stay intact.
    """
    runs = []
    open_runs = {}  # (path, generation, columns) -> index of the still-growing run
    for piece, columns in requests:
        key = (piece.path, getattr(piece, "generation", None), columns)
        idx = open_runs.get(key)
        if idx is not None:
            pieces, _ = runs[idx]
            if len(pieces) < max_run:
                prev = pieces[-1]
                adjacent = piece.row_group == prev.row_group + 1
                bridged = (not adjacent and gap_ok is not None
                           and piece.row_group > prev.row_group
                           and gap_ok(prev, piece))
                if adjacent or bridged:
                    pieces.append(piece)
                    continue
        # new run (first for this key, unmergeable gap, or the open run is full)
        open_runs[key] = len(runs)
        runs.append(([piece], columns))
    return runs


def plan_byte_ranges(ranges, min_gap_bytes=0, target_request_bytes=None):
    """Plan the GETs covering ``[(offset, length), ...]`` byte ranges.

    Overlapping/back-to-back ranges always merge; a gap of at most
    ``min_gap_bytes`` merges too (the wasted gap bytes cost less than a second
    round trip). Merged spans longer than ``target_request_bytes`` split into
    consecutive chunks of at most that size — the parallel GETs the engine
    issues concurrently. Returns ``[(offset, length), ...]`` sorted, disjoint,
    covering every input byte at least once.
    """
    if not ranges:
        return []
    spans = sorted((int(off), int(off) + int(ln)) for off, ln in ranges if ln > 0)
    if not spans:
        return []
    merged = [list(spans[0])]
    for start, end in spans[1:]:
        if start - merged[-1][1] <= max(0, int(min_gap_bytes)):
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    out = []
    chunk = int(target_request_bytes) if target_request_bytes else 0
    for start, end in merged:
        if chunk <= 0 or end - start <= chunk:
            out.append((start, end - start))
            continue
        pos = start
        while pos < end:
            n = min(chunk, end - pos)
            out.append((pos, n))
            pos += n
    return out


def slice_ranges(chunks, ranges):
    """Reassemble the originally requested ``ranges`` from fetched ``chunks``.

    ``chunks`` is ``[(offset, bytes-like), ...]`` (sorted or not); each
    requested ``(offset, length)`` must be fully covered by the chunks (a
    planner output always covers its input — a short GET fails loudly here,
    never silently mis-slices). Returns one ``memoryview``/``bytes`` per
    request, zero-copy when a request falls inside a single chunk.
    """
    spans = sorted((int(off), memoryview(data)) for off, data in chunks)
    out = []
    for off, ln in ranges:
        out.append(_slice_one(spans, int(off), int(ln)))
    return out


def _slice_one(spans, off, ln):
    end = off + ln
    parts = []
    for start, view in spans:
        stop = start + len(view)
        if stop <= off or start >= end:
            continue
        lo = max(off, start)
        hi = min(end, stop)
        parts.append(view[lo - start:hi - start])
    got = sum(len(p) for p in parts)
    if got != ln:
        raise ValueError(
            "ranged GETs cover %d of the %d bytes requested at offset %d"
            % (got, ln, off))
    if len(parts) == 1:
        return parts[0]
    return b"".join(bytes(p) for p in parts)


def split_run_table(table, sizes):
    """Slice a concatenated ranged-read table back into per-row-group tables.

    ``sizes`` are the per-row-group row counts (from the parquet footer
    metadata); slices are zero-copy views. Raises when the sizes don't tile the
    table — a merged read that came back short must fail loudly, not silently
    mis-assign rows to pieces.
    """
    if sum(sizes) != table.num_rows:
        raise ValueError(
            "ranged read returned %d rows but the row-group sizes sum to %d"
            % (table.num_rows, sum(sizes)))
    out = []
    offset = 0
    for size in sizes:
        out.append(table.slice(offset, size))
        offset += size
    return out
