"""Port vs reference: the compressed-page pass-through in petastorm_tpu_torch held against
petastorm_tpu (the JAX package; its Pallas kernels in interpret mode on the CPU) and the
numpy host twin.

Tolerance: exact everywhere. Pages, bytes, run tables, indices and decoded values are
compared byte for byte, and ``ok`` flags for equality. The CUDA kernels are held against
their plain versions by the ``gpu``-marked tests, which skip without a card."""
import inspect
import io
import os
import pickle

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from _torch_pool_helpers import _no_leaked_shm_segments  # noqa: E402,F401

from petastorm_tpu.io import pagedec as ref_pd  # noqa: E402
from petastorm_tpu.ops import pagedec_kernels as ref_pk  # noqa: E402
from petastorm_tpu_torch import make_batch_reader  # noqa: E402
from petastorm_tpu_torch.errors import PagedecCorruptError  # noqa: E402
from petastorm_tpu_torch.io import IoOptions  # noqa: E402
from petastorm_tpu_torch.io import pagedec as pd  # noqa: E402
from petastorm_tpu_torch.loader import DataLoader  # noqa: E402
from petastorm_tpu_torch.ops import pagedec_kernels as pk  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def plain_inflate(monkeypatch):
    """The loader's inflate stage on the CPU runs the kernels' plain versions."""
    monkeypatch.setenv("PTPU_PAGEDEC_DEVICE", "1")


def _write(table, compression="snappy", row_group_size=2000, **kwargs):
    buf = io.BytesIO()
    pq.write_table(table, buf, compression=compression, row_group_size=row_group_size,
                   **kwargs)
    return buf.getvalue()


def _chunk_bytes(data, md, rg, col_idx):
    start, length = pd.chunk_byte_range(md.row_group(rg).column(col_idx))
    return data[start:start + length]


def _build(mod, data, md, rg, col_idx, require_saving=False):
    """One chunk through ``mod`` (the port's or the reference's io.pagedec)."""
    el = mod.classify_chunk(md, rg, col_idx)
    assert el.eligible, el.reason
    chunk, reason = mod.build_chunk(_chunk_bytes(data, md, rg, col_idx), el,
                                    expected_values=md.row_group(rg).num_rows,
                                    require_saving=require_saving)
    assert chunk is not None, reason
    return chunk


def _simple_table(n=3000, seed=0):
    rng = np.random.default_rng(seed)
    return pa.table({
        "f": pa.array(np.repeat(rng.normal(size=max(1, n // 50)).astype(np.float32),
                                50)[:n]),
        "cat": pa.array(rng.integers(0, 11, size=n).astype(np.int64)),
        "i": pa.array(rng.integers(-1000, 1000, size=n).astype(np.int32)),
        "d": pa.array(np.repeat(np.arange(float(-(-n // 50))), 50)[:n]),
    })


def _pages(chunk):
    return ([chunk.dict_page] if chunk.dict_page is not None else []) + list(chunk.pages)


def _page_tuple(p):
    return (p.kind, p.encoding, p.def_encoding, p.num_values, p.header_offset,
            p.payload_offset, p.comp_size, p.uncomp_size)


# -- walker and classifier --------------------------------------------------------------


@pytest.mark.parametrize("codec", ["snappy", "none"])
def test_walker_and_classifier_equal_reference(codec):
    data = _write(_simple_table(), compression=codec, data_page_size=2048)
    md = pq.read_metadata(io.BytesIO(data))
    for rg in range(md.num_row_groups):
        for c in range(md.row_group(rg).num_columns):
            raw = _chunk_bytes(data, md, rg, c)
            ours = pd.walk_pages(raw, md.row_group(rg).num_rows)
            theirs = ref_pd.walk_pages(raw, md.row_group(rg).num_rows)
            assert (ours[0] is None) == (theirs[0] is None)
            if ours[0] is not None:
                assert _page_tuple(ours[0]) == _page_tuple(theirs[0])
            assert [_page_tuple(p) for p in ours[1]] == [_page_tuple(p) for p in theirs[1]]
            assert pd.classify_pages(*ours) == ref_pd.classify_pages(*theirs)
            a, b = pd.classify_chunk(md, rg, c), ref_pd.classify_chunk(md, rg, c)
            assert (a.eligible, a.reason, a.dtype, a.codec, a.max_def) \
                == (b.eligible, b.reason, b.dtype, b.codec, b.max_def)
            assert pd.chunk_byte_range(md.row_group(rg).column(c)) \
                == ref_pd.chunk_byte_range(md.row_group(rg).column(c))


@pytest.mark.parametrize("codec", ["gzip", "zstd", "none", "snappy"])
def test_classifier_gates_equal_reference(codec):
    rng = np.random.default_rng(3)
    n = 500
    vals = rng.normal(size=n).astype(np.float32)
    nulls = vals.copy().astype(object)
    nulls[7] = None
    t = pa.table({
        "ok": pa.array(vals),
        "s": pa.array(["x%d" % i for i in range(n)]),
        "nested": pa.array([{"a": int(i)} for i in range(n)]),
        "withnull": pa.array(list(nulls), type=pa.float32()),
    })
    md = pq.read_metadata(io.BytesIO(_write(t, compression=codec)))
    for c in range(md.row_group(0).num_columns):
        a, b = pd.classify_chunk(md, 0, c), ref_pd.classify_chunk(md, 0, c)
        assert (a.eligible, a.reason, a.max_def) == (b.eligible, b.reason, b.max_def)
    if codec == "zstd":
        from petastorm_tpu_torch.obs.metrics import default_registry

        assert default_registry().counter("ptpu_pagedec_codec_ineligible_columns_total",
                                          codec="zstd").value >= 1


def test_truncated_chunks_raise_the_port_error_where_the_reference_raises():
    data = _write(_simple_table())
    md = pq.read_metadata(io.BytesIO(data))
    raw = _chunk_bytes(data, md, 0, 0)
    n = md.row_group(0).num_rows
    for cut in (1, 3, len(raw) // 2, len(raw) - 1):
        with pytest.raises(ref_pd.PagedecCorruptError):
            ref_pd.walk_pages(raw[:cut], n)
        with pytest.raises(PagedecCorruptError) as e:
            pd.walk_pages(raw[:cut], n)
        assert e.value.cause == "pagedec_corrupt"
    with pytest.raises(PagedecCorruptError):
        pd.walk_pages(raw, n + 1)


def test_no_saving_gate_equal_reference():
    rng = np.random.default_rng(9)
    data = _write(pa.table({"noise": pa.array(rng.normal(size=3000).astype(np.float32))}))
    md = pq.read_metadata(io.BytesIO(data))
    raw = _chunk_bytes(data, md, 0, 0)
    ours = pd.build_chunk(raw, pd.classify_chunk(md, 0, 0), md.row_group(0).num_rows)
    theirs = ref_pd.build_chunk(raw, ref_pd.classify_chunk(md, 0, 0),
                                md.row_group(0).num_rows)
    assert ours[0] is None and theirs[0] is None and ours[1] == theirs[1]


# -- host twin ---------------------------------------------------------------------------


@pytest.mark.parametrize("codec", ["snappy", "none"])
@pytest.mark.parametrize("dict_limit", [64, 1 << 20])
def test_host_twin_equal_reference_and_pyarrow(codec, dict_limit):
    rng = np.random.default_rng((7 if codec == "snappy" else 8) * 31 + dict_limit % 97)
    for trial in range(3):
        n = int(rng.integers(1, 4000))
        t = pa.table({
            "a": pa.array(rng.integers(0, int(rng.integers(2, 5000)), size=n)
                          .astype(np.int64)),
            "b": pa.array(np.repeat(rng.normal(size=n // 7 + 1), 7)[:n].astype(np.float32)),
            "c": pa.array(rng.integers(-5, 5, size=n).astype(np.int32)),
            "d": pa.array(np.repeat(rng.normal(size=n // 3 + 1), 3)[:n]),
        })
        data = _write(t, compression=codec, row_group_size=int(rng.integers(200, 2200)),
                      data_page_size=int(rng.integers(512, 8192)),
                      dictionary_pagesize_limit=dict_limit)
        md = pq.read_metadata(io.BytesIO(data))
        table = pq.read_table(io.BytesIO(data))
        off = 0
        for rg in range(md.num_row_groups):
            nrows = md.row_group(rg).num_rows
            for c in range(md.row_group(rg).num_columns):
                ours = _build(pd, data, md, rg, c)
                theirs = _build(ref_pd, data, md, rg, c)
                got = pd.decode_chunk_numpy(ours)
                assert got.dtype == theirs.dtype
                assert got.tobytes() == ref_pd.decode_chunk_numpy(theirs).tobytes()
                want = table.column(c).to_numpy()[off:off + nrows]
                assert got.tobytes() == want.tobytes(), (trial, rg, c)
            off += nrows


def test_passthrough_column_slice_concat_pickle_and_covering_pages():
    data = _write(_simple_table(4000), row_group_size=4000, data_page_size=512)
    md = pq.read_metadata(io.BytesIO(data))
    ours, theirs = _build(pd, data, md, 0, 0), _build(ref_pd, data, md, 0, 0)
    want = ours.decode()
    assert len(ours.pages) >= 2
    for skip, take in ((0, 1), (3, 5), (ours.page_starts()[1] + 3, 5), (100, 2900)):
        assert ours.covering_pages(skip, take) == theirs.covering_pages(skip, take)
    col = pd.PassthroughColumn.from_chunk(ours)
    part = col.slice(37, 911)
    assert len(part) == 911 and part.shipped_nbytes < col.shipped_nbytes
    assert np.array_equal(part.materialize(), want[37:948])
    joined = pd.PassthroughColumn.concat([col.slice(0, 10), col.slice(10, 90)])
    assert np.array_equal(joined.materialize(), want[:100])
    again = pickle.loads(pickle.dumps(part))
    assert np.array_equal(again.materialize(), want[37:948])
    cols = {"x": col, "plain": np.arange(3)}
    out = pd.materialize_columns(cols)
    assert np.array_equal(out["x"], want) and out["plain"] is cols["plain"]
    untouched = {"plain": np.arange(4)}
    assert pd.materialize_columns(untouched) is untouched


# -- K3: snappy pages --------------------------------------------------------------------


def _small_pages(codec="snappy", n=900, col=1):
    data = _write(_simple_table(n), compression=codec, data_page_size=1024)
    md = pq.read_metadata(io.BytesIO(data))
    chunk = _build(pd, data, md, 0, col)
    return chunk, pk._pack_pages(chunk, _pages(chunk))


@pytest.mark.parametrize("col", [0, 1, 2])
def test_snappy_plain_equal_reference_kernel(col):
    chunk, (comp, meta, out_cap) = _small_pages(col=col)
    ours, ok = pk.snappy_inflate_pages(torch.from_numpy(comp), torch.from_numpy(meta),
                                       out_cap)
    theirs, their_ok = ref_pk.snappy_inflate_pages(comp, meta, out_cap, interpret=True)
    assert ok.numpy().tolist() == np.asarray(their_ok).tolist() == [True] * len(comp)
    assert ours.numpy().tobytes() == np.asarray(theirs).tobytes()


def test_snappy_crafted_literal_latches_ok_false_like_the_reference():
    comp = bytes([64]) + bytes([252, 0xFF, 0xFF, 0xFF, 0xFF]) + b"\x00" * 10
    buf = np.zeros((1, 64), np.uint8)
    buf[0, :len(comp)] = np.frombuffer(comp, np.uint8)
    meta = np.array([[len(comp), 64]], np.int32)
    ours, ok = pk.snappy_inflate_pages(torch.from_numpy(buf), torch.from_numpy(meta), 64)
    theirs, their_ok = ref_pk.snappy_inflate_pages(buf, meta, 64, interpret=True)
    assert not bool(ok[0]) and not bool(np.asarray(their_ok)[0])
    assert ours.numpy().tobytes() == np.asarray(theirs).tobytes()


def test_snappy_literal_length_that_wraps_32_bits_terminates_with_ok_false():
    """A literal of 2^31 - 1 bytes after a one-byte literal: in 32-bit sums its bound
    checks wrap and pass; the port checks in 64-bit and latches ok=False at once."""
    comp = bytes([64, 0, 7, 252, 0xFE, 0xFF, 0xFF, 0x7F]) + bytes(8)
    buf = np.zeros((1, 32), np.uint8)
    buf[0, :len(comp)] = np.frombuffer(comp, np.uint8)
    out, ok = pk.snappy_inflate_pages(torch.from_numpy(buf),
                                      torch.tensor([[len(comp), 64]], dtype=torch.int32), 64)
    assert not bool(ok[0])
    assert out[0, 0].item() == 7 and not out[0, 1:].any()


def test_snappy_bit_flips_plain_equal_reference_kernel():
    chunk, (comp, meta, out_cap) = _small_pages(n=600)
    rng = np.random.default_rng(17)
    latched = 0
    for _ in range(6):
        bad = comp.copy()
        row = int(rng.integers(0, len(bad)))
        bad[row, int(rng.integers(0, meta[row, 0]))] ^= np.uint8(1 << int(rng.integers(0, 8)))
        ours, ok = pk.snappy_inflate_pages(torch.from_numpy(bad), torch.from_numpy(meta),
                                           out_cap)
        theirs, their_ok = ref_pk.snappy_inflate_pages(bad, meta, out_cap, interpret=True)
        assert ok.numpy().tolist() == np.asarray(their_ok).tolist()
        assert ours.numpy().tobytes() == np.asarray(theirs).tobytes()
        latched += int(not bool(ok.all()))
    assert latched >= 1


def _ragged_groups(n=900, codec="snappy", cols=(0, 1, 2, 3), data_page_size=1024):
    """Each column's pages of one small store: (chunk, pages) groups for one ragged
    launch, pages of different sizes side by side."""
    data = _write(_simple_table(n), compression=codec, data_page_size=data_page_size)
    md = pq.read_metadata(io.BytesIO(data))
    return [(c, _pages(c)) for c in (_build(pd, data, md, 0, col) for col in cols)]


@pytest.mark.parametrize("col", [0, 1, 2, 3])
def test_ragged_plain_equal_reference_kernel_page_for_page(col):
    """K3's ragged entry (its plain version) against the reference's padded kernel
    (interpret mode), page for page, on every column of the test store."""
    (chunk, pages), = _ragged_groups(cols=(col,))
    layout, src, table = pk.pack_ragged([(chunk, pages)])
    out, ok = pk.snappy_inflate_ragged(torch.from_numpy(src), torch.from_numpy(table),
                                       layout.out_bytes)
    comp, meta, out_cap = pk._pack_pages(chunk, pages)
    theirs, their_ok = ref_pk.snappy_inflate_pages(comp, meta, out_cap, interpret=True)
    assert ok.numpy().tolist() == np.asarray(their_ok).tolist() == [True] * len(pages)
    assert layout.matrix(out, 0).numpy().tobytes() == np.asarray(theirs).tobytes()
    assert src.nbytes < comp.nbytes or len(pages) == 1  # no padding to the largest page


@pytest.mark.parametrize("what,comp_bytes,out_len", [
    ("literal overrun", bytes([64, 252, 0xFF, 0xFF, 0xFF, 0xFF]) + bytes(10), 64),
    ("32-bit wrap", bytes([64, 0, 7, 252, 0xFE, 0xFF, 0xFF, 0x7F]) + bytes(8), 64),
    ("copy before the output", bytes([16, 0, 7, 0x3D, 9]) + bytes(4), 16),
    ("stream shorter than its length", bytes([32, 8, 1, 2, 3]), 32),
])
def test_ragged_crafted_pages_latch_ok_false_like_the_reference(what, comp_bytes, out_len):
    """Crafted corrupt pages between two good ones in one ragged launch latch ok=False,
    and their bytes equal the reference's (the 32-bit wrap, on which the reference would
    loop 2^31 times, ends with ok=False and only the first literal's byte)."""
    (chunk, pages), = _ragged_groups(cols=(2,))
    good_src = np.frombuffer(chunk.buf, np.uint8)[
        pages[0].payload_offset:pages[0].payload_offset + pages[0].comp_size]
    cap = max(out_len, pages[0].uncomp_size)
    spans = [good_src, np.frombuffer(comp_bytes, np.uint8), good_src]
    src = np.zeros(sum(-(-len(a) // 16) * 16 for a in spans), np.uint8)
    table, off = [], 0
    for i, a in enumerate(spans):
        src[off:off + len(a)] = a
        table.append((off, len(a), len(a), i * cap, cap))
        off += -(-len(a) // 16) * 16
    out, ok = pk.snappy_inflate_ragged(torch.from_numpy(src),
                                       torch.tensor(table, dtype=torch.int64), 3 * cap)
    assert ok.tolist() == [True, False, True], what
    row = out[cap:2 * cap].numpy()
    if what == "32-bit wrap":
        assert row[0] == 7 and not row[1:].any()
    else:
        buf = np.zeros((1, 64), np.uint8)
        buf[0, :len(comp_bytes)] = np.frombuffer(comp_bytes, np.uint8)
        theirs, their_ok = ref_pk.snappy_inflate_pages(
            buf, np.array([[len(comp_bytes), out_len]], np.int32), cap, interpret=True)
        assert not bool(np.asarray(their_ok)[0])
        assert row.tobytes() == np.asarray(theirs)[0].tobytes()
    assert out[:cap].numpy().tobytes() == out[2 * cap:].numpy().tobytes()


def test_page_table_pages_of_different_sizes_share_one_slab():
    """Every column's pages (dictionary and data pages of four sizes and dtypes) in one
    source buffer and one launch: each page equals the padded entry's row, the bytes
    between spans are untouched, and an output span shorter than the page latches it."""
    groups = _ragged_groups(n=2600, data_page_size=2048)
    layout, src, table = pk.pack_ragged(groups)
    sizes = {int(r[1]) for r in table}
    assert len(groups) == 4 and len(sizes) > 4
    assert (table[:, 0] % 16 == 0).all() and (table[:, 3] % 16 == 0).all()
    out, ok = pk.snappy_inflate_ragged(torch.from_numpy(src), torch.from_numpy(table),
                                       layout.out_bytes)
    assert ok.all()
    covered = np.zeros(layout.out_bytes, bool)
    for i, (chunk, pages) in enumerate(groups):
        comp, meta, out_cap = pk._pack_pages(chunk, pages)
        want, _ok = pk.snappy_inflate_pages(torch.from_numpy(comp), torch.from_numpy(meta),
                                            out_cap)
        assert torch.equal(layout.matrix(out, i), want)
    for src_off, src_len, comp_len, dst_off, cap in table.tolist():
        covered[dst_off:dst_off + cap] = True
    assert not out.numpy()[~covered].any()
    short = table.copy()
    short[-1, 4] = int(groups[-1][1][-1].uncomp_size) - 1
    _out, ok = pk.snappy_inflate_ragged(torch.from_numpy(src), torch.from_numpy(short),
                                        layout.out_bytes)
    assert ok.tolist() == [True] * (len(table) - 1) + [False]
    bad = table.copy()
    bad[0, 0] = len(src)  # a span past the source buffer: latched, nothing written
    out, ok = pk.snappy_inflate_ragged(torch.from_numpy(src), torch.from_numpy(bad),
                                       layout.out_bytes)
    assert not ok[0] and ok[1:].all() and not out[:int(table[0, 4])].any()


def test_stored_pages_equal_reference():
    chunk, (comp, meta, out_cap) = _small_pages(codec="none")
    ours, ok = pk.stored_pages(torch.from_numpy(comp), torch.from_numpy(meta), out_cap)
    theirs, their_ok = ref_pk.stored_pages(comp, meta, out_cap)
    assert ok.numpy().tolist() == np.asarray(their_ok).tolist()
    assert ours.numpy().tobytes() == np.asarray(theirs).tobytes()


# -- run scan and K4 ---------------------------------------------------------------------


def _hybrid_stream(rng, bw, high=None):
    """An RLE run, bit-packed groups and another RLE run, as the Parquet writer emits;
    values below ``high`` (default ``2**bw``)."""
    high = 1 << bw if high is None else high
    vals, out = [], bytearray()
    for kind in ("rle", "packed", "rle"):
        if kind == "rle":
            run, v = int(rng.integers(1, 40)), int(rng.integers(0, high))
            out += bytes([run << 1]) + v.to_bytes((bw + 7) // 8, "little")
            vals += [v] * run
        else:
            groups = int(rng.integers(1, 5))
            packed = rng.integers(0, high, size=groups * 8)
            bits = np.unpackbits(packed.astype("<u4").view(np.uint8).reshape(-1, 4),
                                 bitorder="little", axis=1)[:, :bw].ravel()
            out += bytes([(groups << 1) | 1]) + np.packbits(bits, bitorder="little").tobytes()
            vals += [int(x) for x in packed]
    return bytes(out), vals


@pytest.mark.parametrize("bw", [1, 5, 12, 24])
def test_run_scan_and_extract_equal_reference(bw):
    rng = np.random.default_rng(23 + bw)
    stream, vals = _hybrid_stream(rng, bw)
    data = np.frombuffer(stream, np.uint8)
    total = len(vals) - 3  # the last run ends past `total`: legal padding
    max_runs = max(8, total)
    ours = pk.rle_run_scan(torch.from_numpy(data.copy()), len(data), total, max_runs, bw)
    theirs = ref_pk._rle_run_scan(jnp.asarray(data), len(data), total, max_runs, bw)
    for a, b in zip(ours[:4], theirs[:4]):
        assert a.numpy().tolist() == np.asarray(b).tolist()
    assert ours[4].numpy().tolist() == [int(theirs[4]), int(bool(theirs[5]))] == [3, 1]
    got, ok = pk.rle_expand(torch.from_numpy(data.copy()), len(data), bw, total)
    want, their_ok = ref_pk.rle_expand(data, len(data), bw, total, interpret=True)
    assert bool(ok) and bool(their_ok)
    assert got.numpy().tolist() == np.asarray(want).tolist() == vals[:total]
    assert got.numpy().tolist() == pd.rle_bp_decode(stream, bw, total).tolist()


@pytest.mark.parametrize("cut", [1, 2, 5])
def test_run_scan_on_a_cut_stream_equals_reference(cut):
    rng = np.random.default_rng(41)
    stream, vals = _hybrid_stream(rng, 9)
    data = np.frombuffer(stream[:-cut], np.uint8)
    ours = pk.rle_run_scan(torch.from_numpy(data.copy()), len(data), len(vals), len(vals), 9)
    theirs = ref_pk._rle_run_scan(jnp.asarray(data), len(data), len(vals), len(vals),
                                  9)
    for a, b in zip(ours[:4], theirs[:4]):
        assert a.numpy().tolist() == np.asarray(b).tolist()
    assert ours[4].numpy().tolist() == [int(theirs[4]), int(bool(theirs[5]))]
    assert ours[4][1].item() == 0


def test_run_scan_header_whose_byte_count_overflows_32_bits_latches_ok_false():
    """A bit-packed run of 2^27 groups at width 16 claims 2^31 bytes: the port's 64-bit
    overrun check latches ok=False, as the host twin rejects the stream."""
    header = ((1 << 27) << 1) | 1
    varint = bytearray()
    while True:
        b, header = header & 0x7F, header >> 7
        varint.append(b | (0x80 if header else 0))
        if not header:
            break
    stream = bytes(varint) + bytes(range(1, 17))
    with pytest.raises(PagedecCorruptError):
        pd.rle_bp_decode(stream, 16, 8)
    _vals, ok = pk.rle_expand(torch.tensor(list(stream), dtype=torch.uint8), len(stream),
                              16, 8)
    assert not bool(ok)


def test_rle_expand_widths_outside_the_kernel():
    """Width 0 is all zeros; a width over 32 is not Parquet: ok=False, as the host twin
    rejects it."""
    data = torch.zeros(4, dtype=torch.uint8)
    vals, ok = pk.rle_expand(data, 4, 0, 5)
    assert bool(ok) and vals.tolist() == [0] * 5
    vals, ok = pk.rle_expand(data, 4, 33, 5)
    assert not bool(ok)
    with pytest.raises(PagedecCorruptError):
        pd.rle_bp_decode(bytes(4), 33, 5)
    with pytest.raises(ValueError):
        pk.rle_run_scan(data, 4, 5, 8, 33)


@pytest.mark.parametrize("bw", [25, 31, 32])
def test_run_scan_and_extract_wide_widths_equal_host_twin(bw):
    """Widths 25-32, where the reference's 4-byte windows stop: the 5-byte window
    decodes them as the host twin does (32-bit values wrap to int32)."""
    rng = np.random.default_rng(61 + bw)
    stream, vals = _hybrid_stream(rng, bw)
    total = len(vals) - 3
    got, ok = pk.rle_expand(torch.tensor(list(stream), dtype=torch.uint8), len(stream), bw,
                            total)
    assert bool(ok)
    twin = pd.rle_bp_decode(stream, bw, total)
    assert got.numpy().view(np.uint32).tolist() == twin.astype(np.uint32).tolist() \
        == vals[:total]


# -- the batched scan and K4 -------------------------------------------------------------


def _varint(v):
    out = bytearray()
    while True:
        b, v = v & 0x7F, v >> 7
        out.append(b | (0x80 if v else 0))
        if not v:
            return bytes(out)


def _level_block(n):
    """A v1 data page's definition-level block: every one of ``n`` values present."""
    levels = _varint(n << 1) + b"\x01"
    return len(levels).to_bytes(4, "little") + levels


def _mixed_columns(codec):
    """{name: PassthroughColumn} of one batch over two stores: a one-value dictionary
    (pyarrow writes its indices at width 1; width 0 is in the hand-made batch below), and
    dictionary widths 1, 9, 11 and 15-17, PLAIN pages, nullable and non-nullable columns,
    int32/int64/float32/float64, windows cut across row groups (rows [37, 5037) of 6,000
    in row groups of 3,000) and one 70,000-row chunk read whole."""
    rng = np.random.default_rng(77)
    n = 6000
    table = pa.table({
        "w0": pa.array(np.full(n, 7, np.int32)),
        "w1": pa.array(rng.integers(0, 2, n).astype(np.int64)),
        "w9": pa.array(rng.integers(0, 300, n).astype(np.int32)),
        "w12": pa.array(rng.integers(0, 3000, n).astype(np.float32)),
        "plain_f": pa.array(rng.normal(size=n)),
        "plain_i": pa.array(rng.integers(0, 1 << 30, n).astype(np.int32)),
    }, schema=pa.schema([
        pa.field("w0", pa.int32(), nullable=False), pa.field("w1", pa.int64()),
        pa.field("w9", pa.int32(), nullable=False), pa.field("w12", pa.float32()),
        pa.field("plain_f", pa.float64(), nullable=False), pa.field("plain_i", pa.int32())]))
    data = _write(table, compression=codec, row_group_size=3000, data_page_size=4096,
                  use_dictionary=["w0", "w1", "w9", "w12"])
    md = pq.read_metadata(io.BytesIO(data))
    cols = {}
    for c, name in enumerate(table.column_names):
        whole = pd.PassthroughColumn.concat([pd.PassthroughColumn.from_chunk(
            _build(pd, data, md, rg, c)) for rg in range(md.num_row_groups)])
        cols[name] = whole.slice(37, 5000)
    wide = pa.table({"w17": pa.array(rng.permutation(70000).astype(np.int32))})
    data = _write(wide, compression=codec, row_group_size=70000)
    md = pq.read_metadata(io.BytesIO(data))
    cols["w17"] = pd.PassthroughColumn.from_chunk(_build(pd, data, md, 0, 0))
    return cols


def _page_bytes(batch, out, row):
    r = dict(zip(pk.PAGE_COLS, row))
    buf = (out, batch.stored)[r["buf"]]
    return r, buf[r["off"]:r["off"] + r["size"]]


@pytest.mark.parametrize("codec", ["snappy", "none"])
def test_batched_plain_versions_equal_reference_and_host_twin_on_a_mixed_batch(codec):
    """The plain versions of the batched scan and K4 over a batch of mixed columns, page
    for page: the real run entries equal the reference's ``_rle_run_scan``, the indices
    its ``rle_expand`` (interpret mode) and the host twin's ``rle_bp_decode``, and each
    column equals ``PassthroughColumn.materialize``."""
    cols = _mixed_columns(codec)
    batch = pk.stage_batch(cols, CPU)
    out, ok, runs, meta, flags, values = batch.run()
    assert ok.all() and not flags.any()
    column_of = {p: name for name, ws in batch.windows.items() for w in ws
                 for p in range(w.rows.start, w.rows.stop)}
    widths, kinds = set(), set()
    for p, row in enumerate(batch.plan.pages.tolist()):
        r, page = _page_bytes(batch, out, row)
        m = meta[p].tolist()
        kinds.add((r["enc"], r["max_def"], r["item"]))
        if r["enc"] == pk.ENC_VALUES_PLAIN:
            continue
        stream, bw, n = page[m[0]:].numpy(), m[1], r["num_values"]
        widths.add(bw)
        idx = pd.rle_bp_decode(stream.tobytes(), bw, n)
        if bw:
            theirs = ref_pk._rle_run_scan(jnp.asarray(stream), len(stream), n, max(8, n), bw)
            assert m[2] == int(theirs[4]) and bool(theirs[5])
            ours = runs[r["run_off"]:r["run_off"] + m[2]]
            assert ours[:, 0].tolist() == np.asarray(theirs[0])[:m[2]].tolist()
            assert ours[:, 1].tolist() == np.asarray(theirs[1])[:m[2]].tolist()
            assert ours[:, 2].tolist() == np.asarray(theirs[2])[:m[2]].tolist()
            assert (ours[:, 3] * 8).tolist() == np.asarray(theirs[3])[:m[2]].tolist()
            want, their_ok = ref_pk.rle_expand(stream, len(stream), bw, n, interpret=True)
            assert bool(their_ok) and np.asarray(want).tolist() == idx.tolist()
        dtype = batch.plan.columns[column_of[p]][2]
        d = (out, batch.stored)[r["dict_buf"]][r["dict_off"]:r["dict_off"]
                                               + r["dict_n"] * r["item"]].numpy().view(dtype)
        got = values[r["dst"]:r["dst"] + (r["hi"] - r["lo"]) * r["item"]].numpy().view(dtype)
        assert got.tobytes() == d[idx[r["lo"]:r["hi"]]].tobytes()
    assert {1, 9, 11, 17} <= widths
    assert {(pk.ENC_VALUES_PLAIN, 0, 8), (pk.ENC_VALUES_PLAIN, 1, 4),
            (pk.ENC_VALUES_DICT, 0, 4), (pk.ENC_VALUES_DICT, 1, 8)} <= kinds
    got = pk.inflate_columns(cols, CPU)
    for name, col in cols.items():
        twin = col.materialize()
        assert got[name].numpy().dtype == twin.dtype
        assert got[name].numpy().tobytes() == twin.tobytes(), name


def _hand_batch(specs, rng):
    """A batch of hand-made dictionary pages in one stored buffer: ``specs`` rows
    ``(bit_width, n, max_def, lo, hi)``, each page's stream a random one of indices below
    a 50-value int32 dictionary, or ``(..., stream, max_runs)``. Returns ``(stored, pages,
    dictionary, streams, runs_total, out_bytes)``."""
    dictionary = rng.integers(-1 << 31, 1 << 31, 50).astype("<i4")
    buf = bytearray(dictionary.tobytes())
    rows, streams, run_off, dst = [], [], 0, 0
    for bw, n, max_def, lo, hi, *given in specs:
        buf += bytes(-len(buf) % 16)
        if given:
            stream = given[0]
        elif bw:
            stream, vals = _hybrid_stream(rng, bw, high=50)
            while len(vals) < n:
                more, extra = _hybrid_stream(rng, bw, high=50)
                stream, vals = stream + more, vals + extra
        else:
            stream = b""
        body = (_level_block(n) if max_def else b"") + bytes([bw]) + stream
        rows.append(pk.page_row(buf=1, off=len(buf), size=len(body), max_def=max_def,
                                enc=pk.ENC_VALUES_DICT, num_values=n, item=4, dict_buf=1,
                                dict_n=50, run_off=run_off, run_cap=len(body) // 2 + 1,
                                max_runs=given[1] if given else max(8, n), lo=lo, hi=hi,
                                dst=dst))
        streams.append(stream)
        buf += body
        run_off += len(body) // 2 + 1
        dst += 4 * (hi - lo)
    return (torch.from_numpy(np.frombuffer(bytes(buf), np.uint8).copy()),
            torch.tensor(rows, dtype=torch.int64), dictionary, streams, run_off, dst)


def test_batched_plain_versions_take_every_width_on_hand_made_pages():
    """Widths 0, 1, 9, 17, 24, 25 and 32 side by side in one batch (wide widths with
    indices below the dictionary's size, as a writer may emit): the run entries equal the
    reference's scan, the delivered values the dictionary at the host twin's indices
    (and at the reference's ``rle_expand`` indices up to its 24-bit limit)."""
    rng = np.random.default_rng(5)
    specs = [(0, 40, 0, 0, 40), (1, 300, 1, 10, 290), (9, 70, 0, 0, 70),
             (17, 1000, 1, 999, 1000), (24, 64, 0, 3, 60), (25, 90, 1, 0, 90),
             (32, 2100, 0, 0, 2100)]
    stored, pages, dictionary, streams, runs_total, out_bytes = _hand_batch(specs, rng)
    empty = torch.empty(0, dtype=torch.uint8)
    runs, meta, flags = pk.rle_scan_pages(empty, stored, pages, torch.empty(0, dtype=torch.bool),
                                          runs_total)
    assert not flags.any()
    blocks = torch.from_numpy(pk.block_table(pages.numpy()))
    out = pk.extract_pages(empty, stored, pages, blocks, runs, meta, flags, out_bytes)
    assert not flags.any()
    got = out.numpy().view("<i4")
    at = 0
    for (bw, n, _md, lo, hi), stream, m, row in zip(specs, streams, meta.tolist(),
                                                    pages.tolist()):
        idx = pd.rle_bp_decode(stream, bw, n)
        assert got[at:at + hi - lo].tolist() == dictionary[idx[lo:hi]].tolist(), bw
        at += hi - lo
        if not bw:
            continue
        data = np.frombuffer(stream, np.uint8)
        theirs = ref_pk._rle_run_scan(jnp.asarray(data), len(data), n, max(8, n), bw)
        r = dict(zip(pk.PAGE_COLS, row))
        ours = runs[r["run_off"]:r["run_off"] + m[2]]
        assert m[2] == int(theirs[4]) and bool(theirs[5])
        for k in range(3):
            assert ours[:, k].tolist() == np.asarray(theirs[k])[:m[2]].tolist()
        if bw <= 24:
            want, _ok = ref_pk.rle_expand(data, len(data), bw, n, interpret=True)
            assert np.asarray(want).tolist() == idx.tolist()


def test_batched_scan_latches_more_runs_than_max_runs():
    """A page of six one-value RLE runs under a table row whose ``max_runs`` is 4
    latches "RLE expansion latched ok=False", as the reference's scan latches ok=False;
    its neighbours decode."""
    rng = np.random.default_rng(8)
    stream = b"".join(bytes([2, v]) for v in range(6))
    stored, pages, _d, _s, runs_total, _ob = _hand_batch(
        [(9, 30, 0, 0, 30), (3, 6, 0, 0, 6, stream, 4), (9, 30, 1, 0, 30)], rng)
    body = bytes([3]) + stream
    runs, meta, flags = pk.rle_scan_pages(torch.empty(0, dtype=torch.uint8), stored, pages,
                                          torch.empty(0, dtype=torch.bool), runs_total)
    theirs = ref_pk._rle_run_scan(jnp.asarray(np.frombuffer(body[1:], np.uint8)),
                                  len(body) - 1, 6, 4, 3)
    assert not bool(theirs[5]) and int(theirs[4]) == meta[1, 2].item() == 5
    assert flags.tolist() == [0, 7, 0] and pk.REASONS[7] == "RLE expansion latched ok=False"


def test_batched_plain_versions_write_nothing_outside_the_run_table():
    """A table row whose run entries start before the run table (``run_off`` < 0): the
    scan writes none of its entries, not even at the table's end, and K4 writes zeros for
    its values; its neighbours decode as alone."""
    rng = np.random.default_rng(9)
    stored, pages, dictionary, streams, runs_total, out_bytes = _hand_batch(
        [(9, 30, 0, 0, 30), (9, 30, 1, 0, 30), (9, 30, 0, 0, 30)], rng)
    empty, no_ok = torch.empty(0, dtype=torch.uint8), torch.empty(0, dtype=torch.bool)
    blocks = torch.from_numpy(pk.block_table(pages.numpy()))
    runs, meta, flags = pk.rle_scan_pages(empty, stored, pages, no_ok, runs_total)
    want = pk.extract_pages(empty, stored, pages, blocks, runs, meta, flags, out_bytes)
    moved = pages.clone()
    moved[1, pk.PAGE_COLS.index("run_off")] = -3
    m_runs, m_meta, m_flags = pk.rle_scan_pages(empty, stored, moved, no_ok, runs_total)
    own = slice(int(pages[1, pk.PAGE_COLS.index("run_off")]),
                int(pages[2, pk.PAGE_COLS.index("run_off")]))
    assert not m_runs[own].any() and torch.equal(m_runs[-3:], runs[-3:])
    assert torch.equal(m_meta, meta) and m_flags.tolist() == flags.tolist() == [0, 0, 0]
    got = pk.extract_pages(empty, stored, moved, blocks, m_runs, m_meta, m_flags, out_bytes)
    assert not got[120:240].any() and got[120:240].numel() == 120
    assert torch.equal(got[:120], want[:120]) and torch.equal(got[240:], want[240:])
    assert want[120:240].view(torch.int32).tolist() == dictionary[
        pd.rle_bp_decode(streams[1], 9, 30)].tolist()


_CRAFTED = [
    # (case, max_def, page body after the level block, dictionary size, reason)
    ("run of no values", 0, bytes([2, 0x00, 1]), 3, 7),
    ("overrun stream", 1, bytes([2, 0x09, 0xAB, 0xCD]), 3, 7),
    ("short stream", 0, bytes([2, 6, 1]), 3, 7),
    ("2^27-group header", 1, bytes([16]) + _varint(((1 << 27) << 1) | 1)
     + bytes(range(1, 17)), 3, 7),
    ("width 33", 0, bytes([33, 20, 1, 0, 0, 0, 0]), 3, 7),
    ("out-of-range index", 1, bytes([3, 20, 5]), 3, 8),
    ("level block past page end", 1, None, 3, 3),
    ("empty index body", 1, b"", 3, 6),
]


def _crafted_chunk(mod, dictionary, max_def, bodies, num_values=10):
    """A stored (UNCOMPRESSED) chunk of hand-made pages in ``mod`` (the port's or the
    reference's io.pagedec): an int32 dictionary page, then one data page a body; a body
    of ``None`` is a level block whose length runs past its page."""
    buf, pages = bytearray(), []

    def add(kind, enc, n, raw):
        pages.append(mod.PageInfo(kind, enc, None if kind == mod.PAGE_DICT else mod.ENC_RLE,
                                  n, len(buf), len(buf), len(raw), len(raw)))
        buf.extend(raw)

    add(mod.PAGE_DICT, mod.ENC_PLAIN, len(dictionary), dictionary.astype("<i4").tobytes())
    for body in bodies:
        if body is None:
            raw = (1000).to_bytes(4, "little") + bytes(8)
        else:
            raw = (_level_block(num_values) if max_def else b"") + body
        add(mod.PAGE_DATA, mod.ENC_RLE_DICT, num_values, raw)
    return mod.PassthroughChunk(bytes(buf), "UNCOMPRESSED", np.int32, max_def, pages[0],
                                pages[1:])


@pytest.mark.parametrize("case,max_def,body,dict_n,reason", _CRAFTED,
                         ids=[c[0] for c in _CRAFTED])
def test_crafted_streams_latch_their_page_and_name_their_column(case, max_def, body, dict_n,
                                                                reason):
    """A crafted page among a batch's real columns: its page's flag, alone, latches the
    expected reason; the other columns' values equal the host twin; the batch raises
    DeviceInflateError naming the column with the reference's message, and the host twin
    rejects the page too."""
    dictionary = np.array([11, 22, 33][:dict_n], np.int32)
    good = (bytes([2]) + bytes([20, 1]))  # 10 values of index 1
    chunk = _crafted_chunk(pd, dictionary, max_def, [good, body, good])
    cols = _batch_columns(codecs=("snappy", "none"))
    names = sorted(cols)
    cols = {**{k: cols[k] for k in names[:3]}, "bad": pd.PassthroughColumn.from_chunk(chunk),
            **{k: cols[k] for k in names[3:]}}
    batch = pk.stage_batch(cols, CPU)
    _out, ok, _runs, _meta, flags, values = batch.run()
    bad_rows = batch.windows["bad"][0].rows
    assert ok.all()
    assert flags.tolist() == [reason if i == bad_rows.start + 1 else 0
                              for i in range(len(flags))]
    for name, (off, n, dtype) in batch.plan.columns.items():
        if name != "bad":
            assert values[off:off + n * dtype.itemsize].numpy().tobytes() \
                == cols[name].materialize().tobytes(), name
    with pytest.raises(pk.DeviceInflateError) as err:
        pk.inflate_columns(cols, CPU)
    assert err.value.column == "bad" and str(err.value) == pk.REASONS[reason]
    with pytest.raises(PagedecCorruptError):
        cols["bad"].materialize()
    if case != "2^27-group header":  # the reference's int32 byte count wraps and passes
        ref_chunk = _crafted_chunk(ref_pd, dictionary, max_def, [good, body, good])
        with pytest.raises(ref_pk.DeviceInflateError, match=pk.REASONS[reason]
                           .replace("(", r"\(").replace(")", r"\)")):
            ref_pk.inflate_chunk(ref_chunk, interpret=True)


def test_the_first_rejected_column_in_order_is_named():
    """Two columns with rejected pages: the error names the first in ``columns`` order,
    whatever their pages' order in the batch's tables."""
    dictionary = np.array([11, 22, 33], np.int32)
    good = bytes([2, 20, 1])
    late = _crafted_chunk(pd, dictionary, 1, [good, good, None])
    early = _crafted_chunk(pd, dictionary, 0, [bytes([3, 20, 5]), good])
    for order in (("a", "b"), ("b", "a")):
        cols = {order[0]: pd.PassthroughColumn.from_chunk(late),
                order[1]: pd.PassthroughColumn.from_chunk(early)}
        with pytest.raises(pk.DeviceInflateError) as err:
            pk.inflate_columns(cols, CPU)
        assert err.value.column == order[0]
        assert str(err.value) == "level block past page end"


def test_block_table_covers_dictionary_pages_whole_and_plain_pages_delivered():
    rows = [pk.page_row(enc=pk.ENC_VALUES_DICT, num_values=2500, lo=100, hi=200),
            pk.page_row(enc=pk.ENC_VALUES_PLAIN, num_values=5000, lo=1000, hi=3100),
            pk.page_row(enc=pk.ENC_VALUES_PLAIN, num_values=50, lo=7, hi=7)]
    assert pk.block_table(rows).tolist() == [[0, 0], [0, 1024], [0, 2048], [1, 1000],
                                             [1, 2024], [1, 3048]]


# -- inflate stage -----------------------------------------------------------------------


def _batch_columns(codecs=("snappy",), n=4000, row_group_size=2000, skip=37, take=2900):
    """{name: PassthroughColumn} of one batch: every column of ``_simple_table`` (per
    codec), cut across two row groups."""
    cols = {}
    for codec in codecs:
        data = _write(_simple_table(n, seed=5), compression=codec,
                      row_group_size=row_group_size, data_page_size=4096)
        md = pq.read_metadata(io.BytesIO(data))
        for c in range(md.row_group(0).num_columns):
            whole = pd.PassthroughColumn.concat([
                pd.PassthroughColumn.from_chunk(_build(pd, data, md, rg, c))
                for rg in range(md.num_row_groups)])
            cols["%s_%d" % (codec, c)] = whole.slice(skip, take)
    return cols


def test_batch_inflate_equals_inflate_column_and_host_twin():
    """One inflate over all of a batch's columns (snappy and uncompressed chunks side by
    side) equals each column inflated alone and the host twin, byte for byte."""
    cols = _batch_columns(codecs=("snappy", "none"))
    got = pk.inflate_columns(cols, CPU)
    assert sorted(got) == sorted(cols)
    for name, col in cols.items():
        alone = pk.inflate_column(col, CPU)
        twin = col.materialize()
        assert got[name].dtype == alone.dtype and got[name].numpy().dtype == twin.dtype
        assert got[name].numpy().tobytes() == alone.numpy().tobytes() == twin.tobytes(), \
            name


def test_host_reads_one_ok_read_for_a_batch_of_columns():
    """Every K3 page's ok flag and every data page's verdict (level block, bit width,
    stream, index range) of a batch of several columns come back in ONE read."""
    cols = _batch_columns()
    nullable_dict_pages = sum(
        1 for col in cols.values() for chunk, skip, take in col.parts
        for page in chunk.pages[slice(*chunk.covering_pages(skip, take)[:2])]
        if chunk.max_def and page.encoding != pd.ENC_PLAIN)
    assert len(cols) >= 4 and sum(len(c.parts) for c in cols.values()) >= 8
    assert nullable_dict_pages >= 4  # each made 4 reads of its own before
    before = pk.HOST_READS.value
    pk.inflate_columns(cols, CPU)
    assert pk.HOST_READS.value - before == 1


def test_batch_inflate_names_the_column_whose_pages_latched():
    cols = _batch_columns()
    name = sorted(cols)[2]
    chunk, skip, take = cols[name].parts[0]
    raw = bytearray(chunk.buf)
    raw[chunk.pages[0].payload_offset] ^= 0x80  # the varint preamble: the page latches
    bad = pd.PassthroughChunk(bytes(raw), chunk.codec, chunk.dtype, chunk.max_def,
                              chunk.dict_page, chunk.pages)
    cols[name] = pd.PassthroughColumn([(bad, skip, take)] + cols[name].parts[1:])
    with pytest.raises(pk.DeviceInflateError) as err:
        pk.inflate_columns(cols, CPU)
    assert err.value.column == name


def test_inflate_window_equal_reference_kernel_and_host_twin():
    data = _write(_simple_table(2600), data_page_size=2048)
    md = pq.read_metadata(io.BytesIO(data))
    ours, theirs = _build(pd, data, md, 0, 1), _build(ref_pd, data, md, 0, 1)
    got = pk.inflate_column(pd.PassthroughColumn.from_chunk(ours).slice(37, 911), CPU)
    want = ref_pk.inflate_column(ref_pd.PassthroughColumn.from_chunk(theirs).slice(37, 911),
                                 interpret=True)
    twin = ours.decode_window(37, 911)
    assert got.dtype == torch.int64 and twin.dtype == np.int64
    # the reference on x64-off jax delivers the int32 low word of each int64
    assert np.array_equal(got.numpy().astype(np.asarray(want).dtype), np.asarray(want))
    assert got.numpy().tobytes() == twin.tobytes()


@pytest.mark.parametrize("codec", ["snappy", "none"])
def test_inflate_chunk_equal_host_twin_every_column_and_dtype(codec):
    data = _write(_simple_table(6000), compression=codec, row_group_size=3000,
                  data_page_size=4096)
    md = pq.read_metadata(io.BytesIO(data))
    for rg in range(md.num_row_groups):
        for c in range(md.row_group(rg).num_columns):
            chunk = _build(pd, data, md, rg, c)
            got = pk.inflate_chunk(chunk, CPU)
            want = chunk.decode()
            assert got.numpy().dtype == want.dtype  # INT64 int64, DOUBLE float64
            assert got.numpy().tobytes() == want.tobytes(), (rg, c)


def test_float64_inflates_where_the_reference_bails_without_x64():
    data = _write(pa.table({"d": pa.array(np.repeat(np.arange(40.0), 50))}))
    md = pq.read_metadata(io.BytesIO(data))
    with pytest.raises(ref_pk.DeviceInflateError):
        ref_pk.inflate_chunk(_build(ref_pd, data, md, 0, 0), interpret=True)
    chunk = _build(pd, data, md, 0, 0)
    got = pk.inflate_chunk(chunk, CPU)
    assert got.dtype == torch.float64 and got.numpy().tobytes() == chunk.decode().tobytes()


@pytest.mark.parametrize("offset", range(1, 8))
def test_bitcast_values_copies_a_misaligned_slice(offset):
    vals = np.arange(5, dtype="<i8") * 1234567891011
    raw = torch.from_numpy(np.frombuffer(bytes(offset) + vals.tobytes(), np.uint8).copy())
    got = pk.bitcast_values(raw[offset:], np.int64)
    assert got.dtype == torch.int64 and got.tolist() == vals.tolist()
    f32 = pk.bitcast_values(raw[offset:offset + 8], np.float32)
    assert f32.numpy().tobytes() == raw[offset:offset + 8].numpy().tobytes()


def test_host_reads_per_window():
    """Reads back to the host: one for a window of a nullable dictionary column, where
    the reference reads the pages' ok flags, the level-block length, the bit width, the
    stream's ok flag and the index range check."""
    data = _write(_simple_table(2000), data_page_size=1 << 20)
    md = pq.read_metadata(io.BytesIO(data))
    chunk = _build(pd, data, md, 0, 1)  # cat: nullable, dictionary, one data page
    assert chunk.max_def == 1 and len(chunk.pages) == 1
    before = pk.HOST_READS.value
    pk.inflate_chunk(chunk, CPU)
    assert pk.HOST_READS.value - before == 1


def test_corrupt_page_bails_then_the_host_twin_classifies_it():
    data = _write(_simple_table(900))
    md = pq.read_metadata(io.BytesIO(data))
    chunk = _build(pd, data, md, 0, 0)
    raw = bytearray(chunk.buf)
    raw[chunk.pages[0].payload_offset + 1] ^= 0x55
    bad = pd.PassthroughChunk(bytes(raw), chunk.codec, chunk.dtype, chunk.max_def,
                              chunk.dict_page, chunk.pages)
    try:
        out = pk.inflate_chunk(bad, CPU)
    except pk.DeviceInflateError:
        with pytest.raises(PagedecCorruptError):
            bad.decode()
        return
    assert out.shape == (bad.num_rows,)  # an undetectable value-level flip


def test_inflate_entry_points_run_on_the_card_by_default(monkeypatch):
    """Without a device argument the entry points take the CUDA device, and raise
    without one; they never fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = _write(_simple_table(500))
    md = pq.read_metadata(io.BytesIO(data))
    chunk = _build(pd, data, md, 0, 0)
    for call in (lambda: pk.inflate_chunk(chunk),
                 lambda: pk.inflate_window(chunk, 0, 10),
                 lambda: pk.inflate_column(pd.PassthroughColumn.from_chunk(chunk))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_kernel_wrappers_refuse_unsupported_inputs():
    with pytest.raises(TypeError):
        pk.snappy_inflate_pages(torch.zeros(2, 4), torch.zeros(2, 2, dtype=torch.int32), 4)
    with pytest.raises(TypeError):
        pk.snappy_inflate_pages(torch.zeros(2, 4, dtype=torch.uint8),
                                torch.zeros(3, 2, dtype=torch.int32), 4)
    with pytest.raises(TypeError):
        pk.rle_run_scan(torch.zeros(4, dtype=torch.int32), 4, 4, 8, 3)
    tables = [torch.zeros(8, dtype=torch.int32)] * 4
    with pytest.raises(TypeError):
        pk.rle_extract(torch.zeros(4, dtype=torch.uint8), *tables[:3],
                       torch.zeros(8, dtype=torch.int64), 3, 4)


# -- the pass-through seam ---------------------------------------------------------------


def _store(tmp_path, name="ds", n=4000, row_group_size=1000, with_string=True, seed=11,
           compression="snappy"):
    rng = np.random.default_rng(seed)
    cols = {
        "feat": pa.array(np.repeat(rng.normal(size=-(-n // 40)).astype(np.float32),
                                   40)[:n]),
        "cat": pa.array(rng.integers(0, 13, size=n).astype(np.int64)),
        "id": pa.array(np.arange(n, dtype=np.int32)),
        "dbl": pa.array(np.repeat(np.arange(float(-(-n // 25))), 25)[:n]),
    }
    if with_string:
        cols["s"] = pa.array(["row-%d" % i for i in range(n)])
    root = str(tmp_path / name)
    os.makedirs(root, exist_ok=True)
    pq.write_table(pa.table(cols), os.path.join(root, "part-0.parquet"),
                   compression=compression, row_group_size=row_group_size)
    return "file://" + root


def _collect(url, mode, batch=512, last_batch="partial", **loader_kwargs):
    out = []
    with make_batch_reader(url, workers_count=1, shuffle_row_groups=False,
                           io_options={"pagedec": mode}) as r:
        with DataLoader(r, batch, device=CPU, last_batch=last_batch,
                        **loader_kwargs) as loader:
            for b in loader:
                out.append({k: v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
                            for k, v in b.items()})
    return out


def _assert_batches_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert set(x) == set(y)
        for k in x:
            assert x[k].dtype == y[k].dtype, k
            assert x[k].tobytes() == y[k].tobytes() if x[k].dtype != object \
                else list(x[k]) == list(y[k]), k


@pytest.mark.parametrize("compression", ["snappy", "none"])
def test_whole_slice_equal_reference_classic_delivery(tmp_path, plain_inflate, compression):
    """make_batch_reader(pagedec="on") → DataLoader(device="cpu") through the kernels'
    plain versions is byte-identical to the JAX package's pagedec="off" delivery."""
    from petastorm_tpu.loader import DataLoader as RefLoader
    from petastorm_tpu.reader import make_batch_reader as ref_make_batch_reader

    url = _store(tmp_path, n=3000, row_group_size=700, with_string=False,
                 compression=compression)
    counters0 = pd.counter_values()
    ours = _collect(url, "on", batch=997)
    counters = {k: v - counters0[k] for k, v in pd.counter_values().items()}
    assert counters["pages"] > 0 and counters["host_inflate_columns"] == 0
    assert counters["bytes_compressed"] > 0
    theirs = []
    with ref_make_batch_reader(url, reader_pool_type="thread", workers_count=1,
                               shuffle_row_groups=False, io_options={"pagedec": "off"}) as r:
        with RefLoader(r, 997, to_device=False, last_batch="partial") as loader:
            for b in loader:
                theirs.append({k: np.asarray(v) for k, v in b.items()})
    _assert_batches_equal(ours, theirs)


def test_mixed_eligibility_degrades_per_column(tmp_path, plain_inflate):
    url = _store(tmp_path)
    before = pd.counter_values()["fallback_columns"]
    _assert_batches_equal(_collect(url, "off"), _collect(url, "on"))
    # `id` (incompressible arange) declines per column; `s` is footer-ineligible
    assert pd.counter_values()["fallback_columns"] > before


def test_host_twin_on_the_cpu_without_the_device_switch(tmp_path, monkeypatch):
    monkeypatch.delenv("PTPU_PAGEDEC_DEVICE", raising=False)
    url = _store(tmp_path, with_string=False)
    before = pd.counter_values()["host_inflate_columns"]
    _assert_batches_equal(_collect(url, "off"), _collect(url, "on"))
    assert pd.counter_values()["host_inflate_columns"] > before


def test_shuffling_buffer_inflates_on_host_counted(tmp_path, plain_inflate):
    url = _store(tmp_path, with_string=False)
    before = pd.counter_values()["host_inflate_columns"]
    out = _collect(url, "on", batch=500, last_batch="drop", shuffling_queue_capacity=1200,
                   seed=3)
    assert pd.counter_values()["host_inflate_columns"] > before
    assert sorted(np.concatenate([b["id"] for b in out]).tolist()) == list(range(4000))


def test_pad_tail_inflates_on_host_counted(tmp_path, plain_inflate):
    url = _store(tmp_path, n=1100, row_group_size=1100, with_string=False)
    before = pd.counter_values()["host_inflate_columns"]
    padded = _collect(url, "on", batch=512, last_batch="pad")
    assert pd.counter_values()["host_inflate_columns"] > before
    _assert_batches_equal(_collect(url, "off", batch=512, last_batch="pad"), padded)
    assert padded[-1]["__valid__"].sum() == 1100 - 1024


def test_batches_cut_across_row_groups(tmp_path, plain_inflate):
    url = _store(tmp_path, n=3000, row_group_size=700, with_string=False)
    _assert_batches_equal(_collect(url, "off", batch=997), _collect(url, "on", batch=997))


def test_pagedec_auto_stays_classic_on_cpu(tmp_path, plain_inflate):
    url = _store(tmp_path, with_string=False)
    before = pd.counter_values()["bytes_compressed"]
    _collect(url, "auto")
    assert pd.counter_values()["bytes_compressed"] == before


def test_loaderless_reader_materializes_and_loader_hands_back(tmp_path):
    url = _store(tmp_path, with_string=False)
    with make_batch_reader(url, workers_count=1, shuffle_row_groups=False, num_epochs=None,
                           io_options={"pagedec": "on"}) as r:
        b = next(iter(r))
        assert isinstance(b.feat, np.ndarray) and b.feat.dtype == np.float32
        assert isinstance(b.cat, np.ndarray) and b.cat.dtype == np.int64
        with DataLoader(r, 100, device=CPU):
            assert r.keep_passthrough
        assert not r.keep_passthrough
        assert isinstance(next(iter(r)).feat, np.ndarray)


def test_corrupt_pages_surface_pagedec_corrupt_error_through_the_loader(tmp_path,
                                                                        plain_inflate):
    url = _store(tmp_path, n=900, row_group_size=300, with_string=False)
    path = url[len("file://"):] + "/part-0.parquet"
    data = bytearray(open(path, "rb").read())
    md = pq.read_metadata(io.BytesIO(bytes(data)))
    raw = _chunk_bytes(bytes(data), md, 1, 0)
    chunk = _build(pd, bytes(data), md, 1, 0)
    start, _ = pd.chunk_byte_range(md.row_group(1).column(0))
    # garble the snappy stream of the first data page's payload: the kernel latches, the
    # host twin classifies
    page = chunk.pages[0]
    for k in range(page.comp_size // 2, page.comp_size):
        data[start + page.payload_offset + k] = 0xFF
    assert raw != bytes(data[start:start + len(raw)])
    with open(path, "wb") as f:
        f.write(bytes(data))
    with pytest.raises(PagedecCorruptError):
        _collect(url, "on", batch=300)


def test_kernels_rejecting_valid_pages_raise_a_kernel_fault(tmp_path, plain_inflate,
                                                             monkeypatch):
    """Pages the device path rejects but the host twin decodes are a kernel fault: the
    loader raises, and never delivers the twin's decode in the kernels' place."""
    url = _store(tmp_path, n=900, row_group_size=300, with_string=False)

    def latched(src, table, out_bytes):
        out, ok = plain(src, table, out_bytes)
        return out, torch.zeros_like(ok)

    plain = pk._snappy_ragged_plain
    monkeypatch.setattr(pk, "_snappy_ragged_plain", latched)
    before = pd.counter_values()["host_inflate_columns"]
    with pytest.raises(pk.KernelFaultError, match="host twin decodes"):
        _collect(url, "on", batch=300)
    assert pd.counter_values()["host_inflate_columns"] == before


def _passthrough_names(url, io_options):
    """Columns of the first batch a CUDA-adopted reader ships compressed."""
    with make_batch_reader(url, reader_pool_type="dummy", shuffle_row_groups=False,
                           io_options=io_options) as r:
        r.adopt_passthrough(on_device=True)
        b = next(iter(r))
        return sorted(k for k, v in b._asdict().items() if pd.is_passthrough(v))


def test_pagedec_defaults_to_the_classic_read_and_auto_engages_on_a_card(tmp_path,
                                                                        monkeypatch):
    """Without ``io_options`` a CUDA-adopted reader reads classically; ``auto`` ships
    every eligible column that saves bytes (``id``, an arange, declines at build)."""
    monkeypatch.delenv("PTPU_PAGEDEC", raising=False)
    assert IoOptions().pagedec == "off"
    url = _store(tmp_path, with_string=False)
    assert _passthrough_names(url, None) == []
    assert _passthrough_names(url, {"pagedec": "auto"}) == ["cat", "dbl", "feat"]


def test_io_options_pagedec_validates(monkeypatch):
    assert IoOptions.normalize({"pagedec": " ON "}).pagedec == "on"
    monkeypatch.setenv("PTPU_PAGEDEC", "off")
    assert IoOptions().pagedec == "off"
    with pytest.raises(ValueError):
        IoOptions(pagedec="sometimes")
    # the read path's options are ported (item 5a), the host-wide arena too (item 5b):
    # it rides beside pagedec
    opts = IoOptions.normalize({"pagedec": "on", "arena_bytes": 1 << 20})
    assert opts.pagedec == "on" and opts.arena_bytes == 1 << 20
    with pytest.raises(TypeError):
        IoOptions.normalize(3)


# -- on the card -------------------------------------------------------------------------


@pytest.mark.gpu
def test_snappy_kernel_matches_plain_on_the_card(cuda_device):
    _chunk, (comp, meta, out_cap) = _small_pages(n=3000)
    comp_t, meta_t = torch.from_numpy(comp), torch.from_numpy(meta)
    out, ok = pk.snappy_inflate_pages(comp_t.to(cuda_device), meta_t.to(cuda_device), out_cap)
    plain, plain_ok = pk.snappy_inflate_pages(comp_t, meta_t, out_cap)  # the plain version
    torch.cuda.synchronize()
    assert torch.equal(out.cpu(), plain) and torch.equal(ok.cpu(), plain_ok)


@pytest.mark.gpu
@pytest.mark.parametrize("bw", [1, 5, 12, 24, 25, 32])
def test_rle_kernels_match_plain_on_the_card(cuda_device, bw):
    """The one-stream entry points, thin callers of the batched kernels, on the card
    equal their plain versions."""
    stream, vals = _hybrid_stream(np.random.default_rng(bw), bw)
    data = torch.tensor(list(stream), dtype=torch.uint8)
    total = len(vals)
    tables = pk.rle_run_scan(data.to(cuda_device), len(stream), total, total, bw)
    plain = pk.rle_run_scan(data, len(stream), total, total, bw)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(tables, plain))
    got = pk.rle_extract(data.to(cuda_device), *tables[:4], bw, total)
    assert got.cpu().tolist() == pk.rle_extract(data, *plain[:4], bw, total).tolist()
    got, ok = pk.rle_expand(data.to(cuda_device), len(stream), bw, total)
    assert bool(ok) and got.cpu().numpy().view(np.uint32).tolist() == vals


def _assert_batched_kernels_match_plain(k3_out, stored, pages, k3_ok, runs_total, out_bytes,
                                        cuda_device):
    """The batched scan and K4 on the card against their plain versions on the same
    tables: meta and flags equal, each page's written run entries equal, and each page's
    delivered values equal. Returns the plain flags."""
    blocks = torch.from_numpy(pk.block_table(pages.numpy()))
    args = [k3_out, stored, pages]
    dev_args = [t.to(cuda_device) for t in args]
    scans, launches = pk.rle_scan_pages.launches, pk.extract_pages.launches
    runs, meta, flags = pk.rle_scan_pages(*dev_args, k3_ok.to(cuda_device), runs_total)
    out = pk.extract_pages(*dev_args, blocks.to(cuda_device), runs, meta, flags, out_bytes)
    torch.cuda.synchronize()
    assert pk.rle_scan_pages.launches == scans + 1
    assert pk.extract_pages.launches == launches + 1
    p_runs, p_meta, p_flags = pk.rle_scan_pages(*args, k3_ok, runs_total)
    p_out = pk.extract_pages(*args, blocks, p_runs, p_meta, p_flags, out_bytes)
    assert torch.equal(meta.cpu(), p_meta) and torch.equal(flags.cpu(), p_flags)
    runs, out = runs.cpu(), out.cpu()
    for row, m in zip(pages.tolist(), p_meta.tolist()):
        r = dict(zip(pk.PAGE_COLS, row))
        written = min(m[2], r["run_cap"], r["max_runs"]) if m[1] and r["run_off"] >= 0 else 0
        span = slice(r["run_off"], r["run_off"] + written)
        assert torch.equal(runs[span], p_runs[span])
        span = slice(r["dst"], r["dst"] + (r["hi"] - r["lo"]) * r["item"])
        assert torch.equal(out[span], p_out[span])
    return p_flags


@pytest.mark.gpu
@pytest.mark.parametrize("codec", ["snappy", "none"])
def test_batched_kernels_match_plain_on_the_card(cuda_device, codec):
    """The mixed batch (widths 1-17, PLAIN, nullable, snappy or stored pages, windows cut
    across row groups) and the hand-made widths 0-32: values and flags equal the plain
    versions'."""
    batch = pk.stage_batch(_mixed_columns(codec), CPU)
    out, ok, *_rest = batch.run()
    flags = _assert_batched_kernels_match_plain(out, batch.stored, batch.pages, ok,
                                                batch.plan.runs_total, batch.plan.out_bytes,
                                                cuda_device)
    assert not flags.any()
    stored, pages, _d, _s, runs_total, out_bytes = _hand_batch(
        [(0, 40, 0, 0, 40), (1, 300, 1, 10, 290), (9, 70, 0, 0, 70), (17, 1000, 1, 999, 1000),
         (24, 64, 0, 3, 60), (25, 90, 1, 0, 90), (32, 2100, 0, 0, 2100)],
        np.random.default_rng(5))
    empty = torch.empty(0, dtype=torch.uint8)
    flags = _assert_batched_kernels_match_plain(empty, stored, pages, torch.empty(
        0, dtype=torch.bool), runs_total, out_bytes, cuda_device)
    assert not flags.any()


@pytest.mark.gpu
def test_batched_kernels_match_plain_on_the_card_fuzzed(cuda_device):
    """About 200 random, bit-flipped, cut and tight-capacity streams (and a few pages
    K3 rejected, and a few rows whose run entries start before the run table) in one
    launch each: values, run entries and verdicts equal the plain versions'."""
    rng = np.random.default_rng(43)
    real = [s for s in (_hybrid_stream(rng, int(rng.integers(1, 33)), high=50)
                        for _ in range(40))]
    buf = bytearray(np.arange(50, dtype="<i4").tobytes())
    rows, run_off, dst = [], 0, 0
    for i in range(208):
        kind = i % 4
        max_def = int(rng.integers(0, 2))
        if kind == 0:  # random bytes
            body = rng.integers(0, 256, int(rng.integers(0, 40)), dtype=np.uint8).tobytes()
            n = int(rng.integers(0, 300))
        else:
            stream, vals = real[int(rng.integers(0, len(real)))]
            bw = max(1, max(vals).bit_length())
            body = bytearray((_level_block(len(vals)) if max_def else b"")
                             + bytes([bw]) + stream)
            n = len(vals)
            if kind == 1:
                for _ in range(int(rng.integers(1, 4))):
                    body[int(rng.integers(0, len(body)))] ^= 1 << int(rng.integers(0, 8))
            elif kind == 2:
                body = body[:len(body) - int(rng.integers(1, min(8, len(body)) + 1))]
            body = bytes(body)
        buf += bytes(-len(buf) % 16)
        cap = len(body) // 2 + 1 if kind != 3 else int(rng.integers(1, 4))
        lo = int(rng.integers(0, n + 1))
        hi = int(rng.integers(lo, n + 1))
        rows.append(pk.page_row(
            buf=1, off=len(buf), size=len(body), ok_idx=int(rng.integers(0, 4)) - 1,
            max_def=max_def, enc=pk.ENC_VALUES_DICT if i % 9 else pk.ENC_VALUES_PLAIN,
            num_values=n, item=4 if i % 5 else 8, dict_buf=1, dict_n=int(rng.integers(-1, 51)),
            run_off=run_off if i % 13 != 6 else -1 - i % 5, run_cap=cap,
            max_runs=max(8, n) if i % 7 else 3, lo=lo, hi=hi, dst=dst))
        buf += body
        run_off += cap
        dst += 8 * (hi - lo)
    k3_ok = torch.from_numpy(rng.integers(0, 2, 3).astype(bool))
    flags = _assert_batched_kernels_match_plain(
        torch.empty(0, dtype=torch.uint8), torch.from_numpy(np.frombuffer(bytes(buf), np.uint8)
                                                            .copy()),
        torch.tensor(rows, dtype=torch.int64), k3_ok, run_off, dst, cuda_device)
    assert (flags == 0).any() and len(set(flags.tolist())) >= 5


@pytest.mark.gpu
def test_inflate_columns_on_the_card_one_read_and_one_launch_each(cuda_device):
    """The loader's batch inflate on the card: one K3, one scan and one K4 launch, one
    read back to the host, values equal to the host twin."""
    cols = {**_batch_columns(codecs=("snappy", "none")), **_mixed_columns("snappy")}
    counts = (pk.snappy_inflate_ragged.launches, pk.rle_scan_pages.launches,
              pk.extract_pages.launches, pk.HOST_READS.value)
    got = pk.inflate_columns(cols, cuda_device)
    assert (pk.snappy_inflate_ragged.launches, pk.rle_scan_pages.launches,
            pk.extract_pages.launches, pk.HOST_READS.value) \
        == tuple(c + 1 for c in counts)
    for name, col in cols.items():
        assert got[name].cpu().numpy().tobytes() == col.materialize().tobytes(), name


@pytest.mark.gpu
@pytest.mark.parametrize("codec", ["snappy", "none"])
def test_large_pages_on_the_card_equal_host_twin(cuda_device, codec):
    """1 MiB data pages of ~250,000 values (a PLAIN column and a dictionary column):
    K4's grid scales over the values, the scan walks each page's runs alone."""
    rng = np.random.default_rng(3)
    n = 250000
    t = pa.table({"plain": pa.array(rng.integers(0, 1 << 31, n).astype(np.int32)),
                  "dict": pa.array(rng.integers(0, 1000, n).astype(np.int32))})
    # pyarrow from 15 on also cuts pages at 20,000 rows unless told otherwise
    rows_limit = {"max_rows_per_page": n} if "max_rows_per_page" in \
        inspect.signature(pq.ParquetWriter.__init__).parameters else {}
    data = _write(t, compression=codec, row_group_size=n, data_page_size=1 << 20,
                  use_dictionary=["dict"], **rows_limit)
    md = pq.read_metadata(io.BytesIO(data))
    cols = {}
    for c in range(2):
        chunk = _build(pd, data, md, 0, c)
        assert max(p.num_values for p in chunk.pages) >= 200000
        cols[t.column_names[c]] = pd.PassthroughColumn.from_chunk(chunk).slice(11, n - 20)
    got = pk.inflate_columns(cols, cuda_device)
    for name, col in cols.items():
        assert got[name].cpu().numpy().tobytes() == col.materialize().tobytes(), name


@pytest.mark.gpu
def test_inflate_column_on_the_card_equals_host_twin(cuda_device):
    data = _write(_simple_table(6000), row_group_size=3000, data_page_size=4096)
    md = pq.read_metadata(io.BytesIO(data))
    for c in range(md.row_group(0).num_columns):
        chunk = _build(pd, data, md, 0, c)
        got = pk.inflate_column(pd.PassthroughColumn.from_chunk(chunk).slice(11, 2500),
                                cuda_device)
        assert got.cpu().numpy().tobytes() == chunk.decode_window(11, 2500).tobytes()


def _window_edge_pages(rng):
    """Raw snappy pages around K3's shared-memory windows (66 KiB decoded, 40 KiB
    compressed): a 1 MiB page above the output window, an incompressible 60 KiB page
    whose source is above its window, and a 64 KiB page of many copies inside both."""
    raws = [(rng.zipf(1.3, 1 << 18) % 1000).astype(np.int32).tobytes(),
            rng.integers(0, 256, 60 << 10, dtype=np.uint8).tobytes(),
            (rng.zipf(1.3, 1 << 14) % 1000).astype(np.int32).tobytes()]
    return [(pa.compress(r, codec="snappy", asbytes=True), r) for r in raws]


@pytest.mark.gpu
def test_ragged_kernel_matches_plain_on_the_card_across_the_window(cuda_device):
    """One launch over a store's pages, pages above the shared-memory windows and the
    crafted corrupt pages: bytes and ok flags equal the plain version's, and the large
    pages equal their raw bytes."""
    groups = _ragged_groups(n=3000)
    layout, src, table = pk.pack_ragged(groups)
    spans = [src] + [np.frombuffer(c, np.uint8) for c, _r in
                     _window_edge_pages(np.random.default_rng(31))]
    caps = [None] + [len(r) for _c, r in _window_edge_pages(np.random.default_rng(31))]
    for _what, comp_bytes, out_len in [
            ("literal overrun", bytes([64, 252, 0xFF, 0xFF, 0xFF, 0xFF]) + bytes(10), 64),
            ("32-bit wrap", bytes([64, 0, 7, 252, 0xFE, 0xFF, 0xFF, 0x7F]) + bytes(8), 64),
            ("copy before the output", bytes([16, 0, 7, 0x3D, 9]) + bytes(4), 16)]:
        spans.append(np.frombuffer(comp_bytes, np.uint8))
        caps.append(out_len)
    rows, src_off, out_off = [list(r) for r in table.tolist()], 0, layout.out_bytes
    parts = []
    for a, cap in zip(spans, caps):
        if cap is not None:
            rows.append([src_off, len(a), len(a), out_off, cap])
            out_off += -(-cap // 16) * 16
        parts.append(np.pad(a, (0, -len(a) % 16)))
        src_off += len(parts[-1])
    all_src = torch.from_numpy(np.concatenate(parts))
    all_table = torch.tensor(rows, dtype=torch.int64)
    before = pk.snappy_inflate_ragged.launches
    out, ok = pk.snappy_inflate_ragged(all_src.to(cuda_device), all_table.to(cuda_device),
                                       out_off)
    torch.cuda.synchronize()
    assert pk.snappy_inflate_ragged.launches == before + 1
    plain, plain_ok = pk.snappy_inflate_ragged(all_src, all_table, out_off)
    assert torch.equal(ok.cpu(), plain_ok)
    assert plain_ok.tolist() == [True] * (len(rows) - 3) + [False] * 3
    for _s, _l, _c, dst_off, cap in rows:  # bytes outside the spans are unspecified
        assert torch.equal(out[dst_off:dst_off + cap].cpu(), plain[dst_off:dst_off + cap])
    for (_c, raw), row in zip(_window_edge_pages(np.random.default_rng(31)),
                              rows[len(table):]):
        assert out[row[3]:row[3] + row[4]].cpu().numpy().tobytes() == raw


@pytest.mark.gpu
def test_batch_inflate_on_the_card_equals_host_twin(cuda_device):
    """The loader's one-launch batch inflate on the card, snappy and uncompressed
    columns side by side, with one read of the ok flags."""
    cols = _batch_columns(codecs=("snappy", "none"))
    launches, reads = pk.snappy_inflate_ragged.launches, pk.HOST_READS.value
    got = pk.inflate_columns(cols, cuda_device)
    assert pk.snappy_inflate_ragged.launches == launches + 1
    for name, col in cols.items():
        assert got[name].cpu().numpy().tobytes() == col.materialize().tobytes(), name
    cpu_reads = pk.HOST_READS.value - reads
    reads = pk.HOST_READS.value
    pk.inflate_columns(cols, CPU)
    assert pk.HOST_READS.value - reads == cpu_reads


@pytest.mark.gpu
def test_ragged_kernel_verdicts_match_plain_on_the_card_fuzzed(cuda_device):
    """Random streams, bit-flipped real pages, streams cut short and tight output spans,
    all in one launch: every page's bytes and ok flag equal the plain version's."""
    rng = np.random.default_rng(41)
    groups = _ragged_groups(n=3000)
    real = [np.frombuffer(c.buf, np.uint8)[p.payload_offset:p.payload_offset + p.comp_size]
            for c, pages in groups for p in pages]
    caps = [p.uncomp_size for _c, pages in groups for p in pages]
    spans, rows = [], []
    for i in range(240):
        kind = i % 4
        if kind == 0:  # random bytes behind a small varint
            a = rng.integers(0, 256, int(rng.integers(1, 90)), dtype=np.uint8)
            a[0] = rng.integers(0, 120)
            comp_len, cap = len(a) - int(rng.integers(0, min(3, len(a)))), int(rng.integers(1, 160))
        else:
            j = int(rng.integers(0, len(real)))
            a, cap = real[j].copy(), caps[j]
            comp_len = len(a)
            if kind == 1:
                for _ in range(int(rng.integers(1, 4))):
                    a[rng.integers(0, len(a))] ^= np.uint8(1 << int(rng.integers(0, 8)))
            elif kind == 2:
                comp_len -= int(rng.integers(1, min(40, len(a)) + 1))
            else:
                cap += int(rng.integers(-16, 17))
        spans.append(a)
        rows.append([0, len(a), comp_len, 0, max(cap, 0)])
    src_off = out_off = 0
    for a, row in zip(spans, rows):
        row[0], row[3] = src_off, out_off
        src_off += len(a) + (-len(a) % 16)
        out_off += row[4] + (-row[4] % 16)
    src = np.zeros(src_off, np.uint8)
    for a, row in zip(spans, rows):
        src[row[0]:row[0] + len(a)] = a
    src_t, table = torch.from_numpy(src), torch.tensor(rows, dtype=torch.int64)
    out, ok = pk.snappy_inflate_ragged(src_t.to(cuda_device), table.to(cuda_device), out_off)
    plain, plain_ok = pk.snappy_inflate_ragged(src_t, table, out_off)
    torch.cuda.synchronize()
    assert torch.equal(ok.cpu(), plain_ok)
    assert 0 < int(plain_ok.sum()) < len(rows)
    for _s, _l, _c, dst_off, cap in rows:
        assert torch.equal(out[dst_off:dst_off + cap].cpu(), plain[dst_off:dst_off + cap])
