"""Port vs reference: NGram windowing. ``valid_window_starts`` equals the JAX package's
under hypothesis; per-row ``{offset: namedtuple}`` windows and batched flat
``offset/field`` columns equal the JAX package's per window (keyed by the window's first
id) on the dummy, thread and process pools (the pickle wire per row, ``'arrow'`` and
``'shm-view'`` per batch, with a 3-D tensor column and slashed names); a
``transform_spec`` runs before the windowing; the reference's refusals keep their
messages; and flat columns go through ``DataLoader(device="cpu")`` with ``pad_shapes``
and a callable ``device_transform`` as through the JAX package's loader."""
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

from _torch_pool_helpers import _no_leaked_shm_segments, no_leaked_port_slabs  # noqa: E402,F401
from petastorm_tpu import ngram as ref_ngram  # noqa: E402
from petastorm_tpu import predicates as ref_predicates  # noqa: E402
from petastorm_tpu import reader as ref_reader  # noqa: E402
from petastorm_tpu.loader import DataLoader as RefLoader  # noqa: E402
from petastorm_tpu.transform import TransformSpec as RefSpec  # noqa: E402
from petastorm_tpu_torch import TransformSpec, make_batch_reader, make_reader  # noqa: E402
from petastorm_tpu_torch import ngram, predicates, types  # noqa: E402
from petastorm_tpu_torch.codecs import (CompressedImageCodec, NdarrayCodec,  # noqa: E402
                                        ScalarCodec)
from petastorm_tpu_torch.loader import DataLoader  # noqa: E402
from petastorm_tpu_torch.metadata import write_petastorm_tpu_metadata  # noqa: E402
from petastorm_tpu_torch.unischema import Unischema, UnischemaField, encode_row  # noqa: E402

CPU = "cpu"
FILES, ROWS_PER_FILE, RG_ROWS = 3, 20, 7
POOLS = {"dummy": dict(reader_pool_type="dummy"),
         "thread": dict(reader_pool_type="thread", workers_count=3),
         "process": dict(reader_pool_type="process", workers_count=2,
                         results_timeout_s=120)}
WIRES = ["arrow", "shm-view"]


def _schema():
    return Unischema("NgramSchema", [
        UnischemaField("id", np.int64, (), ScalarCodec(types.LongType()), False),
        UnischemaField("ts", np.int64, (), ScalarCodec(types.LongType()), False),
        UnischemaField("x", np.float64, (), ScalarCodec(types.DoubleType()), False),
        UnischemaField("matrix", np.float32, (3, 2), NdarrayCodec(), False),
        UnischemaField("image", np.uint8, (8, 8, 3), CompressedImageCodec("png"), False),
        UnischemaField("name", np.str_, (), ScalarCodec(types.StringType()), False),
    ])


def _timestamps(n, seed):
    """10 ms steps with a seeded gap of 25 to 60 ms after about one row in six."""
    rng = np.random.RandomState(seed)
    steps = np.where(rng.rand(n) < 0.16, rng.randint(25, 61, n), 10)
    return np.cumsum(steps).astype(np.int64)


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """60 rows in 3 files of row groups of 7, 7 and 6 rows; each row group's rows are
    stored in a seeded order, so the windowing's sort by ``ts`` matters."""
    schema = _schema()
    root = tmp_path_factory.mktemp("torch_ngram") / "ds"
    os.makedirs(root)
    rng = np.random.RandomState(3)
    ts = _timestamps(FILES * ROWS_PER_FILE, 4)
    counts = {}
    for f in range(FILES):
        rows = []
        for start in range(0, ROWS_PER_FILE, RG_ROWS):
            ids = f * ROWS_PER_FILE + start + rng.permutation(
                min(RG_ROWS, ROWS_PER_FILE - start))
            for i in ids:
                rows.append(encode_row(schema, {
                    "id": int(i), "ts": int(ts[i]), "x": float(rng.normal()),
                    "matrix": rng.rand(3, 2).astype(np.float32),
                    "image": rng.randint(0, 256, (8, 8, 3)).astype(np.uint8),
                    "name": "row-%d" % i}))
        table = pa.Table.from_pylist(rows, schema=schema.as_arrow_schema())
        name = "part-%d.parquet" % f
        pq.write_table(table, str(root / name), row_group_size=RG_ROWS)
        counts[name] = pq.read_metadata(str(root / name)).num_row_groups
    write_petastorm_tpu_metadata(pa.fs.LocalFileSystem(), str(root), schema, counts)
    return "file://" + str(root)


def _fields(with_image=True):
    big = ["id", "ts", "matrix", "name"] + (["image"] if with_image else [])
    return {0: big, 1: ["id", "ts", "x"], 2: ["id"]}


def _ngrams(overlap=True, delta=10, fields=None):
    fields = fields or _fields()
    return (ngram.NGram(fields, delta, "ts", timestamp_overlap=overlap),
            ref_ngram.NGram(fields, delta, "ts", timestamp_overlap=overlap))


def _assert_same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


# -- the window math ------------------------------------------------------------------------


@settings(max_examples=200, deadline=None)
@given(steps=st.lists(st.integers(0, 30), max_size=40), length=st.integers(1, 5),
       delta=st.integers(0, 20), overlap=st.booleans())
def test_valid_window_starts_equal_the_reference(steps, length, delta, overlap):
    ts = np.cumsum(np.asarray(steps, dtype=np.int64))
    ours = ngram.valid_window_starts(ts, length, delta, overlap)
    theirs = ref_ngram.valid_window_starts(ts, length, delta, overlap)
    np.testing.assert_array_equal(ours, theirs)
    assert np.asarray(ours).dtype.kind == np.asarray(theirs).dtype.kind == "i"


@pytest.mark.parametrize("fields,match", [({}, "non-empty"),
                                          ({0: ["a"], 2: ["a"]}, "consecutive")])
def test_ngram_checks_raise_like_the_reference(fields, match):
    for module in (ngram, ref_ngram):
        with pytest.raises(ValueError, match=match):
            module.NGram(fields, 10, "ts")


def test_regex_resolution_and_field_lists_equal_the_reference():
    from petastorm_tpu.unischema import Unischema as RefSchema

    schema = _schema()
    ref_schema = RefSchema.from_json(schema.to_json())
    ours = ngram.NGram({0: ["i.*", "ts"], 1: ["m.*"]}, 5, "ts")
    theirs = ref_ngram.NGram({0: ["i.*", "ts"], 1: ["m.*"]}, 5, "ts")
    ours.resolve_regex_field_names(schema)
    theirs.resolve_regex_field_names(ref_schema)
    for offset in (0, 1):
        assert ours.get_field_names_at_timestep(offset) \
            == theirs.get_field_names_at_timestep(offset)
    assert ours.get_all_field_names() == theirs.get_all_field_names()
    assert ours.length == theirs.length == 2
    assert list(ours.make_schema_view(schema).fields) \
        == list(theirs.make_schema_view(ref_schema).fields)
    with pytest.raises(ValueError, match="matched nothing"):
        ngram.NGram({0: ["nope"]}, 5, "ts").resolve_regex_field_names(schema)


def test_form_ngram_columns_raises_for_a_missing_field():
    ng = ngram.NGram({0: ["id", "v"], 1: ["id"]}, 10, "ts")
    cols = {"ts": np.arange(5) * 10, "id": np.arange(5)}
    with pytest.raises(ValueError, match="removed by a transform_spec") as ours:
        ngram.form_ngram_columns(cols, ng)
    with pytest.raises(ValueError) as theirs:
        ref_ngram.form_ngram_columns(cols, ref_ngram.NGram({0: ["id", "v"], 1: ["id"]},
                                                           10, "ts"))
    assert str(ours.value) == str(theirs.value)


# -- windows through the readers -------------------------------------------------------------


def _row_windows(module, url, ng, **kwargs):
    """{first id: {offset: {field: value}}} of a per-row NGram read."""
    kw = dict(num_epochs=1, shuffle_row_groups=False, reader_pool_type="dummy")
    kw.update(kwargs)
    out = {}
    with module.make_reader(url, schema_fields=ng, **kw) as reader:
        for w in reader:
            assert sorted(w) == list(range(ng.length))
            key = int(w[0].id)
            assert key not in out
            out[key] = {off: row._asdict() for off, row in w.items()}
    return out


def _batch_windows(module, url, ng, **kwargs):
    """{first id: {flat column: value}} of a batched NGram read."""
    kw = dict(num_epochs=1, shuffle_row_groups=False, reader_pool_type="dummy")
    kw.update(kwargs)
    out = {}
    with module.make_batch_reader(url, schema_fields=ng, **kw) as reader:
        for batch in reader:
            assert type(batch) is dict
            for j, rid in enumerate(batch["0/id"]):
                assert int(rid) not in out
                # copies: on a view wire the batch views a slab until the next fetch
                out[int(rid)] = {k: np.array(v[j]) for k, v in batch.items()}
    return out


def _assert_row_windows_equal(ours, theirs):
    assert ours.keys() == theirs.keys() and ours
    for key, w in ours.items():
        for off, row in w.items():
            assert list(row) == list(theirs[key][off])
            for name, v in row.items():
                if isinstance(v, np.ndarray):
                    _assert_same(v, theirs[key][off][name])
                else:
                    assert v == theirs[key][off][name]


def _assert_batch_windows_equal(ours, theirs):
    assert ours.keys() == theirs.keys() and ours
    for key, w in ours.items():
        assert sorted(w) == sorted(theirs[key])
        for name, v in w.items():
            _assert_same(v, theirs[key][name])


@pytest.mark.parametrize("pool", sorted(POOLS))
def test_per_row_windows_equal_the_reference_per_key(store, pool):
    ours_ng, ref_ng = _ngrams()
    theirs = _row_windows(ref_reader, store, ref_ng)
    ours = _row_windows(__import__("petastorm_tpu_torch.reader").reader, store, ours_ng,
                        **POOLS[pool])
    _assert_row_windows_equal(ours, theirs)
    # each window's rows are consecutive in ts within delta_threshold
    for w in ours.values():
        assert w[1]["ts"] - w[0]["ts"] <= 10


@pytest.mark.parametrize("pool,wire", [("dummy", None), ("thread", None),
                                       ("process", "arrow"), ("process", "shm-view")])
def test_batched_windows_equal_the_reference_per_key(store, pool, wire):
    from petastorm_tpu_torch import reader as port_reader

    ours_ng, ref_ng = _ngrams()
    theirs = _batch_windows(ref_reader, store, ref_ng)
    kw = dict(POOLS[pool])
    if wire:
        kw["wire_serializer"] = wire
    ours = _batch_windows(port_reader, store, ours_ng, **kw)
    _assert_batch_windows_equal(ours, theirs)
    first = next(iter(ours.values()))
    assert first["0/matrix"].shape == (3, 2) and first["0/image"].shape == (8, 8, 3)


def test_batched_windows_equal_the_per_row_windows(store):
    from petastorm_tpu_torch import reader as port_reader

    per_row = _row_windows(port_reader, store, _ngrams()[0])
    batched = _batch_windows(port_reader, store, _ngrams()[0])
    assert per_row.keys() == batched.keys()
    for key, w in per_row.items():
        for off, row in w.items():
            for name, v in row.items():
                got = batched[key]["%d/%s" % (off, name)]
                if isinstance(v, np.ndarray):
                    _assert_same(got, v)
                else:
                    assert got == v


@pytest.mark.parametrize("batched", [False, True])
def test_no_overlap_and_a_wider_threshold_equal_the_reference(store, batched):
    from petastorm_tpu_torch import reader as port_reader

    read = _batch_windows if batched else _row_windows
    for overlap, delta in ((False, 10), (True, 40)):
        fields = {0: ["id", "ts"], 1: ["id", "ts"], 2: ["id", "ts"]}
        ours_ng, ref_ng = _ngrams(overlap, delta, fields)
        ours = read(port_reader, store, ours_ng)
        theirs = read(ref_reader, store, ref_ng)
        if batched:
            _assert_batch_windows_equal(ours, theirs)
        else:
            _assert_row_windows_equal(ours, theirs)


def _scale_x_row(row):
    row["x"] = row["x"] * 2.0 + 1.0
    return row


def _scale_x_frame(df):
    df["x"] = df["x"] * 2.0 + 1.0
    return df


@pytest.mark.parametrize("batched", [False, True])
def test_transform_spec_runs_before_the_windowing(store, batched):
    from petastorm_tpu_torch import reader as port_reader

    fn = _scale_x_frame if batched else _scale_x_row
    fields = {0: ["id", "ts", "x"], 1: ["id", "x"]}
    read = _batch_windows if batched else _row_windows
    ours_ng, ref_ng = _ngrams(fields=fields)
    ours = read(port_reader, store, ours_ng, transform_spec=TransformSpec(fn))
    theirs = read(ref_reader, store, ref_ng, transform_spec=RefSpec(fn))
    plain = read(port_reader, store, _ngrams(fields=fields)[0])
    if batched:
        _assert_batch_windows_equal(ours, theirs)
        assert all(w["1/x"] == 2.0 * plain[k]["1/x"] + 1.0 for k, w in ours.items())
    else:
        _assert_row_windows_equal(ours, theirs)
        assert all(w[1]["x"] == 2.0 * plain[k][1]["x"] + 1.0 for k, w in ours.items())


def test_a_transform_that_removes_a_window_field_raises(store):
    def drop_x(df):
        return df.drop(columns=["x"])

    ng = ngram.NGram({0: ["id", "ts", "x"], 1: ["id"]}, 10, "ts")
    with make_batch_reader(store, schema_fields=ng, reader_pool_type="dummy",
                           transform_spec=TransformSpec(drop_x, removed_fields=["x"])) as r:
        with pytest.raises(ValueError, match="removed by a transform_spec"):
            next(r)


# -- refusals ------------------------------------------------------------------------------


def _refusal(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("factory", ["make_reader", "make_batch_reader"])
def test_predicate_and_decode_on_device_refusals_match_the_reference(store, factory):
    import petastorm_tpu_torch.reader as port_reader

    for module, preds, ngmod in ((port_reader, predicates, ngram),
                                 (ref_reader, ref_predicates, ref_ngram)):
        make = getattr(module, factory)
        ng = ngmod.NGram({0: ["id"], 1: ["id"]}, 10, "ts")
        msg = _refusal(lambda: make(store, schema_fields=ng,
                                    predicate=preds.in_set({1}, "id")))
        assert msg == "NGram readers do not support predicates"
        msg = _refusal(lambda: make(store, schema_fields=ng, decode_on_device=True))
        assert msg == "decode_on_device is not supported with NGram readers"


def test_device_pipeline_and_device_spec_refusals(store):
    from petastorm_tpu_torch.ops import tabular

    ng = ngram.NGram({0: ["id", "x"], 1: ["id"]}, 10, "ts")
    pipe = tabular.FeaturePipeline([tabular.Clip("x", -1.0, 1.0)], device=True)
    with make_batch_reader(store, schema_fields=ng, reader_pool_type="dummy") as r:
        with pytest.raises(ValueError, match="offset/field"):
            DataLoader(r, 4, device=CPU, device_transform=pipe)
    with make_reader(store, schema_fields=ng, reader_pool_type="dummy",
                     transform_spec=TransformSpec(lambda b: b, device=True)) as r:
        with pytest.raises(ValueError, match="offset/field"):
            DataLoader(r, 4, device=CPU)


def test_torch_adapters_refuse_a_batched_ngram_reader(store):
    from petastorm_tpu_torch.adapters.pytorch import BatchedDataLoader
    from petastorm_tpu_torch.adapters.pytorch import DataLoader as TorchLoader

    ng = ngram.NGram({0: ["id"], 1: ["id"]}, 10, "ts")
    with make_batch_reader(store, schema_fields=ng, reader_pool_type="dummy") as r:
        for cls in (TorchLoader, BatchedDataLoader):
            with pytest.raises(ValueError, match="batched NGram.*"
                               "petastorm_tpu_torch.loader.DataLoader"):
                cls(r)


def test_other_selectors_raise(store):
    with pytest.raises(ValueError, match="NGram"):
        make_batch_reader(store, schema_fields=object())


def test_ngram_reads_classically_even_with_the_pass_through_on(tmp_path):
    """NGram turns the pass-through off for the whole read (the workers need decoded
    columns to window): no ``PassthroughColumn`` reaches the worker's windowing."""
    from petastorm_tpu_torch.io import pagedec

    root = tmp_path / "seq"
    os.makedirs(root)
    pq.write_table(pa.table({"ts": np.arange(0, 4000, 10, dtype=np.int64),
                             "v": np.tile(np.arange(8, dtype=np.float32), 50)}),
                   str(root / "p.parquet"), row_group_size=100, compression="snappy")
    ng = ngram.NGram({0: ["ts", "v"], 1: ["ts", "v"]}, 10, "ts")
    before = pagedec.counter_values()["bytes_compressed"]
    with make_batch_reader("file://" + str(root), schema_fields=ng,
                           reader_pool_type="dummy", io_options={"pagedec": "on"}) as r:
        r.adopt_passthrough(on_device=False)
        batches = list(r)
    assert pagedec.counter_values()["bytes_compressed"] == before
    assert all(isinstance(v, np.ndarray) for b in batches for v in b.values())
    assert sum(len(b["0/ts"]) for b in batches) == 4 * 99


# -- the DataLoader ------------------------------------------------------------------------


@pytest.mark.parametrize("batched", [False, True])
def test_flat_columns_through_the_loader_equal_the_reference(store, batched):
    from petastorm_tpu_torch import reader as port_reader

    fields = {0: ["id", "ts", "matrix", "image"], 1: ["id", "x"], 2: ["id"]}
    ours_ng, ref_ng = _ngrams(fields=fields)
    factory = "make_batch_reader" if batched else "make_reader"
    kw = dict(num_epochs=1, shuffle_row_groups=False, reader_pool_type="dummy")

    def port_transform(b):
        return {**b, "0/scaled": b["0/matrix"] * 2.0 + b["1/x"].float()[:, None, None]}

    ours = {}
    with DataLoader(getattr(port_reader, factory)(store, schema_fields=ours_ng, **kw), 5,
                    device=CPU, last_batch="partial",
                    device_transform=port_transform) as loader:
        for batch in loader:
            assert all(isinstance(v, torch.Tensor) for v in batch.values())
            for j, rid in enumerate(batch["0/id"].tolist()):
                ours[rid] = {k: v[j].numpy() for k, v in batch.items()}
    theirs = {}
    with RefLoader(getattr(ref_reader, factory)(store, schema_fields=ref_ng, **kw), 5,
                   to_device=False, last_batch="partial") as loader:
        for batch in loader:
            for j, rid in enumerate(np.asarray(batch["0/id"])):
                theirs[int(rid)] = {k: np.asarray(v)[j] for k, v in batch.items()}
    assert ours.keys() == theirs.keys() and ours
    for key, w in ours.items():
        expected = dict(theirs[key])
        # the same float32 operations, in numpy
        expected["0/scaled"] = expected["0/matrix"] * np.float32(2.0) \
            + expected["1/x"].astype(np.float32)
        assert sorted(w) == sorted(expected)
        for name, v in w.items():
            _assert_same(v, expected[name])


def test_pad_shapes_key_by_the_flat_name(tmp_path):
    """A ragged list column inside windows, padded by its flat name, equals the JAX
    package's loader's padding and mask."""
    root = tmp_path / "ragged"
    os.makedirs(root)
    rng = np.random.RandomState(8)
    n = 48
    hist = [rng.randint(0, 100, rng.randint(0, 6)).astype(np.int32).tolist()
            for _ in range(n)]
    pq.write_table(pa.table({"ts": np.arange(n, dtype=np.int64) * 10,
                             "hist": pa.array(hist, type=pa.list_(pa.int32()))}),
                   str(root / "p.parquet"), row_group_size=16)
    url = "file://" + str(root)
    fields = {0: ["ts", "hist"], 1: ["ts", "hist"]}
    pads = {"0/hist": (5,), "1/hist": (5,)}
    kw = dict(num_epochs=1, shuffle_row_groups=False, reader_pool_type="dummy")
    with DataLoader(make_batch_reader(url, schema_fields=ngram.NGram(fields, 10, "ts"), **kw),
                    8, device=CPU, pad_shapes=pads, last_batch="partial") as loader:
        ours = [{k: v.numpy() for k, v in b.items()} for b in loader]
    with RefLoader(ref_reader.make_batch_reader(
            url, schema_fields=ref_ngram.NGram(fields, 10, "ts"), **kw), 8,
            to_device=False, pad_shapes=pads, last_batch="partial") as loader:
        theirs = [{k: np.asarray(v) for k, v in b.items()} for b in loader]
    assert len(ours) == len(theirs) and sum(len(b["0/ts"]) for b in ours) == 3 * 15
    for a, b in zip(ours, theirs):
        assert sorted(a) == sorted(b) and "0/hist__mask" in a
        for name in a:
            _assert_same(a[name], b[name])


@pytest.mark.gpu
@pytest.mark.parametrize("batched", [False, True])
def test_windows_reach_the_card_equal_to_the_cpu_loader(store, batched):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from petastorm_tpu_torch.ops.image import normalize_images

    fields = {0: ["id", "ts", "image"], 1: ["id", "image"]}
    factory = make_batch_reader if batched else make_reader

    def transform(b):
        return {**b, "0/norm": normalize_images(b["0/image"], [0.5] * 3, [0.25] * 3)}

    def run(device):
        got = {}
        reader = factory(store, schema_fields=ngram.NGram(fields, 10, "ts"), num_epochs=1,
                         shuffle_row_groups=False, reader_pool_type="dummy")
        with DataLoader(reader, 4, device=device, last_batch="partial",
                        device_transform=transform) as loader:
            for b in loader:
                for j, rid in enumerate(b["0/id"].tolist()):
                    got[rid] = {k: v[j].cpu() for k, v in b.items()}
        return got

    on_card, on_cpu = run("cuda"), run(CPU)
    assert on_card.keys() == on_cpu.keys() and on_card
    for key, w in on_card.items():
        for name, v in w.items():
            assert torch.equal(v, on_cpu[key][name]), name
