"""``transform_spec`` through the port's reader factories against the JAX package's.

A small scalar store the reference wrote, read through ``make_reader`` and
``make_batch_reader`` with an opaque host ``TransformSpec`` (a row dict or a pandas
DataFrame in, out) and with a host ``FeaturePipeline`` whose statistics the factories
resolve (row-group min/max, a data pass for mean/std, quantiles and a vocabulary), on
the dummy, thread and process pools: every id once, every field equal to the JAX
package's reader per id (dummy pool). Also: the derived schema, the pass-through turned
off by any transform (0 pages shipped), the refusal of a host spec with
``decode_on_device``, and ``transform_schema`` itself."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_pool_helpers import (_no_leaked_shm_segments, double_x_plus_a,  # noqa: E402,F401
                                 no_leaked_port_slabs)
from petastorm_tpu import metadata as ref_metadata  # noqa: E402
from petastorm_tpu import reader as ref_reader  # noqa: E402
from petastorm_tpu import types as ref_types  # noqa: E402
from petastorm_tpu.codecs import ScalarCodec as RefScalar  # noqa: E402
from petastorm_tpu.io import statscache as ref_stats  # noqa: E402
from petastorm_tpu.ops import tabular as ref_tab  # noqa: E402
from petastorm_tpu.transform import TransformSpec as RefSpec  # noqa: E402
from petastorm_tpu.transform import transform_schema as ref_transform_schema  # noqa: E402
from petastorm_tpu.unischema import Unischema as RefSchema  # noqa: E402
from petastorm_tpu.unischema import UnischemaField as RefField  # noqa: E402
from petastorm_tpu_torch import TransformSpec, make_batch_reader, make_reader  # noqa: E402
from petastorm_tpu_torch import transform_schema  # noqa: E402
from petastorm_tpu_torch.io import pagedec  # noqa: E402
from petastorm_tpu_torch.io import statscache as port_stats  # noqa: E402
from petastorm_tpu_torch.ops import tabular as port_tab  # noqa: E402
from petastorm_tpu_torch.reader import _spec_wants_writable  # noqa: E402
from petastorm_tpu_torch.unischema import Unischema, UnischemaField  # noqa: E402

ROWS = 120
POOLS = {"dummy": dict(reader_pool_type="dummy"),
         "thread": dict(reader_pool_type="thread", workers_count=3),
         "process": dict(reader_pool_type="process", workers_count=2,
                         results_timeout_s=120)}


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """120 rows in 4 row groups: id, two float columns, two categoricals."""
    schema = RefSchema("TransformSchema", [
        RefField("id", np.int64, (), RefScalar(ref_types.LongType()), False),
        RefField("x", np.float64, (), RefScalar(ref_types.DoubleType()), False),
        RefField("y", np.float32, (), RefScalar(ref_types.FloatType()), False),
        RefField("a", np.int64, (), RefScalar(ref_types.LongType()), False),
        RefField("b", np.int32, (), RefScalar(ref_types.IntegerType()), False),
    ])
    rng = np.random.RandomState(21)

    def rows():
        for i in range(ROWS):
            yield {"id": i, "x": float(rng.normal(3.0, 2.0)),
                   "y": np.float32(rng.exponential(1.5)),
                   "a": int(rng.randint(-2 ** 35, 2 ** 35)),
                   "b": np.int32(rng.zipf(1.5) % 9)}

    url = "file://" + str(tmp_path_factory.mktemp("torch_transform") / "ds")
    ref_metadata.write_dataset(url, schema, rows(), row_group_size_mb=0, rows_per_file=30)
    return url


def _opaque(module):
    spec = RefSpec if module is ref_tab else TransformSpec
    return spec(double_x_plus_a, edit_fields=[("x2", np.float64, (), False)])


def _pipeline(module):
    return module.FeaturePipeline([
        module.Standardize("x", out="xz"),
        module.Normalize("y", out="yn"),
        module.Bucketize("y", num_buckets=4, out="yb"),
        module.HashField("a", 100, out="ah"),
        module.VocabLookup("b", max_size=5, out="bv"),
        module.FeatureCross(("a", "b"), 50, out="ab"),
    ], removed_fields=["a"])


SPECS = {"opaque": _opaque, "pipeline": _pipeline}


def _by_id(reader, batched):
    out = {}
    for item in reader:
        d = item._asdict()
        if batched:
            for i, rid in enumerate(d["id"]):
                out[int(rid)] = {k: v[i] for k, v in d.items()}
        else:
            out[int(d["id"])] = d
    return out


@pytest.fixture(scope="module")
def reference_rows(store):
    """The JAX package's delivery for every (factory, spec), on its dummy pool."""
    out = {}
    for batched, factory in ((False, ref_reader.make_reader),
                             (True, ref_reader.make_batch_reader)):
        for name, spec in SPECS.items():
            ref_stats.clear_memo()
            with factory(store, reader_pool_type="dummy", shuffle_row_groups=False,
                         transform_spec=spec(ref_tab)) as r:
                out[batched, name] = (_by_id(r, batched), list(r.schema.fields),
                                      getattr(r.transform_spec, "stats_info", {}))
    ref_stats.clear_memo()
    return out


@pytest.mark.parametrize("pool", sorted(POOLS))
@pytest.mark.parametrize("spec", sorted(SPECS))
@pytest.mark.parametrize("batched", [False, True], ids=["make_reader", "make_batch_reader"])
def test_reader_applies_the_transform_like_the_reference(store, reference_rows, batched,
                                                         spec, pool):
    theirs, fields, stats_info = reference_rows[batched, spec]
    port_stats.clear_memo()
    factory = make_batch_reader if batched else make_reader
    with factory(store, shuffle_row_groups=True, seed=3, transform_spec=SPECS[spec](port_tab),
                 **POOLS[pool]) as r:
        assert list(r.schema.fields) == fields
        ours = _by_id(r, batched)
        assert getattr(r.transform_spec, "stats_info", {}) == stats_info
    port_stats.clear_memo()
    assert sorted(ours) == sorted(theirs) == list(range(ROWS))
    for rid, row in theirs.items():
        assert sorted(ours[rid]) == sorted(row)
        for k, v in row.items():
            np.testing.assert_array_equal(ours[rid][k], v, err_msg="%s of id %d" % (k, rid))
            assert np.asarray(ours[rid][k]).dtype == np.asarray(v).dtype, k


def test_pipeline_statistics_resolve_by_tier(store, reference_rows):
    _rows, _fields, stats_info = reference_rows[True, "pipeline"]
    assert stats_info == {"mean:x": "data-pass", "std:x": "data-pass",
                          "min:y": "rowgroup-stats", "max:y": "rowgroup-stats",
                          "quantiles:y:4": "data-pass", "vocab:b:5": "data-pass"}


@pytest.fixture(scope="module")
def compressible_store(tmp_path_factory):
    """Snappy pages that ship smaller than their values (low-cardinality columns)."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    rng = np.random.RandomState(4)
    root = tmp_path_factory.mktemp("torch_transform_pagedec")
    n = 8192
    pq.write_table(pa.table({"b": (rng.zipf(1.5, n) % 9).astype(np.int32),
                             "k": (rng.zipf(1.3, n) % 50).astype(np.int64),
                             "r": np.repeat(rng.rand(n // 64), 64).astype(np.float32)}),
                   str(root / "part-0.parquet"), row_group_size=4096, compression="snappy")
    return "file://" + str(root)


@pytest.mark.parametrize("spec", ["host pipeline", "device pipeline", "device opaque"])
def test_any_transform_spec_turns_the_pass_through_off(compressible_store, spec):
    """As the JAX package's ``_pagedec_shape_ok``: a transform_spec, even a device one,
    reads the whole store classically: no column ships its pages under
    ``pagedec="on"``, where the same read without a transform ships every column."""
    if spec == "device opaque":
        transform = TransformSpec(lambda batch: batch, device=True)
    else:
        transform = port_tab.FeaturePipeline([port_tab.HashField("b", 10, out="bh")],
                                             device=spec.startswith("device"))

    def shipped(**kw):
        with make_batch_reader(compressible_store, reader_pool_type="dummy",
                               io_options={"pagedec": "on"}, **kw) as r:
            r.adopt_passthrough(on_device=False)
            batches = [b._asdict() for b in r]
        assert sum(len(b["b"]) for b in batches) == 8192
        return sum(pagedec.is_passthrough(v) for b in batches for v in b.values())

    assert shipped(transform_spec=transform) == 0
    assert shipped() == 2 * 3  # two row groups of three columns


@pytest.mark.parametrize("factory", ["make_reader", "make_batch_reader"])
def test_host_spec_with_decode_on_device_raises_like_the_reference(store, factory):
    for reader_mod, spec in ((ref_reader, _opaque(ref_tab)), (None, _opaque(port_tab)),
                             (ref_reader, _pipeline(ref_tab)),
                             (None, _pipeline(port_tab))):
        fn = getattr(reader_mod, factory) if reader_mod is not None else \
            {"make_reader": make_reader, "make_batch_reader": make_batch_reader}[factory]
        with pytest.raises(ValueError, match="not compatible with a host transform_spec"):
            fn(store, reader_pool_type="dummy", transform_spec=spec, decode_on_device=True)
    ref_stats.clear_memo()
    port_stats.clear_memo()


def test_transform_schema_equals_the_reference():
    fields = [("id", np.int64), ("x", np.float64), ("y", np.float32)]
    theirs_schema = RefSchema("S", [RefField(n, d, (), None, False) for n, d in fields])
    ours_schema = Unischema("S", [UnischemaField(n, d, (), None, False) for n, d in fields])
    for kw in ({"edit_fields": [("x", np.float32, (), True), ("z", np.int8, (2,), False)],
                "removed_fields": ["y"]},
               {"edit_fields": [("x2", np.float64, (), None, False)],
                "selected_fields": ["x2", "id"]},
               {"removed_fields": ["ghost"]}):
        theirs = ref_transform_schema(theirs_schema, RefSpec(**kw))
        ours = transform_schema(ours_schema, TransformSpec(**kw))
        assert ours.name == theirs.name
        assert [(f.name, np.dtype(f.numpy_dtype), f.shape, f.nullable)
                for f in ours.fields.values()] == \
            [(f.name, np.dtype(f.numpy_dtype), f.shape, f.nullable)
             for f in theirs.fields.values()]
    with pytest.raises(ValueError, match="selected_fields"):
        transform_schema(ours_schema, TransformSpec(selected_fields=["ghost"]))
    with pytest.raises(ValueError, match="edit_fields"):
        TransformSpec(edit_fields=["x"])


def test_spec_wants_writable_only_for_opaque_host_callables():
    schema = Unischema("S", [UnischemaField("x", np.float64, (), None, False)])
    assert not _spec_wants_writable(None)
    assert not _spec_wants_writable(
        port_tab.FeaturePipeline([port_tab.Clip("x", 0, 1)]).compile(schema))
    assert not _spec_wants_writable(TransformSpec(func=None))
    assert not _spec_wants_writable(TransformSpec(lambda df: df, device=True))
    assert _spec_wants_writable(TransformSpec(lambda df: df))
