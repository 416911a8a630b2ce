"""The port's declarative feature pipelines (petastorm_tpu_torch.ops.tabular) against the
JAX package's (petastorm_tpu.ops.tabular), on the same numpy-seeded columns and the same
op lists.

- Device target: the port's device function on CPU tensors against ``jax.jit`` of the
  reference's (64-bit types off, as the reference's loader runs it). Ids (hash, cross,
  vocab, bucket) bit-exact; float results with ``atol=0`` where the arithmetic is the
  same (every case below: the same float32 subtract and multiply, in the same order).
- Host target: ``apply_columns`` and ``apply_rows`` equal, string hashing included, and
  plan-time validation raises ``PipelineValidationError`` where the reference does.
- Statistics: ``resolve_statistics`` over one store gives the same values and sources.
"""
import warnings

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

torch = pytest.importorskip("torch")

from _torch_pool_helpers import _no_leaked_shm_segments  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from petastorm_tpu.io import statscache as ref_stats  # noqa: E402
from petastorm_tpu.ops import tabular as ref  # noqa: E402
from petastorm_tpu.unischema import Unischema as RefSchema  # noqa: E402
from petastorm_tpu.unischema import UnischemaField as RefField  # noqa: E402
from petastorm_tpu_torch.io import statscache as port_stats  # noqa: E402
from petastorm_tpu_torch.ops import tabular as port  # noqa: E402
from petastorm_tpu_torch.transform import transform_schema  # noqa: E402
from petastorm_tpu_torch.unischema import Unischema as PortSchema  # noqa: E402
from petastorm_tpu_torch.unischema import UnischemaField as PortField  # noqa: E402

N = 96
FIELDS = {"id": np.int64, "x": np.float64, "y": np.float64, "a": np.int64,
          "b": np.int64, "f": np.float32, "i": np.int32, "u": np.uint8}


def _schemas(fields=FIELDS):
    return (RefSchema("S", [RefField(n, dt, (), None, False) for n, dt in fields.items()]),
            PortSchema("S", [PortField(n, dt, (), None, False) for n, dt in fields.items()]))


def _columns(seed=0, n=N):
    rng = np.random.RandomState(seed)
    x = rng.normal(2.0, 3.0, n)
    x[::7] = np.nan
    x[3], x[4], x[5] = np.inf, -np.inf, 4.0e9  # beyond int32 for the casts
    big = rng.randint(-2 ** 40, 2 ** 40, n, dtype=np.int64)
    big[:4] = [2 ** 31, 2 ** 31 + 5, -2 ** 31 - 1, 2 ** 32 + 7]
    return {
        "id": np.arange(n, dtype=np.int64),
        "x": x,
        "y": np.sin(np.arange(n, dtype=np.float64)),
        "a": big,
        "b": rng.randint(-20, 20, n).astype(np.int64),
        "f": rng.normal(0.0, 1.0, n).astype(np.float32),
        "i": rng.randint(-1000, 1000, n).astype(np.int32),
        "u": rng.randint(0, 256, n).astype(np.uint8),
    }


def _both(build, fields=FIELDS, **kw):
    """The reference's and the port's pipeline built from one op list, compiled against
    one schema."""
    ref_schema, port_schema = _schemas(fields)
    return (ref.FeaturePipeline(build(ref), **kw).compile(ref_schema),
            port.FeaturePipeline(build(port), **kw).compile(port_schema))


def _reference_device(pipe, cols):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # 64-bit inputs narrowed, as device_put does
        batch = {k: jnp.asarray(v) for k, v in cols.items()}
    return {k: np.asarray(v) for k, v in jax.jit(pipe._device_call)(batch).items()}


def _port_device(pipe, cols):
    out = pipe._device_call({k: torch.from_numpy(v.copy()) for k, v in cols.items()})
    return {k: v.numpy() if isinstance(v, torch.Tensor) else v for k, v in out.items()}


DEVICE_CASES = {
    "normalize": lambda m: [m.Normalize("x", min=-1.0, max=7.0, out="xn"),
                            m.Normalize("i", min=-1000, max=1000, out="in")],
    "standardize": lambda m: [m.Standardize("y", mean=0.25, std=0.7, out="yz"),
                              m.Standardize("f", mean=-0.1, std=1.3)],
    "clip": lambda m: [m.Clip("x", -1.0, 3.5, out="xc"), m.Clip("i", -10.5, 20.5),
                       m.Clip("f", -0.5, 0.5)],
    "cast": lambda m: [m.Cast("x", np.int32, out="xi"), m.Cast("x", np.uint8, out="xu"),
                       m.Cast("x", np.int64, out="xl"), m.Cast("a", np.float32, out="af"),
                       m.Cast("f", np.float64, out="fd"), m.Cast("i", np.bool_, out="ib"),
                       m.Cast("u", np.int16, out="us")],
    "fill_null": lambda m: [m.FillNull("x", -1.5, out="xf"), m.FillNull("f", 2)],
    "bucketize": lambda m: [m.Bucketize("x", boundaries=[-1.0, 0.0, 2.0, 2.0, 5.5],
                                        out="xb"),
                            m.Bucketize("i", boundaries=[-500, 0, 1, 999], out="ib"),
                            m.Bucketize("y", boundaries=[0.1, 0.30000001], out="yb")],
    "hash": lambda m: [m.HashField("a", 1000, out="ah"),
                       m.HashField("b", 7, out="bh", seed=12345),
                       m.HashField("i", 39884406, out="ih"),
                       m.HashField("u", 3, out="uh", seed=-1)],
    "vocab": lambda m: [m.VocabLookup("b", vocab=[5, -3, 1, 17, -20], out="bv"),
                        m.VocabLookup("y", vocab=[0.0, 0.5, float(np.sin(3.0))],
                                      out="yv", default=-7),
                        m.VocabLookup("i", vocab=[0.5, 12.0, -3.0], out="iv"),
                        m.VocabLookup("u", vocab=[7, 250, 0], out="uv")],
    "cross": lambda m: [m.FeatureCross(("a", "b"), 64, out="ab"),
                        m.FeatureCross(("b", "i", "u"), 39043, out="biu", seed=3)],
    "normalize_clip_fused": lambda m: [m.Normalize("x", min=0.0, max=16.0),
                                       m.Clip("x", 0.0, 1.0), m.Cast("x", np.float32)],
    "standardize_then_int_cast": lambda m: [m.Standardize("y", mean=0.0, std=0.1),
                                            m.Cast("y", np.int64)],
    "fill_standardize_clip": lambda m: [m.Standardize("x", mean=1.0, std=3.0, out="xs"),
                                        m.FillNull("xs", 0.0), m.Clip("xs", -2.0, 2.0)],
    "hash_chain": lambda m: [m.HashField("b", 7, out="b"), m.HashField("b", 5, out="b2"),
                             m.HashField("i", 11, out="ih"), m.HashField("i", 13, out="i")],
    "dense_chains": lambda m: [m.Standardize("x", mean=1.0, std=3.0, out="x1"),
                               m.FillNull("x1", 0.5), m.Standardize("f", mean=0.2, std=0.9),
                               m.FillNull("f", -1.0),
                               m.Standardize("y", mean=-0.1, std=2.5, out="y1"),
                               m.FillNull("y1", 2)],
    "normalize_clip_chains": lambda m: [m.Normalize("x", min=0.0, max=8.0, out="xn"),
                                        m.Clip("xn", 0.0, 1.0),
                                        m.Normalize("y", min=-1.0, max=1.0, out="yn"),
                                        m.Clip("yn", 0.25, 0.75)],
    "chains_of_mixed_dtypes": lambda m: [m.Normalize("x", min=0.0, max=8.0, out="xn"),
                                         m.Clip("xn", 0.0, 1.0),
                                         m.Normalize("i", min=-5, max=5, out="in"),
                                         m.Clip("in", -1, 1)],
    "hashed_then_crossed": lambda m: [m.HashField("a", 97, out="ah"),
                                      m.Bucketize("f", boundaries=[-1.0, 0.0, 1.0],
                                                  out="fb"),
                                      m.FeatureCross(("ah", "fb"), 211, out="x2")],
}


@pytest.mark.parametrize("case", sorted(DEVICE_CASES))
def test_device_function_equals_the_jitted_reference(case):
    """Every output column of the port's device function equals jax.jit of the
    reference's: same dtype, ids bit-exact, floats with atol=0 (the same float32
    arithmetic in the same order)."""
    ref_pipe, port_pipe = _both(DEVICE_CASES[case])
    assert [s.label for s in port_pipe._plan] == [s.label for s in ref_pipe._plan]
    cols = _columns(seed=len(case))
    cols["f"][::5] = np.nan
    theirs = _reference_device(ref_pipe, cols)
    ours = _port_device(port_pipe, cols)
    derived = {s.out for s in port_pipe._plan}
    assert sorted(ours) == sorted(theirs)
    for name in derived:
        assert ours[name].dtype == theirs[name].dtype, (name, ours[name].dtype,
                                                        theirs[name].dtype)
        np.testing.assert_array_equal(ours[name], theirs[name], err_msg=name)


def test_device_hash_of_int64_columns_reads_the_low_word():
    """The port keeps int64 columns 64 bits wide where the reference's device holds
    their low word (ROADMAP.md Queue 3, pinned divergences): the hash reads the low word
    in both, so int64 values beyond 2**31 hash alike, and equal to the host target."""
    ref_pipe, port_pipe = _both(lambda m: [m.HashField("a", 2 ** 31 + 11, out="ah"),
                                           m.FeatureCross(("a", "b"), 977, out="ab")])
    cols = _columns(seed=5)
    ours = port_pipe._device_call({k: torch.from_numpy(v.copy()) for k, v in cols.items()})
    assert ours["a"].dtype == torch.int64  # the pass-through column stays int64
    theirs = _reference_device(ref_pipe, cols)
    host = port_pipe.apply_columns(cols)
    for name in ("ah", "ab"):
        np.testing.assert_array_equal(ours[name].numpy(), theirs[name])
        np.testing.assert_array_equal(ours[name].numpy(), host[name].astype(np.int32))


def test_device_bucketize_compares_in_float32_unlike_the_host_target():
    """Queue 3 G: the reference's device Bucketize rounds the boundaries and values to
    float32, its host target compares in float64. The port follows each target. Smallest
    input: boundary 0.1 and the value 0.09999999999, which rounds to float32 0.1: bucket 1
    on the device, 0 on the host."""
    build = lambda m: [m.Bucketize("x", boundaries=[0.1], out="xb")]  # noqa: E731
    ref_pipe, port_pipe = _both(build)
    cols = {k: v[:2] for k, v in _columns(seed=1).items()}
    cols["x"] = np.array([0.09999999999, 0.1], dtype=np.float64)
    ours = _port_device(port_pipe, cols)["xb"]
    np.testing.assert_array_equal(ours, _reference_device(ref_pipe, cols)["xb"])
    assert ours.tolist() == [1, 1]
    host = port_pipe.apply_columns(cols)["xb"]
    assert host.tolist() == ref_pipe.apply_columns(cols)["xb"].tolist() == [0, 1]


def test_device_outputs_stay_on_the_input_device_and_select_fields():
    ref_pipe, port_pipe = _both(lambda m: [m.HashField("b", 10, out="bh"),
                                           m.Standardize("f", mean=0.0, std=2.0)],
                                selected_fields=["id", "bh", "f"])
    cols = _columns(seed=2)
    ours = _port_device(port_pipe, cols)
    theirs = _reference_device(ref_pipe, cols)
    assert sorted(ours) == sorted(theirs) == ["bh", "f", "id"]
    for k in ("bh", "f"):
        np.testing.assert_array_equal(ours[k], theirs[k])


def test_device_vocab_refuses_string_vocabularies():
    _ref_schema, port_schema = _schemas({"s": np.str_})
    pipe = port.FeaturePipeline([port.VocabLookup("s", vocab=["a", "b"], out="sv")],
                                device=True).compile(port_schema)
    with pytest.raises(port.PipelineValidationError, match="string vocabularies"):
        pipe._device_call({"s": torch.zeros(3)})


# -- host target ------------------------------------------------------------------------

HOST_CASES = {
    "numeric": lambda m: [m.Normalize("x", min=0.0, max=10.0), m.Clip("x", 0.0, 1.0),
                          m.Standardize("y", out="yz", mean=0.5, std=2.0),
                          m.Cast("a", np.float32, out="af"), m.FillNull("f", 0.0)],
    "ids": lambda m: [m.Bucketize("y", boundaries=[-0.5, 0.0, 0.5], out="yb"),
                      m.HashField("a", 32, out="ah"),
                      m.VocabLookup("b", vocab=[5, 3, 1], out="bv"),
                      m.FeatureCross(("a", "b"), 64, out="ab"),
                      m.FeatureCross(("b", "i", "u"), 1021, out="biu", seed=9)],
    "int_cast_break": lambda m: [m.Standardize("x", mean=0.0, std=2.0),
                                 m.Cast("x", np.int64), m.Clip("i", 0, 5)],
}


def _assert_columns_equal(ours, theirs):
    assert sorted(ours) == sorted(theirs)
    for k in theirs:
        assert np.asarray(ours[k]).dtype == np.asarray(theirs[k]).dtype, k
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)


@pytest.mark.parametrize("case", sorted(HOST_CASES))
def test_apply_columns_and_rows_equal_the_reference(case):
    ref_pipe, port_pipe = _both(HOST_CASES[case])
    cols = _columns(seed=3)
    cols["x"] = np.nan_to_num(cols["x"], posinf=50.0, neginf=-50.0)  # castable to int64
    _assert_columns_equal(port_pipe.apply_columns(dict(cols)),
                          ref_pipe.apply_columns(dict(cols)))
    rows = [{k: v[i] for k, v in cols.items()} for i in range(12)]
    ours, theirs = port_pipe.apply_rows(rows), ref_pipe.apply_rows(rows)
    assert len(ours) == len(theirs) == 12
    for a, b in zip(ours, theirs):
        assert sorted(a) == sorted(b)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # the derived schema: the same fields and dtypes
    ref_schema, port_schema = _schemas()
    from petastorm_tpu.transform import transform_schema as ref_transform_schema

    ours_s = transform_schema(port_schema, port_pipe)
    theirs_s = ref_transform_schema(ref_schema, ref_pipe)
    assert [(f.name, np.dtype(f.numpy_dtype), f.nullable) for f in ours_s.fields.values()] \
        == [(f.name, np.dtype(f.numpy_dtype), f.nullable) for f in theirs_s.fields.values()]


@pytest.mark.parametrize("values", [
    ["a", "b", "zz", "a", "", "longer string over sixteen chars"],  # the vectorized lane
    ["é", "b", None, "ü" * 3],                                        # the scalar lane
    [b"raw", b"", b"\x00nul"],
])
def test_string_hash_and_vocab_equal_the_reference(values):
    fields = {"s": np.str_}
    build = lambda m: [m.HashField("s", 1 << 20, out="sh", seed=77),  # noqa: E731
                       m.HashField("s", 16, out="sh16")]
    ref_pipe, port_pipe = _both(build, fields)
    col = np.empty(len(values), dtype=object)
    col[:] = values
    _assert_columns_equal(port_pipe.apply_columns({"s": col}),
                          ref_pipe.apply_columns({"s": col}))
    if all(isinstance(v, str) for v in values):
        build = lambda m: [m.VocabLookup("s", vocab=["b", "a", "zz"], out="sv")]  # noqa
        ref_pipe, port_pipe = _both(build, fields)
        _assert_columns_equal(port_pipe.apply_columns({"s": col}),
                              ref_pipe.apply_columns({"s": col}))


def test_leased_batch_keeps_its_leases_and_escalates_one_column():
    from petastorm_tpu_torch.io.lease import Lease, LeasedBatch, lease_stats, readonly_view

    _ref_schema, port_schema = _schemas()
    pipe = port.FeaturePipeline([port.Clip("x", 0.0, 2.0)]).compile(port_schema)
    lease = Lease(kind="test")
    batch = LeasedBatch(readonly_view(_columns(seed=4)), leases=(lease,))
    cow = lease_stats()["cow"]
    out = pipe.apply_columns(batch)
    assert out is batch and out.leases == (lease,)
    assert lease_stats()["cow"] == cow + 1
    assert out["x"].flags.writeable and np.nanmax(out["x"]) <= 2.0
    assert not out["id"].flags.writeable  # untouched: still the leased view
    batch.release()


def test_stage_counters_record_the_fused_labels():
    _ref_schema, port_schema = _schemas()
    pipe = port.FeaturePipeline([port.Normalize("x", min=0, max=1), port.Clip("x", 0, 1),
                                 port.HashField("a", 8, out="ah")]).compile(port_schema)
    before = port.transform_op_stats()
    rows = port.transform_rows_total()
    pipe.apply_columns(_columns(seed=6, n=32))
    after = port.transform_op_stats()
    for label in ("normalize+clip", "hash"):
        assert after[label]["count"] == before.get(label, {"count": 0})["count"] + 1
    assert port.transform_rows_total() == rows + 32


# -- validation -------------------------------------------------------------------------

_NUM = {"id": np.int64, "x": np.float64, "y": np.float64, "a": np.int64, "b": np.int64}
VALIDATION_CASES = [
    ("unknown field", _NUM, lambda m: m.FeaturePipeline([m.Normalize("nope", min=0, max=1)]),
     "compile", "nope"),
    # deliberately invalid constructions: the runtime raise mirrors what graftlint
    # GL-S001 reports statically (hence the inline suppressions, as in test_tabular.py)
    ("hash dtype", _NUM,
     lambda m: m.HashField("a", 10, dtype=np.float32),  # graftlint: disable=GL-S001
     None, "integer"),
    ("bucket dtype", _NUM,
     lambda m: m.Bucketize("x", num_buckets=4, dtype=np.float64),  # graftlint: disable=GL-S001
     None, "integer"),
    ("normalize dtype", _NUM,
     lambda m: m.Normalize("x", dtype=np.int32),  # graftlint: disable=GL-S001
     None, "floating"),
    ("bucketize both", _NUM, lambda m: m.Bucketize("x"), None, "exactly one"),
    ("non-numeric", {"s": np.str_},
     lambda m: m.FeaturePipeline([m.Normalize("s", min=0, max=1)]), "compile", "non-numeric"),
    ("cross float", _NUM, lambda m: m.FeaturePipeline([m.FeatureCross(("x", "a"), 8, out="c")]),
     "compile", "cross integer"),
    ("stats on derived", _NUM, lambda m: m.FeaturePipeline(
        [m.Standardize("x", mean=0, std=1, out="xz"), m.Bucketize("xz", num_buckets=4,
                                                                  out="xb")]),
     "required_statistics", "already transformed"),
    ("stats on in-place", _NUM, lambda m: m.FeaturePipeline(
        [m.Standardize("x", mean=0, std=1), m.Normalize("x")]),
     "required_statistics", "already transformed"),
    ("unresolved", _NUM, lambda m: m.FeaturePipeline([m.Standardize("x")]), "compile",
     "unresolved statistics"),
    ("selected ghost", _NUM, lambda m: m.FeaturePipeline([m.Clip("x", 0, 1)],
                                                         selected_fields=["ghost"]),
     "compile", "selected_fields"),
    ("not compiled", _NUM, lambda m: m.FeaturePipeline([m.Clip("x", 0, 1)]), "apply",
     "not compiled"),
    ("fill int", _NUM, lambda m: m.FeaturePipeline([m.FillNull("a", 0)]), "compile",
     "only float columns"),
    ("device stats", _NUM, lambda m: m.FeaturePipeline([m.Standardize("x")], device=True),
     "device_fn", "statistics"),
    ("removed ghost", _NUM, lambda m: m.FeaturePipeline([m.Clip("x", 0, 1)],
                                                        removed_fields=["ghost"]),
     "compile", "removed_fields"),
]


@pytest.mark.parametrize("case", VALIDATION_CASES, ids=[c[0] for c in VALIDATION_CASES])
def test_validation_raises_where_the_reference_does(case):
    _name, fields, build, step, match = case
    for module, schema in zip((ref, port), _schemas(fields)):
        with pytest.raises(module.PipelineValidationError, match=match):
            obj = build(module)
            if step == "compile":
                obj.compile(schema)
            elif step == "required_statistics":
                obj.required_statistics(schema)
            elif step == "apply":
                obj.apply_columns({"x": np.zeros(2)})
            elif step == "device_fn":
                obj.device_fn(schema)


# -- statistics -------------------------------------------------------------------------


@pytest.fixture
def stats_store(tmp_path):
    rng = np.random.RandomState(11)
    n = 3000
    table = pa.table({
        "d": np.log1p(rng.zipf(1.6, n)).astype(np.float32),
        "e": np.where(rng.rand(n) < 0.1, np.nan, rng.normal(5.0, 2.0, n)),
        "c": (rng.zipf(1.3, n) % 50).astype(np.int32),
        "k": rng.randint(-5, 5, n).astype(np.int64),
    })
    pq.write_table(table, str(tmp_path / "part-0.parquet"), row_group_size=700)
    pq.write_table(table.slice(0, 1000), str(tmp_path / "part-1.parquet"),
                   row_group_size=300)
    return "file://" + str(tmp_path)


def _requirements(module):
    R = module.StatRequirement
    return [R("d", "min"), R("d", "max"), R("k", "max"), R("e", "mean"), R("e", "std"),
            R("d", "quantiles", 16), R("e", "quantiles", 5), R("c", "vocab", 10),
            R("k", "vocab", 100)]


def _pieces(module_prefix, url):
    import importlib

    fs_mod = importlib.import_module(module_prefix + ".fs")
    md_mod = importlib.import_module(module_prefix + ".metadata")
    fs, path = fs_mod.get_filesystem_and_path_or_paths(url)
    return fs, md_mod.load_row_groups(fs, path)


def test_resolve_statistics_equals_the_reference(stats_store):
    """Values and sources equal, quantile boundaries and vocabularies exact; the second
    resolution is served from the memo in both."""
    ref_stats.clear_memo()
    port_stats.clear_memo()
    fs, pieces = _pieces("petastorm_tpu", stats_store)
    theirs, theirs_src = ref_stats.resolve_statistics(_requirements(ref), fs, pieces)
    fs, pieces = _pieces("petastorm_tpu_torch", stats_store)
    ours, ours_src = port_stats.resolve_statistics(_requirements(port), fs, pieces)
    assert ours_src == theirs_src
    assert ours_src["min:d"] == "rowgroup-stats" and ours_src["mean:e"] == "data-pass"
    assert sorted(ours) == sorted(theirs)
    for key, value in theirs.items():
        if isinstance(value, np.ndarray):
            np.testing.assert_array_equal(ours[key], value, err_msg=key)
        else:
            assert ours[key] == value, key
    again, again_src = port_stats.resolve_statistics(_requirements(port), fs, pieces)
    assert set(again_src.values()) == {"rowgroup-stats", "cached"}
    assert again["vocab:c:10"] == ours["vocab:c:10"]
    port_stats.clear_memo()
    ref_stats.clear_memo()


def test_aggregate_column_stats_equals_the_reference(stats_store):
    from petastorm_tpu.metadata import aggregate_column_stats as ref_aggregate
    from petastorm_tpu_torch.metadata import aggregate_column_stats

    cols = ["d", "e", "c", "k", "missing"]
    fs, pieces = _pieces("petastorm_tpu", stats_store)
    theirs = ref_aggregate(fs, pieces, cols)
    fs, pieces = _pieces("petastorm_tpu_torch", stats_store)
    assert aggregate_column_stats(fs, pieces, cols) == theirs
    assert "d" in theirs and "missing" not in theirs


def test_pipeline_compiled_with_the_references_statistics_computes_the_same(stats_store):
    """The state that crosses from the JAX package: a port pipeline compiled with the
    reference's ``stats`` dict equals the reference's on both targets."""
    ref_stats.clear_memo()
    fs, pieces = _pieces("petastorm_tpu", stats_store)
    fields = {"d": np.float32, "e": np.float64, "c": np.int32, "k": np.int64}
    build = lambda m: [m.Normalize("d", out="dn"), m.Standardize("e", out="ez"),  # noqa
                       m.FillNull("ez", 0.0), m.Bucketize("d", num_buckets=16, out="db"),
                       m.VocabLookup("c", max_size=10, out="cv"),
                       m.VocabLookup("k", max_size=100, out="kv")]
    ref_schema, port_schema = _schemas(fields)
    ref_pipe = ref.FeaturePipeline(build(ref))
    stats, _src = ref_stats.resolve_statistics(ref_pipe.required_statistics(ref_schema),
                                               fs, pieces)
    ref_pipe.compile(ref_schema, statistics=stats)
    port_pipe = port.FeaturePipeline(build(port)).compile(port_schema, statistics=stats)
    cols = {k: np.asarray(v, dtype=fields[k])
            for k, v in pq.read_table(pieces[0].path).to_pydict().items()}
    _assert_columns_equal(port_pipe.apply_columns(dict(cols)),
                          ref_pipe.apply_columns(dict(cols)))
    ours = _port_device(port_pipe, cols)
    theirs = _reference_device(ref_pipe, cols)
    for name in ("dn", "ez", "db", "cv", "kv"):
        np.testing.assert_array_equal(ours[name], theirs[name], err_msg=name)
    ref_stats.clear_memo()


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(DEVICE_CASES))
def test_device_function_on_the_card_equals_the_cpu(case):
    """The same device function on CUDA tensors: every output on the card, equal bit
    for bit to the CPU run (the same float32 operations, the same integer hash)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _ref_pipe, port_pipe = _both(DEVICE_CASES[case])
    cols = _columns(seed=len(case))
    cpu = _port_device(port_pipe, cols)
    card = port_pipe._device_call({k: torch.from_numpy(v.copy()).cuda()
                                   for k, v in cols.items()})
    for stage in port_pipe._plan:
        got = card[stage.out]
        assert got.is_cuda, stage.out
        np.testing.assert_array_equal(got.cpu().numpy(), cpu[stage.out], err_msg=stage.out)


def test_device_groups_stack_consecutive_independent_stages():
    """Consecutive hash stages, and consecutive dense chains of the same ops, run as one
    stacked group; a stage that reads what an earlier one of the run wrote, or another
    kind of stage, starts a new group."""
    _ref, pipe = _both(lambda m: [m.HashField("a", 10, out="ah"), m.HashField("b", 7, out="b"),
                                  m.HashField("b", 5, out="b2"),
                                  m.Standardize("x", mean=0, std=1, out="xs"),
                                  m.FillNull("xs", 0.0),
                                  m.Standardize("y", mean=0, std=2, out="ys"),
                                  m.FillNull("ys", 1.0), m.Clip("f", -1.0, 1.0),
                                  m.Bucketize("f", boundaries=[0.0], out="fb")])
    assert [[s.out for s in g.stages] for g in pipe._device_plan] == \
        [["ah", "b"], ["b2"], ["xs", "ys"], ["f"], ["fb"]]


def test_a_stacked_group_launches_each_operation_once(monkeypatch):
    """The 26 hashes of a Criteo row run as one stack: a fixed number of elementwise
    launches, not one set a column."""
    fields = {"c%d" % i: np.int32 for i in range(26)}
    _ref, pipe = _both(lambda m: [m.HashField("c%d" % i, 1000 + i, out="h%d" % i, seed=i)
                                  for i in range(26)], fields)
    assert len(pipe._device_plan) == 1
    cols = {k: np.arange(64, dtype=np.int32) * (i + 1) for i, k in enumerate(fields)}
    batch = {k: torch.from_numpy(v) for k, v in cols.items()}
    calls = []
    real_stack = torch.stack
    monkeypatch.setattr(torch, "stack", lambda *a, **k: calls.append(1) or real_stack(*a, **k))
    out = pipe._device_call(batch)
    assert len(calls) == 1
    host = pipe.apply_columns(cols)
    for i in range(26):
        np.testing.assert_array_equal(out["h%d" % i].numpy(), host["h%d" % i])
