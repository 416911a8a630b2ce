"""The acceptance harnesses' deterministic parts against the JAX package's.

Every store a harness writes (``make_dataset``, ``_make_store``, ``_write_dataset``)
under the same seed and shape reads back with pyarrow equal to the JAX harness's: the
same file names, row groups and values. Beside them the pure functions the harnesses
hold their runs to: ``wire.expected_payload`` and the payload worker,
``tabular.pandas_twin`` and ``_fnv32_scalar``, the batch records of ``copies`` and
``tabular``, ``tenants.check_frames`` with the frames it checks, ``chaos._expected_ids
_for_entry``, the scenario tables of ``io`` and ``remote`` and ``fleet``'s synthetic
decodes. Nothing here times anything.
"""
import os
from collections import namedtuple

import numpy as np
import pyarrow.parquet as pq
import pytest

torch = pytest.importorskip("torch")

from _torch_pool_helpers import _no_leaked_shm_segments  # noqa: E402,F401
from _torch_pool_helpers import no_leaked_port_slabs  # noqa: E402,F401
from petastorm_tpu.benchmark import attribution as ref_attribution  # noqa: E402
from petastorm_tpu.benchmark import autotune as ref_autotune  # noqa: E402
from petastorm_tpu.benchmark import chaos as ref_chaos  # noqa: E402
from petastorm_tpu.benchmark import copies as ref_copies  # noqa: E402
from petastorm_tpu.benchmark import decompress as ref_decompress  # noqa: E402
from petastorm_tpu.benchmark import fleet as ref_fleet  # noqa: E402
from petastorm_tpu.benchmark import health as ref_health  # noqa: E402
from petastorm_tpu.benchmark import io as ref_io  # noqa: E402
from petastorm_tpu.benchmark import remote as ref_remote  # noqa: E402
from petastorm_tpu.benchmark import slo as ref_slo  # noqa: E402
from petastorm_tpu.benchmark import tabular as ref_tabular  # noqa: E402
from petastorm_tpu.benchmark import tenants as ref_tenants  # noqa: E402
from petastorm_tpu.benchmark import trend as ref_trend  # noqa: E402
from petastorm_tpu.benchmark import wire as ref_wire  # noqa: E402
from petastorm_tpu_torch.benchmark import attribution  # noqa: E402
from petastorm_tpu_torch.benchmark import autotune  # noqa: E402
from petastorm_tpu_torch.benchmark import chaos  # noqa: E402
from petastorm_tpu_torch.benchmark import copies  # noqa: E402
from petastorm_tpu_torch.benchmark import decompress  # noqa: E402
from petastorm_tpu_torch.benchmark import fleet  # noqa: E402
from petastorm_tpu_torch.benchmark import health  # noqa: E402
from petastorm_tpu_torch.benchmark import io as io_bench  # noqa: E402
from petastorm_tpu_torch.benchmark import remote  # noqa: E402
from petastorm_tpu_torch.benchmark import slo  # noqa: E402
from petastorm_tpu_torch.benchmark import tabular  # noqa: E402
from petastorm_tpu_torch.benchmark import tenants  # noqa: E402
from petastorm_tpu_torch.benchmark import trend  # noqa: E402
from petastorm_tpu_torch.benchmark import wire  # noqa: E402

#: (case, port writer, JAX writer, args after the root, does the writer make the root)
STORES = [
    ("decompress-eligible", decompress._make_store, ref_decompress._make_store,
     dict(rows=6_000, row_group_size=1_000, eligible=True), True),
    ("decompress-ineligible", decompress._make_store, ref_decompress._make_store,
     dict(rows=2_000, row_group_size=500, eligible=False), True),
    ("copies", copies.make_dataset, ref_copies.make_dataset,
     dict(rows=512, rows_per_group=32, files=2), False),
    ("io", io_bench.make_dataset, ref_io.make_dataset,
     dict(rows=256, row_bytes=512, rows_per_group=16, files=2), False),
    ("tabular", tabular.make_dataset, ref_tabular.make_dataset,
     dict(rows=1_024, rows_per_group=128, files=2), False),
    ("health", health._write_dataset, ref_health._write_dataset,
     dict(files=2, rows_per_file=2_000), False),
    ("chaos", chaos._write_dataset, ref_chaos._write_dataset,
     dict(files=3, rows_per_file=64), False),
    ("attribution", attribution._make_store, ref_attribution._make_store,
     dict(files=2, rows_per_file=256), False),
    ("slo", slo._make_store, ref_slo._make_store, dict(files=2, rows_per_file=256), False),
    ("autotune", autotune._make_store, ref_autotune._make_store,
     dict(files=2, row_groups=4, rows_per_group=32), False),
    ("tenants", tenants._make_store, ref_tenants._make_store,
     dict(files=2, rows_per_file=256), False),
    ("trend", trend._make_store, ref_trend._make_store,
     dict(files=2, rows_per_file=512), False),
]


def _read_store(root):
    out = {}
    for name in sorted(os.listdir(root)):
        pf = pq.ParquetFile(os.path.join(root, name))
        out[name] = ([pf.metadata.row_group(i).num_rows
                      for i in range(pf.metadata.num_row_groups)], pf.read())
    return out


@pytest.mark.parametrize("case,ours,theirs,kwargs,makes_root", STORES,
                         ids=[s[0] for s in STORES])
def test_harness_store_equals_the_reference(tmp_path, case, ours, theirs, kwargs,
                                            makes_root):
    roots = [str(tmp_path / "port"), str(tmp_path / "ref")]
    for fn, root in zip((ours, theirs), roots):
        if not makes_root:
            os.makedirs(root)
        fn(root, **kwargs)
    a, b = (_read_store(r) for r in roots)
    assert list(a) == list(b) and a
    for name in a:
        assert a[name][0] == b[name][0], (case, name)
        assert a[name][1].equals(b[name][1]), (case, name)


def test_wire_payloads_equal_the_reference():
    assert wire.WIRE_COPIES == ref_wire.WIRE_COPIES
    assert wire.DEFAULT_WIRES == ref_wire.DEFAULT_WIRES
    for nbytes, idx in ((1, 0), (4096, 250), (65536, 251), (3, 1000)):
        np.testing.assert_array_equal(wire.expected_payload(nbytes, idx),
                                      ref_wire.expected_payload(nbytes, idx))
        ours = wire._PayloadWorker()((nbytes, idx))
        theirs = ref_wire._PayloadWorker()((nbytes, idx))
        assert ours[:2] == theirs[:2]
        np.testing.assert_array_equal(ours[2]["x"], theirs[2]["x"])
        assert ours[2]["x"].dtype == theirs[2]["x"].dtype


def test_fnv32_scalar_equals_the_reference():
    rng = np.random.default_rng(5)
    values = list(rng.integers(-(1 << 62), 1 << 62, 200)) + [0, 1, -1, 2 ** 63 - 1]
    for seed in (0, 7, 0xFFFF):
        assert [tabular._fnv32_scalar(v, seed) for v in values] == \
            [ref_tabular._fnv32_scalar(v, seed) for v in values]


def test_pandas_twin_equals_the_reference(tmp_path):
    pd = pytest.importorskip("pandas")
    root = str(tmp_path / "tab")
    os.makedirs(root)
    tabular.make_dataset(root, 1_024, 256, files=2)
    df = pq.read_table(root).to_pandas()
    ours = tabular.pandas_twin(df.copy())
    theirs = ref_tabular.pandas_twin(df.copy())
    pd.testing.assert_frame_equal(ours, theirs, check_exact=True)
    assert [f[0] for f in tabular.build_pandas_spec().edit_fields] == \
        [f[0] for f in ref_tabular.build_pandas_spec().edit_fields]
    ours_ops = [type(op).__name__ for op in tabular.build_pipeline().ops]
    theirs_ops = [type(op).__name__ for op in ref_tabular.build_pipeline().ops]
    assert ours_ops == theirs_ops


def test_batch_records_equal_the_reference():
    rng = np.random.default_rng(3)
    batch = {"id": rng.permutation(64).astype(np.int64),
             "f0": rng.standard_normal(64), "c0": rng.integers(0, 9, 64),
             "s": np.array(["x%d" % i for i in range(64)], dtype=object)}
    assert copies._batch_record(batch) == ref_copies._batch_record(batch)
    assert tabular._batch_record(batch) == ref_tabular._batch_record(batch)


def test_tenant_frames_equal_the_reference():
    from petastorm_tpu.transport import framing as ref_framing
    from petastorm_tpu_torch.transport import framing

    tenants.check_frames()
    ref_tenants.check_frames()
    payload = b"row-group-result-bytes"
    for tenant in (None, tenants.NOISY, tenants.QUIET):
        assert framing.pack_frame(framing.K_OBJ, payload, tenant=tenant) == \
            ref_framing.pack_frame(ref_framing.K_OBJ, payload, tenant=tenant)


def test_chaos_expected_ids_for_entry_equal_the_reference():
    Entry = namedtuple("Entry", "path row_group")
    for name in ("part_000.parquet", "part_007.parquet", "part_zz0.parquet",
                 "part_015.parquet"):
        entry = Entry("/some/store/" + name, 0)
        assert chaos._expected_ids_for_entry(entry, 64, 16) == \
            ref_chaos._expected_ids_for_entry(entry, 64, 16)
    assert chaos._REWRITE_BASE == ref_chaos._REWRITE_BASE


def test_read_path_scenario_tables_equal_the_reference(tmp_path):
    assert io_bench.SCENARIOS == ref_io.SCENARIOS
    assert io_bench._SCENARIO_OPTS == ref_io._SCENARIO_OPTS
    assert remote.SCENARIOS == ref_remote.SCENARIOS
    assert remote.PROFILE == ref_remote.PROFILE
    for scenario in remote.SCENARIOS:
        assert remote._scenario_config(scenario, 64, 8) == \
            ref_remote._scenario_config(scenario, 64, 8)
    lat = list(np.random.default_rng(2).random(101))
    assert remote._p99(lat) == ref_remote._p99(lat) and remote._p99([]) == 0.0
    root = str(tmp_path / "io")
    os.makedirs(root)
    io_bench.make_dataset(root, 128, 256, 16, files=2)
    sizes = {os.path.join(root, n): os.path.getsize(os.path.join(root, n))
             for n in os.listdir(root)}
    assert remote._footer_windows(sizes) == ref_remote._footer_windows(sizes)


def test_fleet_decodes_equal_the_reference():
    for fn in ("decode_shared", "decode_quiet"):
        for item in (0, 5, 11):
            np.testing.assert_array_equal(getattr(fleet, fn)(item)["id"],
                                          getattr(ref_fleet, fn)(item)["id"])
    assert list(fleet.SCHEMA.fields) == list(ref_fleet.SCHEMA.fields)
    assert (fleet.ROWS_PER_ITEM, fleet.DECODE_COST_S, fleet.NOISY_COST_S) == \
        (ref_fleet.ROWS_PER_ITEM, ref_fleet.DECODE_COST_S, ref_fleet.NOISY_COST_S)
    assert sorted(fleet.SCENARIOS) == sorted(ref_fleet.SCENARIOS)
    assert fleet.DEFAULT_SCENARIOS == ref_fleet.DEFAULT_SCENARIOS
