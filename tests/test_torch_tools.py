"""Port vs reference: the dataset tools (``petastorm_tpu_torch.tools``) on stores made
from a numpy seed.

``tests/test_tools.py``'s copy and metadata cases run against the port, and each is
held against the JAX package's tool on the same source: a copy made by the port has the
rows and the ``_common_metadata`` key-value bytes of the JAX package's copy (projection,
null filtering and repartitioning included), and ``generate_metadata`` writes the same
bytes, also over a store that carried only the reference petastorm's pickled keys.
"""
import os
import shutil
import subprocess
import sys

import numpy as np
import pyarrow.parquet as pq
import pytest

torch = pytest.importorskip("torch")

from _torch_pool_helpers import _no_leaked_shm_segments  # noqa: E402,F401
from _torch_pool_helpers import no_leaked_port_slabs  # noqa: E402,F401
from petastorm_tpu.tools import copy_dataset as ref_copy  # noqa: E402
from petastorm_tpu.tools import generate_metadata as ref_gen  # noqa: E402
from petastorm_tpu_torch import make_batch_reader, make_reader  # noqa: E402
from petastorm_tpu_torch.tools import copy_dataset as port_copy  # noqa: E402
from petastorm_tpu_torch.tools import generate_metadata as port_gen  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = 30


@pytest.fixture(scope="module")
def source(tmp_path_factory):
    """The JAX test schema's 30 rows (numpy seed 24; ``nullable_str`` None in every
    fourth row) in three files."""
    from test_common import create_test_dataset

    return create_test_dataset("file://" + str(tmp_path_factory.mktemp("torch_tools") / "ds"),
                               num_rows=ROWS, seed=24)


@pytest.fixture(scope="module")
def vanilla(tmp_path_factory):
    from test_common import create_test_scalar_dataset

    return create_test_scalar_dataset(
        "file://" + str(tmp_path_factory.mktemp("torch_tools") / "scalar"), num_rows=ROWS,
        seed=25)


def _kv(path):
    return dict(pq.read_schema(os.path.join(path, "_common_metadata")).metadata)


def _table(path):
    files = sorted(f for f in os.listdir(path) if f.endswith(".parquet"))
    return [(f, pq.read_table(os.path.join(path, f))) for f in files]


def _assert_same_copy(ours, theirs):
    """Two copies: the same files, row groups, rows and metadata key-value bytes."""
    assert _kv(ours) == _kv(theirs)
    a, b = _table(ours), _table(theirs)
    assert [f for f, _t in a] == [f for f, _t in b]
    for (_f, ta), (_g, tb) in zip(a, b):
        assert ta.equals(tb)
    for f, _t in a:
        assert pq.ParquetFile(os.path.join(ours, f)).metadata.num_row_groups \
            == pq.ParquetFile(os.path.join(theirs, f)).metadata.num_row_groups


@pytest.mark.parametrize("kwargs", [
    {}, {"field_regex": ["id$", "matrix"]}, {"not_null_fields": ["nullable_str"]},
    {"partitions_count": 2},
], ids=["full", "projection", "not_null", "partitions"])
def test_a_port_copy_equals_the_reference_copy(tmp_path, source, kwargs):
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    n = port_copy.copy_dataset(source.url, "file://" + ours, **kwargs)
    assert n == ref_copy.copy_dataset(source.url, "file://" + theirs, **kwargs)
    _assert_same_copy(ours, theirs)
    want = [d for d in source.data
            if not kwargs.get("not_null_fields") or d["nullable_str"] is not None]
    assert n == len(want)
    with make_reader("file://" + ours, shuffle_row_groups=False,
                     reader_pool_type="dummy") as reader:
        rows = list(reader)
    assert sorted(r.id for r in rows) == sorted(d["id"] for d in want)
    if "field_regex" in kwargs:
        assert set(rows[0]._fields) <= {"id", "matrix", "matrix_compressed"}
        assert "sensor_name" not in rows[0]._fields
    by_id = {d["id"]: d for d in want}
    for r in rows:
        np.testing.assert_array_equal(r.matrix, by_id[r.id]["matrix"])


def test_copy_dataset_full(tmp_path, source):
    target = "file://" + str(tmp_path / "copy")
    n = port_copy.copy_dataset(source.url, target)
    assert n == len(source.data)
    with make_reader(target, shuffle_row_groups=False) as reader:
        rows = list(reader)
    assert len(rows) == len(source.data)
    assert {r.id for r in rows} == {d["id"] for d in source.data}


def test_copy_dataset_refuses_nonempty(tmp_path, source):
    target = "file://" + str(tmp_path / "dup")
    port_copy.copy_dataset(source.url, target)
    for copy in (port_copy.copy_dataset, ref_copy.copy_dataset):
        with pytest.raises(ValueError, match="non-empty"):
            copy(source.url, target)
    assert port_copy.copy_dataset(source.url, target, overwrite_output=True) == ROWS
    with pytest.raises(ValueError, match="matched no fields"):
        port_copy.copy_dataset(source.url, "file://" + str(tmp_path / "none"),
                               field_regex=["^nothing$"])


def test_copy_dataset_cli_main(tmp_path, source):
    ours, theirs = str(tmp_path / "cli_ours"), str(tmp_path / "cli_theirs")
    port_copy.main([source.url, "file://" + ours, "--field-regex", "id", "sensor_name",
                    "--partitions-count", "1"])
    ref_copy.main([source.url, "file://" + theirs, "--field-regex", "id", "sensor_name",
                   "--partitions-count", "1"])
    _assert_same_copy(ours, theirs)
    with make_reader("file://" + ours, shuffle_row_groups=False) as reader:
        assert len(list(reader)) == len(source.data)


def test_generate_metadata_cli(tmp_path, vanilla):
    """A vanilla parquet dir gains ``_common_metadata`` so make_reader can open it; the
    bytes equal the JAX package's."""
    ours, theirs = str(tmp_path / "gen_ours"), str(tmp_path / "gen_theirs")
    shutil.copytree(vanilla.path, ours)
    shutil.copytree(vanilla.path, theirs)
    schema = port_gen.generate_metadata("file://" + ours)
    ref_gen.generate_metadata("file://" + theirs)
    assert "id" in schema.fields
    assert _kv(ours) == _kv(theirs)
    with make_reader("file://" + ours, shuffle_row_groups=False) as reader:
        rows = list(reader)
    assert len(rows) == ROWS
    port_gen.main(["file://" + ours, "--no-summary-metadata"])
    ref_gen.main(["file://" + theirs, "--no-summary-metadata"])
    assert _kv(ours) == _kv(theirs)
    assert port_gen.generate_petastorm_metadata is port_gen.generate_metadata


def test_generate_metadata_turns_reference_keys_into_json(tmp_path, source):
    """A store with only the reference petastorm's pickled keys gets the JSON keys, the
    same bytes as the JAX package writes."""
    import pickle

    from test_torch_compat import _fake_modules, _reference_schema_pickle
    from test_common import TestSchema

    ours, theirs = str(tmp_path / "ref_ours"), str(tmp_path / "ref_theirs")
    for d in (ours, theirs):
        shutil.copytree(source.path, d)
        arrow_schema = pq.read_schema(os.path.join(d, "_common_metadata")).remove_metadata()
        pq.write_metadata(arrow_schema.with_metadata({
            b"dataset-toolkit.unischema.v1": _reference_schema_pickle(_fake_modules(),
                                                                      TestSchema),
            b"dataset-toolkit.num_row_groups_per_file.v1": pickle.dumps(
                {"part-00000.parquet": 1}, protocol=2)}), os.path.join(d, "_common_metadata"))
    port_gen.generate_metadata("file://" + ours)
    ref_gen.generate_metadata("file://" + theirs)
    kv = _kv(ours)
    assert kv == _kv(theirs)
    assert b"petastorm_tpu.unischema.json.v1" in kv
    with make_batch_reader("file://" + ours, schema_fields=["id"],
                           reader_pool_type="dummy") as reader:
        assert sorted(int(i) for b in reader for i in b.id) == list(range(ROWS))


@pytest.mark.parametrize("script,module", [
    ("petastorm-tpu-torch-copy-dataset", "petastorm_tpu_torch.tools.copy_dataset:main"),
    ("petastorm-tpu-torch-generate-metadata",
     "petastorm_tpu_torch.tools.generate_metadata:main"),
])
def test_console_scripts_name_the_port_tools(script, module):
    with open(os.path.join(ROOT, "setup.py")) as f:
        text = f.read()
    assert '"%s="' % script in text or '"%s=%s"' % (script, module) in text
    assert module in text


def test_the_tools_run_as_modules(tmp_path, source):
    target = "file://" + str(tmp_path / "as_module")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-m", "petastorm_tpu_torch.tools.copy_dataset",
                          source.url, target], env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    with make_batch_reader(target, schema_fields=["id"], reader_pool_type="dummy") as r:
        assert sorted(int(i) for b in r for i in b.id) == list(range(ROWS))
