"""Port vs reference: row-group indexes and ``rowgroup_selector``. An index built by
the port is read by the JAX package and the other way round (same key-value key and
payload); union and intersect selectors select the reference's row groups; a selector
composed with a predicate and sharding delivers the reference's rows."""
import numpy as np
import pytest

from _torch_pool_helpers import _no_leaked_shm_segments  # noqa: F401

pytest.importorskip("torch")

from petastorm_tpu import metadata as ref_metadata  # noqa: E402
from petastorm_tpu import reader as ref_reader  # noqa: E402
from petastorm_tpu import selectors as ref_selectors  # noqa: E402
from petastorm_tpu import types as ref_types  # noqa: E402
from petastorm_tpu.codecs import ScalarCodec as RefScalar  # noqa: E402
from petastorm_tpu.etl import rowgroup_indexing as ref_indexing  # noqa: E402
from petastorm_tpu.predicates import in_set as ref_in_set  # noqa: E402
from petastorm_tpu.unischema import Unischema as RefSchema  # noqa: E402
from petastorm_tpu.unischema import UnischemaField as RefField  # noqa: E402
from petastorm_tpu_torch import metadata, selectors, types  # noqa: E402
from petastorm_tpu_torch import reader as port_reader  # noqa: E402
from petastorm_tpu_torch.codecs import ScalarCodec  # noqa: E402
from petastorm_tpu_torch.etl import rowgroup_indexing as indexing  # noqa: E402
from petastorm_tpu_torch.fs import get_filesystem_and_path_or_paths  # noqa: E402
from petastorm_tpu_torch.predicates import in_set  # noqa: E402
from petastorm_tpu_torch.unischema import Unischema, UnischemaField  # noqa: E402

ROWS, ROWS_PER_FILE = 96, 12


def _rows():
    rng = np.random.RandomState(11)
    for i in range(ROWS):
        yield {"id": i, "user": int((i // ROWS_PER_FILE + rng.randint(0, 2)) % 9),
               "country": "c%d" % (i // 30)}


def _write(which, url):
    if which == "port":
        schema = Unischema("Sel", [
            UnischemaField("id", np.int64, (), ScalarCodec(types.LongType()), False),
            UnischemaField("user", np.int32, (), ScalarCodec(types.IntegerType()), False),
            UnischemaField("country", np.str_, (), ScalarCodec(types.StringType()), False)])
        metadata.write_dataset(url, schema, _rows(), rows_per_file=ROWS_PER_FILE)
    else:
        schema = RefSchema("Sel", [
            RefField("id", np.int64, (), RefScalar(ref_types.LongType()), False),
            RefField("user", np.int32, (), RefScalar(ref_types.IntegerType()), False),
            RefField("country", np.str_, (), RefScalar(ref_types.StringType()), False)])
        ref_metadata.write_dataset(url, schema, _rows(), rows_per_file=ROWS_PER_FILE)


def _indexers(mod):
    return [mod.SingleFieldIndexer("by_user", "user"),
            mod.SingleFieldIndexer("by_country", "country")]


@pytest.fixture(scope="module", params=["port_built", "reference_built"])
def indexed_store(request, tmp_path_factory):
    """A 96-row store in 8 files of one row group, written and indexed by one package."""
    url = "file://" + str(tmp_path_factory.mktemp("torch_sel") / "ds")
    if request.param == "port_built":
        _write("port", url)
        indexing.build_rowgroup_index(url, _indexers(indexing))
    else:
        _write("ref", url)
        ref_indexing.build_rowgroup_index(url, _indexers(ref_indexing))
    return url


def _indexes(url):
    fs, path = get_filesystem_and_path_or_paths(url)
    return indexing.get_row_group_indexes(fs, path), \
        ref_indexing.get_row_group_indexes(fs, path)


def test_index_is_read_by_both_packages(indexed_store):
    got, want = _indexes(indexed_store)
    assert sorted(got) == sorted(want) == ["by_country", "by_user"]
    for name in got:
        assert got[name].index_field == want[name].index_field
        assert got[name].to_jsonable() == want[name].to_jsonable()
        assert got[name].indexed_values == want[name].indexed_values
        for value in want[name].indexed_values + ["absent"]:
            assert got[name].get_row_group_indexes(value) == \
                want[name].get_row_group_indexes(value)
        assert got[name].get_row_group_indexes() == want[name].get_row_group_indexes()


SELECTORS = {
    "single": lambda m: m.SingleIndexSelector("by_user", [3, 7]),
    "single_str": lambda m: m.SingleIndexSelector("by_country", ["c1"]),
    "union": lambda m: m.UnionIndexSelector([m.SingleIndexSelector("by_user", [1]),
                                             m.SingleIndexSelector("by_country", ["c3"])]),
    "intersect": lambda m: m.IntersectIndexSelector([
        m.SingleIndexSelector("by_user", [2]), m.SingleIndexSelector("by_country", ["c0"])]),
    "intersect_empty_child": lambda m: m.IntersectIndexSelector([
        m.SingleIndexSelector("by_user", [2]), m.SingleIndexSelector("by_country", ["zz"])]),
}


@pytest.mark.parametrize("name", sorted(SELECTORS))
def test_selectors_select_the_references_row_groups(indexed_store, name):
    got_idx, want_idx = _indexes(indexed_store)
    port_sel, ref_sel = SELECTORS[name](selectors), SELECTORS[name](ref_selectors)
    assert port_sel.get_index_names() == ref_sel.get_index_names()
    got = port_sel.select_row_groups(got_idx)
    assert got == ref_sel.select_row_groups(want_idx)
    # crossed: each package's selector over the other package's loaded index
    assert got == port_sel.select_row_groups(want_idx) == ref_sel.select_row_groups(got_idx)


def _ids(module, url, **kwargs):
    with module.make_reader(url, reader_pool_type="dummy", shuffle_row_groups=False,
                            **kwargs) as r:
        return sorted(int(row.id) for row in r)


@pytest.mark.parametrize("name", ["single", "union", "intersect"])
def test_make_reader_with_a_selector_delivers_the_references_rows(indexed_store, name):
    got = _ids(port_reader, indexed_store, rowgroup_selector=SELECTORS[name](selectors))
    want = _ids(ref_reader, indexed_store, rowgroup_selector=SELECTORS[name](ref_selectors))
    assert got == want and 0 < len(got) < ROWS


@pytest.mark.parametrize("shard", [0, 1, 2])
def test_selector_predicate_and_shard_composed(indexed_store, shard):
    kw = dict(cur_shard=shard, shard_count=3, shard_seed=5)
    got = _ids(port_reader, indexed_store, predicate=in_set({3, 7}, "user"),
               rowgroup_selector=selectors.SingleIndexSelector("by_user", [3, 7]), **kw)
    want = _ids(ref_reader, indexed_store, predicate=ref_in_set({3, 7}, "user"),
                rowgroup_selector=ref_selectors.SingleIndexSelector("by_user", [3, 7]), **kw)
    assert got == want
    rows = list(_rows())
    assert all(rows[i]["user"] in (3, 7) for i in got)


def test_unknown_index_and_unindexed_store_raise_like_the_reference(indexed_store, tmp_path):
    with pytest.raises(ValueError, match="no index named") as err:
        port_reader.make_reader(indexed_store,
                                rowgroup_selector=selectors.SingleIndexSelector("nope", [1]))
    with pytest.raises(ValueError) as ref_err:
        ref_reader.make_reader(indexed_store,
                               rowgroup_selector=ref_selectors.SingleIndexSelector("nope", [1]))
    assert str(err.value) == str(ref_err.value)
    url = "file://" + str(tmp_path / "plain")
    _write("port", url)
    with pytest.raises(ValueError, match="no row-group index"):
        port_reader.make_reader(url,
                                rowgroup_selector=selectors.SingleIndexSelector("by_user", [1]))
