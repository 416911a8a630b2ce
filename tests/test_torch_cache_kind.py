"""The cache funnel's key names the reader kind (ROADMAP Queue 3 AB).

A per-row reader caches a list of row dicts a row group and a batch reader a dict of
columns. The JAX package keys both the same way, so its batch reader is served the
per-row reader's payloads of the same store. The port's workers add their payload kind
to the key: each case reads one store with both reader kinds in one process through the
mem tier, the disk tier or both, in either order, and every read delivers what an
uncached read of the same reader kind delivers. A disk directory the JAX package's
per-row reader filled is a miss for the port's batch reader, never a wrong serve.

Comparison level: bit-exact (every value of every row, by id)."""
import decimal

import numpy as np
import pytest

pytest.importorskip("torch")

from _torch_pool_helpers import _no_leaked_shm_segments  # noqa: E402,F401
from test_common import create_test_dataset  # noqa: E402

import petastorm_tpu as ref  # noqa: E402
import petastorm_tpu_torch as port  # noqa: E402
from petastorm_tpu.io import memcache as ref_memcache  # noqa: E402
from petastorm_tpu_torch.io import memcache as port_memcache  # noqa: E402
from petastorm_tpu_torch.reader import _cache_key  # noqa: E402

ROWS = 24


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    url = "file://" + str(tmp_path_factory.mktemp("cache_kind") / "ds")
    create_test_dataset(url, num_rows=ROWS, rows_per_file=8)
    return url


@pytest.fixture(autouse=True)
def _clear_memcaches():
    port_memcache.shared_store().clear()
    ref_memcache.shared_store().clear()
    yield
    port_memcache.shared_store().clear()
    ref_memcache.shared_store().clear()


def _options(tiers, tmp_path):
    opts = dict(reader_pool_type="dummy", shuffle_row_groups=False, num_epochs=1)
    if "mem" in tiers:
        opts["io_options"] = dict(memcache_bytes=64 << 20)
    if "disk" in tiers:
        opts.update(cache_type="local-disk", cache_location=str(tmp_path / "disk"),
                    cache_size_limit=1 << 30)
    return opts


def _per_row(pkg, url, **opts):
    with pkg.make_reader(url, **opts) as reader:
        return {int(r.id): r._asdict() for r in reader}


def _per_batch(pkg, url, **opts):
    out = {}
    with pkg.make_batch_reader(url, **opts) as reader:
        for batch in reader:
            cols = batch._asdict()
            for j, i in enumerate(cols["id"]):
                out[int(i)] = {k: v[j] for k, v in cols.items()}
    return out


def _assert_same(got, want):
    assert sorted(got) == sorted(want) == list(range(ROWS))
    for i, row in want.items():
        assert sorted(got[i]) == sorted(row), i
        for name, value in row.items():
            other = got[i][name]
            if isinstance(value, (np.ndarray, np.generic)):
                assert np.asarray(other).dtype == np.asarray(value).dtype, (i, name)
                np.testing.assert_array_equal(np.asarray(other), np.asarray(value),
                                              err_msg="%s %s" % (i, name))
            else:
                assert isinstance(value, (str, bytes, decimal.Decimal, type(None), int))
                assert other == value, (i, name)


READS = {"row": _per_row, "batch": _per_batch}


@pytest.mark.parametrize("tiers", ["mem", "disk", "mem+disk"])
@pytest.mark.parametrize("first,second", [("row", "batch"), ("batch", "row")])
def test_both_reader_kinds_through_one_cache(store, tmp_path, tiers, first, second):
    """(a) per-row then batch and (b) batch then per-row on one url, one process: each
    read equals the uncached read of its own kind."""
    uncached = {kind: READS[kind](port, store, **_options("", tmp_path))
                for kind in (first, second)}
    opts = _options(tiers, tmp_path)
    _assert_same(READS[first](port, store, **opts), uncached[first])
    _assert_same(READS[second](port, store, **opts), uncached[second])
    # and the second kind's fills are cached under its own key: a third read is served
    _assert_same(READS[second](port, store, **opts), uncached[second])


@pytest.mark.parametrize("tiers", ["disk", "mem+disk"])
def test_reference_filled_disk_directory_is_a_miss(store, tmp_path, tiers):
    """(c) the JAX package's ``make_reader`` fills the disk directory; the port's
    ``make_batch_reader`` on it delivers what its uncached read delivers."""
    uncached = _per_batch(port, store, **_options("", tmp_path))
    opts = _options(tiers, tmp_path)
    ref_rows = _per_row(ref, store, **opts)
    assert sorted(ref_rows) == list(range(ROWS))
    assert any((tmp_path / "disk").rglob("*")), "the JAX read filled nothing"
    _assert_same(_per_batch(port, store, **opts), uncached)


def test_worker_keys_are_the_reference_key_plus_the_kind(store):
    """Without ``kind`` the module function is the JAX package's key string for string
    (``test_torch_io_async.py``); the workers' keys are that key plus ``|kind:...``, so
    no key of the port names a file the JAX package wrote."""
    with port.make_reader(store, reader_pool_type="dummy") as r_rows, \
            port.make_batch_reader(store, reader_pool_type="dummy") as r_cols:
        piece, partition = r_rows._plan._items[0]
        for reader, kind in ((r_rows, "rows"), (r_cols, "columns")):
            worker = reader._worker
            base = _cache_key(piece, worker._read_schema, None, None, partition, 1, None)
            assert worker._cache_key((piece, partition)) == base + "|kind:" + kind
