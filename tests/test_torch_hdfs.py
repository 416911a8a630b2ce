"""Port vs reference: HDFS namenode HA (``petastorm_tpu_torch.hdfs``) and the ``hdfs://``
branch of the port's URL resolution, with no cluster.

The cases are ``tests/test_hdfs_ha.py``'s, each run on both packages' modules with the
same scripted namenodes: the same config resolves to the same namenode lists, the same
failures rotate the same connections, and exhaustion raises ``MaxFailoversExceeded``
with the same attributes. A port reader whose filesystem is the port's ``HAHdfsClient``
keeps delivering across a namenode flip, as the JAX package's does; ``hdfs://`` URLs
reach ``pyarrow.fs.HadoopFileSystem`` with the arguments ``tests/test_fs.py`` holds
the JAX package to.
"""
import threading
import time

import numpy as np
import pyarrow.fs as pafs
import pytest

torch = pytest.importorskip("torch")

from _torch_pool_helpers import _no_leaked_shm_segments  # noqa: E402,F401
from _torch_pool_helpers import no_leaked_port_slabs  # noqa: E402,F401
from petastorm_tpu import fs as ref_fs  # noqa: E402
from petastorm_tpu import hdfs as ref_hdfs  # noqa: E402
from petastorm_tpu_torch import fs as port_fs  # noqa: E402
from petastorm_tpu_torch import hdfs as port_hdfs  # noqa: E402

BOTH = [port_hdfs, ref_hdfs]

CONFIG = {
    "fs.defaultFS": "hdfs://nameservice1",
    "dfs.nameservices": "nameservice1,ns2",
    "dfs.ha.namenodes.nameservice1": "nn1,nn2",
    "dfs.namenode.rpc-address.nameservice1.nn1": "namenode-a:8020",
    "dfs.namenode.rpc-address.nameservice1.nn2": "namenode-b:8020",
    "dfs.ha.namenodes.ns2": "x",
    "dfs.namenode.rpc-address.ns2.x": "single:9000",
}


def _write_site(d, name, props):
    body = "".join(
        "<property><name>%s</name><value>%s</value></property>" % kv
        for kv in props.items())
    (d / name).write_text("<configuration>%s</configuration>" % body)


# -- config parsing ---------------------------------------------------------------------


def test_read_hadoop_config_merges_sites(tmp_path):
    _write_site(tmp_path, "core-site.xml", {"fs.defaultFS": "hdfs://ns", "a": "core"})
    _write_site(tmp_path, "hdfs-site.xml", {"a": "hdfs", "dfs.nameservices": "ns"})
    ours = port_hdfs.read_hadoop_config(str(tmp_path))
    assert ours == ref_hdfs.read_hadoop_config(str(tmp_path))
    assert ours["fs.defaultFS"] == "hdfs://ns"
    assert ours["a"] == "hdfs"  # hdfs-site wins (Hadoop load order)


def test_read_hadoop_config_env_discovery(tmp_path, monkeypatch):
    _write_site(tmp_path, "hdfs-site.xml", {"k": "v"})
    monkeypatch.setenv("HADOOP_CONF_DIR", str(tmp_path))
    assert port_hdfs.read_hadoop_config()["k"] == "v"
    assert port_hdfs.read_hadoop_config() == ref_hdfs.read_hadoop_config()


# -- resolver ---------------------------------------------------------------------------


def test_resolver_nameservice_to_namenodes():
    for mod in BOTH:
        r = mod.HdfsNamenodeResolver(config=CONFIG)
        assert r.nameservices == ["nameservice1", "ns2"]
        assert r.resolve_hdfs_name_service("nameservice1") == [
            ("namenode-a", 8020), ("namenode-b", 8020)]
        assert r.resolve_hdfs_name_service("ns2") == [("single", 9000)]
        assert r.resolve_hdfs_name_service("not-a-service") is None


def test_resolver_default_service():
    got = [mod.HdfsNamenodeResolver(config=CONFIG).resolve_default_hdfs_service()
           for mod in BOTH]
    assert got[0] == got[1] == ("nameservice1", [("namenode-a", 8020), ("namenode-b", 8020)])


def test_resolver_declared_but_unresolvable_raises():
    for mod in BOTH:
        r = mod.HdfsNamenodeResolver(config={"dfs.nameservices": "broken"})
        with pytest.raises(ValueError, match="broken"):
            r.resolve_hdfs_name_service("broken")


# -- failover client --------------------------------------------------------------------


class _FakeFS:
    """Stands in for pyarrow HadoopFileSystem; scripted to fail until told not to."""

    def __init__(self, host, port, fail=False):
        self.host, self.port, self.fail = host, port, fail
        self.calls = []

    def get_file_info(self, path):
        self.calls.append(path)
        if self.fail:
            raise OSError("Operation category READ is not supported in state standby")
        return "info@%s:%s" % (self.host, self.port)

    def open_missing(self, path):
        raise FileNotFoundError(path)

    type_name = "hdfs"  # non-callable attribute passthrough


def _factory(behaviors):
    """behaviors: {host: fail_bool-or-callable}; records every connection made."""
    made = []

    def connect(host, port, storage_options=None):
        fail = behaviors[host]
        fs = _FakeFS(host, port, fail=fail() if callable(fail) else fail)
        made.append(fs)
        return fs

    return connect, made


def test_failover_rotates_to_healthy_namenode():
    seen = []
    for mod in BOTH:
        connect, made = _factory({"namenode-a": True, "namenode-b": False})
        client = mod.HAHdfsClient([("namenode-a", 8020), ("namenode-b", 8020)],
                                  connect=connect)
        assert client.get_file_info("/x") == "info@namenode-b:8020"
        assert [fs.host for fs in made] == ["namenode-a", "namenode-b"]  # reconnected
        # later calls stick to the healthy namenode: no reconnect churn
        assert client.get_file_info("/y") == "info@namenode-b:8020"
        seen.append([(fs.host, fs.calls) for fs in made])
    assert seen[0] == seen[1]


def test_failover_exhaustion_raises_max_failovers():
    for mod in BOTH:
        connect, made = _factory({"a": True, "b": True})
        client = mod.HAHdfsClient([("a", 1), ("b", 2)], connect=connect)
        with pytest.raises(mod.MaxFailoversExceeded) as ei:
            client.get_file_info("/x")
        err = ei.value
        assert err.func_name == "get_file_info"
        assert err.max_failover_attempts == mod.HAHdfsClient.MAX_FAILOVER_ATTEMPTS * 2 == 4
        assert len(err.failed_exceptions) == err.max_failover_attempts
        assert isinstance(err.__cause__, OSError) and isinstance(err, RuntimeError)
        assert [fs.host for fs in made] == ["a", "b", "a", "b"]


def test_real_answers_are_not_failovers():
    for mod in BOTH:
        connect, made = _factory({"a": False, "b": False})
        client = mod.HAHdfsClient([("a", 1), ("b", 2)], connect=connect)
        with pytest.raises(FileNotFoundError):
            client.open_missing("/gone")
        assert len(made) == 1  # no rotation on a genuine FileNotFoundError
    assert port_hdfs._NON_RETRYABLE == ref_hdfs._NON_RETRYABLE


def test_mid_epoch_flip_recovers():
    """The active namenode flips between calls mid-epoch; the next call must rotate and
    succeed instead of killing the read."""
    for mod in BOTH:
        state = {"a_fails": False}
        connect, made = _factory({"a": lambda: state["a_fails"], "b": False})
        client = mod.HAHdfsClient([("a", 1), ("b", 2)], connect=connect)
        assert client.get_file_info("/1") == "info@a:1"  # a is active
        made[0].fail = True  # flip: a goes standby; the cached connection now raises
        state["a_fails"] = True
        assert client.get_file_info("/2") == "info@b:2"  # rotated, no exception


def test_non_callable_attributes_pass_through():
    for mod in BOTH:
        connect, _ = _factory({"a": False})
        client = mod.HAHdfsClient([("a", 1)], connect=connect)
        assert client.type_name == "hdfs"
        with pytest.raises(AttributeError):
            client._private
    with pytest.raises(ValueError, match="at least one namenode"):
        port_hdfs.HAHdfsClient([])


# -- connect_hdfs dispatch --------------------------------------------------------------


def test_connect_hdfs_nameservice_returns_ha_client():
    for mod in BOTH:
        resolver = mod.HdfsNamenodeResolver(config=CONFIG)
        connect, _ = _factory({"namenode-a": False, "namenode-b": False})
        fs = mod.connect_hdfs("nameservice1", None, resolver=resolver, connect=connect)
        assert isinstance(fs, mod.HAHdfsClient)
        assert fs._namenodes == [("namenode-a", 8020), ("namenode-b", 8020)]


def test_connect_hdfs_no_authority_uses_default_service():
    for mod in BOTH:
        resolver = mod.HdfsNamenodeResolver(config=CONFIG)
        connect, _ = _factory({"namenode-a": False, "namenode-b": False})
        fs = mod.connect_hdfs(None, None, resolver=resolver, connect=connect)
        assert isinstance(fs, mod.HAHdfsClient)
        assert fs.get_file_info("/p") == "info@namenode-a:8020"


def test_connect_hdfs_explicit_hostport_is_plain():
    for mod in BOTH:
        connect, made = _factory({"nn": False})
        fs = mod.connect_hdfs("nn", 9000, connect=connect)
        assert isinstance(fs, _FakeFS)
        assert (fs.host, fs.port) == ("nn", 9000)


def test_connect_hdfs_single_namenode_service_is_plain():
    for mod in BOTH:
        resolver = mod.HdfsNamenodeResolver(config=CONFIG)
        connect, _ = _factory({"single": False})
        fs = mod.connect_hdfs("ns2", None, resolver=resolver, connect=connect)
        assert isinstance(fs, _FakeFS)  # one namenode: nothing to fail over to
        assert (fs.host, fs.port) == ("single", 9000)


def test_connect_hdfs_unknown_authority_delegates_to_libhdfs():
    for mod in BOTH:
        resolver = mod.HdfsNamenodeResolver(config=CONFIG)
        connect, made = _factory({"plain-host": False})
        fs = mod.connect_hdfs("plain-host", None, resolver=resolver, connect=connect)
        assert isinstance(fs, _FakeFS)
        assert fs.host == "plain-host" and fs.port == 0


# -- end to end through a reader (an HA client over a real local filesystem) ------------


def _flaky_store(tmp_path):
    import pyarrow as pa
    import pyarrow.parquet as pq

    ds = tmp_path / "ds"
    ds.mkdir()
    for f in range(4):
        ids = np.arange(f * 10, (f + 1) * 10, dtype=np.int64)
        pq.write_table(pa.table({"id": ids}), str(ds / ("p%d.parquet" % f)),
                       row_group_size=5)
    return str(ds)


class FlakyLocalFS:
    """A LocalFileSystem facade that can be flipped into 'standby' failure mode."""

    def __init__(self, host, port):
        self._fs = pafs.LocalFileSystem()
        self.host = host
        self.standby = False

    def __getattr__(self, name):
        # pyarrow-faithful: errors surface when the method is CALLED
        target = getattr(self.__dict__["_fs"], name)
        if not callable(target):
            return target

        def wrapped(*a, **k):
            if self.__dict__.get("standby"):
                raise OSError("state standby (%s)" % self.__dict__["host"])
            return target(*a, **k)

        return wrapped


def _read_across_a_flip(mod, factory, worker_base, path, monkeypatch):
    """Two epochs through ``factory`` over ``mod``'s HA client; the active namenode
    flips at the end of the first. Returns (ids seen, connections made)."""
    monkeypatch.setattr(worker_base, "MAX_OPEN_FILES", 1)
    made = []

    def connect(host, port, storage_options=None):
        fs = FlakyLocalFS(host, port)
        made.append(fs)
        return fs

    client = mod.HAHdfsClient([("nn-a", 1), ("nn-b", 2)], connect=connect)
    seen = []
    flipped = False
    with factory("hdfs://ignored" + path, filesystem=client, shuffle_row_groups=False,
                 num_epochs=2, reader_pool_type="dummy", workers_count=1) as reader:
        for batch in reader:
            seen.extend(np.asarray(batch.id).tolist())
            if not flipped and len(seen) >= 40:  # end of epoch 1
                made[0].standby = True  # the active namenode flips
                flipped = True
    assert flipped
    return seen, made


def test_reader_survives_namenode_flip_mid_epoch(tmp_path, monkeypatch):
    """A reader whose filesystem is an ``HAHdfsClient`` keeps delivering rows when the
    active namenode's connection starts failing mid-epoch. ``MAX_OPEN_FILES`` is pinned
    to 1 so the worker's open-file cache cannot serve every read from connections opened
    before the flip."""
    from petastorm_tpu import reader as ref_reader
    from petastorm_tpu_torch import reader as port_reader

    path = _flaky_store(tmp_path)
    ours, made = _read_across_a_flip(port_hdfs, port_reader.make_batch_reader,
                                     port_reader._WorkerBase, path, monkeypatch)
    assert sorted(ours) == sorted(list(range(40)) * 2)  # both epochs complete
    assert len(made) >= 2  # a failover connection was made
    theirs, _made = _read_across_a_flip(ref_hdfs, ref_reader.make_batch_reader,
                                        ref_reader._WorkerBase, path, monkeypatch)
    assert ours == theirs  # the same rows in the same order


def test_concurrent_failover_rotates_once():
    """A burst of simultaneous errors from reader threads rotates the namenode ONCE
    (guarded by the failed connection), not once a thread: N rotations mod 2 would land
    back on the dead namenode."""

    class SlowFailFS:
        def __init__(self, host, fail):
            self.host, self.fail = host, fail

        def get_file_info(self, path):
            if self.fail:
                time.sleep(0.05)  # widen the race window
                raise OSError("standby")
            return "info@%s" % self.host

    for mod in BOTH:
        connects = []
        lock = threading.Lock()

        def connect(host, port, storage_options=None):
            with lock:
                connects.append(host)
            return SlowFailFS(host, fail=(host == "a"))

        client = mod.HAHdfsClient([("a", 1), ("b", 2)], connect=connect)
        results, errors = [], []

        def worker():
            try:
                results.append(client.get_file_info("/x"))
            except Exception as e:  # noqa: BLE001 — the assertion reads them
                errors.append(e)

        threads = [threading.Thread(target=worker) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors, errors
        assert results == ["info@b"] * 8
        assert connects.count("a") == 1  # rotated away once, never back


# -- hdfs:// URLs (tests/test_fs.py's cases, both packages) -----------------------------


class _Recorder:
    def __init__(self):
        self.calls = []

    def __call__(self, *args, **kwargs):
        self.calls.append((args, kwargs))
        return pafs.LocalFileSystem()  # any real FS satisfies the return contract


@pytest.mark.parametrize("url,kwargs,want_args,want_kwargs,want_path", [
    ("hdfs://namenode-host:8020/data/ds", {}, ("namenode-host", 8020), {}, "/data/ds"),
    ("hdfs://nameservice1/data/ds", {}, ("nameservice1", 0), {}, "/data/ds"),
    ("hdfs:///data/ds", {}, ("default", 0), {}, "/data/ds"),
    ("hdfs://nn:9000/x", {"storage_options": {"user": "alice"}}, ("nn", 9000),
     {"user": "alice"}, "/x"),
])
def test_hdfs_urls_resolve_through_the_ha_client(monkeypatch, url, kwargs, want_args,
                                                 want_kwargs, want_path):
    monkeypatch.delenv("HADOOP_CONF_DIR", raising=False)
    for var in ("HADOOP_HOME", "HADOOP_PREFIX", "HADOOP_INSTALL"):
        monkeypatch.delenv(var, raising=False)
    got = []
    for mod in (port_fs, ref_fs):
        rec = _Recorder()
        monkeypatch.setattr(pafs, "HadoopFileSystem", rec)
        fs, path = mod.get_filesystem_and_path_or_paths(url, **kwargs)
        assert path == want_path
        (args, kw), = rec.calls
        assert args == want_args and kw == want_kwargs
        got.append((path, rec.calls))
    assert got[0] == got[1]


def test_a_nameservice_url_with_hadoop_config_gets_the_failover_client(tmp_path, monkeypatch):
    _write_site(tmp_path, "hdfs-site.xml", CONFIG)
    monkeypatch.setenv("HADOOP_CONF_DIR", str(tmp_path))
    rec = _Recorder()
    monkeypatch.setattr(pafs, "HadoopFileSystem", rec)
    fs, path = port_fs.get_filesystem_and_path_or_paths("hdfs://nameservice1/data/ds")
    assert isinstance(fs, port_hdfs.HAHdfsClient) and path == "/data/ds"
    assert fs._namenodes == [("namenode-a", 8020), ("namenode-b", 8020)]
    assert rec.calls == []  # connects lazily, at the first call
    fs.get_file_info("/data/ds")
    assert rec.calls == [(("namenode-a", 8020), {})]
