"""The port stands alone: petastorm_tpu_torch (and chip_smoke.py and the torch examples)
import neither jax nor any petastorm_tpu module, import loads no kernel, and the entry points refuse to fall
back to the CPU when no device was asked for."""
import ast
import inspect
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_pool_helpers import _no_leaked_shm_segments  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "petastorm_tpu_torch")


def _port_modules():
    names = ["petastorm_tpu_torch"]
    for info in pkgutil.walk_packages([PKG], prefix="petastorm_tpu_torch."):
        names.append(info.name)
    return sorted(names)


def _forbidden(name):
    return name == "jax" or name.startswith("jax.") or name == "jaxlib" \
        or name.startswith("jaxlib.") or name == "petastorm_tpu" \
        or name.startswith("petastorm_tpu.")


def test_importing_every_port_module_loads_no_jax_or_reference():
    modules = _port_modules()
    assert "petastorm_tpu_torch.loader" in modules and "petastorm_tpu_torch.ops.jpeg" in modules
    for name in ("transform", "ops.tabular", "ops.device_shuffle", "io.statscache",
                 "ngram", "weighted_sampling", "adapters.pytorch", "pytorch", "cache",
                 "io.coalesce", "io.readahead", "io.footercache", "io.memcache",
                 "io.tiers", "io.remote", "io.latencyfs", "io.arena", "chaos",
                 "chaos.plan", "recovery", "trace", "obs", "obs.metrics", "obs.log",
                 "obs.flight", "obs.analyze", "obs.export", "obs.health",
                 "obs.timeseries", "obs.slo", "obs.serve", "obs.provenance",
                 "obs.critical_path", "obs.diff", "obs.stats_cli", "benchmark",
                 "benchmark.trend", "transport", "transport.framing", "transport.tcp",
                 "service", "service.protocol", "service.worker", "service.server",
                 "service.client", "service.telemetry", "models", "models.layers",
                 "models.weights", "models.resnet", "models.mnist", "models.vit",
                 "models.transformer", "parallel.collectives", "parallel.attention",
                 "parallel.pipeline", "compat", "compat.reference", "hdfs", "tools",
                 "tools.copy_dataset", "tools.generate_metadata", "adapters.tf",
                 "tf_utils", "spark", "spark.spark_dataset_converter", "spark_utils"):
        assert "petastorm_tpu_torch." + name in modules
    code = (
        "import importlib, sys\n"
        "for m in %r: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'jaxlib', 'petastorm_tpu') "
        "or m.startswith(('jax.', 'jaxlib.', 'petastorm_tpu.')))\n"
        "print(repr(bad))\n" % (modules,))
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("path", ["petastorm_tpu_torch", "chip_smoke.py", "chip_profile.py",
                                  "examples/torch"])
def test_no_jax_or_reference_import_in_source(path):
    full = os.path.join(ROOT, path)
    files = [full] if full.endswith(".py") else [
        os.path.join(d, f) for d, _, fs in os.walk(full) for f in fs if f.endswith(".py")]
    assert files
    for f in files:
        with open(f) as fh:
            tree = ast.parse(fh.read(), filename=f)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert not _forbidden(name), "%s imports %s" % (f, name)


def test_import_builds_and_loads_no_kernel():
    from petastorm_tpu_torch.ops import kernels

    assert kernels._LIB is None


def test_dataloader_without_device_raises_when_cuda_is_absent(monkeypatch):
    from petastorm_tpu_torch.loader import DataLoader

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DataLoader(object(), 4)


def test_decode_without_device_raises_when_cuda_is_absent(monkeypatch):
    from petastorm_tpu_torch.ops.jpeg import decode_jpeg_batch, planes_from_arrays
    import numpy as np

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    planes = planes_from_arrays(8, 8, [(np.zeros((1, 1, 64), np.int16),
                                        np.ones(64, np.int32), 1, 1)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        decode_jpeg_batch([planes])


def _assert_health_and_slos_are_taken(kwargs):
    """``health=`` and ``slos=`` are ported (item 8b(i)): a loader takes ``health=True``
    (its watchdog starts and stops with it), and ``slos=`` without ``metrics=`` is the
    JAX package's ``ValueError``, not a refusal."""
    from types import SimpleNamespace

    from petastorm_tpu_torch.loader import DataLoader

    reader = SimpleNamespace(stop=lambda: None, join=lambda: None)
    if "slos" in kwargs:
        with pytest.raises(ValueError, match="requires metrics="):
            DataLoader(reader, 4, device="cpu", **kwargs)
        return
    with DataLoader(reader, 4, device="cpu", **kwargs) as loader:
        assert loader._health is not None and loader._health_owned
        assert loader.health_report()["schema"] == "ptpu-flight-v1"
    assert loader._health._watchdog is None  # stopped with the loader


# pad_shapes is ported, and so are trace and metrics (item 8a), health and slos (item
# 8b(i)) and provenance (item 8b(ii)): their cases check that they are taken; the
# controller and tenant (item 8c(i)) are taken too, and so is sharding (item 12): an
# object that is not a NamedSharding raises ValueError, as the reference's device_put
@pytest.mark.parametrize("kwargs", [
    {"sharding": object()}, {"controller": object()}, {"slos": object()},
    {"tenant": "team-a"}, {"health": True}, {"provenance": True},
])
def test_unported_loader_options_raise_naming_the_roadmap(kwargs):
    from petastorm_tpu_torch.loader import DataLoader

    if "health" in kwargs or "slos" in kwargs:
        _assert_health_and_slos_are_taken(kwargs)
        return
    if "provenance" in kwargs:
        _assert_provenance_is_taken()
        return
    if "controller" in kwargs or "tenant" in kwargs:
        _assert_controller_and_tenant_are_taken(kwargs)
        return
    assert "sharding" in inspect.signature(DataLoader).parameters
    with pytest.raises(ValueError, match="NamedSharding"):
        DataLoader(object(), 4, device="cpu", **kwargs)


def _assert_controller_and_tenant_are_taken(kwargs):
    """``controller=`` and ``tenant=`` are ported (item 8c(i)): a controller without
    ``metrics=`` is the JAX package's ``ValueError``; with it the loader builds one over
    the reader's knobs and detaches it at exit. A tenant is resolved and kept."""
    from types import SimpleNamespace

    from petastorm_tpu_torch.loader import DataLoader
    from petastorm_tpu_torch.obs.metrics import MetricsRegistry

    reader = SimpleNamespace(stop=lambda: None, join=lambda: None)
    if "tenant" in kwargs:
        with DataLoader(reader, 4, device="cpu", **kwargs) as loader:
            assert loader.tenant_context.tenant == kwargs["tenant"]
        return
    with pytest.raises(ValueError, match="requires metrics="):
        DataLoader(reader, 4, device="cpu", **kwargs)
    with DataLoader(reader, 4, device="cpu", metrics=MetricsRegistry(), **kwargs) as loader:
        ctl = loader.controller
        assert ctl is not None and ctl._store is not None
        assert loader.ctl_decisions() == []
    assert ctl._store is None  # the loader built it, and detached it at exit


def _assert_provenance_is_taken():
    """``provenance=`` is ported (item 8b(ii)): a loader takes ``provenance=True``,
    arms the process's recorder for its lifetime and answers ``attribution_report()``."""
    from types import SimpleNamespace

    from petastorm_tpu_torch.loader import DataLoader
    from petastorm_tpu_torch.obs import provenance as prov

    reader = SimpleNamespace(stop=lambda: None, join=lambda: None)
    try:
        with DataLoader(reader, 4, device="cpu", provenance=True) as loader:
            assert prov.ACTIVE is loader.provenance is not None
            assert loader.attribution_report().batches == 0
            assert loader.batch_provenance() is None
        assert prov.ACTIVE is None  # the loader built it, and released it at exit
    finally:
        prov.ACTIVE = None


def test_device_decode_resize_no_longer_raises_not_implemented():
    """The on-device resize is ported: the option is validated (against the reader's
    device-decoded fields), not refused."""
    from types import SimpleNamespace

    from petastorm_tpu_torch.loader import DataLoader

    reader = SimpleNamespace(device_decode_fields=("image",), stop=lambda: None,
                             join=lambda: None)
    with DataLoader(reader, 4, device="cpu", device_decode_resize=(8, 8)) as loader:
        assert loader._device_decode_resize == (8, 8)
    with pytest.raises(ValueError, match="misspelled|spelled right"):
        DataLoader(reader, 4, device="cpu", device_decode_resize={"imgae": (8, 8)})
    with pytest.raises(ValueError, match="no device-decoded"):
        DataLoader(SimpleNamespace(), 4, device="cpu", device_decode_resize=(8, 8))


def test_kernel_wrappers_refuse_unsupported_inputs():
    from petastorm_tpu_torch.ops.image import normalize_images
    from petastorm_tpu_torch.ops.jpeg import idct_scaled

    with pytest.raises(ValueError):
        idct_scaled(torch.zeros(4, 63))
    with pytest.raises(TypeError):
        idct_scaled(torch.zeros(4, 64, dtype=torch.float64))
    with pytest.raises(TypeError):
        normalize_images(torch.zeros(1, 2, 2, 3), [0.0] * 3, [1.0] * 3)
    # float16 is a store type of K2 (as the reference takes any out_dtype): on the CPU the
    # wrapper is the plain version, the same formula cast to float16
    x = torch.arange(12, dtype=torch.uint8).view(1, 2, 2, 3)
    half = normalize_images(x, [0.5] * 3, [0.25] * 3, out_dtype=torch.float16)
    assert half.dtype == torch.float16
    assert torch.equal(half, ((x.float() / 255.0 - 0.5) * 4.0).to(torch.float16))
    with pytest.raises(TypeError):
        normalize_images(x, [0.0] * 3, [1.0] * 3, out_dtype=torch.float64)


@pytest.mark.parametrize("module", [
    "petastorm_tpu_torch.serializers", "petastorm_tpu_torch._child_worker",
    "petastorm_tpu_torch.parallel.shm_ring", "petastorm_tpu_torch.io.lease",
    "petastorm_tpu_torch.transport", "petastorm_tpu_torch.ops.tabular",
    "petastorm_tpu_torch.transform", "petastorm_tpu_torch.io.statscache",
    "petastorm_tpu_torch.predicates", "petastorm_tpu_torch.partitions",
    "petastorm_tpu_torch.ngram", "petastorm_tpu_torch.weighted_sampling",
    "petastorm_tpu_torch.adapters.pytorch", "petastorm_tpu_torch.pytorch",
    "petastorm_tpu_torch.cache", "petastorm_tpu_torch.io.coalesce",
    "petastorm_tpu_torch.io.readahead", "petastorm_tpu_torch.io.footercache",
    "petastorm_tpu_torch.io.memcache", "petastorm_tpu_torch.io.tiers",
    "petastorm_tpu_torch.io.remote", "petastorm_tpu_torch.chaos",
    "petastorm_tpu_torch.recovery", "petastorm_tpu_torch.trace",
    "petastorm_tpu_torch.obs.log", "petastorm_tpu_torch.obs.export",
    "petastorm_tpu_torch.obs.health", "petastorm_tpu_torch.obs.timeseries",
    "petastorm_tpu_torch.obs.slo", "petastorm_tpu_torch.obs.serve",
    "petastorm_tpu_torch.obs.provenance", "petastorm_tpu_torch.obs.critical_path",
    "petastorm_tpu_torch.obs.diff", "petastorm_tpu_torch.obs.stats_cli",
    "petastorm_tpu_torch.benchmark.trend", "petastorm_tpu_torch.transport",
    "petastorm_tpu_torch.transport.framing", "petastorm_tpu_torch.transport.tcp",
    "petastorm_tpu_torch.service", "petastorm_tpu_torch.service.protocol",
    "petastorm_tpu_torch.service.worker", "petastorm_tpu_torch.service.server",
    "petastorm_tpu_torch.service.client", "petastorm_tpu_torch.service.telemetry"])
def test_process_pool_modules_import_no_jax_or_reference(module):
    """The process pool's modules, which every pool child imports, load neither jax nor
    the JAX package (nor torch: a child must not pay for it or touch the card). A host
    ``transform_spec`` travels to the children, so the feature pipeline's module is one
    of them; so do a predicate, the hive partition layout and an NGram. The mixer and the
    torch adapters are host modules too, and load torch only when they make tensors. A
    child arms the provenance plane's collector at bootstrap; the critical-path fold,
    the run diff, the stats CLI and the trend gate are host tools that need no torch
    until the gate builds a loader. A tcp child imports the transport; a decode worker
    of the data service, in a process of its own, imports the service, whose server and
    client move numpy payloads only."""
    assert module in _port_modules()
    code = ("import importlib, sys\n"
            "importlib.import_module(%r)\n"
            "print(repr(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'petastorm_tpu', 'torch'))))\n" % module)
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _selection_store(tmp_path):
    """A 12-row store written through the port (both factories open it), its
    ``id`` column indexed for ``rowgroup_selector``."""
    import numpy as np

    from petastorm_tpu_torch import types
    from petastorm_tpu_torch.codecs import ScalarCodec
    from petastorm_tpu_torch.etl.rowgroup_indexing import (SingleFieldIndexer,
                                                           build_rowgroup_index)
    from petastorm_tpu_torch.metadata import write_dataset
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField

    schema = Unischema("S", [UnischemaField("id", np.int64, (), ScalarCodec(
        types.LongType()), False)])
    url = "file://" + str(tmp_path / "store")
    write_dataset(url, schema, ({"id": i} for i in range(12)), rows_per_file=4)
    build_rowgroup_index(url, [SingleFieldIndexer("by_id", "id")])
    return url


def _item_6_value(name):
    from petastorm_tpu_torch.predicates import in_set
    from petastorm_tpu_torch.selectors import SingleIndexSelector

    return {"predicate": in_set({1, 5, 9}, "id"), "filters": [("id", "in", [1, 5, 9])],
            "rowgroup_selector": SingleIndexSelector("by_id", [1, 5]),
            "shuffle_row_drop_partitions": 2}[name]


@pytest.mark.parametrize("name", ["predicate", "filters", "rowgroup_selector",
                                  "shuffle_row_drop_partitions"])
def test_item_6_options_are_taken(tmp_path, name):
    """Item 6 is ported: each option is taken by the factories that have it
    (``rowgroup_selector`` is make_reader's only) and selects rows; none is listed as
    unported any more."""
    from petastorm_tpu_torch import make_batch_reader, make_reader
    from petastorm_tpu_torch.loader import DataLoader

    assert "pad_shapes" in inspect.signature(DataLoader).parameters
    url = _selection_store(tmp_path)
    factories = [make_reader] if name == "rowgroup_selector" \
        else [make_reader, make_batch_reader]
    for factory in factories:
        assert name in inspect.signature(factory).parameters
        with factory(url, reader_pool_type="dummy", **{name: _item_6_value(name)}) as r:
            got = sorted(int(i) for x in r for i in np.atleast_1d(x.id))
        if name == "shuffle_row_drop_partitions":
            assert got == list(range(12))  # every partition of every row group, once
        elif name == "rowgroup_selector":
            assert got == list(range(8))  # one row group a file: ids 1 and 5 are in two
        else:
            assert got == [1, 5, 9]


# NGram is ported (item 7): its case now holds make_dataloader(sharding=...). The
# dataset watch is ported (item 8c(ii)): its case reads, watched. Multi-card placement
# is ported (item 12): DataLoader takes a NamedSharding (one rank here, the CPU mesh's
# device), and make_dataloader refuses an object that is not one, stopping its reader
@pytest.mark.parametrize("case", ["cache_type", "io_retries", "recovery", "watch",
                                  "sharding", "make_dataloader_sharding"])
def test_options_still_unported_raise_naming_their_item(tmp_path, case):
    import pyarrow as pa
    import pyarrow.parquet as pq

    from petastorm_tpu_torch import make_batch_reader
    from petastorm_tpu_torch.loader import DataLoader, make_dataloader

    pq.write_table(pa.table({"id": np.arange(4)}), str(tmp_path / "p.parquet"))
    url = "file://" + str(tmp_path)
    if case == "cache_type":
        # cache_type is ported (item 5a) and so is the cache arena (item 5b): the two
        # together read, every row once, through the arena and the local-disk tier
        from petastorm_tpu_torch.io import arena as arena_mod
        from petastorm_tpu_torch.io.memcache import shared_store

        try:
            with make_batch_reader(url, reader_pool_type="dummy", cache_type="local-disk",
                                   cache_location=str(tmp_path / "c"),
                                   io_options={"arena_bytes": 1 << 20}) as r:
                got = sorted(int(i) for b in r for i in np.asarray(b.id))
                stats = r.io_stats()
        finally:
            arena_mod.close_process_arena()
            shared_store().clear()  # the arena implies a process-wide memcache
        assert got == [0, 1, 2, 3]
        assert stats["arena_entries"] >= 1 and stats["tier_remote_hits"] == 1
        return
    if case in ("io_retries", "recovery"):
        # the recovery policy is ported (item 8a): both options are taken, with the
        # JAX package's semantics (the legacy keyword wins over the struct)
        kwargs = {"io_retries": {"io_retries": 2},
                  "recovery": {"recovery": {"io_retries": 1, "on_poison": "quarantine"},
                               "io_retries": 4}}[case]
        with make_batch_reader(url, reader_pool_type="dummy", **kwargs) as r:
            got = sorted(int(i) for b in r for i in np.asarray(b.id))
            rec = r._worker._recovery
            assert not r.quarantine_report
        assert got == [0, 1, 2, 3]
        assert rec.io_retries == {"io_retries": 2, "recovery": 4}[case]
        assert rec.quarantine == (case == "recovery")
        return
    if case == "watch":
        # the dataset watch is taken: every row once, each plan item stamped with its
        # file's generation, and the watcher's gauges in io_stats
        with make_batch_reader(url, reader_pool_type="dummy", watch=True) as r:
            got = sorted(int(i) for b in r for i in np.asarray(b.id))
            assert r.dataset_watcher is not None
            assert all(piece.generation for piece, _p in r._plan.items)
            assert r.io_stats()["watch_errors"] == 0
        assert got == [0, 1, 2, 3]
        return
    if case == "sharding":
        from types import SimpleNamespace

        from petastorm_tpu_torch.parallel.mesh import batch_sharding

        mesh = SimpleNamespace(mesh=torch.zeros((1,), dtype=torch.int64),
                               mesh_dim_names=("dp",), device_type="cpu")
        reader = SimpleNamespace(stop=lambda: None, join=lambda: None)
        with DataLoader(reader, 4, device="cpu", sharding=batch_sharding(mesh)) as loader:
            assert loader.local_batch_size == 4 and loader.device == torch.device("cpu")
        return
    from petastorm_tpu_torch import reader as port_reader

    built = []
    real = port_reader.make_batch_reader

    def spy(*a, **kw):
        built.append(real(*a, **kw))
        return built[-1]

    with pytest.raises(ValueError, match="NamedSharding"):
        make_dataloader(url, 4, sharding=object(), device="cpu", reader_factory=spy,
                        reader_pool_type="dummy")
    assert len(built) == 1 and built[0].stopped


@pytest.mark.parametrize("kwargs,item", [
    ({"provenance": True}, "item 8b"), ({"health": True}, "item 8b"),
    ({"slos": object()}, "item 8b"), ({"controller": object()}, "item 8c"),
    ({"tenant": "team-a"}, "item 8c"),
])
def test_later_observability_slices_raise_naming_8b_or_8c(kwargs, item):
    """What the liveness and time slice (8b(i)) owns, health and slos, what the
    attribution slice (8b(ii)) owns, provenance, and what the tenants and controller
    slice (8c(i)) owns, controller and tenant, are all taken."""
    from petastorm_tpu_torch.loader import DataLoader

    if "health" in kwargs or "slos" in kwargs:
        _assert_health_and_slos_are_taken(kwargs)
        return
    if "provenance" in kwargs:
        _assert_provenance_is_taken()
        return
    if "controller" in kwargs or "tenant" in kwargs:
        _assert_controller_and_tenant_are_taken(kwargs)
        return
    with pytest.raises(NotImplementedError, match="Queue 1 %s" % item):
        DataLoader(object(), 4, device="cpu", **kwargs)


@pytest.mark.parametrize("kwargs,item", [
    ({"provenance": True}, "item 8b"), ({"watch": True}, r"item 8c\(ii\)"),
    ({"tenant": "team-a"}, "item 8c"),
])
def test_later_observability_reader_options_raise_naming_8b_or_8c(tmp_path, kwargs,
                                                                  item):
    import pyarrow as pa
    import pyarrow.parquet as pq

    from petastorm_tpu_torch import make_batch_reader, make_reader

    pq.write_table(pa.table({"id": np.arange(4)}), str(tmp_path / "p.parquet"))
    if "provenance" in kwargs:
        # the attribution slice is ported: the factory arms a recorder of its own, the
        # reader notes its deliveries on it and releases it at join
        from petastorm_tpu_torch.obs import provenance as prov

        try:
            with make_batch_reader("file://" + str(tmp_path), reader_pool_type="dummy",
                                   **kwargs) as reader:
                assert sorted(int(i) for b in reader for i in b.id) == [0, 1, 2, 3]
                assert prov.ACTIVE is reader._prov
                assert sum(r["rows"] for r in reader._prov.items().values()) == 4
            assert prov.ACTIVE is None
        finally:
            prov.ACTIVE = None
        return
    if "tenant" in kwargs:
        # the tenant slice (8c(i)) is ported: both factories read every row and charge
        # them to the tenant (the per-row one from a store with a unischema)
        from petastorm_tpu_torch import types as ptypes
        from petastorm_tpu_torch.codecs import ScalarCodec
        from petastorm_tpu_torch.metadata import write_dataset
        from petastorm_tpu_torch.obs.metrics import default_registry
        from petastorm_tpu_torch.unischema import Unischema, UnischemaField

        rows_url = "file://" + str(tmp_path) + "-rows"  # beside the batch store
        schema = Unischema("S", [UnischemaField("id", np.int64, (),
                                                ScalarCodec(ptypes.LongType()), False)])
        write_dataset(rows_url, schema, ({"id": i} for i in range(4)),
                      row_group_size_mb=1, rows_per_file=4)
        name = 'ptpu_tenant_rows_total{tenant="team-a"}'
        before = default_registry().snapshot().get(name, 0)
        with make_batch_reader("file://" + str(tmp_path), reader_pool_type="dummy",
                               **kwargs) as reader:
            assert sorted(int(i) for b in reader for i in b.id) == [0, 1, 2, 3]
            assert reader.tenant_context.tenant == "team-a"
        with make_reader(rows_url, reader_pool_type="dummy", **kwargs) as reader:
            assert sorted(int(row.id) for row in reader) == [0, 1, 2, 3]
        assert default_registry().snapshot()[name] - before == 8
        return
    # the dataset-watch slice (8c(ii)) is ported: both factories read every row of a
    # watched store (the per-row one from a store with a unischema), every plan item
    # stamped with its file's generation token
    from petastorm_tpu_torch import types as ptypes
    from petastorm_tpu_torch.codecs import ScalarCodec
    from petastorm_tpu_torch.metadata import write_dataset
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField

    rows_url = "file://" + str(tmp_path) + "-rows"
    schema = Unischema("S", [UnischemaField("id", np.int64, (),
                                            ScalarCodec(ptypes.LongType()), False)])
    write_dataset(rows_url, schema, ({"id": i} for i in range(4)), row_group_size_mb=1,
                  rows_per_file=4)
    with make_batch_reader("file://" + str(tmp_path), reader_pool_type="dummy",
                           **kwargs) as reader:
        assert sorted(int(i) for b in reader for i in b.id) == [0, 1, 2, 3]
        assert all(p.generation for p, _ in reader._plan.items)
    with make_reader(rows_url, reader_pool_type="dummy", **kwargs) as reader:
        assert sorted(int(row.id) for row in reader) == [0, 1, 2, 3]
        assert all(p.generation for p, _ in reader._plan.items)


@pytest.mark.parametrize("action,item", [
    ("net.reset", r"item 4\(c\)"), ("net.partition", r"item 4\(c\)"),
    ("remove_file", r"item 8c\(ii\)"), ("append_piece", r"item 8c\(ii\)"),
])
def test_chaos_actions_of_later_slices_raise_naming_them(action, item):
    """Both slices are ported. The ``net.*`` actions of item 4(c): the rule is made, and
    firing it at ``transport.send`` resets the link or opens a partition window. The
    mutation actions of item 8c(ii): firing one at the ``dataset.mutate`` site calls the
    payload's method of the same name with the rule's target."""
    from petastorm_tpu_torch.chaos import FaultPlan, FaultRule
    from petastorm_tpu_torch.chaos.plan import DROPPED

    if action.startswith("net."):
        plan = FaultPlan([FaultRule("transport.send", action, nth=1, latency_s=0.2)])
        if action == "net.reset":
            with pytest.raises(ConnectionResetError, match="net.reset"):
                plan.hit("transport.send", key="session=0", payload=b"frame")
        else:
            assert plan.hit("transport.send", key="session=0", payload=b"frame") \
                is DROPPED
        assert [i["action"] for i in plan.injections()] == [action]
        return

    class _Mutator:
        calls = []

        def remove_file(self, target):
            self.calls.append(("remove_file", target))

        def append_piece(self, target):
            self.calls.append(("append_piece", target))

    target = {"name": "part_zz0.parquet", "start": 100, "rows": 4}
    plan = FaultPlan([FaultRule("dataset.mutate", action, nth=1, target=target)])
    mutator = _Mutator()
    assert plan.hit("dataset.mutate", key="tick=1", payload=mutator) is mutator
    assert plan.hit("dataset.mutate", key="tick=2", payload=mutator) is mutator
    assert mutator.calls == [(action, target)]


def test_trace_and_metrics_are_taken_by_every_loader(tmp_path):
    import pyarrow as pa
    import pyarrow.parquet as pq

    from petastorm_tpu_torch import make_batch_reader
    from petastorm_tpu_torch.loader import DataLoader, InMemDataLoader, make_dataloader
    from petastorm_tpu_torch.obs.metrics import MetricsRegistry
    from petastorm_tpu_torch.trace import TraceRecorder

    pq.write_table(pa.table({"id": np.arange(8)}), str(tmp_path / "p.parquet"))
    url = "file://" + str(tmp_path)
    tracer, registry = TraceRecorder(), MetricsRegistry()
    with DataLoader(make_batch_reader(url, reader_pool_type="dummy"), 4, device="cpu",
                    trace=tracer, metrics=registry) as loader:
        assert sum(1 for _ in loader) == 2
        assert registry.snapshot()["ptpu_pipeline_batches"] == 2
    with InMemDataLoader(make_batch_reader(url, reader_pool_type="dummy"), 4,
                         device="cpu", trace=tracer) as loader:
        assert sum(1 for _ in loader) == 2
    with make_dataloader(url, 4, device="cpu", reader_pool_type="dummy",
                         trace=tracer, metrics=MetricsRegistry()) as loader:
        assert sum(1 for _ in loader) == 2
    assert {"reader.next", "inmem.gather"} <= {e["name"] for e in tracer.events()}


def test_transform_spec_and_device_shuffle_capacity_are_taken():
    from types import SimpleNamespace

    from petastorm_tpu_torch.loader import DataLoader

    reader = SimpleNamespace(stop=lambda: None, join=lambda: None)
    with DataLoader(reader, 4, device="cpu", device_shuffle_capacity=64) as loader:
        assert loader._device_shuffle_capacity == 64
    # pad_shapes is ported too (item 6): taken and kept
    with DataLoader(reader, 4, device="cpu", pad_shapes={"x": (3,)}) as loader:
        assert loader._pad_shapes == {"x": (3,)}
