"""The port stands alone: petastorm_tpu_torch (and chip_smoke.py) import neither jax nor
any petastorm_tpu module, import loads no kernel, and the entry points refuse to fall
back to the CPU when no device was asked for."""
import ast
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
                 "obs.flight", "obs.analyze", "obs.export"):
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


@pytest.mark.parametrize("path", ["petastorm_tpu_torch", "chip_smoke.py", "chip_profile.py"])
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


# pad_shapes is ported, and so are trace and metrics (item 8a): their cases hold the
# controller (item 8c) and the tenant (item 8c), still refused
@pytest.mark.parametrize("kwargs", [
    {"sharding": object()}, {"controller": object()}, {"slos": object()},
    {"tenant": "team-a"}, {"health": True}, {"provenance": True},
])
def test_unported_loader_options_raise_naming_the_roadmap(kwargs):
    from petastorm_tpu_torch.loader import DataLoader

    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item"):
        DataLoader(object(), 4, device="cpu", **kwargs)


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
    "petastorm_tpu_torch.obs.log", "petastorm_tpu_torch.obs.export"])
def test_process_pool_modules_import_no_jax_or_reference(module):
    """The process pool's modules, which every pool child imports, load neither jax nor
    the JAX package (nor torch: a child must not pay for it or touch the card). A host
    ``transform_spec`` travels to the children, so the feature pipeline's module is one
    of them; so do a predicate, the hive partition layout and an NGram. The mixer and the
    torch adapters are host modules too, and load torch only when they make tensors."""
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
    from petastorm_tpu_torch._unported import OPTIONS

    assert name not in OPTIONS and "pad_shapes" not in OPTIONS
    url = _selection_store(tmp_path)
    factories = [make_reader] if name == "rowgroup_selector" \
        else [make_reader, make_batch_reader]
    for factory in factories:
        with factory(url, reader_pool_type="dummy", **{name: _item_6_value(name)}) as r:
            got = sorted(int(i) for x in r for i in np.atleast_1d(x.id))
        if name == "shuffle_row_drop_partitions":
            assert got == list(range(12))  # every partition of every row group, once
        elif name == "rowgroup_selector":
            assert got == list(range(8))  # one row group a file: ids 1 and 5 are in two
        else:
            assert got == [1, 5, 9]


# NGram is ported (item 7): its case now holds make_dataloader(sharding=...), which
# raises naming item 12 before it builds a reader
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
    item = {"watch": "item 8c", "sharding": "item 12",
            "make_dataloader_sharding": "item 12"}[case]
    with pytest.raises(NotImplementedError, match="Queue 1 %s" % item):
        if case == "sharding":
            DataLoader(object(), 4, device="cpu", sharding=object())
        elif case == "make_dataloader_sharding":
            make_dataloader(url, 4, sharding=object(), device="cpu")
        else:
            make_batch_reader(url, watch=True)


@pytest.mark.parametrize("kwargs,item", [
    ({"provenance": True}, "item 8b"), ({"health": True}, "item 8b"),
    ({"slos": object()}, "item 8b"), ({"controller": object()}, "item 8c"),
    ({"tenant": "team-a"}, "item 8c"),
])
def test_later_observability_slices_raise_naming_8b_or_8c(kwargs, item):
    """What the health/provenance slice (8b) and the tenants/controller slice (8c) own
    stays refused, each naming its slice."""
    from petastorm_tpu_torch.loader import DataLoader

    with pytest.raises(NotImplementedError, match="Queue 1 %s" % item):
        DataLoader(object(), 4, device="cpu", **kwargs)


@pytest.mark.parametrize("kwargs,item", [
    ({"provenance": True}, "item 8b"), ({"watch": True}, "item 8c"),
    ({"tenant": "team-a"}, "item 8c"),
])
def test_later_observability_reader_options_raise_naming_8b_or_8c(tmp_path, kwargs,
                                                                  item):
    import pyarrow as pa
    import pyarrow.parquet as pq

    from petastorm_tpu_torch import make_batch_reader, make_reader

    pq.write_table(pa.table({"id": np.arange(4)}), str(tmp_path / "p.parquet"))
    for factory in (make_batch_reader, make_reader):
        with pytest.raises(NotImplementedError, match="Queue 1 %s" % item):
            factory("file://" + str(tmp_path), **kwargs)


@pytest.mark.parametrize("action,item", [
    ("net.reset", r"item 4\(c\)"), ("net.partition", r"item 4\(c\)"),
    ("remove_file", "item 8c"), ("append_piece", "item 8c"),
])
def test_chaos_actions_of_later_slices_raise_naming_them(action, item):
    from petastorm_tpu_torch.chaos import FaultRule

    with pytest.raises(NotImplementedError, match="Queue 1 %s" % item):
        FaultRule("transport.send", action)


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
