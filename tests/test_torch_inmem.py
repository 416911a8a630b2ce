"""Port vs reference: ``InMemDataLoader`` and ``make_dataloader``. With ``shuffle=False``
the port's batches (ids and values) equal the JAX package's; with ``shuffle=True`` every
row comes once an epoch in a seeded order; ``last_batch`` drop and partial, the dropped
host-only column, the decode-on-device fill (pixels bit-identical to the JAX fill's),
``device_decode_resize`` on mixed sizes, the infinite-reader refusal; the cursor
(``state_dict`` keys equal to the reference's, exact resume, the mismatch and
cursor-edge cases, ``checkpoint.save``/``restore`` and DCP through ``state_item``, a
JAX-saved cursor); ``make_dataloader`` equal to the two-call form, and its ``cur_shard``
defaulted from a two-rank gloo job."""
import json
import logging
import os
import socket

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

cv2 = pytest.importorskip("cv2")
torch = pytest.importorskip("torch")

from _torch_pool_helpers import _no_leaked_shm_segments, no_leaked_port_slabs  # noqa: E402,F401
from petastorm_tpu import loader as ref_loader  # noqa: E402
from petastorm_tpu import metadata as ref_metadata  # noqa: E402
from petastorm_tpu import reader as ref_reader  # noqa: E402
from petastorm_tpu import types as ref_types  # noqa: E402
from petastorm_tpu.codecs import CompressedImageCodec as RefImage  # noqa: E402
from petastorm_tpu.codecs import ScalarCodec as RefScalar  # noqa: E402
from petastorm_tpu.unischema import Unischema as RefSchema  # noqa: E402
from petastorm_tpu.unischema import UnischemaField as RefField  # noqa: E402
from petastorm_tpu_torch import checkpoint as ptck  # noqa: E402
from petastorm_tpu_torch import make_batch_reader, types  # noqa: E402
from petastorm_tpu_torch.codecs import CompressedImageCodec, ScalarCodec  # noqa: E402
from petastorm_tpu_torch.loader import DataLoader, InMemDataLoader, make_dataloader  # noqa: E402
from petastorm_tpu_torch.metadata import write_petastorm_tpu_metadata  # noqa: E402
from petastorm_tpu_torch.unischema import Unischema, UnischemaField, encode_row  # noqa: E402

CPU = "cpu"
ROWS, RG = 64, 8
IMG = (32, 40, 3)
IMG_ROWS = 24


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """64 rows in two files of four row groups of 8: an id, a float, an int32 label and
    a string column (host-only)."""
    root = tmp_path_factory.mktemp("torch_inmem") / "ds"
    os.makedirs(root)
    for f in range(2):
        ids = np.arange(f * 32, (f + 1) * 32, dtype=np.int64)
        pq.write_table(pa.table({"id": ids, "val": ids.astype(np.float32) * 0.5,
                                 "label": (ids % 7).astype(np.int32),
                                 "name": ["n%d" % i for i in ids]}),
                       str(root / ("part-%d.parquet" % f)), row_group_size=RG)
    return "file://" + str(root)


@pytest.fixture(scope="module")
def jpeg_store(tmp_path_factory):
    """24 JPEG rows of (32, 40, 3), q85, in row groups of 8, written by the JAX
    package."""
    schema = RefSchema("InMemJpeg", [
        RefField("id", np.int64, (), RefScalar(ref_types.LongType()), False),
        RefField("image", np.uint8, IMG, RefImage("jpeg", 85), False),
    ])
    rng = np.random.RandomState(12)

    def rows():
        for i in range(IMG_ROWS):
            noise = rng.randint(0, 256, IMG).astype(np.float32)
            yield {"id": i, "image": cv2.GaussianBlur(noise, (5, 5), 1.5)
                   .clip(0, 255).astype(np.uint8)}

    url = "file://" + str(tmp_path_factory.mktemp("torch_inmem_jpeg") / "ds")
    ref_metadata.write_dataset(url, schema, rows(), row_group_size_mb=0, rows_per_file=8)
    return url


def _reader(module, url, **kwargs):
    kw = dict(shuffle_row_groups=False, num_epochs=1, reader_pool_type="dummy")
    kw.update(kwargs)
    return module.make_batch_reader(url, **kw)


def _port(url, batch_size=8, **kwargs):
    reader_kw = kwargs.pop("reader_kw", {})
    return InMemDataLoader(_reader(__import__("petastorm_tpu_torch.reader").reader, url,
                                   **reader_kw), batch_size, device=CPU, **kwargs)


def _ids(batches):
    return [tuple(int(x) for x in b["id"].tolist()) for b in batches]


def _np(batch):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in batch.items()}


# -- batches against the reference -----------------------------------------------------------


@pytest.mark.parametrize("last_batch,batch_size", [("drop", 8), ("drop", 24),
                                                   ("partial", 24), ("partial", 64)])
def test_unshuffled_batches_equal_the_reference(store, last_batch, batch_size):
    with _port(store, batch_size, shuffle=False, num_epochs=2,
               last_batch=last_batch) as loader:
        ours = [_np(b) for b in loader]
        n = len(loader)
    with ref_loader.InMemDataLoader(_reader(ref_reader, store), batch_size, num_epochs=2,
                                    shuffle=False, last_batch=last_batch) as loader:
        theirs = [_np(b) for b in loader]
        assert n == len(loader)
    assert len(ours) == len(theirs) == 2 * n
    # the port keeps the store's int64 where the JAX package (x64 off) narrows to int32
    dtypes = {"id": np.int64, "label": np.int32, "val": np.float32}
    for a, b in zip(ours, theirs):
        assert sorted(a) == sorted(b) == ["id", "label", "val"]
        for k in a:
            assert a[k].dtype == dtypes[k]
            np.testing.assert_array_equal(a[k], b[k])


def test_shuffled_epochs_are_seeded_permutations(store):
    with _port(store, 8, shuffle=True, num_epochs=3, seed=5) as loader:
        batches = [_np(b) for b in loader]
        assert len(loader) == ROWS // 8
    epochs = [np.concatenate([b["id"] for b in batches[e * 8:(e + 1) * 8]])
              for e in range(3)]
    for e in epochs:
        assert sorted(e) == list(range(ROWS))
    assert not np.array_equal(epochs[0], epochs[1])
    assert not np.array_equal(epochs[0], np.arange(ROWS))
    # the values travel with their ids
    for b in batches:
        np.testing.assert_array_equal(b["val"], b["id"].astype(np.float32) * 0.5)
    with _port(store, 8, shuffle=True, num_epochs=3, seed=5) as again:
        assert _ids(again) == _ids(batches)
    with _port(store, 8, shuffle=True, num_epochs=1, seed=6) as other:
        assert _ids(other) != _ids(batches[:8])


def test_host_only_columns_are_dropped_with_the_references_warning(store, caplog):
    with caplog.at_level(logging.WARNING, logger="petastorm_tpu_torch.loader"):
        with _port(store, 8) as loader:
            assert sorted(loader._store) == ["id", "label", "val"]
    assert "InMemDataLoader dropped host-only fields: ['name']" in caplog.text


def test_an_infinite_reader_is_refused(store):
    from petastorm_tpu_torch import reader as port_reader

    for module, cls, kw in ((port_reader, InMemDataLoader, {"device": CPU}),
                            (ref_reader, ref_loader.InMemDataLoader, {})):
        reader = _reader(module, store, num_epochs=None)
        try:
            with pytest.raises(ValueError, match="infinite reader"):
                cls(reader, 8, **kw)
        finally:
            reader.stop()
            reader.join()


def test_sharding_raises_naming_item_12(store):
    """Multi-card placement (item 12) is ported: ``sharding=`` takes a ``NamedSharding``
    (held across ranks in ``tests/test_torch_sharding.py``); an object that is not one
    raises ``ValueError``, as the reference's ``device_put`` does for it."""
    from petastorm_tpu_torch import reader as port_reader

    reader = _reader(port_reader, store)
    try:
        with pytest.raises(ValueError, match="NamedSharding"):
            InMemDataLoader(reader, 8, device=CPU, sharding=object())
    finally:
        reader.stop()
        reader.join()


def test_decode_on_device_fill_is_bit_identical_to_the_references(jpeg_store):
    kw = dict(reader_kw=dict(decode_on_device=True))
    with _port(jpeg_store, 8, shuffle=False, **kw) as loader:
        ours = [_np(b) for b in loader]
        assert loader._store["image"].dtype == torch.uint8
    with ref_loader.InMemDataLoader(_reader(ref_reader, jpeg_store, decode_on_device=True),
                                    8, shuffle=False) as loader:
        theirs = [_np(b) for b in loader]
    assert len(ours) == len(theirs) == IMG_ROWS // 8
    for a, b in zip(ours, theirs):
        assert a["image"].shape == (8,) + IMG
        np.testing.assert_array_equal(a["id"], b["id"])
        np.testing.assert_array_equal(a["image"], b["image"])


def test_device_transform_is_seeded_from_seed_and_step(jpeg_store):
    """A two-argument transform gets a generator seeded from ``(seed + 1, step)``: the
    same stream draws the same values, and a resumed stream the uninterrupted one's."""
    from petastorm_tpu_torch.ops.image import normalize_and_augment

    def augment(batch, gen):
        return {**batch, "draw": torch.rand(2, generator=gen),
                "image": normalize_and_augment(batch["image"], [0.5] * 3, [0.25] * 3, gen,
                                               out_dtype=torch.float32)}

    def build():
        return _port(jpeg_store, 8, shuffle=True, seed=3, num_epochs=2,
                     device_transform=augment, reader_kw=dict(decode_on_device=True))

    with build() as loader:
        full = [_np(b) for b in loader]
    draws = [tuple(b["draw"]) for b in full]
    assert len(set(draws)) == len(draws) == 6
    loader = build()
    it = iter(loader)
    for _ in range(4):
        next(it)
    state = loader.state_dict()
    resumed = build()
    resumed.load_state_dict(state)
    rest = [_np(b) for b in resumed]
    assert len(rest) == 2
    for a, b in zip(rest, full[4:]):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def _mixed_store(tmp_path, sizes):
    schema = Unischema("Mixed", [
        UnischemaField("id", np.int64, (), ScalarCodec(types.LongType()), False),
        UnischemaField("image_jpeg", np.uint8, (None, None, 3),
                       CompressedImageCodec("jpeg", quality=90), False)])
    rng = np.random.RandomState(11)
    rows = []
    for i, (h, w) in enumerate(sizes):
        base = rng.randint(0, 256, (max(2, h // 8), max(2, w // 8))).astype(np.float32)
        img = np.kron(base, np.ones((8, 8), np.float32))[:h, :w]
        img = np.stack([img, np.flipud(img), np.fliplr(img)], -1).clip(0, 255)
        rows.append(encode_row(schema, {"id": i, "image_jpeg": img.astype(np.uint8)}))
    pq.write_table(pa.Table.from_pylist(rows, schema=schema.as_arrow_schema()),
                   str(tmp_path / "part-0.parquet"), row_group_size=len(sizes))
    write_petastorm_tpu_metadata(pa.fs.LocalFileSystem(), str(tmp_path), schema,
                                 {"part-0.parquet": 1})
    return "file://" + str(tmp_path)


def test_mixed_sizes_fill_through_the_resize(tmp_path):
    """The JAX package's ``test_inmem_loader_mixed_sizes_with_resize``: the staged decode
    and the resize give the resident store one static shape, and each image is within 1
    of the JAX package's fill (the resize is not bit-exact against
    ``jax.image.resize``)."""
    sizes = [(32, 48), (64, 40), (48, 48), (24, 24)] * 2
    url = _mixed_store(tmp_path, sizes)
    seen = {}
    with _port(url, 4, num_epochs=2, seed=7, device_decode_resize=(32, 32),
               reader_kw=dict(decode_on_device=True)) as loader:
        for batch in loader:
            assert batch["image_jpeg"].shape == (4, 32, 32, 3)
            assert batch["image_jpeg"].dtype == torch.uint8
            for i, img in zip(batch["id"].tolist(), batch["image_jpeg"].numpy()):
                seen.setdefault(i, []).append(img)
    assert sorted(seen) == list(range(len(sizes))) and all(len(v) == 2 for v in seen.values())
    ref = ref_loader.InMemDataLoader(
        _reader(ref_reader, url, decode_on_device=True), 4, shuffle=False,
        device_decode_resize=(32, 32))
    with ref:
        for batch in ref:
            for i, img in zip(np.asarray(batch["id"]), np.asarray(batch["image_jpeg"])):
                diff = np.abs(seen[int(i)][0].astype(int) - img.astype(int))
                assert diff.max() <= 1


# -- the cursor ---------------------------------------------------------------------------


def _build(store, num_epochs=3, **kwargs):
    return _port(store, 8, num_epochs=num_epochs, shuffle=True, seed=5, **kwargs)


def test_state_dict_keys_equal_the_references(store):
    with _build(store) as ours:
        with ref_loader.InMemDataLoader(_reader(ref_reader, store), 8, num_epochs=3,
                                        shuffle=True, seed=5) as theirs:
            a, b = ours.state_dict(), theirs.state_dict()
            assert a == b and sorted(a) == sorted(b)
            next(iter(ours))
            next(iter(theirs))
            assert ours.state_dict() == theirs.state_dict()


def test_state_dict_exact_resume(store):
    full = _ids(_build(store))
    assert len(full) == 24
    loader = _build(store)
    it = iter(loader)
    pre = _ids(next(it) for _ in range(11))
    state = loader.state_dict()
    assert state["inmem"] and state["epoch"] == 1 and state["batch"] == 3
    resumed = _build(store)
    resumed.load_state_dict(state)
    assert pre == full[:11]
    assert _ids(resumed) == full[11:]


def test_save_restore_and_dcp_resume_exactly(store, tmp_path):
    import torch.distributed.checkpoint as dcp

    full = _ids(_build(store, num_epochs=2))
    loader = _build(store, num_epochs=2)
    it = iter(loader)
    consumed = _ids(next(it) for _ in range(5))
    ptck.save(str(tmp_path / "inmem.pt"), loader)
    dcp.save({"data": ptck.state_item(loader)}, checkpoint_id=str(tmp_path / "dcp"))
    resumed = _build(store, num_epochs=2)
    ptck.restore(str(tmp_path / "inmem.pt"), resumed)
    assert consumed + _ids(resumed) == full
    resumed = _build(store, num_epochs=2)
    dcp.load({"data": ptck.state_item(resumed)}, checkpoint_id=str(tmp_path / "dcp"))
    assert consumed + _ids(resumed) == full


def test_state_mismatches_raise(store):
    with _build(store, num_epochs=2) as loader:
        state = loader.state_dict()
    with _port(store, 16, num_epochs=2, shuffle=True, seed=5) as other:
        with pytest.raises(ValueError, match="stream config"):
            other.load_state_dict(state)
    with _build(store) as loader:
        with pytest.raises(ValueError, match="InMemDataLoader state"):
            loader.load_state_dict({"consumed": {}, "resume_epoch": 0})
    with _build(store) as loader, pytest.raises(ValueError, match="stream config"):
        # a shorter num_epochs is a different finite stream
        loader.load_state_dict({**state, "num_epochs": 1})


def test_cursor_edge_cases(store):
    loader = _build(store)
    it = iter(loader)
    for _ in range(11):
        next(it)
    state = loader.state_dict()
    restored = _build(store)
    restored.load_state_dict(state)  # saved again before iterating: the restore point
    assert (restored.state_dict()["epoch"], restored.state_dict()["batch"]) == (1, 3)
    with pytest.raises(ValueError, match="stream config"):
        _build(store, num_epochs=1).load_state_dict(state)
    one = _build(store, num_epochs=1)
    assert len(list(one)) == 8
    assert (one.state_dict()["epoch"], one.state_dict()["batch"]) == (0, 8)
    it2 = iter(one)  # a new pass resets the cursor
    next(it2)
    assert (one.state_dict()["epoch"], one.state_dict()["batch"]) == (0, 1)


def test_a_jax_saved_cursor_resumes_only_without_shuffle(store):
    with ref_loader.InMemDataLoader(_reader(ref_reader, store), 8, num_epochs=2,
                                    shuffle=False) as theirs:
        it = iter(theirs)
        pre = _ids(next(it) for _ in range(3))
        state = json.loads(json.dumps(theirs.state_dict()))
        rest = _ids(it)
    with _port(store, 8, num_epochs=2, shuffle=False) as ours:
        ours.load_state_dict(ptck.from_reference_state(state))
        assert _ids(ours) == rest and len(pre + rest) == 16
    with ref_loader.InMemDataLoader(_reader(ref_reader, store), 8, shuffle=True,
                                    seed=5) as shuffled:
        with pytest.raises(ValueError, match="threefry"):
            ptck.from_reference_state(shuffled.state_dict())


@pytest.mark.gpu
def test_resume_on_the_card_serves_the_remaining_ids(store):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")

    def build():
        return InMemDataLoader(_reader(__import__("petastorm_tpu_torch.reader").reader,
                                       store), 8, num_epochs=2, seed=5, device="cuda")

    full = _ids(build())
    loader = build()
    it = iter(loader)
    pre = _ids(next(it) for _ in range(5))
    resumed = build()
    resumed.load_state_dict(loader.state_dict())
    assert pre + _ids(resumed) == full
    epoch = np.concatenate([np.asarray(b) for b in full[:8]])
    assert sorted(epoch) == list(range(ROWS))


# -- make_dataloader ----------------------------------------------------------------------


def test_make_dataloader_equals_the_two_call_form(store):
    kw = dict(reader_pool_type="dummy", shuffle_row_groups=True, seed=3)
    with make_dataloader(store, 16, device=CPU, last_batch="partial", **kw) as loader:
        ours = [_np(b) for b in loader]
        assert loader._seed == 3 and loader.last_batch == "partial"
    with DataLoader(make_batch_reader(store, num_epochs=1, **kw), 16, seed=3,
                    last_batch="partial", device=CPU) as loader:
        twice = [_np(b) for b in loader]
    assert len(ours) == len(twice) == 4
    for a, b in zip(ours, twice):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_make_dataloader_forwards_only_explicit_options(store):
    with make_dataloader(store, 16, device=CPU, reader_pool_type="dummy",
                         shard_seed=4) as loader:
        assert loader._seed == 4  # seed falls back to shard_seed
        assert loader.last_batch == "drop" and loader.prefetch == 2  # DataLoader's
    with make_dataloader(store, 16, device=CPU, reader_pool_type="dummy",
                         prefetch=0, host_queue_size=3) as loader:
        assert loader.prefetch == 0 and loader._host_queue_size == 3


def test_make_dataloader_cur_shard_defaults_to_the_gloo_rank(store, tmp_path):
    import multiprocessing

    from _torch_pool_helpers import gloo_make_dataloader_rank

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    outs = [str(tmp_path / ("rank%d.json" % r)) for r in range(2)]
    procs = [ctx.Process(target=gloo_make_dataloader_rank, args=(r, 2, port, store, outs[r]))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=150)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.terminate()
        p.join(10)
    assert not alive and [p.exitcode for p in procs] == [0, 0]
    results = [json.load(open(o)) for o in outs]
    shards = [set(r["ids"]) for r in results]
    assert [(r["cur_shard"], r["shard_count"]) for r in results] == [(0, 2), (1, 2)]
    assert all(len(r["ids"]) == len(set(r["ids"])) for r in results)
    assert not shards[0] & shards[1] and shards[0] | shards[1] == set(range(ROWS))
    # multi-card placement is ported: the reference's refusal of an unsharded
    # multi-process InMemDataLoader
    assert all("requires a sharding" in r["inmem_error"] for r in results)


def _slow_first_item_fill(store, **kwargs):
    """A fill over a four-worker thread pool whose item 0 finishes last (a chaos latency
    on its read), so the workers deliver the row groups out of the reader's order."""
    from petastorm_tpu_torch import chaos
    from petastorm_tpu_torch.chaos.plan import FaultPlan, FaultRule

    plan = FaultPlan([FaultRule("worker.item", "latency", item_key="ordinal=0 ",
                                latency_s=0.5)])
    with chaos.armed(plan, propagate=False):
        loader = _port(store, 8, num_epochs=2, shuffle=True, seed=5,
                       reader_kw={"reader_pool_type": "thread", "workers_count": 4},
                       **kwargs)
    assert plan.injections(), "the latency never fired"
    return loader


def test_multi_worker_fills_hold_the_readers_item_order_and_resume_exactly(store):
    """Two fills of one store on four workers hold the rows in the order one worker
    delivers them, and a cursor taken mid-epoch resumes over the second fill serving
    every row of the pass exactly once."""
    with _port(store, 8) as one:
        order = one._store["id"].tolist()
    first = _slow_first_item_fill(store)
    second = _slow_first_item_fill(store)
    assert first._store["id"].tolist() == second._store["id"].tolist() == order
    it = iter(first)
    pre = _ids(next(it) for _ in range(5))
    state = first.state_dict()
    assert (state["epoch"], state["batch"]) == (0, 5)
    second.load_state_dict(state)
    rest = _ids(second)
    served = [i for b in pre + rest for i in b]
    assert len(served) == 2 * ROWS
    assert sorted(served[:ROWS]) == sorted(served[ROWS:]) == list(range(ROWS))


def test_fill_order_sorts_a_scrambled_delivery_log():
    from petastorm_tpu_torch.loader import _fill_order
    from petastorm_tpu_torch.plan import EpochPlan, epoch_permutation

    plan = EpochPlan(list(range(4)), shuffle=True, seed=3)
    perm = [int(o) for o in epoch_permutation(4, 0, 3, True)]
    sizes = {0: 3, 1: 1, 2: 2, 3: 4}
    arrival = [perm[2], perm[0], perm[3], perm[1]]
    log = [(0, o, sizes[o]) for o in arrival]
    rows = np.concatenate([np.full(sizes[o], o) for o in arrival])
    order = _fill_order(plan, log, len(rows))
    assert rows[order].tolist() == [o for o in perm for _ in range(sizes[o])]
    in_order = [(0, o, sizes[o]) for o in perm]
    assert _fill_order(plan, in_order, 10) is None
    assert _fill_order(plan, log, 9) is None  # a log that does not cover the fill


def test_fill_order_leaves_a_grown_plan_in_arrival_order():
    from petastorm_tpu_torch.loader import _fill_order
    from petastorm_tpu_torch.plan import EpochPlan

    plan = EpochPlan(list(range(3)))
    log = [(0, 1, 2), (0, 0, 2)]
    assert _fill_order(plan, log, 4).tolist() == [2, 3, 0, 1]
    plan.extend([3])
    assert _fill_order(plan, log, 4) is None
