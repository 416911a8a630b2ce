"""Port vs reference: the exact-resume cursor and its checkpoints. ``Reader.state_dict()``
equals the JAX package's after the same deliveries; a state saved by either package
resumes the other's reader exactly; ``checkpoint.save``/``restore`` (``torch.save``) and
``torch.distributed.checkpoint`` (``state_item``) resume with nothing lost; the loader's
consumer watermark; the error cases; shard routing; and one 2-rank gloo job."""
import json
import os
import socket

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

torch = pytest.importorskip("torch")

from _torch_pool_helpers import _no_leaked_shm_segments, no_leaked_port_slabs  # noqa: E402,F401
from petastorm_tpu import predicates as ref_predicates  # noqa: E402
from petastorm_tpu import reader as ref_reader  # noqa: E402
from petastorm_tpu_torch import checkpoint as ptck  # noqa: E402
from petastorm_tpu_torch import predicates  # noqa: E402
from petastorm_tpu_torch import reader as port_reader  # noqa: E402
from petastorm_tpu_torch.loader import DataLoader  # noqa: E402

ROWS, RG = 64, 8


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """64 rows in two files of four row groups of 8; ``id`` and a ``val`` column."""
    root = tmp_path_factory.mktemp("torch_ckpt") / "ds"
    os.makedirs(root)
    for f in range(2):
        ids = np.arange(f * 32, (f + 1) * 32, dtype=np.int64)
        pq.write_table(pa.table({"id": ids, "val": ids.astype(np.float32) * 0.5}),
                       str(root / ("part-%d.parquet" % f)), row_group_size=RG)
    return "file://" + str(root)


def _ids(batch):
    return [int(i) for i in np.atleast_1d(np.asarray(batch.id))]


def _reader(module, url, **kwargs):
    kw = dict(shuffle_row_groups=True, seed=7, num_epochs=1, reader_pool_type="dummy")
    kw.update(kwargs)
    return module.make_batch_reader(url, **kw)


# -- the reader's state against the reference's ------------------------------------------


CONFIGS = {
    "shuffled": {},
    "ordered_two_epochs": dict(shuffle_row_groups=False, num_epochs=2),
    "row_drop_partitions": dict(shuffle_row_drop_partitions=3, seed=2),
    "predicate": dict(predicate="split"),
    "filters": dict(filters=[("id", "not in", list(range(8, 24)))]),
    "sharded": dict(cur_shard=1, shard_count=3, shard_seed=9),
    "infinite": dict(num_epochs=None),
}


def _config(name, module):
    kw = dict(CONFIGS[name])
    if kw.get("predicate") == "split":
        mod = predicates if module is port_reader else ref_predicates
        kw["predicate"] = mod.in_pseudorandom_split([0.5, 0.5], 0, "id")
    return kw


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("deliveries", [0, 1, 3, 9])
def test_state_dict_equals_the_references_after_the_same_deliveries(store, name,
                                                                    deliveries):
    states = []
    for module in (port_reader, ref_reader):
        with _reader(module, store, **_config(name, module)) as r:
            it = iter(r)
            for _ in range(deliveries):
                if next(it, None) is None:
                    break
            states.append(r.state_dict())
    assert states[0] == states[1]
    assert json.dumps(states[0], sort_keys=True) == json.dumps(states[1], sort_keys=True)


def test_per_row_state_dict_equals_the_references(tmp_path):
    """The per-row reader marks a row group consumed at its last row, as the reference."""
    from petastorm_tpu_torch import types
    from petastorm_tpu_torch.codecs import ScalarCodec
    from petastorm_tpu_torch.metadata import write_dataset
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField

    url = "file://" + str(tmp_path / "rows")
    schema = Unischema("Rows", [UnischemaField("id", np.int64, (), ScalarCodec(
        types.LongType()), False)])
    write_dataset(url, schema, ({"id": i} for i in range(30)), rows_per_file=10)
    for taken in (0, 3, 5, 8, 15):  # 15 even ids in all
        states = []
        for module, mod in ((port_reader, predicates), (ref_reader, ref_predicates)):
            with module.make_reader(url, reader_pool_type="dummy", seed=3,
                                    predicate=mod.in_set(set(range(0, 30, 2)), "id"),
                                    shuffle_row_drop_partitions=2) as r:
                it = iter(r)
                for _ in range(taken):
                    next(it)
                states.append(r.state_dict())
        assert states[0] == states[1], taken


def _resume_across(save_module, load_module, store, deliveries, **kwargs):
    """Deliver ``deliveries`` batches from ``save_module``'s reader, carry its state as
    JSON, and finish the epoch on ``load_module``'s reader."""
    with _reader(save_module, store, **kwargs) as r:
        it = iter(r)
        pre = [i for _ in range(deliveries) for i in _ids(next(it))]
        state = json.loads(json.dumps(r.state_dict()))
    resumed = _reader(load_module, store, **kwargs)
    if load_module is port_reader:
        resumed.load_state_dict(ptck.from_reference_state(state))
    else:
        from petastorm_tpu.checkpoint import _denormalize

        resumed.load_state_dict(_denormalize(state))
    with resumed:
        post = [i for b in resumed for i in _ids(b)]
        crc = resumed.state_dict()["items_crc"]
    assert crc == state["items_crc"]
    return pre, post


@pytest.mark.parametrize("direction", ["reference_to_port", "port_to_reference"])
@pytest.mark.parametrize("deliveries", [1, 4])
def test_a_state_saved_by_either_package_resumes_the_other(store, direction, deliveries):
    save, load = (ref_reader, port_reader) if direction == "reference_to_port" \
        else (port_reader, ref_reader)
    for kw in ({}, dict(shuffle_row_drop_partitions=2)):
        pre, post = _resume_across(save, load, store, deliveries, **kw)
        assert sorted(pre + post) == list(range(ROWS))
        assert not set(pre) & set(post)  # exactly once across the restart


def test_from_reference_state_takes_json_and_global_payloads(store):
    with _reader(ref_reader, store) as r:
        it = iter(r)
        next(it)
        next(it)
        state = r.state_dict()
    ported = ptck.from_reference_state(json.dumps(state))
    assert ported == state and all(isinstance(e, int) for e in ported["consumed"])
    payload = {ptck._GLOBAL_KEY: {"0": json.loads(json.dumps(state))}}
    assert ptck.from_reference_state(payload) == {ptck._GLOBAL_KEY: {"0": state}}
    with pytest.raises(ValueError, match="not a Reader state"):
        ptck.from_reference_state({"plan": {}})


# -- checkpoint.save / restore and torch.distributed.checkpoint ------------------------


def test_standalone_save_restore_exact_resume(store, tmp_path):
    reader = _reader(port_reader, store)
    with reader:
        it = iter(reader)
        before = _ids(next(it)) + _ids(next(it))
        ptck.save(str(tmp_path / "ckpt" / "data.pt"), reader)
    resumed = _reader(port_reader, store)
    ptck.restore(str(tmp_path / "ckpt" / "data.pt"), resumed)
    with resumed:
        after = [i for b in resumed for i in _ids(b)]
    assert sorted(before + after) == list(range(ROWS))
    assert not set(before) & set(after)  # the dummy pool has nothing in flight


def test_dcp_save_beside_a_model_resumes_exactly(store, tmp_path):
    import torch.distributed.checkpoint as dcp

    model = torch.nn.Linear(3, 2)
    torch.nn.init.constant_(model.weight, 0.5)
    loader = DataLoader(_reader(port_reader, store, shuffle_row_groups=False), RG,
                        device="cpu", prefetch=0)
    with loader:
        it = iter(loader)
        pre = [i for _ in range(3) for i in next(it)["id"].tolist()]
        dcp.save({"model": model.state_dict(), "data": ptck.state_item(loader)},
                 checkpoint_id=str(tmp_path / "dcp"))
    fresh = torch.nn.Linear(3, 2)
    resumed = DataLoader(_reader(port_reader, store, shuffle_row_groups=False), RG,
                         device="cpu")
    target = {"model": fresh.state_dict(), "data": ptck.state_item(resumed)}
    dcp.load(target, checkpoint_id=str(tmp_path / "dcp"))
    fresh.load_state_dict(target["model"])
    assert torch.equal(fresh.weight, model.weight)
    with resumed:
        post = [i for b in resumed for i in b["id"].tolist()]
    assert pre == list(range(24))
    assert sorted(pre + post) == list(range(ROWS)) and not set(pre) & set(post)


# -- errors and routing ----------------------------------------------------------------


def test_restore_into_a_mismatched_reader_raises(store, tmp_path):
    reader = _reader(port_reader, store)
    with reader:
        next(iter(reader))
        ptck.save(str(tmp_path / "c2.pt"), reader)
    pq.write_table(pa.table({"id": np.arange(5, dtype=np.int64)}),
                   str(tmp_path / "p.parquet"))
    wrong = port_reader.make_batch_reader("file://" + str(tmp_path / "p.parquet"),
                                          reader_pool_type="dummy")
    with wrong, pytest.raises(ValueError, match="work items"):
        ptck.restore(str(tmp_path / "c2.pt"), wrong)


def test_a_changed_item_order_fails_the_crc_check(store, tmp_path):
    """Same number of work items, other identities: the consumed ordinals would point
    at other row groups, so the restore refuses."""
    with _reader(port_reader, store) as r:
        next(iter(r))
        state = r.state_dict()
    other = tmp_path / "other"
    os.makedirs(other)
    for f in range(2):
        pq.write_table(pa.table({"id": np.arange(32, dtype=np.int64)}),
                       str(other / ("q-%d.parquet" % f)), row_group_size=RG)
    wrong = _reader(port_reader, "file://" + str(other))
    with wrong, pytest.raises(ValueError, match="item order"):
        wrong.load_state_dict(state)


def _sharded(url, shard):
    return port_reader.make_batch_reader(url, cur_shard=shard, shard_count=2,
                                         shard_seed=0, shuffle_row_groups=False,
                                         num_epochs=1, reader_pool_type="dummy")


def test_cross_shard_state_raises(store):
    with _sharded(store, 0) as r:
        next(iter(r))
        state = r.state_dict()
    with _sharded(store, 1) as other, pytest.raises(ValueError, match="wrong rows"):
        other.load_state_dict(state)


def test_global_payload_routes_by_shard(store):
    states, pre = {}, {}
    for shard in (0, 1):
        with _sharded(store, shard) as r:
            it = iter(r)
            pre[shard] = [i for _ in range(1 + shard) for i in _ids(next(it))]
            states[str(shard)] = r.state_dict()
    payload = {ptck._GLOBAL_KEY: json.loads(json.dumps(states))}
    delivered = []
    for shard in (0, 1):
        resumed = _sharded(store, shard)
        ptck.apply(resumed, payload)
        with resumed:
            rows = pre[shard] + [i for b in resumed for i in _ids(b)]
        assert len(rows) == len(set(rows))
        delivered += rows
    assert sorted(delivered) == list(range(ROWS))


def test_global_payload_missing_shard_raises(store):
    with _sharded(store, 0) as r:
        next(iter(r))
        state = r.state_dict()
    with _sharded(store, 1) as resumed, pytest.raises(ValueError,
                                                      match="no entry for shard"):
        ptck.apply(resumed, {ptck._GLOBAL_KEY: {"0": state}})


def test_replica_group_duplicate_keys_intersect_consumed():
    plan = {"num_items": 8, "seed": 3, "shuffle": True, "num_epochs": 1}
    ahead = {"plan": plan, "resume_epoch": 1, "consumed": {0: [0, 1], 1: [2]}}
    behind = {"plan": plan, "resume_epoch": 0, "consumed": {0: [0]}}
    divergent = {"plan": plan, "resume_epoch": 0, "consumed": {0: [4]}}
    for order in ([["0", ahead], ["0", behind]], [["0", behind], ["0", ahead]]):
        merged = ptck._merge_states(order + [["1", ahead]])
        assert merged["0"]["resume_epoch"] == 0
        assert merged["0"]["consumed"] == {0: [0]}
        assert merged["1"] == ahead
    assert ptck._merge_states([["0", behind], ["0", divergent]])["0"]["consumed"] == {}
    assert ptck._merge_states([["0", ahead], ["0", ahead]]) == {"0": ahead}
    with pytest.raises(ValueError, match="different plans"):
        ptck._merge_states([["0", ahead], ["0", {"plan": dict(plan, seed=9),
                                                 "resume_epoch": 0, "consumed": {0: [0]}}]])


def test_merge_states_equals_the_references():
    from petastorm_tpu.checkpoint import _merge_states as ref_merge

    rng = np.random.RandomState(0)
    plan = {"num_items": 16, "seed": 1, "shuffle": True, "num_epochs": 3}
    pairs = []
    for k in range(12):
        consumed = {e: sorted(rng.choice(16, rng.randint(1, 9), replace=False).tolist())
                    for e in range(rng.randint(1, 3))}
        pairs.append([str(k % 4), {"plan": plan, "resume_epoch": int(rng.randint(0, 2)),
                                   "consumed": consumed}])
    assert ptck._merge_states(pairs) == ref_merge(pairs)


# -- the loader's consumer watermark -------------------------------------------------


def test_loader_state_dict_is_the_consumer_watermark(store):
    pre = []
    loader = DataLoader(_reader(port_reader, store, shuffle_row_groups=False), RG,
                        prefetch=3, host_queue_size=8, device="cpu")
    with loader:
        it = iter(loader)
        for _ in range(3):
            pre += next(it)["id"].tolist()
        state = loader.state_dict()
    assert pre == list(range(24))
    resumed = DataLoader(_reader(port_reader, store, shuffle_row_groups=False), RG,
                         device="cpu")
    resumed.load_state_dict(state)
    with resumed:
        post = [i for b in resumed for i in b["id"].tolist()]
    assert sorted(pre + post) == list(range(ROWS)) and not set(pre) & set(post)


def test_loader_watermark_beats_the_readers_state(store):
    """The reader runs ahead of the consumer (prefetch): restoring the READER's state
    loses the rows in the loader's queues; the loader's watermark replays them."""
    import time

    loader = DataLoader(_reader(port_reader, store, shuffle_row_groups=False), RG,
                        prefetch=3, host_queue_size=8, device="cpu")
    with loader:
        it = iter(loader)
        pre = next(it)["id"].tolist()
        time.sleep(0.5)  # the producer runs ahead into the queues
        reader_state = loader.reader.state_dict()
        loader_state = loader.state_dict()

    def rows_after(state):
        resumed = DataLoader(_reader(port_reader, store, shuffle_row_groups=False), RG,
                             device="cpu")
        resumed.load_state_dict(state)
        with resumed:
            return [i for b in resumed for i in b["id"].tolist()]

    assert set(pre) | set(rows_after(reader_state)) != set(range(ROWS))
    assert sorted(pre + rows_after(loader_state)) == list(range(ROWS))


@pytest.mark.parametrize("kwargs", [{"shuffling_queue_capacity": 16},
                                    {"device_shuffle_capacity": 16}],
                         ids=["host_buffer", "device_ring"])
def test_a_shuffling_loader_refuses_to_checkpoint(store, kwargs):
    loader = DataLoader(_reader(port_reader, store), RG, device="cpu", **kwargs)
    with loader:
        next(iter(loader))
        with pytest.raises(ValueError, match="epoch boundary"):
            loader.state_dict()


def test_loader_resume_across_an_epoch_boundary(store):
    """Two epochs through the loader: a checkpoint taken in the second epoch resumes
    with the first epoch done and the second's remainder, each row once."""
    def build():
        return DataLoader(_reader(port_reader, store, num_epochs=2), RG, device="cpu",
                          prefetch=2)

    loader = build()
    with loader:
        it = iter(loader)
        pre = [i for _ in range(11) for i in next(it)["id"].tolist()]  # 8 a epoch
        state = loader.state_dict()
    assert state["resume_epoch"] == 1
    resumed = build()
    resumed.load_state_dict(json.loads(json.dumps(state)))
    with resumed:
        post = [i for b in resumed for i in b["id"].tolist()]
    assert sorted(pre + post) == sorted(list(range(ROWS)) * 2)


def test_loader_watermark_on_the_passthrough(tmp_path, monkeypatch):
    """Compressed-page pass-through batches count when their inflated columns are
    handed to the consumer: the resume loses nothing (the CPU runs the kernels' plain
    versions with ``PTPU_PAGEDEC_DEVICE=1``)."""
    monkeypatch.setenv("PTPU_PAGEDEC_DEVICE", "1")
    root = tmp_path / "pd"
    os.makedirs(root)
    n = 256
    pq.write_table(pa.table({"id": np.arange(n, dtype=np.int64),
                             "cat": (np.arange(n) % 3).astype(np.int64)}),
                   str(root / "p.parquet"), row_group_size=32, compression="snappy")
    url = "file://" + str(root)

    def build():
        reader = port_reader.make_batch_reader(url, reader_pool_type="dummy",
                                               shuffle_row_groups=False,
                                               io_options={"pagedec": "on"})
        return DataLoader(reader, 32, device="cpu", prefetch=2)

    loader = build()
    with loader:
        it = iter(loader)
        pre = [i for _ in range(3) for i in next(it)["id"].tolist()]
        state = loader.state_dict()
    resumed = build()
    ptck.apply(resumed, state)
    with resumed:
        post = [(i, c) for b in resumed for i, c in zip(b["id"].tolist(),
                                                       b["cat"].tolist())]
    assert sorted(pre + [i for i, _c in post]) == list(range(n))
    assert all(c == i % 3 for i, c in post)


# -- torch.distributed: two ranks on gloo ----------------------------------------------


def test_global_state_dict_over_two_gloo_ranks(store, tmp_path):
    """Two processes, each a shard: ``save`` gathers both states into one file, each
    rank restores its own shard, and the job delivers every row once."""
    import multiprocessing

    from _torch_pool_helpers import gloo_checkpoint_rank

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    outs = [str(tmp_path / ("rank%d.json" % r)) for r in range(2)]
    procs = [ctx.Process(target=gloo_checkpoint_rank,
                         args=(r, 2, port, store, str(tmp_path / "job.pt"), outs[r]))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=150)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.terminate()
        p.join(10)
    assert not alive, "a rank did not finish within its timeout"
    assert [p.exitcode for p in procs] == [0, 0]
    results = [json.load(open(o)) for o in outs]
    delivered = []
    for r, res in enumerate(results):
        assert res["payload_keys"] == ["0", "1"]
        assert len(res["pre"]) == (r + 1) * RG
        assert not set(res["pre"]) & set(res["post"])
        delivered += res["pre"] + res["post"]
    assert sorted(delivered) == list(range(ROWS))
    saved = torch.load(str(tmp_path / "job.pt"), weights_only=True)
    assert sorted(saved[ptck._GLOBAL_KEY]) == ["0", "1"]


def test_the_watermark_never_runs_ahead_of_the_consumer(tmp_path):
    """Stress: four reader threads, a prefetching loader and a short switch interval;
    after every batch the loader's state counts no row group the consumer has not
    taken in full (a lost update of the consumer count would break this)."""
    import sys

    root = tmp_path / "many"
    os.makedirs(root)
    pq.write_table(pa.table({"id": np.arange(1024, dtype=np.int64)}),
                   str(root / "p.parquet"), row_group_size=4)
    reader = port_reader.make_batch_reader("file://" + str(root), workers_count=4,
                                           shuffle_row_groups=False, num_epochs=1)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        taken = set()
        with DataLoader(reader, 12, device="cpu", prefetch=4, host_queue_size=2,
                        last_batch="partial") as loader:
            for batch in loader:
                taken |= set(batch["id"].tolist())
                state = loader.state_dict()
                done = {o for v in state["consumed"].values() for o in v}
                assert state["resume_epoch"] == 0 or len(taken) == 1024
                # ordinal o is row group o (no shuffling): its four rows were all taken
                assert all({4 * o, 4 * o + 1, 4 * o + 2, 4 * o + 3} <= taken for o in done)
    finally:
        sys.setswitchinterval(interval)
    assert len(taken) == 1024
