"""Multi-card placement of the port (``sharding=`` over a torch ``DeviceMesh``) against the
JAX package, on ``"cpu"`` meshes over gloo ranks.

One two-rank job (``_torch_rank_jobs.gloo_sharding_rank``, run once for the module) feeds
cases (a)-(f), one four-rank job cases (g); (h) runs in this process as a world of one.
Each rank joins with a 60 s deadline and each job is reaped after 240 s, so a hung rank
fails its case instead of hanging the suite.

- (a) scalar store, global batch 16 over 2 ranks: each rank cuts 8, and the DTensor's
  ``full_tensor()`` equals, id for id and value for value, the rank-order concatenation
  of the JAX package's batches of ``make_batch_reader(cur_shard=r, shard_count=2)`` +
  ``DataLoader(8)`` (what its multi-process assembly delivers); shards disjoint, union
  exact.
- (b) JPEG store, ``decode_on_device=True``: each rank's uint8 pixels, id for id,
  bit-identical to the JAX ``DataLoader``'s decode of the same ids; the normalising
  transform on the rank's rows within 1e-5 of the reference's; ``Shard(0)``;
  ``decode_unsharded_batches`` 0.
- (c) pass-through store, ``pagedec="on"``: each rank's columns byte-identical, per id, to
  the JAX reader's for the same shard; the inflate ran (compressed bytes shipped, no
  column inflated on the host).
- (d) ``device_shuffle_capacity`` with the sharding: exactly once an epoch across ranks,
  each rank only its shard, shuffled.
- (e) ``InMemDataLoader`` at 2 ranks: local batch 8 of a global 16, every batch global,
  each epoch's local ids exactly once, reshuffled between epochs, the batch count agreed,
  and a resume from ``state_dict`` on both ranks.
- (f) the refusals: an indivisible global batch, an undecomposable sharding (alone and in
  a dict), a device that contradicts the mesh, and the three ``InMemDataLoader`` ones.
- (g) ``sequence_sharding`` on a 2 x 2 (dp, sp) mesh against the JAX delivery over a
  2 x 2 mesh of virtual devices.
- (h) one rank: DTensors whose local values equal ``sharding=None``'s.
"""
import json
import multiprocessing
import os
import socket

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

cv2 = pytest.importorskip("cv2")
torch = pytest.importorskip("torch")

from _torch_pool_helpers import _no_leaked_shm_segments, no_leaked_port_slabs  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from petastorm_tpu import loader as ref_loader  # noqa: E402
from petastorm_tpu import metadata as ref_metadata  # noqa: E402
from petastorm_tpu import reader as ref_reader  # noqa: E402
from petastorm_tpu import types as ref_types  # noqa: E402
from petastorm_tpu.codecs import CompressedImageCodec as RefImage  # noqa: E402
from petastorm_tpu.codecs import ScalarCodec as RefScalar  # noqa: E402
from petastorm_tpu.ops.image import normalize_images as ref_normalize  # noqa: E402
from petastorm_tpu.unischema import Unischema as RefSchema  # noqa: E402
from petastorm_tpu.unischema import UnischemaField as RefField  # noqa: E402
from petastorm_tpu_torch import make_batch_reader  # noqa: E402
from petastorm_tpu_torch.loader import DataLoader, InMemDataLoader, make_dataloader  # noqa: E402

WORLD = 2
BATCH = 16          # global: 8 a rank
SCALAR_ROWS = 64    # 4 files of 2 row groups of 8
JPEG_ROWS, JPEG_BATCH, IMG = 32, 8, (32, 48, 3)
TAB_ROWS, TAB_RG, TAB_BATCH = 8192, 2048, 1024
RING = 16
SEQ_ROWS, SEQ, SEQ_BATCH = 32, 16, 8
JOB_DEADLINE_S = 240


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(target, world, cfg, tmp):
    """Spawn ``world`` ranks of ``target``; every rank must exit 0 within the deadline.
    Returns each rank's JSON (and ``.npz`` arrays where the rank wrote them)."""
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    outs = [os.path.join(tmp, "rank%d.json" % r) for r in range(world)]
    procs = [ctx.Process(target=target, args=(r, world, port, cfg, outs[r]))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=JOB_DEADLINE_S)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.terminate()
        p.join(10)
    assert not alive, "a rank did not end within %d s" % JOB_DEADLINE_S
    assert [p.exitcode for p in procs] == [0] * world
    results = [json.load(open(o)) for o in outs]
    for r, o in zip(results, outs):
        if os.path.exists(o + ".npz"):
            with np.load(o + ".npz") as z:
                r["arrays"] = dict(z)
    return results


def _write_scalar(root):
    os.makedirs(root)
    for f in range(4):
        ids = np.arange(f * 16, (f + 1) * 16, dtype=np.int64)
        pq.write_table(pa.table({"id": ids, "x": ids.astype(np.float32) * 0.5}),
                       os.path.join(root, "part-%d.parquet" % f), row_group_size=8)
    return "file://" + root


def _write_jpeg(root):
    schema = RefSchema("ShardSchema", [
        RefField("id", np.int64, (), RefScalar(ref_types.LongType()), False),
        RefField("image", np.uint8, IMG, RefImage("jpeg", 85), False),
    ])
    rng = np.random.RandomState(19)

    def rows():
        for i in range(JPEG_ROWS):
            noise = rng.randint(0, 256, IMG).astype(np.float32)
            yield {"id": i, "image": cv2.GaussianBlur(noise, (5, 5), 1.5).astype(np.uint8)}

    url = "file://" + root
    ref_metadata.write_dataset(url, schema, rows(), row_group_size_mb=0, rows_per_file=16)
    return url


def _write_tabular(root):
    """Compressible fixed-width columns (a low-cardinality int64, a float32 repeated in
    runs) in snappy row groups big enough for the pass-through to save bytes."""
    os.makedirs(root)
    rng = np.random.RandomState(20)
    pq.write_table(pa.table({
        "id": np.arange(TAB_ROWS, dtype=np.int64),
        "cat": rng.randint(0, 7, TAB_ROWS).astype(np.int64),
        "f": np.repeat(rng.rand(TAB_ROWS // 64).astype(np.float32), 64)}),
        os.path.join(root, "part-0.parquet"), row_group_size=TAB_RG, compression="snappy")
    return "file://" + root


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_sharding"))
    return {"scalar": _write_scalar(os.path.join(root, "scalar")),
            "jpeg": _write_jpeg(os.path.join(root, "jpeg")),
            "tab": _write_tabular(os.path.join(root, "tab")),
            "root": root}


@pytest.fixture(scope="module")
def job(stores):
    """The two-rank job of cases (a)-(f), run once."""
    from _torch_rank_jobs import gloo_sharding_rank

    cfg = {"scalar": stores["scalar"], "jpeg": stores["jpeg"], "tab": stores["tab"],
           "batch": BATCH, "jpeg_batch": JPEG_BATCH, "tab_batch": TAB_BATCH, "ring": RING}
    tmp = os.path.join(stores["root"], "job2")
    os.makedirs(tmp)
    return _run_ranks(gloo_sharding_rank, WORLD, cfg, tmp)


def _ref_batches(url, rank, batch, **kw):
    """The JAX package's batches of rank ``rank``'s shard, as numpy."""
    reader = ref_reader.make_batch_reader(url, cur_shard=rank, shard_count=WORLD,
                                          shuffle_row_groups=False, **kw)
    with ref_loader.DataLoader(reader, batch) as loader:
        return [{k: np.asarray(v) for k, v in b.items()} for b in loader]


# -- (a) the scalar store --------------------------------------------------------------


def test_each_rank_cuts_its_share_and_delivers_dtensors(job):
    for rank, r in enumerate(job):
        assert r["mesh"] == [[WORLD], ["dp"]]
        a = r["a"]
        assert a["local_batch_size"] == BATCH // WORLD
        assert len(a["batches"]) == SCALAR_ROWS // BATCH
        for b in a["batches"]:
            assert b["dtensor"] == ["id", "x"]
            assert b["shape"] == [BATCH] and b["placements"] == ["Shard(dim=0)"]
            assert len(b["local_ids"]) == BATCH // WORLD


def test_global_batches_equal_the_references_rank_order_concatenation(job, stores):
    theirs = [_ref_batches(stores["scalar"], r, BATCH // WORLD, reader_pool_type="dummy")
              for r in range(WORLD)]
    n = len(job[0]["a"]["batches"])
    assert all(len(t) == n for t in theirs)
    for i in range(n):
        for name in ("id", "x"):
            want = np.concatenate([t[i][name] for t in theirs])
            for r in job:  # every rank sees the same global batch
                got = r["arrays"]["a_%d_%s" % (i, name)]
                assert got.shape == want.shape
                np.testing.assert_array_equal(got, want)  # ids and values exact
        # the rank's local tensor is its slice of the global one
        for rank, r in enumerate(job):
            assert r["a"]["batches"][i]["local_ids"] == \
                theirs[rank][i]["id"].tolist()


def test_shards_are_disjoint_and_their_union_exact(job):
    shards = [{i for b in r["a"]["batches"] for i in b["local_ids"]} for r in job]
    assert not shards[0] & shards[1]
    assert shards[0] | shards[1] == set(range(SCALAR_ROWS))


# -- (b) the JPEG store, decoded on each rank's device ---------------------------------


def test_decoded_pixels_are_bit_identical_to_the_references_per_id(job, stores):
    def ref_transform(b):
        return {**b, "norm": ref_normalize(b["image"], [0.485, 0.456, 0.406],
                                           [0.229, 0.224, 0.225], out_dtype=jnp.float32)}

    for rank, r in enumerate(job):
        reader = ref_reader.make_batch_reader(
            stores["jpeg"], cur_shard=rank, shard_count=WORLD, workers_count=1,
            shuffle_row_groups=False, decode_on_device=True)
        with ref_loader.DataLoader(reader, JPEG_BATCH // WORLD,
                                   device_transform=ref_transform) as loader:
            theirs = [{k: np.asarray(v) for k, v in b.items()} for b in loader]
        ids = np.concatenate([t["id"] for t in theirs])
        images = np.concatenate([t["image"] for t in theirs])
        norms = np.concatenate([t["norm"] for t in theirs])
        b = r["b"]
        assert sorted(b["ids"]) == sorted(ids.tolist())
        order = {i: k for k, i in enumerate(ids.tolist())}
        for k, i in enumerate(b["ids"]):
            np.testing.assert_array_equal(r["arrays"]["b_images"][k], images[order[i]])
            # the normalising transform ran on the rank's rows: float32 within 1e-5
            np.testing.assert_allclose(r["arrays"]["b_norm"][k], norms[order[i]],
                                       rtol=0, atol=1e-5)
        assert r["arrays"]["b_images"].dtype == np.uint8


def test_decode_is_placed_shard_0_and_never_unsharded(job):
    for r in job:
        b = r["b"]
        assert b["placements"] == [["Shard(dim=0)"]]
        assert b["global_shape"] == [JPEG_BATCH] + list(IMG)
        assert b["decode_unsharded_batches"] == 0
    assert not set(job[0]["b"]["ids"]) & set(job[1]["b"]["ids"])
    assert set(job[0]["b"]["ids"]) | set(job[1]["b"]["ids"]) == set(range(JPEG_ROWS))


# -- (c) the pass-through --------------------------------------------------------------


def test_passthrough_columns_are_byte_identical_to_the_references_shard(job, stores):
    for rank, r in enumerate(job):
        c = r["c"]
        assert c["columns"] == ["cat", "f", "id"]
        assert c["bytes_compressed"] > 0 and c["host_inflate_columns"] == 0
        reader = ref_reader.make_batch_reader(stores["tab"], cur_shard=rank,
                                              shard_count=WORLD, workers_count=1,
                                              shuffle_row_groups=False)
        with reader:
            batches = list(reader)
        theirs = {k: np.concatenate([np.asarray(getattr(b, k)) for b in batches])
                  for k in ("id", "cat", "f")}
        got = {k: r["arrays"]["c_" + k] for k in ("id", "cat", "f")}
        assert sorted(got["id"].tolist()) == sorted(theirs["id"].tolist())
        order = np.argsort(theirs["id"])
        mine = np.argsort(got["id"])
        for k in ("cat", "f"):
            assert got[k].dtype == theirs[k].dtype
            assert got[k][mine].tobytes() == theirs[k][order].tobytes()


# -- (d) the device shuffle ring -------------------------------------------------------


def test_device_ring_is_exactly_once_across_ranks_and_keeps_each_ranks_shard(job):
    shards = [{i for b in r["a"]["batches"] for i in b["local_ids"]} for r in job]
    for r, shard in zip(job, shards):
        d = r["d"]
        assert d["dtensor"]
        assert len(d["ids"]) == len(set(d["ids"])) == len(shard)
        assert set(d["ids"]) == shard  # only this rank's rows, every one once
        assert d["ids"] != sorted(d["ids"])  # shuffled
    assert not set(job[0]["d"]["ids"]) & set(job[1]["d"]["ids"])


# -- (e) InMemDataLoader across ranks --------------------------------------------------


def test_inmem_two_ranks_serve_global_batches_of_their_shards(job):
    shards = [{i for b in r["a"]["batches"] for i in b["local_ids"]} for r in job]
    lens = {r["e"]["len"] for r in job}
    assert len(lens) == 1  # the batch count is agreed
    for rank, (r, shard) in enumerate(zip(job, shards)):
        e = r["e"]
        assert e["local_batch_size"] == BATCH // WORLD
        assert e["shapes"] == [[BATCH]]  # every batch is global
        assert e["rows"] == SCALAR_ROWS and e["cur_shard"] == rank
        e0, e1 = e["epochs"]
        assert len(e0) == len(set(e0)) == e["len"] * BATCH // WORLD
        assert set(e0) == set(e1) == shard  # each epoch serves the shard once
        assert e0 != e1  # reshuffled
    # each global batch is the ranks' local gathers in rank order
    for k, ids in enumerate(job[0]["e"]["global_ids"]):
        assert ids == job[0]["e"]["stream"][k] + job[1]["e"]["stream"][k]
        assert ids == job[1]["e"]["global_ids"][k]


def test_inmem_resume_from_state_dict_on_both_ranks(job):
    for r in job:
        e = r["e"]
        assert e["resume_state"] == [0, 3]
        # the three served before the save and the rest after it: the whole stream,
        # exactly once, in order
        assert e["resume_pre"] + e["resume_post"] == e["stream"]


# -- (f) the refusals ------------------------------------------------------------------


@pytest.mark.parametrize("case,words", [
    ("indivisible", "not divisible"),
    ("undecomposable", "cannot decompose the global batch"),
    ("undecomposable_dict", "cannot decompose the global batch"),
    ("device", "contradicts the sharding's mesh"),
    ("inmem_no_sharding", "requires a sharding"),
    ("inmem_partial", "last_batch='drop' only"),
    ("inmem_replicated", "replicated batch axis"),
])
def test_refusals_raise_the_references_error(job, case, words):
    for r in job:
        kind, message = r["f"][case]
        assert kind == "ValueError" and words in message


def test_indivisible_and_undecomposable_errors_match_the_reference(monkeypatch):
    """The JAX package's own words for the same two misconfigurations (its
    multi-process branch, reached by faking a two-process topology)."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec, SingleDeviceSharding

    mesh = Mesh(np.array(jax.devices()[:2]), ("dp",))
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    monkeypatch.setattr(jax, "process_index", lambda: 1)
    with pytest.raises(ValueError, match="not divisible"):
        ref_loader._resolve_local_batch(15, NamedSharding(mesh, PartitionSpec("dp")))
    with pytest.raises(ValueError, match="cannot decompose the global batch"):
        ref_loader._resolve_local_batch(16, SingleDeviceSharding(jax.devices()[0]))


# -- (g) sequence sharding on a 2 x 2 (dp, sp) mesh ------------------------------------


@pytest.fixture(scope="module")
def seq_store(tmp_path_factory):
    """32 rows of 16 tokens in row groups of 4: reader shards 0 and 1 (the mesh's dp
    coordinates) start with ids 0-3 and 4-7."""
    root = tmp_path_factory.mktemp("torch_seq") / "ds"
    os.makedirs(root)
    tokens = np.arange(SEQ_ROWS * SEQ, dtype=np.int32).reshape(SEQ_ROWS, SEQ)
    pq.write_table(pa.table({
        "id": np.arange(SEQ_ROWS, dtype=np.int64),
        "tokens": pa.FixedSizeListArray.from_arrays(tokens.reshape(-1), SEQ)}),
        str(root / "part-0.parquet"), row_group_size=4)
    return "file://" + str(root)


@pytest.fixture(scope="module")
def seq_job(seq_store, tmp_path_factory):
    from _torch_rank_jobs import gloo_sequence_rank

    tmp = str(tmp_path_factory.mktemp("torch_seq_job"))
    return _run_ranks(gloo_sequence_rank, 4,
                      {"url": seq_store, "seq": SEQ, "batch": SEQ_BATCH}, tmp)


def _reference_sequence_delivery(url):
    """The JAX package's delivery over a 2 x 2 (dp, sp) mesh of virtual devices
    (``tests/test_loader.py::test_sequence_sharded_batch_delivery``'s sharding)."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("dp", "sp"))
    sharding = {"tokens": NamedSharding(mesh, P("dp", "sp")),
                "id": NamedSharding(mesh, P("dp"))}
    reader = ref_reader.make_batch_reader(url, shuffle_row_groups=False, num_epochs=1,
                                          reader_pool_type="dummy")
    with ref_loader.DataLoader(reader, batch_size=SEQ_BATCH, sharding=sharding) as loader:
        batch = next(iter(loader))
    assert batch["tokens"].addressable_shards[0].data.shape == (SEQ_BATCH // 2, SEQ // 2)
    return np.asarray(batch["tokens"]), np.asarray(batch["id"])


def test_sequence_sharding_sliced_feed_equals_the_references_delivery(seq_job, seq_store):
    tokens, ids = _reference_sequence_delivery(seq_store)
    assert sorted(tuple(r["coordinate"]) for r in seq_job) == [(0, 0), (0, 1), (1, 0),
                                                              (1, 1)]
    for r in seq_job:
        s = r["sliced"]
        assert s["local_batch_size"] == SEQ_BATCH // 2
        assert s["placements"] == ["Shard(dim=0)", "Shard(dim=1)"]
        assert s["local_shape"] == [SEQ_BATCH // 2, SEQ // 2]
        assert s["shape"] == list(tokens.shape) == [SEQ_BATCH, SEQ]
        np.testing.assert_array_equal(np.array(s["tokens"]), tokens)
        np.testing.assert_array_equal(np.array(s["ids"]), ids)


def test_sequence_sharding_whole_feed_is_cut_to_the_ranks_part(seq_job, seq_store):
    """Fed whole sequences, the delivery cuts each rank's rows to its sp part, so the
    global batch is the reference's delivery of the sliced feed. The JAX package's
    ``jax.make_array_from_process_local_data`` would take the whole rows as the sp slice
    and double the sequence axis (ROADMAP.md "By design")."""
    tokens, ids = _reference_sequence_delivery(seq_store)
    for r in seq_job:
        w = r["whole"]
        assert w["local_batch_size"] == SEQ_BATCH // 2
        assert w["placements"] == ["Shard(dim=0)", "Shard(dim=1)"]
        assert w["local_shape"] == [SEQ_BATCH // 2, SEQ // 2]
        assert w["shape"] == list(tokens.shape) == [SEQ_BATCH, SEQ]
        np.testing.assert_array_equal(np.array(w["tokens"]), tokens)
        np.testing.assert_array_equal(np.array(w["ids"]), ids)


def test_sequence_sharding_make_dataloader_reads_the_batch_coordinates_shard(seq_job,
                                                                             seq_store):
    """``make_dataloader`` with no ``cur_shard`` reads the shard of the rank's dp
    coordinate: the two sp ranks of a dp row read the same rows (the JAX package would
    shard by the process index over four shards)."""
    tokens, _ids = _reference_sequence_delivery(seq_store)
    for r in seq_job:
        m = r["made"]
        assert m["shard"] == [r["coordinate"][0], 2]
        assert m["shape"] == [SEQ_BATCH, SEQ]
        np.testing.assert_array_equal(np.array(m["tokens"]), tokens)


# -- (h) a world of one ----------------------------------------------------------------


@pytest.fixture
def one_rank():
    """A gloo group of one in this process, torn down after the case."""
    import datetime

    import torch.distributed as dist

    dist.init_process_group("gloo", init_method="tcp://127.0.0.1:%d" % _free_port(),
                            world_size=1, rank=0, timeout=datetime.timedelta(seconds=60))
    try:
        yield
    finally:
        dist.destroy_process_group()


def _plain(batch):
    return {k: (v.to_local() if hasattr(v, "to_local") else v).numpy()
            for k, v in batch.items()}


def test_one_rank_delivers_dtensors_equal_to_the_unsharded_loader(one_rank, stores):
    from torch.distributed.tensor import DTensor

    from petastorm_tpu_torch.parallel.mesh import batch_sharding, make_mesh

    s = batch_sharding(make_mesh(device_type="cpu"))
    kw = dict(reader_pool_type="dummy", shuffle_row_groups=False)
    with make_dataloader(stores["scalar"], BATCH, sharding=s, device="cpu", **kw) as ld:
        assert ld.local_batch_size == BATCH and ld.device == torch.device("cpu")
        sharded = list(ld)
    with DataLoader(make_batch_reader(stores["scalar"], **kw), BATCH, device="cpu") as ld:
        plain = list(ld)
    assert len(sharded) == len(plain) == SCALAR_ROWS // BATCH
    for a, b in zip(sharded, plain):
        assert all(isinstance(v, DTensor) and v.shape == b[k].shape for k, v in a.items())
        for k, v in _plain(a).items():
            np.testing.assert_array_equal(v, b[k].numpy())


def test_one_rank_inmem_and_ring_deliver_dtensors_equal_to_unsharded(one_rank, stores):
    from torch.distributed.tensor import DTensor

    from petastorm_tpu_torch.ops.device_shuffle import DeviceShuffleBuffer
    from petastorm_tpu_torch.parallel.mesh import batch_sharding, make_mesh

    s = batch_sharding(make_mesh(device_type="cpu"))

    def inmem(sharding):
        reader = make_batch_reader(stores["scalar"], reader_pool_type="dummy",
                                   shuffle_row_groups=False)
        with InMemDataLoader(reader, 12, seed=1, sharding=sharding, last_batch="partial",
                             device="cpu") as loader:
            assert loader.cur_shard is None and len(loader) == 6
            return list(loader)

    sharded, plain = inmem(s), inmem(None)
    for a, b in zip(sharded, plain):  # the short tail (4 rows) is laid out too
        assert all(isinstance(v, DTensor) for v in a.values())
        for k, v in _plain(a).items():
            np.testing.assert_array_equal(v, b[k].numpy())
    # the ring alone: DTensors (or plain tensors) in, the rank's rows kept, DTensors out
    seen = []
    buf = DeviceShuffleBuffer(8, seed=0, shardings=lambda name, arr: s)
    for lo in range(0, 24, 4):
        ids = torch.arange(lo, lo + 4)
        out = buf.push({"id": ids if lo % 8 else DTensor.from_local(ids, s.mesh)})
        if out is not None:
            assert isinstance(out["id"], DTensor)
            seen.extend(out["id"].to_local().tolist())
    seen.extend(i for o in buf.drain() for i in o["id"].to_local().tolist())
    assert sorted(seen) == list(range(24))
