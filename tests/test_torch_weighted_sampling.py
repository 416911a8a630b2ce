"""Port vs reference: ``WeightedSamplingReader``. For the same seed the port's draw
sequence and items are bit for bit the JAX package's (numpy ``PCG64`` in both); the mix
follows its probabilities; the agreement checks on the mixed readers; exact resume
through ``state_dict``, ``checkpoint.save``/``restore`` and DCP; a JAX-saved state resumes
the port's mixer; the mismatch and exhaustion cases of the JAX package's checkpoint
tests; and the mixer under the port's ``DataLoader``, whose reader hooks it forwards
(the view wire's leases, the pass-through adoption on every sub-reader, the pool's
gauges, the consumer watermark)."""
import json
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

torch = pytest.importorskip("torch")

from _torch_pool_helpers import _no_leaked_shm_segments, no_leaked_port_slabs  # noqa: E402,F401
from petastorm_tpu import reader as ref_reader  # noqa: E402
from petastorm_tpu.weighted_sampling import WeightedSamplingReader as RefMixer  # noqa: E402
from petastorm_tpu_torch import checkpoint as ptck  # noqa: E402
from petastorm_tpu_torch import make_batch_reader, make_reader  # noqa: E402
from petastorm_tpu_torch import reader as port_reader  # noqa: E402
from petastorm_tpu_torch.loader import DataLoader  # noqa: E402
from petastorm_tpu_torch.weighted_sampling import WeightedSamplingReader  # noqa: E402

CPU = "cpu"


def _write(root, name, lo, n, rg):
    path = os.path.join(root, name)
    os.makedirs(path)
    ids = np.arange(lo, lo + n, dtype=np.int64)
    # repeated floats and a low-cardinality int: columns the pass-through takes
    pq.write_table(pa.table({"id": ids, "v": np.tile(np.arange(4, dtype=np.float32), n // 4),
                             "k": (ids % 3).astype(np.int64)}),
                   os.path.join(path, "p.parquet"), row_group_size=rg,
                   compression="snappy")
    return "file://" + path


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """Three stores: 64 rows in row groups of 8 (ids 0-63), 96 in row groups of 8 (ids
    1000-1095) and 8 rows in one row group (ids 5000-5007)."""
    root = str(tmp_path_factory.mktemp("torch_mix"))
    return [_write(root, "a", 0, 64, 8), _write(root, "b", 1000, 96, 8),
            _write(root, "small", 5000, 8, 8)]


def _readers(module, urls, **kwargs):
    kw = dict(shuffle_row_groups=False, num_epochs=1, reader_pool_type="dummy")
    kw.update(kwargs)
    return [module.make_batch_reader(u, **kw) for u in urls]


def _port_mixer(urls, p=(0.5, 0.5), seed=3, **kwargs):
    return WeightedSamplingReader(_readers(port_reader, urls, **kwargs), list(p), seed=seed)


def _ref_mixer(urls, p=(0.5, 0.5), seed=3, **kwargs):
    return RefMixer(_readers(ref_reader, urls, **kwargs), list(p), seed=seed)


def _ids(batches):
    return [tuple(int(x) for x in np.asarray(b.id)) for b in batches]


@pytest.mark.parametrize("seed,p", [(3, (0.5, 0.5)), (0, (0.7, 0.3)), (11, (0.1, 0.9))])
def test_draws_and_items_bit_identical_to_the_reference(stores, seed, p):
    with _port_mixer(stores[:2], p, seed) as ours, _ref_mixer(stores[:2], p, seed) as theirs:
        a, b = [], []
        for x in ours:
            a.append(x)
            assert ours._rng.bit_generator.state is not None
        for x in theirs:
            b.append(x)
        assert ours._rng.bit_generator.state == theirs._rng.bit_generator.state
    assert _ids(a) == _ids(b) and len(a) == 8 + 12
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.v, y.v)
        np.testing.assert_array_equal(x.k, y.k)


def test_the_draw_sequence_is_numpys_pcg64_choice(stores):
    """While both readers are alive each item's origin follows ``Generator(PCG64(seed))
    .choice([0, 1], p=p)``, drawn here from numpy directly."""
    rng = np.random.Generator(np.random.PCG64(0))
    with _port_mixer(stores[:2], (0.7, 0.3), 0) as mixer:
        origins = [0 if x.id[0] < 1000 else 1 for x in mixer]
    alive_draws = []
    left = [8, 12]
    for got in origins:
        if min(left) == 0:
            break
        alive_draws.append(int(rng.choice([0, 1], p=[0.7, 0.3])))
        left[got] -= 1
    assert origins[:len(alive_draws)] == alive_draws and len(alive_draws) >= 10


def test_ratios_follow_the_probabilities(tmp_path):
    urls = [_write(str(tmp_path), "x", 0, 4000, 4), _write(str(tmp_path), "y", 10000, 4000, 4)]
    with _port_mixer(urls, (0.7, 0.3), 1) as mixer:
        origins = []
        for x in mixer:
            origins.append(0 if x.id[0] < 10000 else 1)
            if len(origins) == 800:
                break
    share = origins.count(0) / len(origins)
    assert 0.65 < share < 0.75


def test_agreement_checks(stores):
    readers = [make_batch_reader(stores[0], reader_pool_type="dummy")]
    from petastorm_tpu_torch import metadata, types
    from petastorm_tpu_torch.codecs import ScalarCodec
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField

    schema = Unischema("S", [UnischemaField("id", np.int64, (), ScalarCodec(types.LongType()),
                                            False)])
    url = stores[0].replace("/a", "/rows")
    metadata.write_dataset(url, schema, ({"id": i} for i in range(4)), rows_per_file=4)
    readers.append(make_reader(url, reader_pool_type="dummy"))
    try:
        with pytest.raises(ValueError, match="per-row and batched"):
            WeightedSamplingReader(readers, [0.5, 0.5])
        with pytest.raises(ValueError, match="equal length"):
            WeightedSamplingReader(readers[:1], [0.5, 0.5])
        with pytest.raises(ValueError, match="non-negative"):
            WeightedSamplingReader(readers[:1], [-1.0])
        staged = make_reader(url, reader_pool_type="dummy")
        readers.append(staged)
        staged.device_decode_fields = frozenset({"image"})
        with pytest.raises(ValueError, match="same device-decode fields"):
            WeightedSamplingReader(readers[1:], [0.5, 0.5])
    finally:
        for r in readers:
            r.stop()
            r.join()


# -- resume -------------------------------------------------------------------------------


def test_state_dict_exact_resume_and_equal_to_the_references(stores):
    with _port_mixer(stores[:2]) as full_reader:
        full = _ids(full_reader)
    mixer, ref = _port_mixer(stores[:2]), _ref_mixer(stores[:2])
    it, ref_it = iter(mixer), iter(ref)
    pre = _ids([next(it) for _ in range(5)])
    ref_pre = _ids([next(ref_it) for _ in range(5)])
    state = mixer.state_dict()
    assert json.loads(json.dumps(state)) == json.loads(json.dumps(ref.state_dict()))
    for m in (mixer, ref):
        m.stop()
        m.join()
    resumed = _port_mixer(stores[:2])
    resumed.load_state_dict(state)
    with resumed:
        post = _ids(resumed)
    assert pre == ref_pre == full[:5]
    assert post == full[5:]


def test_a_jax_saved_state_resumes_the_ports_mixer(stores):
    with _ref_mixer(stores[:2], (0.6, 0.4), 9) as ref_full:
        full = _ids(ref_full)
    ref = _ref_mixer(stores[:2], (0.6, 0.4), 9)
    it = iter(ref)
    pre = _ids([next(it) for _ in range(7)])
    saved = json.dumps(ref.state_dict())
    ref.stop()
    ref.join()
    ours = _port_mixer(stores[:2], (0.6, 0.4), 9)
    ours.load_state_dict(ptck.from_reference_state(saved))
    with ours:
        assert pre + _ids(ours) == full


def test_save_restore_and_dcp_with_an_exhausted_sub_reader(stores, tmp_path):
    """The JAX package's orbax-and-exhaustion case through ``torch.save`` and DCP: a
    sub-reader exhausted before the save restores as exhausted, and the coverage stays
    exact."""
    import torch.distributed.checkpoint as dcp

    def build():
        return WeightedSamplingReader(_readers(port_reader, [stores[2], stores[1]]),
                                      [0.5, 0.5], seed=1)

    mixer = build()
    it = iter(mixer)
    pre = []
    for _ in range(10):  # draw until 'small' (one batch) is exhausted
        pre.extend(int(x) for x in next(it).id)
        if mixer._readers[0] is None:
            break
    assert mixer._readers[0] is None
    ptck.save(str(tmp_path / "mix.pt"), mixer)
    dcp.save({"data": ptck.state_item(mixer)}, checkpoint_id=str(tmp_path / "dcp"))
    mixer.stop()
    mixer.join()
    for restore in ("save", "dcp"):
        resumed = build()
        if restore == "save":
            ptck.restore(str(tmp_path / "mix.pt"), resumed)
        else:
            dcp.load({"data": ptck.state_item(resumed)},
                     checkpoint_id=str(tmp_path / "dcp"))
        with resumed:
            post = [int(x) for b in resumed for x in b.id]
        seen = pre + post
        assert sorted(seen) == sorted(set(seen))
        assert set(seen) == set(range(5000, 5008)) | set(range(1000, 1096))


def test_state_mismatches_raise(stores):
    mixer = _port_mixer(stores[:2])
    state = mixer.state_dict()
    mixer.stop()
    mixer.join()
    with WeightedSamplingReader(_readers(port_reader, stores[:1]), [1.0], seed=3) as single:
        with pytest.raises(ValueError, match="mixes 2 readers"):
            single.load_state_dict(state)
    reader = make_batch_reader(stores[0], num_epochs=1, reader_pool_type="dummy")
    with reader, pytest.raises(ValueError, match="not a Reader state"):
        reader.load_state_dict(state)
    with _port_mixer(stores[:2]) as other, pytest.raises(ValueError, match="not a Weighted"):
        other.load_state_dict({"plan": {}, "consumed": {}})
    spent = _port_mixer(stores[:2])
    list(spent)
    with spent, pytest.raises(ValueError, match="already exhausted"):
        spent.load_state_dict(state)


# -- under the port's DataLoader ----------------------------------------------------------


def _loader_ids(loader):
    return sorted(int(i) for b in loader for i in b["id"])


def test_the_loader_adopts_the_pass_through_on_every_sub_reader(tmp_path, monkeypatch):
    from petastorm_tpu_torch.io import pagedec

    monkeypatch.setenv("PTPU_PAGEDEC_DEVICE", "1")  # the kernels' plain versions
    # row groups large enough for the compressed pages to save bytes
    urls = [_write(str(tmp_path), "a", 0, 4096, 1024),
            _write(str(tmp_path), "b", 10000, 4096, 1024)]
    mixer = _port_mixer(urls, io_options={"pagedec": "on"})
    before = pagedec.counter_values()
    with DataLoader(mixer, 512, device=CPU, last_batch="partial") as loader:
        assert mixer.keep_passthrough and all(r.keep_passthrough for r in mixer._all)
        batches = [{k: v.clone() for k, v in b.items()} for b in loader]
    assert not any(r.keep_passthrough for r in mixer._all)
    after = pagedec.counter_values()
    assert after["pages"] > before["pages"]
    assert after["host_inflate_columns"] == before["host_inflate_columns"]
    got = {int(i): (float(v), int(k)) for b in batches
           for i, v, k in zip(b["id"], b["v"], b["k"])}
    assert sorted(got) == list(range(4096)) + list(range(10000, 14096))
    assert all(v == (i % 4) and k == i % 3 for i, (v, k) in got.items())


def test_leases_on_the_view_wire_are_taken_from_the_delivering_sub_reader(stores):
    from petastorm_tpu_torch.io import lease

    kw = dict(reader_pool_type="process", workers_count=2, wire_serializer="shm-view",
              results_timeout_s=120)
    mixer = _port_mixer(stores[:2], **kw)
    leaked = lease.lease_stats()["leaked"]
    with DataLoader(mixer, 8, device=CPU, last_batch="partial") as loader:
        assert mixer.wire_views
        values = {}
        for b in loader:
            for i, v, k in zip(b["id"].tolist(), b["v"].tolist(), b["k"].tolist()):
                values[i] = (v, k)
        stats = mixer.wire_stats()
    assert sorted(values) == list(range(64)) + list(range(1000, 1096))
    assert all(v == (i % 4) and k == i % 3 for i, (v, k) in values.items())
    assert stats.get("shm_items", 0) + stats.get("shm_fallbacks", 0) >= 1
    assert lease.lease_stats()["leaked"] == leaked


def test_the_loaders_watermark_resumes_the_mixer(stores):
    with DataLoader(_port_mixer(stores[:2]), 8, device=CPU, prefetch=0) as loader:
        full = [tuple(b["id"].tolist()) for b in loader]
    loader = DataLoader(_port_mixer(stores[:2]), 8, device=CPU, prefetch=0)
    with loader:
        it = iter(loader)
        pre = [tuple(next(it)["id"].tolist()) for _ in range(6)]
        state = loader.state_dict()
    resumed = DataLoader(_port_mixer(stores[:2]), 8, device=CPU, prefetch=0)
    resumed.load_state_dict(state)
    with resumed:
        post = [tuple(b["id"].tolist()) for b in resumed]
    assert pre == full[:6] and post == full[6:]
