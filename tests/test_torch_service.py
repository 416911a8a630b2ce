"""The port's data service against the JAX package's, on the CPU: the JAX package's
service tests under the same names (decode once and serve many, lease re-dispatch
across a link death, the attach and detach watermark, tenant QoS, the DataLoader), the
same job through both packages' services delivering the same (epoch, ordinal, columns)
sequence, and a JAX ServiceReader's state resumed by the port's reader."""
import json
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_pool_helpers import _no_leaked_shm_segments, no_leaked_port_slabs  # noqa: E402,F401
from petastorm_tpu_torch.plan import EpochPlan  # noqa: E402
from petastorm_tpu_torch.recovery import RecoveryOptions  # noqa: E402
from petastorm_tpu_torch.service import (DataService, DecodeWorker,  # noqa: E402
                                         JobSpec, ServiceAttachRejected,
                                         ServiceOptions, ServiceReader)
from petastorm_tpu_torch.service.protocol import svc_metrics  # noqa: E402
from petastorm_tpu_torch.unischema import Unischema, UnischemaField  # noqa: E402
from petastorm_tpu_torch.workers import PullDispatcher  # noqa: E402

SCHEMA = Unischema("t", [UnischemaField("x", np.int64, (), None, False)])

#: module-level state the picklable decode callables reach over the "wire" (the tests
#: run the service and its workers in one process)
_STATE = {}


def _fast_links():
    return RecoveryOptions(link_heartbeat_s=0.1, link_miss_threshold=3,
                           link_reconnect_s=5.0, link_connect_timeout_s=5.0,
                           io_retry_backoff_s=0.01)


def decode_x10(item):
    return {"x": np.arange(4, dtype=np.int64) + item * 10}


def decode_recording(item):
    _STATE.setdefault("order", []).append(item)
    return {"x": np.full(2, item, dtype=np.int64)}


def decode_poison2(item):
    if item == 2:
        raise FileNotFoundError("row group gone")
    return {"x": np.full(2, item, dtype=np.int64)}


def decode_linkkill(item):
    if item == 0 and not _STATE.get("killed"):
        _STATE["killed"] = True
        worker = _STATE["worker"]
        sock = worker._transport._sock
        if sock is not None:
            sock.close()  # the reply dies with this link generation
    return {"x": np.full(2, item, dtype=np.int64)}


def _consume_all(reader, timeout_s=30.0):
    """Drain the reader; returns the first-column tags of the delivered items."""
    got = []
    deadline = time.monotonic() + timeout_s
    for batch in reader:
        got.append(int(batch.x[0]))
        assert time.monotonic() < deadline, "reader drain timed out"
    return got


def _service(n_items, decode, workers=1, rec=None, options=None, job="j",
             **spec_kwargs):
    rec = rec or _fast_links()
    svc = DataService(options=options or ServiceOptions(arena=False),
                      recovery=rec)
    svc.add_job(JobSpec(job, list(range(n_items)), decode, SCHEMA,
                        **spec_kwargs))
    fleet = [DecodeWorker(svc.worker_address(), svc.token, recovery=rec)
             for _ in range(workers)]
    return svc, fleet, rec


def _snapshot():
    m = svc_metrics()
    return {k: v.value for k, v in m.items()}


def _delta(before, key):
    return svc_metrics()[key].value - before[key]


# -- dispatcher seam ---------------------------------------------------------------------


def test_return_items_redispatch_before_plan():
    plan = EpochPlan(list(range(5)), with_epoch=True)
    d = PullDispatcher(plan, workers_count=1, lookahead=0)
    first, _ = d.next(0)
    assert first[1] == 0
    # a wire lease that died: hand the exact item back
    assert d.return_items([first]) == 1
    again, _ = d.next(0)
    assert again == first  # returned items go out again ahead of the plan
    seen = {again[1]}
    while True:
        claim = d.next(0)
        if claim is None:
            break
        seen.add(claim[0][1])
    assert seen == set(range(5))
    assert not d.has_work()


# -- decode once, serve many -------------------------------------------------------------


def test_decode_once_fanout_three_trainers():
    before = _snapshot()
    svc, fleet, rec = _service(6, decode_x10, workers=2)
    # every trainer attaches before the fleet starts, so every decode fans out
    readers = [ServiceReader(svc.trainer_address(), svc.token, job="j",
                             trainer="t%d" % i, recovery=rec, arena=False)
               for i in range(3)]
    for w in fleet:
        w.start()
    seen = {}
    threads = [threading.Thread(
        target=lambda i=i, r=r: seen.update({i: _consume_all(r)}))
        for i, r in enumerate(readers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    for i in range(3):
        assert sorted(v // 10 for v in seen[i]) == list(range(6)), seen
    for r in readers:
        r.stop()
    assert svc.outstanding_leases() == 0
    svc.stop()
    # one decode an item, every extra serve is fan-out
    assert _delta(before, "decodes") == 6
    assert _delta(before, "served_items") == 18
    assert _delta(before, "fanout_serves") == 12
    assert _delta(before, "lease_leaked") == 0


# -- attach and detach -------------------------------------------------------------------


def test_detach_reattach_watermark_exact():
    svc, fleet, rec = _service(8, decode_x10)
    for w in fleet:
        w.start()
    r1 = ServiceReader(svc.trainer_address(), svc.token, job="j",
                       trainer="a", recovery=rec, arena=False)
    first = [int(next(r1).x[0]) // 10 for _ in range(3)]
    state = r1.state_dict()
    r1.stop()  # a mid-epoch detach: unconsumed work returns to the pool

    r2 = ServiceReader(svc.trainer_address(), svc.token, job="j",
                       trainer="a", recovery=rec, arena=False)
    r2.load_state_dict(state)
    rest = [v // 10 for v in _consume_all(r2)]
    r2.stop()
    svc.stop()
    # at the watermark: no loss, no replay
    assert sorted(first + rest) == list(range(8))
    assert not set(first) & set(rest)


def test_state_dict_wrong_job_rejected():
    svc, fleet, rec = _service(2, decode_x10)
    r = ServiceReader(svc.trainer_address(), svc.token, job="j",
                      recovery=rec, arena=False)
    with pytest.raises(ValueError, match="wrong plan|belongs to job"):
        r.load_state_dict({"service": 1, "job": "other", "consumed": {}})
    r.stop()
    svc.stop()


def test_admission_rejects_past_max_trainers():
    svc, fleet, rec = _service(2, decode_x10,
                               options=ServiceOptions(arena=False,
                                                      max_trainers=1))
    r1 = ServiceReader(svc.trainer_address(), svc.token, job="j",
                       recovery=rec, arena=False)
    with pytest.raises(ServiceAttachRejected, match="max_trainers"):
        ServiceReader(svc.trainer_address(), svc.token, job="j",
                      recovery=rec, arena=False)
    r1.stop()
    svc.stop()


# -- exactly once across faults ----------------------------------------------------------


def test_quarantine_broadcast_exactly_once():
    before = _snapshot()
    svc, fleet, rec = _service(5, decode_poison2)
    readers = [ServiceReader(svc.trainer_address(), svc.token, job="j",
                             trainer="t%d" % i, recovery=rec, arena=False)
               for i in range(2)]
    for w in fleet:
        w.start()
    for r in readers:
        delivered = _consume_all(r)
        # delivered and quarantined make the plan, disjoint
        assert sorted(delivered) == [0, 1, 3, 4]
        assert set(r.quarantined) == {(0, 2)}
    for r in readers:
        r.stop()
    svc.stop()
    # the verdict is the service's, decided once
    assert _delta(before, "quarantined") == 1
    assert _delta(before, "lease_leaked") == 0


def test_link_death_mid_lease_redispatches_not_quarantines():
    _STATE.clear()
    before = _snapshot()
    svc, fleet, rec = _service(4, decode_linkkill)
    _STATE["worker"] = fleet[0]
    r = ServiceReader(svc.trainer_address(), svc.token, job="j",
                      recovery=rec, arena=False)
    for w in fleet:
        w.start()
    delivered = sorted(int(b.x[0]) for b in r)
    r.stop()
    svc.stop()
    # the killed link's un-acked lease went out again; delivery stayed exactly once and
    # nothing was quarantined
    assert delivered == [0, 1, 2, 3]
    assert _delta(before, "lease_redispatch") >= 1
    assert _delta(before, "quarantined") == 0
    assert _delta(before, "lease_leaked") == 0


# -- QoS between tenants -----------------------------------------------------------------


def test_priority_tiers_order_dispatch():
    _STATE.clear()
    rec = _fast_links()
    svc = DataService(options=ServiceOptions(arena=False), recovery=rec)
    svc.add_job(JobSpec("lo", [0, 1, 2], decode_recording, SCHEMA,
                        tenant="bulk", priority="low"))
    svc.add_job(JobSpec("hi", [10, 11, 12], decode_recording, SCHEMA,
                        tenant="prod", priority="high"))
    rl = ServiceReader(svc.trainer_address(), svc.token, job="lo",
                       recovery=rec, arena=False)
    rh = ServiceReader(svc.trainer_address(), svc.token, job="hi",
                       recovery=rec, arena=False)
    worker = DecodeWorker(svc.worker_address(), svc.token, recovery=rec)
    worker.start()
    hi = _consume_all(rh)
    lo = _consume_all(rl)
    assert len(hi) == 3 and len(lo) == 3
    rh.stop()
    rl.stop()
    svc.stop()
    order = _STATE["order"]
    # strict tiers on one worker: every high-priority item decodes first
    assert order[:3] == [10, 11, 12]


def test_tenant_weight_knobs_and_rules():
    from petastorm_tpu_torch.control.controller import (WindowContext,
                                                        tenant_qos_rules)
    from petastorm_tpu_torch.control.knobs import KnobSet

    svc = DataService(options=ServiceOptions(arena=False),
                      recovery=_fast_links())
    knobs = KnobSet()
    svc.register_knobs(knobs, ["prod", "bulk"])
    before, after = knobs.apply("svc_weight:bulk", 0.5)
    assert (before, after) == (1.0, 0.5)
    assert svc.get_tenant_weight("bulk") == 0.5
    assert svc.get_tenant_weight("prod") == 1.0
    svc.stop()

    rules = tenant_qos_rules(["bulk"], fire_above=0.6)
    assert rules[0].knob == "svc_weight:bulk"
    assert rules[0].guarded is False
    assert rules[0].propose(None, 2.0) == 1.0
    # the fairness signal: bulk ate 3 of 4 worker-seconds this window
    ctx = WindowContext(
        {'ptpu_tenant_worker_seconds_total{tenant="bulk"}': {"delta": 3.0},
         'ptpu_tenant_worker_seconds_total{tenant="prod"}': {"delta": 1.0}},
        window_s=5.0)
    assert rules[0].signal(ctx) == pytest.approx(0.75)
    # an idle fleet proves nothing
    idle = WindowContext(
        {'ptpu_tenant_worker_seconds_total{tenant="bulk"}': {"delta": 0.0}},
        window_s=5.0)
    assert rules[0].signal(idle) is None


def test_weight_zero_is_admission_throttle():
    svc, fleet, rec = _service(2, decode_x10, tenant="noisy")
    svc.set_tenant_weight("noisy", 0.0)
    with pytest.raises(ServiceAttachRejected, match="throttled"):
        ServiceReader(svc.trainer_address(), svc.token, job="j",
                      recovery=rec, arena=False)
    svc.stop()


# -- the loader --------------------------------------------------------------------------


def test_service_reader_plugs_into_dataloader():
    from petastorm_tpu_torch.loader import DataLoader

    svc, fleet, rec = _service(5, decode_x10)
    for w in fleet:
        w.start()
    reader = ServiceReader(svc.trainer_address(), svc.token, job="j",
                           recovery=rec, arena=False)
    loader = DataLoader(reader, batch_size=4, to_device=False,
                        last_batch="partial", device="cpu")
    rows = 0
    tags = set()
    with loader:
        for batch in loader:
            rows += len(batch["x"])
            tags.update(int(v) // 10 for v in np.asarray(batch["x"]))
    svc.stop()
    assert rows == 20  # 5 items x 4 rows, none lost in batching
    assert tags == set(range(5))


def _double_x(batch):
    return {"x": batch["x"] * 2}


def test_make_service_reader_feeds_the_device_path_and_its_transform():
    """``make_service_reader`` into ``DataLoader(to_device=True)``: the columns arrive
    as torch tensors on the loader's device through its device transform, every row
    once."""
    from petastorm_tpu_torch.loader import DataLoader
    from petastorm_tpu_torch.reader import make_service_reader

    svc, fleet, rec = _service(6, decode_x10, workers=2)
    for w in fleet:
        w.start()
    reader = make_service_reader(svc.trainer_address(), svc.token, "j", recovery=rec,
                                 arena=False)
    seen = []
    with DataLoader(reader, batch_size=8, last_batch="partial", device="cpu",
                    device_transform=_double_x) as loader:
        for batch in loader:
            assert isinstance(batch["x"], torch.Tensor)
            seen.extend(int(v) // 2 for v in batch["x"])
    svc.stop()
    assert sorted(seen) == sorted(int(v) for i in range(6) for v in decode_x10(i)["x"])


# -- against the JAX package's service ---------------------------------------------------


@pytest.fixture(scope="module")
def seeded_store(tmp_path_factory):
    import pyarrow as pa
    import pyarrow.parquet as pq

    root = tmp_path_factory.mktemp("svc_store")
    rng = np.random.default_rng(20)
    for f in range(3):
        n = 48
        table = pa.table({"id": np.arange(f * n, (f + 1) * n, dtype=np.int64),
                          "v": rng.standard_normal(n).astype(np.float32),
                          "k": rng.integers(0, 1 << 40, n, dtype=np.int64)})
        pq.write_table(table, str(root / ("part_%02d.parquet" % f)), row_group_size=16)
    return str(root)


def _ref_links():
    from petastorm_tpu.recovery import RecoveryOptions as RefRecovery

    return RefRecovery(link_heartbeat_s=0.1, link_miss_threshold=3, link_reconnect_s=5.0,
                       link_connect_timeout_s=5.0, io_retry_backoff_s=0.01)


def _delivered(pkg, store, workers, ordered, num_epochs=1, shuffle=False, seed=0,
               take=None, state=None):
    """(epoch, ordinal, {column: values}) in delivery order through ``pkg``'s service
    ('port' or 'ref') with ``workers`` decode workers; ``take`` stops after that many
    items and returns the reader's state too; ``state`` is loaded before reading."""
    if pkg == "port":
        from petastorm_tpu_torch import service as svc_mod

        rec = _fast_links()
    else:
        from petastorm_tpu import service as svc_mod

        rec = _ref_links()
    svc = svc_mod.DataService(options=svc_mod.ServiceOptions(arena=False), recovery=rec)
    try:
        svc.add_job(svc_mod.parquet_job("j", store, num_epochs=num_epochs,
                                        shuffle=shuffle, seed=seed))
        reader = svc_mod.ServiceReader(svc.trainer_address(), svc.token, job="j",
                                       recovery=rec, arena=False, ordered=ordered)
        fleet = [svc_mod.DecodeWorker(svc.worker_address(), svc.token, recovery=rec)
                 for _ in range(workers)]
        for w in fleet:
            w.start()
        if state is not None:
            reader.load_state_dict(state)
        out = []
        deadline = time.monotonic() + 30.0
        for row in reader:
            assert time.monotonic() < deadline
            consumed = reader.state_dict()["consumed"]
            out.append({name: np.asarray(getattr(row, name)) for name in row._fields})
            out[-1]["__consumed"] = sum(len(v) for v in consumed.values())
            if take is not None and len(out) == take:
                break
        saved = reader.state_dict()
        reader.stop()
        return out, saved
    finally:
        svc.stop()


def _keyed(rows):
    return [(r["id"].tolist(), r["v"].tolist(), r["k"].tolist()) for r in rows]


@pytest.mark.parametrize("shuffle,seed", [(False, 0), (True, 3)])
def test_ordered_delivery_equals_the_reference_service(seeded_store, shuffle, seed):
    """The same parquet job through both packages' services, ``ordered=True`` over two
    decode workers and two epochs: the same (epoch, ordinal, columns) sequence, exactly;
    and over one worker in completion order (the dispatch order, shuffled by the plan's
    seed) the same sequence too."""
    for workers, ordered in ((2, True), (1, False)):
        port, _ = _delivered("port", seeded_store, workers, ordered, num_epochs=2,
                             shuffle=shuffle, seed=seed)
        ref, _ = _delivered("ref", seeded_store, workers, ordered, num_epochs=2,
                            shuffle=shuffle, seed=seed)
        assert len(port) == len(ref) == 2 * 9
        assert _keyed(port) == _keyed(ref)
        for a, b in zip(port, ref):
            for name in ("id", "v", "k"):
                assert a[name].dtype == b[name].dtype
    ids = [int(r["id"][0]) for r in port]
    assert sorted(ids[:9]) == sorted(ids[9:]) == list(range(0, 3 * 48, 16))
    assert (ids[:9] == sorted(ids[:9])) == (not shuffle)  # the dispatch order


def test_a_reference_reader_state_resumes_in_the_port(seeded_store):
    """A JAX ServiceReader's ``state_dict()`` after 4 items, through JSON, loads into the
    port's reader, which delivers exactly the remaining items of the plan."""
    first, state = _delivered("ref", seeded_store, 1, True, take=4)
    state = json.loads(json.dumps(state))
    assert set(state) == {"service", "job", "consumed"}
    rest, port_state = _delivered("port", seeded_store, 2, True, state=state)
    got = [i for r in first + rest for i in r["id"].tolist()]
    assert sorted(got) == list(range(3 * 48)) and len(got) == len(set(got))
    assert len(rest) == 9 - 4
    assert sorted(port_state["consumed"][0]) == list(range(9))
