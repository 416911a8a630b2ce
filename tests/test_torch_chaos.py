"""The port's chaos plane and recovery policy against the JAX package's (ROADMAP.md Queue 1
item 8a): deterministic fault injection, the recovery options, poison-item quarantine
with exactly-once accounting on every pool, the dead-child and lease interaction, and
exact resume after a quarantine.

Every case of the JAX package's ``tests/test_chaos.py`` has a counterpart here, the
four cases of the stall healer (``escalation="heal"``, item 8b(i)) included. The
``footer_unreadable`` quarantine cases of ``tests/test_remote_io.py`` and its
``test_hedge_loser_drained_under_chaos_latency_at_io_remote`` are here too. Beside them:

- the same rules and seed fire on the same hits in both packages' ``FaultPlan``, and a
  JAX plan's ``to_json()`` arms the port identically;
- ``RecoveryOptions`` has the same defaults, environment reads and validation errors;
- one store through both packages' ``make_batch_reader`` under the same poison rule, on
  the sync, thread and process pools: the same surviving ids and quarantine entries;
- a plan armed in the JAX package never fires at a port site in the same process;
- a child killed holding a slab and reading through the arena leaves no segment and no
  leaked lease, and so does a child the healer kills;
- the healer kills a child hung on a poison item until the poison policy quarantines
  it, and refuses a kill nothing can absorb, after which the loader delivers the
  ``StallError`` with the children's stacks in the flight record.
"""
import gc
import glob
import os
import pickle
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_pool_helpers import _no_leaked_shm_segments  # noqa: E402,F401
from _torch_pool_helpers import no_leaked_port_slabs  # noqa: E402,F401
from petastorm_tpu import chaos as ref_chaos  # noqa: E402
from petastorm_tpu import recovery as ref_recovery  # noqa: E402
from petastorm_tpu import reader as ref_reader  # noqa: E402
from petastorm_tpu_torch import chaos  # noqa: E402
from petastorm_tpu_torch import make_batch_reader  # noqa: E402
from petastorm_tpu_torch.chaos import ChaosError, FaultPlan, FaultRule  # noqa: E402
from petastorm_tpu_torch.errors import LeaseRevoked, WorkerDiedError  # noqa: E402
from petastorm_tpu_torch.io.lease import lease_stats  # noqa: E402
from petastorm_tpu_torch.obs.log import degradation_counts  # noqa: E402
from petastorm_tpu_torch.recovery import (  # noqa: E402
    QuarantinedItem,
    QuarantineReport,
    RecoveryOptions,
)

#: the process pool's options in these cases: a bounded wait for every result
POOL = dict(reader_pool_type="process", results_timeout_s=60)


@pytest.fixture(autouse=True)
def _disarmed():
    """Every case starts and ends with both packages disarmed: a plan must never leak
    into the next case or into the pool children other cases spawn."""
    chaos.disarm()
    ref_chaos.disarm()
    yield
    chaos.disarm()
    ref_chaos.disarm()


@pytest.fixture(scope="module")
def chaos_dataset(tmp_path_factory):
    """8 files of 1 row group of 16 rows: plan ordinals map one to one to files, so an
    ``item_key`` of ``ordinal=k`` pins a fault to a known id range."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    root = tmp_path_factory.mktemp("torch_chaos_ds")
    for i in range(8):
        pq.write_table(
            pa.table({"id": np.arange(16, dtype=np.int64) + i * 16,
                      "x": np.random.default_rng(i).random(16)}),
            str(root / ("part_%02d.parquet" % i)), row_group_size=16)
    return "file://" + str(root)


def _collect_ids(reader):
    return sorted(int(v) for batch in reader for v in np.asarray(batch.id))


ALL_IDS = list(range(128))


def _fired_at(plan, hits=12, site="s", key=None):
    out = []
    for i in range(1, hits + 1):
        before = plan.stats()["injected_total"]
        plan.hit(site, key=key)
        if plan.stats()["injected_total"] > before:
            out.append(i)
    return out


# -- FaultPlan / FaultRule units ---------------------------------------------------------


def test_rule_nth_and_every_fire_at_exact_hits():
    plan = FaultPlan([FaultRule("s", "latency", nth=2, every=3, latency_s=0)])
    assert _fired_at(plan, 11) == [2, 5, 8, 11]  # nth anchors, every strides


def test_rule_times_budget_caps_fires():
    plan = FaultPlan([FaultRule("s", "latency", every=1, times=2, latency_s=0)])
    for _ in range(10):
        plan.hit("s")
    assert plan.stats()["fires"] == [2]


def test_rule_site_pattern_and_item_key_filter():
    plan = FaultPlan([FaultRule("reader.*", "latency", item_key="ordinal=3",
                                latency_s=0)])
    plan.hit("worker.item", key="ordinal=3")   # site mismatch
    plan.hit("reader.read", key="ordinal=4")   # key mismatch
    assert plan.stats()["hits"] == [0]         # non-matching hits do not count
    plan.hit("reader.read", key="epoch=0 ordinal=3 f.parquet:0")
    assert plan.stats()["fires"] == [1]


def test_probability_is_deterministic_per_seed():
    def pattern(seed):
        plan = FaultPlan([FaultRule("s", "latency", probability=0.5, latency_s=0)],
                         seed=seed)
        return _fired_at(plan, 64)

    a, b, c = pattern(3), pattern(3), pattern(4)
    assert a == b           # same seed: identical replay
    assert a != c           # another seed: another pattern
    assert 10 < len(a) < 54  # and it is probabilistic


def test_raise_actions_raise_the_documented_types():
    plan = FaultPlan([FaultRule("t", "raise_transient", every=1),
                      FaultRule("p", "raise_permanent", every=1)])
    with pytest.raises(ConnectionResetError):
        plan.hit("t")
    with pytest.raises(FileNotFoundError):
        plan.hit("p")


def test_corrupt_flips_one_byte_in_a_copy():
    plan = FaultPlan([FaultRule("wire.decode", "corrupt", every=1)], seed=5)
    original = b"a" * 64
    frames = [b"head", original]
    out = plan.hit("wire.decode", payload=frames)
    assert out[0] == b"head"                       # the largest frame is the target
    assert out[1] != original and len(out[1]) == 64
    assert sum(x != y for x, y in zip(out[1], original)) == 1
    assert frames[1] == b"a" * 64                  # the original is untouched
    out2 = FaultPlan([FaultRule("wire.decode", "corrupt", every=1)],
                     seed=5).hit("wire.decode", payload=[b"head", original])
    assert out2[1] == out[1]                       # deterministic a seed


def test_hang_ends_promptly_on_disarm():
    plan = FaultPlan([FaultRule("s", "hang", every=1, hang_s=60.0)])
    chaos.arm(plan, propagate=False)
    t0 = time.monotonic()
    done = threading.Event()
    threading.Thread(target=lambda: (plan.hit("s"), done.set()), daemon=True).start()
    time.sleep(0.05)
    chaos.disarm()
    assert done.wait(2.0), "hang did not notice disarm"
    assert time.monotonic() - t0 < 5.0


def test_kill_requires_opt_in():
    plan = FaultPlan([FaultRule("s", "kill", every=1)])
    assert not chaos.kill_allowed()
    with pytest.raises(ChaosError, match="did not opt in"):
        plan.hit("s")


def test_plan_json_roundtrip_and_env_arming(monkeypatch):
    plan = FaultPlan([FaultRule("reader.read", "raise_transient", nth=3, times=2,
                                item_key="ordinal=1")], seed=9)
    clone = FaultPlan.from_json(plan.to_json())
    assert clone.seed == 9
    assert clone.rules[0].to_spec() == plan.rules[0].to_spec()
    monkeypatch.setenv("PTPU_CHAOS_SPEC", plan.to_json())
    armed = chaos.arm_from_env()
    assert armed is chaos.ACTIVE and armed.seed == 9
    chaos.disarm()
    monkeypatch.delenv("PTPU_CHAOS_SPEC", raising=False)
    assert chaos.arm_from_env() is None


def test_armed_context_disarms_on_exception():
    plan = FaultPlan([])
    with pytest.raises(RuntimeError):
        with chaos.armed(plan, propagate=False):
            assert chaos.ACTIVE is plan
            raise RuntimeError("scenario failed")
    assert chaos.ACTIVE is None


def test_unarmed_sites_cost_one_none_check():
    assert chaos.ACTIVE is None  # the contract every hook site relies on


def test_every_injection_is_ledgered_counted_and_flight_recorded():
    from petastorm_tpu_torch.obs import flight

    rec = flight.FlightRecorder()
    flight.activate(rec)
    try:
        before = degradation_counts().get("chaos_injected", 0)
        plan = FaultPlan([FaultRule("s", "latency", every=2, latency_s=0)])
        for i in range(4):
            plan.hit("s", key="k%d" % i)
    finally:
        flight.deactivate(rec)
    assert [e["key"] for e in plan.injections()] == ["k1", "k3"]
    assert degradation_counts()["chaos_injected"] == before + 2
    assert [e["kind"] for e in rec.events()].count("chaos") == 2


# -- the two packages' plans ------------------------------------------------------------


@pytest.mark.parametrize("rules", [
    [("s", "latency", dict(nth=2, every=3))],
    [("s", "latency", dict(probability=0.3))],
    [("r.*", "latency", dict(every=2, times=3)), ("r.read", "latency",
                                                  dict(probability=0.6))],
    [("r.read", "latency", dict(item_key="ordinal=1", every=1))],
])
def test_same_rules_and_seed_fire_on_the_same_hits_in_both_packages(rules):
    """Both plans evaluate the same seeded triggers: the same sites, keys and hit
    sequence fire the same rules at the same hits, and leave the same ledger."""
    port = FaultPlan([FaultRule(s, a, latency_s=0, **kw) for s, a, kw in rules], seed=11)
    ref = ref_chaos.FaultPlan([ref_chaos.FaultRule(s, a, latency_s=0, **kw)
                               for s, a, kw in rules], seed=11)
    rng = np.random.default_rng(11)
    sites = ["s", "r.read", "r.run", "x"]
    for _ in range(200):
        site = sites[int(rng.integers(len(sites)))]
        key = "epoch=0 ordinal=%d f:0" % int(rng.integers(4))
        port.hit(site, key=key)
        ref.hit(site, key=key)
    assert port.stats() == ref.stats()
    strip = [{k: v for k, v in e.items() if k != "t"} for e in port.injections()]
    assert strip == [{k: v for k, v in e.items() if k != "t"} for e in ref.injections()]


def test_a_jax_plans_json_arms_the_port_identically(monkeypatch):
    ref = ref_chaos.FaultPlan([
        ref_chaos.FaultRule("reader.read", "raise_transient", every=4),
        ref_chaos.FaultRule("child.item", "kill", item_key="ordinal=5", times=1),
        ref_chaos.FaultRule("wire.decode", "corrupt", nth=2, times=1),
        ref_chaos.FaultRule("io.*", "latency", probability=0.25, latency_s=0.0)], seed=14)
    port = FaultPlan.from_json(ref.to_json())
    assert port.seed == ref.seed
    assert [r.to_spec() for r in port.rules] == [r.to_spec() for r in ref.rules]
    assert port.to_json() == ref.to_json()
    monkeypatch.setenv("PTPU_CHAOS_SPEC", ref.to_json())  # the shared variable name
    armed = chaos.arm_from_env()
    assert armed.to_json() == ref.to_json()
    assert ref_chaos.ACTIVE is None  # the port's arming is the port's alone


def test_item_key_matches_the_jax_packages():
    from petastorm_tpu.metadata import RowGroupPiece as RefPiece

    from petastorm_tpu_torch.metadata import RowGroupPiece

    for item in [(0, 3, (RowGroupPiece("/d/f.parquet", 2, 16), 0)),
                 (1, 0, (RowGroupPiece("/d/g.parquet", 0, -1), 1)), (0, 5, "opaque"), 7]:
        ref_item = item
        if isinstance(item, tuple) and isinstance(item[2], tuple):
            p = item[2][0]
            ref_item = (item[0], item[1], (RefPiece(p.path, p.row_group, p.num_rows),
                                           item[2][1]))
        assert chaos.item_key(item) == ref_chaos.item_key(ref_item)


def test_a_plan_armed_in_the_jax_package_never_fires_at_a_port_site(chaos_dataset):
    """The two packages' armed plans are separate module globals: a JAX plan that
    would fail every read leaves the port's reads alone in the same process."""
    plan = ref_chaos.FaultPlan([
        ref_chaos.FaultRule("reader.read", "raise_permanent", every=1),
        ref_chaos.FaultRule("worker.item", "raise_permanent", every=1)])
    with ref_chaos.armed(plan, propagate=False):
        assert chaos.ACTIVE is None
        with make_batch_reader(chaos_dataset, num_epochs=1, workers_count=2,
                               shuffle_row_groups=False) as reader:
            assert _collect_ids(reader) == ALL_IDS
    assert plan.stats()["hits"] == [0, 0]


# -- RecoveryOptions ---------------------------------------------------------------------


def test_recovery_defaults_and_env(monkeypatch):
    rec = RecoveryOptions()
    assert (rec.io_retries, rec.worker_respawns, rec.on_poison,
            rec.poison_attempts) == (2, 2, "raise", 2)
    monkeypatch.setenv("PTPU_IO_RETRIES", "5")
    monkeypatch.setenv("PTPU_ON_POISON", "quarantine")
    rec = RecoveryOptions()
    assert rec.io_retries == 5 and rec.quarantine


def test_recovery_resolve_legacy_kwargs_win():
    base = RecoveryOptions(io_retries=7, worker_respawns=9)
    merged = RecoveryOptions.resolve(base, io_retries=1)
    assert merged.io_retries == 1          # the explicit legacy keyword wins
    assert merged.worker_respawns == 9     # the struct's fields survive
    assert RecoveryOptions.resolve(None, worker_respawns=0).worker_respawns == 0


def test_recovery_validation_and_pickle():
    with pytest.raises(ValueError, match="on_poison"):
        RecoveryOptions(on_poison="shrug")
    rec = RecoveryOptions(on_poison="quarantine", poison_attempts=3, read_deadline_s=4.5)
    clone = pickle.loads(pickle.dumps(rec))
    assert clone.quarantine and clone.poison_attempts == 3
    assert clone.read_deadline_s == 4.5


_ENV = {"PTPU_IO_RETRIES": "4", "PTPU_IO_RETRY_BACKOFF_S": "0.25",
        "PTPU_IO_RETRY_MAX_BACKOFF_S": "3", "PTPU_READ_DEADLINE_S": "9",
        "PTPU_WORKER_RESPAWNS": "0", "PTPU_ON_POISON": "quarantine",
        "PTPU_POISON_ATTEMPTS": "5", "PTPU_LINK_HEARTBEAT_S": "0.01",
        "PTPU_LINK_MISS_THRESHOLD": "nope", "PTPU_LINK_RECONNECT_S": "",
        "PTPU_LINK_CONNECT_TIMEOUT_S": "7"}


@pytest.mark.parametrize("env", [{}, _ENV], ids=["defaults", "environment"])
def test_recovery_options_equal_the_jax_packages(monkeypatch, env):
    for k in _ENV:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    port, ref = RecoveryOptions(), ref_recovery.RecoveryOptions()
    assert port.__getstate__() == ref.__getstate__()
    legacy = dict(io_retries=1, io_retry_backoff_s=None, worker_respawns=3)
    assert RecoveryOptions.resolve({"poison_attempts": 4}, **legacy).__getstate__() \
        == ref_recovery.RecoveryOptions.resolve({"poison_attempts": 4}, **legacy) \
        .__getstate__()


@pytest.mark.parametrize("bad", [{"on_poison": "shrug"}, {"on_poison": ""},
                                 "a string", 3, {"no_such_field": 1}])
def test_recovery_validation_errors_equal_the_jax_packages(bad):
    def error(cls):
        try:
            cls.normalize(bad)
        except Exception as e:  # noqa: BLE001 — the comparison is the point
            return type(e).__name__, str(e)
        return None

    got = error(RecoveryOptions)
    assert got is not None
    assert got[0] == error(ref_recovery.RecoveryOptions)[0]
    if got[0] == "ValueError":
        assert got == error(ref_recovery.RecoveryOptions)


# -- poison quarantine: every pool type --------------------------------------------------


@pytest.mark.parametrize("pool", ["dummy", "thread"])
def test_poison_item_quarantined_in_process_pools(pool, chaos_dataset):
    plan = FaultPlan([FaultRule("worker.item", "raise_permanent", item_key="ordinal=2")])
    with chaos.armed(plan, propagate=False):
        with make_batch_reader(chaos_dataset, num_epochs=1, workers_count=2,
                               shuffle_row_groups=False, reader_pool_type=pool,
                               recovery={"on_poison": "quarantine",
                                         "poison_attempts": 2}) as reader:
            ids = _collect_ids(reader)
            report = reader.quarantine_report
    assert ids == sorted(set(ALL_IDS) - set(range(32, 48)))
    assert len(report) == 1 and report
    entry = report.entries[0]
    assert (entry.ordinal, entry.attempts, entry.kind) == (2, 2, "exception")
    assert entry.num_rows == 16 and entry.row_group == 0
    assert "FileNotFoundError" in entry.as_dict()["error"]
    assert report.ordinals() == {(0, 2)}
    assert "part_02" in report.render()


def test_poison_item_raises_without_quarantine(chaos_dataset):
    plan = FaultPlan([FaultRule("worker.item", "raise_permanent", item_key="ordinal=2")])
    with chaos.armed(plan, propagate=False):
        with make_batch_reader(chaos_dataset, num_epochs=1, workers_count=2,
                               shuffle_row_groups=False) as reader:
            with pytest.raises(FileNotFoundError, match="chaos-injected"):
                _collect_ids(reader)
            assert not reader.quarantine_report


def test_process_pool_child_exception_quarantined(chaos_dataset):
    """An exception raised inside a pool child (the child.item site) rides the exc
    header; the feeder's poison policy retries, then quarantines, and the pool stays
    alive for every other item."""
    plan = FaultPlan([FaultRule("child.item", "raise_permanent", item_key="ordinal=5")])
    with chaos.armed(plan):  # propagate: the children must inherit the plan
        with make_batch_reader(chaos_dataset, num_epochs=1, workers_count=2,
                               shuffle_row_groups=False, **POOL,
                               recovery=RecoveryOptions(on_poison="quarantine",
                                                        poison_attempts=2)) as reader:
            ids = _collect_ids(reader)
            report = reader.quarantine_report
    assert ids == sorted(set(ALL_IDS) - set(range(80, 96)))
    assert len(report) == 1 and report.entries[0].kind == "exception"


def test_process_pool_poison_kill_quarantined_without_burning_budget(chaos_dataset):
    """An item that kills every child it meets is quarantined after poison_attempts
    deaths, and the death that reaches the threshold respawns uncharged."""
    plan = FaultPlan([FaultRule("child.item", "kill", item_key="ordinal=3")])
    with chaos.armed(plan):
        with make_batch_reader(chaos_dataset, num_epochs=1, workers_count=2,
                               shuffle_row_groups=False, **POOL,
                               recovery=RecoveryOptions(on_poison="quarantine",
                                                        poison_attempts=2,
                                                        worker_respawns=1)) as reader:
            ids = _collect_ids(reader)
            report = reader.quarantine_report
            budget_left = reader._executor._respawn_budget
    assert ids == sorted(set(ALL_IDS) - set(range(48, 64)))
    assert len(report) == 1
    entry = report.entries[0]
    assert entry.kind == "child_death" and entry.attempts == 2
    # the first death charges the budget (1 -> 0); the one reaching the threshold
    # quarantines and respawns uncharged: the pool survived two deaths on a budget of 1
    assert budget_left == 0


def test_respawn_budget_exhaustion_surfaces_original_child_failure(chaos_dataset):
    """Past the budget the consumer sees WorkerDiedError carrying the original child
    failure as __cause__/original, still a RuntimeError."""
    plan = FaultPlan([FaultRule("child.item", "kill", item_key="ordinal=1")])
    with chaos.armed(plan):
        with make_batch_reader(chaos_dataset, num_epochs=1, workers_count=1,
                               shuffle_row_groups=False, **POOL,
                               recovery=RecoveryOptions(worker_respawns=1)) as reader:
            with pytest.raises(WorkerDiedError, match="worker process died") as exc_info:
                _collect_ids(reader)
    err = exc_info.value
    assert isinstance(err, RuntimeError)
    assert isinstance(err.original, (EOFError, ConnectionResetError, BrokenPipeError))
    assert err.__cause__ is err.original


def test_corrupt_wire_payload_redelivered_exactly_once(chaos_dataset):
    """A flipped byte in a wire payload is detected (the descriptor's crc), counts as a
    decode failure (never a child death), and the item is dispatched again on the same
    live child: delivered exactly once, no respawn, no leaked lease."""
    before = lease_stats()["leaked"]
    plan = FaultPlan([FaultRule("wire.decode", "corrupt", nth=2, times=1)], seed=3)
    with chaos.armed(plan, propagate=False):  # a parent-side site
        with make_batch_reader(chaos_dataset, num_epochs=1, workers_count=2,
                               shuffle_row_groups=False, wire_serializer="shm-view",
                               **POOL, recovery=RecoveryOptions(
                                   on_poison="quarantine", poison_attempts=3)) as reader:
            ids = _collect_ids(reader)
            assert not reader.quarantine_report
            procs = list(reader._executor._procs)
            respawns = reader._executor.pool_stats()["respawns"]
    assert ids == ALL_IDS
    assert plan.stats()["fires"] == [1]
    assert len(procs) == 2 and respawns == 0
    gc.collect()
    assert lease_stats()["leaked"] - before == 0


def test_corrupt_wire_payload_without_quarantine_raises_the_decode_error(chaos_dataset):
    plan = FaultPlan([FaultRule("wire.decode", "corrupt", nth=1, times=1)], seed=3)
    with chaos.armed(plan, propagate=False):
        with make_batch_reader(chaos_dataset, num_epochs=1, workers_count=1,
                               shuffle_row_groups=False, wire_serializer="shm",
                               **POOL) as reader:
            with pytest.raises(ValueError, match="crc"):
                _collect_ids(reader)


@pytest.mark.parametrize("pool", ["dummy", "thread", "process"])
def test_the_same_poison_rule_quarantines_the_same_item_in_both_packages(pool,
                                                                         chaos_dataset):
    """One store through both packages' make_batch_reader under the same rule, quarantine
    on: the same surviving ids and the same QuarantineEntry fields. On the process pool
    the rule sits at the children's site, child.item, in both packages."""
    site = "child.item" if pool == "process" else "worker.item"
    kw = dict(num_epochs=1, shuffle_row_groups=False, reader_pool_type=pool,
              workers_count=1 if pool == "process" else 2, results_timeout_s=60,
              recovery={"on_poison": "quarantine", "poison_attempts": 2})

    def fields(report):
        return [(os.path.basename(e.path), e.row_group, e.num_rows, e.kind, e.attempts,
                 e.ordinal) for e in report.entries]

    propagate = pool == "process"
    with ref_chaos.armed(ref_chaos.FaultPlan([ref_chaos.FaultRule(
            site, "raise_permanent", item_key="ordinal=3")]), propagate=propagate):
        with ref_reader.make_batch_reader(chaos_dataset, **kw) as r:
            ref_ids = _collect_ids(r)
            ref_entries = fields(r.quarantine_report)
    with chaos.armed(FaultPlan([FaultRule(site, "raise_permanent",
                                          item_key="ordinal=3")]), propagate=propagate):
        with make_batch_reader(chaos_dataset, **kw) as r:
            ids = _collect_ids(r)
            entries = fields(r.quarantine_report)
    assert ids == ref_ids == sorted(set(ALL_IDS) - set(range(48, 64)))
    assert entries == ref_entries == [("part_03.parquet", 0, 16, "exception", 2, 3)]


# -- the retry policy under faults -------------------------------------------------------


def test_transient_errors_absorbed_by_retry_and_counted(chaos_dataset):
    before = degradation_counts().get("io_retry", 0)
    plan = FaultPlan([FaultRule("reader.read", "raise_transient", every=4)], seed=2)
    with chaos.armed(plan, propagate=False):
        # a retry is a hit of the rule too: with other threads' hits between a read's
        # attempts its retry fails again about one time in four, so the budget here
        # leaves a read exhausted one time in 4 ** 8
        with make_batch_reader(chaos_dataset, num_epochs=1, workers_count=2,
                               shuffle_row_groups=False, io_retries=8,
                               io_retry_backoff_s=0.01) as reader:
            assert _collect_ids(reader) == ALL_IDS
    # one retry for every injected fault, wherever the read ran (foreground or readahead)
    assert degradation_counts().get("io_retry", 0) - before \
        == plan.stats()["injected_total"] > 0


def test_io_retries_zero_fails_fast_on_sync_readahead_and_coalesced_paths():
    """io_retries=0 disables the retry on every read path: one attempt, no sleeps, on
    the sync read, the coalesced run, and a background readahead read (whose stored
    error re-raises at get())."""
    from petastorm_tpu_torch.io.readahead import ReadaheadPool
    from petastorm_tpu_torch.reader import _WorkerBase

    class _P:
        path = "store/p.parquet"
        row_group = 0

    def bare():
        w = _WorkerBase(None, None, None, io_options={"readahead": False},
                        recovery=RecoveryOptions(io_retries=0))
        state = {"attempts": 0}

        def fail(*_a, **_k):
            state["attempts"] += 1
            raise ConnectionResetError("reset")

        w._read_columns_once = fail
        w._read_run_once = fail
        w._evict_parquet_file = lambda path: None
        return w, state

    w, state = bare()
    with pytest.raises(ConnectionResetError):
        w._read_columns_sync(_P(), None)
    assert state["attempts"] == 1  # sync: no retry

    w, state = bare()
    with pytest.raises(ConnectionResetError):
        w._read_run([_P()], None)
    assert state["attempts"] == 1  # coalesced run: no retry

    w, state = bare()
    pool = ReadaheadPool(w._read_columns_sync, read_run_fn=w._read_run, depth=2,
                         io_threads=1, coalesce=False)
    try:
        assert pool.schedule([(_P(), None)]) == 1
        deadline = time.monotonic() + 5.0
        while state["attempts"] < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        with pytest.raises(ConnectionResetError):
            pool.get(_P(), None)
        assert state["attempts"] == 1  # background read: the same zero budget
    finally:
        pool.shutdown()


def test_read_deadline_caps_the_retry_loop():
    from petastorm_tpu_torch.reader import _WorkerBase

    w = _WorkerBase(None, None, None, io_options={"readahead": False},
                    recovery=RecoveryOptions(io_retries=50, io_retry_backoff_s=0.01,
                                             read_deadline_s=0.2))
    state = {"attempts": 0}

    def fail(*_a, **_k):
        state["attempts"] += 1
        raise ConnectionResetError("reset")

    w._read_columns_once = fail
    w._evict_parquet_file = lambda path: None

    class _P:
        path = "p"
        row_group = 0

    with pytest.raises(ConnectionResetError):
        w._read_columns_sync(_P(), None)
    assert 1 <= state["attempts"] < 50  # the deadline, not the budget, stopped it


# -- exact resume across a quarantine ----------------------------------------------------


def _open_quarantining(url):
    return make_batch_reader(url, num_epochs=1, workers_count=1, shuffle_row_groups=False,
                             reader_pool_type="dummy",
                             recovery={"on_poison": "quarantine", "poison_attempts": 2})


def test_checkpoint_resume_after_quarantine_replays_and_loses_nothing(chaos_dataset,
                                                                      tmp_path):
    """A quarantine skip is charged to the consumed-work map: a restore (through the
    port's checkpoint.save) taken after the skip neither replays the poisoned group nor
    loses any other row."""
    from petastorm_tpu_torch import checkpoint

    plan = FaultPlan([FaultRule("worker.item", "raise_permanent", item_key="ordinal=2")])
    first_ids = []
    path = str(tmp_path / "ckpt.pt")
    with chaos.armed(plan, propagate=False):
        with _open_quarantining(chaos_dataset) as reader:
            it = iter(reader)
            # ordinals 0, 1 delivered, 2 quarantined, 3, 4 delivered
            for _ in range(4):
                first_ids.extend(int(v) for v in np.asarray(next(it).id))
            assert len(reader.quarantine_report) == 1
            assert 2 in reader.state_dict()["consumed"][0]
            checkpoint.save(path, reader)
    with _open_quarantining(chaos_dataset) as reader:  # no chaos: the poison would read
        checkpoint.restore(path, reader)
        rest_ids = [int(v) for b in reader for v in np.asarray(b.id)]
    combined = sorted(first_ids + rest_ids)
    assert combined == sorted(set(ALL_IDS) - set(range(32, 48)))
    assert len(combined) == len(set(combined))  # nothing replayed, nothing lost


def test_loader_watermark_counts_the_quarantined_item(chaos_dataset):
    """The DataLoader's consumer watermark advances past a quarantined row group: its
    state_dict() after the epoch counts every ordinal as consumed."""
    from petastorm_tpu_torch.loader import DataLoader

    plan = FaultPlan([FaultRule("worker.item", "raise_permanent", item_key="ordinal=5")])
    with chaos.armed(plan, propagate=False):
        reader = _open_quarantining(chaos_dataset)
        with DataLoader(reader, 16, device="cpu", to_device=False) as loader:
            n = sum(1 for _ in loader)
            state = loader.state_dict()
            report = loader.quarantine_report
    assert n == 7 and len(report) == 1
    assert state["resume_epoch"] == 1 and state["consumed"] == {}


def test_a_jax_state_taken_after_a_quarantine_resumes_the_port(chaos_dataset):
    """from_reference_state carries the JAX reader's state after a quarantine: the
    skipped ordinal is consumed there, and the port's restore skips it too."""
    from petastorm_tpu_torch.checkpoint import from_reference_state

    ref_plan = ref_chaos.FaultPlan([ref_chaos.FaultRule(
        "worker.item", "raise_permanent", item_key="ordinal=2")])
    first = []
    with ref_chaos.armed(ref_plan, propagate=False):
        with ref_reader.make_batch_reader(
                chaos_dataset, num_epochs=1, workers_count=1, shuffle_row_groups=False,
                reader_pool_type="dummy",
                recovery={"on_poison": "quarantine", "poison_attempts": 2}) as r:
            it = iter(r)
            for _ in range(3):
                first.extend(int(v) for v in np.asarray(next(it).id))
            state = r.state_dict()
    assert 2 in state["consumed"][0]
    with _open_quarantining(chaos_dataset) as reader:
        reader.load_state_dict(from_reference_state(state))
        rest = [int(v) for b in reader for v in np.asarray(b.id)]
    assert sorted(first + rest) == sorted(set(ALL_IDS) - set(range(32, 48)))


# -- dead children, slabs, leases and the arena ------------------------------------------


def test_ring_reclaim_revokes_outstanding_lease():
    """Reclaiming a slab with an outstanding consumer lease revokes the lease (it fails
    loudly with LeaseRevoked) and never puts a still-viewed slab back on the free list."""
    from petastorm_tpu_torch.io.lease import Lease
    from petastorm_tpu_torch.parallel.shm_ring import SlabRing, shm_supported

    if not shm_supported():
        pytest.skip("no shared memory on this platform")
    ring = SlabRing(1024, 2)
    try:
        slab = ring.acquire()
        released = []
        lease = Lease(release_cb=lambda: (released.append(slab), ring.release(slab)),
                      kind="shm_slab")
        ring.register_lease(slab, lease)
        ring.reclaim(slab)
        with pytest.raises(LeaseRevoked):
            lease.check()
        assert released == []       # revoke invalidates; the holder still owns it
        assert ring.stats()["shm_slabs_in_flight"] == 1
        lease.release()             # the holder's release returns the slab
        assert released == [slab]
        assert ring.stats()["shm_slabs_in_flight"] == 0
    finally:
        ring.close()


def test_ring_reclaim_without_lease_is_plain_release_and_double_release_guarded():
    from petastorm_tpu_torch.parallel.shm_ring import SlabRing, shm_supported

    if not shm_supported():
        pytest.skip("no shared memory on this platform")
    ring = SlabRing(1024, 2)
    try:
        slab = ring.acquire()
        ring.reclaim(slab)
        assert ring.stats()["shm_slabs_in_flight"] == 0
        free_before = ring._free.qsize()
        ring.release(slab)  # a double release: suppressed, no double insert
        assert ring._free.qsize() == free_before
    finally:
        ring.close()


def test_kill_while_batch_retained_regression(chaos_dataset):
    """A batch retained (lease taken) across a child death keeps its bytes: its slab is
    never granted again under the consumer, and the rest of the epoch arrives once."""
    import signal

    with make_batch_reader(chaos_dataset, num_epochs=1, workers_count=2,
                           shuffle_row_groups=False, wire_serializer="shm-view", **POOL,
                           recovery=RecoveryOptions(worker_respawns=4)) as reader:
        it = iter(reader)
        first = next(it)
        retained_ids = np.asarray(first.id).copy()
        retained_view = first.id
        lease = reader.take_lease()
        assert lease is not None
        try:
            os.kill(reader._executor._procs[0].pid, signal.SIGKILL)
            rest = [int(v) for batch in it for v in np.asarray(batch.id)]
            np.testing.assert_array_equal(np.asarray(retained_view), retained_ids)
            assert sorted(rest + retained_ids.tolist()) == ALL_IDS
        finally:
            lease.release()


def _own_segments():
    pid = os.getpid()
    return sorted(glob.glob("/dev/shm/ptpu_torch_shm_%d_*" % pid)
                  + glob.glob("/dev/shm/ptpu_torch_arena_%d_*" % pid))


def test_a_killed_child_leaves_no_segment_and_no_leaked_lease(chaos_dataset):
    """A kill (os._exit(137)) in a child that holds a slab grant and reads through the
    host-wide arena: the ring's reclaim and the arena's reclaim both run, so after the
    pool and the arena close no segment of this process is left in /dev/shm, and no
    lease leaked."""
    from petastorm_tpu_torch.io import arena as arena_mod
    from petastorm_tpu_torch.io.memcache import shared_store
    from petastorm_tpu_torch.loader import DataLoader

    before_segments = _own_segments()
    leaked0 = lease_stats()["leaked"]
    plan = FaultPlan([FaultRule("child.item", "kill", item_key="ordinal=1")])
    try:
        with chaos.armed(plan):
            reader = make_batch_reader(
                chaos_dataset, num_epochs=1, workers_count=2, shuffle_row_groups=False,
                wire_serializer="shm", io_options={"arena_bytes": 4 << 20}, **POOL,
                recovery=RecoveryOptions(on_poison="quarantine", poison_attempts=1))
            with DataLoader(reader, 16, device="cpu", to_device=False) as loader:
                ids = sorted(int(v) for b in loader for v in np.asarray(b["id"]))
                report = loader.quarantine_report
    finally:
        arena_mod.close_process_arena()
        shared_store().clear()  # the arena implies a process-wide memcache
    assert ids == sorted(set(ALL_IDS) - set(range(16, 32)))
    assert [(e.kind, e.attempts) for e in report.entries] == [("child_death", 1)]
    gc.collect()
    assert lease_stats()["leaked"] - leaked0 == 0
    assert _own_segments() == before_segments


# -- the stall healer (escalation="heal") -------------------------------------------------


def test_monitor_try_heal_unit(tmp_path):
    """Healers run under escalation='heal'; actors nobody heals escalate to StallError,
    healed ones re-arm silently; heal_count counts the recoveries."""
    from petastorm_tpu_torch.errors import StallError
    from petastorm_tpu_torch.obs.health import HealthMonitor, HealthOptions

    mon = HealthMonitor(HealthOptions(stall_threshold_s=0.05, poll_interval_s=10.0,
                                      escalation="heal",
                                      flight_path=str(tmp_path / "f.json")))
    hb_a = mon.register("worker.child-0", "worker")
    hb_b = mon.register("worker.child-1", "worker")
    hb_a.beat("working")
    hb_b.beat("working")
    healed_calls = []
    mon.add_healer(lambda stalled: healed_calls.append(
        [s["actor"] for s in stalled]) or {"worker.child-0"})
    delivered = []
    mon.add_stall_callback(delivered.append)
    time.sleep(0.1)
    mon._handle_stall(mon.check_stalls())  # what the watchdog's poll does
    assert healed_calls and set(healed_calls[0]) == {"worker.child-0", "worker.child-1"}
    assert mon.heal_count == 1
    assert len(delivered) == 1 and isinstance(delivered[0], StallError)
    assert "worker.child-1" in str(delivered[0])
    assert "worker.child-0" not in str(delivered[0])


def test_heal_escalation_recovers_live_hang_without_stallerror(tmp_path):
    """Each child hangs on its second item (a respawned child too, the plan propagates):
    the healer kills it, the respawned child takes the item again, and the consumer sees
    every row and no StallError. Four one-row-group files keep the heals few."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from petastorm_tpu_torch.obs.health import HealthMonitor, HealthOptions

    for i in range(4):
        pq.write_table(pa.table({"id": np.arange(16, dtype=np.int64) + i * 16}),
                       str(tmp_path / ("part_%02d.parquet" % i)))

    plan = FaultPlan([FaultRule("child.item", "hang", nth=2, times=1, hang_s=60.0)])
    mon = HealthMonitor(HealthOptions(stall_threshold_s=1.0, poll_interval_s=0.1,
                                      escalation="heal", thresholds={"child": 1.0},
                                      flight_path=str(tmp_path / "f.json")))
    with chaos.armed(plan):
        with make_batch_reader("file://" + str(tmp_path), num_epochs=1, workers_count=2,
                               shuffle_row_groups=False, recovery=RecoveryOptions(
                                   worker_respawns=16), **POOL) as reader:
            reader.set_health(mon)
            mon.start()
            try:
                ids = _collect_ids(reader)
            finally:
                mon.stop()
            respawns = reader._executor.pool_stats()["respawns"]
    assert ids == list(range(64))
    assert mon.heal_count >= 1 and respawns >= 1
    assert not reader.quarantine_report


def test_heal_falls_through_to_stallerror_when_budget_exhausted(tmp_path):
    """No respawn budget and no quarantine: the healer refuses to kill (nothing could
    absorb it) and the stall escalates to StallError."""
    from petastorm_tpu_torch.errors import StallError
    from petastorm_tpu_torch.obs.health import HealthMonitor, HealthOptions
    from petastorm_tpu_torch.workers import ProcessExecutor

    mon = HealthMonitor(HealthOptions(stall_threshold_s=0.05, poll_interval_s=10.0,
                                      escalation="heal",
                                      flight_path=str(tmp_path / "f.json")))
    with ProcessExecutor(workers_count=1,
                         recovery=RecoveryOptions(worker_respawns=0)) as ex:
        delivered = []
        mon.add_stall_callback(delivered.append)
        ex.set_health(mon)

        class _FakeProc:
            pid = 99999

            @staticmethod
            def poll():
                return None  # alive

            @staticmethod
            def kill():
                raise AssertionError("the healer must not kill: nothing can absorb it")

        ex._child_by_idx[0] = _FakeProc()
        hb = mon.register("worker.child-0", "worker")
        hb.beat("working")
        time.sleep(0.1)
        mon._handle_stall(mon.check_stalls())
        assert len(delivered) == 1 and isinstance(delivered[0], StallError)
        assert mon.heal_count == 0


def test_healer_ignores_sibling_scope_actors(tmp_path):
    """On a shared monitor a pool's healer claims only its own scoped child actors."""
    from petastorm_tpu_torch.obs.health import HealthMonitor, HealthOptions
    from petastorm_tpu_torch.workers import ProcessExecutor

    mon = HealthMonitor(HealthOptions(stall_threshold_s=0.05, poll_interval_s=10.0,
                                      escalation="heal",
                                      flight_path=str(tmp_path / "f.json")))
    scope = mon.scoped("pipe1")
    kills = []
    with ProcessExecutor(workers_count=1,
                         recovery=RecoveryOptions(worker_respawns=2)) as ex:
        ex.set_health(scope)

        class _FakeProc:
            pid = 12345

            @staticmethod
            def poll():
                return None

            @staticmethod
            def kill():
                kills.append(1)

        ex._child_by_idx[0] = _FakeProc()
        sibling = {"actor": "pipe2/worker.child-0", "age_s": 9.9}
        assert ex._heal_stalled([sibling]) == set() and kills == []
        own_name = scope._name("worker.child-0")
        assert ex._heal_stalled([{"actor": own_name, "age_s": 9.9}]) == {own_name}
        assert kills == [1]


def test_healer_kills_for_the_poison_policy_without_budget(tmp_path):
    """No respawn budget, but the poison policy quarantines the item at this attempt:
    the kill is absorbable and the healer makes it."""
    from petastorm_tpu_torch.obs.health import HealthMonitor, HealthOptions
    from petastorm_tpu_torch.workers import ProcessExecutor

    mon = HealthMonitor(HealthOptions(escalation="heal", poll_interval_s=10.0,
                                      flight_path=str(tmp_path / "f.json")))
    kills = []
    with ProcessExecutor(workers_count=1, recovery=RecoveryOptions(
            worker_respawns=0, on_poison="quarantine", poison_attempts=2)) as ex:
        ex.set_health(mon)

        class _FakeProc:
            pid = 4242

            @staticmethod
            def poll():
                return None

            @staticmethod
            def kill():
                kills.append(1)

        ex._child_by_idx[0] = _FakeProc()
        stalled = [{"actor": "worker.child-0", "age_s": 5.0}]
        ex._inflight_attempts[0] = 0  # a kill now is attempt 1 of 2: not absorbable
        assert ex._heal_stalled(stalled) == set() and kills == []
        ex._inflight_attempts[0] = 1  # attempt 2 of 2 quarantines: absorbable
        assert ex._heal_stalled(stalled) == {"worker.child-0"} and kills == [1]


def test_healed_poison_child_quarantined_and_leaves_no_segment(chaos_dataset, tmp_path):
    """A child that hangs on one item every time (the plan propagates to respawned
    children), on the shared-memory wire and the arena: at least the two heals of its two
    attempts (on a loaded host a slow healthy child past the 1.5 s threshold is killed
    too, and its item dispatched again), the item quarantined after 2 attempts, every
    other id once, no StallError, no segment and no leaked lease left."""
    from petastorm_tpu_torch.io import arena as arena_mod
    from petastorm_tpu_torch.io.memcache import shared_store
    from petastorm_tpu_torch.loader import DataLoader
    from petastorm_tpu_torch.obs.health import HealthOptions

    before_segments = _own_segments()
    leaked0 = lease_stats()["leaked"]
    deg0 = degradation_counts().get("stall_heal_kill", 0)
    plan = FaultPlan([FaultRule("child.item", "hang", item_key="ordinal=1",
                                hang_s=60.0)])
    opts = HealthOptions(thresholds={"child": 1.5}, poll_interval_s=0.1,
                         escalation="heal", flight_path=str(tmp_path / "f.json"))
    try:
        with chaos.armed(plan, propagate=True):
            reader = make_batch_reader(
                chaos_dataset, num_epochs=1, workers_count=2, shuffle_row_groups=False,
                wire_serializer="shm", io_options={"arena_bytes": 4 << 20}, **POOL,
                recovery=RecoveryOptions(on_poison="quarantine", poison_attempts=2,
                                         worker_respawns=2))
            with DataLoader(reader, 16, device="cpu", to_device=False,
                            health=opts) as loader:
                ids = sorted(int(v) for b in loader for v in np.asarray(b["id"]))
                report = loader.quarantine_report
                heals = loader._health.heal_count
    finally:
        arena_mod.close_process_arena()
        shared_store().clear()
    assert ids == sorted(set(ALL_IDS) - set(range(16, 32)))
    assert [(e.kind, e.attempts) for e in report.entries] == [("child_death", 2)]
    assert heals >= 2
    assert degradation_counts()["stall_heal_kill"] - deg0 == heals
    gc.collect()
    assert lease_stats()["leaked"] - leaked0 == 0
    assert _own_segments() == before_segments


def test_unabsorbable_heal_delivers_stallerror_with_child_stacks(chaos_dataset,
                                                                 tmp_path):
    """No budget and on_poison='raise': the healer does not kill, the loader delivers
    the StallError, and the flight record holds the children's SIGUSR1 stacks."""
    import json

    from petastorm_tpu_torch.errors import StallError
    from petastorm_tpu_torch.loader import DataLoader
    from petastorm_tpu_torch.obs.health import HealthOptions

    flight = str(tmp_path / "f.json")
    # the hang outlasts detection (1.5 s + a poll) and ends soon after: the hung child
    # finishes its item and exits at the pool's join instead of being killed there
    plan = FaultPlan([FaultRule("child.item", "hang", item_key="ordinal=1",
                                hang_s=3.5)])
    opts = HealthOptions(thresholds={"child": 1.5}, poll_interval_s=0.1,
                         escalation="heal", flight_path=flight)
    deg0 = degradation_counts().get("stall_heal_kill", 0)
    with chaos.armed(plan, propagate=True):
        reader = make_batch_reader(
            chaos_dataset, num_epochs=1, workers_count=2, shuffle_row_groups=False,
            recovery=RecoveryOptions(worker_respawns=0), **POOL)
    with DataLoader(reader, 16, device="cpu", to_device=False, health=opts) as loader:
        with pytest.raises(StallError, match="worker.child-"):
            for _ in loader:
                pass
        assert loader._health.heal_count == 0
    assert degradation_counts().get("stall_heal_kill", 0) == deg0
    with open(flight) as f:
        rec = json.load(f)
    assert rec["child_stacks"] and any("chaos" in t for t in rec["child_stacks"].values())


# -- the object-store tier under chaos ----------------------------------------------------


def test_hedge_loser_drained_under_chaos_latency_at_io_remote():
    """Chaos latency at the io.remote site delays the primary GET; the hedge wins, the
    loser's lease is released, and the range is delivered exactly once."""
    from test_torch_remote_io import _SlowFirstAttemptFS, _engine_opts, _warmed_model

    from petastorm_tpu_torch.io.remote import RemoteReadEngine

    payload = bytes(reversed(range(256))) * 8
    fs = _SlowFirstAttemptFS(payload, slow_s=0.0)  # chaos adds the delay
    engine = RemoteReadEngine(
        fs, options=_engine_opts(hedge=True, hedge_min_samples=8, hedge_min_s=0.01),
        latency_model=_warmed_model("testremote", 256))
    plan = FaultPlan([FaultRule("io.remote", "latency", item_key="#primary",
                                latency_s=0.5, times=1)])
    s0 = lease_stats()
    try:
        with chaos.armed(plan, propagate=False):
            out = engine.fetch_ranges("blob", [(32, 256)])
        assert bytes(out[0]) == payload[32:32 + 256]
        assert len(plan.injections()) == 1
        assert engine.stats()["remote_hedge_wins"] == 1
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            s = lease_stats()
            got = (s["acquired"] - s0["acquired"], s["released"] - s0["released"])
            if got == (2, 2):
                break
            time.sleep(0.02)
        assert got == (2, 2)
        assert len(out) == 1  # exactly once: one payload for one requested range
    finally:
        engine.shutdown()


def test_footer_unreadable_quarantine_surfaces(chaos_dataset):
    """A quarantined item whose footer was never readable (rows unknown) goes through
    the degradation log and io_stats() instead of collapsing to -1 silently."""
    class HeadlessPiece:
        path = "gs://bucket/poison.parquet"
        row_group = 2
        num_rows = None

    with make_batch_reader(chaos_dataset, reader_pool_type="dummy",
                           shuffle_row_groups=False, num_epochs=1) as r:
        before = degradation_counts().get("footer_unreadable", 0)
        r._absorb_quarantine(QuarantinedItem(item=(0, 0, (HeadlessPiece(), 0)),
                                             error=RuntimeError("boom"), attempts=3,
                                             kind="worker"))
        assert r.io_stats()["footer_unreadable"] == 1
        assert degradation_counts()["footer_unreadable"] == before + 1
        assert r.quarantine_report.entries[0].num_rows == -1


def test_quarantine_resolves_rows_from_readable_footer(chaos_dataset):
    """A piece planned without its footer (num_rows=-1) has its real count read from the
    footer at quarantine, with no footer_unreadable."""
    real_path = os.path.join(chaos_dataset[len("file://"):], "part_01.parquet")

    class KvPiece:
        path = real_path
        row_group = 0
        num_rows = -1

    with make_batch_reader(chaos_dataset, reader_pool_type="dummy",
                           shuffle_row_groups=False, num_epochs=1) as r:
        before = degradation_counts().get("footer_unreadable", 0)
        r._absorb_quarantine(QuarantinedItem(item=(0, 1, (KvPiece(), 0)),
                                             error=RuntimeError("boom"), attempts=3,
                                             kind="worker"))
        assert r.quarantine_report.entries[0].num_rows == 16
        assert "footer_unreadable" not in r.io_stats()
        assert degradation_counts().get("footer_unreadable", 0) == before


def test_quarantine_counts_items_and_rows_on_the_registry(chaos_dataset):
    from petastorm_tpu_torch.obs.metrics import default_registry

    items = default_registry().counter("ptpu_quarantined_items_total")
    rows = default_registry().counter("ptpu_quarantined_rows_total")
    i0, r0 = items.value, rows.value
    plan = FaultPlan([FaultRule("worker.item", "raise_permanent", item_key="ordinal=6")])
    with chaos.armed(plan, propagate=False):
        with _open_quarantining(chaos_dataset) as reader:
            assert _collect_ids(reader) == sorted(set(ALL_IDS) - set(range(96, 112)))
    assert (items.value - i0, rows.value - r0) == (1, 16)


# -- marker / report plumbing ------------------------------------------------------------


def test_quarantine_report_is_falsy_when_empty():
    report = QuarantineReport()
    assert not report and len(report) == 0
    assert report.ordinals() == set()
    assert "empty" in report.render()
    assert report.as_dict() == {"quarantined": []}


def test_quarantined_item_marker_repr():
    marker = QuarantinedItem((0, 3, None), ValueError("boom"), 2, kind="child_death")
    assert "attempts=2" in repr(marker) and "child_death" in repr(marker)


# -- on the card ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_a_quarantined_pass_through_row_group_keeps_one_launch_a_batch(tmp_path):
    """On the card the pass-through under a poison row group launches K3, the scan and
    K4 once for every delivered batch, and the quarantined group costs no launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import pyarrow as pa
    import pyarrow.parquet as pq

    from petastorm_tpu_torch.loader import DataLoader
    from petastorm_tpu_torch.ops import pagedec_kernels as pk

    n = 8192
    v = np.repeat(np.arange(n // 8, dtype=np.float32), 8)
    pq.write_table(pa.table({"v": v, "k": np.arange(n, dtype=np.int64) % 7}),
                   str(tmp_path / "p.parquet"), row_group_size=1024, compression="snappy")
    plan = FaultPlan([FaultRule("io.pagedec", "raise_permanent", item_key="p.parquet:2")])
    before = (pk.snappy_inflate_ragged.launches, pk.rle_scan_pages.launches,
              pk.extract_pages.launches)
    with chaos.armed(plan, propagate=False):
        reader = make_batch_reader("file://" + str(tmp_path), reader_pool_type="dummy",
                                   shuffle_row_groups=False, io_options={"pagedec": "auto"},
                                   recovery={"on_poison": "quarantine"})
        with DataLoader(reader, 1024, device="cuda") as loader:
            got = [b["v"].cpu().numpy() for b in loader]
            entries = loader.quarantine_report.entries
    launches = tuple(a - b for a, b in zip((pk.snappy_inflate_ragged.launches,
                                            pk.rle_scan_pages.launches,
                                            pk.extract_pages.launches), before))
    assert launches == (7, 7, 7) and len(got) == 7
    assert [(e.row_group, e.num_rows) for e in entries] == [(2, 1024)]
    np.testing.assert_array_equal(np.concatenate(got),
                                  np.concatenate([v[:2048], v[3072:]]))
