"""The port's closed-loop controller against the JAX package's: the KnobSet's bounds and
restore, the live component retunes (readahead pool, GET engine, mem tier, disk
admission), the worker fleet resized under load on the thread and the process pool, the
policy engine's anti-oscillation contract, the loader's wiring and the live knob gauges.

Every case of the JAX package's ``tests/test_control.py`` has a counterpart here under
the same name (``test_fleet_hot_swap_under_load_byte_identical`` on the thread and the
process pool, as there). Beside them:

- one seeded window sequence through both packages' ``Controller`` over ``KnobSet`` s of
  identical stub knobs, covering warmup, debounce, hysteresis, cooldown, the step
  limit, the no-gain revert-and-freeze and the efficiency guard: the two
  ``decisions()`` lists are equal as ``to_dict()`` s, and so are ``collect()`` and
  ``state()``;
- ``build_knobset`` binds the reference's knobs with the reference's bounds for each
  pool type;
- a mid-epoch shrink and grow of the port's thread and process pools delivers exactly
  the JAX reader's id set with no duplicate, and a process pool's children ack a knob
  frame without a respawn;
- the card half (the controller armed on a main-path loader on the card) is in
  ``tests/test_torch_control_card.py``, which imports nothing of the JAX package.
"""
import gc
import os
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

torch = pytest.importorskip("torch")

from _torch_pool_helpers import _no_leaked_shm_segments  # noqa: E402,F401
from _torch_pool_helpers import no_leaked_port_slabs  # noqa: E402,F401
from petastorm_tpu import control as ref_control  # noqa: E402
from petastorm_tpu_torch.control import (  # noqa: E402
    ControlOptions,
    Controller,
    KnobSet,
    PolicyRule,
    build_knobset,
    default_rules,
)


def _write_dataset(tmp_path, files=3, row_groups=4, rows_per_group=16):
    root = str(tmp_path / "data")
    os.makedirs(root, exist_ok=True)
    rows_per_file = row_groups * rows_per_group
    for i in range(files):
        pq.write_table(
            pa.table({"id": np.arange(rows_per_file, dtype=np.int64) + i * rows_per_file,
                      "x": np.arange(rows_per_file, dtype=np.float64)}),
            os.path.join(root, "part-%02d.parquet" % i), row_group_size=rows_per_group)
    return root, files * rows_per_file


def _leaked_total():
    from petastorm_tpu_torch.obs.metrics import default_registry

    return default_registry().counter("ptpu_lease_leaked_total").value


# --------------------------------------------------------------------------------------
# KnobSet
# --------------------------------------------------------------------------------------


def _holder_knobset(package=None):
    knob_set = (package or _PORT).KnobSet
    state = {"depth": 3, "mode": "always"}
    ks = knob_set()
    ks.numeric("depth", get=lambda: state["depth"],
               apply_fn=lambda v: state.__setitem__("depth", v) or v,
               lo=1, hi=16, default=3)
    ks.enum("mode", get=lambda: state["mode"],
            apply_fn=lambda v: state.__setitem__("mode", v) or v,
            values=("always", "scan-resistant"))
    return ks, state


def test_knobset_bounds_and_rounding():
    ks, state = _holder_knobset()
    assert ks.apply("depth", 64) == (3, 16)
    assert ks.apply("depth", -5) == (16, 1)
    assert ks.apply("depth", 4.6) == (1, 5)
    assert state["depth"] == 5


def test_knobset_noop_when_clamp_lands_on_current():
    ks, state = _holder_knobset()
    ks.apply("depth", 16)
    before, after = ks.apply("depth", 99)
    assert before == after == 16


def test_knobset_enum_validates_membership():
    ks, _ = _holder_knobset()
    assert ks.apply("mode", "scan-resistant") == ("always", "scan-resistant")
    with pytest.raises(ValueError):
        ks.apply("mode", "sometimes")


def test_knobset_unknown_and_duplicate():
    ks, _ = _holder_knobset()
    with pytest.raises(KeyError):
        ks.apply("nope", 1)
    with pytest.raises(ValueError):
        ks.numeric("depth", get=lambda: 1, apply_fn=lambda v: v, lo=0, hi=1)


def test_knobset_checkpoint_restore_reports_moves():
    ks, state = _holder_knobset()
    snap = ks.checkpoint()
    ks.apply("depth", 8)
    ks.apply("mode", "scan-resistant")
    moved = ks.restore(snap)
    assert sorted(m[0] for m in moved) == ["depth", "mode"]
    assert state == {"depth": 3, "mode": "always"}
    assert ks.restore(snap) == []


def test_knobset_collect_exports_live_and_default():
    ks, _ = _holder_knobset()
    ks.apply("depth", 8)
    out = ks.collect()
    assert out["knob_depth"] == 8
    assert out["knob_depth_default"] == 3
    assert out["knob_mode"] == 0
    desc = ks.describe()
    assert desc["depth"]["value"] == 8 and desc["depth"]["hi"] == 16
    assert desc["mode"]["values"] == ("always", "scan-resistant")
    ref_ks, _ = _holder_knobset(ref_control)
    ref_ks.apply("depth", 8)
    assert out == ref_ks.collect() and desc == ref_ks.describe()


# --------------------------------------------------------------------------------------
# component retunes
# --------------------------------------------------------------------------------------


class _Piece:
    def __init__(self, path, rg):
        self.path = path
        self.row_group = rg


def test_readahead_pool_live_depth_and_budget():
    from petastorm_tpu_torch.io.readahead import ReadaheadPool

    class T:
        nbytes = 100

    pool = ReadaheadPool(lambda piece, cols: T(), depth=1, io_threads=1)
    try:
        reqs = [(_Piece("f", i), None) for i in range(6)]
        assert pool.schedule(reqs) == 1
        assert pool.apply_depth(4) == 4
        assert pool.stats()["readahead_depth_limit"] == 4
        pool.drain(5.0)
        assert pool.schedule(reqs) >= 3
        assert pool.apply_byte_budget(1) == 1
        pool.drain(5.0)
        time.sleep(0.05)
        assert pool.stats()["readahead_held_bytes"] <= 100
        assert pool.stats()["readahead_byte_budget"] == 1
    finally:
        pool.shutdown()


def test_readahead_pool_live_io_threads_swap_serves_reads():
    from petastorm_tpu_torch.io.readahead import ReadaheadPool

    class T:
        nbytes = 8

    pool = ReadaheadPool(lambda piece, cols: T(), depth=8, io_threads=1)
    try:
        assert pool.apply_io_threads(4) == 4
        assert pool.io_threads == 4
        p = _Piece("f", 0)
        pool.schedule([(p, None)])
        assert pool.get(p, None) is not None  # served by the swapped pool
        assert pool.apply_io_threads(4) == 4
        assert pool.stats()["readahead_io_threads"] == 4
    finally:
        pool.shutdown()


def test_remote_engine_live_pool_swap_and_quantile(tmp_path):
    import pyarrow.fs as pafs

    from petastorm_tpu_torch.io.remote import RemoteIoOptions, RemoteReadEngine

    path = str(tmp_path / "blob.bin")
    payload = bytes(range(256)) * 64
    with open(path, "wb") as f:
        f.write(payload)
    engine = RemoteReadEngine(pafs.LocalFileSystem(),
                              options=RemoteIoOptions(enabled=True, max_inflight=2,
                                                      hedge=False))
    try:
        got = engine.fetch_ranges(path, [(0, 64), (1000, 64)])
        assert bytes(got[0]) == payload[:64]
        assert engine.apply_max_inflight(6) == 6
        got = engine.fetch_ranges(path, [(0, 64), (256, 64), (512, 64)])
        assert bytes(got[1]) == payload[256:320]
        assert engine.stats()["remote_max_inflight"] == 6
        assert engine.apply_hedge_quantile(0.2) == 0.5
        assert engine.apply_hedge_quantile(0.9) == 0.9
        assert engine.stats()["remote_hedge_quantile"] == 0.9
    finally:
        engine.shutdown()


def test_memcache_live_budget_shrink_evicts():
    from petastorm_tpu_torch.io.memcache import MemCache, _Store

    store = _Store()
    cache = MemCache(10_000, store=store)
    try:
        a = {"v": np.arange(512, dtype=np.float64)}
        b = {"v": np.arange(512, dtype=np.float64) + 1}
        cache.get("a", lambda: a)
        cache.get("b", lambda: b)
        assert cache.stats()["memcache_entries"] == 2
        assert cache.apply_budget(5_000) == 5_000
        assert cache.stats()["memcache_entries"] == 1
        assert cache.stats()["memcache_budget_bytes"] == 5_000
        assert cache.budget == 5_000
        assert not cache.would_admit({"v": np.arange(1024, dtype=np.float64)})
    finally:
        cache.clear()


def test_tiered_cache_live_admission_policy():
    from petastorm_tpu_torch.io.tiers import TieredCache

    tc = TieredCache()
    try:
        assert tc.disk_admit == "always"
        assert tc.apply_disk_admit("scan-resistant") == "scan-resistant"
        assert tc.disk_admit == "scan-resistant"
        with pytest.raises(ValueError):
            tc.apply_disk_admit("never")
        assert tc.mem is None
    finally:
        tc.clear()


# --------------------------------------------------------------------------------------
# dispatcher and the fleet resized under load
# --------------------------------------------------------------------------------------


def test_pull_dispatcher_grow_withdraw_lookahead():
    from petastorm_tpu_torch.workers import PullDispatcher

    d = PullDispatcher(iter(range(10)), workers_count=2, lookahead=2, stealing=False)
    item, upcoming = d.next(0)
    assert item == 0 and len(upcoming) == 2
    d.ensure_workers(4)
    item, _ = d.next(3)
    assert item is not None
    assert d.withdraw(0) == 2
    item, _ = d.next(1)
    assert item in (1, 2)  # a handed-back item, not a fresh pull from the plan
    d.set_lookahead(0)
    while True:
        claim = d.next(1)
        if claim is None or claim[1] == ():
            break
    assert claim is None or claim[1] == ()


def test_pull_dispatcher_has_work_sees_stranded_returns():
    """The last-worker exit gate: a claim handed back after the plan drained keeps the
    stream open."""
    from petastorm_tpu_torch.workers import PullDispatcher

    d = PullDispatcher(iter(range(3)), workers_count=2, lookahead=2, stealing=False)
    assert d.has_work()
    d.next(0)
    assert d.next(1) is None
    assert d.has_work()  # worker 0 still owns its claim
    d.withdraw(0)
    assert d.has_work()
    got = [d.next(1)[0], d.next(1)[0]]
    assert sorted(got) == [1, 2]
    assert not d.has_work()
    assert d.return_items([7]) == 1 and d.next(1)[0] == 7


@pytest.mark.parametrize("pool", ["thread", "process"])
def test_fleet_hot_swap_under_load_byte_identical(tmp_path, pool):
    """Resize mid-epoch on the thread and the process pool: the delivered rows are an
    un-resized run's, no lease leaked. The process pool's results queue holds two
    results, so its children are still under load at the shrink (with the default 16
    the whole plan can be in the queue by then, and a resize of a finished stream is a
    no-op)."""
    from petastorm_tpu_torch.reader import make_batch_reader

    files = 2 if pool == "process" else 3
    root, total = _write_dataset(tmp_path, files=files)
    kwargs = dict(num_epochs=2, workers_count=2)
    if pool == "process":
        kwargs.update(wire_serializer="shm-view", results_queue_size=2)
    leaked = _leaked_total()
    with make_batch_reader("file://" + root, reader_pool_type=pool, **kwargs) as reader:
        ids = []
        n = 0
        for batch in reader:
            ids.extend(int(v) for v in np.asarray(batch.id))
            n += 1
            if n == 2:
                assert reader.resize_workers(4) == 4
            elif n == 5:
                assert reader.resize_workers(1) == 1
        assert reader._executor.target_workers == 1
    gc.collect()
    assert sorted(ids) == sorted(list(range(total)) * 2)
    assert _leaked_total() == leaked


def test_checkpoint_watermark_exact_across_shrink(tmp_path):
    """A state_dict taken right after a live shrink resumes with no loss and no
    replay."""
    from petastorm_tpu_torch.loader import DataLoader
    from petastorm_tpu_torch.reader import make_batch_reader

    root, total = _write_dataset(tmp_path, files=3)

    def make():
        return make_batch_reader("file://" + root, num_epochs=1, workers_count=3,
                                 shuffle_row_groups=False)

    seen = []
    state = None
    with DataLoader(make(), 16, device="cpu", to_device=False) as loader:
        for i, batch in enumerate(loader):
            seen.extend(int(v) for v in np.asarray(batch["id"]))
            if i == 1:
                loader.reader.resize_workers(1)
            if i == 3:
                state = loader.state_dict()
                break
    assert state is not None
    with DataLoader(make(), 16, device="cpu", to_device=False) as resumed:
        resumed.load_state_dict(state)
        rest = []
        for batch in resumed:
            rest.extend(int(v) for v in np.asarray(batch["id"]))
    assert sorted(seen[:4 * 16] + rest) == list(range(total))


def test_resize_after_stream_end_is_noop(tmp_path):
    from petastorm_tpu_torch.reader import make_batch_reader

    root, total = _write_dataset(tmp_path, files=1)
    with make_batch_reader("file://" + root, num_epochs=1, workers_count=2) as reader:
        assert sum(len(b.id) for b in reader) == total
        time.sleep(0.1)
        assert reader.resize_workers(8) == 2
        assert reader.live_workers() == 0


@pytest.mark.parametrize("pool", ["thread", "process"])
def test_resize_delivers_the_reference_id_set(tmp_path, pool):
    """A shrink then a grow mid-epoch of the port's pool: exactly the JAX reader's ids,
    each once; the live count reaches the shrunk size; a process pool's running
    children ack a knob frame sent mid-epoch, without a respawn."""
    from petastorm_tpu.reader import make_batch_reader as ref_make_batch_reader
    from petastorm_tpu_torch.reader import make_batch_reader

    root, total = _write_dataset(tmp_path, files=3, row_groups=8)
    url = "file://" + root
    with ref_make_batch_reader(url, reader_pool_type="dummy", tenant="a") as reader:
        ref_ids = sorted(int(i) for b in reader for i in b.id)
    leaked = _leaked_total()
    with make_batch_reader(url, reader_pool_type=pool, workers_count=4,
                           results_queue_size=2, tenant="a") as reader:
        ids, live = [], []
        for n, batch in enumerate(reader):
            ids.extend(int(v) for v in np.asarray(batch.id))
            if n == 2:
                assert reader.resize_workers(2) == 2
            elif 2 < n < 10:
                live.append(reader.live_workers())
            elif n == 10:
                assert reader.resize_workers(4) == 4
                assert reader.live_workers() == 4
            if n == 6 and pool == "process":
                assert reader.apply_readahead_depth(6) == 6
        acks = reader._executor.ctl_acks() if pool == "process" else {}
        stats = reader._executor.pool_stats() if pool == "process" else {}
    gc.collect()
    assert sorted(ids) == ref_ids == list(range(total))
    assert 2 in live and all(n_live >= 2 for n_live in live)
    assert _leaked_total() == leaked
    if pool == "process":
        assert acks and all(a == {"readahead_depth": 6} for a in acks.values())
        assert stats["respawns"] == 0


# --------------------------------------------------------------------------------------
# the policy engine (synthetic windows)
# --------------------------------------------------------------------------------------

_PORT = type("port", (), {"KnobSet": KnobSet, "Controller": Controller,
                          "PolicyRule": PolicyRule, "ControlOptions": ControlOptions})


def _ctl(state=None, rules=None, options=None, registry=None, package=None):
    pkg = package or _PORT
    state = state if state is not None else {"depth": 1}
    ks = pkg.KnobSet()
    ks.numeric("depth", get=lambda: state["depth"],
               apply_fn=lambda v: state.__setitem__("depth", v) or v,
               lo=1, hi=64, default=1)
    ks.numeric("workers", get=lambda: state.setdefault("workers", 4),
               apply_fn=lambda v: state.__setitem__("workers", v) or v,
               lo=1, hi=8, default=4)
    if rules is None:
        rules = [pkg.PolicyRule(
            "grow-depth", "depth", signal=lambda ctx: ctx.stat("sig", "value"),
            fire_above=0.5, clear_below=0.2, windows=2, cooldown=2,
            propose=lambda ctx, cur: cur * 2)]
    ctl = pkg.Controller(ks, rules=rules, registry=registry,
                         options=options or pkg.ControlOptions(
                             warmup_windows=0, settle_windows=1,
                             max_steps_without_gain=3))
    return ctl, state


def _window(sig=None, rows_delta=100.0, **extra):
    w = {"ptpu_pipeline_rows": {"delta": rows_delta, "kind": "value"}}
    if sig is not None:
        w["sig"] = {"value": sig, "kind": "gauge"}
    w.update(extra)
    return w


def _drive(ctl, signals, rows=None, t0=1000.0, dt=1.0):
    out = []
    for i, sig in enumerate(signals):
        rows_delta = rows[i] if rows is not None else 100.0
        out.append(ctl.evaluate(_window(sig, rows_delta), t0 + i * dt))
    return out


def test_controller_debounce_needs_consecutive_windows():
    ctl, state = _ctl()
    _drive(ctl, [0.9, 0.1, 0.9, 0.1])
    assert state["depth"] == 1 and not ctl.actuations()
    _drive(ctl, [0.9, 0.9], t0=2000.0)
    acts = ctl.actuations()
    assert len(acts) == 1 and state["depth"] == 2
    assert acts[0].knob == "depth" and (acts[0].before, acts[0].after) == (1, 2)
    assert "0.900" in acts[0].trigger and acts[0].window > 0


def test_controller_hysteresis_band_keeps_streak():
    ctl, state = _ctl()
    _drive(ctl, [0.9, 0.3, 0.9])
    assert len(ctl.actuations()) == 1 and state["depth"] == 2


def test_controller_warmup_is_observe_only():
    ctl, state = _ctl(options=ControlOptions(warmup_windows=5, settle_windows=1))
    _drive(ctl, [0.9] * 5)
    assert not ctl.actuations()
    _drive(ctl, [0.9, 0.9], t0=2000.0)
    assert len(ctl.actuations()) == 1


def test_controller_cooldown_spaces_actuations():
    ctl, state = _ctl()
    _drive(ctl, [0.9] * 10, rows=[100, 100, 100, 200, 400, 800, 1600, 3200, 6400, 12800])
    acts = ctl.actuations()
    assert len(acts) >= 2
    gaps = [b.window - a.window for a, b in zip(acts, acts[1:])]
    assert all(g >= 2 for g in gaps), gaps


def test_controller_step_limit_caps_one_actuation():
    ctl, state = _ctl(rules=[PolicyRule(
        "jump", "depth", signal=lambda ctx: ctx.stat("sig", "value"),
        fire_above=0.5, clear_below=0.2, windows=1, cooldown=0,
        propose=lambda ctx, cur: 64, max_step_factor=2.0)])
    _drive(ctl, [0.9])
    assert state["depth"] == 2


def test_controller_sparse_window_skips_streak():
    ctl, state = _ctl()
    _drive(ctl, [0.9, None, 0.9])
    assert len(ctl.actuations()) == 1


def test_controller_no_gain_reverts_and_freezes():
    ctl, state = _ctl()
    _drive(ctl, [0.9] * 12, rows=[100.0] * 12)
    causes = [d.cause for d in ctl.decisions()]
    assert "ctl_revert" in causes and "ctl_freeze" in causes
    assert ctl.frozen
    assert state["depth"] == 1
    before = len(ctl.decisions())
    _drive(ctl, [0.9] * 4, t0=5000.0)
    assert len(ctl.decisions()) == before
    ctl.reset()
    assert not ctl.frozen
    _drive(ctl, [0.9, 0.9], t0=9000.0)
    assert len(ctl.decisions()) > before


def test_controller_commits_on_best_window_improvement():
    ctl, state = _ctl()
    _drive(ctl, [0.9] * 10, rows=[100, 100, 100, 500, 500, 500, 500, 500, 500, 500])
    causes = [d.cause for d in ctl.decisions()]
    assert "ctl_revert" not in causes and not ctl.frozen
    assert state["depth"] > 1


def _shrink_rule(pkg=None):
    return (pkg or _PORT).PolicyRule(
        "shrink", "workers", signal=lambda ctx: ctx.stat("sig", "value"),
        fire_above=0.5, clear_below=0.2, windows=1, cooldown=0,
        propose=lambda ctx, cur: cur - 1, guarded=False)


def test_controller_efficiency_rule_skips_experiment_and_guards_drops():
    ctl, state = _ctl(rules=[_shrink_rule()])
    _drive(ctl, [0.9, 0.0, 0.0, 0.0], rows=[100.0] * 4)
    assert state["workers"] == 3 and not ctl.frozen
    assert all(d.cause == "ctl_actuate" for d in ctl.decisions())
    ctl2, state2 = _ctl(rules=[_shrink_rule()])
    _drive(ctl2, [0.9, 0.0, 0.0, 0.0], rows=[100.0, 100.0, 10.0, 10.0])
    reverts = [d for d in ctl2.decisions() if d.cause == "ctl_revert"]
    assert reverts and reverts[0].rule == "efficiency-guard"
    assert state2["workers"] == 4 and not ctl2.frozen


def test_controller_counts_and_flight_events():
    from petastorm_tpu_torch.obs.flight import FlightRecorder, activate, deactivate
    from petastorm_tpu_torch.obs.log import degradation_counts
    from petastorm_tpu_torch.obs.metrics import MetricsRegistry

    registry = MetricsRegistry()
    ctl, state = _ctl(registry=registry)
    before = degradation_counts().get("ctl_actuate", 0)
    recorder = FlightRecorder()
    activate(recorder)
    try:
        _drive(ctl, [0.9, 0.9])
    finally:
        deactivate(recorder)
    snap = registry.snapshot()
    assert snap['ptpu_ctl_actuations_total{knob="depth"}'] == 1
    assert degradation_counts().get("ctl_actuate", 0) == before + 1
    events = [e for e in recorder.events() if e.get("kind") == "ctl_decision"]
    assert events and events[-1]["knob"] == "depth"


def test_controller_collect_and_state():
    ctl, state = _ctl()
    _drive(ctl, [0.9, 0.9])
    out = ctl.collect()
    assert out["actuations"] == 1 and out["frozen"] == 0
    assert out["knob_depth"] == 2 and out["knob_depth_default"] == 1
    panel = ctl.state()
    assert panel["knobs"]["depth"]["value"] == 2
    assert panel["decisions"][-1]["cause"] == "ctl_actuate"


def test_default_rules_skip_missing_knobs_and_sites():
    ctl = Controller(KnobSet(), rules=default_rules(),
                     options=ControlOptions(warmup_windows=0))
    assert ctl.evaluate(_window(0.9), 1.0) == []
    assert ctl.evaluate(_window(0.9), 2.0) == []
    names = [r.name for r in default_rules()]
    assert names == [r.name for r in ref_control.default_rules()]


def _seeded_windows(seed, n=60):
    """A signal and rows/s sequence from a numpy seed: bursts over the fire threshold,
    dips into the hysteresis band and below the clear threshold, sparse windows, flat
    and rising objectives."""
    rng = np.random.default_rng(seed)
    sigs, rows = [], []
    level = 100.0
    for i in range(n):
        r = rng.random()
        sigs.append(None if r < 0.08 else float(rng.choice([0.05, 0.3, 0.45, 0.7, 0.95])))
        if rng.random() < 0.15:
            level *= float(rng.choice([0.3, 1.0, 1.6]))
        rows.append(round(level * (0.9 + 0.2 * rng.random()), 3))
    return sigs, rows


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_controller_decisions_equal_the_reference(seed):
    """One seeded window sequence through both packages' controllers over identical
    stub knobs and rules (a guarded grow, a step-limited jump, an efficiency shrink),
    with warmup and settling: equal decision lists, collect() and state()."""
    sigs, rows = _seeded_windows(seed)

    def build(pkg):
        rules = [
            pkg.PolicyRule("grow-depth", "depth",
                           signal=lambda ctx: ctx.stat("sig", "value"),
                           fire_above=0.5, clear_below=0.2, windows=2, cooldown=2,
                           propose=lambda ctx, cur: cur * 2),
            pkg.PolicyRule("jump", "depth", signal=lambda ctx: ctx.stat("sig", "value"),
                           fire_above=0.9, clear_below=0.4, windows=1, cooldown=1,
                           propose=lambda ctx, cur: 64, max_step_factor=1.5),
            _shrink_rule(pkg),
        ]
        return _ctl(rules=rules, package=pkg, options=pkg.ControlOptions(
            warmup_windows=3, settle_windows=2, max_steps_without_gain=4))

    ours, our_state = build(_PORT)
    ref, ref_state = build(ref_control)
    for i, (sig, r) in enumerate(zip(sigs, rows)):
        got = ours.evaluate(_window(sig, r), 500.0 + i * 0.5)
        want = ref.evaluate(_window(sig, r), 500.0 + i * 0.5)
        assert [d.to_dict() for d in got] == [d.to_dict() for d in want], i
        if i == len(sigs) // 2:
            ours.reset()
            ref.reset()
    assert [d.to_dict() for d in ours.decisions()] == \
        [d.to_dict() for d in ref.decisions()]
    assert ours.decisions(), "the sequence exercised no decision"
    assert our_state == ref_state
    assert ours.collect() == ref.collect() and ours.state() == ref.state()
    assert ours.frozen == ref.frozen


# --------------------------------------------------------------------------------------
# the loader's wiring and the live gauges
# --------------------------------------------------------------------------------------


def test_loader_controller_requires_metrics(tmp_path):
    from petastorm_tpu_torch.loader import DataLoader
    from petastorm_tpu_torch.reader import make_batch_reader

    root, _ = _write_dataset(tmp_path, files=1)
    reader = make_batch_reader("file://" + root, num_epochs=1)
    try:
        with pytest.raises(ValueError, match="controller"):
            DataLoader(reader, 16, device="cpu", to_device=False, controller=True)
    finally:
        reader.stop()
        reader.join()


def test_loader_controller_e2e_and_live_gauges(tmp_path):
    """The knob gauges report the live value after a retune: through io_stats, the
    registry snapshot and the controller's collector."""
    from petastorm_tpu_torch.loader import DataLoader
    from petastorm_tpu_torch.obs.metrics import MetricsRegistry
    from petastorm_tpu_torch.reader import make_batch_reader

    root, total = _write_dataset(tmp_path, files=2)
    registry = MetricsRegistry()
    reader = make_batch_reader("file://" + root, num_epochs=1, workers_count=2)
    with DataLoader(reader, 16, device="cpu", to_device=False, metrics=registry,
                    controller=True) as loader:
        ctl = loader.controller
        assert ctl is not None
        assert "readahead_depth" in ctl.knobs
        rows = 0
        for batch in loader:
            rows += len(batch["id"])
            if rows == 16:
                before, after = ctl.knobs.apply("readahead_depth", 8)
                assert after == 8
            registry.sample_timelines()
        assert rows == total
        assert reader.io_stats()["readahead_depth_limit"] == 8
        snap = registry.snapshot()
        assert snap["ptpu_io_readahead_depth_limit"] == 8
        assert snap["ptpu_ctl_knob_readahead_depth"] == 8
        assert snap["ptpu_ctl_knob_readahead_depth_default"] == 3
        assert loader.ctl_decisions() == [] == loader.controller_decisions()
    assert ctl._store is None  # the loader's own controller is detached at exit


def test_loader_shared_controller_not_detached(tmp_path):
    from petastorm_tpu_torch.loader import DataLoader
    from petastorm_tpu_torch.obs.metrics import MetricsRegistry
    from petastorm_tpu_torch.reader import make_batch_reader

    root, _ = _write_dataset(tmp_path, files=1)
    registry = MetricsRegistry()
    reader = make_batch_reader("file://" + root, num_epochs=1)
    shared = Controller(build_knobset(reader), registry=registry)
    with DataLoader(reader, 16, device="cpu", to_device=False, metrics=registry,
                    controller=shared) as loader:
        assert loader.controller is shared
        for _ in loader:
            pass
    assert shared._store is not None  # the caller's: stays attached
    shared.detach()


def test_worker_knob_overrides_apply_before_lazy_build(tmp_path):
    """A retune made before the pool exists applies at its lazy build."""
    from petastorm_tpu_torch.reader import make_batch_reader

    root, total = _write_dataset(tmp_path, files=1)
    with make_batch_reader("file://" + root, num_epochs=1,
                           reader_pool_type="dummy") as reader:
        worker = reader._worker
        assert worker.apply_readahead_depth(6) == 6
        assert worker._readahead is None
        assert worker.live_io_knobs()["readahead_depth"] == 6
        rows = sum(len(b.id) for b in reader)
        assert rows == total
        pool = worker._readahead
        assert pool is not None and pool.depth == 6


@pytest.mark.parametrize("pool,io_options", [
    ("thread", {"pagedec": "off"}),
    ("dummy", {"memcache_bytes": 64 << 20, "pagedec": "auto"}),
    ("process", {"pagedec": "off"})])
def test_build_knobset_binds_the_reference_knobs(tmp_path, pool, io_options):
    """The same store and options through both packages' build_knobset: the same knob
    names, bounds and defaults for each pool type. ``pagedec`` is given: the port's
    default is ``off``, the JAX package's ``auto``."""
    from petastorm_tpu.reader import make_batch_reader as ref_make_batch_reader
    from petastorm_tpu_torch.io.memcache import shared_store
    from petastorm_tpu_torch.reader import make_batch_reader

    root, _ = _write_dataset(tmp_path, files=1)
    url = "file://" + root

    def shape(ks):
        out = {}
        for name, entry in ks.describe().items():
            entry = dict(entry)
            entry.pop("value")  # a running reader's live value may already differ
            out[name] = entry
        return out

    kwargs = dict(reader_pool_type=pool, workers_count=2, io_options=io_options)

    def disk(name):
        # the thread case reads through a disk tier: the port leaves the funnel (and
        # its disk_admit knob) out of a reader with nothing to cache
        return dict(cache_type="local-disk", cache_location=str(tmp_path / name)) \
            if pool == "thread" else {}

    try:
        with make_batch_reader(url, **kwargs, **disk("c0")) as reader:
            ours = shape(build_knobset(reader))
        with ref_make_batch_reader(url, **kwargs, **disk("c1")) as reader:
            ref = shape(ref_control.build_knobset(reader))
    finally:
        shared_store().clear()
    assert ours == ref and "readahead_depth" in ours


def test_stats_panel_renders_controller_and_excludes_catch_all():
    from petastorm_tpu.obs.stats_cli import render_dashboard as ref_render
    from petastorm_tpu_torch.obs.stats_cli import render_dashboard

    metrics = {
        "ptpu_ctl_windows": 12,
        "ptpu_ctl_actuations": 3,
        "ptpu_ctl_reverts": 1,
        "ptpu_ctl_freezes": 1,
        "ptpu_ctl_frozen": 1,
        "ptpu_ctl_knob_readahead_depth": 8,
        "ptpu_ctl_knob_readahead_depth_default": 3,
        "ptpu_ctl_knob_workers": 4,
        "ptpu_ctl_knob_workers_default": 4,
        'ptpu_ctl_actuations_total{knob="readahead_depth"}': 3,
    }
    out = render_dashboard(metrics)
    assert "controller:" in out and "[FROZEN]" in out
    assert "readahead_depth" in out and "[RETUNED]" in out
    assert "actuations=3" in out
    assert "other metrics" not in out
    assert out == ref_render(metrics)
