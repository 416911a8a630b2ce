"""The port's attribution plane against the JAX package's: per-item provenance, the
critical-path fold and the loader's attribution report.

Every case of the JAX package's ``tests/test_provenance.py`` has a counterpart here
under the same name (its dashboard case is in ``tests/test_torch_stats_cli.py``).
Beside them:

- the fold (``fold_self_times``, ``diff_self_times``, ``analyze_batches``) over seeded
  random span sets (nested, sibling and partially overlapping spans) gives exactly the
  reference's dicts, ``to_dict()`` and ``render()`` string;
- the same store through both packages' ``make_batch_reader(provenance=True)`` and
  ``DataLoader(to_device=False)``, on the dummy, thread and process pools, gives exactly
  the same item keys, each item's sites and annotations, the batches' row counts and the
  items that fed each batch (times are not compared);
- the report names ``decode.device_inflate`` when that stage is slowed, and
  ``reader.read`` when the read is, with the stage running the kernels' plain versions
  on the CPU (``PTPU_PAGEDEC_DEVICE=1``); an SLO alert of the same loader names the
  slowed site as its culprit;
- ``gpu``-marked cases hold provenance-on runs equal to provenance-off runs on the card,
  with the same kernel launches (they skip here).
"""
import json
import os
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

torch = pytest.importorskip("torch")

from _torch_pool_helpers import _no_leaked_shm_segments  # noqa: E402,F401
from _torch_pool_helpers import no_leaked_port_slabs  # noqa: E402,F401
from petastorm_tpu import chaos as ref_chaos  # noqa: E402
from petastorm_tpu import loader as ref_loader  # noqa: E402
from petastorm_tpu import reader as ref_reader  # noqa: E402
from petastorm_tpu.obs import critical_path as ref_cp  # noqa: E402
from petastorm_tpu.obs import provenance as ref_prov  # noqa: E402
from petastorm_tpu_torch import chaos  # noqa: E402
from petastorm_tpu_torch.chaos import FaultPlan, FaultRule  # noqa: E402
from petastorm_tpu_torch.loader import DataLoader  # noqa: E402
from petastorm_tpu_torch.obs import critical_path as cp  # noqa: E402
from petastorm_tpu_torch.obs import provenance as prov  # noqa: E402
from petastorm_tpu_torch.obs.critical_path import (analyze_batches,  # noqa: E402
                                                   fold_self_times)
from petastorm_tpu_torch.obs.provenance import (ItemProvenance,  # noqa: E402
                                                ProvenanceRecorder)
from petastorm_tpu_torch.reader import make_batch_reader  # noqa: E402


@pytest.fixture(autouse=True)
def _clean_plane():
    """Every test starts and ends with both packages' planes disarmed: they are separate
    module globals, and a recorder left armed would refuse the next test's."""
    for mod in (prov, ref_prov):
        mod.ACTIVE = None
        mod._tls.item = None
    yield
    for mod in (prov, ref_prov):
        mod.ACTIVE = None
        mod._tls.item = None


@pytest.fixture
def store(tmp_path):
    root = str(tmp_path / "data")
    os.makedirs(root)
    for i in range(3):
        pq.write_table(
            pa.table({"id": np.arange(64, dtype=np.int64) + i * 64,
                      "x": np.random.default_rng(i).random(64)}),
            os.path.join(root, "p%d.parquet" % i))
    return root


def _leaked_total():
    from petastorm_tpu_torch.obs.metrics import default_registry

    return default_registry().counter("ptpu_lease_leaked_total").value


def _assert_exactly_once(loader, expected_rows):
    per_item = {}
    for b in loader.provenance.batches():
        for e, o, r in (b["items"] or ()):
            per_item[(e, o)] = per_item.get((e, o), 0) + r
    assert sum(per_item.values()) == expected_rows, per_item
    quarantined = {(e, o) for e, o, _a, _k in loader.provenance.quarantined()}
    assert not (quarantined & set(per_item))
    assert loader.provenance.duplicate_absorbs == 0
    return per_item


# -- critical-path fold -----------------------------------------------------------------


def test_fold_charges_nested_spans_to_the_child():
    spans = [("outer", 0.0, 10.0, 1),
             ("inner", 2.0, 8.0, 1),
             ("leaf", 3.0, 4.0, 2)]
    out = fold_self_times(spans)
    assert out["leaf"] == pytest.approx(1.0)
    assert out["inner"] == pytest.approx(5.0)   # 6 - 1 nested
    assert out["outer"] == pytest.approx(4.0)   # 10 - 6 nested


def test_fold_partial_overlap_is_siblings():
    out = fold_self_times([("a", 0.0, 5.0, 1), ("b", 3.0, 9.0, 1)])
    assert out["a"] == pytest.approx(5.0)
    assert out["b"] == pytest.approx(6.0)


def test_fold_same_site_accumulates():
    out = fold_self_times([("a", 0.0, 1.0, 1), ("a", 2.0, 3.5, 1)])
    assert out["a"] == pytest.approx(2.5)


def test_analyze_batches_names_the_culprit_and_splits_by_tier():
    views = []
    for i in range(10):
        slow = i == 9
        views.append({
            "seq": i, "rows": 8, "step_gap_s": 1.0 if slow else 0.01,
            "spans": [{"site": "loader.collate", "t0": 0.0, "t1": 0.002, "pid": 1}],
            "items": [(0, i, 8)],
            "item_records": [{
                "annotations": {"cache_tier": "remote" if slow else "mem"},
                "attempts": 1,
                "spans": [{"site": "io.remote", "t0": 0.0,
                           "t1": 0.9 if slow else 0.004, "pid": 1}],
            }],
        })
    report = analyze_batches(views)
    assert report.batches == 10
    assert report.top_stage == "io.remote"
    assert report.slow_top == "io.remote"
    assert "io.remote" in report.verdict
    assert report.by_tier["remote"]["p99_s"] >= report.by_tier["mem"]["p99_s"]
    d = report.to_dict()
    assert d["slow_top"] == "io.remote"
    assert "io.remote" in report.render()


def test_fold_sibling_pop_preserves_grandparent():
    """A partially overlapping sibling pops only the top of the stack: enclosing
    ancestors that still contain the new span keep their parenthood."""
    out = fold_self_times([("gp", 0.0, 10.0, 1), ("a", 1.0, 4.0, 1),
                           ("b", 3.0, 9.0, 1)])
    assert out["a"] == pytest.approx(3.0)
    assert out["b"] == pytest.approx(6.0)
    assert out["gp"] == pytest.approx(1.0)  # 10 - 3 - 6: both nested


def test_concurrent_items_fold_per_record_not_merged():
    """Two items' interleaved timelines must not charge outer spans twice: each record
    folds alone, nesting intact."""
    views = [{"seq": 1, "rows": 8, "step_gap_s": 0.1, "spans": [],
              "items": [(0, 0, 4), (0, 1, 4)],
              "item_records": [
                  {"annotations": {}, "attempts": 1, "spans": [
                      {"site": "reader.read", "t0": 0, "t1": 10, "pid": 1},
                      {"site": "io.remote", "t0": 1, "t1": 9, "pid": 1}]},
                  {"annotations": {}, "attempts": 1, "spans": [
                      {"site": "reader.read", "t0": 0.5, "t1": 10.5, "pid": 2}]}]}]
    rep = analyze_batches(views)
    # chain A: read self 10-8=2s + remote 8s; chain B: read self 10s, summing to each
    # chain's own wall, never the merged timeline's 20s
    assert rep.stage_self_s["io.remote"] == pytest.approx(8.0)
    assert rep.stage_self_s["reader.read"] == pytest.approx(12.0)


# -- the fold against the reference on seeded random span sets -------------------------

_SITES = ("reader.read", "io.remote", "io.readahead", "wire.roundtrip", "child.work",
          "transform", "decode.device_inflate", "loader.h2d")


def _random_spans(rng, n):
    """``n`` spans over a few sites: independent intervals (siblings and partial
    overlaps) and children drawn strictly inside an earlier span (nesting), on a
    millisecond grid so equal starts and ends occur too."""
    spans = []
    for _ in range(n):
        site = _SITES[int(rng.integers(len(_SITES)))]
        pid = int(rng.integers(1, 3))
        if spans and rng.random() < 0.5:
            _s, p0, p1, _p = spans[int(rng.integers(len(spans)))]
            a, b = sorted(rng.uniform(p0, p1, size=2))
            t0, t1 = round(float(a), 3), round(float(b), 3)
        else:
            t0 = round(float(rng.uniform(0, 10)), 3)
            t1 = round(t0 + float(rng.uniform(0, 3)), 3)
        spans.append((site, t0, t1, pid))
    return spans


def _span_dicts(spans):
    return [{"site": s, "t0": t0, "t1": t1, "pid": p} for s, t0, t1, p in spans]


def _random_views(rng, n_batches):
    views = []
    for seq in range(n_batches):
        records = []
        for _ in range(int(rng.integers(0, 4))):
            ann = {}
            if rng.random() < 0.7:
                ann["cache_tier"] = ("mem", "arena", "disk", "remote")[int(rng.integers(4))]
            for name in ("io_retries", "hedges"):
                if rng.random() < 0.2:
                    ann[name] = int(rng.integers(1, 3))
            if rng.random() < 0.1:
                ann["quarantined"] = "exception"
            records.append({"annotations": ann, "attempts": int(rng.integers(1, 3)),
                            "spans": _span_dicts(_random_spans(rng, int(rng.integers(0, 6))))})
        views.append({
            "seq": seq, "rows": 8,
            "step_gap_s": None if rng.random() < 0.15
            else round(float(rng.uniform(0.001, 0.5)), 4),
            "spans": _span_dicts(_random_spans(rng, int(rng.integers(0, 4)))),
            "items": None, "item_records": records})
    return views


@pytest.mark.parametrize("seed", range(8))
def test_fold_and_report_equal_the_reference_on_random_spans(seed):
    """Exact equality (no tolerance): the same arithmetic in the same order."""
    rng = np.random.default_rng(seed)
    for n in (0, 1, 5, 40):
        spans = _random_spans(rng, n)
        assert cp.fold_self_times(spans) == ref_cp.fold_self_times(spans)
    a = {s: round(float(rng.uniform(0, 2)), 4) for s in _SITES if rng.random() < 0.7}
    b = {s: round(float(rng.uniform(0, 2)), 4) for s in _SITES if rng.random() < 0.7}
    b["noise.site"] = 1e-4
    for min_share in (0.0, 0.05, 0.3):
        assert cp.diff_self_times(a, b, min_share) \
            == ref_cp.diff_self_times(a, b, min_share)
    for n_batches in (0, 1, 7, 30):
        views = _random_views(rng, n_batches)
        ours, theirs = cp.analyze_batches(views), ref_cp.analyze_batches(views)
        assert ours.to_dict() == theirs.to_dict()
        assert ours.render() == theirs.render()
        assert str(ours) == str(theirs)


# -- recorder units ---------------------------------------------------------------------


def test_item_key_is_the_chaos_stable_key():
    class Piece:
        path = "/d/p.parquet"
        row_group = 3

    tagged = (1, 7, (Piece(), 0))
    assert prov.item_key(tagged) == "epoch=1 ordinal=7 /d/p.parquet:3"
    assert prov.item_key(tagged) == ref_prov.item_key(tagged)
    rec_a = ItemProvenance(*prov.item_identity(tagged))
    rec_b = ItemProvenance(*prov.item_identity(tagged))
    assert rec_a.trace_id == rec_b.trace_id  # stable across processes
    assert rec_a.trace_id == ref_prov.ItemProvenance(
        *ref_prov.item_identity(tagged)).trace_id


def test_hooks_are_noops_when_disarmed():
    assert prov.begin_item((0, 0, "x")) is None  # graftlint: disable=GL-O003 (disarmed no-op)
    prov.add_span("site", 0.0, 1.0)
    prov.annotate("k", "v")
    with prov.span("site"):
        pass
    assert prov.end_item() is None


def test_recorder_spans_annotations_and_retry_attempts():
    rec = ProvenanceRecorder().arm()
    try:
        tagged = (0, 1, "item")
        prov.begin_item(tagged)  # graftlint: disable=GL-O003 (unit test drives the raw API)
        with prov.span("reader.read"):
            time.sleep(0.002)
        prov.annotate("cache_tier", "mem")
        prov.annotate_add("io_retries", 2)
        prov.end_item()
        # a retry of the same (epoch, ordinal) reuses the record
        prov.begin_item(tagged)  # graftlint: disable=GL-O003 (unit test drives the raw API)
        prov.end_item()
        items = rec.items()
        assert len(items) == 1
        record = next(iter(items.values()))
        assert record["attempts"] == 2
        assert record["annotations"] == {"cache_tier": "mem", "io_retries": 2}
        assert record["spans"][0]["site"] == "reader.read"
        assert record["spans"][0]["t1"] > record["spans"][0]["t0"]
    finally:
        rec.disarm()


def test_second_recorder_arm_raises_but_rearm_is_idempotent():
    rec = ProvenanceRecorder().arm()
    try:
        rec.arm()  # same recorder: fine
        with pytest.raises(RuntimeError):
            ProvenanceRecorder().arm()
        # the JAX package's plane is another module global: arming it is independent
        ref = ref_prov.ProvenanceRecorder().arm()
        ref.disarm()
    finally:
        rec.disarm()
    other = ProvenanceRecorder().arm()  # after disarm: fine
    other.disarm()


def test_absorb_child_aligns_clocks_and_learns_the_key():
    rec = ProvenanceRecorder()
    # the delivery note arrives first, with only (epoch, ordinal)
    rec.note_delivery(0, 4, 64)
    wall = time.time() + 100.0      # a "child" whose anchors are shifted
    perf = 5000.0
    blob = (0, 4, "epoch=0 ordinal=4 /d/p.parquet:1",
            [("child.work", 5000.0, 5000.5, 4242)], {"hedges": 1})
    rec.absorb_child(blob, 4242, wall, perf)
    items = rec.items()
    key = "epoch=0 ordinal=4 /d/p.parquet:1"
    assert key in items
    span = items[key]["spans"][0]
    assert span["pid"] == 4242
    assert span["t1"] - span["t0"] == pytest.approx(0.5)
    # aligned onto the parent timeline: ~100s ahead of the recorder origin
    assert span["t0"] - rec._origin == pytest.approx(100.0, abs=5.0)
    assert items[key]["annotations"]["hedges"] == 1


def test_item_registry_is_bounded():
    rec = ProvenanceRecorder(max_items=4)
    for i in range(10):
        rec.note_delivery(0, i, 1)
    assert len(rec.items()) == 4


def test_batch_cut_consumes_the_delivery_fifo_in_order():
    rec = ProvenanceRecorder()
    rec.note_delivery(0, 0, 10)
    rec.note_delivery(0, 1, 6)
    bp1 = rec.producer_cut(8)
    bp2 = rec.producer_cut(8)
    assert bp1.items == [(0, 0, 8)]
    assert bp2.items == [(0, 0, 2), (0, 1, 6)]
    rec.transfer_next()
    rec.transfer_span("loader.h2d", 0.0, 0.001)
    assert rec.batch_delivered() is not None
    assert rec.batch_delivered() is not None
    batches = rec.batches()
    assert [b["seq"] for b in batches] == [1, 2]
    assert batches[0]["spans"][0]["site"] == "loader.h2d"
    assert batches[1]["step_gap_s"] is not None


def test_dropped_batches_keep_pointers_aligned():
    rec = ProvenanceRecorder()
    rec.note_delivery(0, 0, 16)
    bp1 = rec.producer_cut(8)
    bp2 = rec.producer_cut(8)
    rec.batch_dropped(bp1)
    delivered = rec.batch_delivered()
    assert delivered is bp2


def test_summary_is_cached_until_the_window_moves():
    rec = ProvenanceRecorder()
    rec.note_delivery(0, 0, 8)
    rec.producer_cut(8)
    rec.batch_delivered()
    first = rec.summary()
    assert rec._summary_cache is not None
    assert rec.summary() == first  # served from cache, equal content
    rec.note_delivery(0, 1, 8)
    rec.producer_cut(8)
    rec.batch_delivered()
    second = rec.summary()
    assert second["batches"] == 2  # cache invalidated by the new batch


def test_env_switch_and_resolve():
    assert prov.resolve(None, env_default=False) is None
    assert prov.resolve(False) is None
    rec = prov.resolve(True)
    try:
        assert prov.ACTIVE is rec and rec._auto_disarm
    finally:
        rec.disarm()
    shared = ProvenanceRecorder()
    assert prov.resolve(shared) is shared and not shared._auto_disarm
    shared.disarm()


# -- loader end-to-end ------------------------------------------------------------------


@pytest.mark.parametrize("pool", ["dummy", "thread"])
def test_loader_attribution_end_to_end(store, pool):
    leaked0 = _leaked_total()
    reader = make_batch_reader("file://" + store, num_epochs=2,
                               workers_count=2, reader_pool_type=pool,
                               provenance=True)
    with DataLoader(reader, 32, to_device=False, device="cpu") as loader:
        rows = sum(len(b["id"]) for b in loader)
    assert rows == 384
    assert _leaked_total() - leaked0 == 0
    per_item = _assert_exactly_once(loader, rows)
    assert len(per_item) == 6  # 3 files x 2 epochs
    items = loader.provenance.items()
    assert all(".parquet:" in k for k in items)
    assert all(rec["spans"] for rec in items.values())
    bp = loader.batch_provenance()
    assert bp["item_records"] and bp["rows"] == 32
    report = loader.attribution_report()
    assert report.batches == 12
    assert report.stage_self_s
    assert "critical path" in report.render() or report.verdict
    # the module plane is released at __exit__
    assert prov.ACTIVE is None


def test_loader_without_provenance_refuses():
    loader = DataLoader.__new__(DataLoader)
    loader._prov_rec = None
    with pytest.raises(ValueError, match="provenance"):
        loader._require_provenance()


def test_process_pool_merges_child_spans_and_keys(store):
    reader = make_batch_reader("file://" + store, num_epochs=1,
                               workers_count=2, reader_pool_type="process",
                               wire_serializer="shm-view", provenance=True)
    with DataLoader(reader, 32, to_device=False, device="cpu") as loader:
        rows = sum(len(b["id"]) for b in loader)
    assert rows == 192
    _assert_exactly_once(loader, rows)
    items = loader.provenance.items()
    assert all(".parquet:" in k for k in items)
    local = os.getpid()
    pids = {sp["pid"] for rec in items.values() for sp in rec["spans"]}
    assert any(p != local for p in pids), "child spans did not merge"
    sites = {sp["site"] for rec in items.values() for sp in rec["spans"]}
    assert {"wire.roundtrip", "wire.decode", "child.work"} <= sites
    # the child's spans fall inside the driver's wire.roundtrip span of the same item
    for rec in items.values():
        trip = [sp for sp in rec["spans"] if sp["site"] == "wire.roundtrip"]
        work = [sp for sp in rec["spans"] if sp["site"] == "child.work"]
        assert len(trip) == len(work) == 1
        assert trip[0]["t0"] - 0.05 <= work[0]["t0"] <= work[0]["t1"] \
            <= trip[0]["t1"] + 0.05
    report = loader.attribution_report()
    assert report.batches == 6


def test_perfetto_flow_events_link_item_spans_across_pids(store, tmp_path):
    from petastorm_tpu_torch.trace import TraceRecorder

    tracer = TraceRecorder()
    reader = make_batch_reader("file://" + store, num_epochs=1,
                               workers_count=2, reader_pool_type="process",
                               wire_serializer="shm-view", provenance=True)
    with DataLoader(reader, 64, to_device=False, trace=tracer, device="cpu") as loader:
        rows = sum(len(b["id"]) for b in loader)
    assert rows == 192
    path = str(tmp_path / "trace.json")
    tracer.dump(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    flows = [e for e in events if e["ph"] in ("s", "t", "f")]
    assert flows, "no flow events in the dump"
    by_id = {}
    for e in flows:
        by_id.setdefault(e["id"], []).append(e)
    # one flow a delivered item, each spanning >= 2 pid lanes and terminated
    assert len(by_id) == 3
    for chain in by_id.values():
        phases = [e["ph"] for e in sorted(chain, key=lambda e: e["ts"])]
        assert phases[0] == "s" and phases[-1] == "f"
        assert len({e["pid"] for e in chain}) >= 2


def test_shuffling_disables_batch_membership_but_items_still_collect(store):
    reader = make_batch_reader("file://" + store, num_epochs=1,
                               workers_count=2, provenance=True)
    with DataLoader(reader, 32, to_device=False, device="cpu",
                    shuffling_queue_capacity=128, seed=1) as loader:
        rows = sum(len(b["id"]) for b in loader)
    assert rows == 192
    rec = loader.provenance
    assert len(rec._delivery_fifo) == 0  # never grows while disabled
    for b in rec.batches():
        assert b["items"] is None
    assert len(rec.items()) == 3  # item records still collected


# -- the structure against the reference ------------------------------------------------


def _structure(loader):
    """What both packages must agree on: each item's sites, annotations and rows, and
    each batch's rows and contributing items, keyed by the item key with the store's
    directory cut off (the two runs read one store)."""
    rec = loader.provenance
    items = {}
    for key, r in rec.items().items():
        items[key] = (sorted({sp["site"] for sp in r["spans"]}),
                      sorted(r["annotations"].items()), r["rows"], r["attempts"])
    batches = [(b["rows"], [tuple(e) for e in b["items"]]) for b in rec.batches()]
    return items, batches


@pytest.mark.parametrize("pool", ["dummy", "thread", "process"])
def test_item_site_and_batch_structure_equal_the_reference(tmp_path, pool):
    """One worker (the delivery order and the readahead hits are then the plan's), two
    epochs over six row groups with a cut that splits row groups across batches."""
    root = str(tmp_path / "data")
    os.makedirs(root)
    for i in range(3):
        pq.write_table(pa.table({"id": np.arange(48, dtype=np.int64) + i * 48,
                                 "x": np.random.default_rng(i).random(48)}),
                       os.path.join(root, "p%d.parquet" % i), row_group_size=24)
    url = "file://" + root
    kwargs = dict(num_epochs=2, workers_count=1, reader_pool_type=pool,
                  shuffle_row_groups=False, provenance=True)
    with DataLoader(make_batch_reader(url, **kwargs), 20, to_device=False,
                    device="cpu", last_batch="partial") as ours:
        ours_ids = [int(v) for b in ours for v in b["id"]]
    with ref_loader.DataLoader(ref_reader.make_batch_reader(url, **kwargs), 20,
                               to_device=False, last_batch="partial") as theirs:
        theirs_ids = [int(v) for b in theirs for v in np.asarray(b["id"])]
    assert ours_ids == theirs_ids and len(ours_ids) == 288
    ours_items, ours_batches = _structure(ours)
    theirs_items, theirs_batches = _structure(theirs)
    assert ours_items == theirs_items
    assert ours_batches == theirs_batches
    assert len(ours_batches) == 15
    assert len(ours_items) == 12  # 6 row groups x 2 epochs
    annotations = {k for _s, ann, _r, _a in ours_items.values() for k, _v in ann}
    assert "cache_tier" in annotations and "readahead" in annotations
    assert ours.attribution_report().batches == theirs.attribution_report().batches


def test_io_retries_annotate_the_item_as_the_reference_does(tmp_path):
    """A transient read fault every third read hit: the retried items carry the same
    ``io_retries`` counts in both packages (dummy pool, readahead off)."""
    root = str(tmp_path / "data")
    os.makedirs(root)
    pq.write_table(pa.table({"id": np.arange(96, dtype=np.int64)}),
                   os.path.join(root, "p.parquet"), row_group_size=16)
    url = "file://" + root
    kwargs = dict(reader_pool_type="dummy", shuffle_row_groups=False, provenance=True,
                  io_options={"readahead": False},
                  recovery={"io_retries": 2, "io_retry_backoff_s": 0.0})

    def annotations(loader):
        return {k: r["annotations"].get("io_retries", 0)
                for k, r in loader.provenance.items().items()}

    with chaos.armed(FaultPlan([FaultRule("reader.read", "raise_transient", every=3)],
                               seed=1), propagate=False):
        with DataLoader(make_batch_reader(url, **kwargs), 16, to_device=False,
                        device="cpu") as ours:
            assert sum(len(b["id"]) for b in ours) == 96
    with ref_chaos.armed(ref_chaos.FaultPlan(
            [ref_chaos.FaultRule("reader.read", "raise_transient", every=3)], seed=1),
            propagate=False):
        with ref_loader.DataLoader(ref_reader.make_batch_reader(url, **kwargs), 16,
                                   to_device=False) as theirs:
            assert sum(len(b["id"]) for b in theirs) == 96
    assert annotations(ours) == annotations(theirs)
    # the 3rd and 6th hits fail (each retry is a hit of its own)
    assert sum(annotations(ours).values()) == 2


# -- acceptance scenarios ---------------------------------------------------------------


def test_attribution_under_tiered_remote_path(store):
    """CloudLatencyFS + mem tier: the verdict is stable across re-folds, tier
    annotations present, zero leaked leases, ids exactly once, and
    bottleneck_report() keeps working beside it."""
    import pyarrow.fs as pafs

    from petastorm_tpu_torch.io.latencyfs import CloudLatencyFS
    from petastorm_tpu_torch.io.memcache import shared_store

    def run():
        fs = CloudLatencyFS(pafs.LocalFileSystem(), seed=3,
                            base_latency_s=0.01, tail_fraction=0.2,
                            tail_multiplier=5.0)
        leaked0 = _leaked_total()
        reader = make_batch_reader(
            "file://" + store, filesystem=fs, num_epochs=2, workers_count=2,
            provenance=True,
            io_options=dict(readahead=False, memcache_bytes=64 << 20,
                            remote=dict(enabled=True, hedge=False)))
        with DataLoader(reader, 32, to_device=False, device="cpu") as loader:
            rows = sum(len(b["id"]) for b in loader)
        assert rows == 384
        assert _leaked_total() - leaked0 == 0
        _assert_exactly_once(loader, rows)
        tiers = {rec["annotations"].get("cache_tier")
                 for rec in loader.provenance.items().values()}
        report = loader.attribution_report()
        assert loader.bottleneck_report().verdict  # coexists
        return report, tiers, loader.provenance

    shared_store().clear()
    try:
        # COLD run: epoch 1 pays the injected remote latency, epoch 2 serves from the
        # (process-wide) mem tier: the totals blame the remote plane
        first, tiers, recorder = run()
        assert "remote" in tiers and "mem" in tiers
        assert first.top_stage == "io.remote"
        # the verdict is stable: re-folding the same window gives the same attribution
        assert recorder.report().to_dict() == first.to_dict()
        # WARM run: the mem tier serves everything, so the attribution must not keep
        # blaming a remote plane that never ran
        second, tiers2, _rec2 = run()
        assert tiers2 == {"mem"}
        assert second.top_stage != "io.remote"
        assert second.stage_self_s.get("io.remote", 0.0) == 0.0
    finally:
        shared_store().clear()


def test_attribution_under_quarantine_heavy_chaos(store):
    """A poison-heavy chaos plan: the quarantined id lands in the provenance ledger
    exactly once, disjoint from deliveries; attempts are recorded; zero leaked leases;
    the report stays computable."""
    leaked0 = _leaked_total()
    plan = FaultPlan([FaultRule("worker.item", "raise_transient",
                                item_key="p1.parquet")], seed=9)
    with chaos.armed(plan, propagate=False):
        reader = make_batch_reader(
            "file://" + store, num_epochs=1, workers_count=2,
            provenance=True,
            recovery=dict(on_poison="quarantine", poison_attempts=2))
        with DataLoader(reader, 32, to_device=False, device="cpu") as loader:
            rows = sum(len(b["id"]) for b in loader)
    assert rows == 128  # p1's 64 rows quarantined away
    assert _leaked_total() - leaked0 == 0
    per_item = _assert_exactly_once(loader, rows)
    quarantined = loader.provenance.quarantined()
    assert len(quarantined) == 1
    epoch, ordinal, attempts, kind = quarantined[0]
    assert attempts == 2
    assert (epoch, ordinal) not in per_item
    items = loader.provenance.items()
    poisoned = [r for r in items.values() if r["annotations"].get("quarantined")]
    assert len(poisoned) == 1
    report = loader.attribution_report()
    assert report.batches == 4
    assert "quarantined" not in report.by_cause or \
        report.by_cause["quarantined"]["batches"] >= 0


# -- the slowed stage is named: the inflate stage, the read -----------------------------


def _pagedec_store(tmp_path, n=3000, row_group_size=300, seed=11):
    """The JAX package's pass-through store: a repeated float column and a small-range
    int column take the pass-through, the int32 id column reads classically."""
    rng = np.random.default_rng(seed)
    root = str(tmp_path / "pd")
    os.makedirs(root, exist_ok=True)
    pq.write_table(pa.table({
        "feat": np.repeat(rng.normal(size=-(-n // 40)).astype(np.float32), 40)[:n],
        "cat": rng.integers(0, 13, size=n).astype(np.int64),
        "id": np.arange(n, dtype=np.int32)}),
        os.path.join(root, "part-0.parquet"), compression="snappy",
        row_group_size=row_group_size)
    return "file://" + root


def _slowed_run(url, site, latency_s, **loader_kwargs):
    """One pass of the store with ``site`` slowed by ``latency_s`` on every hit: one
    worker and no readahead (so no background read spans compete), the pass-through on
    and the inflate stage running the kernels' plain versions."""
    with chaos.armed(FaultPlan([FaultRule(site, "latency", every=1,
                                          latency_s=latency_s)], seed=3),
                     propagate=False):
        with make_batch_reader(url, reader_pool_type="thread", workers_count=1,
                               shuffle_row_groups=False,
                               io_options={"pagedec": "on", "readahead": False},
                               provenance=True) as r:
            with DataLoader(r, 300, device="cpu", **loader_kwargs) as loader:
                ids = [int(v) for b in loader for v in b["id"]]
                return loader, ids, loader.attribution_report()


def test_attribution_names_device_inflate_when_slow(tmp_path, monkeypatch):
    """The counterpart of the JAX package's test of the same name, built not to flake
    under load: readahead off (no IO-thread spans), and an injected 0.25 s that is far
    more than the rest of a batch's host work (about 2 ms here), so the slowed site owns
    well over half of the slowest batch's critical path however busy the host is."""
    monkeypatch.setenv("PTPU_PAGEDEC_DEVICE", "1")
    url = _pagedec_store(tmp_path)
    _loader, ids, slow = _slowed_run(url, "decode.device_inflate", 0.25)
    assert sorted(ids) == list(range(3000))
    assert slow.slow_top == "decode.device_inflate", (slow.slow_top, slow.slow_share)
    assert slow.slow_share["decode.device_inflate"] > 0.5, slow.slow_share
    _loader, _ids, clean = _slowed_run(url, "reader.read", 0.25)
    assert clean.slow_top == "reader.read", clean.slow_share
    assert clean.slow_share["reader.read"] > 0.5, clean.slow_share
    assert clean.slow_share.get("decode.device_inflate", 0.0) < 0.5


def test_slo_alert_names_the_slowed_site_as_its_culprit(tmp_path, monkeypatch):
    """``DataLoader(slos=, metrics=, provenance=)``: a breach of the inflate stage's p99
    objective fires an alert whose culprit is the slowed stage."""
    from petastorm_tpu_torch.obs.metrics import MetricsRegistry
    from petastorm_tpu_torch.obs.slo import SloSpec

    monkeypatch.setenv("PTPU_PAGEDEC_DEVICE", "1")
    url = _pagedec_store(tmp_path)
    registry = MetricsRegistry()
    spec = SloSpec(name="inflate-p99", metric='ptpu_pipeline_stage_seconds{stage='
                   '"device_inflate"}', stat="p99", op="<=", threshold=0.05,
                   breach_windows=1)
    with chaos.armed(FaultPlan([FaultRule("decode.device_inflate", "latency", every=1,
                                          latency_s=0.25)], seed=3), propagate=False):
        with make_batch_reader(url, reader_pool_type="thread", workers_count=1,
                               shuffle_row_groups=False,
                               io_options={"pagedec": "on", "readahead": False},
                               provenance=True) as r:
            with DataLoader(r, 300, device="cpu", metrics=registry, slos=[spec]) as loader:
                for i, _batch in enumerate(loader):
                    if i in (3, 8):
                        # a window once the report has step gaps, and a later one
                        registry.sample_timelines()
                alerts = loader.slo_alerts()
    assert len(alerts) == 1, alerts  # the breach latches: one alert an excursion
    assert alerts[0].name == "inflate-p99"
    assert alerts[0].culprit == "decode.device_inflate"
    assert alerts[0].attribution["slow_top"] == "decode.device_inflate"
    assert "decode.device_inflate" in alerts[0].message


def test_slo_breach_debounce_and_attribution_snapshot():
    """The JAX package's case, with a real attribution report as the source: the alert
    carries its ``to_dict()`` and names its slow-decile site."""
    from petastorm_tpu_torch.obs.slo import SloEngine, SloSpec

    rec = ProvenanceRecorder()
    for i in range(10):
        rec.note_delivery(0, i, 8)
        bp = rec.producer_cut(8)
        rec.batch_span(bp, "io.remote" if i == 9 else "loader.h2d", 0.0,
                       0.9 if i == 9 else 0.001)
        time.sleep(0.002 if i < 9 else 0.02)
        rec.batch_delivered()

    def window(p99):
        return {"m": {"kind": "histogram", "t": 0, "count": 5, "sum": p99 * 5,
                      "p50": p99, "p99": p99}}

    engine = SloEngine(specs=[SloSpec(name="p99", metric="m", stat="p99", op="<=",
                                      threshold=0.1, breach_windows=3)],
                       attribution=rec.report)
    assert engine.evaluate(window(0.5), t=1.0) == []
    assert engine.evaluate(window(0.5), t=2.0) == []
    alerts = engine.evaluate(window(0.5), t=3.0)
    assert len(alerts) == 1
    alert = alerts[0]
    assert alert.cause == "slo_breach" and alert.windows == 3
    assert alert.culprit == "io.remote"
    assert alert.attribution["slow_top"] == "io.remote"
    assert alert.attribution == rec.report().to_dict()
    assert "io.remote" in alert.message
    assert engine.evaluate(window(0.6), t=4.0) == []
    assert engine.evaluate(window(0.01), t=5.0) == []
    assert engine.evaluate(window(0.5), t=6.0) == []
    assert engine.evaluate(window(0.5), t=7.0) == []
    assert len(engine.evaluate(window(0.5), t=8.0)) == 1
    assert len(engine.alerts()) == 2


def test_metrics_export_the_prov_families_and_the_flight_record_carries_them(store):
    from petastorm_tpu_torch.obs.metrics import MetricsRegistry

    registry = MetricsRegistry()
    reader = make_batch_reader("file://" + store, num_epochs=1, workers_count=1,
                               reader_pool_type="dummy", provenance=True)
    with DataLoader(reader, 32, to_device=False, device="cpu", metrics=registry) as loader:
        assert sum(len(b["id"]) for b in loader) == 192
        snap = registry.snapshot()
        context = loader._health_context()
    assert snap["ptpu_prov_items"] == 3 and snap["ptpu_prov_batches"] == 6
    assert any(k.startswith("ptpu_prov_self_s_reader_read") for k in snap)
    assert context["attribution"]["batches"] == 6


# -- reader-level (loader-less) and lifecycle -------------------------------------------


def test_loader_less_reader_records_items(store):
    reader = make_batch_reader("file://" + store, num_epochs=1,
                               workers_count=1, provenance=True)
    rec = reader._prov
    try:
        rows = 0
        for batch in reader:
            rows += len(batch.id)
        assert rows == 192
        items = rec.items()
        assert len(items) == 3
        assert all(r["rows"] == 64 for r in items.values())
    finally:
        reader.stop()
        reader.join()
        rec.disarm()


def test_factory_recorder_released_at_reader_teardown(store):
    """A factory-built recorder releases the process-global slot at reader join: a
    second provenance reader in the same process works after the first is torn down,
    and is refused while the first is live."""
    r1 = make_batch_reader("file://" + store, num_epochs=1, provenance=True)
    try:
        with pytest.raises(RuntimeError, match="armed"):
            make_batch_reader("file://" + store, num_epochs=1, provenance=True)
    finally:
        r1.stop()
        r1.join()
    assert prov.ACTIVE is None  # join released the slot
    r2 = make_batch_reader("file://" + store, num_epochs=1, provenance=True)
    try:
        rows = sum(len(b.id) for b in r2)
        assert rows == 192
        assert len(r2._prov.items()) == 3
    finally:
        r2.stop()
        r2.join()
    assert prov.ACTIVE is None


def test_reset_rearms_the_recorder(store):
    """reset() goes through join() (release) then _start (arm again): the second pass
    keeps recording."""
    reader = make_batch_reader("file://" + store, num_epochs=1, provenance=True)
    try:
        assert sum(len(b.id) for b in reader) == 192
        reader.reset()
        assert prov.ACTIVE is reader._prov
        assert sum(len(b.id) for b in reader) == 192
        items = reader._prov.items()
        assert all(r["rows"] == 128 for r in items.values())  # both passes
    finally:
        reader.stop()
        reader.join()


def test_caller_supplied_recorder_stays_armed_past_teardown(store):
    """A recorder the caller passed in is the caller's to release: loader __exit__ and
    reader join must not release it."""
    rec = ProvenanceRecorder()
    reader = make_batch_reader("file://" + store, num_epochs=1, provenance=rec)
    with DataLoader(reader, 32, to_device=False, device="cpu", provenance=rec) as loader:
        assert sum(len(b["id"]) for b in loader) == 192
    assert prov.ACTIVE is rec  # still armed: caller-owned
    rec.disarm()


def test_per_row_reader_and_make_dataloader_take_provenance(store, tmp_path):
    from petastorm_tpu_torch import types as ptypes
    from petastorm_tpu_torch.codecs import ScalarCodec
    from petastorm_tpu_torch.loader import make_dataloader
    from petastorm_tpu_torch.metadata import write_dataset
    from petastorm_tpu_torch.reader import make_reader
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField

    schema = Unischema("S", [UnischemaField("id", np.int64, (), ScalarCodec(
        ptypes.LongType()), False)])
    url = "file://" + str(tmp_path / "rows")
    write_dataset(url, schema, ({"id": i} for i in range(12)), rows_per_file=4)
    with make_reader(url, reader_pool_type="dummy", provenance=True) as reader:
        assert sorted(r.id for r in reader) == list(range(12))
        items = reader._prov.items()
    assert sum(r["rows"] for r in items.values()) == 12
    assert prov.ACTIVE is None
    with make_dataloader("file://" + store, 32, provenance=True, to_device=False,
                         device="cpu", reader_pool_type="dummy") as loader:
        assert sum(len(b["id"]) for b in loader) == 192
    assert loader.attribution_report().batches == 6
    assert prov.ACTIVE is None


# -- Reporter rotation ------------------------------------------------------------------


def test_reporter_jsonl_rotation_caps_growth(tmp_path):
    from petastorm_tpu_torch.obs.export import Reporter
    from petastorm_tpu_torch.obs.metrics import MetricsRegistry

    registry = MetricsRegistry()
    registry.counter("ptpu_test_total").inc()
    path = str(tmp_path / "stats.jsonl")
    reporter = Reporter(registry=registry, interval_s=600.0, jsonl_path=path,
                        max_bytes=200, keep=2)
    for _ in range(12):
        reporter._write_once()
    size = os.path.getsize(path)
    assert size <= 200 + 120  # cap + at most one line of slack
    rotated = sorted(p.name for p in tmp_path.iterdir())
    assert "stats.jsonl.1" in rotated and "stats.jsonl.2" in rotated
    assert "stats.jsonl.3" not in rotated  # keep=2 bounds the chain
    for name in ("stats.jsonl", "stats.jsonl.1", "stats.jsonl.2"):
        with open(str(tmp_path / name)) as f:
            for line in f:
                assert "metrics" in json.loads(line)


def test_reporter_rotation_preserves_stop_flush(tmp_path):
    from petastorm_tpu_torch.obs.export import Reporter
    from petastorm_tpu_torch.obs.metrics import MetricsRegistry

    registry = MetricsRegistry()
    path = str(tmp_path / "stats.jsonl")
    with Reporter(registry=registry, interval_s=600.0, jsonl_path=path,
                  max_bytes=10_000, keep=1):
        pass  # stop() writes the final snapshot through the rotation path
    with open(path) as f:
        assert "metrics" in json.loads(f.readline())


def test_reporter_without_cap_never_rotates(tmp_path):
    from petastorm_tpu_torch.obs.export import Reporter
    from petastorm_tpu_torch.obs.metrics import MetricsRegistry

    path = str(tmp_path / "stats.jsonl")
    reporter = Reporter(registry=MetricsRegistry(), interval_s=600.0,
                        jsonl_path=path)
    for _ in range(5):
        reporter._write_once()
    assert [p.name for p in tmp_path.iterdir()] == ["stats.jsonl"]


# -- on the card ------------------------------------------------------------------------


def _pagedec_launches():
    from petastorm_tpu_torch.ops import pagedec_kernels as pk

    return (pk.snappy_inflate_ragged.launches, pk.rle_scan_pages.launches,
            pk.extract_pages.launches)


@pytest.mark.gpu
def test_inflate_stage_with_provenance_on_the_card_matches_provenance_off(tmp_path):
    """With provenance on, the pass-through launches K3, the scan and K4 once a batch
    as without it, delivers the same bytes, and the report carries the stage."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n = 8192
    pq.write_table(pa.table({"v": np.repeat(np.arange(n // 8, dtype=np.float32), 8),
                             "k": np.arange(n, dtype=np.int64) % 7}),
                   str(tmp_path / "p.parquet"), row_group_size=1024, compression="snappy")

    def run(provenance):
        reader = make_batch_reader("file://" + str(tmp_path), reader_pool_type="dummy",
                                   shuffle_row_groups=False,
                                   io_options={"pagedec": "auto"}, provenance=provenance)
        before = _pagedec_launches()
        with DataLoader(reader, 1024, device="cuda") as loader:
            out = [{k: v.cpu().numpy() for k, v in b.items()} for b in loader]
            report = loader.attribution_report() if provenance else None
        return out, tuple(a - b for a, b in zip(_pagedec_launches(), before)), report

    plain, plain_launches, _ = run(None)
    recorded, recorded_launches, report = run(True)
    assert recorded_launches == plain_launches == (len(plain),) * 3
    for a, b in zip(plain, recorded):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].tobytes() == b[k].tobytes()
    assert report.batches == len(plain)
    assert report.stage_self_s.get("decode.device_inflate", 0.0) > 0.0


@pytest.mark.gpu
def test_main_path_with_provenance_on_the_card_matches_provenance_off(tmp_path):
    """The JPEG main path with provenance on: the same images a row id as without it,
    and stage2_planes and stage2_rgb launched as often."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import cv2

    from petastorm_tpu_torch import types as ptypes
    from petastorm_tpu_torch.codecs import CompressedImageCodec, ScalarCodec
    from petastorm_tpu_torch.metadata import write_dataset
    from petastorm_tpu_torch.ops import jpeg
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField

    schema = Unischema("S", [
        UnischemaField("id", np.int64, (), ScalarCodec(ptypes.LongType()), False),
        UnischemaField("image", np.uint8, (32, 48, 3), CompressedImageCodec("jpeg", 85),
                       False)])
    rng = np.random.RandomState(3)
    url = "file://" + str(tmp_path / "s")
    write_dataset(url, schema, ({"id": i, "image": cv2.GaussianBlur(
        rng.randint(0, 256, (32, 48, 3)).astype(np.uint8), (5, 5), 2.0)}
        for i in range(32)), row_group_size_mb=0, rows_per_file=8)

    def run(provenance):
        reader = make_batch_reader(url, reader_pool_type="thread", workers_count=2,
                                   decode_on_device=True, provenance=provenance)
        before = (jpeg.stage2_planes_segments.launches, jpeg.stage2_rgb.launches)
        images = {}
        with DataLoader(reader, 8, device="cuda") as loader:
            for b in loader:
                for i, img in zip(b["id"].cpu().numpy(), b["image"].cpu().numpy()):
                    images[int(i)] = img
        return images, (jpeg.stage2_planes_segments.launches - before[0],
                        jpeg.stage2_rgb.launches - before[1])

    plain, plain_launches = run(None)
    recorded, recorded_launches = run(True)
    assert recorded_launches == plain_launches and plain_launches[0] >= 4
    assert sorted(plain) == sorted(recorded) == list(range(32))
    for i in plain:
        np.testing.assert_array_equal(plain[i], recorded[i])
