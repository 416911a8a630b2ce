"""The port's tenant plane against the JAX package's: context resolution and validation,
the resource meter (counters and the event-driven arena byte*seconds integral), the
fleet-mergeable usage report, per-tenant SLO dimensioning and the delivery charges.

Every case of the JAX package's ``tests/test_tenant.py`` has a counterpart here under
the same name except ``test_frame_tenant_header_round_trip_and_old_peer_compat`` (the
tcp transport's tenant header: ROADMAP.md Queue 1 item 4(c)). Beside them:

- one seeded metrics snapshot through both packages' ``TenantUsageReport``: equal
  ``to_dict()``, ``render()``, ``top_consumer()`` and ``merge()``;
- one store read with ``tenant="a"`` by both packages' readers (dummy pool): equal
  ``ptpu_tenant_rows_total{tenant="a"}`` charges, and the port's process pool charges
  the same rows and its children's worker seconds in the parent;
- a tagged ``DataLoader`` charges its decode seconds; the arena charges the admitting
  tenant's residency;
- the card half (a tagged main-path loader on the card) is in
  ``tests/test_torch_control_card.py``, which imports nothing of the JAX package.
"""
import os
import pickle
import threading

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

torch = pytest.importorskip("torch")

from _torch_pool_helpers import _no_leaked_shm_segments  # noqa: E402,F401
from _torch_pool_helpers import no_leaked_port_slabs  # noqa: E402,F401
from petastorm_tpu.obs import provenance as ref_prov  # noqa: E402
from petastorm_tpu.obs import tenant as ref_tenant  # noqa: E402
from petastorm_tpu_torch.obs import provenance as prov  # noqa: E402
from petastorm_tpu_torch.obs import tenant as tenant_mod  # noqa: E402
from petastorm_tpu_torch.obs.metrics import MetricsRegistry, default_registry  # noqa: E402
from petastorm_tpu_torch.obs.tenant import (  # noqa: E402
    UNTAGGED,
    TenantContext,
    TenantUsageReport,
)


@pytest.fixture(autouse=True)
def _tenant_reset():
    for mod in (tenant_mod, ref_tenant):
        mod._reset_for_tests()
    for mod in (prov, ref_prov):
        mod.ACTIVE = None
    yield
    for mod in (tenant_mod, ref_tenant):
        mod._reset_for_tests()
    for mod in (prov, ref_prov):
        mod.ACTIVE = None


# -- context validation and resolution --------------------------------------------------


def test_context_validates_bounded_slug():
    ctx = TenantContext("team-a.prod_1", job="j42", priority="high")
    assert (ctx.tenant, ctx.job, ctx.priority) == ("team-a.prod_1", "j42", "high")
    for bad in ("", "UPPER", "-leading", "a" * 33, "sp ace", 'q"uote', "unié"):
        with pytest.raises(ValueError):
            TenantContext(bad)
        with pytest.raises(ValueError):
            ref_tenant.TenantContext(bad)  # the same grammar
    with pytest.raises(ValueError):
        TenantContext("ok", job="Bad Job")
    with pytest.raises(ValueError):
        TenantContext("ok", priority="urgent")


def test_context_immutable_picklable_value_semantics():
    ctx = TenantContext("a", job="j", priority="low")
    with pytest.raises(AttributeError):
        ctx.tenant = "b"
    assert ctx == TenantContext("a", job="j", priority="low")
    assert ctx != TenantContext("a")
    assert hash(ctx) == hash(TenantContext("a", job="j", priority="low"))
    assert pickle.loads(pickle.dumps(ctx)) == ctx
    assert ctx.env() == {"PTPU_TENANT": "a", "PTPU_TENANT_JOB": "j",
                         "PTPU_TENANT_PRIORITY": "low"}
    assert ctx.env() == ref_tenant.TenantContext("a", job="j", priority="low").env()
    assert repr(ctx) == repr(ref_tenant.TenantContext("a", job="j", priority="low"))


def test_from_env_degrades_on_invalid_slug():
    """A launcher typo runs untagged (tenant_label_invalid) instead of raising."""
    assert tenant_mod.from_env({}) is None
    assert tenant_mod.from_env({"PTPU_TENANT": "NOT A SLUG"}) is None
    ctx = tenant_mod.from_env({"PTPU_TENANT": "a", "PTPU_TENANT_JOB": "B AD",
                               "PTPU_TENANT_PRIORITY": "urgent"})
    assert (ctx.tenant, ctx.job, ctx.priority) == ("a", None, None)
    counter = default_registry().counter("ptpu_degradations_total",
                                         cause="tenant_label_invalid")
    assert counter.value >= 1


def test_resolve_order_explicit_beats_env(monkeypatch):
    monkeypatch.setenv("PTPU_TENANT", "env-tenant")
    assert tenant_mod.resolve("arg-tenant").tenant == "arg-tenant"
    ctx = TenantContext("ctx-tenant")
    assert tenant_mod.resolve(ctx) is ctx
    assert tenant_mod.resolve(None).tenant == "env-tenant"
    assert tenant_mod.resolve(None, env_default=False) is None
    with pytest.raises(ValueError):
        tenant_mod.resolve("NOT A SLUG")
    with pytest.raises(TypeError):
        tenant_mod.resolve(42)


def test_activation_is_thread_local():
    ctx = TenantContext("a")
    assert tenant_mod.current() is None
    seen = {}

    def other_thread():
        seen["label"] = tenant_mod.current_label()

    with tenant_mod.activate(ctx):
        assert tenant_mod.current() is ctx
        t = threading.Thread(target=other_thread)
        t.start()
        t.join(timeout=10.0)
        assert not t.is_alive()
    assert seen["label"] is None  # the activation never leaked across threads
    assert tenant_mod.current() is None
    tenant_mod.set_default(ctx)  # the process default applies without an activation
    assert tenant_mod.current_label() == "a"
    assert tenant_mod.label_of(None) == UNTAGGED == ref_tenant.UNTAGGED


# -- the meter --------------------------------------------------------------------------


def test_charge_noop_untagged_and_labels_when_tagged():
    reg = MetricsRegistry()
    tenant_mod.charge("rows", 10, registry=reg)  # untagged: charges nothing
    assert not any(n.startswith("ptpu_tenant_") for n in reg.snapshot())
    with tenant_mod.activate(TenantContext("a")):
        tenant_mod.charge("rows", 10, registry=reg)
        tenant_mod.charge("read_bytes", 4096, registry=reg)
    tenant_mod.charge("rows", 5, label="b", registry=reg)
    snap = reg.snapshot()
    assert snap['ptpu_tenant_rows_total{tenant="a"}'] == 10
    assert snap['ptpu_tenant_read_bytes_total{tenant="a"}'] == 4096
    assert snap['ptpu_tenant_rows_total{tenant="b"}'] == 5
    # the same resources under the same family names
    assert {k: v[0] for k, v in tenant_mod.RESOURCES.items()} == \
        {k: v[0] for k, v in ref_tenant.RESOURCES.items()}


def test_arena_byte_seconds_integral_is_event_driven():
    """Residency x time accrues exactly between adjustments (explicit ``now=`` stamps
    make the integral deterministic)."""
    reg = MetricsRegistry()
    m = tenant_mod.meter(reg)
    m.arena_adjust("a", 1000.0, now=10.0)
    m.arena_adjust("a", 1000.0, now=12.0)
    m.arena_adjust("a", -1500.0, now=13.0)
    m.arena_settle(now=15.0)
    snap = reg.snapshot()
    assert snap['ptpu_tenant_arena_byte_seconds_total{tenant="a"}'] == \
        pytest.approx(2.0 * 1000 + 1.0 * 2000 + 2.0 * 500)
    assert snap['ptpu_tenant_arena_resident_bytes{tenant="a"}'] == 500.0
    m.arena_adjust("a", -9999.0, now=16.0)  # never below zero
    assert reg.snapshot()['ptpu_tenant_arena_resident_bytes{tenant="a"}'] == 0.0


# -- the usage report -------------------------------------------------------------------


def _usage_metrics():
    return {
        'ptpu_tenant_rows_total{tenant="a"}': 100.0,
        'ptpu_tenant_worker_seconds_total{tenant="a"}': 1.5,
        'ptpu_tenant_rows_total{tenant="b"}': 900.0,
        'ptpu_tenant_worker_seconds_total{tenant="b"}': 6.0,
        'ptpu_tenant_hedged_gets_total{tenant="b"}': 3.0,
        "ptpu_io_tier_bytes_total": 1e6,  # untagged families never report
        'ptpu_other_total{tenant="a"}': 5.0,  # not a RESOURCES family
    }


def test_report_from_metrics_and_top_consumer():
    report = TenantUsageReport.from_metrics(_usage_metrics())
    assert report.tenants() == ["a", "b"]
    assert report.get("a", "rows") == 100.0
    assert report.top_consumer("worker_s") == ("b", 6.0)
    assert report.top_consumer("quarantined") == (None, 0.0)
    assert "other" not in str(report.to_dict())


def test_report_merge_sums_per_tenant():
    a = TenantUsageReport.from_metrics(_usage_metrics())
    b = TenantUsageReport({"b": {"rows": 100.0}, "c": {"rows": 7.0}})
    merged = a.merge(b)
    assert merged.get("b", "rows") == 1000.0
    assert merged.get("c", "rows") == 7.0
    assert a.get("b", "rows") == 900.0  # merge never mutates its inputs


def test_report_render_ranks_by_worker_seconds():
    lines = TenantUsageReport.from_metrics(_usage_metrics()).render()
    assert lines[0].startswith("tenants (ptpu_tenant_")
    assert lines[1].lstrip().startswith("b ")
    assert lines[2].lstrip().startswith("a ")


def _seeded_snapshot(seed, tenants=12):
    """A snapshot of every RESOURCES family for ``tenants`` tenants, values from a numpy
    seed, with untagged and unknown families mixed in."""
    rng = np.random.default_rng(seed)
    metrics = {}
    for i in range(tenants):
        name = "t%02d" % i
        for resource, (family, _) in tenant_mod.RESOURCES.items():
            if rng.random() < 0.8:
                value = float(rng.integers(0, 5000)) if resource in (
                    "rows", "hedged_gets", "quarantined", "svc_items") \
                    else float(rng.random() * 1e7)
                metrics['%s{tenant="%s"}' % (family, name)] = value
    metrics["ptpu_pipeline_rows"] = 123.0
    metrics['ptpu_unknown_total{tenant="t00"}'] = 9.0
    metrics['ptpu_tenant_rows_total{tenant="t01",x="1"}'] = 4.0
    return metrics


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_usage_report_equals_the_reference_on_a_seeded_snapshot(seed):
    metrics = _seeded_snapshot(seed)
    ours = TenantUsageReport.from_metrics(metrics)
    ref = ref_tenant.TenantUsageReport.from_metrics(metrics)
    assert ours.to_dict() == ref.to_dict()
    assert ours.render() == ref.render()
    assert ours.render(top=3) == ref.render(top=3)
    for resource in tenant_mod.RESOURCES:
        assert ours.top_consumer(resource) == ref.top_consumer(resource)
    other = _seeded_snapshot(seed + 10, tenants=5)
    assert ours.merge(TenantUsageReport.from_metrics(other)).to_dict() == \
        ref.merge(ref_tenant.TenantUsageReport.from_metrics(other)).to_dict()


# -- per-tenant SLO dimensioning ----------------------------------------------------------


def test_slo_per_tenant_expansion_names_the_tenant():
    from petastorm_tpu_torch.obs.slo import SloEngine, SloSpec, _strip_tenant

    assert _strip_tenant('m{tenant="x"}') == ("m", "x")
    assert _strip_tenant('m{a="1",tenant="x"}') == ('m{a="1"}', "x")
    assert _strip_tenant('m{tenant="x",a="1"}') == ('m{a="1"}', "x")
    assert _strip_tenant("m") == ("m", None)

    spec = SloSpec(name="burn", metric="ptpu_tenant_rows_total", stat="delta", op="<=",
                   threshold=100.0, breach_windows=2, per_tenant=True)
    engine = SloEngine(specs=[spec])
    noisy = 'ptpu_tenant_rows_total{tenant="b"}'
    quiet = 'ptpu_tenant_rows_total{tenant="a"}'

    def window(qa, qb):
        return {quiet: {"delta": qa}, noisy: {"delta": qb}}

    assert engine.evaluate(window(10.0, 500.0), t=1.0) == []
    assert engine.breaching() == {'burn{tenant="b"}': 1}
    alerts = engine.evaluate(window(10.0, 500.0), t=2.0)
    assert len(alerts) == 1
    alert = alerts[0]
    assert alert.tenant == "b" and alert.cause == "slo_breach"
    assert "by tenant 'b'" in alert.message
    assert engine.evaluate(window(10.0, 500.0), t=3.0) == []  # latched
    assert engine.evaluate(window(400.0, 0.0), t=4.0) == []
    quiet_alerts = engine.evaluate(window(400.0, 0.0), t=5.0)
    assert [a.tenant for a in quiet_alerts] == ["a"]


def test_slo_per_tenant_alert_counter_carries_tenant_label():
    from petastorm_tpu_torch.obs.slo import SloEngine, SloSpec

    reg = MetricsRegistry()
    spec = SloSpec(name="burn", metric="m", stat="value", op="<=", threshold=1.0,
                   breach_windows=1, per_tenant=True)
    engine = SloEngine(specs=[spec], registry=reg)
    engine.evaluate({'m{tenant="b"}': {"value": 9.0}}, t=1.0)
    assert reg.snapshot()['ptpu_slo_alerts_total{slo="burn",tenant="b"}'] == 1


def test_slo_per_tenant_attribution_scoped_to_tenant():
    from petastorm_tpu_torch.obs.slo import SloEngine, SloSpec

    calls = []

    class _Report:
        slow_top = "io.remote"

        def to_dict(self):
            return {"slow_top": "io.remote"}

    def attribution(tenant=None):
        calls.append(tenant)
        return _Report()

    spec = SloSpec(name="burn", metric="m", stat="value", op="<=", threshold=1.0,
                   breach_windows=1, per_tenant=True)
    engine = SloEngine(specs=[spec], attribution=attribution)
    alerts = engine.evaluate({'m{tenant="b"}': {"value": 9.0}}, t=1.0)
    assert calls == ["b"]
    assert alerts[0].culprit == "io.remote" and alerts[0].tenant == "b"


# -- end to end: the delivery charges and the provenance annotation ---------------------


def _delta(before, name):
    return default_registry().snapshot().get(name, 0) - before.get(name, 0)


def test_reader_delivery_charges_rows_to_the_tenant(scalar_dataset):
    from petastorm_tpu_torch.reader import make_batch_reader

    name = 'ptpu_tenant_rows_total{tenant="t-e2e"}'
    worker_name = 'ptpu_tenant_worker_seconds_total{tenant="t-e2e"}'
    before = default_registry().snapshot()
    rows = 0
    with make_batch_reader(scalar_dataset.url, num_epochs=1, workers_count=1,
                           tenant="t-e2e") as reader:
        assert reader.tenant_context.tenant == "t-e2e"
        for batch in reader:
            rows += len(batch.id)
    assert rows == 30
    assert _delta(before, name) == rows
    assert _delta(before, worker_name) > 0


def test_untagged_reader_charges_nothing(scalar_dataset):
    from petastorm_tpu_torch.reader import make_batch_reader

    def tenant_series():
        return {n: v for n, v in default_registry().snapshot().items()
                if n.startswith("ptpu_tenant_")}

    before = tenant_series()
    with make_batch_reader(scalar_dataset.url, num_epochs=1, workers_count=1) as reader:
        rows = sum(len(b.id) for b in reader)
        assert reader.tenant_context is None
    assert rows == 30
    assert tenant_series() == before


def test_tagged_worker_stamps_provenance_annotation(scalar_dataset):
    """The per-tenant attribution fold filters on the annotation the tagged worker
    stamps."""
    from petastorm_tpu_torch.reader import make_batch_reader

    with make_batch_reader(scalar_dataset.url, num_epochs=1, workers_count=1,
                           provenance=True, tenant="t-prov") as reader:
        rows = sum(len(b.id) for b in reader)
        recorder = reader._prov
        assert rows == 30
        items = recorder.items()
        assert items, "provenance recorded no items"
        assert all(rec["annotations"].get("tenant") == "t-prov"
                   for rec in items.values())
        assert recorder.report(tenant="nobody").batches == 0


# -- against the JAX package, and the port's own sites ------------------------------------


@pytest.fixture
def store(tmp_path):
    root = str(tmp_path / "data")
    os.makedirs(root)
    for i in range(3):
        pq.write_table(
            pa.table({"id": np.arange(48, dtype=np.int64) + i * 48,
                      "x": np.random.default_rng(i).random(48)}),
            os.path.join(root, "p%d.parquet" % i), row_group_size=16)
    return "file://" + root


def test_tagged_reads_charge_the_reference_rows(store):
    """The same store read with tenant="a" by both packages (dummy pool): the same rows
    charged, the same delivered ids; the port's read_bytes equal the bytes its funnel
    served."""
    from petastorm_tpu.obs.metrics import default_registry as ref_registry
    from petastorm_tpu.reader import make_batch_reader as ref_make_batch_reader
    from petastorm_tpu_torch.reader import make_batch_reader

    name = 'ptpu_tenant_rows_total{tenant="a"}'
    ref_before = ref_registry().snapshot().get(name, 0)
    with ref_make_batch_reader(store, reader_pool_type="dummy", tenant="a") as reader:
        ref_ids = sorted(int(i) for b in reader for i in b.id)
    ref_rows = ref_registry().snapshot()[name] - ref_before

    before = default_registry().snapshot()
    with make_batch_reader(store, reader_pool_type="dummy", tenant="a") as reader:
        ids = sorted(int(i) for b in reader for i in b.id)
        served = sum(v for k, v in reader.io_stats().items()
                     if k.startswith("tier_") and k.endswith("_bytes"))
    assert ids == ref_ids == list(range(144))
    assert _delta(before, name) == ref_rows == 144
    assert _delta(before, 'ptpu_tenant_read_bytes_total{tenant="a"}') == served > 0


@pytest.mark.parametrize("pool", ["thread", "process"])
def test_pool_charges_rows_and_worker_seconds_in_the_parent(store, pool):
    """Both pools charge every delivered row and worker seconds to the reader's tenant
    in this process's registry (a process pool's children charge in their own, so the
    pool charges each result's work seconds here); a child adopts the tenant."""
    from petastorm_tpu_torch.reader import make_batch_reader

    before = default_registry().snapshot()
    with make_batch_reader(store, reader_pool_type=pool, workers_count=2,
                           tenant=TenantContext("pool-t", job="j1")) as reader:
        rows = sum(len(b.id) for b in reader)
        if pool == "process":
            env = reader._executor._child_env
            assert env["PTPU_TENANT"] == "pool-t" and env["PTPU_TENANT_JOB"] == "j1"
    assert rows == 144
    assert _delta(before, 'ptpu_tenant_rows_total{tenant="pool-t"}') == 144
    assert _delta(before, 'ptpu_tenant_worker_seconds_total{tenant="pool-t"}') > 0


def test_loader_charges_decode_seconds_and_resolves_its_tenant(store):
    """The loader's tenant: explicit, else the reader's, else the current one; its
    timed decode is charged to it."""
    from petastorm_tpu_torch.loader import DataLoader
    from petastorm_tpu_torch.reader import make_batch_reader

    before = default_registry().snapshot()
    reader = make_batch_reader(store, reader_pool_type="dummy", tenant="r-t")
    with DataLoader(reader, 16, device="cpu") as loader:
        assert loader.tenant_context.tenant == "r-t"
        assert sum(len(b["id"]) for b in loader) == 144
    assert _delta(before, 'ptpu_tenant_decode_seconds_total{tenant="r-t"}') > 0
    reader = make_batch_reader(store, reader_pool_type="dummy", tenant="r-t")
    with DataLoader(reader, 16, device="cpu", tenant="l-t") as loader:
        assert loader.tenant_context.tenant == "l-t"
    reader = make_batch_reader(store, reader_pool_type="dummy")
    with tenant_mod.activate(TenantContext("ambient")):
        with DataLoader(reader, 16, device="cpu") as loader:
            assert loader.tenant_context.tenant == "ambient"


def test_arena_charges_the_admitting_tenant(store):
    """An arena admission made by a tagged reader bills the tenant's residency; the
    arena's stats hold the host-wide bytes by tenant."""
    from petastorm_tpu_torch.io import arena as arena_mod
    from petastorm_tpu_torch.io.memcache import shared_store
    from petastorm_tpu_torch.reader import make_batch_reader

    try:
        with make_batch_reader(store, reader_pool_type="dummy", tenant="arena-t",
                               io_options={"arena_bytes": 8 << 20}) as reader:
            assert sum(len(b.id) for b in reader) == 144
            stats = reader.io_stats()
        report = TenantUsageReport.from_registry()
    finally:
        arena_mod.close_process_arena()
        shared_store().clear()
    # the row groups the worker admitted are the tenant's; the footers the factory
    # published while planning, before the reader existed, are untagged
    assert 0 < stats["arena_tenant_bytes"]["arena-t"] < stats["arena_payload_bytes"]
    assert report.get("arena-t", "arena_bytes") > 0
    assert report.get("arena-t", "arena_byte_s") > 0
