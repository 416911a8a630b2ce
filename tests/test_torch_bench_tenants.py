"""The tenant harness of the port against the JAX package's: ``tenants``.

Its ``--smoke`` runs green through the port's ``cli.main`` on ``--device cpu`` with
``--skip-overhead``: the tagged/untagged throughput arms assert a 20 % ceiling on
wall-clock rates, which a shared CPU under the suite's parallel load does not hold
still; they run here over one epoch each for what they must keep, equal row sets. The
usage report and a per-tenant burn alert name the noisy tenant and its culprit site,
frames round-trip (``tests/test_torch_bench_stores.py`` holds them byte for byte), and
the tcp leg's rows equal the JAX harness's. Timings are never compared across packages.
"""
import pytest

torch = pytest.importorskip("torch")

from _torch_bench_helpers import last_json, run_main  # noqa: E402
from _torch_pool_helpers import _no_leaked_shm_segments  # noqa: E402,F401
from _torch_pool_helpers import no_leaked_port_slabs  # noqa: E402,F401
from petastorm_tpu.benchmark import tenants as ref_tenants  # noqa: E402
from petastorm_tpu.obs import provenance as ref_prov  # noqa: E402
from petastorm_tpu.obs import tenant as ref_tenant  # noqa: E402
from petastorm_tpu_torch.benchmark import cli  # noqa: E402
from petastorm_tpu_torch.benchmark import tenants  # noqa: E402
from petastorm_tpu_torch.obs import provenance as prov  # noqa: E402
from petastorm_tpu_torch.obs import tenant  # noqa: E402

CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True)
def _clean_planes():
    for mod in (prov, ref_prov):
        mod.ACTIVE = None
    yield
    for mod in (prov, ref_prov):
        mod.ACTIVE = None
    tenant._reset_for_tests()
    ref_tenant._reset_for_tests()


def test_tenants_smoke_names_the_noisy_neighbor(capsys):
    rc, out = run_main(cli.main, ["tenants", "--smoke", "--skip-overhead"] + CPU, capsys)
    summary = last_json(out)
    assert rc == 0 and not summary["failures"], out
    contention = summary["contention"]
    assert contention["top_worker_s"] == tenants.NOISY
    assert [(a["tenant"], a["culprit"]) for a in contention["alerts"]][:1] == \
        [(tenants.NOISY, "io.remote")]
    assert contention["held_leases"] == 0
    assert summary["wire"]["ok"] and summary["wire"]["wire_bytes"] > 0


def test_tenants_tcp_leg_delivers_the_reference_rows(tmp_path):
    (tmp_path / "port").mkdir()
    (tmp_path / "ref").mkdir()
    ours, ours_failures = tenants.scenario_wire(str(tmp_path / "port"))
    theirs, theirs_failures = ref_tenants.scenario_wire(str(tmp_path / "ref"))
    assert not ours_failures and not theirs_failures
    assert ours["rows"] == theirs["rows"] == 128


def test_tenants_overhead_arms_deliver_the_same_rows(tmp_path):
    off_best, on_best, overhead = tenants.measure_overhead(str(tmp_path), epochs=1,
                                                           device="cpu")
    assert off_best > 0 and on_best > 0 and 0.0 <= overhead <= 1.0
