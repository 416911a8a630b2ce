"""The data-service harness of the port against the JAX package's: ``fleet``.

The ``--smoke`` of the scenarios runs green through the port's ``cli.main`` on
``--device cpu`` (the three default ones in one run, then ``linkdeath`` and
``attribution``), and the exactly-once verdicts hold as the JAX harness's: every
trainer of a shared fleet receives the plan once, a detach and reattach resumes
exactly, a link death re-dispatches without quarantine. ``provoverhead`` runs alone:
its two arms must each deliver the plan once with no lease left, but its 20 % ceiling
on the wall-clock overhead is not asserted under the suite's parallel load. Timings are
never compared across packages.
"""
import pytest

torch = pytest.importorskip("torch")

from _torch_bench_helpers import last_json, run_main  # noqa: E402
from _torch_pool_helpers import _no_leaked_shm_segments  # noqa: E402,F401
from _torch_pool_helpers import no_leaked_port_slabs  # noqa: E402,F401
from petastorm_tpu.benchmark import fleet as ref_fleet  # noqa: E402
from petastorm_tpu.obs import provenance as ref_prov  # noqa: E402
from petastorm_tpu.obs import tenant as ref_tenant  # noqa: E402
from petastorm_tpu_torch.benchmark import cli  # noqa: E402
from petastorm_tpu_torch.benchmark import fleet  # noqa: E402
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


@pytest.mark.parametrize("scenarios", [[], ["linkdeath", "attribution"]],
                         ids=["defaults", "linkdeath-attribution"])
def test_fleet_smoke(capsys, scenarios):
    argv = ["fleet", "--smoke"] + (["--scenarios"] + scenarios if scenarios else []) + CPU
    rc, out = run_main(cli.main, argv, capsys)
    summary = last_json(out)
    assert rc == 0 and not summary["failures"], out
    names = scenarios or list(fleet.DEFAULT_SCENARIOS)
    assert sorted(summary["scenarios"]) == sorted(names)
    assert all(r["ok"] for r in summary["scenarios"].values())


def test_shared_fleet_delivers_the_reference_plan_to_every_trainer():
    ours, _ws, ours_failures = fleet._run_fleet(12, 3, 2, fleet.decode_shared,
                                                fleet._rec())
    theirs, _ws, theirs_failures = ref_fleet._run_fleet(12, 3, 2, ref_fleet.decode_shared,
                                                        ref_fleet._rec())
    assert not ours_failures and not theirs_failures, (ours_failures, theirs_failures)
    assert [sorted(items) for items in ours] == [sorted(items) for items in theirs] \
        == [list(range(12))] * 3


def test_elasticity_and_linkdeath_conclude_as_the_reference():
    for scenario in ("scenario_elasticity", "scenario_linkdeath"):
        ours, ours_failures = getattr(fleet, scenario)(smoke=True, device="cpu")
        theirs, theirs_failures = getattr(ref_fleet, scenario)(smoke=True)
        assert not ours_failures and not theirs_failures, (scenario, ours_failures,
                                                           theirs_failures)
        assert ours["ok"] and theirs["ok"] and ours["items"] == theirs["items"]
    assert ours["chaos"]["injected_total"] == theirs["chaos"]["injected_total"] == 1


def test_provoverhead_arms_deliver_the_plan_once():
    result, failures = fleet.scenario_provoverhead(smoke=True, device="cpu")
    exactness = [f for f in failures if "overhead" not in f]
    assert not exactness, failures
    assert result["wall_off_s"] > 0 and result["wall_on_s"] > 0
