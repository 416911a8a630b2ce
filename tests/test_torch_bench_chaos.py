"""The chaos harness of the port against the JAX package's: the fault scenarios on the
thread and process pools.

Each scenario's ``--smoke`` runs green through the port's ``cli.main`` on ``--device
cpu`` (``--scenario`` picks it; the harness asserts, inside every run, that delivered
and quarantined rows make up the plan exactly once with no lease or slab left). Beside
them each deterministic scenario runs through both packages' ``_run_scenario`` on the
same store: the same rows delivered and the same row groups quarantined. The process
pool's kills and the process-pool comparisons are in ``tests/test_torch_bench_chaos_kills.py``,
the stall healer and the dataset mutations in ``tests/test_torch_bench_chaos_watch.py``,
the network faults in ``tests/test_torch_bench_chaos_net.py``.
"""
import tempfile

import pytest

torch = pytest.importorskip("torch")

from _torch_bench_helpers import last_json, run_main  # noqa: E402
from _torch_pool_helpers import _no_leaked_shm_segments  # noqa: E402,F401
from _torch_pool_helpers import no_leaked_port_slabs  # noqa: E402,F401
from petastorm_tpu.benchmark import chaos as ref_chaos  # noqa: E402
from petastorm_tpu_torch.benchmark import chaos  # noqa: E402
from petastorm_tpu_torch.benchmark import cli  # noqa: E402

CPU = ["--device", "cpu"]
FILES, ROWS = 8, 64  # the harness's --smoke store


@pytest.mark.parametrize("scenario", ["transient-io", "poison", "corrupt"])
def test_chaos_smoke(capsys, scenario):
    rc, out = run_main(cli.main, ["chaos", "--smoke", "--scenario", scenario] + CPU, capsys)
    summary = last_json(out)["chaos_summary"]
    assert rc == 0 and summary["ok"], out
    runs = summary["scenarios"]
    assert runs and all(r["scenario"] == scenario for r in runs)
    assert all(r["lease_leak_delta"] == 0 for r in runs)
    assert all(r["delivered"] + r["quarantined_rows"] == FILES * ROWS for r in runs)


def _scenario(module, name):
    for entry in module._scenarios(FILES, True):
        if entry[0] == name:
            return entry
    raise KeyError(name)


@pytest.mark.parametrize("name,pool", [("transient-io", "thread"), ("poison", "thread")])
def test_chaos_scenario_delivers_the_reference_rows(name, pool):
    results = []
    with tempfile.TemporaryDirectory() as root:
        chaos._write_dataset(root, FILES, ROWS)
        expected = list(range(FILES * ROWS))
        for module in (chaos, ref_chaos):
            _name, _pools, plan_fn, recovery, _heal = _scenario(module, name)
            results.append(module._run_scenario(name, root, expected, pool, plan_fn(),
                                                recovery=recovery))
    ours, theirs = results
    for key in ("delivered", "quarantined_items", "quarantined_rows", "lease_leak_delta",
                "transport"):
        assert ours[key] == theirs[key], key
