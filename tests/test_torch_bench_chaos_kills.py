"""The chaos harness of the port against the JAX package's on the process pool: the
children killed mid-item (``kills``) and the process-pool comparisons.

``--smoke --scenario kills`` runs green through the port's ``cli.main`` on ``--device
cpu``: every child dies at its second item and one poison item kills every child it
meets; the run delivers every row but the poison row group's, which is quarantined, the
verdict the JAX harness reaches on the same plan. The transient-IO and poison scenarios
run through both packages' ``_run_scenario`` on the process pool over the ``'arrow'``
wire: a JAX ring of shm slabs here would be blamed by the conftest's host-wide slab check
on tests in other xdist workers (the harness's own ``shm-view`` runs are the port's, in
the smokes).
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


def test_chaos_smoke_kills(capsys):
    rc, out = run_main(cli.main, ["chaos", "--smoke", "--scenario", "kills"] + CPU, capsys)
    summary = last_json(out)["chaos_summary"]
    assert rc == 0 and summary["ok"], out
    (run,) = summary["scenarios"]
    assert (run["scenario"], run["pool"], run["wire"]) == ("kills", "process", "shm-view")
    # the poison ordinal's row group quarantined, every other row delivered once
    assert (run["quarantined_items"], run["quarantined_rows"]) == (1, ROWS)
    assert run["delivered"] == (FILES - 1) * ROWS and run["lease_leak_delta"] == 0


def _scenario(module, name):
    for entry in module._scenarios(FILES, True):
        if entry[0] == name:
            return entry
    raise KeyError(name)


@pytest.mark.parametrize("name", ["transient-io", "poison"])
def test_chaos_process_scenario_delivers_the_reference_rows(name):
    results = []
    with tempfile.TemporaryDirectory() as root:
        chaos._write_dataset(root, FILES, ROWS)
        expected = list(range(FILES * ROWS))
        for module in (chaos, ref_chaos):
            _name, _pools, plan_fn, recovery, _heal = _scenario(module, name)
            results.append(module._run_scenario(name, root, expected, "process",
                                                plan_fn(), recovery=recovery,
                                                wire="arrow"))
    ours, theirs = results
    for key in ("delivered", "quarantined_items", "quarantined_rows", "lease_leak_delta",
                "transport"):
        assert ours[key] == theirs[key], key
