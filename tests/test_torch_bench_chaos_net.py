"""The chaos harness of the port against the JAX package's: the network faults on the
tcp transport.

``--smoke --scenario network`` runs green through the port's ``cli.main`` on ``--device
cpu``: the pipe and tcp pools deliver byte-identical payloads, and seeded resets,
partitions, slow sends and corrupt frames on the loopback tcp pool, with no respawn
budget, are absorbed by reconnect and re-dispatch alone. Beside it both packages run the
scenario on the same store: the same rows delivered, no item quarantined for a link
fault.
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


def test_chaos_smoke_network(capsys):
    rc, out = run_main(cli.main, ["chaos", "--smoke", "--scenario", "network"] + CPU,
                       capsys)
    summary = last_json(out)["chaos_summary"]
    assert rc == 0 and summary["ok"], out
    assert "pipe vs tcp byte-identical" in out
    (run,) = summary["scenarios"]
    assert run["reconnects"] >= 1 and run["quarantined_items"] == 0
    assert run["delivered"] == FILES * ROWS and run["lease_leak_delta"] == 0


def test_network_scenario_delivers_the_reference_rows():
    results = []
    with tempfile.TemporaryDirectory() as root:
        chaos._write_dataset(root, FILES, ROWS)
        expected = list(range(FILES * ROWS))
        for module in (chaos, ref_chaos):
            assert module._run_transport_identity(root, len(expected)) == len(expected)
            results.append(module._run_network(root, expected))
    ours, theirs = results
    for key in ("delivered", "quarantined_items", "quarantined_rows", "lease_leak_delta"):
        assert ours[key] == theirs[key], key
    assert ours["delivered"] == FILES * ROWS and ours["reconnects"] >= 1
