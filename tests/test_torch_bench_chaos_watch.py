"""The chaos harness of the port against the JAX package's: the stall healer and the
dataset mutations.

Each scenario's ``--smoke`` runs green through the port's ``cli.main`` on ``--device
cpu`` (``--scenario`` picks it). Beside them the mutations on the dummy pool run through
both packages on the same store: the same rows delivered, the same items quarantined.
"""
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


@pytest.mark.parametrize("scenario", ["stall-heal", "mutating-dataset"])
def test_chaos_smoke(capsys, scenario):
    rc, out = run_main(cli.main, ["chaos", "--smoke", "--scenario", scenario] + CPU, capsys)
    summary = last_json(out)["chaos_summary"]
    assert rc == 0 and summary["ok"], out
    runs = summary["scenarios"]
    assert runs and all(r["lease_leak_delta"] == 0 for r in runs)
    if scenario == "stall-heal":
        assert all(r["heals"] >= 1 and r["delivered"] == FILES * ROWS for r in runs)
    else:
        pools = [r["pool"] for r in runs if r["scenario"] == "mutating-dataset"]
        assert pools == ["dummy", "thread", "process"]
        assert runs[-1]["scenario"] == "infinite-watch"


def test_mutating_dataset_on_the_dummy_pool_quarantines_as_the_reference():
    ours = chaos._run_mutating_dataset("dummy", 16, ROWS)
    theirs = ref_chaos._run_mutating_dataset("dummy", 16, ROWS)
    for key in ("delivered", "quarantined_items", "quarantined_rows", "injected",
                "lease_leak_delta"):
        assert ours[key] == theirs[key], key
