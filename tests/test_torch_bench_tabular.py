"""The tabular-preprocessing harness of the port against the JAX package's:
``tabular``.

``--smoke`` runs green through the port's ``cli.main`` on ``--device cpu``: the
declarative pipeline delivers value-identical batches to the pandas twin on the dummy,
thread and process pools, charging nothing to the writable-copy sites. What the
scenarios count and the batch records equal the JAX harness's (run on the dummy and
thread pools: a JAX ring of shm slabs here would be blamed by the conftest's host-wide
slab check on tests in other xdist workers). Timings are never compared across
packages.
"""
import pytest

torch = pytest.importorskip("torch")

from _torch_bench_helpers import best_of_three, last_json  # noqa: E402
from _torch_bench_helpers import run_main, wall_clock  # noqa: E402
from _torch_pool_helpers import _no_leaked_shm_segments  # noqa: E402,F401
from _torch_pool_helpers import no_leaked_port_slabs  # noqa: E402,F401
from petastorm_tpu.benchmark import tabular as ref_tabular  # noqa: E402
from petastorm_tpu_torch.benchmark import cli  # noqa: E402
from petastorm_tpu_torch.benchmark import tabular  # noqa: E402

CPU = ["--device", "cpu"]


def test_tabular_smoke_is_value_identical_to_the_pandas_twin(capsys):
    """The smoke's bars on the pipeline's and the string hash's speed read the wall
    clock: the best of three attempts (``best_of_three``) on those bars alone; the
    value identity and the leases are asserted on every attempt."""
    def smoke():
        rc, out = wall_clock(lambda: run_main(cli.main, ["tabular", "--smoke"] + CPU,
                                              capsys),
                             ("is not >= 2x the pandas twin", "regressed below the scalar"))
        assert rc == 0 and "identity: declarative scenarios delivered value-identical" \
            in out, out
        summary = last_json(out)
        assert summary["leases_leaked"] == 0, summary
        return summary

    summary = best_of_three(smoke)
    assert summary["speedup"] >= 2.0
    assert all(not census for census in summary["census"].values()), summary["census"]


def test_tabular_records_equal_the_reference():
    kwargs = dict(rows=1024, rows_per_group=128, batch_size=128, files=2, workers=2,
                  scenarios=("pandas-dummy", "declarative-dummy", "declarative-thread"),
                  check=True)
    ours = tabular.run_tabular_bench(**kwargs, device="cpu")
    theirs = ref_tabular.run_tabular_bench(**kwargs)
    for a, b in zip(ours, theirs):
        for key in ("scenario", "batches", "rows", "census", "leases_leaked",
                    "identical_to_pandas"):
            assert a.get(key) == b.get(key), (a["scenario"], key)
    # the records themselves: the port's pandas twin against the JAX package's pipeline
    import os
    import tempfile

    from petastorm_tpu_torch.benchmark.tabular import _measure

    with tempfile.TemporaryDirectory() as root:
        tabular.make_dataset(root, 512, 128, files=2)
        _row, ours_records = _measure("declarative-dummy", root, 128, 2, True,
                                      device="cpu")
        _row, theirs_records = ref_tabular._measure("declarative-dummy", root, 128, 2, True)
        assert os.listdir(root)
    assert sorted(ours_records) == sorted(theirs_records)
