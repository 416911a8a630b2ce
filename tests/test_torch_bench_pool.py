"""The pool harnesses of the port against the JAX package's: ``wire`` and ``copies``.

Each harness's ``--smoke`` runs green through the port's ``cli.main`` on ``--device
cpu``, and what it counts equals the JAX harness's: every wire delivers every payload
byte-exact with the same structural copies; the copy census charges the same bytes to
the same sites (the leased paths copy nothing). Timings are never compared across
packages.

The JAX harnesses run here only on pools without shared-memory slabs (the socket wires,
the dummy and thread pools): the conftest's slab check globs every JAX-package slab on
the host and would blame a JAX ring of this file on a test in another xdist worker. The
port's own shm scenarios run in its smokes (its slabs carry their own prefix).
"""
import pytest

torch = pytest.importorskip("torch")

from _torch_bench_helpers import last_json, run_main  # noqa: E402
from _torch_pool_helpers import _no_leaked_shm_segments  # noqa: E402,F401
from _torch_pool_helpers import no_leaked_port_slabs  # noqa: E402,F401
from petastorm_tpu.benchmark import copies as ref_copies  # noqa: E402
from petastorm_tpu.benchmark import wire as ref_wire  # noqa: E402
from petastorm_tpu_torch.benchmark import cli  # noqa: E402
from petastorm_tpu_torch.benchmark import copies  # noqa: E402
from petastorm_tpu_torch.benchmark import wire  # noqa: E402

CPU = ["--device", "cpu"]


def test_wire_smoke_measures_every_wire_over_both_links(capsys):
    rc, out = run_main(cli.main, ["wire", "--smoke", "--json"] + CPU, capsys)
    assert rc == 0
    import json

    rows = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    pipe = [r["wire"] for r in rows if r["transport"] == "pipe"]
    tcp = [r["wire"] for r in rows if r["transport"] == "tcp"]
    assert pipe == ["pickle", "arrow", "shm", "shm-arrow", "shm-view", "shm-arrow-view"]
    assert tcp == list(wire.TCP_WIRES)
    assert all(r["checked"] and r["items"] == 6 for r in rows)
    assert not any(r["shm_unavailable"] for r in rows)


def test_wire_rows_equal_the_reference():
    """Each link's rows count what the JAX harness's (pipe-only) rows count."""
    kwargs = dict(items=4, warmup=1, wires=("pickle", "arrow"), workers=1, check=True)
    ours = wire.run_wire_bench([32 << 10], **kwargs)
    theirs = ref_wire.run_wire_bench([32 << 10], **kwargs)
    assert [r["transport"] for r in ours] == ["pipe", "pipe", "tcp", "tcp"]
    for link in wire.TRANSPORTS:
        rows = [r for r in ours if r["transport"] == link]
        assert len(rows) == len(theirs) == 2
        for a, b in zip(rows, theirs):
            for key in ("wire", "payload_mb", "items", "payload_copies", "checked",
                        "shm_unavailable"):
                assert a[key] == b[key], (link, key)


def test_copies_smoke_leased_paths_copy_nothing(capsys):
    rc, out = run_main(cli.main, ["copies", "--smoke"] + CPU, capsys)
    summary = last_json(out)
    assert rc == 0 and "identity: leased scenarios delivered byte-identical" in out
    for group in ("wire", "memcache"):
        assert summary[group]["leased_strictly_below_default"], summary
        assert summary[group]["leased_copied_bytes_per_batch"] == 0.0, summary


def test_copies_census_equals_the_reference():
    kwargs = dict(rows=256, rows_per_group=32, batch_size=16, files=2, workers=2,
                  memcache_mb=64, check=True,
                  scenarios=("memcache-default", "memcache-leased"))
    ours = copies.run_copies_bench(**kwargs, device="cpu")
    theirs = ref_copies.run_copies_bench(**kwargs)
    assert [r["scenario"] for r in ours] == [r["scenario"] for r in theirs]
    for a, b in zip(ours, theirs):
        for key in ("batches", "rows", "copied_bytes", "copied_bytes_per_batch", "census",
                    "leases_leaked", "identical_to_default"):
            assert a.get(key) == b.get(key), (a["scenario"], key)
