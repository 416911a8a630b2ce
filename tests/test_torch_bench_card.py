"""The throughput tool's synthetic step on the card.

``--overlap-step-ms``'s step is a chain of (1024, 1024) bf16 matmuls captured once as a
CUDA graph: a call is one replay, its length calibrated from a captured probe's
CUDA-event time, and the batch's first element enters through a device copy into the
graph's static input. ``benchmark.throughput.block_until_ready`` waits for it on the
result's device.

These cases need a CUDA device (``gpu`` marker; they skip without one) and import
nothing of the JAX package. Run them on the card with
``python -m pytest -m gpu tests/test_torch_bench_card.py``.
"""
import pytest

torch = pytest.importorskip("torch")

from _torch_pool_helpers import _no_leaked_shm_segments  # noqa: E402,F401
from _torch_pool_helpers import no_leaked_port_slabs  # noqa: E402,F401


@pytest.mark.gpu
def test_synthetic_step_on_the_card_is_one_graph_replay():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from petastorm_tpu_torch.benchmark import cli
    from petastorm_tpu_torch.benchmark import throughput as tp

    dev = torch.device("cuda")
    step = cli._make_synthetic_step(2.0, dev)
    assert step.matmuls >= 1 and step.device_ms > 0
    a = tp.block_until_ready(step({"x": torch.zeros(4, dtype=torch.uint8,
                                                    device=dev)})).clone()
    b = tp.block_until_ready(step({"x": torch.full((4,), 100000, dtype=torch.int64,
                                                   device=dev)})).clone()
    assert a.device.type == "cuda" and a.shape == (1024, 1024)
    assert torch.isfinite(a.float()).all() and not torch.equal(a, b)
    # the calibration lands near its target: a 2 ms call is not a 0.5 or 8 ms call
    assert 1.0 <= step.device_ms <= 4.0, step.device_ms


def _paced(device, gap_s):
    """A loader of one-tensor batches on ``device``, one every ``gap_s`` seconds."""
    import time

    x = torch.zeros(4, dtype=torch.uint8, device=device)

    class Paced:
        def __iter__(self):
            while True:
                time.sleep(gap_s)
                yield {"x": x}

    return Paced()


@pytest.mark.gpu
@pytest.mark.parametrize("gap_ms, step_ms, low, high", [(20.0, 2.0, 0.7, 1.0),
                                                         (0.0, 5.0, 0.0, 0.2)],
                         ids=["starved", "fed"])
def test_overlap_idle_on_the_card_is_the_device_idle(gap_ms, step_ms, low, high):
    """On the card the idle is read from CUDA events around the steps: a 2 ms step fed
    every 20 ms leaves the card idle about 90 % of the window; a 5 ms step fed at once
    keeps it busy, though the consumer runs ahead and waits on nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from petastorm_tpu_torch.benchmark import cli
    from petastorm_tpu_torch.benchmark import throughput as tp

    dev = torch.device("cuda")
    step = cli._make_synthetic_step(step_ms, dev)
    res = tp.overlap_throughput(_paced(dev, gap_ms / 1e3), step, warmup_batches=2,
                                measure_batches=20, step_repeats=1)
    assert res.batches == 20 and res.step_repeats == 1
    assert low <= res.device_idle_fraction <= high, res
