"""The tenant plane and the controller on the card, on the JPEG main path: a tagged
loader charges its tenant and delivers the images of an untagged one; an armed
controller retunes the reader live with the same kernel launches and images as an
unarmed run.

These cases need a CUDA device (``gpu`` marker; they skip without one) and import
nothing of the JAX package: they compare the port with itself, armed against unarmed.
Run them on the card with ``python -m pytest -m gpu tests/test_torch_control_card.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_pool_helpers import _no_leaked_shm_segments  # noqa: E402,F401
from _torch_pool_helpers import no_leaked_port_slabs  # noqa: E402,F401


def _jpeg_store(tmp_path):
    """32 rows of 32x48 q85 JPEG, 8 a file, content from a numpy seed."""
    import cv2

    from petastorm_tpu_torch import types as ptypes
    from petastorm_tpu_torch.codecs import CompressedImageCodec, ScalarCodec
    from petastorm_tpu_torch.metadata import write_dataset
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField

    schema = Unischema("S", [
        UnischemaField("id", np.int64, (), ScalarCodec(ptypes.LongType()), False),
        UnischemaField("image", np.uint8, (32, 48, 3), CompressedImageCodec("jpeg", 85),
                       False)])
    rng = np.random.RandomState(3)
    url = "file://" + str(tmp_path / "s")
    write_dataset(url, schema, ({"id": i, "image": cv2.GaussianBlur(
        rng.randint(0, 256, (32, 48, 3)).astype(np.uint8), (5, 5), 2.0)}
        for i in range(32)), row_group_size_mb=0, rows_per_file=8)
    return url


def _drain(loader, registry=None, on_batch=None):
    """{id: uint8 image} of every delivered row."""
    images = {}
    for n, b in enumerate(loader):
        if registry is not None:
            registry.sample_timelines()
        if on_batch is not None:
            on_batch(n, loader)
        for i, img in zip(b["id"].cpu().numpy(), b["image"].cpu().numpy()):
            images[int(i)] = img
    return images


def _same_images(a, b):
    assert sorted(a) == sorted(b) == list(range(32))
    for i in a:
        np.testing.assert_array_equal(a[i], b[i])


@pytest.mark.gpu
def test_tagged_main_path_on_the_card_charges_the_tenant(tmp_path):
    """A tagged main path on the card: rows, worker and decode seconds charged to the
    tenant, the images those of an untagged run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from petastorm_tpu_torch.loader import DataLoader
    from petastorm_tpu_torch.obs.metrics import default_registry
    from petastorm_tpu_torch.reader import make_batch_reader

    url = _jpeg_store(tmp_path)

    def run(tenant):
        reader = make_batch_reader(url, workers_count=2, decode_on_device=True,
                                   tenant=tenant)
        with DataLoader(reader, 8, device="cuda") as loader:
            return _drain(loader)

    before = default_registry().snapshot()
    tagged = run("card-t")
    plain = run(None)
    _same_images(plain, tagged)
    after = default_registry().snapshot()

    def delta(name):
        key = 'ptpu_tenant_%s{tenant="card-t"}' % name
        return after.get(key, 0) - before.get(key, 0)

    assert delta("rows_total") == 32
    assert delta("worker_seconds_total") > 0 and delta("decode_seconds_total") > 0


@pytest.mark.gpu
def test_controller_on_the_card_retunes_a_main_path_loader(tmp_path):
    """A main-path loader on the card with the controller armed: a knob retuned live,
    the launches and images those of an unarmed run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from petastorm_tpu_torch.loader import DataLoader
    from petastorm_tpu_torch.obs.metrics import MetricsRegistry
    from petastorm_tpu_torch.ops import jpeg
    from petastorm_tpu_torch.reader import make_batch_reader

    url = _jpeg_store(tmp_path)

    def retune(n, loader):
        if n == 1:
            assert loader.controller.knobs.apply("readahead_depth", 5)[1] == 5

    def run(controller):
        registry = MetricsRegistry()
        reader = make_batch_reader(url, workers_count=2, decode_on_device=True)
        before = jpeg.stage2_planes_segments.launches
        with DataLoader(reader, 8, device="cuda", metrics=registry,
                        controller=controller) as loader:
            images = _drain(loader, registry, retune if controller else None)
            depth = reader.io_stats().get("readahead_depth_limit")
        return images, jpeg.stage2_planes_segments.launches - before, depth

    plain, plain_launches, _ = run(None)
    armed, armed_launches, depth = run(True)
    assert armed_launches == plain_launches >= 4
    assert depth == 5
    _same_images(plain, armed)
