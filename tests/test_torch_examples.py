"""The torch examples (``examples/torch/``) against the JAX package's examples, on the CPU.

- The ImageNet example's train step (``make_train_step``: ``image / 255``, mean cross
  entropy, ``torch.optim.SGD`` with Nesterov momentum) against the JAX example's step,
  built as ``examples/imagenet/train_imagenet_jax.py`` builds it (optax
  ``sgd(nesterov=True)``, ``softmax_cross_entropy_with_integer_labels``), both from the
  flax variables of one init carried across by ``models/weights.py``: ResNet-50 in
  float32 at 32x32, 10 classes, batches of 8 made from a numpy seed, the example's
  learning rate 0.1. Losses within rtol 1e-4; parameters within atol/rtol 1e-4 and batch
  statistics within atol 1e-5 (the model bars of ``tests/test_torch_models.py``): after
  the first step against the JAX step as it is, and after both steps against the same
  step with flax's two-pass batch variance (``use_fast_variance=False``, patched into
  ``flax.linen`` for the case), which the port's float32 batch norm computes alike. The
  JAX step as it is after both steps is held in float64, port and reference alike,
  every leaf within the same bars: in float32 the two-pass forms leave the second step's
  stage-3 ``BatchNorm_2`` biases up to 4.4e-4 from the float64 step, the reference's
  E[x^2] - E[x]^2 form 3.4e-7 (ROADMAP.md Queue 3 U).
- The example end to end on a store written here (two steps, ``--augment``,
  ``--trace``; ViT-S/16 with ``--host-decode``), and as two gloo ranks in the
  environment ``torchrun`` sets (``tests/_torch_rank_jobs.py``): each rank reads its
  shard, ``DistributedDataParallel`` keeps the replicas equal, and after each step the
  parameters and batch statistics equal the one-process step's on the global batch
  (float32; the model bars).
- Every other script's ``main`` at a small size; where the rows are deterministic the
  result equals what the JAX counterpart prints on the same store.
"""
import ast
import functools
import importlib.util
import json
import math
import multiprocessing
import os
import re
import socket
import sys
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_pool_helpers import _no_leaked_shm_segments  # noqa: E402,F401
from _torch_pool_helpers import no_leaked_port_slabs  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_EXAMPLES = os.path.join(ROOT, "examples", "torch")
JAX_EXAMPLES = os.path.join(ROOT, "examples")
IMAGENET = os.path.join(PORT_EXAMPLES, "imagenet", "train_imagenet_torch.py")
SCRIPTS = sorted(os.path.relpath(os.path.join(d, f), PORT_EXAMPLES)
                 for d, _, fs in os.walk(PORT_EXAMPLES) for f in fs if f.endswith(".py"))


def _load(root, rel):
    """Import an example script by path under a module name of its own (its directory
    on ``sys.path`` for sibling imports, as when run as a script)."""
    path = os.path.join(root, rel)
    if os.path.dirname(path) not in sys.path:
        sys.path.insert(0, os.path.dirname(path))
    name = "example_%s_%s" % ("torch" if root == PORT_EXAMPLES else "jax",
                              rel.replace("/", "_")[:-3])
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run_jax_example(rel, argv, monkeypatch, capsys):
    """The JAX example's ``main()`` (it parses ``sys.argv``); returns what it printed."""
    module = _load(JAX_EXAMPLES, rel)
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", [rel] + list(argv))
    module.main()
    return capsys.readouterr().out


@pytest.fixture
def scratch_tmp(tmp_path, monkeypatch):
    """``tempfile``'s directory under the test's: the scripts' default stores land there."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    return tmp_path


def test_every_jax_example_has_its_torch_counterpart():
    jax_scripts = sorted(os.path.relpath(os.path.join(d, f), JAX_EXAMPLES)
                         for d, _, fs in os.walk(JAX_EXAMPLES)
                         if os.path.relpath(d, JAX_EXAMPLES).split(os.sep)[0] != "torch"
                         for f in fs if f.endswith(".py"))
    want = sorted(s.replace("_jax.py", "_torch.py") for s in jax_scripts)
    assert SCRIPTS == want and len(SCRIPTS) == 11
    assert os.path.exists(os.path.join(PORT_EXAMPLES, "README.md"))
    for rel in SCRIPTS:
        import inspect

        main = _load(PORT_EXAMPLES, rel).main
        assert list(inspect.signature(main).parameters) == ["argv"], rel


# -- the ImageNet step against the JAX example's ----------------------------------------


_FLAX = {}


def _flax_resnet50():
    """The flax ResNet-50 (float32, 10 classes) and its initial variables at 32x32."""
    if not _FLAX:
        pytest.importorskip("flax")
        import jax
        import jax.numpy as jnp

        from petastorm_tpu.models.resnet import ResNet50

        model = ResNet50(num_classes=10, dtype=jnp.float32)
        init = jax.jit(functools.partial(model.init, train=False))
        _FLAX["model"] = model
        _FLAX["variables"] = init(jax.random.PRNGKey(0), jnp.zeros((2, 32, 32, 3)))
    return _FLAX["model"], _FLAX["variables"]


def _jax_example_steps(images, labels, learning_rate, float64=False):
    """The JAX example's train step (train_imagenet_jax.py's ``optax.sgd`` with Nesterov
    momentum and its ``loss_fn``, the ResNet branch) over the batches; returns the loss
    and the variables after each step, as numpy. ``float64``: the same step with the
    model, its variables and ``image / 255`` in float64 (under ``jax.enable_x64``)."""
    import jax
    import jax.numpy as jnp
    import optax

    model, variables = _flax_resnet50()
    dtype = jnp.float32
    if float64:
        from petastorm_tpu.models.resnet import ResNet50

        dtype = jnp.float64
        model = ResNet50(num_classes=10, dtype=dtype)
    with jax.enable_x64(float64):
        variables = jax.tree.map(lambda a: jnp.asarray(np.asarray(a), dtype), variables)
        return _run_jax_example_steps(model, variables, images, labels, learning_rate,
                                      dtype)


def _run_jax_example_steps(model, variables, images, labels, learning_rate, dtype):
    import jax
    import jax.numpy as jnp
    import optax

    params, batch_stats = variables["params"], variables["batch_stats"]
    tx = optax.sgd(learning_rate, momentum=0.9, nesterov=True)
    opt_state = tx.init(params)

    @jax.jit
    def train_step(params, batch_stats, opt_state, image, label):
        def loss_fn(p):
            x = image.astype(dtype) / 255.0
            out, updates = model.apply({"params": p, "batch_stats": batch_stats}, x,
                                       train=True, mutable=["batch_stats"])
            loss = optax.softmax_cross_entropy_with_integer_labels(out, label).mean()
            return loss, updates["batch_stats"]

        (loss, new_stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), new_stats, opt_state, loss

    out = []
    for image, label in zip(images, labels):
        params, batch_stats, opt_state, loss = train_step(
            params, batch_stats, opt_state, jnp.asarray(image), jnp.asarray(label))
        out.append((float(loss), jax.tree.map(np.asarray, {"params": dict(params),
                                                           "batch_stats": dict(batch_stats)})))
    return out


def _assert_tree_close(ours, theirs, atol, rtol):
    for key, value in theirs.items():
        if isinstance(value, dict):
            _assert_tree_close(ours[key], value, atol, rtol)
        else:
            np.testing.assert_allclose(ours[key], value, atol=atol, rtol=rtol, err_msg=key)


def _port_example_steps(example, images, labels, learning_rate, steps, dtype):
    """The port's example step (``make_train_step``) from the flax variables of
    :func:`_flax_resnet50`, the model in ``dtype``; yields the loss and the variables
    (numpy) after each step, and the step closure last."""
    import jax

    from petastorm_tpu_torch.models.weights import flax_variables, load_flax_variables

    _model, variables = _flax_resnet50()
    model = example.build_model("resnet50", 10, (32, 32), "cpu", dtype=dtype).to(dtype)
    load_flax_variables(model, jax.tree.map(np.asarray, {k: dict(v)
                                                         for k, v in variables.items()}))
    step = example.make_train_step(model, learning_rate)
    for i in range(steps):
        loss = float(step(torch.from_numpy(images[i]), torch.from_numpy(labels[i])))
        yield loss, jax.tree.map(lambda a: np.array(a, copy=True), flax_variables(model))
    yield step


@pytest.mark.parametrize("variance,param_steps", [("fast", 1), ("two_pass", 2)])
def test_the_imagenet_step_equals_the_jax_examples_step(variance, param_steps,
                                                        monkeypatch):
    learning_rate = 0.1
    example = _load(PORT_EXAMPLES, "imagenet/train_imagenet_torch.py")
    rng = np.random.RandomState(32)
    images = rng.randint(0, 256, (2, 8, 32, 32, 3)).astype(np.uint8)
    labels = rng.randint(0, 10, (2, 8)).astype(np.int32)
    _flax_resnet50()
    if variance == "two_pass":
        import flax.linen

        monkeypatch.setattr(flax.linen, "BatchNorm", functools.partial(
            flax.linen.BatchNorm, use_fast_variance=False))
    theirs = _jax_example_steps(images, labels, learning_rate)

    *ours, step = _port_example_steps(example, images, labels, learning_rate, 2,
                                      torch.float32)
    for i, ((loss, tree), (mine_loss, mine)) in enumerate(zip(theirs, ours)):
        assert math.isfinite(mine_loss)
        assert mine_loss == pytest.approx(loss, rel=1e-4)
        if i < param_steps:
            _assert_tree_close(mine["params"], tree["params"], atol=1e-4, rtol=1e-4)
            _assert_tree_close(mine["batch_stats"], tree["batch_stats"], atol=1e-5, rtol=0)
    if variance == "fast":
        # the witness of the second step: both steps in float64, where the JAX example's
        # E[x^2] - E[x]^2 variance and the port's batch norm agree on every leaf within
        # the same bars (2.9e-6 at most: the port's step forms image / 255 in float32);
        # in float32 either two-pass form (flax's, the port's) leaves one stage-3
        # channel's bias gradient 2.3e-3 off the float64 step's
        wits = _jax_example_steps(images, labels, learning_rate, float64=True)
        *ours64, _ = _port_example_steps(example, images, labels, learning_rate, 2,
                                         torch.float64)
        for (loss, tree), (mine_loss, mine) in zip(wits, ours64):
            assert mine_loss == pytest.approx(loss, rel=1e-4)
            _assert_tree_close(mine["params"], tree["params"], atol=1e-4, rtol=1e-4)
            _assert_tree_close(mine["batch_stats"], tree["batch_stats"], atol=1e-5, rtol=0)
    groups = model_optimizer_groups(step)
    assert groups == [{"lr": learning_rate, "momentum": 0.9, "nesterov": True,
                       "dampening": 0, "weight_decay": 0}]


def model_optimizer_groups(step):
    """The hyper-parameters of the SGD a ``make_train_step`` closure holds."""
    cells = {name: cell.cell_contents for name, cell in zip(step.__code__.co_freevars,
                                                            step.__closure__)}
    return [{k: g[k] for k in ("lr", "momentum", "nesterov", "dampening", "weight_decay")}
            for g in cells["opt"].param_groups]


def test_the_augment_transform_crops_and_flips_from_the_generator():
    example = _load(PORT_EXAMPLES, "imagenet/train_imagenet_torch.py")
    from petastorm_tpu_torch.ops import image

    x = torch.from_numpy(np.random.RandomState(33).randint(0, 256, (6, 240, 250, 3))
                         .astype(np.uint8))
    out = example.make_augment()({"image": x, "label": torch.arange(6)},
                                 torch.Generator().manual_seed(5))
    g = torch.Generator().manual_seed(5)
    cropped = image.random_crop(x, g, 224, 224)
    flips = torch.rand(6, generator=g) < 0.5
    assert out["image"].shape == (6, 224, 224, 3)
    assert torch.equal(out["image"], torch.where(flips[:, None, None, None],
                                                 cropped.flip(2), cropped))
    small = x[:, :32, :32]
    out = example.make_augment()({"image": small}, torch.Generator().manual_seed(5))
    flips = torch.rand(6, generator=torch.Generator().manual_seed(5)) < 0.5
    assert torch.equal(out["image"], torch.where(flips[:, None, None, None],
                                                 small.flip(2), small))


# -- the ImageNet example end to end ------------------------------------------------------


ROWS, HW = 48, 32


@pytest.fixture(scope="module")
def imagenet_store(tmp_path_factory):
    """48 rows of the example's training layout (32x32 JPEG q90, labels 0-9) through
    the torch generator's schema, 12 rows a file."""
    gen = _load(PORT_EXAMPLES, "imagenet/generate_petastorm_imagenet.py")
    from petastorm_tpu_torch.metadata import write_dataset

    rng = np.random.RandomState(34)
    url = "file://" + str(tmp_path_factory.mktemp("torch_examples") / "imagenet")
    write_dataset(url, gen.training_schema(HW), (
        {"noun_id": "n%08d" % (i % 10), "label": np.int32(i % 10),
         "image": rng.randint(0, 256, (HW, HW, 3), dtype=np.uint8)} for i in range(ROWS)),
        rows_per_file=12, row_group_size_mb=1)
    return url


@pytest.mark.parametrize("extra", [["--augment", "--trace"], ["--model", "vit_s16",
                                                              "--host-decode"]],
                         ids=["resnet50_augment_trace", "vit_s16_host_decode"])
def test_the_imagenet_example_trains_end_to_end(imagenet_store, tmp_path, extra):
    example = _load(PORT_EXAMPLES, "imagenet/train_imagenet_torch.py")
    argv = ["--dataset-url", imagenet_store, "--device", "cpu", "--steps", "2",
            "--batch-size", "8", "--num-classes", "10", "--workers", "1"]
    trace = str(tmp_path / "trace.json")
    argv += [a if a != "--trace" else "--trace=" + trace for a in extra]
    res = example.main(argv)
    assert res["steps"] == 2 and len(res["losses"]) == 2
    assert all(math.isfinite(v) for v in res["losses"])
    assert res["img_per_s"] > 0 and res["stats"]["batches"] >= 2
    if "--trace" in extra:
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
        assert sum(e.get("name") == "train.step" for e in events) == 2
        assert any(e.get("name") == "decode.dispatch" for e in events)


def test_the_imagenet_example_refuses_resize_with_host_decode(imagenet_store):
    example = _load(PORT_EXAMPLES, "imagenet/train_imagenet_torch.py")
    with pytest.raises(SystemExit):
        example.parse_args(["--dataset-url", imagenet_store, "--host-decode",
                            "--decode-resize", "64"])


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_the_imagenet_example_as_two_gloo_ranks(imagenet_store, tmp_path):
    from _torch_rank_jobs import gloo_imagenet_example_rank

    world = 2
    cfg = {"script": IMAGENET,
           "argv": ["--dataset-url", imagenet_store, "--device", "cpu", "--steps", "2",
                    "--batch-size", "8", "--num-classes", "10", "--workers", "1"]}
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    outs = [str(tmp_path / ("rank%d.json" % r)) for r in range(world)]
    procs = [ctx.Process(target=gloo_imagenet_example_rank,
                         args=(r, world, port, cfg, outs[r])) for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=240)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.terminate()
        p.join(10)
    assert not alive and [p.exitcode for p in procs] == [0] * world
    ranks = [json.load(open(o)) for o in outs]
    for r in ranks:
        assert r["steps"] == 2 and all(math.isfinite(v) for v in r["losses"])
        assert r["stats"]["rows"] >= 2 * 8 // world  # each rank cuts its half a batch
    # DistributedDataParallel applied one averaged gradient on both: equal replicas
    assert ranks[0]["param_sum"] == ranks[1]["param_sum"]
    assert ranks[0]["losses"] != ranks[1]["losses"]  # each rank's own half of the batch
    # each step is the one-process step on the global batch (the ranks' halves in rank
    # order), batch statistics included, within the model bars
    example = _load(PORT_EXAMPLES, "imagenet/train_imagenet_torch.py")
    recs = [np.load(o + ".npz") for o in outs]
    model = example.build_model("resnet50", 10, (HW, HW), "cpu", dtype=torch.float32)
    step = example.make_train_step(model, 0.1)
    buffers = {name for name, _ in model.named_buffers()}
    for i in range(2):
        image = np.concatenate([rec["step%d.image" % i] for rec in recs])
        label = np.concatenate([rec["step%d.label" % i] for rec in recs])
        assert image.shape[0] == 8
        loss = float(step(torch.from_numpy(image), torch.from_numpy(label)))
        assert loss == pytest.approx(np.mean([r["losses"][i] for r in ranks]), rel=1e-4)
        for name, value in model.state_dict().items():
            for rec in recs:
                tol = dict(atol=1e-5, rtol=0) if name in buffers else dict(atol=1e-4,
                                                                          rtol=1e-4)
                np.testing.assert_allclose(rec["step%d.%s" % (i, name)], value.numpy(),
                                           err_msg="step %d %s" % (i, name), **tol)


# -- the other scripts ------------------------------------------------------------------


def test_hello_world_petastorm_dataset(scratch_tmp, monkeypatch, capsys):
    ours = _load(PORT_EXAMPLES, "hello_world/petastorm_dataset.py").main(
        ["--url", "file://" + str(scratch_tmp / "ours")])
    out = _run_jax_example("hello_world/petastorm_dataset.py",
                           ["--url", "file://" + str(scratch_tmp / "theirs")], monkeypatch,
                           capsys)
    theirs = [int(line.split()[0]) for line in out.splitlines()]
    assert sorted(ours) == sorted(theirs) == list(range(10))


def test_hello_world_external_dataset(scratch_tmp, monkeypatch, capsys):
    ours = _load(PORT_EXAMPLES, "hello_world/external_dataset.py").main(
        ["--path", str(scratch_tmp), "--device", "cpu"])
    out = _run_jax_example("hello_world/external_dataset.py", ["--path", str(scratch_tmp)],
                           monkeypatch, capsys)
    assert "rows: %d" % ours["rows"] in out and ours["rows"] == 100
    theirs = re.search(r"batch: (\{.*\})", out).group(1)
    for name, (shape, _dtype) in ours["batch"].items():
        assert "'%s': (%r" % (name, shape) in theirs


def test_hello_world_hive_partitioned(scratch_tmp, monkeypatch, capsys):
    ours = _load(PORT_EXAMPLES, "hello_world/hive_partitioned.py").main(
        ["--path", str(scratch_tmp / "ours"), "--device", "cpu"])
    out = _run_jax_example("hello_world/hive_partitioned.py",
                           ["--path", str(scratch_tmp / "theirs")], monkeypatch, capsys)
    assert "rows for 2024-06-02: %d" % ours["day_rows"] in out and ours["day_rows"] == 80
    assert "eu rows with positive value: %d" % ours["eu_positive_rows"] in out
    assert "columns: %r" % ours["columns"] in out
    # the first batch is whichever row group a reader thread finished first, in either
    # package: each first row must carry its own id's partition values
    theirs = ast.literal_eval(re.search(r"first rows: (\[.*\])", out).group(1))
    for rows in (ours["first_rows"], theirs):
        assert len(rows) == 3
        for rid, date, region in rows:
            part = rid // 40  # 40 ids a (date, region) directory, dates outermost
            assert (date, region) == (("2024-06-01", "2024-06-02", "2024-06-03")[part // 2],
                                       ("us", "eu")[part % 2])


def test_ngram_example(scratch_tmp, monkeypatch, capsys):
    ours = _load(PORT_EXAMPLES, "ngram/ngram_example.py").main(
        ["--url", "file://" + str(scratch_tmp / "ours")])
    out = _run_jax_example("ngram/ngram_example.py",
                           ["--url", "file://" + str(scratch_tmp / "theirs")], monkeypatch,
                           capsys)
    assert "per-row windows: %d" % len(ours["rows"]) in out
    assert "columnar windows: %d" % ours["columnar"] in out
    assert ours["rows"][0] == [0, 1, 2] and ours["columnar"] == len(ours["rows"])


def test_converter_example_without_pyspark(scratch_tmp, monkeypatch, capsys):
    try:
        import pyspark  # noqa: F401

        pytest.skip("pyspark installed: the fallback is not the path")
    except ImportError:
        pass
    ours = _load(PORT_EXAMPLES, "spark_dataset_converter/converter_example.py").main(
        ["--device", "cpu"])
    assert ours == {"id": (64,), "feature": (64,)}
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", ["converter_example.py"])
    module = _load(JAX_EXAMPLES, "spark_dataset_converter/converter_example.py")
    module.arrow_fallback()
    assert "'id': (64,)" in capsys.readouterr().out


def test_checkpoint_resume_example(scratch_tmp, monkeypatch, capsys):
    ours = _load(PORT_EXAMPLES, "checkpoint_resume/resume_example.py").main([])
    assert set(ours["before"]) | set(ours["after"]) == set(range(96))
    assert ours["dcp"] >= 96 and ours["loader"] >= 96
    out = _run_jax_example("checkpoint_resume/resume_example.py", [], monkeypatch, capsys)
    assert "preempted after %d rows" % len(ours["before"]) in out
    assert "resumed: %d rows after restore" % len(ours["after"]) in out


@pytest.mark.parametrize("extra", [[], ["--in-memory"]], ids=["streamed", "in_memory"])
def test_train_mnist_example(scratch_tmp, monkeypatch, capsys, extra):
    ours = _load(PORT_EXAMPLES, "mnist/train_mnist_torch.py").main(
        ["--path", str(scratch_tmp), "--device", "cpu", "--epochs", "1"] + extra)
    assert ours["steps"] == 2048 // 128
    assert all(math.isfinite(v) for v in ours["losses"])
    out = _run_jax_example("mnist/train_mnist_jax.py",
                           ["--path", str(scratch_tmp), "--epochs", "1"] + extra,
                           monkeypatch, capsys)
    assert "trained %d steps" % ours["steps"] in out


def test_mnist_pytorch_example(scratch_tmp, monkeypatch, capsys):
    ours = _load(PORT_EXAMPLES, "mnist/pytorch_example.py").main(
        ["--path", str(scratch_tmp)])
    out = _run_jax_example("mnist/pytorch_example.py", ["--path", str(scratch_tmp)],
                           monkeypatch, capsys)
    assert "epoch 0: %d steps" % ours["steps"][0] in out
    assert ours["steps"] == [2048 // 128]


def test_mnist_tf_example(scratch_tmp):
    pytest.importorskip("tensorflow")
    histories = _load(PORT_EXAMPLES, "mnist/tf_example.py").main(["--path", str(scratch_tmp)])
    assert len(histories) == 1 and math.isfinite(histories[0].history["loss"][0])


def test_generate_imagenet_example_writes_the_jax_examples_store(scratch_tmp, monkeypatch,
                                                                 capsys):
    import pyarrow.parquet as pq

    ours = _load(PORT_EXAMPLES, "imagenet/generate_petastorm_imagenet.py").main(
        ["--url", "file://" + str(scratch_tmp / "ours"), "--size", "32"])
    out = _run_jax_example("imagenet/generate_petastorm_imagenet.py",
                           ["--url", "file://" + str(scratch_tmp / "theirs"), "--size", "32"],
                           monkeypatch, capsys)
    assert out.strip() == "n00000000 (32, 32, 3)"
    assert ours == "file://" + str(scratch_tmp / "ours")
    a = pq.read_table(str(scratch_tmp / "ours"))
    b = pq.read_table(str(scratch_tmp / "theirs"))
    assert a.num_rows == 32 and a.equals(b)
