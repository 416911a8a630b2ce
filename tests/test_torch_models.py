"""The port's model zoo (ResNet, ViT, MnistCNN) against the JAX package's flax models.

The JAX model's initial variables cross over through ``models/weights.py`` as numpy, and
the same inputs, made from a numpy seed, go through both:

- forward parity in float32: logits within atol/rtol 1e-4 in eval and train mode, and
  the BatchNorm ``batch_stats`` after one train-mode forward within atol 1e-5, for
  ResNet-18 and ResNet-50 at 64x64, ViT-S/16 at 32x32 (a 2x2 patch grid) and MnistCNN;
- gradient parity in float32: cross-entropy gradients of ResNet-18 (train mode) and
  ViT-S/16 against ``jax.grad``, each tensor within 1e-4 of its largest magnitude (the
  attention's key biases, whose gradient is zero in exact arithmetic, are held below
  1e-6 of the model's largest gradient in both packages);
- the bfloat16 default: ResNet-18's logits within 2e-2 of the largest JAX bfloat16
  logit (measured on the CPU over inputs of seeds 2-4: 2.9e-7 to 4.3e-7 in eval mode,
  3.3e-3 to 5.8e-3 in train mode);
- parameter counts equal ``tests/test_models.py``'s canonical ones;
- ViT dropout at contract level, the weights' round trip and refusals, the flax traps
  (SAME padding, the running variance), and the entry points' CUDA default.
"""
import functools
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("flax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from petastorm_tpu.models import mnist as ref_mnist  # noqa: E402
from petastorm_tpu.models import resnet as ref_resnet  # noqa: E402
from petastorm_tpu.models import vit as ref_vit  # noqa: E402
from petastorm_tpu_torch.models import layers, mnist, resnet, vit  # noqa: E402
from petastorm_tpu_torch.models.weights import flax_variables, load_flax_variables  # noqa: E402

F32 = torch.float32


def _numpy_tree(variables):
    return jax.tree.map(np.asarray, {k: dict(v) for k, v in variables.items()})


_INITIAL = {}


def _pair(ref_model, port_model, x):
    """Initialise the flax model on ``x`` (jitted: eager flax init of a ResNet takes
    ~20 s here), load its variables into the port's model."""
    ref_model = ref_model.clone(dtype=jnp.float32)  # float32 params whatever the dtype
    key = (repr(ref_model), x.shape)
    if key not in _INITIAL:
        init = jax.jit(functools.partial(ref_model.init, train=False))
        _INITIAL[key] = _numpy_tree(init(jax.random.PRNGKey(0), jnp.asarray(x)))
    variables = _INITIAL[key]
    return variables, load_flax_variables(port_model, variables)


MODELS = {
    "resnet18": (lambda: ref_resnet.ResNet18(num_classes=10, dtype=jnp.float32),
                 lambda: resnet.ResNet18(num_classes=10, dtype=F32, device="cpu"),
                 (2, 64, 64, 3)),
    "resnet50": (lambda: ref_resnet.ResNet50(num_classes=10, dtype=jnp.float32),
                 lambda: resnet.ResNet50(num_classes=10, dtype=F32, device="cpu"),
                 (2, 64, 64, 3)),
    "vit_s16": (lambda: ref_vit.ViT_S16(num_classes=10, dtype=jnp.float32),
                lambda: vit.ViT_S16(num_classes=10, dtype=F32, image_size=32,
                                    device="cpu"),
                (2, 32, 32, 3)),
    "mnist": (lambda: ref_mnist.MnistCNN(), lambda: mnist.MnistCNN(device="cpu"),
              (3, 28, 28)),
}


def _input(shape, seed=0):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_forward_parity_f32(name):
    make_ref, make_port, shape = MODELS[name]
    x = _input(shape)
    ref_model = make_ref()
    variables, model = _pair(ref_model, make_port(), x)
    model.eval()
    with torch.no_grad():
        ours = model(torch.from_numpy(x)).numpy()
    theirs = np.asarray(ref_model.apply(variables, jnp.asarray(x), train=False))
    assert ours.dtype == np.float32 and ours.shape == theirs.shape
    np.testing.assert_allclose(ours, theirs, atol=1e-4, rtol=1e-4)
    if "batch_stats" not in variables:
        return
    model.train()
    with torch.no_grad():
        ours = model(torch.from_numpy(x)).numpy()
    theirs, updated = ref_model.apply(variables, jnp.asarray(x), train=True,
                                      mutable=["batch_stats"])
    np.testing.assert_allclose(ours, np.asarray(theirs), atol=1e-4, rtol=1e-4)
    stats = flax_variables(model)["batch_stats"]
    leaves = jax.tree_util.tree_leaves_with_path(updated["batch_stats"])
    assert len(leaves) == len(jax.tree_util.tree_leaves(stats))
    for path, leaf in leaves:
        node = stats
        for key in path:
            node = node[key.key]
        np.testing.assert_allclose(node, np.asarray(leaf), atol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))


def _cross_entropy_grads(ref_model, model, variables, x, labels, train):
    def loss_fn(params):
        rest = {k: v for k, v in variables.items() if k != "params"}
        if train and "batch_stats" in rest:
            logits, _ = ref_model.apply({"params": params, **rest}, jnp.asarray(x),
                                        train=True, mutable=["batch_stats"])
        else:
            logits = ref_model.apply({"params": params, **rest}, jnp.asarray(x),
                                     train=False)
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(jnp.take_along_axis(logp, jnp.asarray(labels)[:, None], 1))

    theirs = jax.jit(jax.grad(loss_fn))(jax.tree.map(jnp.asarray, variables["params"]))
    model.train(train)
    logits = model(torch.from_numpy(x))
    torch.nn.functional.cross_entropy(logits, torch.from_numpy(labels)).backward()
    return flax_variables(model, grads=True)["params"], theirs


@pytest.mark.parametrize("name,train", [("resnet18", True), ("vit_s16", False)])
def test_gradient_parity_f32(name, train):
    make_ref, make_port, shape = MODELS[name]
    x = _input(shape, seed=1)
    labels = np.array([3, 7], dtype=np.int64)
    ref_model = make_ref()
    variables, model = _pair(ref_model, make_port(), x)
    ours, theirs = _cross_entropy_grads(ref_model, model, variables, x, labels, train)
    leaves = jax.tree_util.tree_leaves_with_path(theirs)
    assert len(leaves) == len(jax.tree_util.tree_leaves(ours))
    largest = max(float(np.abs(np.asarray(leaf)).max()) for _p, leaf in leaves)
    for path, leaf in leaves:
        node = ours
        for key in path:
            node = node[key.key]
        leaf = np.asarray(leaf)
        name = jax.tree_util.keystr(path)
        if name.endswith("['key']['bias']"):
            # zero in exact arithmetic (a key bias adds one constant to a query's scores,
            # which the softmax removes): both packages hold rounding noise
            assert np.abs(node).max() <= 1e-6 * largest, name
            assert np.abs(leaf).max() <= 1e-6 * largest, name
            continue
        np.testing.assert_allclose(node, leaf, atol=1e-4 * np.abs(leaf).max(), rtol=0,
                                   err_msg=name)


def test_resnet18_bf16_forward_within_the_stated_tolerance():
    x = _input((2, 64, 64, 3), seed=2)
    ref_model = ref_resnet.ResNet18(num_classes=10)  # the JAX default: bfloat16
    variables, model = _pair(ref_model, resnet.ResNet18(num_classes=10, device="cpu"), x)
    assert model.compute_dtype == torch.bfloat16
    for train in (False, True):
        model.train(train)
        with torch.no_grad():
            ours = model(torch.from_numpy(x)).numpy()
        theirs = ref_model.apply(variables, jnp.asarray(x), train=train,
                                 mutable=["batch_stats"] if train else False)
        theirs = np.asarray(theirs[0] if train else theirs)
        assert ours.dtype == np.float32
        assert np.abs(ours - theirs).max() <= 2e-2 * np.abs(theirs).max()


@pytest.mark.parametrize("make,expected", [
    (lambda: resnet.ResNet18(num_classes=1000, device="meta"), 11_689_512),
    (lambda: resnet.ResNet34(num_classes=1000, device="meta"), 21_797_672),
    (lambda: resnet.ResNet50(num_classes=1000, device="meta"), 25_557_032),
    (lambda: vit.ViT_B16(num_classes=1000, device="meta"), 86_567_656),
    (lambda: vit.ViT_S16(num_classes=1000, device="meta"), 22_050_664),
])
def test_param_counts_canonical(make, expected):
    assert sum(p.numel() for p in make().parameters()) == expected


def test_block_classes():
    assert resnet.ResNet18(device="meta").block_cls is resnet.BasicBlock
    assert resnet.ResNet34(device="meta").block_cls is resnet.BasicBlock
    assert resnet.ResNet50(device="meta").block_cls is resnet.BottleneckBlock


def test_vit_dropout_contract():
    x = torch.from_numpy(np.random.RandomState(0).randint(0, 255, (2, 32, 32, 3))
                         .astype(np.uint8))
    kw = dict(num_classes=10, patch_size=8, hidden_size=64, num_layers=2, num_heads=4,
              mlp_dim=128, image_size=32, dtype=F32, device="cpu")
    torch.manual_seed(0)
    model = vit.ViT(dropout_rate=0.5, **kw).eval()
    with torch.no_grad():
        eval1, eval2 = model(x), model(x)
        assert torch.equal(eval1, eval2) and eval1.dtype == F32 and eval1.shape == (2, 10)
        model.train()
        tr1, tr2 = model(x), model(x)
    assert not torch.equal(tr1, eval1) and not torch.equal(tr1, tr2)
    torch.manual_seed(0)
    model = vit.ViT(dropout_rate=0.0, **kw)
    with torch.no_grad():
        assert torch.equal(model.train()(x), model.eval()(x))


def test_weights_round_trip_and_refusals():
    x = _input((1, 28, 28))
    variables, model = _pair(ref_mnist.MnistCNN(), mnist.MnistCNN(device="cpu"), x)
    back = flax_variables(model)
    for path, leaf in jax.tree_util.tree_leaves_with_path(variables):
        node = back
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node, leaf)
    missing = {"params": {k: v for k, v in variables["params"].items() if k != "Dense_1"}}
    with pytest.raises(ValueError, match="missing"):
        load_flax_variables(mnist.MnistCNN(device="cpu"), missing)
    bad = {"params": dict(variables["params"],
                          Dense_1={"kernel": np.zeros((128, 5), np.float32),
                                   "bias": np.zeros(5, np.float32)})}
    with pytest.raises(ValueError, match="Dense_1/kernel"):
        load_flax_variables(mnist.MnistCNN(device="cpu"), bad)
    with pytest.raises(TypeError, match="no flax layout"):
        flax_variables(torch.nn.Linear(2, 2))


def test_flax_traps_same_padding_and_running_variance():
    import flax.linen as nn

    x = np.random.RandomState(4).rand(2, 8, 8, 3).astype(np.float32)
    # a 3x3 stride-2 "SAME" conv pads (0, 1) on an even input
    ref_conv = nn.Conv(4, (3, 3), (2, 2), use_bias=False)
    params = ref_conv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    conv = layers.Conv(3, 4, 3, 2, bias=False, device="cpu")
    load = np.transpose(np.asarray(params["params"]["kernel"]), (3, 2, 0, 1))
    conv.weight.data.copy_(torch.from_numpy(np.array(load)))
    xt = layers.nhwc_to_nchw(torch.from_numpy(x), F32)
    ours = conv(xt).permute(0, 2, 3, 1).detach().numpy()
    np.testing.assert_allclose(ours, np.asarray(ref_conv.apply(params, jnp.asarray(x))),
                               atol=1e-5)
    assert layers.same_pads(8, 3, 2) == (0, 1) and layers.same_pads(7, 3, 2) == (1, 1)
    pooled = layers.max_pool_same(xt, 3, 2).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(pooled, np.asarray(nn.max_pool(
        jnp.asarray(x), (3, 3), strides=(2, 2), padding="SAME")))
    # flax's running variance is the biased one, momentum 0.9 on the old value
    bn = layers.BatchNorm(4, device="cpu").train()
    y = torch.from_numpy(np.random.RandomState(5).rand(2, 4, 3, 3).astype(np.float32))
    bn(y)
    np.testing.assert_allclose(bn.var.numpy(), 0.9 + 0.1 * y.var(dim=(0, 2, 3),
                                                                 unbiased=False).numpy(),
                               atol=1e-6)


def test_entry_points_default_to_cuda():
    from petastorm_tpu_torch.models import transformer

    entries = [resnet.ResNet50, vit.ViT_B16, mnist.MnistCNN,
               lambda device="cuda": transformer.init_params(transformer.TransformerConfig(),
                                                             0, device=device)]
    for entry in (resnet.ResNet, vit.ViT, mnist.MnistCNN, transformer.init_params,
                  transformer.model_mesh, layers.Conv, layers.Dense, layers.BatchNorm,
                  layers.LayerNorm):
        assert inspect.signature(entry).parameters["device" if entry is not
                                                   transformer.model_mesh
                                                   else "device_type"].default == "cuda"
    if torch.cuda.is_available():
        return  # on a card the defaults build there (the gpu-marked tests use it)
    for entry in entries:
        with pytest.raises((RuntimeError, AssertionError)):
            entry()
