"""The port's parallelism toolkit (ring and Ulysses attention, the GPipe pipeline)
against the JAX package's, over gloo ranks on ``"cpu"`` meshes.

One eight-rank job (``_torch_model_ranks.attention_pipeline_rank``, run once for the
module) computes every case; this process runs the JAX functions on the eight virtual
devices of ``tests/conftest.py`` with the same inputs, made from a numpy seed. The bars
are ``tests/test_parallel.py``'s: attention within atol 2e-5 of the JAX functions and of
``reference_attention``; the ring's q/k/v gradients within 1e-5 of ``jax.grad``'s; the
pipeline within 1e-5 of sequential application and of the JAX pipeline. The world-of-one
cases run in this process.
"""
import datetime

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from petastorm_tpu.parallel import attention as ref_attention  # noqa: E402
from petastorm_tpu.parallel import pipeline as ref_pipeline  # noqa: E402
from petastorm_tpu.parallel.mesh import make_mesh as ref_make_mesh  # noqa: E402
from petastorm_tpu.parallel.mesh import sequence_sharding as ref_sequence_sharding  # noqa: E402
from petastorm_tpu_torch.parallel import attention, collectives  # noqa: E402

WORLD = 8


def _inputs():
    rng = np.random.RandomState(0)
    z = {n: rng.standard_normal((2, 16, 4, 8)).astype(np.float32) for n in "qkv"}
    z.update({"g" + n: rng.standard_normal((1, 8, 2, 4)).astype(np.float32) for n in "qkv"})
    z["w"] = (rng.standard_normal((4, 8, 8)) * 0.3).astype(np.float32)
    z["x"] = rng.standard_normal((16, 8)).astype(np.float32)
    return z


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    from _torch_model_ranks import attention_pipeline_rank, run_ranks

    tmp = tmp_path_factory.mktemp("torch_parallel_job")
    inputs = str(tmp / "inputs.npz")
    np.savez(inputs, **_inputs())
    return run_ranks(attention_pipeline_rank, WORLD, {"inputs": inputs}, str(tmp))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("name", ["ring", "ulysses"])
def test_self_attention_equals_the_references(job, name, causal):
    z = _inputs()
    mesh = ref_make_mesh({"sp": 4, "dp": 2})
    sh = ref_sequence_sharding(mesh)
    q, k, v = (jax.device_put(jnp.asarray(z[n]), sh) for n in "qkv")
    fn = {"ring": ref_attention.ring_self_attention,
          "ulysses": ref_attention.ulysses_self_attention}[name]
    theirs = np.asarray(fn(q, k, v, mesh, causal=causal))
    dense = np.asarray(ref_attention.reference_attention(
        *(jnp.asarray(z[n]) for n in "qkv"), causal=causal))
    for r in job:
        ours = r["arrays"]["%s_%d" % (name, causal)]
        np.testing.assert_allclose(ours, theirs, atol=2e-5)
        np.testing.assert_allclose(ours, dense, atol=2e-5)


def test_ring_attention_gradients_equal_jax_grad(job):
    z = _inputs()
    mesh = ref_make_mesh({"sp": 4}, devices=jax.devices()[:4])

    def loss(q, k, v):
        return jnp.sum(ref_attention.ring_self_attention(q, k, v, mesh, causal=True) ** 2)

    grads = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(z["g" + n]) for n in "qkv"))
    for r in job:
        for n, g in zip("qkv", grads):
            np.testing.assert_allclose(r["arrays"]["grad_" + n], np.asarray(g), atol=1e-5)


def test_pipeline_equals_sequential_and_the_reference(job):
    z = _inputs()
    w, x = z["w"], z["x"]
    expected = x
    for i in range(4):
        expected = np.tanh(expected @ w[i])
    theirs = ref_pipeline.pipelined_apply(lambda p, h: jnp.tanh(h @ p), jnp.asarray(w),
                                          jnp.asarray(x), ref_make_mesh({"pp": 4}),
                                          n_micro=4)
    for r in job:
        np.testing.assert_allclose(r["arrays"]["pipeline"], expected, atol=1e-5)
        np.testing.assert_allclose(r["arrays"]["pipeline"], np.asarray(theirs), atol=1e-5)


# -- a world of one, in this process ----------------------------------------------------


@pytest.fixture
def one_rank():
    import torch.distributed as dist
    from _torch_model_ranks import free_port

    dist.init_process_group("gloo", init_method="tcp://127.0.0.1:%d" % free_port(),
                            world_size=1, rank=0, timeout=datetime.timedelta(seconds=60))
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_axis_of_one_is_the_identity_and_the_local_forms_equal_the_oracle(one_rank):
    from petastorm_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh({"sp": 1}, device_type="cpu")
    z = _inputs()
    q, k, v = (torch.from_numpy(z[n]) for n in "qkv")
    x = torch.arange(6.0).reshape(2, 3).requires_grad_()
    for fn in (lambda t: collectives.ppermute(t, mesh, "sp"),
               lambda t: collectives.all_to_all(t, mesh, "sp", 0, 1),
               lambda t: collectives.f(t, mesh, ("dp", "sp")),
               lambda t: collectives.g(t, mesh, ("dp", "sp"))):
        y = fn(x)
        assert torch.equal(y, x)
        (grad,) = torch.autograd.grad(y.sum(), x)
        assert torch.equal(grad, torch.ones_like(x))
    for causal in (False, True):
        dense = attention.reference_attention(q, k, v, causal=causal)
        ref = np.asarray(ref_attention.reference_attention(
            *(jnp.asarray(z[n]) for n in "qkv"), causal=causal))
        np.testing.assert_allclose(dense.numpy(), ref, atol=2e-5)
        for fn in (attention.ring_attention, attention.ulysses_attention):
            np.testing.assert_allclose(fn(q, k, v, mesh, "sp", causal).numpy(), ref,
                                       atol=2e-5)


def test_ulysses_refuses_heads_that_do_not_split(one_rank):
    from petastorm_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(device_type="cpu")
    q = torch.zeros(1, 4, 3, 2)
    assert attention.ulysses_attention(q, q, q, mesh, "dp").shape == q.shape
    with pytest.raises(ValueError, match="divisible"):
        _uly_on_fake_axis(q)


def _uly_on_fake_axis(q):
    """Ulysses' check on an axis of size 2 (the check runs before any exchange)."""
    class _Mesh:
        mesh_dim_names = ("sp",)
        mesh = torch.zeros(2)

        @staticmethod
        def get_coordinate():
            return [0]

    return attention.ulysses_attention(q, q, q, _Mesh, "sp")
