"""The port's SPMD MoE transformer step against the JAX package's, over eight gloo ranks.

One eight-rank job (``_torch_model_ranks.transformer_rank``, run once for the module)
runs every case, each on its own ``model_mesh``; this process runs the JAX package's
``make_train_step`` on the eight virtual devices of ``tests/conftest.py`` from the same
initial params (the JAX ``init_params``, carried across as numpy) and tokens.

- Layouts ``{dp:2, pp:2, sp:2}``, ``{pp:2, sp:2, tp:2}`` and ``{pp:2, ep:2, sp:2}``: one
  step's loss within 2e-4 of the dense ``reference_loss`` (JAX's and the port's), and
  every updated parameter within atol 1e-5 / rtol 1e-4 of JAX's step on the same layout.
- ``capacity_factor=1.0`` on the ep layout, so tokens drop: the loss and the parameters
  equal JAX's step.
- Five steps at lr 0.5 on the dp layout: the loss falls.
- The dp layout fed by the port's ``make_dataloader`` under ``data_sharding(mesh)`` from
  a token store: the delivered global batch is the store's rows, each rank's block is
  its (dp, sp) part, and the step equals JAX's on the delivered tokens.
"""
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from petastorm_tpu.models import transformer as ref  # noqa: E402
from petastorm_tpu_torch.models import transformer as port  # noqa: E402

CFG = ref.TransformerConfig(vocab=64, d_model=32, n_heads=4, head_dim=8, d_ff=32,
                            n_stages=2, layers_per_stage=1, n_experts=4,
                            capacity_factor=8.0,  # >= n_experts: nothing drops
                            max_seq=32)
DROP = dict(capacity_factor=1.0)
LAYOUTS = {"dp": {"dp": 2, "pp": 2, "sp": 2}, "tp": {"pp": 2, "sp": 2, "tp": 2},
           "ep": {"pp": 2, "ep": 2, "sp": 2}}
CASES = [{"name": name, "axes": axes, "capacity_factor": 8.0, "lr": 0.1, "steps": 1}
         for name, axes in LAYOUTS.items()] + [
    {"name": "drop", "axes": LAYOUTS["ep"], "capacity_factor": 1.0, "lr": 0.1, "steps": 1},
    {"name": "falls", "axes": LAYOUTS["dp"], "capacity_factor": 8.0, "lr": 0.5, "steps": 5},
    {"name": "loader", "axes": LAYOUTS["dp"], "capacity_factor": 8.0, "lr": 0.1,
     "steps": 1, "loader": True}]
B, S = 8, 32


def _params():
    return jax.tree.map(np.asarray, ref.init_params(CFG, jax.random.PRNGKey(0)))


def _data():
    kt, kg = jax.random.split(jax.random.PRNGKey(1))
    return (np.asarray(jax.random.randint(kt, (B, S), 0, CFG.vocab), dtype=np.int32),
            np.asarray(jax.random.randint(kg, (B, S), 0, CFG.vocab), dtype=np.int32))


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    from _torch_model_ranks import run_ranks, transformer_rank

    tmp = tmp_path_factory.mktemp("torch_transformer_job")
    params = _params()
    tokens, targets = _data()
    flat = {k: v for k, v in params.items() if k != "stages"}
    flat.update({"stages/" + k: v for k, v in params["stages"].items()})
    inputs = str(tmp / "inputs.npz")
    np.savez(inputs, tokens=tokens, targets=targets, **flat)
    store = tmp / "tokens"
    store.mkdir()
    # the store's rows are the tokens in another order, so the loader's batch is checked
    # by content
    order = np.random.RandomState(3).permutation(B)
    pq.write_table(pa.table({
        "tokens": pa.FixedSizeListArray.from_arrays(tokens[order].reshape(-1), S),
        "targets": pa.FixedSizeListArray.from_arrays(targets[order].reshape(-1), S)}),
        str(store / "part-0.parquet"), row_group_size=2)
    results = run_ranks(transformer_rank, 8, {"inputs": inputs, "cases": CASES,
                                              "url": "file://" + str(store)}, str(tmp))
    return results


_STEPS = {}


def _jax_step(axes, capacity_factor, tokens, targets, lr=0.1):
    """JAX's ``make_train_step`` on ``axes`` from the initial params: (new params as
    numpy, loss)."""
    import dataclasses

    cfg = dataclasses.replace(CFG, capacity_factor=capacity_factor)
    mesh = ref.model_mesh(dict(axes))
    shardings = ref.param_shardings(cfg, mesh)
    params = jax.tree.map(jax.device_put, ref.init_params(cfg, jax.random.PRNGKey(0)),
                          shardings, is_leaf=lambda x: isinstance(x, jnp.ndarray))
    ds = ref.data_sharding(mesh)
    step = ref.make_train_step(cfg, mesh, n_micro=2, learning_rate=lr)
    new, loss = step(params, jax.device_put(jnp.asarray(tokens), ds),
                     jax.device_put(jnp.asarray(targets), ds))
    return jax.tree.map(np.asarray, new), float(loss)


def _port_params(arrays, name):
    out = {"stages": {}}
    for k, v in arrays.items():
        if k.startswith(name + "/stages/"):
            out["stages"][k.rsplit("/", 1)[1]] = v
        elif k.startswith(name + "/") and k.count("/") == 1:
            out[k.split("/", 1)[1]] = v
    return out


def _assert_params_equal(ours, theirs):
    for k in ("embed", "pos", "ln_f", "unembed"):
        np.testing.assert_allclose(ours[k], theirs[k], atol=1e-5, rtol=1e-4, err_msg=k)
    for k, v in theirs["stages"].items():
        np.testing.assert_allclose(ours["stages"][k], v, atol=1e-5, rtol=1e-4, err_msg=k)


def _reference_losses(tokens, targets):
    theirs = float(ref.reference_loss(CFG, ref.init_params(CFG, jax.random.PRNGKey(0)),
                                      jnp.asarray(tokens), jnp.asarray(targets)))
    params = jax.tree.map(torch.from_numpy, _params())
    ours = float(port.reference_loss(port.TransformerConfig(**{
        f: getattr(CFG, f) for f in ("vocab", "d_model", "n_heads", "head_dim", "d_ff",
                                     "n_stages", "layers_per_stage", "n_experts",
                                     "capacity_factor", "max_seq")}), params,
        torch.from_numpy(tokens), torch.from_numpy(targets)))
    return theirs, ours


def test_reference_loss_equals_the_references():
    tokens, targets = _data()
    theirs, ours = _reference_losses(tokens, targets)
    assert abs(ours - theirs) < 2e-5, (ours, theirs)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_train_step_matches_dense_oracle_and_the_references_step(job, layout):
    tokens, targets = _data()
    dense, _ours = _reference_losses(tokens, targets)
    new, loss = _jax_step(LAYOUTS[layout], 8.0, tokens, targets)
    for r in job:
        got = r[layout]["losses"][0]
        assert abs(got - dense) < 2e-4, (got, dense)
        assert abs(got - loss) < 2e-5, (got, loss)
    _assert_params_equal(_port_params(job[0]["arrays"], layout), new)


def test_dropped_tokens_match_the_references_step(job):
    tokens, targets = _data()
    new, loss = _jax_step(LAYOUTS["ep"], 1.0, tokens, targets)
    dense, _ = _reference_losses(tokens, targets)
    assert abs(loss - dense) > 1e-3  # tokens did drop: the dense oracle differs
    for r in job:
        assert abs(r["drop"]["losses"][0] - loss) < 2e-5
    _assert_params_equal(_port_params(job[0]["arrays"], "drop"), new)


def test_loss_decreases_over_steps(job):
    for r in job:
        losses = r["falls"]["losses"]
        assert len(losses) == 5 and losses[-1] < losses[0], losses
        assert all(np.isfinite(losses))


def test_loader_fed_step_equals_the_references_step(job):
    tokens, targets = _data()
    arrays = job[0]["arrays"]
    fed, fed_targets = arrays["loader/tokens"], arrays["loader/targets"]
    assert sorted(map(tuple, fed)) == sorted(map(tuple, tokens))
    row = {tuple(t): i for i, t in enumerate(tokens)}
    np.testing.assert_array_equal(fed_targets, targets[[row[tuple(t)] for t in fed]])
    for r in job:
        assert r["loader"]["placements"] == ["Shard(dim=0)", "Replicate()", "Replicate()",
                                             "Shard(dim=1)", "Replicate()"]
        assert r["loader"]["local_shape"] == [B // 2, S // 2]
        np.testing.assert_array_equal(r["arrays"]["loader/tokens"], fed)
    new, loss = _jax_step(LAYOUTS["dp"], 8.0, fed, fed_targets)
    for r in job:
        assert abs(r["loader"]["losses"][0] - loss) < 2e-5
    _assert_params_equal(_port_params(arrays, "loader"), new)
