"""Rank bodies of the port's model-parallel tests (``tests/test_torch_parallel.py`` and
``tests/test_torch_transformer.py``): each runs in a spawned process as one rank of a
``torch.distributed`` job over gloo on ``"cpu"`` meshes, reads its inputs from an
``.npz`` the test wrote, and writes what it computed (an ``.npz``, plus JSON) for the
test process to hold against the JAX package.

This module imports numpy and the port only: a rank must not load jax or the JAX package.
"""
import datetime
import json
import multiprocessing
import os
import socket

import numpy as np

JOB_DEADLINE_S = 240


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(target, world, cfg, tmp):
    """Spawn ``world`` ranks of ``target``; every rank must exit 0 within the deadline.
    Returns each rank's JSON, with its ``.npz`` arrays under ``"arrays"``."""
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    outs = [os.path.join(tmp, "rank%d.json" % r) for r in range(world)]
    procs = [ctx.Process(target=target, args=(r, world, port, cfg, outs[r]))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=JOB_DEADLINE_S)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.terminate()
        p.join(10)
    assert not alive, "a rank did not end within %d s" % JOB_DEADLINE_S
    assert [p.exitcode for p in procs] == [0] * world
    results = [json.load(open(o)) for o in outs]
    for r, o in zip(results, outs):
        with np.load(o + ".npz") as z:
            r["arrays"] = dict(z)
    return results


def _join(rank, world, port):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)  # eight ranks share the host's cores
    dist.init_process_group("gloo", init_method="tcp://127.0.0.1:%d" % port,
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))


def _write(out, res, arrays):
    np.savez(out + ".npz", **arrays)
    with open(out, "w") as f:
        json.dump(res, f)


def _placed(full, mesh, *spec):
    """The global ``full`` array as a DTensor laid out by ``spec`` over ``mesh`` (each
    rank keeps its block)."""
    import torch

    from petastorm_tpu_torch.models.transformer import distribute_params
    from petastorm_tpu_torch.parallel.mesh import NamedSharding, PartitionSpec

    return distribute_params(torch.from_numpy(np.ascontiguousarray(full)),
                             NamedSharding(mesh, PartitionSpec(*spec)))


def attention_pipeline_rank(rank, world, port, cfg, out):
    """Ring and Ulysses attention on a (dp, sp) = (2, 4) mesh, causal and not; the
    ring's q/k/v gradients of ``sum(out ** 2)`` on (dp, sp) = (2, 4) with the batch
    replicated; ``pipelined_apply`` of four ``tanh(h @ w)`` stages over (dp, pp) =
    (2, 4), 4 microbatches."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from petastorm_tpu_torch.parallel import (pipelined_apply, ring_self_attention,
                                              stage_sharding, ulysses_self_attention)
    from petastorm_tpu_torch.parallel.mesh import make_mesh

    _join(rank, world, port)
    try:
        z = dict(np.load(cfg["inputs"]))
        arrays = {}
        mesh = make_mesh({"sp": 4, "dp": 2}, device_type="cpu")
        q, k, v = (_placed(z[n], mesh, "dp", "sp") for n in "qkv")
        for causal in (False, True):
            for name, fn in (("ring", ring_self_attention),
                             ("ulysses", ulysses_self_attention)):
                o = fn(q, k, v, mesh, causal=causal)
                assert isinstance(o, DTensor) and o.placements == q.placements
                arrays["%s_%d" % (name, causal)] = o.full_tensor().numpy()
        leaves = [_placed(z["g" + n], mesh, None, "sp") for n in "qkv"]
        local = [t.to_local().detach().requires_grad_() for t in leaves]
        placed = [DTensor.from_local(t, mesh, s.placements, run_check=False,
                                     shape=s.shape, stride=s.stride())
                  for t, s in zip(local, leaves)]
        o = ring_self_attention(*placed, mesh, causal=True)
        (o.to_local() ** 2).sum().backward()
        for n, t, s in zip("qkv", local, leaves):
            grad = DTensor.from_local(t.grad, mesh, s.placements, run_check=False,
                                      shape=s.shape, stride=s.stride())
            arrays["grad_" + n] = grad.full_tensor().numpy()
        pmesh = make_mesh({"pp": 4}, device_type="cpu")
        w = _placed(z["w"], pmesh, "pp")
        assert w.placements == stage_sharding(pmesh).placements()
        y = pipelined_apply(lambda p, h: torch.tanh(h @ p), w, torch.from_numpy(z["x"]),
                            pmesh, n_micro=4)
        arrays["pipeline"] = y.detach().numpy()
        _write(out, {"rank": rank}, arrays)
    finally:
        dist.destroy_process_group()


def _config(case):
    from petastorm_tpu_torch.models.transformer import TransformerConfig

    return TransformerConfig(vocab=64, d_model=32, n_heads=4, head_dim=8, d_ff=32,
                             n_stages=2, layers_per_stage=1, n_experts=4,
                             capacity_factor=case["capacity_factor"], max_seq=32)


def transformer_rank(rank, world, port, cfg, out):
    """``make_train_step`` for each of ``cfg["cases"]`` on its own ``model_mesh``:
    ``steps`` steps from the JAX package's initial params (``cfg["inputs"]``), tokens
    and targets placed per ``data_sharding`` (or, for a case with ``"loader"``, the
    port's ``make_dataloader`` over the token store under that sharding). Writes each
    case's losses, and its updated params gathered whole."""
    import torch
    import torch.distributed as dist

    from petastorm_tpu_torch.loader import make_dataloader
    from petastorm_tpu_torch.models.transformer import (data_sharding, distribute_params,
                                                        make_train_step, model_mesh,
                                                        param_shardings)

    _join(rank, world, port)
    try:
        z = dict(np.load(cfg["inputs"]))
        global_params = {k: torch.from_numpy(v) for k, v in z.items()
                         if k not in ("tokens", "targets")}
        nested = {"stages": {}}
        for k, v in global_params.items():
            if k.startswith("stages/"):
                nested["stages"][k.split("/", 1)[1]] = v
            else:
                nested[k] = v
        res, arrays = {}, {}
        for case in cfg["cases"]:
            tcfg = _config(case)
            mesh = model_mesh(case["axes"], device_type="cpu")
            params = distribute_params(nested, param_shardings(tcfg, mesh))
            ds = data_sharding(mesh)
            rec = {}
            if case.get("loader"):
                with make_dataloader(cfg["url"], z["tokens"].shape[0],
                                     sharding={"tokens": ds, "targets": ds}, device="cpu",
                                     reader_pool_type="dummy",
                                     shuffle_row_groups=False) as loader:
                    batch = next(iter(loader))
                tokens, targets = batch["tokens"], batch["targets"]
                rec["placements"] = [repr(p) for p in tokens.placements]
                rec["local_shape"] = list(tokens.to_local().shape)
                arrays[case["name"] + "/tokens"] = tokens.full_tensor().numpy()
                arrays[case["name"] + "/targets"] = targets.full_tensor().numpy()
            else:
                tokens, targets = (distribute_params(torch.from_numpy(z[n]), ds)
                                   for n in ("tokens", "targets"))
            step = make_train_step(tcfg, mesh, n_micro=2, learning_rate=case["lr"])
            losses = []
            for _ in range(case["steps"]):
                params, loss = step(params, tokens, targets)
                losses.append(float(loss))
            rec["losses"] = losses
            arrays[case["name"] + "/embed"] = params["embed"].full_tensor().numpy()
            for k, v in params["stages"].items():
                arrays["%s/stages/%s" % (case["name"], k)] = v.full_tensor().numpy()
            for k in ("pos", "ln_f", "unembed"):
                arrays["%s/%s" % (case["name"], k)] = params[k].full_tensor().numpy()
            res[case["name"]] = rec
        _write(out, res, arrays)
    finally:
        dist.destroy_process_group()
